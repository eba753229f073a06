"""The tile-binning rule of raster kernel K1 (`csrc/raster_zbuffer.cu`), on
the CPU.

The CUDA kernel runs only on the card.  Its binning rule is emulated here in
PyTorch float32 with the kernel's operations in the kernel's order: for each
16x16 pixel tile, and then for each warp's 8x4 region of it, a candidate is
dropped when, for one of its barycentric planes, the plane is below
-2 delta at all four corner pixels of the tile or region (the kernel tests
the one corner that decides it, which gives the same answer)
(delta = 4u (|c0| x1 + |c1| y1 + |c2|) + FLT_MIN, u = 2^-24).  Each pixel
is then rasterized against the candidates that survive both its tile and
its region only, and the result must be bit-equal (zbuf and tid) to the
brute-force plain version `rasterize_zbuffer_plain`.  The same inputs go
through the kernel on the card in tests/test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer_plain
from torch_raster_cases import ADVERSARIAL, adversarial_case, empty_case, scene_case

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

TILE = 16
REGION_W, REGION_H = 8, 4  # a warp's pixels
KROUND = 2.0 ** -22  # 4u
FLT_MIN = float(np.finfo(np.float32).tiny)


def _plane(c, x, y):
    """((c0*x) + (c1*y)) + c2 in float32, rounded after every operation."""
    return (c[..., 0] * x + c[..., 1] * y) + c[..., 2]


def _tiles(H, W, tw=TILE, th=TILE):
    """Tile origins and last pixels (x0, x1, y0, y1) as float32 (NT,) rows,
    tiles of tw x th pixels in row-major order."""
    ty, tx = torch.meshgrid(torch.arange(0, H, th), torch.arange(0, W, tw), indexing="ij")
    tx, ty = tx.reshape(-1), ty.reshape(-1)
    x1, y1 = torch.clamp(tx + tw, max=W) - 1, torch.clamp(ty + th, max=H) - 1
    return [v.float() for v in (tx, x1, ty, y1)]


def _tile_of(H, W, tw=TILE, th=TILE):
    """(P,) index of each pixel's tile in _tiles' order."""
    pid = torch.arange(H * W)
    return (torch.div(pid, W, rounding_mode="floor") // th) * ((W + tw - 1) // tw) \
        + (pid % W) // tw


def tile_survivors(coef, counts, H, W, tw=TILE, th=TILE):
    """(B, NT, T) bool: candidate t survives the corner test of tile k."""
    x0, x1, y0, y1 = (v[:, None, None] for v in _tiles(H, W, tw, th))  # (NT,1,1)
    c = coef[:, None, :, :3, :]  # (B,1,T,3,3): the barycentric planes
    delta = KROUND * _plane(c.abs(), x1, y1) + FLT_MIN
    lim = -2.0 * delta
    below = ((_plane(c, x0, y0) < lim) & (_plane(c, x1, y0) < lim)
             & (_plane(c, x0, y1) < lim) & (_plane(c, x1, y1) < lim))
    live = torch.arange(coef.shape[1]) < counts[:, None].long()  # (B,T)
    return ~below.any(dim=-1) & live[:, None, :]


def binned_raster(coef, counts, H, W):
    """Each pixel against the survivors of its tile and of its region, in
    ascending candidate order with the kernel's strict '>' (lowest index
    wins a tie).  Also returns the tile survivors and whether any dropped
    candidate covers a pixel (it must not)."""
    B, T = coef.shape[:2]
    keep = tile_survivors(coef, counts, H, W)
    keep_region = tile_survivors(coef, counts, H, W, REGION_W, REGION_H)
    pid = torch.arange(H * W)
    px, py = (pid % W).float(), torch.div(pid, W, rounding_mode="floor").float()
    tile_of, region_of = _tile_of(H, W), _tile_of(H, W, REGION_W, REGION_H)
    zbuf = torch.zeros((B, H * W))
    tid = torch.full((B, H * W), -1, dtype=torch.int32)
    dropped_cover = False
    idx = torch.arange(T, dtype=torch.int32)
    for b in range(B):
        vals = coef[b, :, :, 0, None] * px + coef[b, :, :, 1, None] * py + coef[b, :, :, 2, None]
        l0, l1, l2, iz = vals.unbind(1)  # (T,P) each
        covers = (torch.minimum(l0, torch.minimum(l1, l2)) >= 0) & (iz > 1e-12)
        covers &= (idx < counts[b])[:, None]
        # (T,P): candidate t survives pixel p's tile and region
        k = (keep[b][tile_of] & keep_region[b][region_of]).T
        dropped_cover |= bool((covers & ~k).any())
        key = torch.where(covers & k, iz, -1.0)
        izmax = key.amax(dim=0)
        hit = izmax > 0
        first = torch.where(key >= izmax, idx[:, None], T).amin(dim=0)
        zbuf[b] = torch.where(hit, 1.0 / torch.clamp(izmax, min=1e-12), 0.0)
        tid[b] = torch.where(hit, first, -1)
    return zbuf, tid, keep, dropped_cover


def _check(coef, counts, H, W):
    zp, tp = rasterize_zbuffer_plain(coef, counts, H, W)
    zb, tb, keep, dropped_cover = binned_raster(coef, counts, H, W)
    assert not dropped_cover  # the rule never drops a covering triangle
    assert torch.equal(zb, zp)
    assert torch.equal(tb, tp)
    return keep, tp


@pytest.mark.parametrize("B,hw,cull", [(4, (48, 48), True), (3, (37, 53), False),
                                       (2, (80, 64), True)])
def test_binning_on_scene_matches_plain(B, hw, cull):
    coef, counts, H, W = scene_case("cpu", B, hw, cull=cull)
    keep, tid = _check(coef, counts, H, W)
    assert (tid >= 0).float().mean() > 0.05  # the object is in view
    # the rule does cut: most candidates are dropped from most tiles
    per_tile = keep.sum(-1).float() / counts[:, None].float()
    assert per_tile.mean() < 0.6


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_binning_on_hand_placed_triangles_matches_plain(name):
    coef, counts, H, W = adversarial_case(name, "cpu")
    keep, tid = _check(coef, counts, H, W)
    assert (tid >= 0).any()
    if name == "ties":  # duplicates: the lowest index wins, in every tile
        assert (tid[0][tid[0] >= 0] != 2).all() and (tid[0][tid[0] >= 0] != 3).all()


def test_binning_with_empty_poses_matches_plain():
    coef, counts, H, W = empty_case("cpu")
    assert counts.tolist()[1:] == [0, 0] and counts[0] > 0
    _, tid = _check(coef, counts, H, W)
    assert (tid[1:] == -1).all() and (tid[0] >= 0).any()


@pytest.mark.parametrize("name", [*ADVERSARIAL, "scene"])
def test_one_corner_decides_as_four_corners_do(name):
    """The kernel evaluates each plane only at the corner that the signs of
    c0 and c1 pick: the rounded plane is monotone in px and py, so that
    corner's value is the largest of the four, and 'below at all four
    corners' holds exactly when it holds there."""
    coef, counts, H, W = (scene_case("cpu", 4, (48, 40)) if name == "scene"
                          else adversarial_case(name, "cpu"))
    for tw, th in ((TILE, TILE), (REGION_W, REGION_H)):
        x0, x1, y0, y1 = (v[:, None, None] for v in _tiles(H, W, tw, th))
        c = coef[:, None, :, :3, :]
        lim = -2.0 * (KROUND * _plane(c.abs(), x1, y1) + FLT_MIN)
        four = ((_plane(c, x0, y0) < lim) & (_plane(c, x1, y0) < lim)
                & (_plane(c, x0, y1) < lim) & (_plane(c, x1, y1) < lim))
        one = _plane(c, torch.where(c[..., 0] >= 0, x1, x0),
                     torch.where(c[..., 1] >= 0, y1, y0)) < lim
        assert torch.equal(one, four)
        assert four.any()  # the test does reject here


def test_corner_rule_keeps_slivers_on_pixel_rows():
    """A triangle one ulp tall lying on a pixel row covers that row's pixels
    in the plain version; the tiles it crosses keep it."""
    coef, counts, H, W = adversarial_case("slivers", "cpu")
    _, tp = rasterize_zbuffer_plain(coef, counts, H, W)
    keep = tile_survivors(coef, counts, H, W)
    hit_ids = set(tp[tp >= 0].tolist())
    assert hit_ids & set(range(5))  # some row sliver wins pixels
    for t in hit_ids:
        pixels = (tp[0] == t).nonzero()[:, 0]
        assert keep[0, _tile_of(H, W)[pixels], t].all()
