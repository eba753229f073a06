"""The per-block cull test of ray-mesh kernel K2 (`csrc/ray_mesh.cu`), on the
CPU.

The CUDA kernel runs only on the card.  Its cull test is stated operation
for operation in PyTorch float32 (`kernels/raytrace.py::cull_keep`): for
each block of the kernel's rays with one common origin, a triangle is
dropped when the largest value of one of its three edge functions over the
block's box of directions lies below minus a rounding margin (the proof is
in the kernel's note).  Each ray is then tested by the plain pair test
against the triangles its block keeps only, and the result must be
bit-equal to the brute-force plain version `ray_mesh_intersect_plain`, with
no dropped triangle that the plain pair test reports as a hit.  The same
inputs go through the kernel on the card in tests/test_torch_kernels_cuda.py."""
import pytest
import torch

from sixdof_tpu_torch.kernels import raytrace as k2
from torch_ray_cases import HAND_PLACED, each_edge_case, scene_case, to_torch

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def binned(o, d, valid, tris):
    """(t of each ray against its block's survivors, keep, whether a dropped
    triangle is hit)."""
    keep = k2.cull_keep(o, d, valid, tris)
    R = k2.THREADS >> k2.threads_per_ray_log2(len(o))
    block = torch.arange(len(o)) // R
    out, dropped_hit = [], False
    for i in range(0, len(o), k2.RAY_CHUNK):
        sl = slice(i, i + k2.RAY_CHUNK)
        t = k2.pair_t(o[sl], d[sl], valid[sl], tris)
        kept = keep[block[sl]]
        dropped_hit |= bool((torch.isfinite(t) & ~kept).any())
        out.append(torch.where(kept, t, float("inf")).amin(dim=1))
    return torch.cat(out), keep, dropped_hit


def _check(case):
    o, d, valid, tris = to_torch(case, "cpu")
    want = k2.ray_mesh_intersect_plain(o, d, valid, tris)
    got, keep, dropped_hit = binned(o, d, valid, tris)
    assert not dropped_hit  # the test never drops a triangle that a ray hits
    assert torch.equal(got, want)
    return keep, want


def test_cull_on_scene_matches_plain():
    """Every 4th pixel of the frame in x and y: the rule culls nearly every
    triangle from nearly every block."""
    keep, t = _check(scene_case(4))
    assert torch.isfinite(t).sum() > 200
    per_block = keep.sum(dim=1).float()
    assert per_block.mean() < 0.02 * keep.shape[1]
    assert 0 < per_block.max() < keep.shape[1]


@pytest.mark.parametrize("name", list(HAND_PLACED))
def test_cull_on_hand_placed_rays_matches_plain(name):
    case = HAND_PLACED[name]()
    keep, t = _check(case)
    if name != "each_edge":  # its rays pass outside the triangle
        assert torch.isfinite(t).any()
    valid, tri_mask = torch.tensor(case[2]), torch.tensor(case[4])
    R = k2.THREADS >> k2.threads_per_ray_log2(len(valid))
    live = valid.reshape(-1, R).any(dim=1)
    assert not keep[~live].any()  # a block without a valid ray keeps nothing
    if name == "inside":
        assert torch.isfinite(t).all()
    if name == "masked":
        assert not keep[:, ~tri_mask].any() and keep.any()
    if name == "overflow":
        assert (keep.sum(dim=1) > 512).all()
    if name == "mixed_origins":
        assert keep[live].all()  # no common origin: every triangle kept


def test_each_edge_plane_culls():
    """Blocks outside one edge each: all three edge planes take part."""
    o, d, valid, tris = to_torch(each_edge_case(), "cpu")
    keep = k2.cull_keep(o, d, valid, tris)
    assert keep.shape == (3, 1) and not keep.any()
    # the same rays moved inside the triangle keep it
    inside = torch.nn.functional.normalize(torch.tensor([[0.4, 0.4, 1.0]]).repeat(len(o), 1),
                                           dim=1)
    assert k2.cull_keep(o, inside, valid, tris).all()
