"""Neural object field: a truncated-SDF NeRF for model-free mesh reconstruction.

Port of `sixdof_tpu/models/object_field.py`, the JAX rebuild of the
reference's `bundlesdf/` subsystem: when no CAD model exists, fit a
hash-grid SDF/colour field to masked RGB-D frames with known rough poses,
then extract a mesh and use it as the pose target.  The names follow the
JAX module one to one.

- Multi-resolution hash-grid encoding (instant-NGP: 16 levels, base
  resolution 32 to finest 512, 2 features a level, a 2^22 table): one
  gather of the 8 corners of every level, and a backward that keeps the
  gathered corner values (`d_w` needs no second gather) and scatter-adds
  the table gradient level by level (`_LookupCorners`).  The hash
  multiplies in uint32 with wraparound, which torch computes in int64
  masked to 32 bits.  Indices and weights keep the JAX layout, (8, L, N)
  with N minor, and the indices int32.
- Spherical-harmonics direction encoding (degree 3), the NeRFSmall MLPs
  (a 2-layer SDF net, 64 wide, giving the SDF and 15 geometry features; a
  3-layer colour net on [SH, frame latent, geometry]), the per-frame latents
  and the tanh-bounded se(3) pose corrections with frame 0 pinned.
- Depth-band compositing and the truncated-SDF losses (rgb x100,
  free-space x100, empty x1, sdf x6000, latent and pose regularisers),
  computed in the JAX order and dtype.

Every random draw (the initial weights and table, the minibatch, the
samples along each ray) is split from its use, as the port's trainer does:
a draw function takes an explicit `torch.Generator` on the device and
returns a dict of tensors, each the value one `jax.random` call returns in
the JAX module, and a deterministic body takes the dict.  The CPU tests
feed JAX's own draws to the bodies.  The field (`FieldParams`) is an
`nn.Module` whose parameters keep the JAX tree's layout (dense weights
(in, out), `h @ w + b`); `field_params_from_numpy` carries a JAX field
over.  Checkpoints are `.npz` files holding the same tree as the JAX
package's orbax checkpoints.  Entry points run on the card unless the
caller passes `device="cpu"`.

`ObjectFieldRunner.step(draws, device_mesh=mesh)` is the data-parallel step
(parallel/sharding.py, one process a rank): every rank makes the same draws,
runs the loss and backward of its slice of the ray minibatch
(`loss_and_grad`, through `shard_field_rays`; the hash table's scatter-add
stays per rank), the gradients are averaged across the ranks, and every
rank takes the same Adam step.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
from scipy import ndimage

from ..device import resolve_device
from ..parallel.sharding import all_gather, average_gradients, shard_field_rays

BAD_DEPTH = 99.0
BAD_COLOR = 0


# ------------------------------------------------------------- hash grid  --


class HashGridSpec(NamedTuple):
    n_levels: int = 16
    base_res: int = 32
    finest_res: int = 512
    level_dim: int = 2
    log2_hashmap_size: int = 22

    @property
    def per_level_scale(self):
        return math.exp(math.log(self.finest_res / self.base_res) / (self.n_levels - 1))

    def level_res(self, l):
        return int(math.floor(self.base_res * self.per_level_scale**l))

    def level_size(self, l):
        res = self.level_res(l)
        dense = (res + 1) ** 3
        return min(dense, 2**self.log2_hashmap_size)

    @property
    def offsets(self):
        offs = [0]
        for l in range(self.n_levels):
            offs.append(offs[-1] + self.level_size(l))
        return offs

    @property
    def out_dim(self):
        return self.n_levels * self.level_dim


_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# corner c in 0..7 takes bit (c >> d) & 1 of coordinate d
_CORNER_BITS = [[(c >> d) & 1 for c in range(8)] for d in range(3)]


def init_hash_grid(spec: HashGridSpec, generator, device=None):
    """The table's draw: (total, level_dim) uniform in [-1e-4, 1e-4)."""
    total = spec.offsets[-1]
    u = torch.rand((total, spec.level_dim), generator=generator,
                   device=resolve_device(device))
    return u * 2e-4 - 1e-4


def hash_grid_indices(x, spec: HashGridSpec):
    """All (corner, level) table rows and trilinear weights in one shot.

    @x: (N,3) in [-1,1] -> idx (8, L, N) int32 rows of the GLOBAL table
    (level offsets folded in), w (8, L, N) float32 trilinear weights."""
    L = spec.n_levels
    dev = x.device
    res = [spec.level_res(l) for l in range(L)]
    size = [spec.level_size(l) for l in range(L)]
    dense = torch.tensor([(r + 1) ** 3 <= s for r, s in zip(res, size)], device=dev)
    res_f = torch.tensor(res, dtype=x.dtype, device=dev)[:, None]
    res_hi = torch.tensor(res, dtype=torch.int32, device=dev)[:, None] - 1
    res1 = torch.tensor(res, dtype=torch.int32, device=dev)[:, None] + 1

    x01 = (x + 1.0) / 2.0
    cds, ws = [], []
    for d in range(3):  # each (2,L,N): the low and high corner of the cell
        pos = res_f * x01[:, d][None, :]
        p0 = torch.floor(pos).to(torch.int32)
        frac = pos - p0
        p0 = torch.minimum(torch.clamp(p0, min=0), res_hi)
        cds.append(torch.stack([p0, p0 + 1]))
        ws.append(torch.stack([1.0 - frac, frac]))
    sel = [torch.tensor(b, device=dev) for b in _CORNER_BITS]
    w = ws[0][sel[0]] * ws[1][sel[1]] * ws[2][sel[2]]

    # dense levels: (cx * (res+1) + cy) * (res+1) + cz, summed per coordinate
    # on (2,L,N) before the (8,L,N) expansion (int32 holds 513^3)
    dense_idx = (cds[0] * res1 * res1)[sel[0]] + (cds[1] * res1)[sel[1]] + cds[2][sel[2]]
    # hashed levels: uint32 products with wraparound, XORed, modulo the size
    h = [((cds[d].to(torch.int64) * _PRIMES[d]) & _U32) for d in range(3)]
    hash_idx = (h[0][sel[0]] ^ h[1][sel[1]] ^ h[2][sel[2]]) \
        % torch.tensor(size, dtype=torch.int64, device=dev)[:, None]
    idx = torch.where(dense[:, None], dense_idx, hash_idx.to(torch.int32))
    offs = torch.tensor(spec.offsets[:-1], dtype=torch.int32, device=dev)[:, None]
    return idx + offs, w


class _LookupCorners(torch.autograd.Function):
    """sum_c w_c * table[idx_c] over the 8 corners, both feature columns in
    one gather.  Backward: d_w = g . cot from the SAVED corner values g (no
    second gather), and d_table scatter-added level by level into each
    level's own rows, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, table, idx, w, spec):
        g = table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])
        ctx.save_for_backward(g, idx, w)
        ctx.spec = spec
        ctx.table_shape = table.shape
        return (w[..., None] * g).sum(dim=0)  # (L,N,level_dim)

    @staticmethod
    def backward(ctx, cot):
        g, idx, w = ctx.saved_tensors
        spec = ctx.spec
        d_table = None
        if ctx.needs_input_grad[0]:
            upd = w[..., None] * cot[None]
            d_table = torch.zeros(ctx.table_shape, dtype=cot.dtype, device=cot.device)
            offs = spec.offsets
            for l in range(spec.n_levels):
                rows = idx[:, l].reshape(-1) - offs[l]
                d_table[offs[l]:offs[l + 1]].index_add_(
                    0, rows, upd[:, l].reshape(-1, ctx.table_shape[1]))
        d_w = (g * cot[None]).sum(dim=-1) if ctx.needs_input_grad[2] else None
        return d_table, None, d_w, None


def hash_grid_encode(table, x, spec: HashGridSpec):
    """@x: (N,3) in [-1,1] -> (N, n_levels * level_dim) features."""
    idx, w = hash_grid_indices(x, spec)
    out = _LookupCorners.apply(table, idx, w, spec)  # (L,N,level_dim)
    return out.permute(1, 0, 2).reshape(x.shape[0], spec.out_dim)


# ------------------------------------------------------------ SH encoding --

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396]


def sh_encode(d, degree=3):
    """Real SH basis up to @degree (out dim degree^2)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz, _C2[4] * (xx - yy),
        ]
    return torch.stack(out, dim=-1)


# ------------------------------------------------------------------ model --


class _Dense(nn.Module):
    """One dense layer in the JAX layout: weight (in, out), bias (out,)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, h):
        return h @ self.w + self.b


class FieldParams(nn.Module):
    """The JAX module's FieldParams as an nn.Module: the hash table, the
    SDF MLP (`sigma_w`: 2 dense layers), the colour MLP (`color_w`: 3), the
    per-frame latents and the per-frame se(3) pose corrections."""

    def __init__(self, table, sigma_w, color_w, frame_features, pose_deltas):
        super().__init__()
        self.table = nn.Parameter(table)
        self.sigma_w = nn.ModuleList(_Dense(w, b) for w, b in sigma_w)
        self.color_w = nn.ModuleList(_Dense(w, b) for w, b in color_w)
        self.frame_features = nn.Parameter(frame_features)
        self.pose_deltas = nn.Parameter(pose_deltas)

    def tree(self):
        """The JAX tree's paths -> numpy arrays (the checkpoint's layout)."""
        out = {"table": self.table, "frame_features": self.frame_features,
               "pose_deltas": self.pose_deltas}
        for name in ("sigma_w", "color_w"):
            for i, layer in enumerate(getattr(self, name)):
                out[f"{name}/{i}/0"], out[f"{name}/{i}/1"] = layer.w, layer.b
        return {k: v.detach().cpu().numpy() for k, v in out.items()}


def field_params_from_numpy(tree, device=None):
    """A JAX FieldParams given as numpy arrays (its `_asdict()`: table,
    sigma_w ((w, b), ...), color_w, frame_features, pose_deltas) -> the
    port's FieldParams on @device."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    return FieldParams(
        t(tree["table"]),
        [(t(w), t(b)) for w, b in tree["sigma_w"]],
        [(t(w), t(b)) for w, b in tree["color_w"]],
        t(tree["frame_features"]), t(tree["pose_deltas"]))


def field_draws(spec: HashGridSpec, frame_feat_dim=2, sh_degree=3, generator=None,
                device=None):
    """init_field's draws: the five dense kernels' unit normals and the
    hash table (`init_hash_grid`)."""
    dev = resolve_device(device)
    c_in = sh_degree**2 + frame_feat_dim + 15
    shapes = dict(sigma1=(spec.out_dim, 64), sigma2=(64, 16), color1=(c_in, 64),
                  color2=(64, 64), color3=(64, 3))
    out = {k: torch.randn(s, generator=generator, device=dev) for k, s in shapes.items()}
    out["table"] = init_hash_grid(spec, generator, dev)
    return out


def init_field(spec: HashGridSpec, n_frames, draws, frame_feat_dim=2, sh_degree=3):
    """FieldParams from @draws (`field_draws`): He-scaled dense kernels,
    zero biases, the SDF bias started positive (0.1), zero latents and pose
    corrections."""
    dev = draws["table"].device

    def dense(name):
        w = draws[name]
        return w * math.sqrt(2.0 / w.shape[0]), torch.zeros(w.shape[1], device=dev)

    sigma1, sigma2 = dense("sigma1"), dense("sigma2")
    sigma2[1][0] = 0.1
    return FieldParams(
        draws["table"].clone(), [sigma1, sigma2],
        [dense("color1"), dense("color2"), dense("color3")],
        torch.zeros((n_frames, frame_feat_dim), device=dev),
        torch.zeros((n_frames, 6), device=dev))


def field_sdf(params: FieldParams, x, spec: HashGridSpec):
    h = hash_grid_encode(params.table, x, spec)
    l1, l2 = params.sigma_w
    out = l2(torch.relu(l1(h)))
    return out[..., 0], out[..., 1:]


def field_color(params: FieldParams, geo_feat, dirs, frame_feat, sh_degree=3):
    sh = sh_encode(dirs, sh_degree)
    h = torch.cat([sh, frame_feat, geo_feat], dim=-1)
    l1, l2, l3 = params.color_w
    return l3(torch.relu(l2(torch.relu(l1(h)))))  # raw logits; sigmoid at compositing


# -------------------------------------------------------------- rendering --


def ray_box_intersect(origins, dirs, lo=-1.0, hi=1.0):
    """Slab test against the normalized cube; returns (near, far) clamped."""
    inv = 1.0 / torch.where(dirs.abs() > 1e-9, dirs, torch.full_like(dirs, 1e-9))
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), torch.clamp(tmax, min=0.0)


def sample_z_draws(n, n_uniform, n_depth, generator, device):
    """sample_z_vals' three uniform draws: the stratified jitter (u1), the
    depth-band positions (u2) and the second stratified set for rays
    without depth (u3)."""
    def u(k):
        return torch.rand((n, k), generator=generator, device=device)

    return dict(u1=u(n_uniform), u2=u(n_depth), u3=u(n_depth))


def sample_z_vals(origins, dirs, target_d, n_uniform, n_depth, truncation,
                  neg_trunc_ratio, far_cap, draws):
    """Uniform box samples + samples around the depth, sorted."""
    near, far = ray_box_intersect(origins, dirs)
    far = torch.clamp(far, max=far_cap)
    dev = origins.device
    u = (torch.arange(n_uniform, device=dev) + draws["u1"]) / n_uniform
    z_uni = near[:, None] + (far - near)[:, None] * u
    has_depth = (target_d < far_cap) & (target_d > 0)
    lo = target_d[:, None] - truncation
    hi = target_d[:, None] + truncation * neg_trunc_ratio
    z_dep = lo + (hi - lo) * draws["u2"]
    # rays without valid depth get a SECOND stratified uniform set over
    # [near, far], not a replicated first sample
    u2 = (torch.arange(n_depth, device=dev) + draws["u3"]) / n_depth
    z_uni2 = near[:, None] + (far - near)[:, None] * u2
    z_dep = torch.where(has_depth[:, None], z_dep, z_uni2)
    z = torch.sort(torch.cat([z_uni, z_dep], dim=-1), dim=-1).values
    return z, z > 0


def sdf2weights(sdf_unused, z_vals, depth, truncation, sdf_lambda, neg_trunc_ratio, far_cap):
    """Depth-band compositing weights."""
    f = (depth[:, None] - z_vals) / truncation
    w = torch.sigmoid(f * sdf_lambda) * torch.sigmoid(-f * sdf_lambda)
    invalid = depth > far_cap
    band = (z_vals - depth[:, None] <= truncation * neg_trunc_ratio) & (
        z_vals - depth[:, None] >= -truncation
    )
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w = torch.where(invalid[:, None], zero, torch.where(band, w, zero))
    return w / (w.sum(dim=-1, keepdim=True) + 1e-10)


# ----------------------------------------------------------------- runner --


class ObjectFieldConfig(NamedTuple):
    n_step: int = 1000
    n_rand: int = 2048
    n_samples: int = 128
    n_samples_around_depth: int = 128
    lrate: float = 0.01
    trunc: float = 0.01
    neg_trunc_ratio: float = 1.0
    sdf_lambda: float = 5.0
    rgb_weight: float = 100.0
    fs_weight: float = 100.0
    empty_weight: float = 1.0
    trunc_weight: float = 6000.0
    fs_sdf: float = 1.0
    feature_reg_weight: float = 0.1
    pose_reg_weight: float = 0.01
    far: float = 2.0
    first_frame_weight: float = 1.0
    sh_degree: int = 3
    frame_feat_dim: int = 2
    optimize_poses: bool = True
    max_trans: float = 0.02  # meters; tanh bound on the pose correction
    max_rot: float = 10.0  # degrees


def compute_scene_bounds(pts):
    """Translate to the centre, scale so the cloud fits in [-1,1] * 0.9.
    Returns (sc_factor, translation)."""
    mn, mx = pts.min(axis=0), pts.max(axis=0)
    center = (mn + mx) / 2
    translation = -center
    radius = np.abs(pts + translation).max()
    sc_factor = 0.9 / radius
    return float(sc_factor), translation


def dilate_mask(m, size):
    """``cv2.dilate(m, np.ones((size, size), np.uint8))`` of a uint8 mask:
    OpenCV anchors the kernel at (size // 2, size // 2), so the window
    spans offsets -(size // 2) .. size - 1 - size // 2 (-5..+4 for 10), as
    scipy's maximum filter's does; the border never wins the max."""
    return ndimage.maximum_filter(m, size=size, mode="constant", cval=0)


def make_frame_rays(rgbs, depths, masks, poses, K, sc_factor, dilate=10):
    """Flattened per-pixel ray table (host numpy, once): [origin(3), dir(3),
    rgb(3), depth(1), frame_id(1)] in the NORMALIZED object frame, OpenCV
    pinhole dirs transformed by the cam-in-object poses."""
    n, H, W = depths.shape
    rows = []
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    dirs_cam = np.stack(
        [(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1], np.ones_like(us, dtype=np.float64)],
        axis=-1,
    )
    for i in range(n):
        m = (masks[i] > 0).astype(np.uint8)
        if dilate > 0:
            m = dilate_mask(m, dilate)
        ys, xs = np.where(m > 0)
        d = depths[i][ys, xs] * sc_factor
        d = np.where(depths[i][ys, xs] >= BAD_DEPTH * 0.9, BAD_DEPTH, d)
        dirs = dirs_cam[ys, xs] @ poses[i][:3, :3].T
        origins = np.tile(poses[i][:3, 3], (len(ys), 1))
        rgb = rgbs[i][ys, xs]
        rows.append(
            np.concatenate(
                [origins, dirs, rgb, d[:, None], np.full((len(ys), 1), i, dtype=np.float64)],
                axis=-1,
            )
        )
    return np.concatenate(rows).astype(np.float32)


def make_loss_fn(cfg_ref: ObjectFieldConfig, spec_ref: HashGridSpec, sc: float):
    """The training loss (rgb + truncated-SDF terms): loss_fn(params, batch,
    draws) -> (total, parts), @draws as `sample_z_draws` gives them."""

    def loss_fn(params: FieldParams, batch, draws):
        o = batch[:, 0:3]
        d = batch[:, 3:6]
        target_rgb = batch[:, 6:9]
        target_d = batch[:, 9]
        fids = batch[:, 10].to(torch.int64)

        if cfg_ref.optimize_poses:
            from ..ops.lie import se3_exp_map

            # tanh-bounded corrections, frame 0 pinned to identity (else the
            # gauge drifts and the mesh is misaligned to the given poses)
            theta = torch.tanh(params.pose_deltas[fids])
            tw = torch.cat(
                [theta[:, :3] * cfg_ref.max_trans,
                 theta[:, 3:6] * (cfg_ref.max_rot * math.pi / 180.0)], dim=-1)
            tw = torch.where((fids == 0)[:, None], torch.zeros_like(tw), tw)
            delta = se3_exp_map(tw)
            o = (delta[:, :3, :3] @ o[..., None])[..., 0] + delta[:, :3, 3]
            d = (delta[:, :3, :3] @ d[..., None])[..., 0]

        # trunc and far are METERS in the config: normalized like the rays
        trunc = cfg_ref.trunc * sc
        far_n = cfg_ref.far * sc
        z, valid = sample_z_vals(
            o, d, target_d, cfg_ref.n_samples, cfg_ref.n_samples_around_depth,
            trunc, cfg_ref.neg_trunc_ratio, far_n, draws,
        )
        pts = o[:, None] + d[:, None] * z[..., None]  # (N,S,3)
        N, S = z.shape
        sdf, geo = field_sdf(params, pts.reshape(-1, 3), spec_ref)
        sdf = sdf.reshape(N, S)
        dirs_flat = d.repeat_interleave(S, dim=0)
        ff = params.frame_features[fids].repeat_interleave(S, dim=0)
        rgb_raw = field_color(params, geo, dirs_flat, ff, cfg_ref.sh_degree)
        rgb = torch.sigmoid(rgb_raw).reshape(N, S, 3)

        w = sdf2weights(sdf, z, target_d, trunc, cfg_ref.sdf_lambda,
                        cfg_ref.neg_trunc_ratio, far_n)
        w = torch.where(valid, w, torch.zeros_like(w))
        rgb_map = torch.sum(w[..., None] * rgb, dim=-2)

        one = torch.ones_like(target_d)
        ray_w = torch.where(fids == 0, one * cfg_ref.first_frame_weight, one)
        has_depth = target_d <= far_n
        rgb_loss = cfg_ref.rgb_weight * torch.mean(
            (rgb_map - target_rgb) ** 2 * (ray_w * has_depth)[:, None]
        )

        # truncated-SDF losses
        td = target_d[:, None]
        sample_w = ray_w[:, None] * valid
        front = z < td - trunc
        back = z > td + trunc * cfg_ref.neg_trunc_ratio
        sdf_band = (~front) & (~back) & has_depth[:, None]
        fs_mask = (~has_depth)[:, None] & (sdf < cfg_ref.fs_sdf)
        fs_loss = cfg_ref.fs_weight * 0.5 * torch.mean(
            ((sdf - cfg_ref.fs_sdf) * fs_mask) ** 2 * sample_w
        )
        empty_mask = front & has_depth[:, None] & (sdf < 1)
        empty_loss = cfg_ref.empty_weight * torch.mean(
            torch.abs(sdf - 1.0) * empty_mask * sample_w
        )
        sdf_loss = cfg_ref.trunc_weight * 0.5 * torch.mean(
            ((z + sdf * trunc) * sdf_band - td * sdf_band) ** 2 * sample_w
        )
        reg = cfg_ref.feature_reg_weight * torch.mean(params.frame_features**2)
        pose_reg = cfg_ref.pose_reg_weight * torch.sum(params.pose_deltas[1:] ** 2)
        total = rgb_loss + fs_loss + empty_loss + sdf_loss + reg + pose_reg
        return total, {
            "rgb": rgb_loss, "fs": fs_loss, "empty": empty_loss, "sdf": sdf_loss,
        }

    return loss_fn


def loss_and_grad(params: FieldParams, loss_fn, batch, draws, device_mesh=None):
    """The loss of @loss_fn on the ray minibatch @batch (R,11) with its
    sample draws, the gradients left in @params (replacing any earlier
    ones).  @device_mesh: this rank takes its slice of the rays and of their
    draws (R must divide the data axis), and the gradients, the loss and
    its parts are averaged across the ranks.  Returns (loss, parts)."""
    if device_mesh is not None:
        batch, n = shard_field_rays(batch, device_mesh)
        rows = device_mesh.rows(n)
        draws = {k: v[rows] for k, v in draws.items()}
    for p in params.parameters():
        p.grad = None
    loss, parts = loss_fn(params, batch, draws)
    loss.backward()
    out = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
    if device_mesh is not None:
        average_gradients(params.parameters(), device_mesh)
        means = all_gather(torch.stack(list(out.values()))[None], device_mesh).mean(dim=0)
        out = dict(zip(out, means))
    loss = out.pop("loss")
    return loss, out


def step_draws(cfg: ObjectFieldConfig, n_rays, generator, device):
    """One training step's draws: the minibatch rows (`idx`, uniform over
    the @n_rays rays of the table) and sample_z_vals' draws."""
    n = int(cfg.n_rand)
    return dict(idx=torch.randint(0, n_rays, (n,), generator=generator, device=device),
                **sample_z_draws(n, cfg.n_samples, cfg.n_samples_around_depth, generator,
                                 device))


class ObjectFieldRunner:
    """Fit the field, extract the mesh (NerfRunner's role)."""

    def __init__(self, cfg: ObjectFieldConfig, K, rgbs, depths, masks, cam_in_obs,
                 spec: HashGridSpec = HashGridSpec(), seed=0, device=None):
        """@rgbs: (N,H,W,3) uint8; @depths: (N,H,W) meters; @masks: (N,H,W);
        @cam_in_obs: (N,4,4) camera-in-object (OpenCV pinhole convention).
        Draws from a generator on @device seeded with @seed."""
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        # seconds of each stage a caller times (rays here, then train,
        # extract, colour, ...), synchronised on the device
        self.stage_seconds = {}
        t0 = time.perf_counter()
        n = len(rgbs)

        depths = depths.astype(np.float64).copy()
        depths[depths < 0.001] = BAD_DEPTH
        rgbs = rgbs.astype(np.float64).copy()
        rgbs[masks == 0] = BAD_COLOR
        depths[masks == 0] = BAD_DEPTH

        # scene normalization from the fused masked cloud
        pts_all = []
        for i in range(n):
            ys, xs = np.where((masks[i] > 0) & (depths[i] < BAD_DEPTH * 0.9))
            z = depths[i][ys, xs]
            x = (xs - K[0, 2]) * z / K[0, 0]
            y = (ys - K[1, 2]) * z / K[1, 1]
            p_cam = np.stack([x, y, z], axis=-1)
            pts_all.append(p_cam @ cam_in_obs[i][:3, :3].T + cam_in_obs[i][:3, 3])
        pts_all = np.concatenate(pts_all)
        self.sc_factor, self.translation = compute_scene_bounds(pts_all)

        poses = cam_in_obs.copy().astype(np.float64)
        poses[:, :3, 3] += self.translation
        poses[:, :3, 3] *= self.sc_factor

        self.poses_normalized = poses
        self.rays = make_frame_rays(rgbs / 255.0, depths, masks, poses, K, self.sc_factor)
        logging.info(f"rays: {self.rays.shape}, sc_factor {self.sc_factor:.4f}")
        self.stage_seconds["rays"] = time.perf_counter() - t0

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_field(
            spec, n, field_draws(spec, cfg.frame_feat_dim, cfg.sh_degree, self.generator,
                                 self.device),
            cfg.frame_feat_dim, cfg.sh_degree)
        self.opt = torch.optim.Adam(self.params.parameters(), lr=cfg.lrate)
        self.global_step = 0
        self._rays_dev = None
        self._build_step()

    def _build_step(self):
        """(Re)build the loss: it bakes sc_factor, so a load_weights that
        restores another normalization calls this again."""
        self._loss_fn = make_loss_fn(self.cfg, self.spec, float(self.sc_factor))

    def rays_on_device(self):
        """The ray table, uploaded once; every minibatch is drawn on the device."""
        if self._rays_dev is None:
            self._rays_dev = torch.as_tensor(self.rays, device=self.device)
        return self._rays_dev

    def draw(self):
        """The next step's draws (`step_draws`) from the runner's generator."""
        return step_draws(self.cfg, self.rays_on_device().shape[0], self.generator,
                          self.device)

    def loss_and_grad(self, draws, device_mesh=None):
        """The loss on @draws' minibatch, gradients left in the parameters
        (`loss_and_grad`, data-parallel over @device_mesh's ranks)."""
        return loss_and_grad(self.params, self._loss_fn, self.rays_on_device()[draws["idx"]],
                             draws, device_mesh)

    def step(self, draws, device_mesh=None):
        """One Adam step on @draws (data-parallel over @device_mesh's ranks
        when given); returns (loss, parts) on the device."""
        loss, parts = self.loss_and_grad(draws, device_mesh)
        self.opt.step()
        self.global_step += 1
        return loss, parts

    def train(self, n_steps=None, log_every=100, ckpt_dir=None, ckpt_every=250):
        """@ckpt_dir: when set, a checkpoint is written every @ckpt_every
        steps, so a campaign that dies keeps its field.  Returns the losses
        (read back once, after the loop)."""
        n_steps = n_steps or self.cfg.n_step
        losses = []
        for i in range(n_steps):
            loss, parts = self.step(self.draw())
            losses.append(loss)
            if log_every and i % log_every == 0:
                logging.info(
                    f"field step {i}: loss {float(loss):.4f} "
                    + " ".join(f"{k}={float(v):.4f}" for k, v in parts.items())
                )
            if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0 and i + 1 < n_steps:
                self.save_weights(ckpt_dir)
        return torch.stack(losses).cpu().tolist() if losses else []

    # -------------------------------------------------------- checkpointing --

    def save_weights(self, path):
        """@path/field.npz: the field's tree under `field/` (table, sigma_w,
        color_w, frame_features, pose_deltas), `step`, `sc_factor` and
        `translation`, as the JAX package's orbax checkpoint holds them.
        Written to a temporary file and renamed, so a reader never sees a
        partial file."""
        os.makedirs(path, exist_ok=True)
        arrays = {f"field/{k}": v for k, v in self.params.tree().items()}
        arrays.update(step=np.asarray(self.global_step), sc_factor=np.asarray(self.sc_factor),
                      translation=np.asarray(self.translation))
        final = os.path.join(path, "field.npz")
        with open(final + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(final + ".tmp", final)

    def load_weights(self, path):
        with np.load(os.path.join(path, "field.npz")) as z:
            a = {k: z[k] for k in z.files}
        layers = {name: [(a[f"field/{name}/{i}/0"], a[f"field/{name}/{i}/1"])
                         for i in range(sum(k.startswith(f"field/{name}/") for k in a) // 2)]
                  for name in ("sigma_w", "color_w")}
        self.params = field_params_from_numpy(
            dict(table=a["field/table"], frame_features=a["field/frame_features"],
                 pose_deltas=a["field/pose_deltas"], **layers), self.device)
        self.global_step = int(a["step"])
        # restore the normalization the field was TRAINED in: the hash grid
        # and any extracted mesh live in that frame, not in the one computed
        # from this runner's (possibly different) frames
        if "sc_factor" in a:
            old_sc = float(self.sc_factor)
            self.sc_factor = float(a["sc_factor"])
            self.translation = a["translation"]
            if self.sc_factor != old_sc:
                self._build_step()
        self.opt = torch.optim.Adam(self.params.parameters(), lr=self.cfg.lrate)
        return self

    # ---------------------------------------------------------- extraction --

    @torch.no_grad()
    def query_sdf_grid(self, resolution=128, chunk=1 << 17):
        """SDF on a dense grid over [-1,1]^3 (chunked device queries)."""
        lin = torch.as_tensor(np.linspace(-1, 1, resolution).astype(np.float32),
                              device=self.device)
        pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
        out = torch.cat([field_sdf(self.params, pts[i:i + chunk], self.spec)[0]
                         for i in range(0, len(pts), chunk)])
        return out.reshape(resolution, resolution, resolution).cpu().numpy()

    def extract_mesh(self, resolution=128, isolevel=0.0):
        """Marching tetrahedra over the SDF grid -> TriMesh in the
        NORMALIZED frame."""
        from ..io.mesh_io import TriMesh
        from ..ops.marching import marching_tetrahedra

        sdf = self.query_sdf_grid(resolution)
        verts, faces = marching_tetrahedra(sdf, isolevel)
        if len(verts) == 0:
            return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        verts = verts / (resolution - 1) * 2.0 - 1.0
        return TriMesh(verts, faces)

    @torch.no_grad()
    def _query_color(self, pts, dirs, frame_id):
        """sigmoid(colour) of the field at @pts (N,3) seen along @dirs, with
        frame @frame_id's latent."""
        _, geo = field_sdf(self.params, pts, self.spec)
        ff = self.params.frame_features[frame_id][None].expand(len(pts), -1)
        return torch.sigmoid(field_color(self.params, geo, dirs, ff, self.cfg.sh_degree))

    def color_mesh(self, mesh, frame_id=0):
        """Per-vertex colours queried from the fitted field."""
        if len(mesh.vertices) == 0:
            return mesh
        pts = torch.as_tensor(mesh.vertices, dtype=torch.float32, device=self.device)
        # view dirs run camera->surface in training (against the outward
        # normal), so query with the INWARD normal to stay in-distribution
        vn = np.asarray(mesh.vertex_normals, dtype=np.float32)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
        rgb = self._query_color(pts, torch.as_tensor(-vn, device=self.device), frame_id)
        mesh.vertex_colors = rgb.cpu().numpy() * 255.0
        return mesh

    def bake_texture(self, mesh, cell=16, frame_id=0, chunk=1 << 16):
        """Per-face UV atlas texture bake from the fitted field.

        Each triangle gets one cell of a square atlas; texel (x,y) of a cell
        maps affinely to barycentrics, clamped onto the triangle so edge
        texels bleed the rim colour (bilinear-safe), and takes the field's
        colour at that surface point seen along the inward face normal.
        Returns a NEW TriMesh with per-corner UVs (vertices duplicated per
        face) and an (S,S,3) uint8 texture; @mesh must be in the NORMALIZED
        field frame (bake before mesh_to_real_world).  The texel points are
        made on the device in float64, @chunk at a time, and queried in
        float32, as the JAX bake rounds them."""
        from ..io.mesh_io import TriMesh

        faces = np.asarray(mesh.faces)
        T = len(faces)
        if T == 0:
            return mesh
        C = int(np.ceil(np.sqrt(T)))
        S = C * cell
        margin = 1.0

        # local texel -> barycentric (affine; clamped onto the triangle)
        xs = (np.arange(cell) + 0.5 - margin) / (cell - 2 * margin)
        l1 = np.tile(xs[None, :], (cell, 1))  # along +x
        l2 = np.tile(xs[:, None], (1, cell))  # along +y
        l1 = np.clip(l1, 0.0, 1.0)
        l2 = np.clip(l2, 0.0, 1.0)
        over = l1 + l2
        scale = np.where(over > 1.0, 1.0 / np.maximum(over, 1e-9), 1.0)
        l1, l2 = l1 * scale, l2 * scale
        l0 = 1.0 - l1 - l2  # (cell,cell)

        tri = np.asarray(mesh.vertices)[faces]  # (T,3,3)
        # INWARD face normals as the view dirs
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

        dev = self.device
        lam = torch.as_tensor(np.stack([l0, l1, l2]).reshape(3, -1, 1), device=dev)
        tri_d = torch.as_tensor(tri, device=dev)
        dirs_d = torch.as_tensor(-n, device=dev).to(torch.float32)
        tex = torch.zeros((C * C, cell * cell, 3), dtype=torch.float32, device=dev)
        per = max(1, chunk // (cell * cell))  # faces a query
        for f0 in range(0, T, per):
            t = tri_d[f0:f0 + per]
            pts = (lam[0] * t[:, None, 0] + lam[1] * t[:, None, 1] + lam[2] * t[:, None, 2])
            dirs = dirs_d[f0:f0 + per, None].expand(-1, cell * cell, -1)
            rgb = self._query_color(pts.reshape(-1, 3).to(torch.float32), dirs.reshape(-1, 3),
                                    frame_id)
            tex[f0:f0 + len(t)] = rgb.reshape(len(t), cell * cell, 3)
        tex = tex.reshape(C, C, cell, cell, 3).permute(0, 2, 1, 3, 4).reshape(S, S, 3)
        tex_u8 = (torch.clamp(tex, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()

        # per-corner UVs (OBJ convention: v from the bottom; atlas row 0 = top)
        cols = np.arange(T) % C
        rows = np.arange(T) // C
        x0 = cols * cell + margin - 0.5
        y0 = rows * cell + margin - 0.5
        span = cell - 2 * margin
        corners = np.stack(
            [
                np.stack([x0, y0], -1),           # l0 corner
                np.stack([x0 + span, y0], -1),    # l1 corner
                np.stack([x0, y0 + span], -1),    # l2 corner
            ],
            axis=1,
        )  # (T,3,2) in texel coords
        uv = np.empty((T, 3, 2))
        uv[..., 0] = (corners[..., 0] + 0.5) / S
        uv[..., 1] = 1.0 - (corners[..., 1] + 0.5) / S

        new_verts = tri.reshape(-1, 3)
        new_faces = np.arange(3 * T, dtype=np.int64).reshape(T, 3)
        return TriMesh(new_verts, new_faces, uv=uv.reshape(-1, 2), texture=tex_u8)

    def mesh_to_real_world(self, mesh):
        mesh.vertices = mesh.vertices / self.sc_factor - np.asarray(self.translation).reshape(1, 3)
        return mesh

    def get_optimized_poses(self):
        """Per-frame camera-in-object poses with the learned corrections
        applied, in real-world units (frame 0 pinned to identity, so no
        re-anchoring offset is needed)."""
        from ..ops.lie import se3_exp_map

        theta = np.tanh(self.params.pose_deltas.detach().cpu().numpy().astype(np.float64))
        tw = np.concatenate(
            [theta[:, :3] * self.cfg.max_trans,
             theta[:, 3:6] * (self.cfg.max_rot * np.pi / 180.0)], axis=-1)
        tw[0] = 0.0
        # in float32, as the JAX package maps the twists
        delta = se3_exp_map(torch.as_tensor(tw, dtype=torch.float32)).numpy()
        opt = delta @ self.poses_normalized
        opt[:, :3, 3] = opt[:, :3, 3] / self.sc_factor - np.asarray(self.translation)
        return opt.astype(np.float32)


def _synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_neural_object_field(cfg: ObjectFieldConfig, K, rgbs, depths, masks, cam_in_obs,
                            resolution=128, train_steps=None, ckpt_dir=None,
                            spec: HashGridSpec = None, device=None):
    """One-call model-free mesh creation.

    @ckpt_dir: when given, weights are saved BEFORE mesh extraction, so the
    training survives an extraction failure.  @spec: the hash grid (default
    `HashGridSpec()`).  The runner keeps `train_seconds`, `final_loss` and
    the seconds of each stage (`stage_seconds`: rays, train, extract,
    colour)."""
    runner = ObjectFieldRunner(cfg, K, rgbs, depths, masks, cam_in_obs,
                               spec=spec or HashGridSpec(), device=device)
    dev = runner.device
    t0 = _synced(dev)
    losses = runner.train(train_steps, ckpt_dir=ckpt_dir)
    t1 = _synced(dev)
    runner.train_seconds = runner.stage_seconds["train"] = t1 - t0
    runner.final_loss = float(losses[-1]) if losses else float("nan")
    if ckpt_dir:
        runner.save_weights(ckpt_dir)
    t1 = _synced(dev)
    mesh = runner.extract_mesh(resolution=resolution)
    t2 = _synced(dev)
    mesh = runner.color_mesh(mesh)
    t3 = _synced(dev)
    mesh = runner.mesh_to_real_world(mesh)
    runner.stage_seconds.update(extract=t2 - t1, colour=t3 - t2)
    return mesh, runner


# ------------------------------------------------------------- occupancy  --


class OccupancyGrid:
    """Dense voxel occupancy over [-1,1]^3 (the kaolin octree's stand-in):
    O(1) voxel queries and a vectorized probe march."""

    def __init__(self, points, resolution=64, dilate=1, device=None):
        """@points: (N,3) in the NORMALIZED [-1,1] frame."""
        self.resolution = int(resolution)
        dev = resolve_device(device)
        idx = np.clip(((np.asarray(points) + 1.0) / 2.0 * self.resolution).astype(np.int64),
                      0, self.resolution - 1)
        grid = np.zeros((self.resolution,) * 3, dtype=bool)
        grid[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        g = torch.as_tensor(grid, device=dev)
        if dilate > 0:
            k = 2 * dilate + 1
            g = torch.nn.functional.max_pool3d(g[None, None].float(), k, stride=1,
                                               padding=dilate)[0, 0] > 0.5
        self.grid = g
        self.vox_size = 2.0 / self.resolution

    def query(self, pts):
        """(N,3) normalized points -> (N,) bool occupancy."""
        idx = torch.clamp(((pts + 1.0) / 2.0 * self.resolution).to(torch.int64),
                          0, self.resolution - 1)
        return self.grid[idx[..., 0], idx[..., 1], idx[..., 2]]

    def ray_near_far(self, origins, dirs, n_probe=64):
        """Per-ray [near, far] span over occupied space (a probe march)."""
        near_box, far_box = ray_box_intersect(origins, dirs)
        ts = torch.linspace(0.0, 1.0, n_probe, device=origins.device)[None]  # (1,P)
        t = near_box[:, None] + (far_box - near_box)[:, None] * ts  # (N,P)
        pts = origins[:, None] + dirs[:, None] * t[..., None]
        occ = self.query(pts)  # (N,P)
        big = torch.tensor(1e9, dtype=t.dtype, device=t.device)
        t_occ_min = torch.where(occ, t, big).amin(dim=1)
        t_occ_max = torch.where(occ, t, -big).amax(dim=1)
        any_occ = occ.any(dim=1)
        pad = self.vox_size  # half-voxel safety margin each side
        near = torch.where(any_occ, torch.clamp(t_occ_min - pad, min=0.0), near_box)
        far = torch.where(any_occ, t_occ_max + pad, far_box)
        return near, far
