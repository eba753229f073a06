"""Refiner / scorer predictors: crop construction + iterative pose updates.

Port of `sixdof_tpu/models/predict.py`.  The JAX package fuses each stage
into one jitted program; here the same stages are plain functions on
tensors that run eagerly on the caller's device:

  JAX                          port
  _make_AB                     _make_AB
  refine_poses_jit             refine_poses
  score_poses_jit              score_poses
  register_pipeline_jit        register_pipeline
  track_pose_jit               track_pose (with _track_depth_polish)

The predictors' `predict()` (one refine or score call, the staged register
path's stages), the scorer's multi-chunk tournament and the refiner's crop
visualisation (`_make_vis`) keep the JAX package's keyword names.

Every hypothesis render goes through `ops/rasterize.py::render_batch`, so
through raster kernel K1 on the card; `plain_raster=True` routes them
through its plain PyTorch version instead.  Geometry is fp32; the networks
run under bf16 autocast unless a predictor is built with float32.

With a `device_mesh` (parallel/sharding.py) the hypothesis axis is split
across the ranks, as JAX's sharded hypothesis batch is: every rank passes
the whole set, refines or scores its slice (rendered through K1) and gets
the whole result back.  The scorer gathers the per-hypothesis features
before its cross-hypothesis attention, so each score is taken against the
whole set, as GSPMD's program takes it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import network_autocast, resolve_device
from ..ops.depth_filter import bilateral_filter_depth, erode_depth
from ..ops.geometry import (compute_crop_window_tf_batch, depth2xyzmap,
                            egocentric_delta_pose_to_pose)
from ..ops.icp import icp_point_to_plane
from ..ops.lie import rotation_6d_to_matrix, so3_exp_map, so3_log_map
from ..ops.rasterize import MeshArrays, render_batch
from ..ops.warp import warp_crop_batch
from ..parallel.sharding import all_gather, shard_hypotheses
from . import checkpoint
from .networks import RefineNet, ScoreNetMultiPair
from .weights import refine_state_dict, score_state_dict

DEFAULT_REFINER_CFG = dict(
    input_resize=(160, 160),
    crop_ratio=1.2,
    c_in=6,
    trans_rep="tracknet",  # or "deepim" (z-scaled image-space offsets)
    rot_rep="axis_angle",  # or "6d"
    normalize_xyz=False,
    trans_normalizer=0.02,
    rot_normalizer=0.3490658503988659,  # 20 deg
    # visibility substitution (see _make_AB); must match how the weights
    # were trained: False | True | a float gate ceiling
    occ_sub=False,
)

DEFAULT_SCORER_CFG = dict(
    input_resize=(160, 160),
    crop_ratio=1.2,
    c_in=6,
    normalize_xyz=False,
    # 'network' | 'depth' (analytic render-vs-observed) | 'hybrid' (sum)
    score_mode="hybrid",
)


def to_rgb01(rgb, device):
    """uint8-or-float image -> float32 [0,1] tensor (max > 1.5 means 0-255)."""
    arr = np.asarray(rgb)
    out = torch.as_tensor(arr, dtype=torch.float32, device=device)
    if float(arr.max(initial=0.0)) > 1.5:
        out = out / 255.0
    return out


def occlusion_mask(zA, zB, occ_sub, valid_z):
    """The visibility substitution's (N,H,W,1) mask: pixels where B is >1 cm
    nearer than A (both deeper than @valid_z), in samples whose occluded
    share lies in (0.02, ceiling); ceiling 0.6 for @occ_sub True, else
    float(@occ_sub).  B takes A there, so occluders carry no residual."""
    hi = 0.6 if occ_sub is True else float(occ_sub)
    both = (zA > valid_z) & (zB > valid_z)
    occ = both & (zB < zA - 0.01)
    frac = occ.sum(dim=(1, 2)) / torch.clamp(both.sum(dim=(1, 2)), min=1)
    gate = (frac > 0.02) & (frac < hi)
    return (occ & gate[:, None, None])[..., None]


def _make_AB(mesh, poses, rgb01, xyz_map, K, crop_ratio, mesh_diameter, out_hw,
             normalize_xyz, invalid_z_thresh, backface_cull=False, occ_sub=False,
             plain_raster=False):
    """(A = render, B = real) 6-channel NHWC crop pair for a pose batch.
    Returns (A, B, tf_to_crops, rend)."""
    tf_to_crops = compute_crop_window_tf_batch(poses, K, crop_ratio=crop_ratio,
                                               out_size=(out_hw[1], out_hw[0]),
                                               mesh_diameter=mesh_diameter)
    rend = render_batch(mesh, poses, K, tf_to_crops, out_hw=out_hw,
                        backface_cull=backface_cull, plain_raster=plain_raster)
    rgbA = rend["color"]
    xyzA = rend["xyz_map"]
    rgbB = warp_crop_batch(rgb01, tf_to_crops, out_hw, mode="bilinear")
    xyzB = warp_crop_batch(xyz_map, tf_to_crops, out_hw, mode="nearest")

    center = poses[:, :3, 3][:, None, None, :]
    rend = dict(rend)
    rend["obs_validB"] = xyzB[..., 2] > invalid_z_thresh
    rend["xyzA_m"] = xyzA - center
    rend["xyzB_m"] = xyzB - center
    sub = None
    if occ_sub:
        sub = occlusion_mask(xyzA[..., 2], xyzB[..., 2], occ_sub, invalid_z_thresh)
    if normalize_xyz:
        r = mesh_diameter / 2.0
        invalidA = xyzA[..., 2:3] < invalid_z_thresh
        invalidB = xyzB[..., 2:3] < invalid_z_thresh
        xyzA = (xyzA - center) / r
        xyzB = (xyzB - center) / r
        xyzA = torch.where(invalidA | (xyzA.abs() >= 2).any(-1, keepdim=True), 0.0, xyzA)
        xyzB = torch.where(invalidB | (xyzB.abs() >= 2).any(-1, keepdim=True), 0.0, xyzB)
    else:
        xyzA = rend["xyzA_m"]
        xyzB = rend["xyzB_m"]
    A = torch.cat([rgbA, xyzA], dim=-1)
    B = torch.cat([rgbB, xyzB], dim=-1)
    if sub is not None:
        B = torch.where(sub, A, B)
    return A, B, tf_to_crops, rend


def _deepim_trans_delta(trans, poses, tf_to_crops, K, out_hw):
    """DeepIM's translation decode: a crop-pixel offset of the projected
    centre (scaled by the input size) and a multiplicative depth."""
    centers = poses[:, :3, 3]
    z_pred = trans[:, 2] * centers[:, 2]
    ones = torch.ones_like(z_pred)[:, None]
    uvs = torch.einsum("ij,bj->bi", K, centers)
    uvs = uvs / uvs[:, 2:3]
    uvA_crop = torch.einsum("bij,bj->bi", tf_to_crops, uvs)[:, :2]
    uv_pred_crop = uvA_crop + trans[:, :2] * out_hw[0]
    uv_pred = torch.einsum("bij,bj->bi", torch.linalg.inv(tf_to_crops),
                           torch.cat([uv_pred_crop, ones], dim=-1))
    uv_pred = uv_pred[:, :2] / uv_pred[:, 2:3]
    ray = torch.einsum("ij,bj->bi", torch.linalg.inv(K), torch.cat([uv_pred, ones], dim=-1))
    return ray * z_pred[:, None] - centers


@torch.no_grad()
def refine_poses(model, mesh: MeshArrays, poses, rgb01, xyz_map, K, mesh_diameter, crop_ratio,
                 trans_normalizer, rot_normalizer, iterations: int, out_hw=(160, 160),
                 normalize_xyz=False, rot_rep="axis_angle", backface_cull=False, occ_sub=False,
                 plain_raster=False, compute_dtype=torch.bfloat16, trans_rep="tracknet",
                 device_mesh=None):
    """`iterations` render -> compare -> update refinement steps.  The
    translation is decoded as @trans_rep: "tracknet" (tanh-bounded by
    trans_normalizer, raw when xyz inputs are normalized) or "deepim".
    @device_mesh: each rank refines its slice, and the poses are gathered."""
    poses = poses.float()
    n = poses.shape[0]
    if device_mesh is not None:
        poses, _ = shard_hypotheses(poses, device_mesh)
    for _ in range(iterations):
        A, B, tf_to_crops, _ = _make_AB(
            mesh, poses, rgb01, xyz_map, K, crop_ratio, mesh_diameter, out_hw, normalize_xyz,
            invalid_z_thresh=0.001, backface_cull=backface_cull, occ_sub=occ_sub,
            plain_raster=plain_raster)
        with network_autocast(poses.device, compute_dtype):
            out = model(A, B)
        if trans_rep == "tracknet":
            trans_delta = (out["trans"] if normalize_xyz
                           else torch.tanh(out["trans"]) * trans_normalizer)
        elif trans_rep == "deepim":
            trans_delta = _deepim_trans_delta(out["trans"], poses, tf_to_crops, K, out_hw)
        else:
            trans_delta = out["trans"]
        if rot_rep == "axis_angle":
            rot_mat_delta = so3_exp_map(torch.tanh(out["rot"]) * rot_normalizer).transpose(-1, -2)
        elif rot_rep == "6d":
            rot_mat_delta = rotation_6d_to_matrix(out["rot"]).transpose(-1, -2)
        else:
            raise ValueError(rot_rep)
        if normalize_xyz:  # a global post-scale, whatever the translation form
            trans_delta = trans_delta * (mesh_diameter / 2.0)
        poses = egocentric_delta_pose_to_pose(poses, trans_delta, rot_mat_delta)
    if device_mesh is not None:
        poses = all_gather(poses, device_mesh)[:n]
    return poses


def _depth_alignment_score(A, B, rend, poses, mesh_diameter):
    """Occlusion-aware analytic render-vs-observed score (higher = better):
    support fraction - violation fraction + residual sharpness + 2 x colour
    agreement on the supporting pixels."""
    alpha = rend["alpha"]
    xyzA = rend["xyzA_m"]
    xyzB = rend["xyzB_m"]
    both = (alpha > 0) & rend["obs_validB"]
    d = torch.linalg.norm(xyzA - xyzB, dim=-1)
    dz = xyzB[..., 2] - xyzA[..., 2]
    tau = 0.05 * mesh_diameter
    occluded = both & (dz < -tau)
    support = both & (d <= tau)
    violate = both & (dz > tau)
    n_vis = torch.clamp(both.sum(dim=(1, 2)) - occluded.sum(dim=(1, 2)), min=1)
    support_frac = support.sum(dim=(1, 2)) / n_vis
    violate_frac = violate.sum(dim=(1, 2)) / n_vis
    n_sup = torch.clamp(support.sum(dim=(1, 2)), min=1)
    col = -torch.where(support[..., None], (A[..., :3] - B[..., :3]).abs(), 0.0).sum(
        dim=(1, 2, 3)) / (3 * n_sup)
    geom = -torch.where(support, d, 0.0).sum(dim=(1, 2)) / n_sup
    return support_frac - violate_frac + geom / tau + 2.0 * col


@torch.no_grad()
def score_poses(model, mesh: MeshArrays, poses, rgb01, xyz_map, K, mesh_diameter, crop_ratio,
                out_hw=(160, 160), normalize_xyz=False, mode="network", backface_cull=False,
                plain_raster=False, compute_dtype=torch.bfloat16, device_mesh=None):
    """Single-pass hypothesis scoring: 'network', 'depth' or 'hybrid' (sum).
    @device_mesh: each rank takes the features and depth scores of its
    slice; they are gathered, then the cross-hypothesis part scores the
    whole set on every rank."""
    n = poses.shape[0]
    if device_mesh is not None:
        poses, _ = shard_hypotheses(poses, device_mesh)

    def gather(x):  # every rank's rows, without the padding
        return x if device_mesh is None else all_gather(x, device_mesh)[:n]

    A, B, _, rend = _make_AB(mesh, poses, rgb01, xyz_map, K, crop_ratio, mesh_diameter, out_hw,
                             normalize_xyz, invalid_z_thresh=0.1, backface_cull=backface_cull,
                             plain_raster=plain_raster)
    score = torch.zeros(n, dtype=torch.float32, device=poses.device)
    if mode in ("network", "hybrid"):
        with network_autocast(poses.device, compute_dtype):
            logits = model.cross(gather(model.features(A, B)), L=n)
        # the winning pass gets +100, like scores_global[global_ids] = scores+100
        score = score + logits.reshape(-1).float() + 100.0
    if mode in ("depth", "hybrid"):
        score = score + gather(_depth_alignment_score(A, B, rend, poses, mesh_diameter))
    return score


@torch.no_grad()
def register_pipeline(rmodel, smodel, mesh: MeshArrays, poses, rgb01, depth, K, mesh_diameter,
                      crop_ratio, trans_normalizer, rot_normalizer, prune_to, coarse_iters,
                      iterations, out_hw=(160, 160), coarse_hw=None, normalize_xyz=False,
                      trans_rep="tracknet", rot_rep="axis_angle", score_mode="hybrid",
                      backface_cull=False, prune_schedule=None, score_crop_ratio=None,
                      score_normalize_xyz=None, score_hw=None, polish_top=0, polish_iters=0,
                      occ_sub=False, plain_raster=False, compute_dtype=torch.bfloat16):
    """The registration cascade: refine the full grid for coarse_iters at
    coarse_hw -> score -> keep the prune_to best -> refine the rest of the
    iterations at out_hw -> score -> (cascade polish) -> sort.
    @prune_schedule: (iters, keep) coarse stages in place of the single
    (coarse_iters, prune_to) cut; a stage is skipped when it would keep
    every pose or use up the iterations; coarse stages score at coarse_hw.
    @polish_top/@polish_iters: refine the polish_top best a further
    polish_iters iterations and rank them alongside the originals
    (polished first, so equal scores prefer them).
    @depth: already-filtered depth.  Returns (sorted_poses (K,4,4), sorted_scores (K,))."""
    xyz_map = depth2xyzmap(depth, K)
    n = poses.shape[0]
    common = dict(backface_cull=backface_cull, plain_raster=plain_raster,
                  compute_dtype=compute_dtype)

    def refine(p, iters, hw):
        return refine_poses(rmodel, mesh, p, rgb01, xyz_map, K, mesh_diameter, crop_ratio,
                            trans_normalizer, rot_normalizer, iters, hw, normalize_xyz,
                            rot_rep, occ_sub=occ_sub, trans_rep=trans_rep, **common)

    s_crop = crop_ratio if score_crop_ratio is None else score_crop_ratio
    s_norm = normalize_xyz if score_normalize_xyz is None else score_normalize_xyz
    final_hw = out_hw if score_hw is None else score_hw

    def score(p, hw):
        return score_poses(smodel, mesh, p, rgb01, xyz_map, K, mesh_diameter, s_crop, hw,
                           s_norm, score_mode, **common)

    def best_first(s):  # descending, equal scores in index order (lax.top_k's order)
        return torch.argsort(-s, stable=True)

    if prune_schedule is None and prune_to and prune_to < n and iterations > coarse_iters:
        prune_schedule = ((coarse_iters, prune_to),)
    for stage_iters, keep_k in prune_schedule or ():
        if keep_k >= poses.shape[0] or iterations <= stage_iters:
            continue
        chw = coarse_hw or out_hw
        poses = refine(poses, stage_iters, chw)
        poses = poses[best_first(score(poses, chw))[:keep_k]]
        iterations = iterations - stage_iters
    poses = refine(poses, iterations, out_hw)
    scores = score(poses, final_hw)
    if polish_top and polish_iters and polish_top <= poses.shape[0]:
        polished = refine(poses[best_first(scores)[:polish_top]], polish_iters, out_hw)
        poses = torch.cat([polished, poses])
        scores = torch.cat([score(polished, final_hw), scores])
    order = best_first(scores)
    return poses[order], scores[order]


def pack_rgbd(rgb_u8, depth_u16):
    """(H,W,3) uint8 + (H,W) uint16-mm -> one (H,W,5) uint8 buffer (one upload)."""
    return np.concatenate(
        [rgb_u8, depth_u16.view(np.uint8).reshape(*depth_u16.shape, 2)], axis=-1)


def unpack_rgbd(rgbd_u8):
    """(H,W,5) uint8 from pack_rgbd -> (colour in [0,1] (H,W,3), depth in
    metres (H,W)), float32, decoded as the JAX track program decodes them."""
    # XLA compiles a division by a constant into a multiply by its float32
    # reciprocal; the port follows the compiled program
    rgb01 = rgbd_u8[..., :3].float() * (1.0 / 255.0)
    depth_mm = rgbd_u8[..., 3].int() | (rgbd_u8[..., 4].int() << 8)  # little-endian uint16
    # the same for depth: a true / 1000 differs by an ulp on 38,850 of the
    # 65,536 values, which flips erosion's 1 mm test on millimetre depth
    return rgb01, depth_mm.float() * (1.0 / 1000.0)


@torch.no_grad()
def track_pose(model, mesh: MeshArrays, pose_last, rgbd_u8, K, mesh_diameter, crop_ratio,
               trans_normalizer, rot_normalizer, iterations: int, out_hw=(160, 160),
               normalize_xyz=False, rot_rep="axis_angle", backface_cull=False, occ_sub=False,
               polish_tgt=None, polish_tn=None, polish_tmask=None, plain_raster=False,
               compute_dtype=torch.bfloat16, trans_rep="tracknet"):
    """One tracking step on the device: unpack -> depth erode + bilateral ->
    xyz map -> refine -> (track polish).  @rgbd_u8: (H,W,5) uint8 tensor from
    pack_rgbd.  Returns (pose (1,4,4), filtered depth)."""
    rgb01, depth_raw = unpack_rgbd(rgbd_u8)
    depth = erode_depth(depth_raw, radius=2)
    depth = bilateral_filter_depth(depth, radius=2)
    xyz_map = depth2xyzmap(depth, K)
    poses = refine_poses(model, mesh, pose_last, rgb01, xyz_map, K, mesh_diameter, crop_ratio,
                         trans_normalizer, rot_normalizer, iterations, out_hw, normalize_xyz,
                         rot_rep, backface_cull, occ_sub, plain_raster, compute_dtype, trans_rep)
    if polish_tgt is not None:
        poses = _track_depth_polish(mesh, poses, rgb01, xyz_map, K, crop_ratio, polish_tgt,
                                    polish_tn, polish_tmask, mesh_diameter, backface_cull,
                                    plain_raster)
    return poses, depth


def _rigid_inv(tf):
    Rt = tf[:3, :3].T
    out = torch.eye(4, dtype=tf.dtype, device=tf.device)
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ tf[:3, 3]
    return out


def _track_depth_polish(model_mesh, poses, rgb01, xyz_map, K, crop_ratio, tgt, tgt_normals,
                        tgt_mask, mesh_diameter, backface_cull=False, plain_raster=False):
    """Per-frame depth polish after the learned refine: coarse + fine
    point-to-plane ICP of the visible observed cloud (one 96x96 render of the
    tracked pose selects it) against a dense model sampling, taken as a
    damped 0.7 step and kept only when the correction is plausible
    (< 20 deg, < 0.25 diameters, fitness > 0.05)."""
    pose0 = poses[0]
    d = mesh_diameter
    _, _, _, rend = _make_AB(model_mesh, poses, rgb01, xyz_map, K, crop_ratio, mesh_diameter,
                             (96, 96), normalize_xyz=False, invalid_z_thresh=0.001,
                             backface_cull=backface_cull, plain_raster=plain_raster)
    center = pose0[:3, 3]
    xyzB = (rend["xyzB_m"][0, ::2, ::2] + center).reshape(-1, 3)
    zA = rend["xyzA_m"][0, ::2, ::2, 2].reshape(-1) + center[2]
    # erode the rendered silhouette 2 px (5x5 min filter, SAME padding)
    a2 = -F.max_pool2d(-rend["alpha"][0][None, None], 5, stride=1, padding=2)[0, 0]
    alpha = a2[::2, ::2].reshape(-1) > 0
    obs = rend["obs_validB"][0, ::2, ::2].reshape(-1)
    valid = alpha & obs & ((xyzB[:, 2] - zA).abs() < 0.12 * d)
    init = _rigid_inv(pose0)
    r1 = icp_point_to_plane(xyzB, valid, tgt, tgt_normals, tgt_mask, init, 0.05 * d, max_iter=6)
    r2 = icp_point_to_plane(xyzB, valid, tgt, tgt_normals, tgt_mask, r1.transformation,
                            max(0.02 * d, 0.004), max_iter=6)
    polished = _rigid_inv(r2.transformation)
    dR = polished[:3, :3].T @ pose0[:3, :3]
    cos_ang = torch.clamp((torch.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    dt = torch.linalg.norm(polished[:3, 3] - pose0[:3, 3])
    ok = (cos_ang > math.cos(math.radians(20.0))) & (dt < 0.25 * d) & (r2.fitness > 0.05)
    step = 0.7  # damped step toward the depth optimum (1.0 oscillates)
    half_w = step * so3_log_map((polished[:3, :3] @ pose0[:3, :3].T)[None])
    blended = torch.eye(4, dtype=poses.dtype, device=poses.device)
    blended[:3, :3] = so3_exp_map(half_w)[0] @ pose0[:3, :3]
    blended[:3, 3] = step * polished[:3, 3] + (1.0 - step) * pose0[:3, 3]
    return torch.where(ok, blended[None], poses)


def _seeded_init(model: torch.nn.Module, generator: torch.Generator):
    """Draw every parameter from @generator: He-normal convolutions, LeCun-
    normal linears (the heads at a tenth of that, so seeded outputs stay
    inside tanh's range), zero biases, unit LayerNorm scales."""
    for name, p in model.named_parameters():
        with torch.no_grad():
            if p.ndim == 1:
                p.fill_(1.0 if name.endswith("norm1.weight") or name.endswith("norm2.weight")
                        else 0.0)
                continue
            fan_in = p[0].numel()
            std = math.sqrt(2.0 / fan_in) if p.ndim == 4 else math.sqrt(1.0 / fan_in)
            if name.startswith(("trans_head.1", "rot_head.1", "linear")):
                std *= 0.1
            p.copy_(torch.randn(p.shape, generator=generator) * std)


class _PredictorBase:
    def _setup(self, net, defaults, cfg, device, compute_dtype, ckpt_dir):
        self.cfg = dict(defaults)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.ckpt_path = checkpoint.resolve(ckpt_dir, net)
        if self.ckpt_path is not None:
            # the checkpoint's training-time cfg (the JAX predictor's OCC_SUB
            # marker), unless the caller sets the same keys
            self.cfg.update(checkpoint.cfg_overrides(self.ckpt_path, net))
        if cfg:
            self.cfg.update(cfg)

    def _build(self, model, net, params, seed, convert, ckpt_dir):
        if params is not None:
            model.load_state_dict(convert(params))
        else:
            sd = checkpoint.load_params(ckpt_dir, net, self.compute_dtype)
            if sd is not None:
                model.load_state_dict(sd)
            else:
                _seeded_init(model, torch.Generator().manual_seed(int(seed)))
        return model.to(self.device).eval()


class PoseRefinePredictor(_PredictorBase):
    """Refiner.  Weights, first match: @params, the JAX parameter tree as
    numpy arrays (converted through models/weights.py); @ckpt_dir, an
    export or `.pth` checkpoint (models/checkpoint.py); else a seeded
    initialisation.  @device: None = the CUDA card (raises without one),
    or e.g. "cpu"."""

    def __init__(self, device=None, cfg: Optional[dict] = None, params=None, seed=0,
                 compute_dtype=torch.bfloat16, ckpt_dir=None):
        self._setup("refiner", DEFAULT_REFINER_CFG, cfg, device, compute_dtype,
                    None if params is not None else ckpt_dir)
        self.model = self._build(RefineNet(c_in=self.cfg["c_in"], rot_rep=self.cfg["rot_rep"]),
                                 "refiner", params, seed, refine_state_dict, ckpt_dir)

    def predict(self, rgb, depth, K, ob_in_cams, xyz_map, normal_map=None, get_vis=False,
                mesh=None, mesh_tensors: MeshArrays = None, glctx=None, mesh_diameter=None,
                iteration=5, out_hw=None, backface_cull=None, plain_raster=False,
                device_mesh=None):
        """@iteration refine steps of the poses @ob_in_cams (N,4,4) against
        the frame (@rgb (H,W,3) uint8 or float, @xyz_map (H,W,3)) at @out_hw
        (default the cfg's input_resize).  @plain_raster: render through
        K1's plain version (a comparison run).  @device_mesh: the poses
        split across its ranks (`refine_poses`).  Returns (poses (N,4,4)
        tensor, vis: the crop grid of _make_vis when @get_vis, else None)."""
        dev = self.device
        rgb01 = to_rgb01(rgb, dev)
        xyz = torch.as_tensor(xyz_map, dtype=torch.float32, device=dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        poses = refine_poses(
            self.model, mesh_tensors, torch.as_tensor(ob_in_cams, dtype=torch.float32,
                                                      device=dev),
            rgb01, xyz, K, float(mesh_diameter), float(self.cfg["crop_ratio"]),
            float(self.cfg["trans_normalizer"]), float(self.cfg["rot_normalizer"]),
            int(iteration),
            out_hw=tuple(out_hw) if out_hw is not None else tuple(self.cfg["input_resize"]),
            normalize_xyz=bool(self.cfg["normalize_xyz"]), rot_rep=self.cfg["rot_rep"],
            # per call: one predictor may serve several meshes
            backface_cull=bool(self.cfg.get("backface_cull", False)
                               if backface_cull is None else backface_cull),
            occ_sub=self.cfg.get("occ_sub", False), plain_raster=plain_raster,
            compute_dtype=self.compute_dtype, trans_rep=self.cfg["trans_rep"],
            device_mesh=device_mesh)
        vis = None
        if get_vis:
            vis = self._make_vis(mesh_tensors, poses, rgb01, xyz, K, mesh_diameter,
                                 plain_raster=plain_raster)
        return poses, vis

    @torch.no_grad()
    def _make_vis(self, mesh_arrays, poses, rgb01, xyz_map, K, mesh_diameter,
                  plain_raster=False):
        """The rendered and the real crops (colour) of the first 16 poses,
        side by side a row each, as one uint8 RGB image."""
        from ..utils.vis import make_grid_image

        A, B, _, _ = _make_AB(mesh_arrays, poses, rgb01, xyz_map, K,
                              float(self.cfg["crop_ratio"]), float(mesh_diameter),
                              tuple(self.cfg["input_resize"]),
                              bool(self.cfg["normalize_xyz"]), 0.001,
                              plain_raster=plain_raster)
        rows = []
        for i in range(min(16, A.shape[0])):
            ra = (A[i, ..., :3] * 255).cpu().numpy().astype(np.uint8)
            rb = (B[i, ..., :3] * 255).cpu().numpy().astype(np.uint8)
            rows.append(make_grid_image([ra, rb], nrow=2))
        return make_grid_image(rows, nrow=1)


def _host(x):
    """A score vector as a numpy array (tensors from any device)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ScorePredictor(_PredictorBase):
    """Scorer: weights and @device as for PoseRefinePredictor.  A cfg
    "max_batch" scores more poses than that in a tournament of chunks
    (`predict`)."""

    def __init__(self, device=None, cfg: Optional[dict] = None, params=None, seed=1,
                 compute_dtype=torch.bfloat16, ckpt_dir=None):
        self._setup("scorer", DEFAULT_SCORER_CFG, cfg, device, compute_dtype,
                    None if params is not None else ckpt_dir)
        self.model = self._build(ScoreNetMultiPair(c_in=self.cfg["c_in"]), "scorer", params,
                                 seed, score_state_dict, ckpt_dir)

    def predict(self, rgb, depth, K, ob_in_cams, normal_map=None, get_vis=False, mesh=None,
                mesh_tensors: MeshArrays = None, glctx=None, mesh_diameter=None,
                out_hw=None, backface_cull=None, plain_raster=False, device_mesh=None):
        """Scores of the poses @ob_in_cams (N,4,4) against the frame (@rgb,
        @depth in metres, already filtered) at @out_hw, in the cfg's
        score_mode ("network" where the cfg has none, as in the JAX
        predictor).  More than the cfg's max_batch poses go through
        `_tournament`.  @device_mesh: every call of the scorer (each chunk
        of the tournament) split across its ranks (`score_poses`), so every
        rank keeps the same winners.  Returns (scores (N,) tensor, None)."""
        dev = self.device
        rgb01 = to_rgb01(rgb, dev)
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        xyz_map = depth2xyzmap(torch.as_tensor(depth, dtype=torch.float32, device=dev), K)

        def score_fn(poses):
            return score_poses(
                self.model, mesh_tensors, torch.as_tensor(poses, dtype=torch.float32, device=dev),
                rgb01, xyz_map, K, float(mesh_diameter), float(self.cfg["crop_ratio"]),
                out_hw=tuple(out_hw) if out_hw is not None else tuple(self.cfg["input_resize"]),
                normalize_xyz=bool(self.cfg["normalize_xyz"]),
                mode=self.cfg.get("score_mode", "network"),
                backface_cull=bool(self.cfg.get("backface_cull", False)
                                   if backface_cull is None else backface_cull),
                plain_raster=plain_raster, compute_dtype=self.compute_dtype,
                device_mesh=device_mesh)

        max_batch = self.cfg.get("max_batch")
        n = len(ob_in_cams)
        if max_batch is None or n <= max_batch:
            return score_fn(ob_in_cams), None
        # chunks of 1 elect themselves winner forever: never terminates
        scores = self._tournament(score_fn, _host(torch.as_tensor(ob_in_cams)),
                                  max(2, int(max_batch)))
        return scores.to(dev), None

    @staticmethod
    def _tournament(score_fn, poses_np, max_batch):
        """Multi-chunk elimination: each round splits the surviving poses
        into chunks of @max_batch (the last padded by repeating the first
        survivor) and keeps each chunk's argmax; the final round's scores
        + 100 land in the global vector.  An eliminated pose keeps the
        score of its last chunk (not 0), so a top-K cut over the vector
        ranks it by quality.  Returns the (N,) float32 scores (CPU tensor)."""
        n = len(poses_np)
        global_ids = np.arange(n)
        scores_global = np.zeros(n, dtype=np.float32)
        while True:
            m = len(global_ids)
            if m <= max_batch:
                scores_global[global_ids] = _host(score_fn(poses_np[global_ids])) + 100.0
                return torch.from_numpy(scores_global)
            pad = (-m) % max_batch
            # duplicates score alike, so a padded winner is still a real pose id
            padded = np.concatenate([global_ids, np.repeat(global_ids[:1], pad)])
            winners = []
            for chunk in padded.reshape(-1, max_batch):
                s = _host(score_fn(poses_np[chunk]))
                scores_global[chunk] = s
                winners.append(chunk[int(np.argmax(s))])
            global_ids = np.asarray(winners)
