"""Classical pose refinement and capture events: preprocessing, z search,
parallel-restart ICP, and the fused capture program.

Port of `sixdof_tpu/app/icp_pipeline.py` (`preprocess_target`,
`preprocess_source`, `predict_z_axis_adjustment`, `improve_result`,
`capture_event`, `capture_event_async`, `refine_pose_with_icp`, and the
`--icp` global registration: `refine_registration`, `run_icp`,
`determine_pose`, the FPFH features of the preprocessing, and the
standalone demo `demo_data` / `demo_icp`).  The restarts and the z ladder
run as one batched device call each (`ops/icp.py`); a capture event is one
device program whose defect ray trace runs in kernel K2; the FPFH features
and the RANSAC trials are host numpy (`ops/features.py`).  Units:
millimetres, the depth camera's frame.  `refine_pose_with_icp`,
`capture_event` and `capture_event_async` first join the engine's warm-up
thread (`estimater.join_precompile`), whose error they raise.

    python -m sixdof_tpu_torch.app.icp_pipeline [scene_dir]

replays the standalone ICP demo on the card (default demo_data/synth_box).
"""
from __future__ import annotations

import copy
import functools
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..estimater import join_precompile
from ..io.mesh_io import PointCloud, load_point_cloud
from ..ops import icp as icp_ops
from ..ops import pointcloud as pc
from ..ops import raytrace as rt
from ..ops.lie import euler_matrix
from .defect_projection import create_intersection_pcd, load_extrinsics


@dataclass
class RegistrationResult:
    """Open3D RegistrationResult stand-in."""

    transformation: np.ndarray = field(default_factory=lambda: np.eye(4))
    fitness: float = 0.0
    inlier_rmse: float = 0.0
    valid_trials: int = 0  # RANSAC (ops/features.py): the trials passing its checkers, scored


def _bucket(n, minimum=1024, maximum=1 << 20):
    size = minimum
    while size < n and size < maximum:
        size *= 2
    return size


def _pad_cloud(points, device, bucket=None):
    """(N,3) points -> (b,3) float32 zero-padded device tensor + (b,) mask,
    b a power-of-two bucket."""
    n = len(points)
    b = bucket or _bucket(n)
    pts = np.zeros((b, 3), dtype=np.float32)
    pts[:n] = points[:b]
    mask = np.zeros(b, dtype=bool)
    mask[: min(n, b)] = True
    return torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)


# ------------------------------------------------------------ preprocessing --


def preprocess_target(pcd: PointCloud, param):
    """Cap the target to max_pcd points and estimate its normals.
    Returns (target_processed, target_fpfh): the FPFH features when
    @param["compute_fpfh"] (the --icp path), else None."""
    params = param["preprocess_target"]
    target_processed = pc.random_down_sample(pcd, params["max_pcd"])
    if len(target_processed) == len(pcd):
        logging.info(f":: Point cloud already has less than or exactly {params['max_pcd']} "
                     "points.")
    pc.estimate_normals(target_processed, radius=2, max_nn=5)
    target_fpfh = None
    if param.get("compute_fpfh", False):
        target_fpfh = _compute_fpfh(target_processed, params.get("fpfh_radius", 20.0),
                                    params.get("fpfh_max_nn", 100))
    return target_processed, target_fpfh


def preprocess_source(pcd: PointCloud, background: PointCloud, param, i=0,
                      near_point=None, near_radius=None):
    """Scene-cloud cleanup: downsample, plane removal, background removal,
    cluster pick, outlier removal.  Returns (processed, processed, fpfh):
    fpfh is the processed cloud's FPFH features on the first frame when
    @param["compute_fpfh"] (the --icp path), else 0.

    @i: 0 on the first frame (orients the plane by the cloud's mean normal
    and estimates normals), > 0 at capture time (keeps the camera's side of
    the plane, downsamples at 5 mm).  @near_point/@near_radius: the expected
    object position (mm); the cluster step then keeps the cluster nearest to
    it instead of the largest."""
    params = param["preprocess_source"]
    down_sample = 5 if i > 0 else params["down_sample"]
    # the background cloud is static across captures: its downsample is
    # cached per (cloud, voxel), with the cloud itself pinned in the entry so
    # a recycled id() can never serve another scene's downsample
    cache = getattr(preprocess_source, "_bg_cache", None)
    ck = (id(background), float(down_sample))
    if cache is not None and cache[0] == ck and cache[2] is background:
        background_d = cache[1]
    else:
        background_d = pc.voxel_down_sample(background, voxel_size=down_sample * 2)
        preprocess_source._bg_cache = (ck, background_d, background)
    pcd_down = pc.voxel_down_sample(pcd, voxel_size=down_sample)

    plane_model, inliers = pc.segment_plane(
        pcd_down,
        distance_threshold=params["plane_removal"]["distance_threshold"],
        num_iterations=params["plane_removal"]["num_iterations"],
    )
    if i == 0:
        pc.estimate_normals(pcd_down, radius=2, max_nn=5)
        average_normal = pc.compute_average_normal(pcd_down)
        logging.info(f":: Average Normal for Source = {average_normal}")
        # normals face the camera; the plane normal must point along the
        # viewing direction so the object side (toward the camera) is kept
        plane_model, _ = pc.flip_plane_normal_if_needed(plane_model, -average_normal)
    elif plane_model[3] > 0:
        # capture time: keep the side the camera (the origin) is on
        plane_model = [-v for v in plane_model]
    source_processed = pc.remove_points_below_plane(pcd_down, plane_model)

    if param.get("box"):
        source_processed = pc.background_removal(source_processed, background_d)
    else:
        source_processed = pc.remove_plane(pcd_down, inliers)
    if param.get("mesh"):
        ms = params.get("mesh", {})
        source_processed = pc.smooth_resample(
            source_processed,
            radius=ms.get("radius", 5.0),
            n_iterations=ms.get("number_of_iterations", 10),
            n_points=ms.get("number_of_points", 3000),
        )
        pc.estimate_normals(source_processed, radius=2, max_nn=5)
    largest = pc.filter_largest_cluster(source_processed, near_point=near_point,
                                        near_radius=near_radius)
    if largest is not None:
        source_processed = largest
    source_processed = pc.remove_statistical_outliers(source_processed, nb_neighbors=75,
                                                      std_ratio=0.01)
    source_fpfh = 0
    if i == 0:
        pc.estimate_normals(background_d, radius=2, max_nn=5)
        pc.estimate_normals(source_processed, radius=2, max_nn=5)
        if param.get("compute_fpfh", False):
            source_fpfh = _compute_fpfh(source_processed, params.get("fpfh_radius", 20.0),
                                        params.get("fpfh_max_nn", 100))
    return source_processed, source_processed, source_fpfh


def _compute_fpfh(pcd, radius, max_nn):
    """The cloud's FPFH features, or None (with a warning) where they
    cannot be computed, as the JAX package keeps its main path alive."""
    from ..ops.features import compute_fpfh

    try:
        return compute_fpfh(pcd, radius=radius, max_nn=max_nn)
    except Exception as e:  # the features are optional: keep the caller running
        logging.warning(f":: FPFH computation failed: {e}")
        return None


# ------------------------------------------------------------------ device --


def _pad_target(target: PointCloud, device):
    """Padded device target (points, normals, mask), estimating normals if
    absent: shared by _DeviceClouds and CaptureContext so refinement and
    captures see the same target."""
    tb = _bucket(len(target))
    tgt, tgt_mask = _pad_cloud(target.points, device, tb)
    if target.normals is None:
        pc.estimate_normals(target, radius=2, max_nn=5)
    normals = np.zeros((tb, 3), dtype=np.float32)
    normals[: len(target.normals)] = target.normals[:tb]
    return tgt, torch.as_tensor(normals, device=device), tgt_mask


class _DeviceClouds:
    """Padded device-resident source/target for one refinement session."""

    def __init__(self, source: PointCloud, target: PointCloud, device):
        self.src, self.src_mask = _pad_cloud(source.points, device)
        self.tgt, self.tgt_normals, self.tgt_mask = _pad_target(target, device)


class CaptureContext:
    """Device-resident constants for repeated capture events: the processed
    target cloud, the model-mesh triangles, the heatmap rays, the restart
    noise and the colour->depth bridge are uploaded once.

    @device: None = the card; @plain_raytrace: every capture through this
    context takes K2's plain version (a comparison run)."""

    def __init__(self, target_processed: PointCloud, model_mesh, color_to_depth, device=None,
                 plain_raytrace=False):
        self.device = resolve_device(device)
        self.plain_raytrace = bool(plain_raytrace)
        dev = self.device
        self.tgt, self.tgt_normals, self.tgt_mask = _pad_target(target_processed, dev)
        self._n_target = len(target_processed)
        self._n_faces = len(model_mesh.faces)
        tri, tri_mask = rt.mesh_to_tri_verts(model_mesh.vertices, model_mesh.faces)
        self.tri = torch.as_tensor(tri, device=dev)
        self.tri_mask = torch.as_tensor(tri_mask, device=dev)
        self._color_to_depth = np.asarray(color_to_depth, dtype=np.float64).copy()
        self.depth_to_color = torch.as_tensor(np.linalg.inv(color_to_depth),
                                              dtype=torch.float32, device=dev)
        self._ray_key = None
        self._rays = None
        self._restart_cache = None
        self._pose_consts = None

    def check(self, target_processed, model_mesh, color_to_depth):
        """Refuse a context built for another target, mesh or extrinsic: its
        cached device constants would silently win over the call's."""
        if (len(target_processed) != self._n_target
                or len(model_mesh.faces) != self._n_faces
                or not np.allclose(color_to_depth, self._color_to_depth)):
            raise ValueError(
                "CaptureContext was built for a different target/mesh/extrinsic "
                "than this capture_event call; rebuild the context"
            )

    def rays_device(self, ray_dirs, ray_mask, intensities):
        """The heatmap rays on the device, cached by content."""
        dirs = np.ascontiguousarray(np.asarray(ray_dirs, dtype=np.float32))
        mask = np.ascontiguousarray(np.asarray(ray_mask, dtype=bool))
        inten = np.ascontiguousarray(np.asarray(intensities, dtype=np.float64))
        key = (dirs.shape, dirs.tobytes(), mask.tobytes(), inten.tobytes())
        if self._ray_key != key:
            self._rays = (torch.as_tensor(dirs, device=self.device),
                          torch.as_tensor(mask, device=self.device), inten)
            self._ray_key = key
        return self._rays

    def restarts_device(self, parameters, n_restarts=None, seed=0):
        """The restart noise and thresholds on the device, cached (they do
        not depend on the pose).  Returns (noise (K,4,4), thresholds (K,),
        base_thresh, max_iter, K)."""
        base_thresh = float(parameters["refine_registration"]["distance_threshold"])
        if n_restarts is None:
            n_restarts = int(parameters.get("run_icp", {}).get("n_restarts", 50))
        max_iter = int(parameters.get("run_icp", {}).get("max_iter", 30))
        key = (base_thresh, int(n_restarts), max_iter, int(seed))
        if self._restart_cache is not None and self._restart_cache[0] == key:
            return self._restart_cache[1]
        noise, thresholds = _restart_noise(base_thresh, n_restarts, seed)
        out = (torch.as_tensor(noise, dtype=torch.float32, device=self.device),
               torch.as_tensor(thresholds, device=self.device), base_thresh, max_iter,
               int(n_restarts))
        self._restart_cache = (key, out)
        return out

    def pose_consts_device(self, tf_to_centered):
        """The centred->original mesh compose and the mm colour->depth
        extrinsic on the device (both static per scene)."""
        key = np.asarray(tf_to_centered, dtype=np.float64).tobytes()
        if self._pose_consts is not None and self._pose_consts[0] == key:
            return self._pose_consts[1]
        out = (torch.as_tensor(tf_to_centered, dtype=torch.float32, device=self.device),
               torch.as_tensor(self._color_to_depth, dtype=torch.float32, device=self.device))
        self._pose_consts = (key, out)
        return out


# ------------------------------------------------------------------ search --


def predict_z_axis_adjustment(source, target, initial_fp_transformation, param,
                              max_adjustment=50, step=2.5, clouds=None, device=None):
    """Best z offset from a ladder of one-iteration ICP probes over
    +-max_adjustment mm, all evaluated at once.  Returns (best_adjustment,
    fitness, rmse); `tf[2,3] += best_adjustment` gives the best probe.
    @clouds: the padded device clouds of @source and @target, when the
    caller has them; else they are built on @device (None = the card)."""
    dc = clouds if clouds is not None else _DeviceClouds(source, target, resolve_device(device))
    zs = np.arange(-max_adjustment, max_adjustment + step / 2, step)
    tfs = np.tile(np.eye(4, dtype=np.float32)[None], (len(zs), 1, 1))
    base = np.asarray(initial_fp_transformation, dtype=np.float32)
    for k, z in enumerate(zs):
        t = base.copy()
        t[2, 3] += z
        tfs[k] = np.linalg.inv(t)  # source->target init
    res = icp_ops.icp_one_iter_batch(
        dc.src, dc.src_mask, dc.tgt, dc.tgt_normals, dc.tgt_mask,
        torch.as_tensor(tfs, device=dc.src.device),
        float(param["refine_registration"]["distance_threshold"]),
    )
    fit = res.fitness.cpu().numpy()
    rmse = res.inlier_rmse.cpu().numpy()
    best = np.lexsort((rmse, -fit))[0]
    logging.info(f":: Best z-axis adjustment: {zs[best]:.2f}mm, Fitness: {fit[best]:.4f}, "
                 f"RMSE: {rmse[best]:.4f}")
    return float(zs[best]), float(fit[best]), float(rmse[best])


@functools.lru_cache(maxsize=32)
def _restart_noise(base_thresh, n_restarts, seed=0):
    """Pose-independent restart noise: threshold jitter U(0.8,1.2), rotation
    noise U(-0.01,0.01) rad, translation U(-x,x) with x escalating across the
    batch.  Row 0 is the identity at the base threshold (the unperturbed
    seed).  Returns (noise (K,4,4) float64, thresholds (K,) float32);
    lru-cached, so callers must not mutate them."""
    rng = np.random.RandomState(seed)
    K = int(n_restarts)
    noise_tfs = np.zeros((K, 4, 4), dtype=np.float64)
    thresholds = np.zeros(K, dtype=np.float32)
    xs = np.concatenate([np.full(K // 2, 0.1), np.linspace(0.1, 1.0, K - K // 2)])
    for k in range(K):
        if k == 0:
            noise_tfs[k] = np.eye(4)
            thresholds[k] = base_thresh
            continue
        thresholds[k] = base_thresh * rng.uniform(0.8, 1.2)
        noise = euler_matrix(*[rng.uniform(-0.01, 0.01) for _ in range(3)])
        noise[:3, 3] = rng.uniform(-xs[k], xs[k], 3)
        noise_tfs[k] = noise
    return noise_tfs, thresholds


def _build_restarts(current_result, parameters, n_restarts=None, seed=0):
    """Host-seeded restart batch.  Returns (best_transformation,
    tfs (K,4,4) float32, thresholds (K,), base_thresh, max_iter, K)."""
    if not hasattr(current_result, "fitness") or current_result.fitness is None:
        init_tf = np.asarray(current_result, dtype=np.float64)
    else:
        init_tf = np.asarray(current_result.transformation, dtype=np.float64)
    # the caller gives target->source ("object in scene"); ICP refines the
    # inverse (source->target)
    best_transformation = np.linalg.inv(init_tf)
    base_thresh = float(parameters["refine_registration"]["distance_threshold"])
    if n_restarts is None:
        n_restarts = int(parameters.get("run_icp", {}).get("n_restarts", 50))
    max_iter = int(parameters.get("run_icp", {}).get("max_iter", 30))
    noise_tfs, thresholds = _restart_noise(base_thresh, n_restarts, seed)
    tfs = (noise_tfs @ best_transformation).astype(np.float32)
    return best_transformation, tfs, thresholds, base_thresh, max_iter, n_restarts


def improve_result(source_processed, original_target_processed, current_result, parameter,
                   n_restarts=None, seed=0, clouds=None, device=None):
    """Parallel random-restart point-to-plane refinement: all restarts in one
    batched device call, plus the unrefined transform's own score (never
    regress); the best by (fitness, -rmse).  @current_result: a
    RegistrationResult or a raw 4x4 (object in scene).  @clouds: the
    padded device clouds of the two clouds, when the caller has them; else
    they are built on @device (None = the card)."""
    parameters = copy.deepcopy(parameter)
    dc = clouds if clouds is not None else _DeviceClouds(
        source_processed, original_target_processed, resolve_device(device))
    dev = dc.src.device
    best_transformation, tfs, thresholds, base_thresh, max_iter, K = _build_restarts(
        current_result, parameters, n_restarts, seed
    )
    res, f0, r0 = icp_ops.icp_batch_with_eval(
        dc.src, dc.src_mask, dc.tgt, dc.tgt_normals, dc.tgt_mask,
        torch.as_tensor(tfs, device=dev), torch.as_tensor(thresholds, device=dev),
        torch.as_tensor(best_transformation, dtype=torch.float32, device=dev), base_thresh,
        max_iter=max_iter,
    )
    fit = np.concatenate([res.fitness.cpu().numpy(), f0.cpu().numpy().reshape(1)])
    rmse = np.concatenate([res.inlier_rmse.cpu().numpy(), r0.cpu().numpy().reshape(1)])
    tf_all = np.concatenate([res.transformation.cpu().numpy(),
                             best_transformation[None].astype(np.float32)])
    valid = (fit > 0) & (rmse > 0)
    if not valid.any():
        best = len(fit) - 1  # nothing converged: keep the initial transform
        logging.info(":: No restart improved the result; keeping the initial transform")
    else:
        fit = np.where(valid, fit, -1.0)
        best = np.lexsort((rmse, -fit))[0]
    logging.info(f":: Improved result: Fitness = {fit[best]:.4f}, RMSE = {rmse[best]:.4f} "
                 f"(over {K} parallel restarts)")
    return RegistrationResult(tf_all[best].astype(np.float64), float(fit[best]),
                              float(rmse[best]))


def _capture_outputs(tf_all, fit, rmse, best, t, ray_dirs, ray_mask, intensities):
    """Host arrays of one capture -> (RegistrationResult, defect PointCloud)."""
    best = int(best)
    out = RegistrationResult(tf_all[best].astype(np.float64), float(fit[best]),
                             float(rmse[best]))
    hit = np.isfinite(t) & np.asarray(ray_mask, dtype=bool)
    pts = np.asarray(ray_dirs)[hit] * t[hit, None]
    if len(pts) == 0:
        return out, PointCloud(np.zeros((0, 3)))
    return out, create_intersection_pcd(pts, np.asarray(intensities)[hit])


def capture_event(source_processed, target_processed, current_result, parameter,
                  model_mesh, ray_dirs, ray_mask, intensities, color_to_depth,
                  n_restarts=None, seed=0, clouds=None, ctx: CaptureContext = None, device=None):
    """One defect-capture event as one device program: restart ICP + the
    initial transform's evaluation + the best pick + the defect ray trace on
    the re-posed mesh (ops/icp.py::improve_and_raytrace), read back at once.

    @model_mesh: TriMesh in the MODEL frame (mm); @ray_dirs/@ray_mask/
    @intensities: colour-frame heatmap rays (defect_projection.compute_rays).
    The device constants and the ray-trace route (kernel or plain) come from
    @ctx; without one a context is built for this call, on the device of
    @clouds (the padded clouds, whose source and target then stand in for
    @source_processed and @target_processed, as in JAX) or on @device
    (None = the card).  Returns (RegistrationResult, intersection PointCloud)."""
    join_precompile()
    parameters = copy.deepcopy(parameter)
    best_transformation, tfs, thresholds, base_thresh, max_iter, K = _build_restarts(
        current_result, parameters, n_restarts, seed
    )
    from_clouds = ctx is None and clouds is not None
    if ctx is None:
        ctx = CaptureContext(target_processed, model_mesh, color_to_depth,
                             device=clouds.src.device if from_clouds else device)
    ctx.check(target_processed, model_mesh, color_to_depth)
    dev = ctx.device
    if from_clouds:
        src, src_mask = clouds.src, clouds.src_mask
        tgt, tgt_normals, tgt_mask = clouds.tgt, clouds.tgt_normals, clouds.tgt_mask
    else:
        src, src_mask = _pad_cloud(source_processed.points, dev)
        tgt, tgt_normals, tgt_mask = ctx.tgt, ctx.tgt_normals, ctx.tgt_mask
    rays_d, ray_mask_d, intensities = ctx.rays_device(ray_dirs, ray_mask, intensities)
    arrs = icp_ops.improve_and_raytrace(
        src, src_mask, tgt, tgt_normals, tgt_mask,
        torch.as_tensor(tfs, device=dev), torch.as_tensor(thresholds, device=dev),
        torch.as_tensor(best_transformation, dtype=torch.float32, device=dev), base_thresh,
        ctx.tri, ctx.tri_mask, rays_d, ray_mask_d, ctx.depth_to_color, max_iter=max_iter,
        plain_raytrace=ctx.plain_raytrace,
    )
    out, pcd = _capture_outputs(*(a.cpu().numpy() for a in arrs), ray_dirs, ray_mask,
                                intensities)
    logging.info(f":: Capture event: Fitness = {out.fitness:.4f}, RMSE = {out.inlier_rmse:.4f} "
                 f"(over {K} parallel restarts)")
    return out, pcd


class PendingCapture:
    """Handle for an in-flight capture event (capture_event_async).

    The device outputs (tf_all, fit, rmse, best, t_hit) are copied to pinned
    host memory without blocking and a CUDA event marks the copies;
    `.result()` waits on that event only and returns (and caches) the same
    (RegistrationResult, intersection PointCloud) tuple as capture_event."""

    __slots__ = ("_host", "_event", "_rays", "_mask", "_inten", "_n_restarts", "_out")

    def __init__(self, arrs, ray_dirs, ray_mask, intensities, n_restarts):
        if arrs[0].is_cuda:
            self._host = []
            for a in arrs:
                h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                h.copy_(a, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [a.clone() for a in arrs]
            self._event = None
        self._rays = np.asarray(ray_dirs)
        self._mask = np.asarray(ray_mask, dtype=bool)
        self._inten = np.asarray(intensities)
        self._n_restarts = n_restarts
        self._out = None

    def result(self):
        if self._out is not None:
            return self._out
        if self._event is not None:
            self._event.synchronize()
        self._out = _capture_outputs(*(h.numpy() for h in self._host), self._rays, self._mask,
                                     self._inten)
        out = self._out[0]
        logging.info(f":: Capture event: Fitness = {out.fitness:.4f}, "
                     f"RMSE = {out.inlier_rmse:.4f} "
                     f"(over {self._n_restarts} parallel restarts, async)")
        return self._out


def capture_event_async(source_processed, pose_dev, tf_to_centered, parameter,
                        ray_dirs, ray_mask, intensities, ctx: CaptureContext,
                        n_restarts=None, seed=0):
    """Dispatch one capture event seeded from the DEVICE tracked pose and
    return a PendingCapture at once: nothing on the dispatch path waits for
    the device.

    Same search and results as capture_event(..., ctx=ctx) seeded with
    `color_to_depth @ mm(pose)`, with the seed computed on the device
    (ops/icp.py::capture_from_pose).  @pose_dev: (4,4)/(1,4,4) tensor, the
    CENTRED-mesh pose in colour-camera metres (`PendingPose.device_pose()`
    or `FoundationPose.pose_last`); @tf_to_centered:
    FoundationPose.get_tf_to_centered_mesh()."""
    join_precompile()
    noise_d, thr_d, base_thresh, max_iter, K = ctx.restarts_device(parameter, n_restarts, seed)
    tf_center_d, c2d_d = ctx.pose_consts_device(tf_to_centered)
    rays_d, ray_mask_d, intensities = ctx.rays_device(ray_dirs, ray_mask, intensities)
    src, src_mask = _pad_cloud(source_processed.points, ctx.device)
    pose_dev = torch.as_tensor(pose_dev, dtype=torch.float32, device=ctx.device)
    arrs = icp_ops.capture_from_pose(
        src, src_mask, ctx.tgt, ctx.tgt_normals, ctx.tgt_mask,
        pose_dev, tf_center_d, c2d_d, noise_d, thr_d, base_thresh,
        ctx.tri, ctx.tri_mask, rays_d, ray_mask_d, ctx.depth_to_color,
        max_iter=max_iter, plain_raytrace=ctx.plain_raytrace,
    )
    return PendingCapture(arrs, ray_dirs, ray_mask, intensities, K)


# ------------------------------------------------------------------- mains --


def refine_pose_with_icp(source, target, background, initial_fp_transformation, parameters,
                         device=None):
    """Full classical refinement: preprocess + z search + parallel restarts.

    @initial_fp_transformation: object in scene (depth camera, mm).
    Returns (target_transformed, best_result_icp, z_adjustment,
    target_processed)."""
    join_precompile()
    dev = resolve_device(device)
    param = copy.deepcopy(parameters)
    initial_fp_transformation = np.array(initial_fp_transformation, dtype=np.float64)

    source.paint_uniform_color([1, 0, 0])
    target.paint_uniform_color([0, 0, 1])

    target_processed, _ = preprocess_target(target, param)
    tb = target.points.max(axis=0) - target.points.min(axis=0)
    source_processed, _, _ = preprocess_source(
        source, background, param,
        near_point=initial_fp_transformation[:3, 3],
        near_radius=0.75 * float(np.linalg.norm(tb)))

    clouds = _DeviceClouds(source_processed, target_processed, dev)
    z_adjustment, best_fitness, best_rmse = predict_z_axis_adjustment(
        source_processed, target_processed, initial_fp_transformation, param, clouds=clouds)
    initial_fp_transformation[2, 3] += z_adjustment
    logging.info(f":: Predicted Z-axis adjustment: {z_adjustment:.2f}mm")

    result_icp = RegistrationResult(initial_fp_transformation, best_fitness, best_rmse)
    best_result_icp = improve_result(source_processed, target_processed, result_icp, param,
                                     clouds=clouds)
    logging.info(
        f"-- Final Results"
        f"\n:: Refine registration results: Inlier_rmse: {best_result_icp.inlier_rmse:.4f}, "
        f"Fitness: {best_result_icp.fitness:.4f}"
        f"\n:: Final Transformation Matrix:\n{np.linalg.inv(best_result_icp.transformation)}"
    )
    target_transformed = target.copy()
    target_transformed.transform(np.linalg.inv(best_result_icp.transformation))
    return target_transformed, best_result_icp, z_adjustment, target_processed



# ------------------------------------------------- global registration --


def refine_registration(source: PointCloud, target: PointCloud, transformation, param,
                        device=None):
    """One point-to-plane ICP run of 30 iterations from @transformation
    (source->target) at refine_registration's distance threshold, on
    @device (None = the card)."""
    dc = _DeviceClouds(source, target, resolve_device(device))
    dev = dc.src.device
    res = icp_ops.icp_batch(
        dc.src, dc.src_mask, dc.tgt, dc.tgt_normals, dc.tgt_mask,
        torch.as_tensor(np.asarray(transformation, dtype=np.float32), device=dev)[None],
        torch.as_tensor([float(param["refine_registration"]["distance_threshold"])],
                        dtype=torch.float32, device=dev),
        max_iter=30,
    )
    return RegistrationResult(res.transformation[0].cpu().numpy().astype(np.float64),
                              float(res.fitness[0]), float(res.inlier_rmse[0]))


def run_icp(source_processed, target_processed, source_fpfh, target_fpfh, param, device=None):
    """Global registration (RANSAC over FPFH matches) refined by ICP: the
    --icp path.  Returns (result_icp, result_ransac)."""
    from ..ops.features import execute_global_registration

    result_ransac = execute_global_registration(
        source_processed, target_processed, source_fpfh, target_fpfh, param)
    result_icp = refine_registration(source_processed, target_processed,
                                     result_ransac.transformation, param, device=device)
    return result_icp, result_ransac


def determine_pose(source, target, background, initial_fp_transformation, parameters,
                   icp=False, device=None):
    """The object's pose in the scene cloud, either from the FoundationPose
    pose @initial_fp_transformation (z search, then the restarts) or, with
    @icp, by global registration (up to 10 attempts until run_icp's fitness
    and rmse thresholds hold), then the restarts.  On @device (None = the
    card).  Returns (target_transformed, best_result_icp, z_adjustment,
    target_processed)."""
    dev = resolve_device(device)
    param = copy.deepcopy(parameters)
    if icp:
        param["compute_fpfh"] = True  # the RANSAC path consumes features
    source.paint_uniform_color([1, 0, 0])
    target.paint_uniform_color([0, 0, 1])
    start_time_total = time.perf_counter()
    target_processed, target_fpfh = preprocess_target(target, param)
    if icp:
        near, nr = None, None  # global registration has no prior pose
    else:
        tb = target.points.max(axis=0) - target.points.min(axis=0)
        near = np.asarray(initial_fp_transformation)[:3, 3]
        nr = 0.75 * float(np.linalg.norm(tb))
    source_processed, _, source_fpfh = preprocess_source(
        source, background, param, near_point=near, near_radius=nr)

    if icp:
        result_icp, _ = run_icp(source_processed, target_processed, source_fpfh, target_fpfh,
                                param, device=dev)
        attempts = 1
        while (result_icp.fitness < param["run_icp"]["fitness_threshold"]
               or result_icp.inlier_rmse > param["run_icp"]["rmse_threshold"]) \
                and attempts < 10:
            result_icp, _ = run_icp(source_processed, target_processed, source_fpfh,
                                    target_fpfh, param, device=dev)
            attempts += 1
        result_icp.transformation = np.linalg.inv(result_icp.transformation)
        z_adjustment = 0
    clouds = _DeviceClouds(source_processed, target_processed, dev)
    if not icp:
        z_adjustment, best_fitness, best_rmse = predict_z_axis_adjustment(
            source_processed, target_processed, initial_fp_transformation, param,
            clouds=clouds)
        initial_fp_transformation = np.array(initial_fp_transformation, dtype=np.float64)
        initial_fp_transformation[2, 3] += z_adjustment
        result_icp = RegistrationResult(initial_fp_transformation, best_fitness, best_rmse)

    best_result_icp = improve_result(source_processed, target_processed, result_icp, param,
                                     clouds=clouds)
    logging.info(
        f"-- Final Results"
        f"\n:: Refine registration results: Inlier_rmse: {best_result_icp.inlier_rmse:.4f}, "
        f"Fitness: {best_result_icp.fitness:.4f}"
        f"\n:: Pose Estimation Execution Time: {time.perf_counter() - start_time_total:.2f} "
        "seconds"
    )
    target_transformed = target.copy()
    target_transformed.transform(np.linalg.inv(best_result_icp.transformation))
    return target_transformed, best_result_icp, z_adjustment, target_processed


# ------------------------------------------------------------------- demos --


def demo_data(base_dir="demo_data/synth_box", frame="0000"):
    """The standalone ICP demo's inputs: (target model cloud, scene cloud,
    background, initial pose (depth camera, mm) from debug/ob_in_cam/ or
    else the annotated pose, ICP parameters)."""
    source = load_point_cloud(f"{base_dir}/pcd/cloud_{frame}.ply")
    background = load_point_cloud(f"{base_dir}/background/box.ply")
    target = load_point_cloud(f"{base_dir}/mesh/model.ply")

    pose_file = f"debug/ob_in_cam/{frame}.txt"
    if not os.path.exists(pose_file):
        pose_file = f"{base_dir}/annotated_poses/{frame}.txt"
    scaled = np.loadtxt(pose_file).reshape(4, 4)
    scaled[:3, -1] *= 1000.0
    color_to_depth, _ = load_extrinsics(base_dir)
    initial = color_to_depth @ scaled
    with open(f"{base_dir}/configs/icp_parameters.json") as f:
        icp_param = json.load(f)
    return target, source, background, initial, icp_param


def demo_icp(base_dir="demo_data/synth_box", tries=1, icp=False, device=None):
    """Replay determine_pose on the demo inputs @tries times; returns the
    mean seconds a try."""
    target, source, background, initial, icp_param = demo_data(base_dir)
    t0 = time.perf_counter()
    for i in range(tries):
        determine_pose(source, target, background, initial.copy(), icp_param, icp=icp,
                       device=device)
        logging.info(f"Try number {i}")
    total = time.perf_counter() - t0
    logging.info(f"Average time for {tries} iterations {total / tries}\n Total time {total}")
    return total / tries


if __name__ == "__main__":
    import sys

    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")
    demo_icp(sys.argv[1] if len(sys.argv) > 1 else "demo_data/synth_box")
