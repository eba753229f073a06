"""FoundationPose engine: rotation-grid registration + frame-to-frame tracking.

Port of `sixdof_tpu/estimater.py::FoundationPose`, with its signatures:
`register(K, rgb, depth, ob_mask, ob_id=None, glctx=None, iteration=5)` on
the first frame and `track_one(rgb, depth, K, iteration, extra=None,
sync=True)` on every later one, with the same conventions (meters, OpenCV
colour-camera frame, poses w.r.t. the ORIGINAL mesh origin via the
centred-mesh compose).  Depth filtering, hypothesis rendering, refinement,
scoring and the depth polishes run on the estimator's device; the host
guesses the initial translation from the mask and orchestrates.

Registration runs the fused cascade (models/predict.py::register_pipeline)
or, at `debug >= 2` or with a `device_mesh`, the JAX engine's staged path:
refine and score as separate predictor calls, with (at `debug >= 2`) the
refiner's crops written to `{debug_dir}/vis_refiner.png`.  With a
`device_mesh` (parallel/sharding.py: one process a rank) every stage splits
the hypotheses across the ranks, and every rank returns the same pose;
tracking is not sharded, as in JAX.

`precompile_async` is the start-up path (the JAX engine's, which compiles
its programs in background threads): one daemon thread takes, before the
first real frame, what a process pays once on the card: it builds and
loads the kernel libraries (`kernels/build.py`, whose hash-named libraries
are the port's build cache), and runs register's cascade with the depth
polish, one track step and, given the scene's ICP parameters, one capture
program on a synthetic frame at the app's shapes, so that the CUDA
modules, the cuBLAS/cuDNN/cuSOLVER handles and the allocator's first
segments are there.  It touches no state of the engine, draws from no
seeded generator and counts its kernel launches apart
(`precompile_record`).  `register()`, `track_one()` and the capture
entries (`app/icp_pipeline.py`) join it before their first device work
(`join_precompile`), and an error in it is raised again there.  Eager
PyTorch has no compile to detour around, so JAX's staged detour while the
fused program compiles has no counterpart.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from .device import resolve_device
from .io.mesh_io import PointCloud, TriMesh
from .io import png
from .io.png import write_png_rgb8
from .kernels import raster, raytrace
from .kernels.build import build_all, launches_apart
from .models.predict import (PoseRefinePredictor, ScorePredictor, pack_rgbd, register_pipeline,
                             to_rgb01, track_pose)
from .ops.depth_filter import bilateral_filter_depth, erode_depth
from .ops.geometry import compute_mesh_diameter, depth2xyzmap
from .ops.hypotheses import make_rotation_grid
from .ops.icp import capture_from_pose, icp_polish_two_pass
from .ops.pointcloud import voxel_down_sample
from .ops.rasterize import make_mesh_arrays
from .ops.raytrace import mesh_to_tri_verts
from .parallel.sharding import pad_hypotheses

_warmups = set()  # warm-ups not joined yet
_warmups_lock = threading.Lock()


class _Warmup:
    """One engine warm-up thread: what it records (its work's parts, and
    when it started, finished and was joined, on `time.perf_counter`), and
    the error it raised (kept for the join)."""

    def __init__(self, work, record):
        self.record = record
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(work,), daemon=True,
                                       name="sixdof-precompile")
        with _warmups_lock:
            _warmups.add(self)
        self.thread.start()

    def _run(self, work):
        self.record["started"] = time.perf_counter()
        try:
            # autocast is entered per network call by the predict functions,
            # in this thread, as on the main path
            with launches_apart(self.record["launches"]), torch.inference_mode():
                work()
        except Exception as e:  # raised again at the join
            self.error = e
        finally:
            self.record["finished"] = time.perf_counter()

    def join(self):
        t0 = time.perf_counter()
        if self.thread.is_alive():
            logging.info("waiting for the engine's warm-up")
        self.thread.join()
        with _warmups_lock:
            if self not in _warmups:
                return
            _warmups.discard(self)
        self.record["joined"] = time.perf_counter()
        self.record["waited_s"] = self.record["joined"] - t0
        if self.error is not None:
            raise self.error


def join_precompile():
    """Wait for every engine warm-up that has not been joined; the first one
    that failed raises its error here (the run fails with it)."""
    with _warmups_lock:
        pending = list(_warmups)
    for w in pending:
        w.join()


class PendingPose:
    """Handle for an in-flight tracked pose (track_one(sync=False)).

    The device pose stays referenced (`device_pose()`, what a capture event
    seeds from without a host sync).  On the card it is also copied to
    pinned host memory without blocking, and a CUDA event marks the copy;
    `.numpy()` waits on that event only and returns the 4x4 in the
    original-mesh frame (the sync return value)."""

    __slots__ = ("_dev", "_host", "_event", "_tf", "_np")

    def __init__(self, dev, tf_to_centered_mesh):
        self._dev = dev
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = dev.clone()
            self._event = None
        self._tf = tf_to_centered_mesh
        self._np = None

    def device_pose(self):
        """The (1,4,4) float32 pose tensor of the centred mesh, on the device."""
        return self._dev

    def centered(self):
        """The host 4x4 in the centred-mesh frame (waits for the copy only)."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().reshape(4, 4).astype(np.float64)

    def numpy(self):
        if self._np is None:
            self._np = self.centered() @ self._tf
        return self._np


class FoundationPose:
    def __init__(self, model_pts, model_normals, symmetry_tfs=None, mesh: TriMesh = None,
                 scorer: ScorePredictor = None, refiner: PoseRefinePredictor = None,
                 glctx=None, debug=0, debug_dir="debug/fp", prune_to=None, device_mesh=None,
                 coarse_hw=(96, 96), prune_schedule=None, track_crop=True, polish_top=0,
                 polish_iters=2, depth_polish=True, track_polish=True, device=None,
                 plain_raster=False):
        """The JAX engine's parameters in its order, then the port's own
        (@device, @plain_raster).  @glctx: accepted and ignored, as in JAX.
        @prune_to: keep this many hypotheses after 2 coarse refine
        iterations over the full grid at @coarse_hw (None: no pruning).
        @prune_schedule: (iters, keep) coarse stages in place of prune_to's
        single cut (models/predict.py::register_pipeline).
        @track_crop: upload only a window around the tracked pose.
        @polish_top/@polish_iters: the cascade polish (0 disables).
        @depth_polish: ICP-polish the registered top pose against the
        masked observed cloud.  @track_polish: the same polish, guarded,
        after every track step.
        @device: None = the CUDA card (raises without one), or e.g. "cpu".
        @debug: >= 2 registers through the staged path, writes the
        refiner's crops to {@debug_dir}/vis_refiner.png and tracks full
        frames (no upload crop).
        @plain_raster: render every hypothesis through the raster kernel's
        plain PyTorch version instead of the kernel (a comparison run).
        @device_mesh: a `parallel/sharding.py` mesh; register goes through
        the staged path with the hypotheses split across its ranks (every
        rank calls register on the same frame)."""
        self.device = resolve_device(device)
        self.device_mesh = device_mesh
        self.debug = debug
        self.debug_dir = debug_dir
        self.plain_raster = bool(plain_raster)
        self.prune_to = prune_to
        self.prune_schedule = tuple(tuple(s) for s in prune_schedule) if prune_schedule else None
        self.polish_top = int(polish_top or 0)
        self.polish_iters = int(polish_iters or 0)
        self.depth_polish = bool(depth_polish)
        self.track_polish = bool(track_polish)
        self.track_crop = bool(track_crop)
        self.coarse_hw = tuple(coarse_hw) if coarse_hw is not None else None
        self.reset_object(model_pts, model_normals, symmetry_tfs=symmetry_tfs, mesh=mesh)
        self.make_rotation_grid(min_n_views=40, inplane_step=60)
        self._track_crop_margin = 1.4
        self._crop_pose_host = None
        self._crop_size = None
        self._last_center_px = None
        self._pose_hist = deque()
        self.scorer = scorer if scorer is not None else ScorePredictor(self.device)
        self.refiner = refiner if refiner is not None else PoseRefinePredictor(self.device)
        self.pose_last = None  # per the centred mesh
        self.gt_pose = None  # set by a caller that has one: compute_add_err_to_gt_pose
        self._warmup = None
        self.precompile_record = None  # the last warm-up's parts, filled by its thread

    # ------------------------------------------------------------- setup --

    def reset_object(self, model_pts, model_normals, symmetry_tfs=None, mesh: TriMesh = None):
        """Centre the mesh at its bbox centre and build device tensors."""
        dev = self.device
        max_xyz = mesh.vertices.max(axis=0)
        min_xyz = mesh.vertices.min(axis=0)
        self.model_center = (min_xyz + max_xyz) / 2
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices - self.model_center.reshape(1, 3)
        self.diameter = compute_mesh_diameter(model_pts=mesh.vertices, n_sample=10000)
        self.vox_size = max(self.diameter / 20.0, 0.003)
        pcd = voxel_down_sample(PointCloud(mesh.vertices, normals=np.asarray(mesh.vertex_normals)),
                                self.vox_size)
        self.pts = pcd.points.astype(np.float32)
        f32 = dict(dtype=torch.float32, device=dev)
        # dense surface sampling: target of register's depth polish
        dense = mesh.sample_points(16384, seed=0)
        self._polish_tgt = torch.as_tensor(dense.points, **f32)
        self._polish_tn = torch.as_tensor(dense.normals, **f32)
        self._polish_tmask = torch.ones(len(dense.points), dtype=torch.bool, device=dev)
        # 4096 points for the per-frame track polish
        small = mesh.sample_points(4096, seed=1)
        self._polish_tgt_small = torch.as_tensor(small.points, **f32)
        self._polish_tn_small = torch.as_tensor(small.normals, **f32)
        self._polish_tmask_small = torch.ones(4096, dtype=torch.bool, device=dev)
        self.mesh = mesh
        self.mesh_tensors = make_mesh_arrays(mesh, dev)
        # culling is an identity only for closed, outward-wound meshes
        self.backface_cull = bool(mesh.is_watertight()) and mesh.signed_volume() > 0
        self.symmetry_tfs = np.eye(4)[None] if symmetry_tfs is None else np.asarray(symmetry_tfs)

    def compute_add_err_to_gt_pose(self, poses):
        """ADD error of each of @poses against `self.gt_pose` over the
        downsampled model points; -1 each while `gt_pose` is None."""
        if self.gt_pose is None:
            return -np.ones(len(poses))
        from .metrics import add_err

        return np.array([add_err(np.asarray(p), np.asarray(self.gt_pose), np.asarray(self.pts))
                         for p in poses])

    def get_tf_to_centered_mesh(self):
        tf_to_center = np.eye(4)
        tf_to_center[:3, 3] = -np.asarray(self.model_center)
        return tf_to_center

    def make_rotation_grid(self, min_n_views=40, inplane_step=60):
        self.rot_grid = make_rotation_grid(min_n_views=min_n_views, inplane_step=inplane_step,
                                           symmetry_tfs=self.symmetry_tfs, cluster_angle=30.0,
                                           cluster_dist=99999.0)

    def _scalar_args(self):
        ref = self.refiner
        return (float(self.diameter), float(ref.cfg["crop_ratio"]),
                float(ref.cfg["trans_normalizer"]), float(ref.cfg["rot_normalizer"]))

    # ------------------------------------------------------------ helpers --

    def _depth_polish(self, top_pose_centered, depth_np, ob_mask, K):
        """Coarse-then-fine point-to-plane polish of the cascade's top pose
        against the masked observed cloud; skipped when the mask is tiny or
        covers < 40% of the projected silhouette (heavy occlusion)."""
        vs, us = np.where((np.asarray(ob_mask) > 0) & (depth_np > 0.001))
        if len(us) < 64:
            return top_pose_centered
        Kn = np.asarray(K, dtype=np.float64)
        p = np.asarray(top_pose_centered, dtype=np.float64)
        pc = np.asarray(self.pts) @ p[:3, :3].T + p[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        uu = np.clip(np.round(Kn[0, 0] * pc[:, 0] / z + Kn[0, 2]), 0, depth_np.shape[1] - 1)
        vv = np.clip(np.round(Kn[1, 1] * pc[:, 1] / z + Kn[1, 2]), 0, depth_np.shape[0] - 1)
        px_per_vox = float(max(Kn[0, 0], Kn[1, 1])) * self.vox_size / float(np.median(z))
        bucket = max(1, int(px_per_vox))
        proj_area = len(set(zip(uu.astype(int) // bucket, vv.astype(int) // bucket))) * bucket ** 2
        if len(us) < 0.4 * proj_area:
            logging.info(f":: depth polish skipped (mask {len(us)} px < 40% of "
                         f"projected ~{proj_area} px)")
            return top_pose_centered
        z = depth_np[vs, us]
        pts = np.stack([(us - Kn[0, 2]) * z / Kn[0, 0], (vs - Kn[1, 2]) * z / Kn[1, 1], z],
                       axis=-1).astype(np.float32)
        if len(pts) > 8192:
            pts = pts[np.random.RandomState(0).choice(len(pts), 8192, replace=False)]
        spad = 1 << int(np.ceil(np.log2(max(len(pts), 1024))))
        src = np.zeros((spad, 3), np.float32)
        src[: len(pts)] = pts
        smask = np.zeros(spad, bool)
        smask[: len(pts)] = True
        tf = self._polish_two_pass(src, smask, np.linalg.inv(p).astype(np.float32))
        return np.linalg.inv(tf.cpu().numpy().astype(np.float64))

    def _polish_two_pass(self, src, smask, init):
        """The depth polish's device ICP of the padded (N,3) cloud @src
        (@smask valid) from the (4,4) @init (model -> camera inverse)."""
        d = float(self.diameter)
        dev = self.device
        return icp_polish_two_pass(
            torch.as_tensor(src, device=dev), torch.as_tensor(smask, device=dev),
            self._polish_tgt, self._polish_tn, self._polish_tmask,
            torch.as_tensor(init, device=dev), 0.1 * d, 0.05 * d, max(0.02 * d, 0.004))

    def guess_translation(self, depth, mask, K):
        """Mask-centre backprojection at the median masked depth."""
        vs, us = np.where(mask > 0)
        if len(us) == 0:
            return np.zeros(3)
        uc = (us.min() + us.max()) / 2.0
        vc = (vs.min() + vs.max()) / 2.0
        valid = (mask > 0) & (np.asarray(depth) >= 0.001)
        if not valid.any():
            return np.zeros(3)
        zc = np.median(np.asarray(depth)[valid])
        return (np.linalg.inv(K) @ np.array([uc, vc, 1.0]).reshape(3, 1) * zc).reshape(3)

    def generate_random_pose_hypo(self, K, rgb, depth, mask, scene_pts=None):
        """The rotation grid at the mask's guessed translation (@scene_pts:
        accepted and unused, as in JAX)."""
        ob_in_cams = self.rot_grid.copy()
        ob_in_cams[:, :3, 3] = self.guess_translation(depth=depth, mask=mask, K=K).reshape(1, 3)
        return ob_in_cams

    # ---------------------------------------------------------- start-up --

    def precompile_async(self, K, image_hw, iteration=5, track_iteration=2,
                         icp_parameters=None):
        """Start the warm-up thread (see the module docstring); returns it,
        or None with a device_mesh (as the JAX engine, whose sharded path
        compiles per-mesh programs).

        @K: 3x3 intrinsics; @image_hw: (H, W) of the frames register() and
        track_one() will see; @iteration/@track_iteration: their
        iterations.  @icp_parameters: the scene's ICP parameters (the
        reader's); given, the thread also runs one capture program with
        their restart count and iterations (ops/icp.py::capture_from_pose).
        Its parts' seconds, the libraries it found built and its K1/K2
        launches land in `precompile_record`."""
        if self.device_mesh is not None:
            return None
        self._join_precompile()
        record = {"seconds": {}, "launches": {}, "built_before": {}}
        self.precompile_record = record
        H, W = int(image_hw[0]), int(image_hw[1])
        self._warmup = _Warmup(lambda: self._warm_up(np.asarray(K, dtype=np.float64), H, W,
                                                     iteration, track_iteration,
                                                     icp_parameters, record), record)
        return self._warmup.thread

    def _join_precompile(self):
        """Wait for this engine's warm-up; its error is raised here."""
        w, self._warmup = self._warmup, None
        if w is not None:
            w.join()

    def _warm_up(self, K, H, W, iteration, track_iteration, icp_parameters, record):
        """The warm-up thread's work on a synthetic frame: a plane at the
        object's distance, every hypothesis of the rotation grid in front of
        the camera.  Nothing it computes is kept."""
        dev = self.device
        cuda = dev.type == "cuda"

        def part(name, fn):
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.current_stream(dev).synchronize()
            record["seconds"][name] = time.perf_counter() - t0
            return out

        libraries = (raster.LIBRARY, raytrace.LIBRARY, png.LIBRARY) if cuda else (png.LIBRARY,)
        record["built_before"] = {lib.name: lib.built() for lib in libraries}
        part("build", lambda: build_all(libraries))

        z0 = max(0.5, 4.0 * float(self.diameter))
        pose = np.eye(4, dtype=np.float32)
        pose[2, 3] = z0
        rgb = np.full((H, W, 3), 128, dtype=np.uint8)
        depth = np.full((H, W), z0, dtype=np.float32)
        poses = self.rot_grid.copy()
        poses[:, :3, 3] = pose[:3, 3]

        def register():
            self._cascade(poses, rgb, self._filtered_depth(depth), K, iteration)[0].cpu()

        part("register", register)
        if self.depth_polish:  # on the polish's smallest cloud bucket
            src = self._polish_tgt[:1024] + torch.as_tensor(pose[:3, 3], device=dev)
            smask = torch.ones(len(src), dtype=torch.bool, device=dev)
            part("depth_polish", lambda: self._polish_two_pass(src, smask, np.linalg.inv(pose))
                 .cpu())
        pose_t = torch.as_tensor(pose, device=dev).reshape(1, 4, 4)
        depth_mm = np.round(depth * 1000.0).astype(np.uint16)
        part("track", lambda: self._readback(
            [self._track_step(pose_t, rgb, depth_mm, K, track_iteration)[0]]))
        if icp_parameters is not None:
            part("capture", lambda: self._readback(self._capture_program(pose_t,
                                                                          icp_parameters)))

    def _readback(self, tensors):
        """Copy @tensors to pinned host memory as PendingPose and
        PendingCapture do (the pinned allocator's first blocks), and wait."""
        if self.device.type != "cuda":
            return [t.cpu() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host

    def _capture_program(self, pose_t, parameters):
        """One capture program (restart ICP + the defect ray trace through
        K2) from @pose_t with the restarts and iterations of @parameters,
        on the engine's mesh in millimetres: its sampled surface as the
        target, part of it as the scene cloud, and a cone of rays."""
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        n_restarts = int(parameters.get("run_icp", {}).get("n_restarts", 50))
        max_iter = int(parameters.get("run_icp", {}).get("max_iter", 30))
        thresh = float(parameters["refine_registration"]["distance_threshold"])
        max_pcd = int(parameters.get("preprocess_target", {}).get("max_pcd", 4096))

        def padded(pts, n):  # the capture's power-of-two buckets (at least 1024)
            size = 1 << int(np.ceil(np.log2(max(n, 1024))))
            out = torch.zeros((size, 3), **f32)
            out[: min(n, len(pts))] = pts[:n]
            mask = torch.zeros(size, dtype=torch.bool, device=dev)
            mask[: min(n, len(pts))] = True
            return out, mask

        tgt, tgt_mask = padded(self._polish_tgt_small * 1000.0, max_pcd)
        tgt_n, _ = padded(self._polish_tn_small, max_pcd)
        src, src_mask = padded(self._polish_tgt_small * 1000.0, 1024)
        tri, tri_mask = mesh_to_tri_verts(self.mesh.vertices * 1000.0, self.mesh.faces)
        a = np.linspace(-0.05, 0.05, 32)
        rays = np.stack(np.broadcast_arrays(a[:, None], a[None, :], 1.0), -1).reshape(-1, 3)
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        out = capture_from_pose(
            src, src_mask, tgt, tgt_n, tgt_mask, pose_t,
            torch.as_tensor(self.get_tf_to_centered_mesh(), **f32), torch.eye(4, **f32),
            torch.eye(4, **f32).expand(n_restarts, 4, 4), torch.full((n_restarts,), thresh, **f32),
            thresh, torch.as_tensor(tri, device=dev), torch.as_tensor(tri_mask, device=dev),
            torch.as_tensor(rays, **f32), torch.ones(len(rays), dtype=torch.bool, device=dev),
            torch.eye(4, **f32), max_iter=max_iter)
        return list(out)

    # ------------------------------------------------------------- infer --

    def register(self, K, rgb, depth, ob_mask, ob_id=None, glctx=None, iteration=5):
        """Global pose estimation over the rotation grid: the coarse-to-fine
        cascade (models/predict.py::register_pipeline), then the depth polish.
        @ob_id is kept as `self.ob_id`; @glctx is accepted and ignored, as in
        JAX."""
        self._join_precompile()
        depth_t = self._filtered_depth(depth)
        depth_np = depth_t.cpu().numpy()
        valid = (depth_np >= 0.001) & (np.asarray(ob_mask) > 0)
        if valid.sum() < 4:
            pose = np.eye(4)
            pose[:3, 3] = self.guess_translation(depth=depth_np, mask=ob_mask, K=K)
            return pose
        self.H, self.W = depth_np.shape[:2]
        self.K = K
        self.ob_id = ob_id
        self.ob_mask = ob_mask
        poses = self.generate_random_pose_hypo(K=K, rgb=rgb, depth=depth_np, mask=ob_mask)
        if self.debug >= 2 or self.device_mesh is not None:
            return self._register_staged(K, rgb, depth_t, depth_np, ob_mask, poses, iteration)
        poses_sorted, scores_sorted = self._cascade(poses, rgb, depth_t, K, iteration)
        poses_np = poses_sorted.cpu().numpy().copy()
        scores_np = scores_sorted.cpu().numpy()
        logging.info(f"sorted scores (top5): {scores_np[:5]}")
        if self.depth_polish:
            poses_np[0] = self._depth_polish(poses_np[0], depth_np, ob_mask, K)
        self.pose_last = poses_np[0]
        self._crop_pose_host = np.asarray(poses_np[0], dtype=np.float64)
        self._pose_hist.clear()
        self._last_center_px = None
        self.poses = poses_np
        self.scores = scores_np
        return poses_np[0] @ self.get_tf_to_centered_mesh()

    def _filtered_depth(self, depth):
        """The frame's depth on the device, eroded and bilateral-filtered."""
        depth_t = torch.as_tensor(np.asarray(depth), dtype=torch.float32, device=self.device)
        return bilateral_filter_depth(erode_depth(depth_t, radius=2), radius=2)

    def _cascade(self, poses, rgb, depth_t, K, iteration):
        """The fused register cascade from the (N,4,4) hypotheses @poses on
        the filtered @depth_t.  Returns (sorted poses, sorted scores)."""
        dev = self.device
        ref, sc = self.refiner, self.scorer
        score_hw = tuple(sc.cfg["input_resize"])
        return register_pipeline(
            ref.model, sc.model, self.mesh_tensors,
            torch.as_tensor(poses, dtype=torch.float32, device=dev), to_rgb01(rgb, dev), depth_t,
            torch.as_tensor(K, dtype=torch.float32, device=dev), *self._scalar_args(),
            prune_to=int(self.prune_to) if self.prune_to else 0, coarse_iters=2,
            iterations=int(iteration), out_hw=tuple(ref.cfg["input_resize"]),
            coarse_hw=self.coarse_hw, normalize_xyz=bool(ref.cfg["normalize_xyz"]),
            trans_rep=ref.cfg["trans_rep"], rot_rep=ref.cfg["rot_rep"],
            score_mode=sc.cfg.get("score_mode", "hybrid"), prune_schedule=self.prune_schedule,
            polish_top=self.polish_top, polish_iters=self.polish_iters,
            backface_cull=self.backface_cull, score_crop_ratio=float(sc.cfg["crop_ratio"]),
            score_normalize_xyz=bool(sc.cfg["normalize_xyz"]),
            score_hw=score_hw if score_hw != tuple(ref.cfg["input_resize"]) else None,
            occ_sub=ref.cfg.get("occ_sub", False), plain_raster=self.plain_raster,
            compute_dtype=ref.compute_dtype,
        )

    def _pad(self, poses):
        """(@poses padded to the mesh's data axis, their count), as JAX's
        shard_hypotheses pads them; unchanged without a mesh."""
        if self.device_mesh is None:
            return poses, len(poses)
        padded, n = pad_hypotheses(torch.as_tensor(poses, dtype=torch.float32), self.device_mesh)
        return padded.numpy(), n

    def _register_staged(self, K, rgb, depth_t, depth_np, ob_mask, poses, iteration):
        """The JAX engine's staged register: the cascade's stages as separate
        refiner and scorer calls (prune schedule, final refine and score,
        cascade polish), ranked on the host, then the depth polish.  With a
        mesh each stage's hypotheses are padded as JAX pads them and split
        across the ranks; the gathered scores rank them on every rank alike."""
        logging.info("register: staged path")
        common = dict(mesh=self.mesh, mesh_tensors=self.mesh_tensors, rgb=rgb, depth=depth_t,
                      K=K, glctx=None, mesh_diameter=self.diameter,
                      backface_cull=self.backface_cull, plain_raster=self.plain_raster,
                      device_mesh=self.device_mesh)
        xyz_map = depth2xyzmap(depth_t, torch.as_tensor(K, dtype=torch.float32,
                                                        device=self.device))
        poses, n_hypo = self._pad(poses)
        schedule = self.prune_schedule
        if schedule is None and self.prune_to and self.prune_to < len(poses) and iteration > 2:
            schedule = ((2, self.prune_to),)  # 2 iterations on the full grid, keep the best
        for stage_iters, keep_k in schedule or ():
            if keep_k >= n_hypo or iteration <= stage_iters:
                continue
            coarse, _ = self.refiner.predict(ob_in_cams=poses, xyz_map=xyz_map,
                                             iteration=stage_iters, get_vis=False,
                                             out_hw=self.coarse_hw, **common)
            coarse_scores, _ = self.scorer.predict(ob_in_cams=coarse, out_hw=self.coarse_hw,
                                                   **common)
            keep = np.argsort(-coarse_scores.cpu().numpy()[:n_hypo])[:keep_k]
            poses, n_hypo = self._pad(coarse.cpu().numpy()[keep])
            iteration = iteration - stage_iters
        poses, vis = self.refiner.predict(ob_in_cams=poses, xyz_map=xyz_map, iteration=iteration,
                                          get_vis=self.debug >= 2, **common)
        if vis is not None and (self.device_mesh is None or self.device_mesh.rank == 0):
            os.makedirs(self.debug_dir, exist_ok=True)
            write_png_rgb8(f"{self.debug_dir}/vis_refiner.png", vis)
        scores, _ = self.scorer.predict(ob_in_cams=poses, **common)
        scores_np = scores.cpu().numpy()[:n_hypo]
        poses_np = poses.cpu().numpy()[:n_hypo]
        if self.polish_top and self.polish_iters and self.polish_top <= n_hypo:
            # extra refine iterations on the best few, ranked alongside the
            # originals (the fused cascade's polish)
            top = np.argsort(-scores_np)[: self.polish_top]
            cand, n_cand = self._pad(poses_np[top])
            cand, _ = self.refiner.predict(ob_in_cams=cand, xyz_map=xyz_map,
                                           iteration=self.polish_iters, get_vis=False, **common)
            cand_scores, _ = self.scorer.predict(ob_in_cams=cand, **common)
            poses_np = np.concatenate([cand.cpu().numpy()[:n_cand], poses_np])
            scores_np = np.concatenate([cand_scores.cpu().numpy()[:n_cand], scores_np])
        ids = np.argsort(-scores_np)
        poses_np = poses_np[ids]
        logging.info(f"sorted scores (top5): {scores_np[ids][:5]}")
        if self.depth_polish:
            poses_np = poses_np.copy()
            poses_np[0] = self._depth_polish(poses_np[0], depth_np, ob_mask, K)
        self.pose_last = poses_np[0]
        self._crop_pose_host = np.asarray(poses_np[0], dtype=np.float64)
        self._pose_hist.clear()
        self._last_center_px = None
        self.poses = poses_np
        self.scores = scores_np[ids]
        return poses_np[0] @ self.get_tf_to_centered_mesh()

    def _crop_window(self, K, hw):
        """Conservative (oy, ox, size) upload crop around the tracked pose,
        or None for the full frame (size fixed per session, multiple of 32)."""
        p = self._crop_pose_host
        if p is None:
            return None
        tz = float(p[2, 3])
        if tz <= 1e-6:
            return None
        H, W = int(hw[0]), int(hw[1])
        f = max(float(K[0, 0]), float(K[1, 1]))
        crop_ratio = float(self.refiner.cfg.get("crop_ratio", 1.2))
        need_net = 2.0 * f * (0.5 * self.diameter * crop_ratio) / tz
        need = need_net * self._track_crop_margin
        if self._crop_size is None:
            size = max(64, int(np.ceil(need * 1.05 / 32.0) * 32))
            self._crop_size = 0 if size >= min(H, W) else size
        elif self._crop_size and need > 0.95 * self._crop_size:
            logging.info(":: track_crop: object too close for the session window, "
                         "reverting to full-frame uploads")
            self._crop_size = 0
        if not self._crop_size or self._crop_size > min(H, W):
            return None
        size = self._crop_size
        u = float(K[0, 0]) * float(p[0, 3]) / tz + float(K[0, 2])
        v = float(K[1, 1]) * float(p[1, 3]) / tz + float(K[1, 2])
        if not (0.0 <= u < W and 0.0 <= v < H):
            self._last_center_px = None
            return None
        slack = 0.5 * (size - need_net)
        prev = self._last_center_px
        self._last_center_px = (u, v)
        if prev is not None:
            motion = float(np.hypot(u - prev[0], v - prev[1]))
            if motion * (len(self._pose_hist) + 1) + 4.0 > slack:
                return None
        ox = int(np.clip(round(u - size / 2), 0, W - size))
        oy = int(np.clip(round(v - size / 2), 0, H - size))
        return oy, ox, size

    def _push_pose_hist(self, pose):
        """Advance the host-side crop pose from readbacks two frames old.
        @pose: a PendingPose (pipelined) or a host 4x4 (sync), centred frame."""
        self._pose_hist.append(pose)
        if len(self._pose_hist) > 2:
            old = self._pose_hist.popleft()
            if isinstance(old, PendingPose):
                old = old.centered()
            self._crop_pose_host = np.asarray(old, dtype=np.float64).reshape(4, 4)

    def _track_polish_kwargs(self):
        """The track polish's model sampling, or nothing when it is off."""
        if not self.track_polish:
            return {}
        return dict(polish_tgt=self._polish_tgt_small, polish_tn=self._polish_tn_small,
                    polish_tmask=self._polish_tmask_small)

    def track_one(self, rgb, depth, K, iteration, extra=None, sync=True):
        """Single-hypothesis refinement from the previous frame's pose.
        @sync=False returns a PendingPose: the pose chain stays on the device
        and its host copy is started without blocking.  At debug >= 2 the
        whole frame goes up (no upload crop), and @extra (a dict) gets
        "vis": the refiner's crops of the tracked pose, one more iteration
        on the track step's filtered depth, as JAX's track_one draws them."""
        if self.pose_last is None:
            raise RuntimeError("track_one needs a pose: call register first")
        self._join_precompile()
        dev = self.device
        rgb_np = np.ascontiguousarray(np.asarray(rgb))
        if rgb_np.dtype != np.uint8:
            rgb_np = (rgb_np * 255).clip(0, 255).astype(np.uint8) if rgb_np.max() <= 1.5 \
                else rgb_np.astype(np.uint8)
        depth_np = np.asarray(depth)
        if depth_np.dtype != np.uint16:
            depth_np = np.clip(depth_np * 1000.0, 0, 65535).astype(np.uint16)
        K_use = np.asarray(K, dtype=np.float64)
        win = self._crop_window(K_use, rgb_np.shape[:2]) \
            if self.track_crop and self.debug < 2 else None
        if win is not None:
            oy, ox, size = win
            rgb_np = rgb_np[oy : oy + size, ox : ox + size]
            depth_np = depth_np[oy : oy + size, ox : ox + size]
            K_use = K_use.copy()
            K_use[0, 2] -= ox
            K_use[1, 2] -= oy
        if isinstance(self.pose_last, torch.Tensor):
            pose_last = self.pose_last.reshape(1, 4, 4)
        else:
            pose_last = torch.as_tensor(np.asarray(self.pose_last).reshape(1, 4, 4),
                                        dtype=torch.float32, device=dev)
        pose, depth_filtered = self._track_step(pose_last, rgb_np, depth_np, K_use, iteration)
        if self.debug >= 2:
            K_t = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
            _, vis = self.refiner.predict(
                mesh=self.mesh, mesh_tensors=self.mesh_tensors, rgb=rgb, depth=depth_filtered,
                K=K, ob_in_cams=pose.reshape(1, 4, 4), xyz_map=depth2xyzmap(depth_filtered, K_t),
                mesh_diameter=self.diameter, iteration=1, get_vis=True,
                plain_raster=self.plain_raster)
            if extra is not None:
                extra["vis"] = vis
        self.pose_last = pose  # the chain stays on the device
        if not sync:
            pending = PendingPose(pose, self.get_tf_to_centered_mesh())
            self._push_pose_hist(pending)
            return pending
        pose_np = pose.cpu().numpy().reshape(4, 4).astype(np.float64)
        self._push_pose_hist(pose_np)
        return pose_np @ self.get_tf_to_centered_mesh()

    def _track_step(self, pose_last, rgb_u8, depth_u16, K, iteration):
        """One track step on the device from the (1,4,4) @pose_last on the
        uint8 colour and uint16-mm depth (one packed upload).  Returns the
        (1,4,4) pose and the filtered depth."""
        ref = self.refiner
        dev = self.device
        rgbd = torch.from_numpy(pack_rgbd(np.ascontiguousarray(rgb_u8),
                                          np.ascontiguousarray(depth_u16))).to(dev)
        return track_pose(
            ref.model, self.mesh_tensors, pose_last, rgbd,
            torch.as_tensor(K, dtype=torch.float32, device=dev), *self._scalar_args(),
            iterations=int(iteration), out_hw=tuple(ref.cfg["input_resize"]),
            normalize_xyz=bool(ref.cfg["normalize_xyz"]), rot_rep=ref.cfg["rot_rep"],
            backface_cull=self.backface_cull, occ_sub=ref.cfg.get("occ_sub", False),
            plain_raster=self.plain_raster, compute_dtype=ref.compute_dtype,
            trans_rep=ref.cfg["trans_rep"], **self._track_polish_kwargs())
