"""FoundationPose engine: rotation-grid registration + frame-to-frame tracking.

Port of `sixdof_tpu/estimater.py::FoundationPose`: `register(K, rgb, depth,
ob_mask, iteration)` on the first frame and `track_one(rgb, depth, K,
iteration)` on every later one, with the same conventions (meters, OpenCV
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
tracking is not sharded, as in JAX.  The JAX engine also takes the staged
path while its fused program compiles; the executable cache and background
precompile exist to hide TPU compile time, and PyTorch runs eagerly, so
they have no counterpart here.
"""
from __future__ import annotations

import logging
import os
from collections import deque

import numpy as np
import torch

from .device import resolve_device
from .io.mesh_io import PointCloud, TriMesh
from .io.png import write_png_rgb8
from .models.predict import (PoseRefinePredictor, ScorePredictor, pack_rgbd, register_pipeline,
                             to_rgb01, track_pose)
from .ops.depth_filter import bilateral_filter_depth, erode_depth
from .ops.geometry import compute_mesh_diameter, depth2xyzmap
from .ops.hypotheses import make_rotation_grid
from .ops.icp import icp_polish_two_pass
from .ops.pointcloud import voxel_down_sample
from .ops.rasterize import make_mesh_arrays
from .parallel.sharding import pad_hypotheses


class PendingPose:
    """Handle for an in-flight tracked pose (track_one(sync=False)).

    The device pose stays referenced (`device_pose()`, what a capture event
    seeds from without a host sync).  On the card it is also copied to
    pinned host memory without blocking, and a CUDA event marks the copy;
    `.numpy()` waits on that event only and returns the 4x4 in the
    original-mesh frame (the sync return value)."""

    __slots__ = ("_dev", "_host", "_event", "_tf", "_np")

    def __init__(self, dev_pose, tf_to_centered_mesh):
        self._dev = dev_pose
        if dev_pose.is_cuda:
            self._host = torch.empty(dev_pose.shape, dtype=dev_pose.dtype, pin_memory=True)
            self._host.copy_(dev_pose, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = dev_pose.clone()
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
                 device=None, debug=0, debug_dir="debug/fp", prune_to=None, coarse_hw=(96, 96),
                 prune_schedule=None, track_crop=True, polish_top=0, polish_iters=2,
                 depth_polish=True, track_polish=True, plain_raster=False, device_mesh=None):
        """@prune_to: keep this many hypotheses after 2 coarse refine
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
        init = np.linalg.inv(p).astype(np.float32)
        d = float(self.diameter)
        dev = self.device
        tf = icp_polish_two_pass(
            torch.as_tensor(src, device=dev), torch.as_tensor(smask, device=dev),
            self._polish_tgt, self._polish_tn, self._polish_tmask,
            torch.as_tensor(init, device=dev), 0.1 * d, 0.05 * d, max(0.02 * d, 0.004))
        return np.linalg.inv(tf.cpu().numpy().astype(np.float64))

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

    def generate_random_pose_hypo(self, K, rgb, depth, mask):
        ob_in_cams = self.rot_grid.copy()
        ob_in_cams[:, :3, 3] = self.guess_translation(depth=depth, mask=mask, K=K).reshape(1, 3)
        return ob_in_cams

    # ------------------------------------------------------------- infer --

    def register(self, K, rgb, depth, ob_mask, iteration=5):
        """Global pose estimation over the rotation grid: the coarse-to-fine
        cascade (models/predict.py::register_pipeline), then the depth polish."""
        dev = self.device
        depth_t = torch.as_tensor(np.asarray(depth), dtype=torch.float32, device=dev)
        depth_t = bilateral_filter_depth(erode_depth(depth_t, radius=2), radius=2)
        depth_np = depth_t.cpu().numpy()
        valid = (depth_np >= 0.001) & (np.asarray(ob_mask) > 0)
        if valid.sum() < 4:
            pose = np.eye(4)
            pose[:3, 3] = self.guess_translation(depth=depth_np, mask=ob_mask, K=K)
            return pose
        poses = self.generate_random_pose_hypo(K=K, rgb=rgb, depth=depth_np, mask=ob_mask)
        if self.debug >= 2 or self.device_mesh is not None:
            return self._register_staged(K, rgb, depth_t, depth_np, ob_mask, poses, iteration)
        ref, sc = self.refiner, self.scorer
        score_hw = tuple(sc.cfg["input_resize"])
        poses_sorted, scores_sorted = register_pipeline(
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

    def track_one(self, rgb, depth, K, iteration, sync=True):
        """Single-hypothesis refinement from the previous frame's pose.
        @sync=False returns a PendingPose: the pose chain stays on the device
        and its host copy is started without blocking.  At debug >= 2 the
        whole frame goes up (no upload crop)."""
        if self.pose_last is None:
            raise RuntimeError("track_one needs a pose: call register first")
        ref = self.refiner
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
        rgbd = torch.from_numpy(pack_rgbd(np.ascontiguousarray(rgb_np),
                                          np.ascontiguousarray(depth_np))).to(dev)
        if isinstance(self.pose_last, torch.Tensor):
            pose_last = self.pose_last.reshape(1, 4, 4)
        else:
            pose_last = torch.as_tensor(np.asarray(self.pose_last).reshape(1, 4, 4),
                                        dtype=torch.float32, device=dev)
        pose, _ = track_pose(
            ref.model, self.mesh_tensors, pose_last, rgbd,
            torch.as_tensor(K_use, dtype=torch.float32, device=dev), *self._scalar_args(),
            iterations=int(iteration), out_hw=tuple(ref.cfg["input_resize"]),
            normalize_xyz=bool(ref.cfg["normalize_xyz"]), rot_rep=ref.cfg["rot_rep"],
            backface_cull=self.backface_cull, occ_sub=ref.cfg.get("occ_sub", False),
            plain_raster=self.plain_raster, compute_dtype=ref.compute_dtype,
            trans_rep=ref.cfg["trans_rep"], **self._track_polish_kwargs())
        self.pose_last = pose  # the chain stays on the device
        if not sync:
            pending = PendingPose(pose, self.get_tf_to_centered_mesh())
            self._push_pose_hist(pending)
            return pending
        pose_np = pose.cpu().numpy().reshape(4, 4).astype(np.float64)
        self._push_pose_hist(pose_np)
        return pose_np @ self.get_tf_to_centered_mesh()
