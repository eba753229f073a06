#!/usr/bin/env python3
"""BOP evaluation campaign on the PyTorch/CUDA port: the pose server over
one BOP scene (`tools/run_bop.py` on the port).

    python tools/run_bop_torch.py <scene_dir> [--ob_id K] [--frames N]
        [--register_every M] [--weights DIR] [--shorter_side S]
        [--prune_to P] [--max_hypotheses H] [--device cpu]

Registers the first frame (and every M-th, M > 0) on its visible mask and
tracks the others, scores ADD and ADD-S against scene_gt.json, and prints
one JSON line: AUC of ADD-S to 0.1 diameter, recall of ADD and ADD-S, mean
rotation and translation error.  Models above 5000 triangles are decimated
to 5000 for the raster.  The networks load `DIR/{refiner,scorer}.npz`
(default `weights_torch/`, the export of the bundled weights) when present,
else start from a seed.  Runs on the CUDA card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(scene_dir, ob_id=None, frames=None, register_every=0, weights="weights_torch",
         shorter_side=None, prune_to=64, max_hypotheses=None, device=None, refiner=None,
         scorer=None, poses=None):
    """The campaign; returns (and prints) its JSON summary.  @refiner /
    @scorer: predictors to use instead of loading @weights; @poses: a list
    that receives each frame's pose (4x4, object in camera, metres)."""
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.bop_reader import BopSceneReader
    from sixdof_tpu_torch.io.mesh_io import decimate_mesh
    from sixdof_tpu_torch.metrics import add_err, adds_err, compute_auc, rotation_angle_deg
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    dev = resolve_device(device)
    reader = BopSceneReader(scene_dir, ob_id=ob_id, shorter_side=shorter_side)
    mesh = reader.get_gt_mesh()
    if len(mesh.faces) > 5000:
        mesh = decimate_mesh(mesh, target_tris=5000)
    sym = reader.get_symmetry_tfs()

    def ckpt(net):
        path = os.path.join(REPO, weights, f"{net}.npz")
        return path if os.path.exists(path) else None

    est = FoundationPose(
        model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh, symmetry_tfs=sym,
        device=dev, prune_to=prune_to,
        refiner=refiner or PoseRefinePredictor(dev, ckpt_dir=ckpt("refiner")),
        scorer=scorer or ScorePredictor(dev, ckpt_dir=ckpt("scorer")))
    if max_hypotheses and len(est.rot_grid) > max_hypotheses:
        step = len(est.rot_grid) // max_hypotheses
        est.rot_grid = est.rot_grid[::step][:max_hypotheses]
    model_pts = np.asarray(est.pts) + est.model_center

    n = min(frames or len(reader), len(reader))
    adds, add, rot, trans, used_register = [], [], [], [], []
    pose = None
    for i in range(n):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        do_register = pose is None or (register_every and i % register_every == 0)
        if do_register:
            mask = reader.get_mask(i)
            if mask.sum() < 16:
                continue
            pose = est.register(K=reader.get_K(i), rgb=color, depth=depth, ob_mask=mask,
                                iteration=5)
        else:
            pose = est.track_one(rgb=color, depth=depth, K=reader.get_K(i), iteration=2)
        used_register.append(bool(do_register))
        if poses is not None:
            poses.append(np.asarray(pose))
        gt = reader.get_gt_pose(i)
        if gt is None:
            continue
        adds.append(adds_err(pose, gt, model_pts))
        add.append(add_err(pose, gt, model_pts))
        rot.append(rotation_angle_deg(pose[:3, :3], gt[:3, :3]))
        trans.append(float(np.linalg.norm(pose[:3, 3] - gt[:3, 3])))

    diam = reader.get_model_diameter() or est.diameter
    out = {
        "scene": reader.get_video_name(),
        "obj_id": reader.ob_id,
        "frames": len(adds),
        "registered_frames": int(sum(used_register)),
        "adds_mean_m": float(np.mean(adds)) if adds else -1,
        "add_mean_m": float(np.mean(add)) if add else -1,
        "adds_auc_0.1d": compute_auc(adds, max_val=0.1 * diam) if adds else -1,
        "adds_recall_0.1d": float(np.mean(np.asarray(adds) < 0.1 * diam)) if adds else -1,
        "add_recall_0.1d": float(np.mean(np.asarray(add) < 0.1 * diam)) if add else -1,
        "rot_err_deg_mean": float(np.mean(rot)) if rot else -1,
        "t_err_m_mean": float(np.mean(trans)) if trans else -1,
        "diameter_m": float(diam),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--ob_id", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--register_every", type=int, default=0)
    ap.add_argument("--weights", type=str, default="weights_torch")
    ap.add_argument("--shorter_side", type=int, default=None)
    ap.add_argument("--prune_to", type=int, default=64)
    ap.add_argument("--max_hypotheses", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' on request)")
    a = ap.parse_args()
    logging.disable(logging.INFO)
    main(a.scene_dir, a.ob_id, a.frames, a.register_every, a.weights, a.shorter_side,
         a.prune_to, a.max_hypotheses, a.device)
