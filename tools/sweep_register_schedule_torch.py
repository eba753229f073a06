"""Sweep the register cascade's prune configurations on the port.

For each configuration (prune_to 64, and the schedules 1x128,1x64 /
1x128,1x48 / 1x96,1x48, as `tools/sweep_register_schedule.py` sweeps
them), on frame 0 of a demo scene at shorter side 288, on the bundled
networks: the first register's seconds, the warm register's (the least of
3, the card synchronised), and the pose's rotation, translation and ADD-S
error against the annotated pose.  One JSON line a configuration.

    python tools/sweep_register_schedule_torch.py [scene] [--device cpu]
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = [
    ("prune64", dict(prune_to=64)),
    ("sched 1x128,1x64", dict(prune_schedule=((1, 128), (1, 64)))),
    ("sched 1x128,1x48", dict(prune_schedule=((1, 128), (1, 48)))),
    ("sched 1x96,1x48", dict(prune_schedule=((1, 96), (1, 48)))),
]


def main(scene="synth_box", device=None, configs=CONFIGS, refiner=None, scorer=None,
         shorter_side=288, warm_runs=3, n_hypotheses=None):
    """Returns the list of per-configuration records (also printed).
    @refiner/@scorer: the predictors (default the bundled networks);
    @n_hypotheses: keep that many of the grid (default all 252)."""
    import torch

    from sixdof_tpu_torch.app.run import _ckpt
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import adds_err, rotation_angle_deg
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    logging.disable(logging.INFO)
    dev = resolve_device(device)
    scene_dir = os.path.join(REPO, "demo_data", scene)
    reader = DataReader(scene_dir, shorter_side=shorter_side)
    mesh = load_mesh(f"{scene_dir}/mesh/model_scaled_down.obj")
    refiner = refiner or PoseRefinePredictor(dev, ckpt_dir=_ckpt(None, "refiner"))
    scorer = scorer or ScorePredictor(dev, ckpt_dir=_ckpt(None, "scorer"))
    color, depth = reader.get_color(0), reader.get_depth(0)
    frame = dict(K=reader.color_K, rgb=color, depth=depth,
                 ob_mask=reader.get_mask(color, 0).astype(bool), iteration=5)
    gt = reader.get_gt_pose(0)

    def timed_register(est):
        t0 = time.perf_counter()
        pose = est.register(**frame)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return pose, time.perf_counter() - t0

    records = []
    for name, kw in configs:
        est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals,
                             mesh=mesh, refiner=refiner, scorer=scorer, device=dev, **kw)
        if n_hypotheses:
            est.rot_grid = est.rot_grid[:: len(est.rot_grid) // n_hypotheses][:n_hypotheses]
        _, first = timed_register(est)
        warm = []
        for _ in range(warm_runs):
            pose, s = timed_register(est)
            warm.append(s)
        rec = {"config": name, "first_register_s": first, "warm_register_s": min(warm),
               "rot_err_deg": rotation_angle_deg(pose[:3, :3], gt[:3, :3]),
               "t_err_mm": float(np.linalg.norm(pose[:3, 3] - gt[:3, 3]) * 1e3),
               "adds_mm": adds_err(pose, gt, np.asarray(est.pts)) * 1e3,
               "device": dev.type}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = None
    if "--device" in argv:
        k = argv.index("--device")
        dev = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    main(argv[0] if argv else "synth_box", device=dev)
