#!/usr/bin/env python3
"""Track a scene from one frame's annotated pose in both packages, on the
CPU: the JAX package's FoundationPose and the port's, on the bundled
networks (orbax `weights/` and their export `weights_torch/`), each frame's
ADD-S against the annotated pose.  One JSON line a frame.

    JAX_PLATFORMS=cpu python tools/track_drift_reference.py <scene_dir> <start> <stop>

A scene longer than the demo fixtures comes from
`python tools/make_demo_scene_torch.py <scene_dir> 31 --device cpu`.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(scene, start, stop):
    os.environ["SIXDOF_AOT_CACHE"] = ""  # CPU executables do not load back in one process
    import torch

    from sixdof_tpu.estimater import FoundationPose as JaxEngine
    from sixdof_tpu.io.mesh_io import load_mesh as jax_load
    from sixdof_tpu.models import predict as jax_predict
    from sixdof_tpu_torch.estimater import FoundationPose as PortEngine
    from sixdof_tpu_torch.io.mesh_io import load_mesh as port_load
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import adds_err
    from sixdof_tpu_torch.models import predict as port_predict

    path = os.path.join(scene, "mesh", "model_scaled_down.obj")
    jm, pm = jax_load(path), port_load(path)
    jest = JaxEngine(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm,
                     refiner=jax_predict.PoseRefinePredictor(
                         ckpt_dir=os.path.join(REPO, "weights", "refiner")),
                     scorer=jax_predict.ScorePredictor(
                         ckpt_dir=os.path.join(REPO, "weights", "scorer")),
                     debug_dir=os.path.join(scene, "debug_jax"))
    pest = PortEngine(model_pts=pm.vertices, model_normals=pm.vertex_normals, mesh=pm,
                      device="cpu",
                      refiner=port_predict.PoseRefinePredictor(
                          "cpu", ckpt_dir=os.path.join(REPO, "weights_torch", "refiner.npz")),
                      scorer=port_predict.ScorePredictor(
                          "cpu", ckpt_dir=os.path.join(REPO, "weights_torch", "scorer.npz")))
    torch.set_num_threads(4)
    reader = DataReader(scene)
    for est in (jest, pest):  # poses of the centred mesh
        est.pose_last = reader.get_gt_pose(start) @ np.linalg.inv(est.get_tf_to_centered_mesh())
    rows = []
    for i in range(start + 1, stop + 1):
        color, depth = reader.get_color(i), reader.get_depth(i)
        pj = jest.track_one(rgb=color, depth=depth, K=reader.color_K, iteration=2)
        pp = pest.track_one(rgb=color, depth=depth, K=reader.color_K, iteration=2)
        gt = reader.get_gt_pose(i)
        row = {"frame": i, "jax_adds_mm": adds_err(pj, gt, pm.vertices) * 1e3,
               "port_adds_mm": adds_err(pp, gt, pm.vertices) * 1e3}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
