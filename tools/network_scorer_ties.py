#!/usr/bin/env python3
"""Where the network-only scorer ties: frame 0 of a demo scene registered
with the scorer in network mode (SCORE_MODE=network: the full rotation
grid, the engine's defaults otherwise, as tools/parity_check.py registers
it) by the JAX package and by the port, each in bf16 and in float32.

For each run: the registered pose's rotation error, the top-k scores and
each one's rotation error against the annotated pose (per the centred
mesh), the spread of the top-k scores, and the rank of the first
hypothesis within 15 deg of the truth.  One JSON line a run.

    JAX_PLATFORMS=cpu python tools/network_scorer_ties.py [scene]
        [--runs jax:bfloat16,jax:float32,port:bfloat16,port:float32]
        [--device cpu] [--top 8]

The JAX runs and the port's float32 run (its weights are the JAX
predictor's, converted) need JAX and the orbax weights/, so they run on
the CPU; the port's bf16 run reads the bundled export (weights_torch/)
and runs on the card too (`--runs port:bfloat16 --device cuda`).  On the
CPU a run takes 8-25 minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOOD_DEG = 15.0


class _Args:
    debug = 0
    box = None
    mesh = None
    voxel_size = None


def _jax_predictors(dtype):
    import jax.numpy as jnp

    from sixdof_tpu.models.predict import PoseRefinePredictor, ScorePredictor

    dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return (PoseRefinePredictor(ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=dt),
            ScorePredictor(cfg={"score_mode": "network"},
                           ckpt_dir=os.path.join(REPO, "weights", "scorer"), compute_dtype=dt))


def _engine(package, dtype, scene_dir, device):
    """(engine, reader) of @package ("jax" or "port") in @dtype."""
    if package == "jax":
        # the JAX package's executable caches fail when read back on the CPU
        os.environ.setdefault("SIXDOF_AOT_CACHE", "")
        from sixdof_tpu.estimater import FoundationPose
        from sixdof_tpu.io.mesh_io import load_mesh
        from sixdof_tpu.io.readers import DataReader

        refiner, scorer = _jax_predictors(dtype)
        kw = {}
    else:
        import torch

        from sixdof_tpu_torch.estimater import FoundationPose
        from sixdof_tpu_torch.io.mesh_io import load_mesh
        from sixdof_tpu_torch.io.readers import DataReader
        from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

        cfg = {"score_mode": "network"}
        if dtype == "float32":
            import jax

            jr, js = _jax_predictors("float32")
            refiner = PoseRefinePredictor(device, params=jax.tree.map(np.asarray, jr.params),
                                          compute_dtype=torch.float32)
            scorer = ScorePredictor(device, cfg=cfg, params=jax.tree.map(np.asarray, js.params),
                                    compute_dtype=torch.float32)
        else:
            wdir = os.path.join(REPO, "weights_torch")
            refiner = PoseRefinePredictor(device, ckpt_dir=os.path.join(wdir, "refiner.npz"))
            scorer = ScorePredictor(device, cfg=cfg, ckpt_dir=os.path.join(wdir, "scorer.npz"))
        kw = {"device": device}
    reader = DataReader(base_dir=scene_dir, shorter_side=None, zfar=np.inf, arguments=_Args())
    mesh = load_mesh(f"{scene_dir}/mesh/model_scaled_down.obj")
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         refiner=refiner, scorer=scorer, **kw)
    return est, reader


def run(package, dtype, scene="synth_clutter", device="cpu", top=8):
    """One registration; returns the record printed."""
    from sixdof_tpu_torch.metrics import rotation_angle_deg

    t0 = time.perf_counter()
    scene_dir = os.path.join(REPO, "demo_data", scene)
    est, reader = _engine(package, dtype, scene_dir, device)
    color, depth = reader.get_color(0), reader.get_depth(0)
    pose = est.register(K=reader.color_K, rgb=color, depth=depth,
                        ob_mask=reader.get_mask(color, 0).astype(bool), iteration=5)
    gt = reader.get_gt_pose(0)
    gt_c = gt @ np.linalg.inv(est.get_tf_to_centered_mesh())
    poses, scores = np.asarray(est.poses), np.asarray(est.scores, dtype=np.float64)
    rots = [rotation_angle_deg(p[:3, :3], gt_c[:3, :3]) for p in poses]
    good = [i for i, r in enumerate(rots) if r < GOOD_DEG]
    return {"scene": scene, "package": package, "dtype": dtype,
            "device": device if package == "port" else "cpu",
            "pose_rot_deg": rotation_angle_deg(pose[:3, :3], gt[:3, :3]),
            "top_scores": scores[:top].tolist(), "top_rot_deg": rots[:top],
            "top_score_spread": float(scores[0] - scores[top - 1]),
            "first_within_15deg_rank": good[0] if good else None,
            "hypotheses": len(rots), "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="synth_clutter")
    ap.add_argument("--runs", default="jax:bfloat16,jax:float32,port:bfloat16,port:float32")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    for spec in args.runs.split(","):
        package, dtype = spec.split(":")
        print(json.dumps(run(package, dtype, args.scene, args.device, args.top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
