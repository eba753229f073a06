#!/usr/bin/env python3
"""Where the PyTorch port's pose server spends its time, on one CUDA card.

    python3 tools/profile_torch_pose.py [--frames 5] [--trace-dir traces]

Builds the pose server as chip_smoke.py does (demo scene synth_box, the
bundled networks from weights_torch/, 252 hypotheses), warms it up with one
register and one track step, then runs register once and track_one on --frames frames under
torch.profiler.  For each of the two it prints one JSON line: wall time,
device-busy time (sum of the CUDA kernels' own durations), the busy share,
the kernel launch count, and the kernels that take the most device time.
With --trace-dir it also writes a Chrome trace of each.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
WEIGHTS = os.path.join(REPO, "weights_torch")


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _summary(prof, wall_s, top):
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e6 / wall_s if wall_s else None,
        "kernel_launches": launches,
        "top": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3, "count": int(e.count)}
                for e in kernels[:top]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_pose: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    dev = torch.device("cuda")
    reader = DataReader(SCENE)
    mesh = load_mesh(os.path.join(SCENE, "mesh", "model_scaled_down.obj"))
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         scorer=ScorePredictor(dev, ckpt_dir=os.path.join(WEIGHTS, "scorer.npz")),
                         refiner=PoseRefinePredictor(dev, ckpt_dir=os.path.join(WEIGHTS,
                                                                                "refiner.npz")),
                         device=dev, prune_to=64,
                         coarse_hw=(96, 96))
    K = reader.color_K
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    frames = [(reader.get_color(i), reader.get_depth(i))
              for i in range(1, min(args.frames, len(reader) - 1) + 1)]
    est.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=5)  # warm-up
    est.track_one(rgb=frames[0][0], depth=frames[0][1], K=K, iteration=2)
    torch.cuda.synchronize()

    def register():
        est.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=5)

    def track():
        for c, d in frames:
            est.track_one(rgb=c, depth=d, K=K, iteration=2)

    name = torch.cuda.get_device_name(0)
    for stage, fn in (("register", register), ("track", track)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = {"stage": stage, "device": name, **_summary(prof, wall, args.top)}
        if stage == "track":
            out["frames"] = len(frames)
        print(json.dumps(out), flush=True)
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace_dir, f"torch_{stage}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
