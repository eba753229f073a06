#!/usr/bin/env python3
"""Where the PyTorch port's capture path spends its time, on one CUDA card.

    python3 tools/profile_torch_capture.py [--trace-dir traces]

Runs the capture path on the demo scene synth_box from its annotated poses,
with the scene's icp_parameters.json, as chip_smoke.py's capture phase does:
refine_pose_with_icp on frame 0 (host preprocessing, z ladder, restart ICP),
the frame-0 defect ray trace, and one async capture on frame 2
(capture-time preprocessing, dispatch, result).  Each is warmed up once,
then run under torch.profiler; for each it prints one JSON line in the form
of tools/profile_torch_pose.py (wall time, device-busy time, busy share,
kernel launches, top kernels).  With --trace-dir it also writes a Chrome
trace of each.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_capture: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from profile_torch_pose import _summary

    from sixdof_tpu_torch.app.defect_projection import (compute_rays, heatmap_to_points,
                                                       ray_tracing)
    from sixdof_tpu_torch.app.icp_pipeline import (CaptureContext, capture_event_async,
                                                   preprocess_source, refine_pose_with_icp)
    from sixdof_tpu_torch.io.readers import DataReader

    dev = torch.device("cuda")
    reader = DataReader(SCENE)
    params = reader.parameters
    init = reader.color_to_depth @ reader.scale_translation_to_millimeters(reader.get_gt_pose(0))
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    rays, inten = compute_rays(heatmap_to_points(heatmap, 0.75), reader.color_pinhole)
    pose2 = torch.as_tensor(reader.get_gt_pose(2), dtype=torch.float32, device=dev)
    state = {}

    def icp_refine():
        _, res, _, state["target"] = refine_pose_with_icp(
            reader.get_source(0), reader.target, reader.background, init, params, device=dev)
        state["posed"] = reader.target_mesh.copy().transform(np.linalg.inv(res.transformation))

    def trace():
        ray_tracing(reader.base_dir, state["posed"], heatmap, reader.color_pinhole,
                    heatmap_threshold=0.75, device=dev)

    def capture():
        ctx = state.setdefault("ctx", CaptureContext(state["target"], reader.target_mesh,
                                                     reader.color_to_depth, device=dev))
        src, _, _ = preprocess_source(reader.get_source(2), reader.background, params, i=2)
        capture_event_async(src, pose2, np.eye(4), params, rays, np.ones(len(rays), bool),
                            inten, ctx).result()

    stages = (("icp_refine", icp_refine), ("ray_tracing", trace), ("capture", capture))
    for _, fn in stages:  # warm-up
        fn()
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)
    for stage, fn in stages:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps({"stage": stage, "device": name, **_summary(prof, wall, args.top)}),
              flush=True)
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace_dir, f"torch_{stage}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
