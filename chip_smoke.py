#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's pose server on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; a phase that fails raises and the script exits
non-zero without printing the final result:

  device   the card's name and power limit (torch and nvidia-smi)
  build    nvcc compiles sixdof_tpu_torch/csrc/raster_zbuffer.cu
  k1       raster kernel K1 against its plain PyTorch version on the card,
           on the register shapes (B=252 at 96x96, B=64 at 160x160) with
           backface culling and compaction; kernel and plain timings
  pose     the pose server at full width (252 hypotheses, 96x96 coarse
           phase, 160x160 refine and score, 5 register iterations, depth
           polish, then track_one with 2 iterations and the track polish on
           frames 1-5) with seeded networks, through the kernel; then the
           same loop with the plain raster, which must agree
  kernels  each kernel the run launched, with its check and numbers

The last line is {"ok": true, "device": {...}}.  Without CUDA the script
exits 1 before any result.  `run(device="cpu", small=True)` rehearses every
phase at a tiny size with the plain raster (tests/test_torch_chip_smoke.py).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and fp32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# K1 tolerances: both versions do the same IEEE fp32 operations in the same
# order, so depth is expected bit-equal; tid may differ only where two
# candidates have exactly equal inverse depth
K1_DEPTH_ATOL = 1e-6
K1_TID_MIN_AGREE = 0.999
# kernel run vs plain-raster run of the pose server
POSE_ROT_DEG_MAX = 0.1
POSE_TRANS_M_MAX = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def _nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn, device, n):
    """Mean milliseconds of @fn over @n calls (CUDA events on the card)."""
    import torch

    if device.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_k1(device, mesh_arrays, poses_all, K, diameter, shapes, n_time):
    """K1 against its plain version at the register shapes."""
    import torch

    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer, rasterize_zbuffer_plain
    from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch
    from sixdof_tpu_torch.ops.rasterize import render_batch, zbuffer_setup

    results = []
    for B, H, W in shapes:
        poses = poses_all[:B]
        tfs = compute_crop_window_tf_batch(poses, K, 1.2, (W, H), diameter)
        s = zbuffer_setup(mesh_arrays, poses, K, tfs, backface_cull=True)
        coef, counts = s["coef_c"], s["counts"]
        zk, tk = rasterize_zbuffer(coef, counts, H, W)
        zp, tp = rasterize_zbuffer_plain(coef, counts, H, W)
        _sync(device)
        depth_err = float((zk - zp).abs().max())
        agree = float((tk == tp).double().mean())
        # every tid mismatch must sit on an exact inverse-depth tie
        bad = (tk != tp).nonzero()
        ties_ok = True
        if len(bad):
            b, p = bad[:, 0], bad[:, 1]
            px, py = (p % W).float(), torch.div(p, W, rounding_mode="floor").float()

            def iz(t):
                c = coef[b, t.long().clamp(min=0), 3]
                return c[:, 0] * px + c[:, 1] * py + c[:, 2]

            ties_ok = bool(((tk[b, p] >= 0) & (tp[b, p] >= 0)).all()
                           and (iz(tk[b, p]) == iz(tp[b, p])).all())
        rk = render_batch(mesh_arrays, poses, K, tfs, out_hw=(H, W), backface_cull=True)
        rp = render_batch(mesh_arrays, poses, K, tfs, out_hw=(H, W), backface_cull=True,
                          plain_raster=True)
        render_err = max(float((rk[k] - rp[k]).abs().max()) for k in rk)
        # timings: kernel warm over many launches; plain over a few
        for _ in range(3):
            rasterize_zbuffer(coef, counts, H, W)
        ms = _timed(lambda: rasterize_zbuffer(coef, counts, H, W), device, n_time)
        plain_ms = _timed(lambda: rasterize_zbuffer_plain(coef, counts, H, W), device,
                          max(1, n_time // 10))
        n_tests = int(counts.long().sum()) * H * W
        bytes_moved = int(counts.long().sum()) * 48 + B * 4 + B * H * W * 8
        flops = n_tests * 16  # 4 planes x (2 multiplies + 2 adds) per (pixel, triangle)
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        res = dict(B=B, H=H, W=W, mean_count=float(counts.float().mean()),
                   max_abs_depth_err=depth_err, tid_agree=agree, tid_mismatch=len(bad),
                   mismatches_at_ties=ties_ok, render_max_abs_err=render_err,
                   ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   gflops=flops / (ms * 1e-3) / 1e9)
        emit({"phase": "k1", **res})
        if not (depth_err <= K1_DEPTH_ATOL and agree >= K1_TID_MIN_AGREE and ties_ok
                and render_err <= K1_DEPTH_ATOL):
            raise RuntimeError(f"K1 disagrees with its plain version at B={B} {H}x{W}: {res}")
        results.append(res)
    return results


def phase_pose(device, cfg, small, n_frames, plain_raster, refiner, scorer, warmup):
    """register + track_one on the demo scene; returns poses, timings, counts."""
    import numpy as np

    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer
    from sixdof_tpu_torch.metrics import adds_err

    scene = os.path.join(REPO, cfg.test_scene_dir)
    reader = DataReader(scene, shorter_side=cfg.shorter_side)
    mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         scorer=scorer, refiner=refiner, device=device, prune_to=cfg.prune_to,
                         coarse_hw=cfg.coarse_hw, plain_raster=plain_raster)
    if small:
        est.rot_grid = est.rot_grid[:: len(est.rot_grid) // 8][:8]
    n_hypo = len(est.rot_grid)
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    K = reader.color_K
    reg_iters, track_iters = cfg.est_refine_iter, cfg.track_refine_iter
    if warmup:  # first-call CUDA/cuBLAS/cuDNN set-up stays out of the timings
        est.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=reg_iters)
        est.track_one(rgb=reader.get_color(1), depth=reader.get_depth(1), K=K,
                      iteration=track_iters)
    _sync(device)
    rasterize_zbuffer.launches = 0
    t0 = time.perf_counter()
    pose0 = est.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=reg_iters)
    _sync(device)
    register_s = time.perf_counter() - t0
    register_launches = rasterize_zbuffer.launches
    poses, track_ms, track_launches = [pose0], [], []
    for i in range(1, n_frames + 1):
        c, d = reader.get_color(i), reader.get_depth(i)
        before = rasterize_zbuffer.launches
        t0 = time.perf_counter()
        poses.append(est.track_one(rgb=c, depth=d, K=K, iteration=track_iters))  # host pose
        track_ms.append((time.perf_counter() - t0) * 1e3)
        track_launches.append(rasterize_zbuffer.launches - before)
    total_launches = rasterize_zbuffer.launches
    for p in poses:
        R = p[:3, :3]
        if (p.shape != (4, 4) or not np.isfinite(p).all()
                or np.abs(R @ R.T - np.eye(3)).max() > 1e-3):
            raise RuntimeError(f"bad pose from the pose server:\n{p}")
    model = mesh.vertices
    adds = [adds_err(p, reader.get_gt_pose(i), model) for i, p in enumerate(poses)]
    return dict(n_hypotheses=n_hypo, register_s=register_s, track_ms=track_ms,
                register_launches=register_launches, track_launches=track_launches,
                launches=total_launches, adds_m=adds, poses=poses,
                top_score=float(est.scores[0]), scores=est.scores)


def _rot_deg(R1, R2):
    """Rotation angle between R1 and R2 from the chord ||R1 - R2||_F
    (= 2 sqrt(2) sin(angle / 2)), stable near zero unlike the trace form."""
    import numpy as np

    chord = np.linalg.norm(R1 - R2) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord))))


def run(device="cuda", small=False):
    """All phases; raises on any failure.  Returns the list of kernel records."""
    import numpy as np
    import torch

    from sixdof_tpu_torch.config import PipelineConfig
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels import raster
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter
    from sixdof_tpu_torch.ops.hypotheses import make_rotation_grid
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    # deterministic cuDNN, so the kernel and plain-raster runs see the same
    # network arithmetic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    if on_card:
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t0 = time.perf_counter()
        raster.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(raster.build_info["library"], REPO),
              "ptxas": raster.build_info["ptxas"].strip().splitlines()[-2:]})

    cfg = PipelineConfig()
    if small:
        cfg = PipelineConfig(shorter_side=120, input_resize=(32, 32), prune_to=4,
                             coarse_hw=(16, 16))
    scene = os.path.join(REPO, cfg.test_scene_dir)

    # K1 at the register shapes, on seeded poses around the object
    mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    mesh.vertices = mesh.vertices - (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    diameter = compute_mesh_diameter(mesh.vertices)
    reader = DataReader(scene)
    K = torch.as_tensor(reader.color_K, dtype=torch.float32, device=dev)
    grid = make_rotation_grid()
    rng = np.random.RandomState(0)
    grid[:, :3, 3] = np.array([0.0, 0.0, 0.55]) + rng.uniform(-0.02, 0.02, (len(grid), 3))
    poses = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    shapes = [(8, 24, 24), (4, 40, 40)] if small else [(252, 96, 96), (64, 160, 160)]
    k1 = phase_k1(dev, make_mesh_arrays(mesh, dev), poses, K, diameter, shapes,
                  n_time=2 if small else 50)

    # the pose server, through the kernel, then through the plain raster
    refiner = PoseRefinePredictor(dev, cfg={"input_resize": cfg.input_resize}, seed=0)
    scorer = ScorePredictor(dev, cfg={"input_resize": cfg.input_resize}, seed=1)
    n_frames = 2 if small else 5
    kern = phase_pose(dev, cfg, small, n_frames, False, refiner, scorer, warmup=on_card)
    plain = phase_pose(dev, cfg, small, n_frames, True, refiner, scorer, warmup=False)
    rot = [_rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(kern["poses"], plain["poses"])]
    trans = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
             for a, b in zip(kern["poses"], plain["poses"])]
    report = {k: v for k, v in kern.items() if k not in ("poses", "scores")}
    emit({"phase": "pose", **report, "plain_register_s": plain["register_s"],
          "plain_track_ms": plain["track_ms"], "vs_plain_rot_deg": rot,
          "vs_plain_trans_m": trans, "top_score": kern["top_score"],
          "plain_top_score": plain["top_score"]})
    if on_card and (kern["register_launches"] == 0 or min(kern["track_launches"]) == 0):
        raise RuntimeError("the pose server did not launch raster kernel K1")
    if max(rot) > POSE_ROT_DEG_MAX or max(trans) > POSE_TRANS_M_MAX \
            or abs(kern["top_score"] - plain["top_score"]) > 1e-3:
        raise RuntimeError("kernel and plain-raster pose servers disagree: "
                           f"rot {rot} deg, trans {trans} m, top score "
                           f"{kern['top_score']} vs {plain['top_score']}")

    main_shape = k1[0]
    kernels = [{
        "name": "raster_zbuffer", "route": "cuda",
        "source": "sixdof_tpu_torch/csrc/raster_zbuffer.cu",
        "replaces": "sixdof_tpu/ops/pallas/raster_kernel.py:188",
        "launches": kern["launches"],
        "max_abs_err": max(r["max_abs_depth_err"] for r in k1),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "check": "passed",
    }]
    emit({"kernels": kernels})
    return kernels


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, "sixdof_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    smi = _nvidia_smi()
    run("cuda")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
