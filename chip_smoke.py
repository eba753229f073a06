#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's pose server, capture path, trainer, JPEG
decoder, BOP campaign, live-camera loop, neural object field, H5 pose-pair
path, its multi-device path (the data and the model axis), its start-up
path, its scene synthesis, accuracy parity harness and artifact, register
schedule sweep and FLOP accounting, and the evaluation of trained weights
on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, one JSON line each; a phase that fails raises and the script exits
non-zero without printing the final result:

  device   the card's name and power limit (torch and nvidia-smi)
  build    both kernel sources, the PNG row-filter routine and the JPEG
           decoder compile at once (nvcc: sixdof_tpu_torch/csrc/
           raster_zbuffer.cu, csrc/ray_mesh.cu; cc: csrc/png_unfilter.c,
           csrc/jpeg_decode.c)
  k1       raster kernel K1 against its plain PyTorch version on the card
           (zbuf bit-equal, tid equal on every pixel), on the register
           shapes (B=252 at 96x96, B=64 at 160x160), the track shapes (B=1
           at 160x160 and 96x96), model_scaled_down.obj subdivided to
           5120 triangles (B=64 at 160x160) and the bop phase's full grid
           (B=252 at 160x160, on the pose mesh and on a 20,480-triangle
           subdivision decimated to 5000), with backface culling and
           compaction; kernel (CUDA events and profiler device time) and
           plain timings, the bound from the pixels in each candidate's
           bounding box beside the brute-force bound, and the mean
           candidates per 16x16 tile and per 8x4 warp region that pass the
           kernel's corner test
  pose     the pose server at full width (252 hypotheses, 96x96 coarse
           phase, 160x160 refine and score, 5 register iterations, depth
           polish, then track_one with 2 iterations and the track polish on
           frames 1-5) with the bundled networks (weights_torch/, the numpy
           export of weights/; missing weights fail the run), through the
           kernel; then the same loop with the plain raster, which must agree
  k2       ray-mesh kernel K2 against its plain version at four shapes:
           the capture's heatmap rays (587 x 1280 triangles of model.obj
           posed by the annotated pose), 8192 seeded rays (MAX_DEFECT_RAYS,
           some masked) and every pixel of the 640x480 frame, all from the
           camera centre, and 8192 rays from seeded origins (no common
           origin); t bit-equal; kernel (CUDA events and profiler device
           time) and plain timings, the bound from the pairs whose direction
           lies in the triangle's enlarged cone beside the brute-force
           bound, and the triangles each block keeps (mean, max)
  accuracy the pose phase's kernel run against annotated_poses/ (ADD-S,
           ADD, their AUC, rotation and translation error, register and
           track apart), refine_pose_with_icp from the registered pose
           (fitness, ADD-S) and the frame-0 defect ray trace through K2
           (median distance to the mesh), each beside the JAX package's
           PARITY_r5.json value and held to tools/parity_check.py's synth_box
           ceilings
  capture  (a) refine_pose_with_icp from the annotated pose of frame 0, the
           frame-0 defect ray trace and one async capture on frame 2;
           (b) the port's run loop (sixdof_tpu_torch/app/run.py::main) on
           frames 0-5 with async captures every 2 frames (3 K2 launches),
           whose ICP results must register (fitness >= 0.9); then (a) and
           (b) again through K2's plain version, which must give the same
           transforms and defect points
  debug    the run loop at --debug 2 on frames 0-1: the staged register
           (K1 launches counted), its pose beside the pose phase's fused
           register (the pose phase's limits) and both register times, and
           vis_refiner.png, track_vis/0001.png and overlay/overlay_0.png
           decoded
  viewer   the run loop in viewer mode on 127.0.0.1 (a free port), frames
           0-3: GET / holds the Capture New Data button, the overlay is
           served, one POST /capture after frame 0 triggers a capture on
           frame 1 whose defect cloud reaches GET /data (a higher seq, the
           loop state's point and face counts)
  point_click  ray_tracing_points through K2 on the crust create_mesh builds
           from mesh/model.ply (169,900 triangles), posed by the annotated
           pose, at 64 seeded clicks inside the object's projection (K2
           launches counted), and heatmap_to_rays at 0.75 (the same rays on
           the card and the CPU) against the crust: t bit-equal to K2's
           plain version, kernel and plain timings and the bound, as in k2
  icp_global  determine_pose(icp=True) on the demo inputs on the card and on
           the CPU (the same valid RANSAC trials, 0 on synth_box, and the
           same fitness; seconds in FPFH, RANSAC and ICP), then
           determine_pose(icp=False) from the annotated pose (fitness >= 0.9)
  train    the trainer (sixdof_tpu_torch/parallel/train.py) at its
           configuration (batch 32 at 160x160, the scorer 4 scenes x 12,
           clutter and sensor model on): refiner and scorer batches on
           synth_box and a procedural object through K1 and through the
           plain raster from the same draws (bit-equal), K1 timed at B=32
           and B=48 160x160 without culling (phase line `train_k1`); a
           textured box (seeded uv, 256x256 texture) written and read back
           (equal), rendered at B=64 through both (bit-equal) and one
           refiner step on it; the fixed-batch overfit at JAX's test
           setting (below 0.8x in 40 steps) and the same at the trainer's
           setting (reported); 10 refiner and 5 scorer steps round-robin
           over both objects (K1 launches counted, 2 a step; batch and
           update ms by CUDA events; busy share and launches of a step and
           of its batch generation alone by the profiler; peak memory); the bundled weights' first losses beside
           a fresh model's (the refiner's must be lower); the trained nets
           written, loaded by the predictors (outputs bit-equal) and
           registering frame 0 (a finite pose)
  jpeg     the JPEG decoder (cc: csrc/jpeg_decode.c) on the host: every
           fixture of tests/data/jpeg (synth_box's frames as JPEG, one file
           of each kind read, a 256x256 texture) decoded as cv2.imread and
           as PIL's convert("RGB") decode it, each sha256 equal to the
           manifest's; frame 0 (640x480) decoded 50 times as JPEG and as
           PNG (median ms); an OBJ whose map_Kd is the JPEG texture loaded
           (its texture's sha256 equal to the manifest's)
  bop      the BOP campaign: each 6-frame demo scene converted by
           tools/convert_scene_to_bop_torch.py and scored by
           tools/run_bop_torch.py at full width, on the full grid and at
           prune_to 64, plus synth_box with its model subdivided to 20,480
           triangles (decimated by the tool) and synth_box_jpeg (its frames
           swapped for the JPEG fixtures, synth_box's ceilings, the JAX
           package's numbers on it from the manifest and frame 0's pose
           beside the PNG scene's); ADD-S held to
           tools/parity_check.py's ceiling of each scene at both settings,
           rotation on the full grid; ADD, AUC, recall and t error beside
           PARITY_r5.json; K1 launches and seconds a run
  live     the run loop at --no-demo --capture_background true on frames
           0-5 with captures every 2 frames, against scene_kinect (a
           stand-in for pykinect_azure serving synth_box at the Kinect's
           sizes), through K1 and K2 and again through their plain
           versions: the same poses (the pose phase's limits), identical
           captures, the background captured and the camera stopped; ADD-S
           against the annotated poses reported
  field    the neural object field through tools/run_object_field_torch.py
           on synth_box_recon (40 frames) at the JAX tool's configuration
           (1000 steps of 2048 rays x 128 + 128 samples, a 2^22 hash table,
           extraction at 128^3, colour, texture bake): chamfer_ok against
           the GT mesh (at most 2 voxels), s/step, seconds a stage, peak
           memory, final loss; 20 more steps with draws, forward+backward
           and Adam timed apart, one under the profiler (busy share,
           launches); frame 0 registered on the extracted mesh through K1
           (ADD-S reported, a finite pose required)
  h5       the H5 pose-pair path at the trainer's width: a refiner batch of
           32 pairs at 160x160 on synth_box through K1, its crops encoded
           into the H5 layout's PNG blobs and decoded bit-equal (timed), a
           BatchPoseData pinned and moved to the card, transform_batch at
           H_ori, W_ori = 540, 720 on the card and the CPU (colour
           bit-equal, xyz within H5_XYZ_ATOL but for H5_XYZ_FLIP_SHARE;
           timed), select_by_indices; opening an .h5 file without h5py
           raises the ImportError naming it
  multi    the multi-device path: ranks on the one card over gloo
           (spawn_ranks, a FileStore, 120 s timeouts; it measures no
           scaling), part by part, each held to rank 0's unsharded run of
           the same inputs.  The data axis on 2 ranks: (register)
           FoundationPose(device_mesh=...) on frame 0 at the app's
           configuration (252 hypotheses, prune_to 64, 96x96 coarse,
           160x160, 5 iterations) against the unsharded staged register
           (the pose phase's limits, top-5 scores 1e-3 relative); (capture)
           frame 2's capture with its restarts and rays sharded, restart by
           restart and ray by ray; (train) 3 refiner and 3 scorer steps
           from the bundled weights at batch 32 / 4 scenes x 12 and (field)
           3 object-field steps at the JAX tool's configuration, each loss
           1e-3 relative and the first step's averaged gradients 1e-4 of
           the largest entry, the trunk's first gradient non-zero.  The
           model axis: (model) the same trainer steps with the large layers
           split over a (1, 2) mesh and (model2d) a (2, 2) mesh, held as
           (train) is, the replicated parameters bit-equal across the model
           ranks and every parameter across the data ranks after the steps,
           the split trainer's checkpoint equal to its gathered weights,
           loaded by the predictors and within 6 steps of lr of the
           unsharded one's.  Seconds, data- and model-axis collective
           seconds, peak memory and K1 and K2 launches of each rank
  cold     the start-up path in fresh processes: tools/precompile_torch.py
           on synth_box (the libraries found built, the engine's warm-up
           parts and their K1/K2 launches), then
           tools/measure_cold_start_torch.py, the app at its defaults on
           frames 0-5 with captures on 2 and 4, its timeline from
           interpreter start (seconds to the first pose and the first defect
           cloud, first and second register, each capture, the warm-up's
           parts and how long frame 0's register waited for it): (a)
           --precompile 0 and (b) --precompile 1 on the built libraries, (c)
           --precompile 1 building them anew, (d) (b) with glibc's malloc
           held to one arena; (a) and (b) bit-equal (poses, ICP transforms,
           defect clouds) with the same loop launches, and (b)'s warm-up
           launching K1 and K2 (counted apart from the loop's)
  scene    the scene generator (tools/make_demo_scene_torch.py) through K1
           at full frame (B=1, 640x480; 2 launches a frame): the six
           committed scenes regenerated (synth_box, synth_clutter,
           synth_occl, the two sensor scenes: 6 frames; synth_box_recon:
           40), every render's z-buffer held to K1's plain version (zbuf
           bit-equal, tid equal; those launches counted apart) and each
           scene to its committed files by the tool's SCENE_GATES (poses,
           meshes, model.ply, background, heatmap, camera configs and masks
           equal; depth, RGB and clouds within the float32 raster rounding
           the gates state); seconds a frame in rendering, the sensor chain
           and writing; K1 timed at the box's and the clutter scene's
           full-frame shapes (phase lines `scene_k1`); then a 31-frame
           synth_box generated and the run loop over it (frame 0 register +
           ICP + ray trace, 30 tracked frames, captures on 10, 20 and 30,
           each registering): frame ms and the stage means
  parity   the port's parity artifact (tools/make_parity_artifact_torch.py):
           tools/parity_check_torch.py on the five 6-frame scenes at the
           app's defaults on the bundled networks, the network-mode rows
           (synth_box, synth_clutter) and the clutter rank0 probe (prune_to
           64, depth polish), each field beside the JAX package's
           PARITY_r5.json value; every scene within the tool's ceilings,
           the rank0 probe's ADD-S within 5 mm (its rotation and the
           network rows reported: off the TPU the JAX package flips
           there too); the artifact printed as one line
           (`parity_artifact`; PARITY_torch_r1.json is that line)
  sweep    tools/sweep_register_schedule_torch.py: prune_to 64 and the
           schedules 1x128,1x64 / 1x128,1x48 / 1x96,1x48 at shorter side
           288: first and warm register seconds, frame-0 rotation,
           translation and ADD-S errors (reported)
  flops    tools/flops_report_torch.py: FlopCounterMode's FLOPs of
           register, its cascade, a track step and the cascade's four
           stages beside FLOPS.json's XLA figures; the cascade equal to
           the sum of its stages
  evaluate evaluating trained weights: (a) tools/eval_register_torch.py on
           synth_box with the bundled networks (the refiner's basin at 5,
           10, 20, 30 and 45 deg, the refined 252-pose grid, the scorer's
           ranking), the basin at 5 and 20 deg again through K1's plain
           version (the pose phase's limits), K1 against its plain version
           at the basin's B=8 160x160 (`evaluate_k1`); (b) phase train's
           nets saved as a candidate whose refiner was trained with
           occ_sub 0.85, tools/eval_candidate_torch.py on it with
           synth_box: EVAL.json with the JAX tool's keys, its
           clutter_rank0.occ_sub 0.85 and every refine handed 0.85 as a
           float (accuracy reported, not held)
  kernels  each kernel the run launched, with its check and numbers (K1's
           launches: the pose, train, bop, live, field, h5, scene, parity,
           sweep, flops and evaluate phases' and multi's ranks'; K2's: the
           run loop's in capture (b), point_click's, live's, scene's loop,
           parity's, evaluate's and multi's ranks')

The last line is {"ok": true, "device": {...}}.  Without CUDA the script
exits 1 before any result.  `run(device="cpu", small=True)` rehearses every
phase at a tiny size through the plain versions, where the accuracy
ceilings and the loop's fitness are reported but not held, and phase cold
runs (b) alone (tests/test_torch_chip_smoke.py).
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
# K1 against its plain version: the same IEEE fp32 operations in the same
# order over the candidates in ascending order, so depth bit-equal
# (tolerance 0) and tid equal on every pixel (no mismatch allowed)
K1_DEPTH_ATOL = 0.0
# 4 planes x (2 multiplies + 2 adds) per (pixel, triangle) test
K1_FLOPS_PER_PAIR = 16
# kernel run vs plain-raster run of the pose server
POSE_ROT_DEG_MAX = 0.1
POSE_TRANS_M_MAX = 1e-4
# K2 against its plain version: the same IEEE fp32 operations in the same
# order, so hit masks equal and t bit-equal (tolerance 0)
K2_T_ATOL = 0.0
# capture: ICP from the annotated pose must register; kernel and plain-K2
# runs must give the same transforms and defect points (K2 is bit-equal to
# its plain version and the rest of each run is the same computation:
# tolerance 0)
CAPTURE_MIN_FITNESS = 0.9
# --icp on the card against the CPU run: the RANSAC trials are host numpy,
# the same on both, and the ICP that follows must end with the same inlier
# count (on synth_box no trial passes the checkers and both runs end at 0)
ICP_GLOBAL_FITNESS_ATOL = 1e-6
CAPTURE_TF_ATOL = 0.0
CAPTURE_PTS_ATOL = 0.0
# accuracy on synth_box: tools/parity_check.py's ceilings (about 2x the JAX
# package's PARITY_r5.json values)
ACCURACY_CEILINGS = {"adds_mean_m": 0.005, "rot_err_deg_mean": 6.0, "icp_adds_mm": 4.0,
                     "defect_surface_median_dist_mm": 5.0,
                     "defect_to_annotated_mesh_median_mm": 5.0}
WEIGHTS = os.path.join(REPO, "weights_torch")


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


def _subdivide(mesh):
    """Midpoint subdivision: each triangle into four, sharing edge midpoints
    (1280 -> 5120 triangles for model_scaled_down.obj); colours and uv of a
    midpoint are its edge's mean."""
    import numpy as np

    from sixdof_tpu_torch.io.mesh_io import TriMesh

    v, f = mesh.vertices, mesh.faces
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    ab, bc, ca = (len(v) + inv.reshape(3, -1))  # midpoints of edges 01, 12, 20
    a, b, c = f.T
    faces = np.stack([np.stack(t, 1) for t in ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                                              (ab, bc, ca))], 1).reshape(-1, 3)

    def split(x):
        return None if x is None else np.vstack([x, (x[uniq[:, 0]] + x[uniq[:, 1]]) / 2])

    return TriMesh(split(v), faces, split(mesh.vertex_colors), split(mesh.uv), mesh.texture)


def _bbox_pairs(setup, faces, K, tfs, H, W):
    """(pixel, candidate) pairs whose pixel lies in the candidate triangle's
    screen bounding box, clamped to the crop: the work these inputs need."""
    import torch

    from sixdof_tpu_torch.ops.rasterize import ZNEAR

    uvw = torch.matmul(setup["p_cam"], K.T)
    uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=ZNEAR)
    uv = torch.matmul(torch.cat([uv, torch.ones_like(uv[..., :1])], -1),
                      tfs.transpose(1, 2))[..., :2]
    tri = torch.take_along_dim(uv[:, faces], setup["order"][..., None, None], dim=1)
    lo = torch.ceil(tri.amin(dim=2)).clamp(min=0)
    hi = torch.minimum(torch.floor(tri.amax(dim=2)), torch.tensor([W - 1.0, H - 1.0],
                                                                  device=tri.device))
    n = torch.clamp(hi - lo + 1, min=0).prod(dim=-1)  # (B,T)
    live = torch.arange(n.shape[1], device=n.device) < setup["counts"][:, None]
    return int(torch.where(live, n, 0).double().sum())


def _tile_survivors(coef, counts, H, W, tw=16, th=16):
    """Mean candidates per (pose, tw x th tile) that pass K1's corner test
    (csrc/raster_zbuffer.cu: 16x16 tiles, then 8x4 warp regions), in
    PyTorch float32 at all four corners (the kernel's one-corner form
    decides the same; tests/test_torch_raster_binning.py)."""
    import torch

    def plane(c, x, y):
        return (c[..., 0] * x + c[..., 1] * y) + c[..., 2]

    dev = coef.device
    ty, tx = torch.meshgrid(torch.arange(0, H, th, device=dev),
                            torch.arange(0, W, tw, device=dev), indexing="ij")
    x0, y0 = tx.reshape(-1, 1, 1).float(), ty.reshape(-1, 1, 1).float()
    x1 = (torch.clamp(tx + tw, max=W) - 1).reshape(-1, 1, 1).float()
    y1 = (torch.clamp(ty + th, max=H) - 1).reshape(-1, 1, 1).float()
    total = 0
    for b0 in range(0, coef.shape[0], 16):
        c = coef[b0:b0 + 16, None, :, :3, :]
        lim = -2.0 * (2.0 ** -22 * plane(c.abs(), x1, y1) + torch.finfo(torch.float32).tiny)
        below = ((plane(c, x0, y0) < lim) & (plane(c, x1, y0) < lim)
                 & (plane(c, x0, y1) < lim) & (plane(c, x1, y1) < lim)).any(dim=-1)
        live = torch.arange(coef.shape[1], device=dev) < counts[b0:b0 + 16, None]
        total += int((~below & live[:, None]).sum())
    return total / (coef.shape[0] * x0.shape[0])


def _device_us(fn, n, name):
    """Mean device microseconds of the kernels named @name over @n calls of
    @fn, from torch.profiler; None where the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and name in e.key:
            us += float(getattr(e, "self_device_time_total", 0.0)
                        or getattr(e, "self_cuda_time_total", 0.0))
            count += int(e.count)
    return us / count if count and us > 0 else None


def phase_k1(device, cases, K, diameter, n_time, phase="k1", cull=True, full_frame=False):
    """K1 against its plain version: zbuf bit-equal and tid equal on every
    pixel.  @cases: (label, mesh arrays, poses, H, W); @cull: backface
    culling, as the pose server renders (the trainer does not cull);
    @full_frame: the whole image, no crop (the scene generator's renders)."""
    import torch

    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer, rasterize_zbuffer_plain
    from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch
    from sixdof_tpu_torch.ops.rasterize import render_batch, zbuffer_setup

    results = []
    for label, mesh_arrays, poses, H, W in cases:
        B = poses.shape[0]
        tfs = torch.eye(3, device=device).repeat(B, 1, 1) if full_frame else \
            compute_crop_window_tf_batch(poses, K, 1.2, (W, H), diameter)
        s = zbuffer_setup(mesh_arrays, poses, K, tfs, backface_cull=cull)
        coef, counts = s["coef_c"], s["counts"]
        zk, tk = rasterize_zbuffer(coef, counts, H, W)
        zp, tp = rasterize_zbuffer_plain(coef, counts, H, W)
        _sync(device)
        depth_err = float((zk - zp).abs().max())
        mismatch = int((tk != tp).sum())
        rk = render_batch(mesh_arrays, poses, K, tfs, out_hw=(H, W), backface_cull=cull)
        rp = render_batch(mesh_arrays, poses, K, tfs, out_hw=(H, W), backface_cull=cull,
                          plain_raster=True)
        render_err = max(float((rk[k] - rp[k]).abs().max()) for k in rk)
        # timings: kernel warm over many launches; plain over a few
        for _ in range(3):
            rasterize_zbuffer(coef, counts, H, W)
        ms = _timed(lambda: rasterize_zbuffer(coef, counts, H, W), device, n_time)
        device_us = (_device_us(lambda: rasterize_zbuffer(coef, counts, H, W), n_time,
                                "raster_zbuffer") if device.type == "cuda" else None)
        plain_ms = _timed(lambda: rasterize_zbuffer_plain(coef, counts, H, W), device,
                          max(1, n_time // 10))
        # bound: the work these inputs need (pixels in each candidate's
        # bounding box); beside it the brute-force count (every pixel against
        # every candidate) that the earlier one-thread-a-pixel kernel did
        n_cand = int(counts.long().sum())
        pairs = _bbox_pairs(s, mesh_arrays.faces, K, tfs, H, W)
        bytes_moved = n_cand * 48 + B * 4 + B * H * W * 8
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = pairs * K1_FLOPS_PER_PAIR / FP32_FLOPS * 1e3
        brute_ms = max(t_bytes, n_cand * H * W * K1_FLOPS_PER_PAIR / FP32_FLOPS * 1e3)
        res = dict(shape=label, B=B, H=H, W=W, triangles=int(mesh_arrays.faces.shape[0]),
                   mean_count=float(counts.float().mean()),
                   mean_tile_survivors=_tile_survivors(coef, counts, H, W),
                   mean_region_survivors=_tile_survivors(coef, counts, H, W, 8, 4),
                   bbox_pairs=pairs,
                   max_abs_depth_err=depth_err, tid_mismatch=mismatch,
                   render_max_abs_err=render_err, ms=ms, device_us=device_us,
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   brute_bound_ms=brute_ms)
        emit({"phase": phase, **res})
        if depth_err > K1_DEPTH_ATOL or mismatch or render_err > K1_DEPTH_ATOL:
            raise RuntimeError(f"K1 disagrees with its plain version at {label}: {res}")
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
                top_score=float(est.scores[0]), scores=est.scores,
                centred_pts=np.asarray(est.pts, dtype=np.float64), model_center=est.model_center,
                diameter=est.diameter)


def _cone_pairs(o, d, valid, tris, chunk):
    """(ray, triangle) pairs that can hit: the direction lies inside the
    cone of the triangle enlarged by the 1e-6 slack, in front of the
    origin (Moller-Trumbore in float64 on the float32 inputs, no det cut):
    the work these inputs need."""
    import torch

    tris = tris.double()
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    n = 0
    for i in range(0, len(o), chunk):
        oc, dc = o[i:i + chunk].double(), d[i:i + chunk].double()
        p = torch.cross(dc[:, None], e2[None].expand(len(dc), -1, -1), dim=-1)
        det = (p * e1[None]).sum(-1)
        s = oc[:, None] - v0[None]
        q = torch.cross(s, e1[None].expand(len(dc), -1, -1), dim=-1)
        u, v = (s * p).sum(-1) / det, (q * dc[:, None]).sum(-1) / det
        t = (q * e2[None]).sum(-1) / det
        inside = (det != 0) & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1 + 1e-6) & (t > 1e-6)
        n += int((inside & valid[i:i + chunk, None]).sum())
    return n


def k2_cases(device, scene, small):
    """K2's inputs at the capture's shapes: (packed triangles, their mask,
    [(name, origins or None for the camera centre, dirs, valid)]): the
    heatmap's rays, MAX_DEFECT_RAYS seeded rays (every 11th masked), every
    pixel of the frame, and MAX_DEFECT_RAYS rays from seeded origins inside
    and outside the mesh's bounding box; triangles: model.obj posed by the
    annotated pose of frame 0 in the colour camera (mm)."""
    import numpy as np
    import torch

    from sixdof_tpu_torch.app.defect_projection import (MAX_DEFECT_RAYS, compute_rays,
                                                       heatmap_to_points)
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels import raytrace as k2
    from sixdof_tpu_torch.ops.raytrace import mesh_to_tri_verts

    reader = DataReader(scene)
    mesh = reader.target_mesh.copy()
    mesh.transform(reader.scale_translation_to_millimeters(reader.get_gt_pose(0)))
    tri, tri_mask = mesh_to_tri_verts(mesh.vertices, mesh.faces)
    tris = k2.pack_tris(torch.as_tensor(tri, device=device),
                        torch.as_tensor(tri_mask, device=device))
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    app_rays, _ = compute_rays(heatmap_to_points(heatmap, 0.75), reader.color_pinhole)
    rng = np.random.RandomState(0)
    centre = mesh.vertices.mean(axis=0)
    n_rand = 64 if small else MAX_DEFECT_RAYS
    rand = centre + rng.randn(n_rand, 3) * 30.0
    rand_mask = np.arange(len(rand)) % 11 != 0
    lo, hi = mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
    mixed_o = lo + rng.rand(n_rand, 3) * (hi - lo) * 3.0 - (hi - lo)  # a third inside
    mixed_d = centre + rng.randn(n_rand, 3) * 20.0 - mixed_o
    H, W = reader.color_pinhole.height, reader.color_pinhole.width
    Kp = reader.color_pinhole.intrinsic_matrix
    step = 20 if small else 1  # the rehearsal takes every 20th pixel
    ys, xs = np.mgrid[0:H:step, 0:W:step]
    pix = np.stack([(xs - Kp[0, 2]) / Kp[0, 0], (ys - Kp[1, 2]) / Kp[1, 1], np.ones_like(xs)],
                   axis=-1).reshape(-1, 3)
    cases = []
    for name, origins, dirs, mask in [("heatmap", None, app_rays, np.ones(len(app_rays), bool)),
                                      ("max_defect_rays", None, rand, rand_mask),
                                      ("full_frame", None, pix, np.ones(len(pix), bool)),
                                      ("mixed_origins", mixed_o, mixed_d, np.ones(n_rand, bool))]:
        dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
        d = torch.as_tensor(dirs, dtype=torch.float32, device=device)
        o = (torch.zeros_like(d) if origins is None
             else torch.as_tensor(origins, dtype=torch.float32, device=device))
        cases.append((name, o, d, torch.as_tensor(mask, device=device)))
    return tris, tri_mask, cases


def phase_k2(device, scene, small, n_time):
    """K2 against its plain version at the shapes of `k2_cases`; the last
    one has no common origin (the kernel's uncull path).  Reports the
    triangles each block of the kernel keeps (its cull test, emulated)."""
    import torch

    from sixdof_tpu_torch.kernels import raytrace as k2

    tris, tri_mask, cases = k2_cases(device, scene, small)
    results = []
    for name, o, d, m in cases:
        tk = k2.ray_mesh_intersect(o, d, m, tris)
        tp = k2.ray_mesh_intersect_plain(o, d, m, tris)
        _sync(device)
        bit_equal = torch.equal(tk, tp)
        hits_equal = bool((torch.isfinite(tk) == torch.isfinite(tp)).all())
        both = torch.isfinite(tk) & torch.isfinite(tp)
        err = float((tk[both] - tp[both]).abs().max()) if bool(both.any()) else 0.0
        for _ in range(3):
            k2.ray_mesh_intersect(o, d, m, tris)
        ms = _timed(lambda: k2.ray_mesh_intersect(o, d, m, tris), device, n_time)
        device_us = (_device_us(lambda: k2.ray_mesh_intersect(o, d, m, tris), n_time,
                                "ray_mesh_kernel") if device.type == "cuda" else None)
        n_plain = 2 if name == "full_frame" else max(1, n_time // 10)
        plain_ms = _timed(lambda: k2.ray_mesh_intersect_plain(o, d, m, tris), device, n_plain)
        keep = k2.cull_keep(o, d, m, tris)
        R = k2.THREADS >> k2.threads_per_ray_log2(len(d))
        live = torch.cat([m, m.new_zeros(keep.shape[0] * R - len(m))]).reshape(-1, R).any(1)
        kept = keep[live].sum(dim=1).float()
        N, T = len(d), len(tri_mask)
        pairs = int(m.sum()) * int(tri_mask.sum())
        cone = _cone_pairs(o, d, m, tris, 1024 if small else 8192)
        bytes_moved = N * (12 + 12 + 1) + T * 36 + N * 4
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = cone * k2.FLOPS_PER_PAIR / FP32_FLOPS * 1e3
        res = dict(shape=name, rays=N, valid_rays=int(m.sum()), triangles=T,
                   rays_per_block=R, pairs=pairs, cone_pairs=cone,
                   survivors_per_block={"mean": float(kept.mean()), "max": int(kept.max())},
                   hits=int(torch.isfinite(tk).sum()), hits_equal=hits_equal,
                   bit_equal=bit_equal, max_abs_err=err, ms=ms, device_us=device_us,
                   plain_ms=plain_ms, plain_calls=n_plain, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   brute_bound_ms=max(t_bytes, pairs * k2.FLOPS_PER_PAIR / FP32_FLOPS * 1e3))
        emit({"phase": "k2", **res})
        if not (bit_equal and hits_equal) or err > K2_T_ATOL or res["hits"] == 0:
            raise RuntimeError(f"K2 disagrees with its plain version at {name}: {res}")
        results.append(res)
    return results


def _surface_median_mm(points, mesh, n_sample=200_000):
    """Median distance (mm) of @points to @mesh's surface, measured against a
    dense uniform sampling of the surface."""
    import numpy as np
    from scipy.spatial import cKDTree

    if len(points) == 0:
        return float("nan")
    surf = mesh.sample_points(n_sample, seed=0).points
    return float(np.median(cKDTree(surf).query(points, workers=-1)[0]))


def phase_accuracy(device, scene, small, pose):
    """The pose phase's kernel run (frames 0-5) against the annotated poses,
    ICP from the registered pose, and the defect ray trace on the mesh it
    posed, as tools/parity_check.py measures them for PARITY_r5.json."""
    import numpy as np
    from scipy.spatial import cKDTree

    from sixdof_tpu_torch.app.defect_projection import ray_tracing
    from sixdof_tpu_torch.app.icp_pipeline import refine_pose_with_icp
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import add_err, adds_err, compute_auc, rotation_angle_deg

    reader = DataReader(scene)
    model = pose["centred_pts"] + pose["model_center"]  # the original mesh frame
    per_frame = []
    for i, p in enumerate(pose["poses"]):
        gt = reader.get_gt_pose(i)
        per_frame.append(dict(adds_m=adds_err(p, gt, model), add_m=add_err(p, gt, model),
                              rot_err_deg=rotation_angle_deg(p[:3, :3], gt[:3, :3]),
                              t_err_m=float(np.linalg.norm(p[:3, 3] - gt[:3, 3]))))
    mean = {k: float(np.mean([f[k] for f in per_frame])) for k in per_frame[0]}
    m = {"adds_mean_m": mean["adds_m"], "add_mean_m": mean["add_m"],
         "adds_auc_0.1d": compute_auc([f["adds_m"] for f in per_frame],
                                      max_val=0.1 * pose["diameter"]),
         "rot_err_deg_mean": mean["rot_err_deg"], "t_err_m_mean": mean["t_err_m"]}
    for stage, frames in (("register", per_frame[:1]), ("track", per_frame[1:])):
        for k in per_frame[0]:
            m[f"{stage}_{k}_mean"] = float(np.mean([f[k] for f in frames]))

    params = _icp_parameters(reader.parameters, small)
    init = reader.color_to_depth @ reader.scale_translation_to_millimeters(pose["poses"][0])
    _, icp, _, _ = refine_pose_with_icp(reader.get_source(0), reader.target, reader.background,
                                        init, params, device=device)
    gt_mm = reader.color_to_depth @ reader.scale_translation_to_millimeters(reader.get_gt_pose(0))
    icp_pose = np.linalg.inv(icp.transformation)
    m.update(icp_fitness=icp.fitness, icp_rmse_mm=icp.inlier_rmse,
             icp_rot_err_deg=rotation_angle_deg(icp_pose[:3, :3], gt_mm[:3, :3]),
             icp_t_err_mm=float(np.linalg.norm(icp_pose[:3, 3] - gt_mm[:3, 3])),
             # parity_check's point set: the centred model points, in mm
             icp_adds_mm=adds_err(icp_pose, gt_mm, pose["centred_pts"] * 1000.0))

    posed = reader.target_mesh.copy()
    posed.transform(np.linalg.inv(icp.transformation))
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    pcd, traced = ray_tracing(reader.base_dir, posed, heatmap, reader.color_pinhole,
                              heatmap_threshold=0.75, device=device)
    gt_posed = reader.target_mesh.copy()
    gt_posed.transform(reader.scale_translation_to_millimeters(reader.get_gt_pose(0)))
    m.update(defect_pts=len(pcd),
             defect_surface_median_dist_mm=(
                 float(np.median(cKDTree(traced.vertices).query(pcd.points, k=1)[0]))
                 if len(pcd) else float("nan")),
             defect_to_annotated_mesh_median_mm=_surface_median_mm(pcd.points, gt_posed))

    with open(os.path.join(REPO, "PARITY_r5.json")) as f:
        ref = json.load(f)["scenes"]["synth_box"]
    report = {k: {"card": v, "jax_parity_r5": ref.get(k), "ceiling": ACCURACY_CEILINGS.get(k)}
              for k, v in m.items()}
    emit({"phase": "accuracy", "frames": len(per_frame), "metrics": report})
    breaches = [f"{k}={m[k]:.4g} > {c}" for k, c in ACCURACY_CEILINGS.items()
                if not m[k] <= c]  # nan breaches too
    if breaches and not small:
        raise RuntimeError(f"accuracy on synth_box above its ceilings: {breaches}")
    return m


def _capture_once(device, scene, small, plain):
    """(a): refine_pose_with_icp from the annotated pose of frame 0, the
    frame-0 ray trace, and an async capture on frame 2 seeded from the
    annotated pose of frame 2 (a device tensor), timed twice: the process's
    first capture, then a warm one."""
    import numpy as np
    import torch

    from sixdof_tpu_torch.app.defect_projection import (compute_rays, heatmap_to_points,
                                                       ray_tracing)
    from sixdof_tpu_torch.app.icp_pipeline import (CaptureContext, capture_event_async,
                                                   preprocess_source, refine_pose_with_icp)
    from sixdof_tpu_torch.io.readers import DataReader

    reader = DataReader(scene)
    params = _icp_parameters(reader.parameters, small)
    init = reader.color_to_depth @ reader.scale_translation_to_millimeters(reader.get_gt_pose(0))
    _sync(device)
    t0 = time.perf_counter()
    _, icp, z_adj, target_processed = refine_pose_with_icp(
        reader.get_source(0), reader.target, reader.background, init, params, device=device)
    _sync(device)
    icp_refine_s = time.perf_counter() - t0
    posed = reader.target_mesh.copy()
    posed.transform(np.linalg.inv(icp.transformation))
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    t0 = time.perf_counter()
    pcd0, posed_c = ray_tracing(reader.base_dir, posed, heatmap, reader.color_pinhole,
                                heatmap_threshold=0.75, device=device, plain_raytrace=plain)
    ray_tracing_ms = (time.perf_counter() - t0) * 1e3

    ctx = CaptureContext(target_processed, reader.target_mesh, reader.color_to_depth,
                         device=device, plain_raytrace=plain)
    t0 = time.perf_counter()
    src2, _, _ = preprocess_source(reader.get_source(2), reader.background, params, i=2)
    preprocess_ms = (time.perf_counter() - t0) * 1e3
    rays, inten = compute_rays(heatmap_to_points(heatmap, 0.75), reader.color_pinhole)
    pose2 = torch.as_tensor(reader.get_gt_pose(2), dtype=torch.float32, device=device)
    capture_ms = []  # the first capture of the process, then a warm one
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        pending = capture_event_async(src2, pose2, np.eye(4), params, rays,
                                      np.ones(len(rays), bool), inten, ctx)
        res2, pcd2 = pending.result()
        capture_ms.append((time.perf_counter() - t0) * 1e3)

    # distances: to the mesh the defects were traced on, and to the mesh at
    # the annotated pose (both in the colour camera, mm)
    gt_posed = reader.target_mesh.copy()
    gt_posed.transform(reader.scale_translation_to_millimeters(reader.get_gt_pose(0)))
    cap_posed = reader.target_mesh.copy()
    cap_posed.transform(np.linalg.inv(reader.color_to_depth)
                        @ np.linalg.inv(res2.transformation))
    gt2 = reader.target_mesh.copy()
    gt2.transform(reader.scale_translation_to_millimeters(reader.get_gt_pose(2)))
    return dict(
        icp_refine_s=icp_refine_s, z_adjustment_mm=z_adj, refine_fitness=icp.fitness,
        refine_rmse_mm=icp.inlier_rmse, ray_tracing_ms=ray_tracing_ms,
        defect_points=len(pcd0),
        defect_to_traced_mesh_median_mm=_surface_median_mm(pcd0.points, posed_c),
        defect_to_annotated_mesh_median_mm=_surface_median_mm(pcd0.points, gt_posed),
        preprocess_ms=preprocess_ms, capture_first_ms=capture_ms[0], capture_ms=capture_ms[1],
        capture_fitness=res2.fitness,
        capture_rmse_mm=res2.inlier_rmse, capture_defect_points=len(pcd2),
        capture_defect_to_traced_mesh_median_mm=_surface_median_mm(pcd2.points, cap_posed),
        capture_defect_to_annotated_mesh_median_mm=_surface_median_mm(pcd2.points, gt2),
        _tfs=[icp.transformation, res2.transformation], _pts=[pcd0.points, pcd2.points])


def _icp_parameters(params, small):
    """The scene's ICP parameters; cut to a tiny size for the CPU rehearsal
    (a 6 mm first-frame downsample: at 8 mm frame 0 keeps so few points that
    the JAX package's own refinement ends at fitness 0.8)."""
    if small:
        params["preprocess_target"]["max_pcd"] = 1000
        params["preprocess_source"]["down_sample"] = 6.0
        params["run_icp"].update(n_restarts=4, max_iter=5)
    return params


def _scene_icp_parameters(small):
    """Context in which every reader (recorded or live) holds the ICP
    parameters of _icp_parameters (the run loop builds its own reader)."""
    import contextlib
    from unittest import mock

    from sixdof_tpu_torch.io import readers

    if not small:
        return contextlib.nullcontext()
    update_config = readers._ReaderCommon.update_config
    return mock.patch.object(readers._ReaderCommon, "update_config",
                             lambda self, args: _icp_parameters(update_config(self, args), small))


def _loop_once(device, cfg, scene, small, refiner, scorer, plain):
    """(b): the port's run loop with async captures; returns its numbers,
    K2 launches counted over the run."""
    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.kernels import raytrace as k2

    n_frames = 3 if small else 6
    args = _loop_args(cfg, scene, small,
                      os.path.join(REPO, "build", "chip_smoke", "plain" if plain else "k2"),
                      ["--no_server", "--max_frames", str(n_frames), "--capture_every", "2",
                       "--track_pipeline", "3", "--debug", "0"])
    state = app_run.LoopState()
    with _scene_icp_parameters(small):
        _sync(device)
        k2.ray_mesh_intersect.launches = 0
        frame_times = app_run.main(args, device=device, refiner=refiner, scorer=scorer,
                                   plain_raytrace=plain, state=state)
        _sync(device)
    launches = k2.ray_mesh_intersect.launches
    return dict(frames=len(frame_times), frame_ms=[t * 1e3 for t in frame_times],
                k2_launches=launches, stages=state.stages,
                captures=[{"frame": f, "fitness": r.fitness, "rmse_mm": r.inlier_rmse}
                          for f, r in state.captures],
                defect_points=[len(p) for p in state.intersection_pcds],
                _tfs=[r.transformation for _, r in state.captures],
                _pts=[p.points for p in state.intersection_pcds])


def _same(a, b):
    """Max abs difference of two lists of arrays, inf where shapes differ."""
    import numpy as np

    err = 0.0
    for x, y in zip(a, b):
        if np.shape(x) != np.shape(y):
            return float("inf")
        if np.size(x):
            err = max(err, float(np.abs(np.asarray(x) - np.asarray(y)).max()))
    return err if len(a) == len(b) else float("inf")


def phase_capture(device, cfg, scene, small, refiner, scorer):
    """(a) and (b) through K2, then through its plain version."""
    a = _capture_once(device, scene, small, plain=False)
    b = _loop_once(device, cfg, scene, small, refiner, scorer, plain=False)
    a_plain = _capture_once(device, scene, small, plain=True)
    b_plain = _loop_once(device, cfg, scene, small, refiner, scorer, plain=True)
    vs_plain = dict(
        capture_tf_max_abs_diff=_same(a["_tfs"], a_plain["_tfs"]),
        capture_pts_max_abs_diff_mm=_same(a["_pts"], a_plain["_pts"]),
        capture_counts=[len(x) for x in a["_pts"]], plain_counts=[len(x) for x in a_plain["_pts"]],
        loop_tf_max_abs_diff=_same(b["_tfs"], b_plain["_tfs"]),
        loop_pts_max_abs_diff_mm=_same(b["_pts"], b_plain["_pts"]),
        loop_counts=b["defect_points"], loop_plain_counts=b_plain["defect_points"])
    strip = lambda d: {k: v for k, v in d.items() if not k.startswith("_")}  # noqa: E731
    emit({"phase": "capture", "a": strip(a), "b": strip(b),
          "plain_a": {k: a_plain[k] for k in ("icp_refine_s", "ray_tracing_ms", "capture_first_ms",
                                              "capture_ms")},
          "plain_b_frame_ms": b_plain["frame_ms"], "vs_plain": vs_plain})
    expect_launches = 2 if small else 3
    if min(a["refine_fitness"], a["capture_fitness"]) < CAPTURE_MIN_FITNESS:
        raise RuntimeError(f"ICP from the annotated pose did not register: {strip(a)}")
    if not (a["defect_points"] > 0 and a["capture_defect_points"] > 0
            and a["defect_to_traced_mesh_median_mm"] < 1.0
            and a["capture_defect_to_traced_mesh_median_mm"] < 1.0):
        raise RuntimeError(f"no defect points on the posed mesh: {strip(a)}")
    if device.type == "cuda" and b["k2_launches"] != expect_launches:
        raise RuntimeError(f"the run loop launched K2 {b['k2_launches']} times, "
                           f"expected {expect_launches}")
    if len(b["captures"]) != expect_launches or min(b["defect_points"]) == 0:
        raise RuntimeError(f"the run loop did not consume its captures: {strip(b)}")
    if not small and min(c["fitness"] for c in b["captures"]) < CAPTURE_MIN_FITNESS:
        raise RuntimeError(f"the run loop's captures did not register: {b['captures']}")
    if max(vs_plain["capture_tf_max_abs_diff"], vs_plain["loop_tf_max_abs_diff"]) \
            > CAPTURE_TF_ATOL or max(vs_plain["capture_pts_max_abs_diff_mm"],
                                     vs_plain["loop_pts_max_abs_diff_mm"]) > CAPTURE_PTS_ATOL:
        raise RuntimeError(f"kernel and plain-K2 captures disagree: {vs_plain}")
    return dict(loop_k2_launches=b["k2_launches"])


# the rehearsal's viewer and --debug loops skip the depth polishes, whose
# brute-force nearest neighbours take most of a CPU register
_NO_POLISH = ["--depth_polish", "0", "--track_polish", "0"]


def _loop_args(cfg, scene, small, debug_dir, extra):
    """The port's run-loop arguments for @scene and @extra; for the CPU
    rehearsal (@small) the crops' shorter side, 8 hypotheses and one
    refine iteration a frame."""
    from sixdof_tpu_torch.app import run as app_run

    argv = ["--test_scene_dir", scene, "--debug_dir", debug_dir, "--precompile", "0"] + extra
    if small:
        argv += ["--shorter_side", str(cfg.shorter_side), "--max_hypotheses", "8",
                 "--prune_to", str(cfg.prune_to), "--est_refine_iter", "1",
                 "--track_refine_iter", "1"]
    return app_run.build_parser().parse_args(argv)


def phase_debug(device, cfg, scene, small, refiner, scorer, fused):
    """The run loop at --debug 2 on frames 0-1: register through the staged
    path (K1 launches counted over the run), the drawings and overlays
    written and decodable, the staged register's pose beside the pose
    phase's fused one (@fused) on frame 0."""
    import numpy as np

    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.io.png import read_png
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer

    import shutil

    out = os.path.join(REPO, "build", "chip_smoke", "debug2")
    shutil.rmtree(out, ignore_errors=True)  # only this run's images count
    args = _loop_args(cfg, scene, small, out, ["--no_server", "--max_frames", "2",
                                               "--debug", "2"] + _NO_POLISH * small)
    state = app_run.LoopState()
    with _scene_icp_parameters(small):
        _sync(device)
        rasterize_zbuffer.launches = 0
        app_run.main(args, device=device, refiner=refiner, scorer=scorer, state=state)
        _sync(device)
    launches = rasterize_zbuffer.launches
    files = ["vis_refiner.png", os.path.join("track_vis", "0001.png")] + sorted(
        os.path.join("overlay", f) for f in os.listdir(os.path.join(out, "overlay")))
    shapes = {f: list(read_png(os.path.join(out, f)).shape) for f in files}
    staged = np.loadtxt(os.path.join(out, "ob_in_cam", "0000.txt"))
    rot = _rot_deg(staged[:3, :3], fused["poses"][0][:3, :3])
    trans = float(np.linalg.norm(staged[:3, 3] - fused["poses"][0][:3, 3]))
    res = dict(k1_launches=launches, staged_register_s=state.stages["register"]["total_s"],
               fused_register_s=fused["register_s"], vs_fused_rot_deg=rot,
               vs_fused_trans_m=trans, files=shapes, stages=state.stages)
    if not small:  # both register paths in turns on one engine each: fused, staged x2, fused
        res["register_s_in_turns"] = _register_in_turns(device, scene, refiner, scorer,
                                                        os.path.join(out, "turns"))
    emit({"phase": "debug", **res})
    if device.type == "cuda" and launches == 0:
        raise RuntimeError("the staged register did not launch raster kernel K1")
    if len(shapes) < 3 or not any(f.startswith("overlay") for f in shapes):
        raise RuntimeError(f"--debug 2 did not write its images: {shapes}")
    # the rehearsal's loop runs other crops than the pose phase: reported only
    if not small and (rot > POSE_ROT_DEG_MAX or trans > POSE_TRANS_M_MAX):
        raise RuntimeError(f"staged and fused register disagree: {rot} deg, {trans} m")
    return res


def _register_in_turns(device, scene, refiner, scorer, debug_dir):
    """Synchronised register_s of the fused cascade and of the staged path
    (debug 2) on frame 0, in turns: [(path, seconds), ...]."""
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader

    reader = DataReader(scene)
    mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    engines = {debug: FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals,
                                     mesh=mesh, scorer=scorer, refiner=refiner, device=device,
                                     prune_to=64, debug=debug, debug_dir=debug_dir)
               for debug in (0, 2)}
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    out = []
    for debug in (0, 2, 2, 0):
        _sync(device)
        t0 = time.perf_counter()
        engines[debug].register(K=reader.color_K, rgb=color, depth=depth, ob_mask=mask,
                                iteration=5)
        _sync(device)
        out.append(("staged" if debug else "fused", time.perf_counter() - t0))
    return out


def _http(address, path, method="GET"):
    """(status, body bytes) of one request to the viewer at @address."""
    import urllib.request

    req = urllib.request.Request(f"http://{address[0]}:{address[1]}{path}", method=method,
                                 data=b"" if method == "POST" else None)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def phase_viewer(device, cfg, scene, small, refiner, scorer):
    """The run loop in viewer mode on 127.0.0.1 (a free port), frames 0-3
    (0-1 in the rehearsal), no automatic captures: after frame 0's publish the page is served, the
    payload holds frame 0's defect cloud and one POST /capture is made;
    the capture it triggers must reach GET /data (a higher seq, the loop
    state's point count)."""
    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.kernels import raytrace as k2

    seen = []

    class State(app_run.LoopState):
        def update(self, pcds, mesh):
            super().update(pcds, mesh)
            data = json.loads(_http(self.viewer_address, "/data")[1])
            n = sum(len(p) for p in pcds)
            seen.append(dict(seq=data["seq"], points=sum(len(p["points"]) for p in data["pcds"]),
                             state_points=n, faces=len(data["faces"]),
                             mesh_faces=len(mesh.faces)))
            if len(seen) == 1:
                page = _http(self.viewer_address, "/")[1].decode()
                overlay = _http(self.viewer_address, "/assets/overlay.png")[1]
                seen[0].update(page_has_button="Capture New Data" in page,
                               overlay_png=overlay[:8] == b"\x89PNG\r\n\x1a\n",
                               capture_status=_http(self.viewer_address, "/capture",
                                                    "POST")[0])

    out = os.path.join(REPO, "build", "chip_smoke", "viewer")
    args = _loop_args(cfg, scene, small, out,
                      ["--max_frames", "2" if small else "4", "--debug", "0"] + _NO_POLISH * small)
    state = State()
    with _scene_icp_parameters(small):
        _sync(device)
        k2.ray_mesh_intersect.launches = 0
        app_run.main(args, device=device, refiner=refiner, scorer=scorer, state=state,
                     viewer_address=("127.0.0.1", 0))
        _sync(device)
    res = dict(updates=seen, captures=[f for f, _ in state.captures],
               k2_launches=k2.ray_mesh_intersect.launches)
    emit({"phase": "viewer", **res})
    first = seen[0] if seen else {}
    if not (first.get("page_has_button") and first.get("overlay_png")
            and first.get("capture_status") == 200):
        raise RuntimeError(f"the viewer did not serve its page, overlay or capture: {res}")
    if len(seen) < 2 or seen[-1]["seq"] <= seen[0]["seq"] or state.captures[-1][0] != 1:
        raise RuntimeError(f"POST /capture did not trigger a capture on frame 1: {res}")
    if any(u["points"] != u["state_points"] or u["faces"] != u["mesh_faces"] for u in seen):
        raise RuntimeError(f"GET /data differs from the loop state: {res}")
    return res


def phase_point_click(device, scene, small, n_time):
    """The point-click path: the crust create_mesh builds from the model's
    point cloud (mesh/model.ply), posed by the annotated pose of frame 0,
    and ray_tracing_points through K2 at seeded clicks inside the object's
    projection, against K2's plain version (t bit-equal, a hit needed);
    then heatmap_to_rays at 0.75 (on the card and on the CPU: the same
    rays) against the same crust.  K2's launches are counted over
    ray_tracing_points."""
    import numpy as np
    import torch

    from sixdof_tpu_torch.app.defect_projection import (MAX_DEFECT_RAYS, compute_rays,
                                                       create_mesh, ray_tracing_points)
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels import raytrace as k2
    from sixdof_tpu_torch.ops.raytrace import heatmap_to_rays, mesh_to_tri_verts

    reader = DataReader(scene)
    t0 = time.perf_counter()
    crust = create_mesh(reader.target, resolution=16 if small else 64)
    create_mesh_s = time.perf_counter() - t0
    in_depth = reader.color_to_depth @ reader.scale_translation_to_millimeters(
        reader.get_gt_pose(0))
    crust.transform(in_depth)  # the object's crust in the scene (depth camera, mm)
    in_color = crust.copy().transform(np.linalg.inv(reader.color_to_depth))
    Kp = reader.color_pinhole.intrinsic_matrix
    uv = in_color.vertices[:, :2] / in_color.vertices[:, 2:3] * Kp[[0, 1], [0, 1]] \
        + Kp[:2, 2]
    pix = np.unique(np.round(uv).astype(np.int64), axis=0)
    rng = np.random.RandomState(0)
    clicks = pix[rng.choice(len(pix), 8 if small else 64, replace=False)]
    color = reader.get_color(0)

    _sync(device)
    k2.ray_mesh_intersect.launches = 0
    t0 = time.perf_counter()
    pcd, _ = ray_tracing_points(scene, crust, reader.color_pinhole, color, points=clicks,
                                device=device)
    _sync(device)
    ray_tracing_points_ms = (time.perf_counter() - t0) * 1e3
    launches = k2.ray_mesh_intersect.launches
    pcd_plain, _ = ray_tracing_points(scene, crust, reader.color_pinhole, color, points=clicks,
                                      device=device, plain_raytrace=True)

    tri, tri_mask = mesh_to_tri_verts(in_color.vertices, in_color.faces)
    tris = k2.pack_tris(torch.as_tensor(tri, device=device),
                        torch.as_tensor(tri_mask, device=device))
    click_rays, _ = compute_rays([(x, y, 1.0) for x, y in clicks], reader.color_pinhole)
    heatmap = reader.get_heatmap(color)[0].astype(np.float32)
    n_rays = 64 if small else MAX_DEFECT_RAYS  # the rehearsal's plain version is slow
    dirs, inten, mask = heatmap_to_rays(torch.as_tensor(heatmap, device=device), Kp, 0.75,
                                        n_rays)
    dirs_cpu, inten_cpu, mask_cpu = heatmap_to_rays(torch.as_tensor(heatmap), Kp, 0.75, n_rays)
    rays_err = float((dirs.cpu() - dirs_cpu).abs().max())
    same_rays = bool(torch.equal(mask.cpu(), mask_cpu) and torch.equal(inten.cpu(), inten_cpu)
                     and rays_err <= 1e-6)
    results = []
    for name, d, m in (("clicks", torch.as_tensor(click_rays, dtype=torch.float32,
                                                   device=device),
                        torch.ones(len(click_rays), dtype=torch.bool, device=device)),
                       ("heatmap", dirs, mask)):
        o = torch.zeros_like(d)
        tk = k2.ray_mesh_intersect(o, d, m, tris)
        tp = k2.ray_mesh_intersect_plain(o, d, m, tris)
        _sync(device)
        for _ in range(2):
            k2.ray_mesh_intersect(o, d, m, tris)
        ms = _timed(lambda: k2.ray_mesh_intersect(o, d, m, tris), device, n_time)
        device_us = (_device_us(lambda: k2.ray_mesh_intersect(o, d, m, tris), n_time,
                                "ray_mesh_kernel") if device.type == "cuda" else None)
        plain_ms = _timed(lambda: k2.ray_mesh_intersect_plain(o, d, m, tris), device, 1)
        N, T = len(d), len(tri_mask)
        cone = _cone_pairs(o, d, m, tris, 64)
        bytes_moved = N * (12 + 12 + 1) + T * 36 + N * 4
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = cone * k2.FLOPS_PER_PAIR / FP32_FLOPS * 1e3
        res = dict(shape=name, rays=N, valid_rays=int(m.sum()), triangles=T,
                   rays_per_block=k2.THREADS >> k2.threads_per_ray_log2(N), cone_pairs=cone,
                   hits=int(torch.isfinite(tk).sum()), bit_equal=bool(torch.equal(tk, tp)),
                   ms=ms, device_us=device_us, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   bytes_bound_ms=t_bytes)
        if name == "clicks":
            res.update(launches=launches, create_mesh_s=create_mesh_s,
                       ray_tracing_points_ms=ray_tracing_points_ms, defect_points=len(pcd),
                       plain_defect_points=len(pcd_plain),
                       points_bit_equal=bool(np.array_equal(pcd.points, pcd_plain.points)))
        else:
            res.update(same_rays_as_cpu=same_rays, rays_max_abs_diff=rays_err)
        emit({"phase": "point_click", **res})
        if not res["bit_equal"] or res["hits"] == 0:
            raise RuntimeError(f"K2 disagrees with its plain version on the crust: {res}")
        results.append(res)
    if device.type == "cuda" and launches == 0:
        raise RuntimeError("ray_tracing_points did not launch K2")
    if not (results[0]["points_bit_equal"] and len(pcd) > 0) or not same_rays:
        raise RuntimeError(f"the point-click path disagrees with its plain run: {results}")
    return results


def phase_icp_global(device, scene, small):
    """determine_pose(icp=True) on the demo inputs, on the card and on the
    CPU: the same RANSAC trials (host numpy) and the same end (on synth_box
    no trial passes the checkers, as in the JAX package); seconds in FPFH,
    RANSAC and ICP.  Then determine_pose(icp=False) from the annotated pose
    must register."""
    import contextlib
    from unittest import mock

    import torch

    from sixdof_tpu_torch.app import icp_pipeline as ip
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.ops import features

    def run(dev, icp, initial=None):
        target, source, background, init, params = ip.demo_data(scene)
        params = _icp_parameters(params, small)
        if small:
            params["execute_global_registration"]["ransac_criteria"]["iterations"] = 2000
        seconds = {"fpfh": 0.0, "ransac": 0.0, "icp": 0.0}
        trials = []

        def timed(key, fn, record=None):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                _sync(dev)
                seconds[key] += time.perf_counter() - t0
                if record is not None:
                    record.append(out.valid_trials)
                return out
            return wrapper

        with contextlib.ExitStack() as stack:
            for obj, name, key, rec in ((features, "compute_fpfh", "fpfh", None),
                                        (features, "execute_global_registration", "ransac",
                                         trials),
                                        (ip, "refine_registration", "icp", None),
                                        (ip, "improve_result", "icp", None)):
                stack.enter_context(mock.patch.object(obj, name,
                                                      timed(key, getattr(obj, name), rec)))
            t0 = time.perf_counter()
            _, res, _, _ = ip.determine_pose(source, target, background,
                                             init if initial is None else initial, params,
                                             icp=icp, device=dev)
            _sync(dev)
        return dict(fitness=res.fitness, rmse=res.inlier_rmse, valid_trials=trials,
                    seconds=dict(seconds, total=time.perf_counter() - t0))

    card = run(device, True)
    cpu = run(torch.device("cpu"), True) if device.type == "cuda" else card
    reader = DataReader(scene)
    local = run(device, False, initial=reader.color_to_depth
                @ reader.scale_translation_to_millimeters(reader.get_gt_pose(0)))
    res = dict(icp=card, icp_cpu=cpu, from_annotated=local)
    emit({"phase": "icp_global", **res})
    if card["valid_trials"] != cpu["valid_trials"] or abs(card["fitness"] - cpu["fitness"]) \
            > ICP_GLOBAL_FITNESS_ATOL:
        raise RuntimeError(f"--icp on the card ends unlike the CPU run: {res}")
    if not small and local["fitness"] < CAPTURE_MIN_FITNESS:
        raise RuntimeError(f"determine_pose from the annotated pose did not register: {res}")
    return res


# the trainer: JAX's fixed-batch overfit setting (tests/test_parallel.py:56-103):
# an 8-vertex box, K, diameter 0.1, batch 8 at 48x48, gradients clipped to
# norm 1 then Adam 3e-4, 40 steps; the loss must end below 0.8x its first
OVERFIT_BOX_V = [[-0.04, -0.03, -0.02], [0.04, -0.03, -0.02], [0.04, 0.03, -0.02],
                 [-0.04, 0.03, -0.02], [-0.04, -0.03, 0.02], [0.04, -0.03, 0.02],
                 [0.04, 0.03, 0.02], [-0.04, 0.03, 0.02]]
OVERFIT_BOX_F = [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                 [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]]
OVERFIT_K = [[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]]
OVERFIT_RATIO = 0.8


def _profiled(fn, device, top=0, trace=None):
    """Wall ms of @fn, and where the profiler sees the card: its busy ms
    (the kernels' device time) and the kernel launches; with @top, the @top
    kernels that take the most device time, each with its count; with
    @trace, the Chrome trace written to that path."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return dict(wall_ms=(time.perf_counter() - t0) * 1e3, busy_ms=None, launches=None)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)

    def device_us(e):
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an optimizer's user-annotation range is reported on the
    # device too, spanning its own kernels
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=device_us, reverse=True)
    out = dict(wall_ms=wall * 1e3, busy_ms=sum(map(device_us, kernels)) / 1e3,
               launches=sum(int(e.count) for e in kernels))
    if top:
        out["top"] = [{"kernel": e.key[:90], "ms": device_us(e) / 1e3, "count": int(e.count)}
                      for e in kernels[:top]]
    return out


def _step_times(trainers, n, gen, device):
    """@n round-robin steps of @trainers, each split into batch generation
    and forward/backward/update (CUDA events on the card); ms lists."""
    import torch

    marks = []
    for i in range(n):
        t = trainers[i % len(trainers)]
        if device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            batch = t.batch(gen)
            ev[1].record()
            t.update(batch)
            ev[2].record()
            marks.append(ev)
        else:
            t0 = time.perf_counter()
            batch = t.batch(gen)
            t1 = time.perf_counter()
            t.update(batch)
            marks.append((t0, t1, time.perf_counter()))
    _sync(device)
    if device.type == "cuda":
        return ([a.elapsed_time(b) for a, b, _ in marks],
                [b.elapsed_time(c) for _, b, c in marks])
    return ([(b - a) * 1e3 for a, b, _ in marks], [(c - b) * 1e3 for _, b, c in marks])


def phase_train(device, cfg, scene, small):
    """The trainer (parallel/train.py) on the card: (1) its batches through
    K1 against the same draws through the plain raster (bit-equal), K1
    timed at the trainer's shapes; (2) a textured box written and read back
    (uv and texture equal), rendered through K1 and the plain raster
    (bit-equal), one refiner step on it; (3) the fixed-batch overfit at
    JAX's test setting (gated) and at the trainer's (reported), then 10
    refiner and 5 scorer steps round-robin over synth_box and a procedural
    object (the K1 launches counted, each step split into batch generation
    and update, the card's busy share, launches and peak memory); (4) the
    bundled weights' first losses beside a from-scratch model's; (5) the
    trained nets written, loaded by the predictors (outputs bit-equal) and
    registering frame 0."""
    import tempfile

    import numpy as np
    import torch

    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import TriMesh, load_mesh, load_obj, save_obj
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer
    from sixdof_tpu_torch.models.networks import RefineNet, ScoreNetMultiPair, init_flax_style
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor
    from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch, compute_mesh_diameter
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays, render_batch
    from sixdof_tpu_torch.parallel import train as tr
    from sixdof_tpu_torch.parallel.procgen import procedural_objects

    reader = DataReader(scene)
    K_np = np.asarray(reader.color_K, dtype=np.float64)
    K = torch.as_tensor(K_np, dtype=torch.float32, device=device)
    mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    mesh.vertices = mesh.vertices - (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    box = (make_mesh_arrays(mesh, device), K_np, compute_mesh_diameter(mesh.vertices))
    # (the rehearsal takes the 80-triangle sphere: the plain raster is slow)
    proc = procedural_objects(1, K_np, device, subdivisions=1 if small else 4)[0]
    objects = (("synth_box", box), ("procedural", proc))
    # the trainer's configuration (tools/train_torch_networks.py)
    rcfg = tr.TrainConfig(batch_size=2 if small else 32,
                          input_hw=(32, 32) if small else (160, 160), p_occlusion=0.5,
                          p_sensor=0.5)
    scfg = rcfg._replace(n_hypotheses=2 if small else 12, lr=3e-4)
    n_steps = 3 if small else None
    res = {}

    # (1) batches through K1 against the plain raster, on the same draws
    same, cases = {}, []
    for label, (arrays, _, diam) in objects:
        for net, draw, make, c in (("refiner", tr.refiner_draws, tr.make_refiner_batch, rcfg),
                                   ("scorer", tr.scorer_draws, tr.make_scorer_batch, scfg)):
            draws = draw(torch.Generator(device).manual_seed(7), c)
            kern = make(draws, arrays, K, diam, c)
            ref = make(draws, arrays, K, diam, c, plain_raster=True)
            same[f"{net}_{label}"] = all(torch.equal(a, b) for a, b in zip(kern, ref))
            if label == "synth_box":
                if net == "refiner":
                    poses = tr._perturb(draws["perturb"], tr._random_poses(draws["poses"]))[0]
                else:
                    poses = tr.scorer_hypotheses(draws, diam, c.n_hypotheses)[1]
                cases.append((f"train_{net}", arrays, poses, *c.input_hw))
    res["batches_bit_equal"] = same
    if not all(same.values()):
        raise RuntimeError(f"trainer batches through K1 disagree with the plain raster: {same}")
    k1 = phase_k1(device, cases, K, box[2], n_time=2 if small else 50, phase="train_k1",
                  cull=False)

    # (2) a textured mesh: written, read back, rendered, one refiner step
    rng = np.random.RandomState(3)
    textured = TriMesh(mesh.vertices, mesh.faces, uv=rng.rand(len(mesh.vertices), 2),
                       texture=rng.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    with tempfile.TemporaryDirectory() as tmp:
        save_obj(os.path.join(tmp, "box.obj"), textured)
        back = load_obj(os.path.join(tmp, "box.obj"))
    tex_ok = np.array_equal(back.uv, textured.uv) and np.array_equal(back.texture,
                                                                     textured.texture)
    tarr = make_mesh_arrays(back, device)
    hw = (32, 32) if small else (160, 160)
    tposes = tr._random_poses(tr._pose_draws(torch.Generator(device).manual_seed(5),
                                             4 if small else 64, rcfg.z_range))
    tfs = compute_crop_window_tf_batch(tposes, K, 1.2, (hw[1], hw[0]), box[2])
    rk = render_batch(tarr, tposes, K, tfs, out_hw=hw)
    rp = render_batch(tarr, tposes, K, tfs, out_hw=hw, plain_raster=True)
    tex_render_equal = all(torch.equal(rk[k], rp[k]) for k in rk)
    tex_trainer = tr.RefinerTrainer(RefineNet(), tarr, K_np, box[2], rcfg, seed=0)
    tex_loss = float(tex_trainer.step(torch.Generator(device).manual_seed(11)))
    res["textured"] = dict(uv_texture_equal=bool(tex_ok), render_bit_equal=tex_render_equal,
                           covered=float(rk["alpha"].mean()), refiner_step_loss=tex_loss)
    if not (tex_ok and tex_render_equal and np.isfinite(tex_loss)):
        raise RuntimeError(f"textured mesh check failed: {res['textured']}")

    # (3a) the fixed-batch overfit at JAX's test setting, then at the trainer's
    overfit = {}
    obox = make_mesh_arrays(TriMesh(np.array(OVERFIT_BOX_V), np.array(OVERFIT_BOX_F)), device)
    oK = torch.tensor(OVERFIT_K, dtype=torch.float32, device=device)
    for label, c, lr, clip in (("jax_test_setting", tr.TrainConfig(batch_size=8,
                                                                   input_hw=(48, 48)), 3e-4, 1.0),
                               ("trainer_setting", rcfg, rcfg.lr, None)):
        draws = tr.refiner_draws(torch.Generator(device).manual_seed(0), c)
        batch = tr.make_refiner_batch(draws, obox, oK, 0.1, c)
        model = init_flax_style(RefineNet(), torch.Generator().manual_seed(0)).to(device)
        _sync(device)
        t0 = time.perf_counter()
        losses = tr.overfit_fixed_batch(model, batch, n_steps or 40, lr, c, clip)
        overfit[label] = dict(batch=c.batch_size, hw=list(c.input_hw), lr=lr, clip=clip,
                              first=losses[0], last=losses[-1], ratio=losses[-1] / losses[0],
                              s=time.perf_counter() - t0)
    res["overfit"] = overfit
    emit({"phase": "train", "part": "batches", **res})
    if not small and overfit["jax_test_setting"]["ratio"] >= OVERFIT_RATIO:
        raise RuntimeError(f"the refiner did not overfit a fixed batch: {overfit}")

    # (3b) round-robin training from scratch, fresh batches: the main path
    rts = [tr.RefinerTrainer(RefineNet(), *box, rcfg, seed=0)]
    rts.append(rts[0].sharing(*proc))
    sts = [tr.ScorerTrainer(ScoreNetMultiPair(), *box, scfg, seed=1)]
    sts.append(sts[0].sharing(*proc))
    gen = torch.Generator(device).manual_seed(0)
    if device.type == "cuda":  # first-call set-up stays out of the timings
        rts[0].step(gen)
        sts[0].step(gen)
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    rasterize_zbuffer.launches = 0
    steps = {}
    for net, trainers, n in (("refiner", rts, n_steps or 10), ("scorer", sts, n_steps or 5)):
        before = rasterize_zbuffer.launches
        t0 = time.perf_counter()
        gen_ms, upd_ms = _step_times(trainers, n, gen, device)
        wall = time.perf_counter() - t0
        steps[net] = dict(steps=n, s_per_step=wall / n, batch_ms=gen_ms, update_ms=upd_ms,
                          batch_share=sum(gen_ms) / (sum(gen_ms) + sum(upd_ms)),
                          k1_launches=rasterize_zbuffer.launches - before)
    train_launches = rasterize_zbuffer.launches
    for net, trainers in (("refiner", rts), ("scorer", sts)):
        # whole steps, then batch generation alone (synchronised at its end)
        for key, fn in (("step", lambda: [t.step(gen) for t in trainers]),
                        ("batch", lambda: [t.batch(gen) for t in trainers])):
            prof = _profiled(fn, device)
            n = len(trainers)
            steps[net][key + "_profile"] = dict(
                calls=n, wall_ms=prof["wall_ms"] / n,
                busy_ms=None if prof["busy_ms"] is None else prof["busy_ms"] / n,
                busy_share=(None if prof["busy_ms"] is None
                            else prof["busy_ms"] / prof["wall_ms"]),
                launches=None if prof["launches"] is None else prof["launches"] / n)
    res = dict(steps=steps, k1_launches=train_launches,
               max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None))
    if device.type == "cuda" and train_launches != 2 * (steps["refiner"]["steps"]
                                                        + steps["scorer"]["steps"]):
        raise RuntimeError(f"the trainer's renders did not launch K1 twice a step: {res}")

    # (4) fine-tuning: the bundled weights' first losses beside from scratch
    first = {}
    for net, cls, model_cls, c, seed in (("refiner", tr.RefinerTrainer, RefineNet, rcfg, 0),
                                         ("scorer", tr.ScorerTrainer, ScoreNetMultiPair, scfg, 1)):
        bundled = cls(model_cls(), *box, c, params=tr.load_init_params(WEIGHTS, net))
        scratch = cls(model_cls(), *box, c, seed=seed)
        batch = bundled.batch(torch.Generator(device).manual_seed(21))
        with torch.no_grad():
            first[net] = dict(bundled=float(bundled.loss(*batch)),
                              from_scratch=float(scratch.loss(*batch)))
    res["first_loss"] = first
    # (at the rehearsal's 32x32 crops the bundled nets are outside what they
    # were trained on: reported, not held)
    if not small and first["refiner"]["bundled"] >= first["refiner"]["from_scratch"]:
        raise RuntimeError(f"the bundled refiner does not start below a fresh one: {first}")

    # (5) checkpoint round trip into the predictors, then register frame 0
    with tempfile.TemporaryDirectory() as tmp:
        tr.save_params(tmp, "refiner", rts[0].model)
        tr.save_params(tmp, "scorer", sts[0].model)
        preds = (PoseRefinePredictor(device, ckpt_dir=tmp, compute_dtype=torch.float32),
                 ScorePredictor(device, ckpt_dir=tmp, compute_dtype=torch.float32))
        batch = rts[0].batch(torch.Generator(device).manual_seed(31))
        sbatch = sts[0].batch(torch.Generator(device).manual_seed(31))
        with torch.no_grad():
            r_out = (rts[0].model(*batch[:2]), preds[0].model(*batch[:2]))
            s_out = (sts[0].model(*sbatch[:2], L=scfg.n_hypotheses),
                     preds[1].model(*sbatch[:2], L=scfg.n_hypotheses))
        round_trip = all(torch.equal(a[k], b[k]) for a, b in (r_out, s_out) for k in a)
        refiner = PoseRefinePredictor(device, cfg={"input_resize": cfg.input_resize},
                                      ckpt_dir=tmp)
        scorer = ScorePredictor(device, cfg={"input_resize": cfg.input_resize}, ckpt_dir=tmp)
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals,
                         mesh=load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj")),
                         scorer=scorer, refiner=refiner, device=device, prune_to=cfg.prune_to,
                         coarse_hw=cfg.coarse_hw, depth_polish=not small)
    if small:
        est.rot_grid = est.rot_grid[:: len(est.rot_grid) // 8][:8]
    frames = DataReader(scene, shorter_side=cfg.shorter_side)  # as phase pose reads them
    color, depth = frames.get_color(0), frames.get_depth(0)
    pose = est.register(K=frames.color_K, rgb=color, depth=depth,
                        ob_mask=frames.get_mask(color, 0).astype(bool),
                        iteration=cfg.est_refine_iter)
    res["checkpoint"] = dict(outputs_bit_equal=round_trip,
                             register_pose_finite=bool(np.isfinite(pose).all()))
    emit({"phase": "train", "part": "training", **res})
    if not (round_trip and res["checkpoint"]["register_pose_finite"]):
        raise RuntimeError(f"checkpoint round trip failed: {res['checkpoint']}")
    # the trained nets: phase evaluate's candidate
    return dict(k1=k1, launches=train_launches, models=(rts[0].model, sts[0].model))


# the BOP campaign's ceilings: tools/parity_check.py's THRESHOLDS of the two
# metrics a BOP run reports, per scene (about 2x the JAX package's
# PARITY_r5.json values)
BOP_CEILINGS = {"synth_box": {"adds_mean_m": 0.005, "rot_err_deg_mean": 6.0},
                "synth_box_sensor": {"adds_mean_m": 0.006, "rot_err_deg_mean": 6.0},
                "synth_clutter": {"adds_mean_m": 0.006, "rot_err_deg_mean": 6.0},
                "synth_clutter_sensor": {"adds_mean_m": 0.006, "rot_err_deg_mean": 7.0},
                "synth_occl": {"adds_mean_m": 0.008, "rot_err_deg_mean": 15.0}}
BOP_SCENES = list(BOP_CEILINGS)  # the five 6-frame demo scenes


def _small_engine(small):
    """Context in which every port FoundationPose renders 16x16 coarse crops
    (the CPU rehearsal of tools that build their own engine)."""
    import contextlib
    import functools
    from unittest import mock

    import sixdof_tpu_torch.estimater as estimater

    if not small:
        return contextlib.nullcontext()
    return mock.patch.object(estimater, "FoundationPose",
                             functools.partial(estimater.FoundationPose, coarse_hw=(16, 16)))


JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")


def _digest(img):
    import hashlib

    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def _median_ms(fn, n):
    import numpy as np

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_jpeg(small):
    """The JPEG decoder (io/jpeg.py, csrc/jpeg_decode.c) on this host: every
    fixture of tests/data/jpeg decoded by read_jpeg_color and read_jpeg_rgb,
    each digest equal to the manifest's (cv2.imread's and PIL's convert's
    on the machine that wrote them); synth_box frame 0 (640x480) decoded
    50 times as JPEG and as PNG (median ms each); and an OBJ written here
    whose map_Kd is the JPEG texture loaded, its texture's digest equal to
    the manifest's."""
    import glob
    import shutil

    from sixdof_tpu_torch.io.jpeg import read_jpeg_color, read_jpeg_rgb
    from sixdof_tpu_torch.io.mesh_io import load_obj
    from sixdof_tpu_torch.io.png import read_png_color

    with open(os.path.join(JPEG_FIXTURES, "MANIFEST.json")) as f:
        manifest = json.load(f)
    files, wrong = {}, []
    for rel, entry in sorted(manifest["files"].items()):
        path = os.path.join(JPEG_FIXTURES, rel)
        got = {"cv2": _digest(read_jpeg_color(path)), "pil": _digest(read_jpeg_rgb(path))}
        files[rel] = {k: got[k] == entry[k] for k in got}
        wrong += [f"{rel} ({k})" for k, same in files[rel].items() if not same]
    n = 3 if small else 50
    jpg = os.path.join(JPEG_FIXTURES, "rgb", "000000.jpg")
    png = sorted(glob.glob(os.path.join(REPO, "demo_data", "synth_box", "rgb", "*.png")))[0]
    frame = dict(shape=list(read_jpeg_color(jpg).shape), jpeg_bytes=os.path.getsize(jpg),
                 png_bytes=os.path.getsize(png),
                 jpeg_ms=_median_ms(lambda: read_jpeg_color(jpg), n),
                 png_ms=_median_ms(lambda: read_png_color(png), n), calls=n)
    out = os.path.join(REPO, "build", "chip_smoke", "jpeg")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    shutil.copy(os.path.join(JPEG_FIXTURES, "texture.jpg"), out)
    with open(os.path.join(out, "quad.mtl"), "w") as f:
        f.write("newmtl material_0\nmap_Kd texture.jpg\n")
    with open(os.path.join(out, "quad.obj"), "w") as f:
        f.write("mtllib quad.mtl\nusemtl material_0\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    mesh = load_obj(os.path.join(out, "quad.obj"))
    texture_equal = mesh.texture is not None and \
        _digest(mesh.texture) == manifest["files"]["texture.jpg"]["pil"]
    res = dict(fixtures=len(files), files=files, frame=frame, texture_equal=texture_equal,
               written_by={"cv2": manifest["cv2"], "pillow": manifest["pillow"]})
    emit({"phase": "jpeg", **res})
    if wrong or not texture_equal:
        raise RuntimeError(f"the JPEG decoder disagrees with the manifest: {wrong}, texture "
                           f"{'equal' if texture_equal else 'differs'}")
    return res


def _jpeg_scene(bop_scene):
    """The converted synth_box with rgb/ holding the fixtures' JPEG frames
    (cv2 quality 95, 4:2:0) in place of its PNGs."""
    import glob
    import shutil

    for png in glob.glob(os.path.join(bop_scene, "rgb", "*.png")):
        os.remove(png)
    for jpg in sorted(glob.glob(os.path.join(JPEG_FIXTURES, "rgb", "*.jpg"))):
        shutil.copy(jpg, os.path.join(bop_scene, "rgb"))


def phase_bop(device, small, refiner, scorer):
    """The BOP path: each 6-frame demo scene converted by
    tools/convert_scene_to_bop_torch.py, then tools/run_bop_torch.py's main
    at full width (252 hypotheses, 96x96 coarse, 160x160 refine and score,
    register 5 / track 2 iterations, the bundled networks), on the full grid
    for every iteration (prune_to 0, tools/parity_check.py's setting, for
    which the ceilings were set) and at the tool's default prune_to 64; one
    more scene, synth_box with its model subdivided to 20,480 triangles,
    which the tool decimates to 5000; and synth_box_jpeg, synth_box with its
    frames swapped for the JPEG fixtures (read through io/jpeg.py), beside
    the JAX package's numbers on the same scene (tests/data/jpeg's
    manifest) and the PNG scene's frame-0 pose.  ADD-S is held to each
    scene's ceiling at both settings, the rotation error on the full grid (pruned
    to 64 after two coarse iterations, the cascade keeps the 180-degree
    flip of the symmetric clutter object on synth_clutter and its sensor
    twin, as the JAX package does, and on synth_occl the prune cuts where
    neighbouring coarse scores lie closer together than bf16 rounding moves
    them, so rounding decides which hypotheses survive and whether tracking
    recovers from frame 0's pose, in the JAX package as in the port:
    tools/bf16_prune_sensitivity.py; tools/bop_jax_reference.py gives the
    JAX package's numbers); K1 launches, seconds and frame 0's pose a run
    (tools/bf16_prune_sensitivity.py --frame0_from replays the JAX package's
    campaign from it)."""
    import shutil

    import numpy as np

    from sixdof_tpu_torch.io.mesh_io import load_mesh, save_mesh
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_scene_to_bop_torch
    import run_bop_torch

    root = os.path.join(REPO, "build", "chip_smoke", "bop")
    shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(REPO, "PARITY_r5.json")) as f:
        parity = json.load(f)["scenes"]
    runs = [(s, s) for s in (["synth_box"] if small else BOP_SCENES)]
    runs += [("synth_box_20480", "synth_box"), ("synth_box_jpeg", "synth_box")]
    kw = dict(frames=2, max_hypotheses=8, shorter_side=120) if small else {}
    with open(os.path.join(JPEG_FIXTURES, "MANIFEST.json")) as f:
        jax_jpeg = json.load(f).get("jax_bop", {})
    results, launches, breaches, frame0 = [], 0, [], {}
    for name, scene in runs:
        bop_scene = convert_scene_to_bop_torch.main(os.path.join(REPO, "demo_data", scene),
                                                    os.path.join(root, name), obj_id=1)
        if name.endswith("jpeg"):
            _jpeg_scene(bop_scene)
        triangles = None
        if name.endswith("20480"):
            model = os.path.join(root, name, "models", "obj_000001.ply")
            fine = _subdivide(_subdivide(load_mesh(model)))
            save_mesh(model, fine)
            triangles = len(fine.faces)
        for prune_to in (0, 4 if small else 64):
            poses = []
            with _small_engine(small):
                _sync(device)
                rasterize_zbuffer.launches = 0
                t0 = time.perf_counter()
                out = run_bop_torch.main(bop_scene, device=device, refiner=refiner,
                                         scorer=scorer, prune_to=prune_to, poses=poses, **kw)
                _sync(device)
                seconds = time.perf_counter() - t0
            k1 = rasterize_zbuffer.launches
            launches += k1
            ref = parity[scene]
            gated = BOP_CEILINGS[scene] if prune_to == 0 else \
                {"adds_mean_m": BOP_CEILINGS[scene]["adds_mean_m"]}
            res = dict(name=name, prune_to=prune_to, seconds=seconds, k1_launches=k1,
                       model_triangles=triangles, **out,
                       jax_parity_r5={k: ref[k] for k in ("adds_mean_m", "add_mean_m",
                                                          "adds_auc_0.1d", "rot_err_deg_mean",
                                                          "t_err_m_mean")},
                       ceilings=gated, frame0_pose=poses[0].tolist() if poses else None)
            frame0[name, prune_to] = poses[0] if poses else np.full((4, 4), np.nan)
            if name.endswith("jpeg"):
                png_pose = frame0[scene, prune_to]
                res.update(jax_jpeg_scene=jax_jpeg.get(str(prune_to)),
                           png_frame0_pose=png_pose.tolist(),
                           vs_png_frame0_rot_deg=_rot_deg(poses[0][:3, :3], png_pose[:3, :3]),
                           vs_png_frame0_trans_m=float(np.linalg.norm(poses[0][:3, 3]
                                                                      - png_pose[:3, 3])))
            emit({"phase": "bop", **res})
            results.append(res)
            breaches += [f"{name} (prune_to {prune_to}): {k}={out[k]:.4g} > {c}"
                         for k, c in gated.items() if not 0 <= out[k] <= c]
            if device.type == "cuda" and k1 == 0:
                raise RuntimeError(f"the BOP campaign on {name} did not launch raster kernel K1")
            if out["frames"] != (2 if small else 6) or out["registered_frames"] != 1:
                raise RuntimeError(f"the BOP campaign on {name} did not run every frame: {out}")
    if breaches and not small:
        raise RuntimeError(f"the BOP campaign above its ceilings: {breaches}")
    return dict(launches=launches, results=results)


def scene_kinect(scene, schedule):
    """A stand-in `pykinect_azure` module whose device
    (tests/torch_kinect_fake.py's ScheduledDevice) serves @scene as an Azure
    Kinect would: colour resized to 1280x720 BGRA, depth to 320x288 (uint16
    mm), the frame's point cloud (depth camera, mm), and colour intrinsics
    the scene's K scaled by (2, 1.5) (depth's by (0.5, 0.6)), the cameras
    coinciding.  Each `update()` serves the next entry of @schedule (a
    frame index, or "background" for background/box.ply's cloud with frame
    0's images).  Returns (module, device)."""
    import numpy as np

    from sixdof_tpu_torch.io.mesh_io import load_point_cloud
    from sixdof_tpu_torch.io.png import read_png
    from sixdof_tpu_torch.io.readers import resize_nearest

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_kinect_fake

    with open(os.path.join(scene, "configs", "camera_intrinsics.json")) as f:
        intr = json.load(f)

    def frame(entry):
        i = 0 if entry == "background" else entry
        bgr = read_png(os.path.join(scene, "rgb", f"rgb_{i:04d}.png"))
        bgra = np.concatenate([bgr, np.full(bgr.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        depth = read_png(os.path.join(scene, "depth", f"depth_{i:04d}.png"))
        cloud = os.path.join(scene, "background", "box.ply") if entry == "background" else \
            os.path.join(scene, "pcd", f"cloud_{i:04d}.ply")
        return (resize_nearest(bgra, 1280, 720), resize_nearest(depth, 320, 288),
                load_point_cloud(cloud).points)

    def params(cam, sx, sy):
        return cam["fx"] * sx, cam["fy"] * sy, cam["cx"] * sx, cam["cy"] * sy

    calibration = torch_kinect_fake.Calibration(params(intr["color"], 2.0, 1.5),
                                                params(intr["depth"], 0.5, 0.6), (0.0, 0.0, 0.0))
    device = torch_kinect_fake.ScheduledDevice(frame, schedule, calibration)
    return torch_kinect_fake.shim_module(device), device


# the loop's camera polls: the empty scene for --capture_background, one
# poll before the first frame (the heatmap's), then a frame a poll
LIVE_SCHEDULE = ["background", 0, 0, 1, 2, 3, 4, 5]


def live_scene_dir(scene, out):
    """A live run's scene directory: @scene's configs, mesh, heatmap and mask,
    no background (the live reader captures it)."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    for sub in ("configs", "mesh", "heatmap", "masks"):
        shutil.copytree(os.path.join(scene, sub), os.path.join(out, sub))
    return out


def _live_once(device, cfg, scene, small, refiner, scorer, plain):
    """The port's loop at --no-demo --capture_background true against
    scene_kinect(@scene); K1 and K2 launches counted over the run."""
    import functools
    from unittest import mock

    import numpy as np

    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.kernels import raytrace as k2
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer

    out = os.path.join(REPO, "build", "chip_smoke", "live_plain" if plain else "live")
    base = live_scene_dir(scene, os.path.join(out, "scene"))
    n_frames = 3 if small else 6
    args = _loop_args(cfg, base, small, os.path.join(out, "debug"),
                      ["--no-demo", "--capture_background", "true", "--no_server",
                       "--max_frames", str(n_frames), "--capture_every", "2",
                       "--track_pipeline", "3", "--debug", "0"])
    mod, cam = scene_kinect(scene, LIVE_SCHEDULE)
    state = app_run.LoopState()
    engine = functools.partial(app_run.FoundationPose, plain_raster=plain)
    with mock.patch.dict(sys.modules, {"pykinect_azure": mod}), \
            mock.patch.object(time, "sleep", lambda s: None), \
            mock.patch.object(app_run, "FoundationPose", engine), _scene_icp_parameters(small):
        _sync(device)
        rasterize_zbuffer.launches = k2.ray_mesh_intersect.launches = 0
        frame_times = app_run.main(args, device=device, refiner=refiner, scorer=scorer,
                                   plain_raytrace=plain, state=state)
        _sync(device)
    poses = [np.loadtxt(os.path.join(out, "debug", "ob_in_cam", f"{i:04d}.txt"))
             for i in range(n_frames)]
    return dict(frames=len(frame_times), frame_ms=[t * 1e3 for t in frame_times],
                k1_launches=rasterize_zbuffer.launches,
                k2_launches=k2.ray_mesh_intersect.launches, stages=state.stages,
                served=cam.served, camera_stopped=cam.stopped and cam.closed,
                background_saved=os.path.exists(os.path.join(base, "background", "box.ply")),
                captures=[{"frame": f, "fitness": r.fitness} for f, r in state.captures],
                _poses=poses, _tfs=[r.transformation for _, r in state.captures],
                _pts=[p.points for p in state.intersection_pcds])


def phase_live(device, cfg, scene, small, refiner, scorer):
    """The live-camera path: the loop against a stand-in Kinect serving
    @scene, through K1 and K2, then through their plain versions; poses to
    the pose phase's limits, captures identical; ADD-S against the
    annotated poses reported."""
    import numpy as np

    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.metrics import adds_err

    kern = _live_once(device, cfg, scene, small, refiner, scorer, plain=False)
    plain = _live_once(device, cfg, scene, small, refiner, scorer, plain=True)
    rot = [_rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(kern["_poses"], plain["_poses"])]
    trans = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
             for a, b in zip(kern["_poses"], plain["_poses"])]
    model = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj")).vertices
    gts = [np.loadtxt(os.path.join(scene, "annotated_poses", f"{i:04d}.txt"))
           for i in range(len(kern["_poses"]))]
    res = {k: v for k, v in kern.items() if not k.startswith("_")}
    res.update(adds_m=[adds_err(p, g, model) for p, g in zip(kern["_poses"], gts)],
               plain_frame_ms=plain["frame_ms"], vs_plain_rot_deg=rot, vs_plain_trans_m=trans,
               capture_tf_max_abs_diff=_same(kern["_tfs"], plain["_tfs"]),
               capture_pts_max_abs_diff_mm=_same(kern["_pts"], plain["_pts"]),
               defect_points=[len(p) for p in kern["_pts"]])
    emit({"phase": "live", **res})
    n_captures = 2 if small else 3  # frame 0's ICP and a capture every 2 frames
    if device.type == "cuda" and (kern["k1_launches"] == 0 or kern["k2_launches"] == 0):
        raise RuntimeError(f"the live loop launched K1 {kern['k1_launches']} and K2 "
                           f"{kern['k2_launches']} times")
    if not (res["background_saved"] and res["camera_stopped"]
            and len(res["captures"]) == n_captures and min(res["defect_points"]) > 0):
        raise RuntimeError(f"the live loop did not capture, save or stop: {res}")
    if max(rot) > POSE_ROT_DEG_MAX or max(trans) > POSE_TRANS_M_MAX \
            or res["capture_tf_max_abs_diff"] > CAPTURE_TF_ATOL \
            or res["capture_pts_max_abs_diff_mm"] > CAPTURE_PTS_ATOL:
        raise RuntimeError(f"the live loop through the kernels and the plain versions "
                           f"disagree: rot {rot} deg, trans {trans} m, {res}")
    return dict(k1_launches=kern["k1_launches"], k2_launches=kern["k2_launches"])

FIELD_SCENE = os.path.join(REPO, "demo_data", "synth_box_recon")
# the field's steps timed apart (draw, forward+backward, Adam) after the fit
FIELD_SPLIT_STEPS = 20


def phase_field(device, cfg, small, refiner, scorer):
    """The neural object field on synth_box_recon (40 frames at 640x480,
    annotated poses, per-frame masks) through tools/run_object_field_torch.py
    at the JAX tool's configuration (ObjectFieldConfig(): 1000 steps of 2048
    rays x 128 + 128 samples, Adam 0.01; HashGridSpec(): 16 levels, a 2^22
    table; extraction at 128^3, colour, texture bake): chamfer_ok against
    mesh/model_scaled_down.obj (at most 2 of the engine's voxels), s/step
    and the seconds of each stage, peak memory, the final loss; then 20
    more steps with the draws, forward+backward and Adam timed apart, and
    one under the profiler (busy share, launches); then frame 0 registered
    on the extracted mesh (decimated to 5000 triangles, as the BOP tool
    decimates a model) through K1: ADD-S against the annotated pose, K1
    launches, a finite pose required."""
    import contextlib

    import numpy as np
    import torch

    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import decimate_mesh, load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer
    from sixdof_tpu_torch.metrics import adds_err
    from sixdof_tpu_torch.models.object_field import HashGridSpec, ObjectFieldConfig

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import profile_torch_field
    import run_object_field_torch

    out = os.path.join(REPO, "build", "chip_smoke", "field")
    if small:  # the CPU rehearsal: 4 frames, 10 steps, a tiny grid
        fcfg = ObjectFieldConfig(n_step=10, n_rand=64, n_samples=8, n_samples_around_depth=8)
        spec = HashGridSpec(n_levels=4, base_res=4, finest_res=16, log2_hashmap_size=12)
        resolution, frames = 32, 4
    else:
        fcfg, spec, resolution, frames = ObjectFieldConfig(), HashGridSpec(), 128, None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the tool's indented JSON
        result, runner = run_object_field_torch.main(
            FIELD_SCENE, os.path.join(out, "model_free.obj"), steps=fcfg.n_step,
            resolution=resolution, device=device, ckpt_dir=os.path.join(out, "field_ckpt"),
            cfg=fcfg, spec=spec, max_frames=frames)
    _sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    split = profile_torch_field.step_split(runner, device, 2 if small else FIELD_SPLIT_STEPS)
    prof = _profiled(lambda: runner.step(runner.draw()), device)

    # frame 0 registered on the extracted mesh through K1
    reader = DataReader(FIELD_SCENE, shorter_side=cfg.shorter_side)
    mesh = load_mesh(result["mesh"])
    if len(mesh.faces) > 5000:
        mesh = decimate_mesh(mesh, target_tris=5000)
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         scorer=scorer, refiner=refiner, device=device, prune_to=cfg.prune_to,
                         coarse_hw=cfg.coarse_hw)
    if small:
        est.rot_grid = est.rot_grid[:: len(est.rot_grid) // 8][:8]
    color, depth = reader.get_color(0), reader.get_depth(0)
    _sync(device)
    rasterize_zbuffer.launches = 0
    t1 = time.perf_counter()
    pose = est.register(K=reader.color_K, rgb=color, depth=depth,
                        ob_mask=reader.get_mask(color, 0).astype(bool),
                        iteration=cfg.est_refine_iter)
    _sync(device)
    register_s = time.perf_counter() - t1
    k1 = rasterize_zbuffer.launches
    gt = load_mesh(os.path.join(FIELD_SCENE, "mesh", "model_scaled_down.obj")).vertices

    res = dict(result, wall_s=wall, train_s_exact=runner.train_seconds,
               s_per_step=runner.train_seconds / fcfg.n_step,
               stage_seconds=runner.stage_seconds, peak_memory_gb=None if peak is None
               else peak / 1e9, final_loss_exact=runner.final_loss,
               chamfer_mm=result.get("chamfer_m", float("nan")) * 1e3,
               rays=int(runner.rays.shape[0]), frames=int(len(runner.poses_normalized)),
               table_mb=runner.params.table.numel() * 4 / 1e6,
               draw_ms=float(np.mean(split[0])), forward_backward_ms=float(np.mean(split[1])),
               adam_ms=float(np.mean(split[2])), step_profile=prof,
               register_triangles=int(len(mesh.faces)), register_s=register_s,
               register_k1_launches=k1, register_adds_m=adds_err(pose, reader.get_gt_pose(0), gt),
               register_pose_finite=bool(np.isfinite(pose).all()))
    emit({"phase": "field", **res})
    if "texture_error" in result or not result["n_vertices"]:
        raise RuntimeError(f"the field campaign did not write its meshes: {result}")
    if not np.isfinite(runner.final_loss) or not res["register_pose_finite"]:
        raise RuntimeError(f"the field's loss or the pose on its mesh is not finite: {res}")
    if not small and not result["chamfer_ok"]:
        raise RuntimeError(f"the fitted field's mesh is {res['chamfer_mm']:.3f} mm from the GT "
                           f"mesh, over 2 voxels ({result['vox_size_m'] * 2e3:.3f} mm)")
    if device.type == "cuda" and k1 == 0:
        raise RuntimeError("registering on the field's mesh did not launch raster kernel K1")
    return dict(launches=k1)


H5_ORI = (540, 720)  # the H5 reader's default H_ori, W_ori
# transform_batch on the card against the CPU: the same float32 operations,
# but the crop transforms' inverses (cuSOLVER, LAPACK) may differ by an ulp,
# which can flip a nearest pick at a half-pixel boundary: at most this share
# of the xyz values may differ by more than H5_XYZ_ATOL; colour bit-equal
H5_XYZ_ATOL, H5_XYZ_FLIP_SHARE = 1e-5, 1e-3


def _frame_fields(A, B, poses_A, poses_B, tfs, K, diameter):
    """The H5 layout's samples of a refiner batch: uint8 colour and the
    depth (the crops' z, in metres) as write_pair_h5 stores it, uint16 mm;
    and the poses, intrinsics, crop transforms and diameters as load_batch
    returns them."""
    import numpy as np
    import torch

    n = A.shape[0]
    cz = poses_A[:, 2, 3][:, None, None]
    out = {}
    for side, x in (("A", A), ("B", B)):
        out[f"rgb{side}"] = (x[..., :3] * 255.0).round().to(torch.uint8).cpu().numpy()
        depth = np.maximum((x[..., 5] + cz).cpu().numpy(), 0.0)
        out[f"depth{side}"] = np.round(depth * 1000.0).astype(np.uint16)
    meta = dict(poseA=poses_A.cpu().numpy(), poseB=poses_B.cpu().numpy(),
                Ks=np.repeat(K.cpu().numpy()[None], n, axis=0), tf_to_crops=tfs.cpu().numpy(),
                mesh_diameters=np.full(n, diameter, np.float32))
    return out, meta


def phase_h5(device, scene, small):
    """The H5 pose-pair path at the trainer's width: a refiner batch of 32
    pairs at 160x160 on synth_box rendered through K1 (make_refiner_batch),
    every rgb and depth crop encoded into the H5 layout's PNG blobs and
    decoded bit-equal (timed), a BatchPoseData of the decoded pairs pinned
    and moved to the card, transform_batch at H_ori, W_ori = 540, 720 on the
    card and on the CPU (held to each other, timed), select_by_indices; and
    an .h5 file opened: without h5py (the card) the ImportError naming it,
    with h5py (a CPU rehearsal) the file written and read back equal."""
    import importlib.util

    import numpy as np
    import torch

    from sixdof_tpu_torch.io import h5_dataset as h5
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.png import decode_png, encode_png
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer
    from sixdof_tpu_torch.models.pose_data import BatchPoseData, PoseData
    from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch, compute_mesh_diameter
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
    from sixdof_tpu_torch.parallel import train as tr

    reader = DataReader(scene)
    K = torch.as_tensor(reader.color_K, dtype=torch.float32, device=device)
    mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    mesh.vertices = mesh.vertices - (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    diameter = compute_mesh_diameter(mesh.vertices)
    cfg = tr.TrainConfig(batch_size=2 if small else 32,
                         input_hw=(32, 32) if small else (160, 160), p_occlusion=0.5,
                         p_sensor=0.5)
    draws = tr.refiner_draws(torch.Generator(device).manual_seed(13), cfg)
    _sync(device)
    rasterize_zbuffer.launches = 0
    A, B, _, _ = tr.make_refiner_batch(draws, make_mesh_arrays(mesh, device), K, diameter, cfg)
    _sync(device)
    k1 = rasterize_zbuffer.launches
    gt = tr._random_poses(draws["poses"])
    hyp = tr._perturb(draws["perturb"], gt)[0]
    H, W = cfg.input_hw
    tfs = compute_crop_window_tf_batch(hyp, K, crop_ratio=1.2, out_size=(W, H),
                                       mesh_diameter=diameter)
    images, meta = _frame_fields(A, B, hyp, gt, tfs, K, diameter)

    # PNG blobs (the H5 layout's np.void scalars): encode, decode, bit-equal
    t0 = time.perf_counter()
    blobs = {k: [encode_png(x) for x in v] for k, v in images.items()}
    decoded = {k: np.stack([decode_png(b) for b in v]) for k, v in blobs.items()}
    png_ms = (time.perf_counter() - t0) * 1e3
    png_equal = all(np.array_equal(decoded[k], images[k]) and decoded[k].dtype == images[k].dtype
                    for k in images)
    fields = dict(rgbAs=decoded["rgbA"], rgbBs=decoded["rgbB"],
                  depthAs=decoded["depthA"].astype(np.float32) / h5.PairH5Dataset.DEPTH_SCALE,
                  depthBs=decoded["depthB"].astype(np.float32) / h5.PairH5Dataset.DEPTH_SCALE,
                  **meta)

    # transform_batch on the card (pinned host batch moved over) and the CPU
    ds = h5.PoseRefinePairH5Dataset(mode="test")  # transform-only, no file
    cpu = BatchPoseData(**fields).device("cpu")
    if device.type == "cuda":
        cpu = cpu.pin_memory()
    on_dev = BatchPoseData(**vars(cpu)).device(device)
    n_time = 1 if small else 10
    ds.transform_batch(BatchPoseData(**vars(on_dev)), *H5_ORI)  # warm-up
    transform_ms = _timed(lambda: ds.transform_batch(BatchPoseData(**vars(on_dev)), *H5_ORI),
                          device, n_time)
    got = ds.transform_batch(BatchPoseData(**vars(on_dev)), *H5_ORI)
    t0 = time.perf_counter()
    want = ds.transform_batch(BatchPoseData(**vars(cpu)), *H5_ORI)
    transform_cpu_ms = (time.perf_counter() - t0) * 1e3
    rgb_equal = all(torch.equal(getattr(got, k).cpu(), getattr(want, k))
                    for k in ("rgbAs", "rgbBs"))
    xyz_err = [(getattr(got, k).cpu() - getattr(want, k)).abs()
               for k in ("xyz_mapAs", "xyz_mapBs")]
    flip_share = float(sum((e > H5_XYZ_ATOL).sum() for e in xyz_err)
                       / sum(e.numel() for e in xyz_err))
    pick = [min(3, cfg.batch_size - 1), 0]
    sub = got.select_by_indices(pick)
    select_ok = all(torch.equal(getattr(sub, k)[j], getattr(got, k)[i])
                    for k in ("xyz_mapAs", "rgbBs", "poseA") for j, i in enumerate(pick))

    # an .h5 file: the card has no h5py
    path = os.path.join(REPO, "build", "chip_smoke", "h5", "pairs.h5")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    has_h5py = importlib.util.find_spec("h5py") is not None
    if has_h5py:
        samples = [PoseData(rgbA=images["rgbA"][i], rgbB=images["rgbB"][i],
                            depthA=fields["depthAs"][i], depthB=fields["depthBs"][i],
                            poseA=meta["poseA"][i], poseB=meta["poseB"][i], K=meta["Ks"][i],
                            tf_to_crop=meta["tf_to_crops"][i], mesh_diameter=diameter)
                   for i in range(cfg.batch_size)]
        h5.write_pair_h5(path, {"synth_box": samples}, H_ori=H5_ORI[0], W_ori=H5_ORI[1])
        back = h5.PairH5Dataset(h5_file=path)
        read = [back.load_sample("synth_box", i) for i in range(cfg.batch_size)]
        file_ok = all(np.array_equal(s.rgbA, images["rgbA"][i])
                      and np.array_equal(s.depthB, fields["depthBs"][i])
                      for i, s in enumerate(read)) and (back.H_ori, back.W_ori) == H5_ORI
        open_h5 = "written and read back equal" if file_ok else "read back differently"
    else:
        try:
            h5.PairH5Dataset(h5_file=path)
            file_ok, open_h5 = False, "opened without h5py"
        except ImportError as e:
            file_ok, open_h5 = "h5py" in str(e), f"ImportError: {e}"
    res = dict(pairs=cfg.batch_size, hw=list(cfg.input_hw), ori=list(H5_ORI), k1_launches=k1,
               png_round_trip_ms=png_ms,
               png_ms_per_image=png_ms / sum(len(v) for v in blobs.values()),
               png_bytes=sum(len(b) for v in blobs.values() for b in v), png_bit_equal=png_equal,
               transform_ms=transform_ms, transform_cpu_ms=transform_cpu_ms,
               xyz_max_abs_diff=float(max(e.max() for e in xyz_err)),
               xyz_share_over_atol=flip_share, rgb_bit_equal=rgb_equal,
               select_by_indices_ok=select_ok, h5py=has_h5py, open_h5=open_h5)
    emit({"phase": "h5", **res})
    if not (png_equal and rgb_equal and select_ok and file_ok):
        raise RuntimeError(f"the H5 path failed: {res}")
    if flip_share > H5_XYZ_FLIP_SHARE:
        raise RuntimeError(f"transform_batch on {device} and on the CPU disagree: {res}")
    if device.type == "cuda" and k1 == 0:
        raise RuntimeError("the H5 phase's batch did not launch raster kernel K1")
    return dict(launches=k1)


# ------------------------------------------------------- multi-device --

MULTI_RANKS = 2  # processes on the one card, over gloo (NCCL refuses two on one device)
MULTI_TIMEOUT = 120.0  # each part's rendezvous, and its wait for the ranks' results
MULTI_TRAIN_STEPS = 3
# a split trainer's checkpoint after its first update against the unsharded
# one's, on the entries whose unsharded first gradient is over
# MULTI_CKPT_GRAD_FLOOR of its largest (well above the gradients' 1e-4
# agreement, so both runs step them the same way): within
# MULTI_CKPT_LR_FRAC x lr.  Adam's first step moves such an entry by lr
# times the gradient's sign, so a shard stepped wrong is about lr off.
MULTI_CKPT_GRAD_FLOOR, MULTI_CKPT_LR_FRAC = 1e-3, 0.1
# sharded against unsharded: top-5 register scores, each step's loss
# (relative), the first step's averaged gradients (of the largest entry)
MULTI_SCORE_RTOL, MULTI_LOSS_RTOL, MULTI_GRAD_REL = 1e-3, 1e-3, 1e-4
# the capture restart by restart (mm transforms: rotation entries, then
# translations), fitness, and the hit distances (mm)
MULTI_ROT_ATOL, MULTI_TRANS_MM_ATOL, MULTI_FIT_ATOL, MULTI_HIT_MM_ATOL = 1e-4, 1e-2, 1e-3, 1e-3


def _config(small):
    """The pipeline configuration of the run: the app's, or the CPU
    rehearsal's tiny one."""
    from sixdof_tpu_torch.config import PipelineConfig

    if small:
        return PipelineConfig(shorter_side=120, input_resize=(32, 32), prune_to=4,
                              coarse_hw=(16, 16))
    return PipelineConfig()


def _bundled_predictors(device, cfg):
    """The refiner and scorer on the bundled weights (weights_torch/)."""
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    nets = []
    for cls, net in ((PoseRefinePredictor, "refiner"), (ScorePredictor, "scorer")):
        pred = cls(device, cfg={"input_resize": cfg.input_resize},
                   ckpt_dir=os.path.join(WEIGHTS, f"{net}.npz"))
        if pred.ckpt_path is None:
            raise RuntimeError(f"no exported {net} weights under {WEIGHTS}: "
                               "JAX_PLATFORMS=cpu python tools/export_torch_weights.py")
        nets.append(pred)
    return nets


def _kernel_counts(reset=False):
    """(K1, K2) launch counts; set to 0 first with @reset."""
    from sixdof_tpu_torch.kernels import raster, raytrace

    if reset:
        raster.rasterize_zbuffer.launches = raytrace.ray_mesh_intersect.launches = 0
    return raster.rasterize_zbuffer.launches, raytrace.ray_mesh_intersect.launches


def _multi_register(mesh, device, small):
    """synth_box frame 0 registered by FoundationPose(device_mesh=...) at the
    app's configuration (the staged path, hypotheses split over the ranks),
    on the card after one warm-up register; rank 0 then registers the frame
    unsharded through the staged path (debug 2, as phase debug)."""
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader

    cfg = _config(small)
    refiner, scorer = _bundled_predictors(device, cfg)
    scene = os.path.join(REPO, cfg.test_scene_dir)
    reader = DataReader(scene, shorter_side=cfg.shorter_side)
    obj = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    color = reader.get_color(0)
    frame = dict(K=reader.color_K, rgb=color, depth=reader.get_depth(0),
                 ob_mask=reader.get_mask(color, 0).astype(bool), iteration=cfg.est_refine_iter)

    def engine(**kw):
        est = FoundationPose(model_pts=obj.vertices, model_normals=obj.vertex_normals, mesh=obj,
                             scorer=scorer, refiner=refiner, device=device,
                             prune_to=cfg.prune_to, coarse_hw=cfg.coarse_hw, **kw)
        if small:
            est.rot_grid = est.rot_grid[:: len(est.rot_grid) // 8][:8]
        return est

    def register(est):
        _sync(device)
        t0 = time.perf_counter()
        pose = est.register(**frame)
        _sync(device)
        return pose, time.perf_counter() - t0

    sharded = engine(device_mesh=mesh)
    if device.type == "cuda":  # warm-up: first-call set-up stays out of the count and the time
        register(sharded)
    _kernel_counts(reset=True)
    pose, seconds = register(sharded)
    k1, k2 = _kernel_counts()
    out = dict(k1=k1, k2=k2, n_hypotheses=len(sharded.rot_grid), register_s=seconds, pose=pose,
               top_scores=sharded.scores[:5])
    if mesh.rank == 0:
        ref = engine(debug=2, debug_dir=os.path.join(REPO, "build", "chip_smoke", "multi"))
        ref_pose, ref_s = register(ref)
        out.update(unsharded_pose=ref_pose, unsharded_top_scores=ref.scores[:5],
                   unsharded_register_s=ref_s)
    return out


def _multi_capture(mesh, device, small):
    """Frame 2's capture (phase capture (a)'s inputs: the annotated pose,
    the heatmap's rays) through ops/icp.py::capture_from_pose with the ICP
    restarts and the defect rays split over the ranks (on the card after one
    warm-up); rank 0 then runs it unsharded."""
    import numpy as np
    import torch

    from sixdof_tpu_torch.app.defect_projection import compute_rays, heatmap_to_points
    from sixdof_tpu_torch.app.icp_pipeline import (CaptureContext, _pad_cloud,
                                                   preprocess_source, preprocess_target)
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.ops.icp import capture_from_pose

    cfg = _config(small)
    reader = DataReader(os.path.join(REPO, cfg.test_scene_dir))
    params = _icp_parameters(reader.parameters, small)
    ctx = CaptureContext(preprocess_target(reader.target, params)[0], reader.target_mesh,
                         reader.color_to_depth, device=device)
    src2 = preprocess_source(reader.get_source(2), reader.background, params, i=2)[0]
    rays, inten = compute_rays(heatmap_to_points(reader.get_heatmap(reader.get_color(0))[0],
                                                 0.75), reader.color_pinhole)
    noise, thr, base_thresh, max_iter, n_restarts = ctx.restarts_device(params)
    tf_center, c2d = ctx.pose_consts_device(np.eye(4))
    rays_d, ray_mask, _ = ctx.rays_device(rays, np.ones(len(rays), bool), inten)
    src, src_mask = _pad_cloud(src2.points, device)
    pose = torch.as_tensor(reader.get_gt_pose(2), dtype=torch.float32, device=device)

    def capture(device_mesh):
        _sync(device)
        t0 = time.perf_counter()
        out = capture_from_pose(src, src_mask, ctx.tgt, ctx.tgt_normals, ctx.tgt_mask, pose,
                                tf_center, c2d, noise, thr, base_thresh, ctx.tri, ctx.tri_mask,
                                rays_d, ray_mask, ctx.depth_to_color, max_iter=max_iter,
                                device_mesh=device_mesh)
        out = [a.cpu().numpy() for a in out]
        return out, time.perf_counter() - t0

    if device.type == "cuda":
        capture(mesh)  # warm-up
    _kernel_counts(reset=True)
    sharded, seconds = capture(mesh)
    k1, k2 = _kernel_counts()
    res = dict(k1=k1, k2=k2, restarts=n_restarts, rays=len(rays), capture_s=seconds,
               sharded=sharded)
    if mesh.rank == 0:
        res["unsharded"], res["unsharded_capture_s"] = capture(None)
    return res


def _multi_train(mesh, device, small):
    """MULTI_TRAIN_STEPS refiner and scorer steps at the trainer's
    configuration (batch 32 at 160x160; 4 scenes x 12) from the bundled
    weights (whose heads, unlike a fresh model's zero heads, give the trunk
    a first gradient), over the mesh from one generator, the first step's
    averaged gradients kept whole; each rank's peak memory and the digests
    of its parameters after the steps; rank 0 then takes the same steps
    unsharded from the same generator.  With a model axis the large layers
    are split over it (parallel/tensor_parallel.py), and the split
    trainer's checkpoint (save_params) after its first update is held to
    the unsharded one's."""
    import hashlib
    import shutil
    import tempfile

    import torch

    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.models.networks import RefineNet, ScoreNetMultiPair
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
    from sixdof_tpu_torch.parallel import train as tr
    from sixdof_tpu_torch.parallel.tensor_parallel import (full_state_dict, full_tensors,
                                                           split_parameters)

    scene = os.path.join(REPO, _config(small).test_scene_dir)
    obj = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
    obj.vertices = obj.vertices - (obj.vertices.max(0) + obj.vertices.min(0)) / 2
    arrays = make_mesh_arrays(obj, device)
    K, diameter = DataReader(scene).color_K, compute_mesh_diameter(obj.vertices)
    rcfg = tr.TrainConfig(batch_size=4 if small else 32,
                          input_hw=(32, 32) if small else (160, 160), p_occlusion=0.5,
                          p_sensor=0.5)
    scfg = rcfg._replace(n_hypotheses=2 if small else 12, lr=3e-4)
    split = mesh.shape["model"] > 1
    # the checkpoints: rank 0 writes them into its own temporary directory
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_multi_")

    def steps(cls, model, cfg, device_mesh, net, save=None):
        """The trainer's steps, the first step's gradients, and with @save
        its checkpoint there after the first update (and its weights
        gathered whole)."""
        trainer = cls(model(c_in=6), arrays, K, diameter, cfg,
                      params=tr.load_init_params(WEIGHTS, net), device_mesh=device_mesh)
        gen = torch.Generator(device).manual_seed(21)
        first = _step_seconds(device, lambda: trainer.gradients(trainer.batch(gen)))
        grads = {k: g.clone() for k, g in full_tensors(trainer.model, grads=True).items()}
        trainer.optimizer.step()
        ckpt = (tr.save_params(save, net, trainer.model),
                {k: v.clone() for k, v in full_state_dict(trainer.model).items()}) \
            if save else None
        return trainer, _steps(device, first, lambda: trainer.step(gen)), grads, ckpt

    def flat(tensors):
        return torch.cat([t.reshape(-1) for t in tensors.values()])

    out = dict(k1=0, k2=0, data_rank=mesh.data_rank, model_rank=mesh.model_rank, digests={},
               split={})
    for name, cls, model, cfg in (("refiner", tr.RefinerTrainer, RefineNet, rcfg),
                                  ("scorer", tr.ScorerTrainer, ScoreNetMultiPair, scfg)):
        _kernel_counts(reset=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        trainer, res, grads, ckpt = steps(cls, model, cfg, mesh, name,
                                          os.path.join(out_dir, "sharded") if split else None)
        out["k1"] += _kernel_counts()[0]
        res["batch"] = cfg.batch_size if name == "refiner" else cls.n_scenes * cfg.n_hypotheses
        res["peak_memory_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                                 if device.type == "cuda" else None)
        out["digests"][name] = {k: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
                                for k, p in trainer.model.named_parameters()}
        out["split"][name] = sorted(split_parameters(trainer.model))
        if mesh.rank == 0:
            _, ref_res, ref_grads, ref_ckpt = steps(
                cls, model, cfg, None, name, os.path.join(out_dir, "unsharded") if split else None)
            res.update(unsharded_losses=ref_res["losses"], unsharded_step_s=ref_res["step_s"],
                       grad_max=float(flat(ref_grads).abs().max()),
                       grad_max_abs_diff=float((flat(grads) - flat(ref_grads)).abs().max()),
                       trunk_grad_max=max(float(g.abs().max()) for k, g in ref_grads.items()
                                          if k.startswith(("encodeA", "encoderA"))))
            if split:
                res.update(_checkpoint_checks(*ckpt, ref_ckpt[0], ref_grads, out["split"][name],
                                              device, (PoseRefinePredictor, ScorePredictor)[
                                                  name == "scorer"], cfg.lr))
        out[name] = res
    shutil.rmtree(out_dir)
    return out


def _checkpoint_checks(path, whole, ref_path, ref_grads, split, device, predictor, lr):
    """The split trainer's checkpoint at @path, written after its first
    update: bit-equal to its weights gathered whole (@whole), the names and
    shapes of the unsharded one at @ref_path, loaded by @predictor, and,
    on the entries whose unsharded first gradient (@ref_grads) is over
    MULTI_CKPT_GRAD_FLOOR of the largest (counted, and those of the @split
    weights apart), its largest difference from the unsharded one beside
    the bound MULTI_CKPT_LR_FRAC x @lr."""
    import numpy as np
    import torch

    floor = MULTI_CKPT_GRAD_FLOOR * max(float(g.abs().max()) for g in ref_grads.values())
    with np.load(path) as a, np.load(ref_path) as b:
        equal = sorted(a.files) == sorted(whole) and all(
            np.array_equal(a[k], whole[k].float().cpu().numpy()) for k in a.files)
        same = sorted(a.files) == sorted(b.files) and all(a[k].shape == b[k].shape
                                                          for k in a.files)
        diff = {k: np.abs(a[k] - b[k]) for k in a.files} if same else {}
    held = {k: diff[k][ref_grads[k].abs().cpu().numpy() > floor] for k in ref_grads if k in diff}
    loaded = predictor(device, ckpt_dir=path, compute_dtype=torch.float32).ckpt_path == path
    return dict(ckpt_equals_gathered=equal, ckpt_same_names_shapes=same, ckpt_loads=loaded,
                ckpt_max_abs_diff=max(float(d.max()) for d in diff.values()) if same else None,
                ckpt_held_entries=int(sum(d.size for d in held.values())),
                ckpt_held_split_entries=int(sum(held[k].size for k in split if k in held)),
                ckpt_held_max_abs_diff=max((float(d.max(initial=0.0)) for d in held.values()),
                                           default=float("inf")),
                ckpt_bound=MULTI_CKPT_LR_FRAC * lr)


def _step_seconds(device, fn):
    """(@fn's result, its synchronised seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _steps(device, first, step):
    """The losses and seconds of MULTI_TRAIN_STEPS steps: @first's (a
    (loss, seconds) pair already taken), then @step's, each synchronised."""
    runs = [first] + [_step_seconds(device, step) for _ in range(MULTI_TRAIN_STEPS - 1)]
    return dict(losses=[float(loss) for loss, _ in runs], step_s=[t for _, t in runs])


def _multi_field(mesh, device, small):
    """MULTI_TRAIN_STEPS object-field steps on synth_box_recon at the JAX
    tool's configuration (2048 rays, a 2^22 table), data-parallel over the
    ranks (every rank the same draws), the first step's averaged gradients
    kept; rank 0 then takes the same steps unsharded from the same seed."""
    import torch

    from sixdof_tpu_torch.models.object_field import (HashGridSpec, ObjectFieldConfig,
                                                      ObjectFieldRunner)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from run_object_field_torch import load_frames

    if small:  # phase field's rehearsal size
        cfg = ObjectFieldConfig(n_rand=64, n_samples=8, n_samples_around_depth=8)
        spec = HashGridSpec(n_levels=4, base_res=4, finest_res=16, log2_hashmap_size=12)
    else:
        cfg, spec = ObjectFieldConfig(), HashGridSpec()
    frames = load_frames(FIELD_SCENE, 4 if small else None)

    def steps(device_mesh):
        runner = ObjectFieldRunner(cfg, *frames, spec=spec, seed=0, device=device)
        first = _step_seconds(device,
                              lambda: runner.loss_and_grad(runner.draw(), device_mesh)[0])
        grads = torch.cat([p.grad.reshape(-1) for p in runner.params.parameters()]).clone()
        runner.opt.step()
        res = _steps(device, first, lambda: runner.step(runner.draw(), device_mesh)[0])
        return dict(res, table_mb=runner.params.table.numel() * 4 / 1e6), grads

    _kernel_counts(reset=True)
    out, grads = steps(mesh)
    k1, k2 = _kernel_counts()
    out.update(k1=k1, k2=k2, rays=int(cfg.n_rand))
    if mesh.rank == 0:
        ref, ref_grads = steps(None)
        out.update(unsharded_losses=ref["losses"], unsharded_step_s=ref["step_s"],
                   grad_max=float(ref_grads.abs().max()),
                   grad_max_abs_diff=float((grads - ref_grads).abs().max()))
    return out


MULTI_PARTS = {"register": _multi_register, "capture": _multi_capture, "train": _multi_train,
               "field": _multi_field, "model": _multi_train, "model2d": _multi_train}
# each part's (n_data, n_model) mesh: the trainers split over a model axis
# in parts model and model2d, the rest over MULTI_RANKS data ranks
MULTI_MESH = {"model": (1, 2), "model2d": (2, 2)}
# the kernel each part's ranks launch (K1 renders, K2 traces; the field none)
MULTI_KERNEL = {"register": 0, "capture": 1, "train": 0, "model": 0, "model2d": 0}


def multi_rank(mesh, part, device_type, small):
    """One rank of phase multi: part @part on the device @device_type (both
    ranks share the one card), with the run's cuDNN settings."""
    import torch

    from sixdof_tpu_torch.device import resolve_device

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = MULTI_PARTS[part](mesh, resolve_device(device_type), small)
    return dict(out, axis_s=dict(mesh.seconds))


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _check_multi(part, ranks):
    """The gates of one part against rank 0's unsharded run; returns the
    numbers compared and the failures."""
    import numpy as np

    r0, out, bad = ranks[0], {}, []
    if part == "register":
        same = all(np.array_equal(r["pose"], r0["pose"]) for r in ranks)
        rot = _rot_deg(r0["pose"][:3, :3], r0["unsharded_pose"][:3, :3])
        trans = float(np.linalg.norm(r0["pose"][:3, 3] - r0["unsharded_pose"][:3, 3]))
        rel = _rel(r0["top_scores"], r0["unsharded_top_scores"])
        out = dict(ranks_same_pose=same, vs_unsharded_rot_deg=rot, vs_unsharded_trans_m=trans,
                   top5_scores_max_rel_diff=rel)
        bad = [not same, rot > POSE_ROT_DEG_MAX, trans > POSE_TRANS_M_MAX,
               rel > MULTI_SCORE_RTOL]
    elif part == "capture":
        (tf, fit, _, best, t), (tf1, fit1, _, best1, t1) = r0["sharded"], r0["unsharded"]
        nr, nray = r0["restarts"], r0["rays"]
        same = all(all(np.array_equal(a, b) for a, b in zip(r["sharded"], r0["sharded"]))
                   for r in ranks)
        out = dict(ranks_same=same, padded=[int(tf.shape[0]) - 1, int(t.shape[0])],
                   rot_max_abs_diff=float(np.abs(tf[:nr, :3, :3] - tf1[:nr, :3, :3]).max()),
                   trans_max_abs_diff_mm=float(np.abs(tf[:nr, :3, 3] - tf1[:nr, :3, 3]).max()),
                   fitness_max_abs_diff=float(np.abs(fit[:nr] - fit1[:nr]).max()),
                   chosen_max_abs_diff=float(np.abs(tf[int(best)] - tf1[int(best1)]).max()),
                   chosen_fitness=float(fit[int(best)]))
        hit, hit1 = np.isfinite(t[:nray]), np.isfinite(t1[:nray])
        out.update(hits=int(hit.sum()), hits_same=bool(np.array_equal(hit, hit1)),
                   hit_max_abs_diff_mm=float(np.abs(t[:nray][hit] - t1[:nray][hit]).max())
                   if hit.any() else 0.0)
        bad = [not same, out["rot_max_abs_diff"] > MULTI_ROT_ATOL,
               out["trans_max_abs_diff_mm"] > MULTI_TRANS_MM_ATOL,
               out["fitness_max_abs_diff"] > MULTI_FIT_ATOL,
               np.abs(tf[int(best)][:3, :3] - tf1[int(best1)][:3, :3]).max() > MULTI_ROT_ATOL,
               np.abs(tf[int(best)][:3, 3] - tf1[int(best1)][:3, 3]).max() > MULTI_TRANS_MM_ATOL,
               not out["hits_same"], out["hit_max_abs_diff_mm"] > MULTI_HIT_MM_ATOL,
               not np.isinf(t[nray:]).all()]
    else:
        for name in (None,) if part == "field" else ("refiner", "scorer"):
            r = r0[name] if name else r0
            same = all((q[name] if name else q)["losses"] == r["losses"] for q in ranks)
            rel = _rel(r["losses"], r["unsharded_losses"])
            grad_rel = r["grad_max_abs_diff"] / max(r["grad_max"], 1e-30)
            out[name or part] = dict(ranks_same_losses=same, loss_max_rel_diff=rel,
                                     first_grad_diff_of_max=grad_rel)
            bad += [not same, rel > MULTI_LOSS_RTOL, grad_rel > MULTI_GRAD_REL]
            if name:
                checks = _replica_checks(ranks, name)
                out[name].update(checks, trunk_grad_max=r["trunk_grad_max"])
                bad += [not all(checks.values()), not r["trunk_grad_max"] > 0]
            if name and "ckpt_bound" in r:
                out[name].update({k: v for k, v in r.items() if k.startswith("ckpt_")})
                bad += [not r["ckpt_equals_gathered"], not r["ckpt_same_names_shapes"],
                        not r["ckpt_loads"], not r["ckpt_held_split_entries"] > 0,
                        not r["ckpt_held_max_abs_diff"] <= r["ckpt_bound"]]
    return out, any(bad)


def _replica_checks(ranks, net):
    """After a trainer part's steps: every replicated parameter bit-equal
    across the model ranks of a data index, every parameter (shards too)
    across the data ranks of a model index."""
    rep = [k for k in ranks[0]["digests"][net] if k not in ranks[0]["split"][net]]
    return dict(
        replicated_equal_over_model=all(q["digests"][net][k] == r["digests"][net][k]
                                        for r in ranks for q in ranks
                                        if q["data_rank"] == r["data_rank"] for k in rep),
        params_equal_over_data=all(q["digests"][net] == r["digests"][net]
                                   for r in ranks for q in ranks
                                   if q["model_rank"] == r["model_rank"]))


def phase_multi(device, small):
    """The multi-device path on the one card (gloo; every tensor on the card,
    gloo's all_gather through host memory): the data axis over MULTI_RANKS
    ranks, then the trainers' model axis on (1, 2) and (2, 2) meshes
    (MULTI_MESH), started part by part by spawn_ranks, each part held to
    rank 0's unsharded run of the same inputs (the gates above).  It
    measures no scaling: the ranks share one card."""
    from sixdof_tpu_torch.parallel.sharding import spawn_ranks

    res = dict(backend="gloo", ranks_per_card=MULTI_RANKS, measures_scaling=False, parts={})
    k1 = k2 = 0
    failed = []
    for part in MULTI_PARTS:
        n_data, n_model = MULTI_MESH.get(part, (MULTI_RANKS, 1))
        t0 = time.perf_counter()
        ranks = spawn_ranks(multi_rank, n_data * n_model, args=(part, device.type, small),
                            backend="gloo", timeout=MULTI_TIMEOUT, threads=1 if small else None,
                            n_model=n_model)
        seconds = time.perf_counter() - t0
        checks, bad = _check_multi(part, ranks)
        launches = [(r["k1"], r["k2"]) for r in ranks]
        keep = {k: v for k, v in ranks[0].items()
                if k not in ("pose", "unsharded_pose", "sharded", "unsharded", "k1", "k2",
                             "axis_s", "digests", "split", "data_rank",
                             "model_rank")}
        nets = [net for net in ("refiner", "scorer") if net in ranks[0]]
        res["parts"][part] = dict(seconds=seconds, mesh=[n_data, n_model],
                                  data_axis_s=[r["axis_s"]["data"] for r in ranks],
                                  model_axis_s=[r["axis_s"]["model"] for r in ranks],
                                  peak_memory_gb={net: [r[net]["peak_memory_gb"] for r in ranks]
                                                  for net in nets},
                                  k1_launches=[n for n, _ in launches],
                                  k2_launches=[n for _, n in launches], checks=checks,
                                  **_jsonable(keep))
        k1 += sum(n for n, _ in launches)
        k2 += sum(n for _, n in launches)
        if bad:
            failed.append(part)
        kernel = MULTI_KERNEL.get(part)  # every rank must launch its part's kernel
        if device.type == "cuda" and kernel is not None and not all(n[kernel] for n in launches):
            failed.append(f"{part}: a rank launched no {('K1', 'K2')[kernel]}")
    emit({"phase": "multi", **res})
    if failed:
        raise RuntimeError(f"phase multi failed: {failed}")
    return dict(k1_launches=k1, k2_launches=k2)


COLD_TIMEOUT = 300.0  # one fresh process of the timeline tool
# the cold phase's runs, (flags, environment): (a) and (b) on the libraries
# phase build built, (c) building them anew in an empty directory, (d) as
# (b) with glibc's malloc held to one arena (a new thread's allocations
# otherwise come from an arena of its own, which the warm-up thread fills)
COLD_RUNS = {"a": (["--no-precompile"], {}), "b": ([], {}), "c": (["--cold-build"], {}),
             "d": ([], {"MALLOC_ARENA_MAX": "1"})}
COLD_ARRAYS = ("poses", "icp_frames", "icp_tfs", "icp_fitness", "cloud_sizes", "clouds")


def _small_scene(scene, out):
    """@scene with the CPU rehearsal's ICP parameters (_icp_parameters) in
    its configs: the other entries are links to @scene's."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for entry in os.listdir(scene):
        if entry != "configs":
            os.symlink(os.path.abspath(os.path.join(scene, entry)), os.path.join(out, entry))
    shutil.copytree(os.path.join(scene, "configs"), os.path.join(out, "configs"))
    path = os.path.join(out, "configs", "icp_parameters.json")
    with open(path) as f:
        params = _icp_parameters(json.load(f), True)
    with open(path, "w") as f:
        json.dump(params, f)
    return out


def _tool(name, argv, env, small):
    """tools/@name run in a fresh process; returns (its last JSON line, its
    wall seconds from the process's start to its end).  A run that fails
    raises."""
    env = dict(os.environ, **env, **({"OMP_NUM_THREADS": "1"} if small else {}))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", name), *argv],
                          capture_output=True, text=True, timeout=COLD_TIMEOUT, env=env,
                          cwd=REPO)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} {' '.join(argv)} failed with exit code "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads([x for x in proc.stdout.splitlines() if x.startswith("{")][-1]), wall


def _cold_run(name, scene, flags, env, out_dir, small):
    """One fresh process of tools/measure_cold_start_torch.py on @scene with
    @flags in @env; returns (its JSON line, its results' arrays, its wall
    seconds)."""
    import numpy as np

    npz = os.path.join(out_dir, f"{name}.npz")
    res, wall = _tool("measure_cold_start_torch.py",
                      [scene, "--out", npz, "--debug_dir", os.path.join(out_dir, f"debug_{name}"),
                       *flags], env, small)
    with np.load(npz) as f:
        arrays = {k: f[k] for k in COLD_ARRAYS}
    return res, arrays, wall


def _bit_equal(x, y):
    import numpy as np

    return all(np.array_equal(x[k], y[k]) for k in COLD_ARRAYS)


def phase_cold(device, cfg, scene, small):
    """The start-up path in fresh processes: tools/precompile_torch.py on
    @scene (the libraries found built, the warm-up's parts), then the
    timeline tool on @scene at the app's defaults (6 frames, captures every
    2) as COLD_RUNS lists them.  (a) and (b) must give bit-equal poses, ICP
    transforms and defect clouds, and the same loop launches; (b)'s warm-up
    reports its own K1/K2 launches.  The CPU rehearsal (@small) runs (b)
    alone at a tiny size."""
    out = os.path.join(REPO, "build", "chip_smoke", "cold")
    os.makedirs(out, exist_ok=True)
    flags = []
    res = {}
    if not small:
        res["prebuild"], res["prebuild_wall_s"] = _tool("precompile_torch.py", [scene], {}, small)
    if small:
        scene = _small_scene(scene, os.path.join(out, "scene"))
        flags = ["--device", device.type, "--input_resize", str(cfg.input_resize[0]),
                 "--max_frames", "3", "--depth_polish", "0", "--track_polish", "0"]
        flags += ["--shorter_side", str(cfg.shorter_side), "--max_hypotheses", "8",
                  "--prune_to", str(cfg.prune_to), "--est_refine_iter", "1",
                  "--track_refine_iter", "1"]
    names = ["b"] if small else list(COLD_RUNS)
    runs, arrays = {}, {}
    for name in names:
        run_flags, env = COLD_RUNS[name]
        one, arrays[name], wall = _cold_run(name, scene, run_flags + flags, env, out, small)
        runs[name] = dict(one, process_wall_s=wall)
    res["runs"] = runs
    if not small:
        res.update(a_vs_b_bit_equal=_bit_equal(arrays["a"], arrays["b"]),
                   c_vs_a_bit_equal=_bit_equal(arrays["a"], arrays["c"]),
                   d_vs_a_bit_equal=_bit_equal(arrays["a"], arrays["d"]),
                   icp_frames=arrays["a"]["icp_frames"].tolist())
    emit({"phase": "cold", **_jsonable(res)})
    check_cold(res, on_card=device.type == "cuda", small=small)
    return res


def check_cold(res, on_card, small):
    """phase cold's gates (see phase_cold); raises on the first that fails."""
    runs = res["runs"]
    warm = runs["b"]
    if set(warm["precompile_record"]["seconds"]) < {"build", "register", "track", "capture"}:
        raise RuntimeError(f"the warm-up did not run every part: {warm['precompile_record']}")
    if on_card:
        launched = warm["precompile_record"]["launches"]
        if not (launched.get("rasterize_zbuffer") and launched.get("ray_mesh_intersect")):
            raise RuntimeError(f"the warm-up did not launch K1 and K2: {launched}")
    if small:
        return
    if res["icp_frames"] != [0, 2, 4]:
        raise RuntimeError(f"the cold runs captured on frames {res['icp_frames']}, not 0, 2, 4")
    if not res["a_vs_b_bit_equal"]:
        raise RuntimeError("the runs with and without the warm-up disagree")
    same = ("loop_k1_launches", "loop_k2_launches")
    if any(runs["a"][k] != runs["b"][k] for k in same):
        raise RuntimeError("the warm-up changed the loop's launch counts: "
                           f"{[(runs['a'][k], runs['b'][k]) for k in same]}")


# the six committed demo scenes: (name, frames, variant, sensor model)
SCENE_SET = (("synth_box", 6, "box", False), ("synth_clutter", 6, "clutter", False),
             ("synth_occl", 6, "occl", False), ("synth_box_sensor", 6, "box", True),
             ("synth_clutter_sensor", 6, "clutter", True), ("synth_box_recon", 40, "recon", False))
SCENE_LOOP_FRAMES = 31  # bench.py's loop: frame 0, then 30 tracked, a capture every 10


def _tools():
    path = os.path.join(REPO, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)


def _checked_render(check):
    """render_batch, each call's z-buffer also computed through K1 (launch
    counted apart, in check["apart"]) and K1's plain version: zbuf and tid
    must agree, and the render's depth be that z-buffer.  The first renders
    of each scene (check["scene"]) are kept for phase k1's timings, and the
    seconds the checks take, a scene, in check["seconds"]."""
    import torch

    from sixdof_tpu_torch.kernels.build import launches_apart
    from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer, rasterize_zbuffer_plain
    from sixdof_tpu_torch.ops.rasterize import render_batch, zbuffer_setup

    def render(mesh, poses, K, crop_tfs=None, out_hw=(160, 160), **kw):
        out = render_batch(mesh, poses, K, crop_tfs, out_hw=out_hw, **kw)
        _sync(poses.device)
        t0 = time.perf_counter()
        H, W = out_hw
        tfs = torch.eye(3, device=poses.device).repeat(len(poses), 1, 1)
        s = zbuffer_setup(mesh, poses, K, tfs, backface_cull=kw.get("backface_cull", False))
        with launches_apart(check["apart"]):
            zk, tk = rasterize_zbuffer(s["coef_c"], s["counts"], H, W)
        zp, tp = rasterize_zbuffer_plain(s["coef_c"], s["counts"], H, W)
        check["renders"] += 1
        check["max_depth_err"] = max(check["max_depth_err"], float((zk - zp).abs().max()))
        check["tid_mismatch"] += int((tk != tp).sum())
        check["render_depth_err"] = max(check["render_depth_err"], float(
            (out["depth"].reshape(len(poses), -1) - zk).abs().max()))
        first = check["first"].setdefault(check["scene"], [])
        if len(first) < 2:
            first.append((mesh, poses, K, H, W))
        check["seconds"][check["scene"]] = check["seconds"].get(check["scene"], 0.0) \
            + time.perf_counter() - t0
        return out
    return render


def phase_scene(device, cfg, small, refiner, scorer):
    """The scene generator (tools/make_demo_scene_torch.py) on the device:
    the six committed scenes regenerated at 640x480 through K1 (every
    render's z-buffer held to K1's plain version) and each held to its
    committed files by SCENE_GATES; K1 timed at the generator's full-frame
    shapes; then a 31-frame synth_box generated and the run loop driven
    over it (frame 0 register + ICP + ray trace, 30 tracked frames,
    captures on 10, 20, 30; each frame's ADD-S against the scene's
    annotated poses reported).  The CPU rehearsal (@small) generates two
    scenes of 2 frames at 120x160, compares nothing, and loops 3 frames."""
    import shutil

    import numpy as np

    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import adds_err
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter

    _tools()
    import make_demo_scene_torch as gen

    root = os.path.join(REPO, "build", "chip_smoke", "scene")
    shutil.rmtree(root, ignore_errors=True)
    H, W = (120, 160) if small else (480, 640)
    scenes = (SCENE_SET[0], SCENE_SET[4]) if small else SCENE_SET
    check = dict(apart={}, renders=0, max_depth_err=0.0, tid_mismatch=0, render_depth_err=0.0,
                 first={}, scene=None, seconds={})
    render = _checked_render(check)
    results, breaches, frames = [], [], 0
    _sync(device)
    _kernel_counts(reset=True)
    t_all = time.perf_counter()
    for name, n, variant, sensor in scenes:
        n = 2 if small else n
        check["scene"] = name
        stats = {}
        out = gen.main(os.path.join(root, name), n, H=H, W=W, variant=variant, sensor=sensor,
                       device=device, stats=stats, render=render)
        frames += n
        seconds = dict(stats["seconds"], check=check["seconds"][name])
        seconds["render"] -= seconds["check"]  # the generator's own render time
        rec = dict(scene=name, frames=n, seconds=seconds,
                   s_per_frame={k: v / n for k, v in seconds.items()})
        if not small:
            diff = gen.compare_scenes(os.path.join(REPO, "demo_data", name), out, n)
            rec["vs_committed"] = diff
            breaches += [f"{name}: {b}" for b in gen.scene_breaches(diff)]
        results.append(rec)
    _sync(device)
    generate_s = time.perf_counter() - t_all
    k1_generate, _ = _kernel_counts()

    # K1 at the generator's shapes, B=1 at full frame: the box's object and
    # plane, and (on the card) the clutter scene's object and statics
    cases = [(f"{name}_{what}_full_frame", mesh, poses, h, w)
             for name in (("synth_box",) if small else ("synth_box", "synth_clutter"))
             for what, (mesh, poses, _, h, w) in zip(("object", "statics"), check["first"][name])]
    k1 = phase_k1(device, cases, check["first"]["synth_box"][0][2],
                  float(compute_mesh_diameter(gen.make_object_mesh(0).vertices)),
                  n_time=2 if small else 50, phase="scene_k1", cull=False, full_frame=True)

    # a 31-frame synth_box through the run loop (the timings' launches above
    # are not the main path's)
    _kernel_counts(reset=True)
    n_loop = 3 if small else SCENE_LOOP_FRAMES
    loop_dir = gen.main(os.path.join(root, f"synth_box_{n_loop}"), n_loop, H=H, W=W,
                        variant="box", device=device, stats={}, render=render)
    k1_loop_scene, _ = _kernel_counts()
    args = _loop_args(cfg, loop_dir, small, os.path.join(root, "loop_debug"),
                      ["--no_server", "--max_frames", str(n_loop), "--capture_every",
                       "2" if small else "10", "--track_pipeline", "3", "--debug", "0"]
                      + (_NO_POLISH if small else []))
    state = app_run.LoopState()
    with _scene_icp_parameters(small):
        _sync(device)
        t0 = time.perf_counter()
        frame_times = app_run.main(args, device=device, refiner=refiner, scorer=scorer,
                                   state=state)
        _sync(device)
    loop_s = time.perf_counter() - t0
    k1_after, k2_total = _kernel_counts()
    # the tracked poses against the generated scene's annotated poses
    reader = DataReader(loop_dir)
    model = load_mesh(os.path.join(loop_dir, "mesh", "model_scaled_down.obj")).vertices
    adds_mm, rot_deg = [], []
    for i in range(n_loop):
        pose = np.loadtxt(os.path.join(root, "loop_debug", "ob_in_cam", f"{i:04d}.txt"))
        gt = reader.get_gt_pose(i)
        adds_mm.append(adds_err(pose, gt, model) * 1e3)
        rot_deg.append(_rot_deg(pose[:3, :3], gt[:3, :3]))
    loop = dict(frames=len(frame_times), seconds=loop_s,
                frame_ms_mean=float(np.mean(frame_times[1:]) * 1e3),
                frame0_ms=frame_times[0] * 1e3, stages=state.stages,
                captures=[{"frame": f, "fitness": r.fitness} for f, r in state.captures],
                defect_points=[len(p) for p in state.intersection_pcds],
                adds_mm=adds_mm, rot_err_deg=rot_deg,
                k1_launches=k1_after - k1_loop_scene, k2_launches=k2_total)
    res = dict(scenes=results, frames=frames, generate_s=generate_s,
               renders_checked=check["renders"], max_abs_depth_err=check["max_depth_err"],
               tid_mismatch=check["tid_mismatch"], render_depth_err=check["render_depth_err"],
               k1_generate_launches=k1_generate, loop=loop,
               gates=None if small else gen.SCENE_GATES, breaches=breaches)
    emit({"phase": "scene", **_jsonable(res)})
    expect_captures = [0, 2] if small else [0, 10, 20, 30]
    if check["max_depth_err"] > K1_DEPTH_ATOL or check["tid_mismatch"] \
            or check["render_depth_err"] > K1_DEPTH_ATOL:
        raise RuntimeError(f"K1 disagrees with its plain version on a generated frame: {check}")
    if device.type == "cuda" and (k1_generate != 2 * frames or loop["k2_launches"]
                                  != len(expect_captures)):
        raise RuntimeError(f"the generator launched K1 {k1_generate} times for {frames} frames "
                           f"and the loop K2 {loop['k2_launches']} times")
    if breaches:
        raise RuntimeError(f"generated scenes differ from the committed ones: {breaches}")
    # the heatmap stays where frame 0 shows the object, so later captures
    # may trace no defect: only frame 0's is held
    if len(frame_times) != n_loop or [c["frame"] for c in loop["captures"]] != expect_captures \
            or loop["defect_points"][0] == 0:
        raise RuntimeError(f"the run loop over the generated scene did not finish: {loop}")
    if not small and loop["captures"][0]["fitness"] < CAPTURE_MIN_FITNESS:
        raise RuntimeError(f"the generated scene's frame 0 did not register: {loop}")
    return dict(k1=k1, launches=k1_generate + k1_after, k2_launches=k2_total)


# the parity artifact's gate beside the five scenes' ceilings: the clutter
# rank0 probe's ADD-S before ICP (mm).  Its rotation and the network-mode
# rows are reported, not held: off the TPU the JAX package registers the
# same 180 deg flip of the clutter object at prune_to 64 (176.07 deg, 3.61
# mm, bf16 on the CPU), and its network-only scorer gives synth_clutter's
# top hypotheses equal scores in float32 (the flip, 176.07 deg) and scores
# 2e-3 apart in bf16, where rounding picks the pose (PERF.md §6,
# tools/network_scorer_ties.py)
CLUTTER_RANK0_ADDS_MM_MAX = 5.0


def _small_tools(small, cfg):
    """Context in which the tools' own engines and predictors run at the
    CPU rehearsal's size (8 hypotheses of the grid, @cfg's coarse renders,
    prune and crops, no depth or track polish: their brute-force nearest
    neighbours over full frames take minutes on the CPU), the harness on 2
    frames with the cut ICP; nothing where not @small."""
    import contextlib
    import functools
    from unittest import mock

    import sixdof_tpu_torch.estimater as estimater
    from sixdof_tpu_torch.models import predict

    _tools()
    import parity_check_torch as pc

    if not small:
        return contextlib.nullcontext()

    class Small(estimater.FoundationPose):
        def __init__(self, *args, **kw):
            kw.update(coarse_hw=cfg.coarse_hw, depth_polish=False, track_polish=False)
            if kw.get("prune_to"):
                kw["prune_to"] = min(kw["prune_to"], cfg.prune_to)
            super().__init__(*args, **kw)
            self.rot_grid = self.rot_grid[:: len(self.rot_grid) // 8][:8]

    def sized(cls):
        def make(device=None, cfg=None, **kw):
            return cls(device, cfg={**(cfg or {}), "input_resize": crops}, **kw)
        return make

    crops = cfg.input_resize
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(estimater, "FoundationPose", Small))
    for name in ("PoseRefinePredictor", "ScorePredictor"):
        stack.enter_context(mock.patch.object(predict, name, sized(getattr(predict, name))))
    stack.enter_context(mock.patch.object(pc, "main", functools.partial(pc.main, n_frames=2)))
    stack.enter_context(_scene_icp_parameters(small))
    return stack


def phase_parity(device, cfg, small):
    """tools/make_parity_artifact_torch.py: the five 6-frame scenes
    (tools/parity_check_torch.py at the app's defaults on the bundled
    networks), the network-mode rows and the clutter rank0 probe, each
    field beside the JAX package's PARITY_r5.json value; every scene within
    the tool's ceilings and the rank0 probe's ADD-S within
    CLUTTER_RANK0_ADDS_MM_MAX; then the artifact as one line (phase line
    `parity_artifact`).  The CPU rehearsal (@small) runs synth_box's and
    the network rows' first 2 frames on 8 hypotheses at a tiny size and
    holds nothing."""
    import contextlib
    import io
    from unittest import mock

    _tools()
    import make_parity_artifact_torch as mpa
    import parity_check_torch as pc

    with open(os.path.join(REPO, "PARITY_r5.json")) as f:
        jax_art = json.load(f)
    out = os.path.join(REPO, "build", "chip_smoke", "PARITY_torch_r1.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    _sync(device)
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_small_tools(small, cfg))
        if small:
            stack.enter_context(mock.patch.object(pc, "SCENES", ("synth_box",)))
        # the tools' own lines stay out of the script's
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        art = mpa.main("r1", out=out, device=device)
    _sync(device)
    k1, k2 = _kernel_counts()

    def beside(port, jax):
        return {m: {"port": v, "jax_r5": (jax or {}).get(m)} for m, v in port.items()}

    rank0 = art["clutter_rank0"]
    failed = [] if small else art["floors"]["breaches"] + (
        [] if rank0["rank0_adds_mm"] <= CLUTTER_RANK0_ADDS_MM_MAX else
        [f"clutter_rank0: rank0_adds_mm={rank0['rank0_adds_mm']:.4g} > "
         f"{CLUTTER_RANK0_ADDS_MM_MAX}"])
    emit({"phase": "parity", "seconds": time.perf_counter() - t0, "k1_launches": k1,
          "k2_launches": k2, "device": art["device"], "breaches": art["floors"]["breaches"],
          "failed": failed,
          "scenes": {k: beside(v, jax_art["scenes"].get(k)) for k, v in art["scenes"].items()},
          "network_mode": {k: beside(v, jax_art["network_mode"].get(k))
                           for k, v in art["network_mode"].items()},
          "clutter_rank0": beside(rank0, jax_art["clutter_rank0"])})
    emit({"phase": "parity_artifact", "artifact": art})
    if failed:
        raise RuntimeError(f"PARITY FLOOR BREACHED: {failed}")
    return dict(launches=k1, k2_launches=k2)


# phase evaluate: the basin angles run again through K1's plain version; the
# candidate's refiner marked as trained with the visibility substitution at a
# float gate ceiling; EVAL.json's keys (tools/eval_candidate.py's, on
# synth_box) and its rank0 probe's
EVAL_PLAIN_DEGS = (5, 20)
CANDIDATE_OCC_SUB = 0.85
EVAL_KEYS = ["weights_dir", "synth_box", "synth_box_network", "synth_clutter_network",
             "clutter_rank0"]
EVAL_RANK0_KEYS = ["occ_sub", "rank0_rot_deg", "rank0_adds_mm", "grid_best_rot_deg",
                   "grid_best_adds_mm", "true_best_rank", "n_rot_lt10"]


def phase_evaluate(device, cfg, small, train):
    """Evaluating trained weights: (a) tools/eval_register_torch.py on
    synth_box with the bundled networks (the refiner's basin, the refined
    grid, the scorer's ranking), the basin at EVAL_PLAIN_DEGS again through
    K1's plain version (the pose phase's limits), K1 held to its plain
    version at the basin's B=8 shape (phase line `evaluate_k1`); (b) phase
    train's nets (@train) saved as a candidate whose refiner was trained
    with occ_sub CANDIDATE_OCC_SUB, and tools/eval_candidate_torch.py on it
    with synth_box: EVAL.json with the JAX tool's keys, its clutter_rank0
    carrying the ceiling, every refine handed it as a float.  Accuracy is
    reported, not held: the phase's few steps train nothing."""
    import contextlib
    import inspect
    import io
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from sixdof_tpu_torch.models import predict
    from sixdof_tpu_torch.parallel.train import save_params

    _tools()
    import eval_candidate_torch as ec
    import eval_register_torch as er

    # (a) the diagnostics on the bundled networks, then the basin through the
    # plain raster
    _sync(device)
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    with _small_tools(small, cfg), contextlib.redirect_stdout(io.StringIO()):
        reg = er.main("synth_box", "weights_torch", device=device)
    _sync(device)
    register_s = time.perf_counter() - t0
    k1_register = _kernel_counts()[0]
    with _small_tools(small, cfg):
        probe = er.load(os.path.join(REPO, "demo_data", "synth_box"), "weights_torch", device)
        plain = er.basin(probe, degs=EVAL_PLAIN_DEGS, plain_raster=True)
    _sync(device)
    plain_k1 = _kernel_counts()[0] - k1_register
    kern = {r["deg"]: r["poses"] for r in reg["basin"]}
    vs_rot = [max(_rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(kern[r["deg"]], r["poses"]))
              for r in plain]
    vs_trans = [float(np.abs(kern[r["deg"]][:, :3, 3] - r["poses"][:, :3, 3]).max())
                for r in plain]
    # K1 at the basin's shape: the 20 deg perturbations at the refiner's
    # crops, rendered without culling, as the tool's refine renders them
    H, W = probe.refiner.cfg["input_resize"]
    k1 = phase_k1(device, [("basin", probe.est.mesh_tensors,
                            torch.as_tensor(er.perturbations(probe.pose_c_gt, 20),
                                            dtype=torch.float32, device=device), H, W)],
                  torch.as_tensor(probe.K, dtype=torch.float32, device=device),
                  float(probe.est.diameter), n_time=2 if small else 50, phase="evaluate_k1",
                  cull=False)
    del probe

    # (b) phase train's nets as a candidate trained with a float gate ceiling
    refine = predict.refine_poses
    params = inspect.signature(refine)
    seen = []

    def recording(*args, **kw):
        seen.append(params.bind(*args, **kw).arguments.get("occ_sub", False))
        return refine(*args, **kw)

    cand = tempfile.mkdtemp(prefix="candidate_")
    try:
        save_params(cand, "refiner", train["models"][0], {"occ_sub": CANDIDATE_OCC_SUB})
        save_params(cand, "scorer", train["models"][1])
        _sync(device)
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        with _small_tools(small, cfg), mock.patch.object(predict, "refine_poses", recording), \
                contextlib.redirect_stdout(io.StringIO()):
            ev = ec.main(cand, ["synth_box"], device=device)
        _sync(device)
        candidate_s = time.perf_counter() - t0
        k1_candidate, k2_candidate = _kernel_counts()
        with open(os.path.join(cand, "EVAL.json")) as f:
            written = json.load(f)
    finally:
        shutil.rmtree(cand, ignore_errors=True)
    rank0 = written["clutter_rank0"]
    checks = dict(
        eval_keys=list(written) == EVAL_KEYS and written == json.loads(json.dumps(ev)),
        floor_breaches="floor_breaches" in written["synth_box"],
        rank0_keys=list(rank0) == EVAL_RANK0_KEYS,
        rank0_occ_sub=type(rank0["occ_sub"]) is float and rank0["occ_sub"] == CANDIDATE_OCC_SUB,
        refine_occ_sub=bool(seen) and all(type(x) is float and x == CANDIDATE_OCC_SUB
                                          for x in seen))
    res = dict(
        register=reg["summary"], register_s=register_s, register_k1_launches=k1_register,
        basin_vs_plain=dict(degs=list(EVAL_PLAIN_DEGS), rot_deg=vs_rot, trans_m=vs_trans,
                            plain_k1_launches=plain_k1),
        candidate=dict(seconds=candidate_s, k1_launches=k1_candidate,
                       k2_launches=k2_candidate, refine_calls=len(seen),
                       occ_sub_seen=sorted(set(map(repr, seen))), clutter_rank0=rank0,
                       synth_box={k: written["synth_box"].get(k) for k in (
                           "adds_mean_m", "rot_err_deg_mean", "floor_breaches")},
                       network_rot_err_deg_mean={
                           k: written[k]["rot_err_deg_mean"] for k in EVAL_KEYS[2:4]}),
        checks=checks)
    emit({"phase": "evaluate", **res})
    if device.type == "cuda" and not (k1_register and k1_candidate and k2_candidate):
        raise RuntimeError(f"phase evaluate did not launch K1 and K2: {res}")
    if plain_k1 or max(vs_rot) > POSE_ROT_DEG_MAX or max(vs_trans) > POSE_TRANS_M_MAX:
        raise RuntimeError(f"the basin through K1 and through its plain version disagree: "
                           f"{res['basin_vs_plain']}")
    if not all(checks.values()):
        raise RuntimeError(f"the candidate's evaluation is not the JAX tool's: {checks}")
    return dict(k1=k1, launches=k1_register + k1_candidate, k2_launches=k2_candidate)


def phase_sweep(device, cfg, small, refiner, scorer):
    """tools/sweep_register_schedule_torch.py: the four prune configurations'
    first and warm register seconds and frame-0 errors (reported)."""
    _tools()
    import sweep_register_schedule_torch as sweep

    kw = dict(shorter_side=cfg.shorter_side, warm_runs=1, n_hypotheses=8,
              configs=sweep.CONFIGS[:2]) if small else {}
    _sync(device)
    _kernel_counts(reset=True)
    with _small_engine(small):
        records = sweep.main("synth_box", device, refiner=refiner, scorer=scorer, **kw)
    emit({"phase": "sweep", "configs": records, "k1_launches": _kernel_counts()[0]})
    if any(not r["warm_register_s"] > 0 for r in records):
        raise RuntimeError(f"the sweep did not time its registers: {records}")
    return dict(records=records, launches=_kernel_counts()[0])


def phase_flops(device, cfg, small, refiner, scorer):
    """tools/flops_report_torch.py: FlopCounterMode's count of register,
    its cascade, a track step and the cascade's four stages beside
    FLOPS.json's XLA figures; the cascade must equal its stages' sum."""
    _tools()
    import flops_report_torch as fr

    out = os.path.join(REPO, "build", "chip_smoke", "flops.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    kw = dict(shorter_side=cfg.shorter_side, n_hypotheses=8, prune_to=4) if small else {}
    _sync(device)
    _kernel_counts(reset=True)
    with _small_engine(small):
        rep = fr.main(device=device, out=out, refiner=refiner, scorer=scorer, **kw)
    _sync(device)
    rep["k1_launches"] = _kernel_counts()[0]
    emit({"phase": "flops", **{k: v for k, v in rep.items() if k != "register_stages"},
          "register_stages": {k: {m: v[m] for m in ("flops", "xla_flops", "ratio_to_xla")}
                              for k, v in rep["register_stages"].items()}})
    if rep["register_cascade"]["flops"] != rep["register_stage_sum_flops"] \
            or rep["register_stage_sum_flops"] <= 0:
        raise RuntimeError("the cascade's FLOPs are not the sum of its stages': "
                           f"{rep['register_cascade']['flops']} vs "
                           f"{rep['register_stage_sum_flops']}")
    return rep


def _jsonable(x):
    """numpy values as lists and floats, for the phase's JSON line."""
    import numpy as np

    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


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

    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.io import jpeg, png
    from sixdof_tpu_torch.io.mesh_io import decimate_mesh, load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.kernels import raster, raytrace
    from sixdof_tpu_torch.kernels.build import build_all
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
        libraries = (raster.LIBRARY, raytrace.LIBRARY, png.LIBRARY, jpeg.LIBRARY)
        seconds = build_all(libraries)
        emit({"phase": "build", "seconds": seconds,
              "libraries": {lib.name: {"library": os.path.relpath(lib.info["library"], REPO),
                                       "seconds": lib.info["seconds"],
                                       "ptxas": lib.info["ptxas"].strip().splitlines()[-2:]}
                            for lib in libraries}})

    cfg = _config(small)
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
    # the register shapes, the track shapes, the 5120-triangle mesh (the
    # size at which the JAX package switches to its banded raster form), and
    # the bop phase's full grid (every hypothesis refined and scored at
    # 160x160) on the pose mesh and on a 20,480-triangle subdivision
    # decimated to 5000, as tools/run_bop_torch.py decimates it
    arrays, fine = make_mesh_arrays(mesh, dev), make_mesh_arrays(_subdivide(mesh), dev)
    decimated = make_mesh_arrays(decimate_mesh(_subdivide(_subdivide(mesh)), target_tris=5000),
                                 dev)
    sizes = ((8, 24), (4, 40), (1, 40), (1, 24), (4, 40), (8, 40), (8, 40)) if small else \
        ((252, 96), (64, 160), (1, 160), (1, 96), (64, 160), (252, 160), (252, 160))
    labels = ("register_coarse", "register_refine", "track_refine", "track_coarse",
              "subdivided_5120", "register_full_grid", "full_grid_decimated_5000")
    meshes = {"subdivided_5120": fine, "full_grid_decimated_5000": decimated}
    cases = [(label, meshes.get(label, arrays), poses[:B], hw, hw)
             for label, (B, hw) in zip(labels, sizes)]
    k1 = phase_k1(dev, cases, K, diameter, n_time=2 if small else 50)

    # the pose server on the bundled networks, through the kernel, then
    # through the plain raster
    refiner, scorer = _bundled_predictors(dev, cfg)
    n_frames = 2 if small else 5
    kern = phase_pose(dev, cfg, small, n_frames, False, refiner, scorer, warmup=on_card)
    plain = phase_pose(dev, cfg, small, n_frames, True, refiner, scorer, warmup=False)
    rot = [_rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(kern["poses"], plain["poses"])]
    trans = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
             for a, b in zip(kern["poses"], plain["poses"])]
    report = {k: v for k, v in kern.items()
              if k not in ("poses", "scores", "centred_pts", "model_center")}
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

    # K2 at the capture's shapes, accuracy, then the capture path and the run loop
    k2 = phase_k2(dev, scene, small, n_time=2 if small else 50)
    phase_accuracy(dev, scene, small, kern)
    cap = phase_capture(dev, cfg, scene, small, refiner, scorer)
    # the JAX app's other paths: --debug 2 (staged register, drawings), the
    # viewer, the point-click defect path on a crust, the --icp registration
    phase_debug(dev, cfg, scene, small, refiner, scorer, kern)
    phase_viewer(dev, cfg, scene, small, refiner, scorer)
    clicks = phase_point_click(dev, scene, small, n_time=2 if small else 20)
    phase_icp_global(dev, scene, small)
    # the trainer: its batches through K1 at the trainer's shapes, textured
    # meshes, training from scratch and from the bundled weights
    train = phase_train(dev, cfg, scene, small)
    # the JPEG decoder against its fixtures, the BOP campaign on every
    # 6-frame demo scene (and on synth_box's frames as JPEG), and the
    # live-camera loop
    phase_jpeg(small)
    bop = phase_bop(dev, small, refiner, scorer)
    live = phase_live(dev, cfg, scene, small, refiner, scorer)
    # the neural object field: a fit, its mesh, and a register on that mesh
    field = phase_field(dev, cfg, small, refiner, scorer)
    # the H5 pose-pair path, then the multi-device path's data and model axes
    # (ranks on the card; their launches are counted in the ranks)
    h5 = phase_h5(dev, scene, small)
    multi = phase_multi(dev, small)
    # the start-up path in fresh processes, with and without the warm-up
    phase_cold(dev, cfg, scene, small)
    # the README's last entry points: scene synthesis through K1 at full
    # frame (and the loop over a generated scene), the accuracy parity
    # harness, the register schedule sweep and FLOP accounting
    gen = phase_scene(dev, cfg, small, refiner, scorer)
    parity = phase_parity(dev, cfg, small)
    sweep = phase_sweep(dev, cfg, small, refiner, scorer)
    flops = phase_flops(dev, cfg, small, refiner, scorer)
    # evaluating trained weights: the register diagnostics on the bundled
    # networks, and phase train's nets as a candidate
    ev = phase_evaluate(dev, cfg, small, train)

    main_shape = k1[0]
    kernels = [{
        "name": "raster_zbuffer", "route": "cuda",
        "source": "sixdof_tpu_torch/csrc/raster_zbuffer.cu",
        "replaces": "sixdof_tpu/ops/pallas/raster_kernel.py:188",
        "launches": kern["launches"] + train["launches"] + bop["launches"]
        + live["k1_launches"] + field["launches"] + h5["launches"] + multi["k1_launches"]
        + gen["launches"] + parity["launches"] + sweep["launches"] + flops["k1_launches"]
        + ev["launches"],
        "max_abs_err": max(r["max_abs_depth_err"]
                           for r in k1 + train["k1"] + gen["k1"] + ev["k1"]),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "check": "passed",
    }, {
        "name": "ray_mesh_intersect", "route": "cuda",
        "source": "sixdof_tpu_torch/csrc/ray_mesh.cu",
        "replaces": "sixdof_tpu/ops/pallas/raytrace_kernel.py:85",
        "launches": cap["loop_k2_launches"] + clicks[0]["launches"] + live["k2_launches"]
        + multi["k2_launches"] + gen["k2_launches"] + parity["k2_launches"]
        + ev["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k2),
        "ms": k2[0]["ms"], "plain_ms": k2[0]["plain_ms"],
        "bound_ms": k2[0]["bound_ms"], "bound_by": k2[0]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a ray-triangle first hit
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
