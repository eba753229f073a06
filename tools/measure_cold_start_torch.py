#!/usr/bin/env python3
"""Time to the first pose and the first defect cloud in a FRESH process: the
port's app start-up (`sixdof_tpu_torch/app/run.py`), as a timeline from
interpreter start.

The port's counterpart of `tools/measure_cold_start.py`.  It runs the
app's own loop (`app/run.py::main`) on the scene, so the start-up keeps the
app's order (mesh, checkpoints, engine, reader, the warm-up thread started
by `--precompile 1`, heatmap, frame 0), and prints one line a mark:

  imports, CUDA up, then the loop's marks (`LoopState.marks`): viewer,
  mesh, checkpoints, engine, reader, precompile started, heatmap, frame 0
  loaded, first pose (the first register), first defect cloud (frame 0's
  refine_pose_with_icp and ray_tracing), each capture's start and end;
  then a second register of frame 0 on the same engine (the warm one).

The last line is one JSON object: the marks, the seconds to the first pose
and to the first defect cloud, the first and second register, each
capture's seconds, the warm-up's record (its parts' seconds, the libraries
it found built, its K1/K2 launches apart from the loop's, when it ran and
how long the first register waited for it), the loop's K1/K2 launches and
which kernel libraries were built before the run.

    python3 tools/measure_cold_start_torch.py [scene_dir] [--no-precompile]
        [--cold-build] [--out results.npz] [app flags ...]

Any other flag goes to the app's parser (`--max_frames 6 --capture_every 2`
by default; the viewer listens on a free port of 127.0.0.1 unless
`--no_server`).  `--no-precompile` runs
the app at `--precompile 0`.  `--cold-build` builds every kernel library
anew in an empty temporary directory (`kernels.build.BUILD_DIR`, set here
before anything is built, removed at the end).  `--out` writes the loop's
results (the poses of every frame, the ICP transforms and fitness of frame
0 and of each capture, the defect clouds) to an .npz, which runs with and
without the warm-up are compared on.  `--input_resize N` gives both
networks N x N crops (a small CPU run).  Runs on the card unless `--device
cpu` is given.
"""
import os
import sys
import time

T0 = time.perf_counter()  # as close to process start as an in-script timer gets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MARKS = []


def mark(label, t=None):
    t = (time.perf_counter() if t is None else t) - T0
    MARKS.append((label, t))
    print(f"[{t:8.3f}s] {label}", flush=True)
    return t


def _take(argv, flag, value=False):
    """Remove @flag (and its value with @value) from @argv; returns it."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    out = argv[i + 1] if value else True
    del argv[i: i + 2 if value else i + 1]
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    precompile = not _take(argv, "--no-precompile")
    cold_build = bool(_take(argv, "--cold-build"))
    out = _take(argv, "--out", value=True)
    input_resize = _take(argv, "--input_resize", value=True)
    scene = argv.pop(0) if argv and not argv[0].startswith("-") else os.path.join(
        REPO, "demo_data", "synth_box")

    import functools
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.io import png
    from sixdof_tpu_torch.kernels import build, raster, raytrace

    mark("imports (numpy, torch, the package)")
    build_dir = None
    if cold_build:
        build_dir = build.BUILD_DIR = tempfile.mkdtemp(prefix="sixdof-kernels-")
    libraries = (raster.LIBRARY, raytrace.LIBRARY, png.LIBRARY)
    built_before = {lib.name: lib.built() for lib in libraries}

    defaults = ["--max_frames", "6", "--capture_every", "2"]
    args = app_run.build_parser().parse_args(
        ["--test_scene_dir", scene] + defaults + argv
        + ["--precompile", "1" if precompile else "0"])
    if args.device in (None, "cuda"):
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        mark("CUDA up")

    engines = []

    class Engine(app_run.FoundationPose):  # keeps the loop's engine for the second register
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    app_run.FoundationPose = Engine
    if input_resize:
        cfg = {"input_resize": (int(input_resize), int(input_resize))}
        app_run.PoseRefinePredictor = functools.partial(app_run.PoseRefinePredictor, cfg=cfg)
        app_run.ScorePredictor = functools.partial(app_run.ScorePredictor, cfg=cfg)
    k1_before, k2_before = raster.rasterize_zbuffer.launches, raytrace.ray_mesh_intersect.launches
    state = app_run.LoopState()
    try:
        app_run.main(args, state=state, viewer_address=("127.0.0.1", 0))
        loop_k1 = raster.rasterize_zbuffer.launches - k1_before
        loop_k2 = raytrace.ray_mesh_intersect.launches - k2_before
        at = dict(state.marks)
        for label, t in state.marks:
            mark(label, t)

        est = engines[0]
        reader = app_run.DataReader(scene, shorter_side=args.shorter_side, zfar=np.inf,
                                    arguments=args)
        color, depth = reader.get_color(0), reader.get_depth(0)
        mask = reader.get_mask(color, 0).astype(bool)
        t0 = time.perf_counter()
        est.register(K=reader.color_K, rgb=color, depth=depth, ob_mask=mask,
                     iteration=args.est_refine_iter)
        if est.device.type == "cuda":
            torch.cuda.synchronize()
        second_register_s = time.perf_counter() - t0
        mark("second register")
    finally:
        if build_dir is not None:
            shutil.rmtree(build_dir, ignore_errors=True)

    captures = sorted({int(label.split()[1]) for label in at if label.startswith("capture ")})
    capture_s = {f: at[f"capture {f} end"] - at[f"capture {f} start"]
                 for f in captures if f"capture {f} end" in at}
    record = est.precompile_record
    overlap = {}
    if record is not None:
        # how much of the warm-up ran beside the host set-up before frame 0's
        # register, and how long that register waited for the rest
        overlap = dict(warmup_s=record["finished"] - record["started"],
                       warmup_beside_setup_s=min(record["finished"], at["frame 0 loaded"])
                       - record["started"],
                       register_waited_s=record.get("waited_s"),
                       register_after_join_s=at["first pose"] - record["joined"])
        record = dict(record, **{k: record[k] - T0 for k in ("started", "finished", "joined")
                                 if k in record})
    poses = np.stack([np.loadtxt(os.path.join(args.debug_dir, "ob_in_cam", f"{i:04d}.txt"))
                      for i in range(len(reader) if args.max_frames is None
                                     else min(args.max_frames, len(reader)))])
    result = {
        "precompile": precompile, "cold_build": cold_build, "device": str(est.device),
        "marks": [[label, t] for label, t in MARKS],
        "time_to_first_pose_s": at["first pose"] - T0,
        "time_to_first_defect_cloud_s": at["first defect cloud"] - T0,
        "first_register_s": at["first pose"] - at["frame 0 loaded"],
        "second_register_s": second_register_s,
        "capture_s": {str(f): s for f, s in capture_s.items()},
        "precompile_record": record, **overlap,
        "loop_k1_launches": loop_k1, "loop_k2_launches": loop_k2,
        "built_before": built_before,
        "stages": state.stages,
    }
    if out:
        clouds = [np.asarray(p.points) for p in state.intersection_pcds]
        np.savez(out, poses=poses,
                 icp_frames=np.array([f for f, _ in state.captures]),
                 icp_tfs=np.stack([r.transformation for _, r in state.captures]),
                 icp_fitness=np.array([r.fitness for _, r in state.captures]),
                 cloud_sizes=np.array([len(c) for c in clouds]),
                 clouds=np.concatenate(clouds) if clouds else np.zeros((0, 3)))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
