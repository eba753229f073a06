#!/usr/bin/env python3
"""Build the port's kernel libraries for a deployment, and warm the engine
up at a scene's shapes.

The port's counterpart of `tools/precompile.py`.  What persists across
processes is the hash-named kernel libraries in `build/kernels/`
(`sixdof_tpu_torch/kernels/build.py`: raster kernel K1, ray-mesh kernel
K2, the PNG row-filter routine), named by a hash of each source and its
compiler flags: a later process loads them instead of running nvcc.  The
CUDA context, the library handles and the loaded modules are a process's
own, which the app's warm-up thread (`--precompile 1`) takes at start.

    python3 tools/precompile_torch.py                      # build every library
    python3 tools/precompile_torch.py demo_data/synth_box  # and warm up there
        [--shorter_side N] [--prune_to 64] [other app flags]

Prints which libraries were already built and which it built, in how many
seconds; with a scene, the engine's warm-up (`FoundationPose.precompile_async`
with the app's arguments) at that scene's shapes and each part's seconds
and K1/K2 launches.  The last line is one JSON object.  The app's flags
(`run_torch.py`'s) set the engine and reader as the app would.  Runs on the
card unless `--device cpu` is given (then only the PNG routine is built:
the CPU takes the kernels' plain versions).
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    scene = argv.pop(0) if argv and not argv[0].startswith("-") else None

    import numpy as np

    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import join_precompile
    from sixdof_tpu_torch.io import png
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.kernels import raster, raytrace
    from sixdof_tpu_torch.kernels.build import build_all

    args = app_run.build_parser().parse_args(
        (["--test_scene_dir", scene] if scene else []) + argv)
    dev = resolve_device(args.device)
    libraries = (raster.LIBRARY, raytrace.LIBRARY, png.LIBRARY) if dev.type == "cuda" \
        else (png.LIBRARY,)
    before = {lib.name: lib.built() for lib in libraries}
    seconds = build_all(libraries)
    built = {}
    for lib in libraries:
        built[lib.name] = dict(built_before=before[lib.name], seconds=lib.info["seconds"],
                               library=os.path.relpath(lib.info["library"], REPO))
        print(f"[precompile] {lib.name}: "
              f"{'already built' if before[lib.name] else 'built'} in "
              f"{lib.info['seconds']:.2f}s -> {built[lib.name]['library']}", flush=True)
    print(f"[precompile] libraries: {seconds:.2f}s", flush=True)
    result = {"device": str(dev), "build_seconds": seconds, "libraries": built}

    if scene:
        mesh = load_mesh(args.mesh_file or f"{scene}/mesh/model_scaled_down.obj")
        refiner = app_run.PoseRefinePredictor(dev, ckpt_dir=app_run._ckpt(args.refiner_ckpt,
                                                                          "refiner"))
        scorer = app_run.ScorePredictor(dev, ckpt_dir=app_run._ckpt(args.scorer_ckpt, "scorer"))
        est = app_run.build_engine(args, dev, mesh, refiner, scorer)
        reader = app_run.DataReader(scene, shorter_side=args.shorter_side, zfar=np.inf,
                                    arguments=args)
        t0 = time.perf_counter()
        est.precompile_async(reader.color_K, (reader.color_H, reader.color_W),
                             iteration=args.est_refine_iter,
                             track_iteration=args.track_refine_iter,
                             icp_parameters=reader.parameters)
        join_precompile()
        record = est.precompile_record
        for part, s in record["seconds"].items():
            print(f"[precompile] warm-up {part}: {s:.3f}s", flush=True)
        print(f"[precompile] warm-up at {reader.color_H}x{reader.color_W}, "
              f"{len(est.rot_grid)} hypotheses: {time.perf_counter() - t0:.2f}s; "
              f"launches {record['launches']}", flush=True)
        result.update(scene=scene, image_hw=[reader.color_H, reader.color_W],
                      hypotheses=len(est.rot_grid), warm_up_seconds=record["seconds"],
                      warm_up_launches=record["launches"])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
