#!/usr/bin/env python3
"""The JAX package's BOP campaign on the converted 6-frame demo scenes: the
reference that the port's BOP numbers are read against.

    JAX_PLATFORMS=cpu python tools/bop_jax_reference.py [--prune_to P]
        [--scenes synth_clutter synth_occl ...] [--frames N]
        [--compute_dtype float32] [--port] [--out DIR]

Each scene is converted by tools/convert_scene_to_bop.py into DIR (default
build/bop_jax_reference/) and scored by tools/run_bop.py's main at the
app's width (252 hypotheses, prune_to P, default 64, register 5 and track 2
iterations, the bundled weights/, the networks in bfloat16 unless
--compute_dtype float32; the first N frames, default all 6).  With --port,
the port's campaign (tools/run_bop_torch.py's main on the CPU, the scene
converted by tools/convert_scene_to_bop_torch.py) runs beside it, its
networks holding the same checkpoint in the same arithmetic.  Prints one
JSON line a scene and package: the scene, the package, the prune_to, the
dtype and run_bop's keys (ADD-S, ADD, AUC, recalls, mean rotation and
translation error).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

SCENES = ("synth_box", "synth_box_sensor", "synth_clutter", "synth_clutter_sensor", "synth_occl")


def main(scenes=SCENES, prune_to=64, out=None, frames=None, compute_dtype="bfloat16",
         port=False):
    # no executable caches on disk (sixdof_tpu/utils/aot_cache.py, and the
    # persistent cache whose directory run_bop sets): an XLA:CPU executable
    # loaded back from them fails on the next scene ("Function ... not found")
    os.environ["SIXDOF_AOT_CACHE"] = ""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import convert_scene_to_bop
    import run_bop
    from sixdof_tpu.models import predict

    jax.config.update("jax_enable_compilation_cache", False)
    nets = {name: getattr(predict, name)(ckpt_dir=os.path.join(REPO, "weights", net),
                                         compute_dtype=getattr(jnp, compute_dtype))
            for name, net in (("PoseRefinePredictor", "refiner"), ("ScorePredictor", "scorer"))}
    for name, pred in nets.items():  # run_bop builds its predictors from this module
        setattr(predict, name, lambda pred=pred, **_: pred)
    if port:
        import torch

        import convert_scene_to_bop_torch
        import run_bop_torch
        from sixdof_tpu_torch.models import predict as tpredict

        tnets = {name: getattr(tpredict, name)("cpu", params=jax.tree.map(np.asarray, p.params),
                                               compute_dtype=getattr(torch, compute_dtype))
                 for name, p in nets.items()}

    out = out or os.path.join(REPO, "build", "bop_jax_reference")
    results = []
    for scene in scenes:
        src = os.path.join(REPO, "demo_data", scene)
        runs = [("jax", lambda: run_bop.main(
            convert_scene_to_bop.main(src, os.path.join(out, scene), obj_id=1),
            frames=frames, prune_to=prune_to))]
        if port:
            runs.append(("port", lambda: run_bop_torch.main(
                convert_scene_to_bop_torch.main(src, os.path.join(out, "port", scene), obj_id=1),
                frames=frames, prune_to=prune_to, device="cpu",
                refiner=tnets["PoseRefinePredictor"], scorer=tnets["ScorePredictor"])))
        for package, run in runs:
            results.append(dict(name=scene, package=package, prune_to=prune_to,
                                compute_dtype=compute_dtype, **run()))
            print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--prune_to", type=int, default=64)
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--compute_dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--port", action="store_true",
                    help="also run the port's campaign on the CPU on the same checkpoint")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    main(a.scenes, a.prune_to, a.out, a.frames, a.compute_dtype, a.port)
