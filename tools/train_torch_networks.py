#!/usr/bin/env python3
"""Train the refiner and scorer with the PyTorch port and save checkpoints
the port's predictors load.

    python3 tools/train_torch_networks.py [scene_dirs] [refiner_steps] [scorer_steps] [out_dir]
                                          [--device cpu]

The port's counterpart of `tools/train_networks.py`, with its arguments and
environment switches:
- @scene_dirs: comma-separated scene directories (their centred
  `mesh/model_scaled_down.obj` and colour intrinsics), and `proc:N` for N
  procedural objects (`parallel/procgen.py`); default demo_data/synth_box.
  With several objects one model and one Adam round-robin over them.
- @refiner_steps (800), @scorer_steps (400); @out_dir (weights_torch/).
- REFINER_LR (1e-4), SCORER_LR (3e-4), P_OCC (0.5), SENSOR_AUG (0.5),
  OCC_SUB (0 off, 1 the 0.6 gate ceiling, else the ceiling), DISTILL (0),
  INIT_WEIGHTS (a checkpoint `models/checkpoint.py::resolve` takes, to
  fine-tune from instead of training from scratch).
Batch 32 at 160x160; the scorer takes 12 hypotheses x 4 scenes a step.
Runs on the CUDA card (the renders launch raster kernel K1) unless
`--device cpu`.

Writes `<out_dir>/refiner.npz`, `<out_dir>/scorer.npz` (float32 state
dicts) and their entries in `<out_dir>/MANIFEST.json`, with `cfg.occ_sub`
when OCC_SUB set it, so the predictors apply the same visibility
substitution.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _parse_occ_sub(s):
    """0 = off, 1 = True (0.6 gate ceiling), any other float = the ceiling."""
    v = float(s)
    if v == 0:
        return False
    return True if v == 1 else v


def load_objects(scene_dirs, device):
    """(mesh_arrays, K, diameter) per scene, centred as the estimator
    centres it, then the `proc:N` procedural objects."""
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
    from sixdof_tpu_torch.parallel.procgen import procedural_objects

    objects, n_proc = [], 0
    for s in scene_dirs:
        if s.startswith("proc:"):
            n_proc = int(s.split(":", 1)[1])
            continue
        mesh = load_mesh(os.path.join(s, "mesh", "model_scaled_down.obj"))
        mesh.vertices = mesh.vertices - (mesh.vertices.min(axis=0) + mesh.vertices.max(axis=0)) / 2
        diameter = compute_mesh_diameter(mesh.vertices, n_sample=10000)
        with open(os.path.join(s, "configs", "camera_intrinsics.json")) as f:
            intr = json.load(f)["color"]
        K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
        objects.append((make_mesh_arrays(mesh, device), K, diameter))
        logging.info(f"object {os.path.basename(os.path.normpath(s))}: diameter {diameter:.3f}")
    if n_proc:
        K_proc = objects[0][1] if objects else np.array(
            [[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
        objects += procedural_objects(n_proc, K_proc, device)
        logging.info(f"added {n_proc} procedural objects (shared topology)")
    if not objects:
        raise ValueError("no objects to train on")
    return objects


def train_shared(trainers, n_steps, tag, gen):
    """Round-robin the objects' steps over the shared model; losses stay on
    the device between log points.  Returns (first, last, s/step)."""
    losses = []
    t0 = time.time()
    for i in range(n_steps):
        losses.append(trainers[i % len(trainers)].step(gen))
        if i % 50 == 0:
            logging.info(f"{tag} step {i}: loss {float(losses[-1]):.5f}")
    if not losses:
        return None
    first, last = float(losses[0]), float(losses[-1])
    per = (time.time() - t0) / len(losses)
    logging.info(f"{tag}: {first:.4f} -> {last:.4f} ({per:.2f}s/step)")
    return first, last, per


def main(scene_dirs, refiner_steps=800, scorer_steps=400, out_dir=None, device=None,
         **overrides):
    """@overrides: TrainConfig fields to replace (a smaller batch or crop
    for a rehearsal), applied to both networks' configs."""
    import torch

    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.models.networks import RefineNet, ScoreNetMultiPair
    from sixdof_tpu_torch.parallel.train import (RefinerTrainer, ScorerTrainer, TrainConfig,
                                                 load_init_params, save_params)

    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(REPO, "weights_torch")
    objects = load_objects(list(scene_dirs), dev)
    cfg = TrainConfig(batch_size=32, input_hw=(160, 160),
                      lr=float(os.environ.get("REFINER_LR", "1e-4")), z_range=(0.4, 0.8),
                      p_occlusion=float(os.environ.get("P_OCC", "0.5")),
                      p_sensor=float(os.environ.get("SENSOR_AUG", "0.5")),
                      occ_sub=_parse_occ_sub(os.environ.get("OCC_SUB", "0")))._replace(
                          **overrides)
    init = os.environ.get("INIT_WEIGHTS", "")
    result = {}
    if refiner_steps > 0:
        logging.info(f"training refiner for {refiner_steps} steps on {len(objects)} object(s)")
        first = RefinerTrainer(RefineNet(c_in=6), *objects[0], cfg,
                               params=load_init_params(init, "refiner"))
        trainers = [first] + [first.sharing(*o) for o in objects[1:]]
        result["refiner"] = train_shared(trainers, refiner_steps, "refiner",
                                         torch.Generator(dev).manual_seed(0))
        # the predictors read occ_sub back from the manifest (the JAX
        # trainer's OCC_SUB marker file)
        occ = {"occ_sub": 0.6 if cfg.occ_sub is True else float(cfg.occ_sub)} \
            if cfg.occ_sub else None
        save_params(out_dir, "refiner", first.model, occ)
    if scorer_steps > 0:
        logging.info(f"training scorer for {scorer_steps} steps")
        scfg = cfg._replace(n_hypotheses=overrides.get("n_hypotheses", 12),
                            lr=float(os.environ.get("SCORER_LR", "3e-4")),
                            w_distill=float(os.environ.get("DISTILL", "0")))
        first = ScorerTrainer(ScoreNetMultiPair(c_in=6), *objects[0], scfg,
                              params=load_init_params(init, "scorer"))
        trainers = [first] + [first.sharing(*o) for o in objects[1:]]
        result["scorer"] = train_shared(trainers, scorer_steps, "scorer",
                                        torch.Generator(dev).manual_seed(0))
        save_params(out_dir, "scorer", first.model)
    logging.info(f"checkpoints saved under {out_dir}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default=os.path.join(REPO, "demo_data", "synth_box"))
    ap.add_argument("refiner_steps", nargs="?", type=int, default=800)
    ap.add_argument("scorer_steps", nargs="?", type=int, default=400)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(args.scene.split(","), args.refiner_steps, args.scorer_steps, args.out_dir,
         args.device)
