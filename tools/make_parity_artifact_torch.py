"""Write the port's parity artifact, PARITY_torch_<tag>.json: the accuracy
record of the port's engine on the bundled networks (weights_torch/), in
one process.

The port's counterpart of `tools/make_parity_artifact.py`, with its keys:

  scenes         tools/parity_check_torch.py on the five 6-frame demo
                 scenes (hybrid scorer); their ceilings checked below
  network_mode   synth_box and synth_clutter with SCORE_MODE=network (the
                 reference's scorer: synth_box's known texture flip stays
                 visible)
  clutter_rank0  synth_clutter's frame 0 registered through the product
                 cascade (prune_to 64, depth polish): the top pose's
                 rotation and ADD-S error
  floors         the ceilings' breach strings, and whether none breached

plus `device`: the card's name and power limit as nvidia-smi states them,
or "cpu".  Prints the JAX tool's summary line.

    python tools/make_parity_artifact_torch.py [tag] [--device cpu]   (default tag r1)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

WEIGHTS_DIR = "weights_torch"
NETWORK_SCENES = ("synth_box", "synth_clutter")


def rank0_probe(scene="demo_data/synth_clutter", device=None):
    """Register @scene's frame 0 through the product cascade (prune_to 64,
    depth polish) on the bundled networks, on @device (None = the card),
    and report the top pose's quality: the rank0 number before ICP."""
    import numpy as np

    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import adds_err, rotation_angle_deg
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    dev = resolve_device(device)

    class Args:
        debug = 0
        box = None
        mesh = None
        voxel_size = None

    reader = DataReader(base_dir=os.path.join(REPO, scene), shorter_side=None,
                        zfar=float("inf"), arguments=Args())
    mesh = load_mesh(os.path.join(REPO, scene, "mesh", "model_scaled_down.obj"))
    wdir = os.path.join(REPO, WEIGHTS_DIR)
    est = FoundationPose(
        model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
        refiner=PoseRefinePredictor(dev, ckpt_dir=os.path.join(wdir, "refiner.npz")),
        scorer=ScorePredictor(dev, ckpt_dir=os.path.join(wdir, "scorer.npz")),
        prune_to=64, device=dev)
    color = reader.get_color(0)
    depth = reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    est.register(K=reader.color_K, rgb=color, depth=depth, ob_mask=mask, iteration=5)
    gt_c = reader.get_gt_pose(0) @ np.linalg.inv(est.get_tf_to_centered_mesh())
    top = est.poses[0]
    return {
        "scene": scene,
        "rank0_rot_deg": float(rotation_angle_deg(top[:3, :3], gt_c[:3, :3])),
        "rank0_adds_mm": float(adds_err(top, gt_c, np.asarray(est.pts)) * 1000),
        "depth_polish": bool(est.depth_polish),
        "prune_to": 64,
    }


def _git_head():
    """The checkout's short commit, or "" outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                              capture_output=True, text=True).stdout.strip()
    except OSError:
        return ""


def device_name(dev):
    """"cpu", or the card's name and power limit as nvidia-smi states them
    (the torch name where nvidia-smi cannot be run)."""
    import torch

    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return out[index] if index < len(out) else torch.cuda.get_device_name(index)


def main(tag="r1", out=None, device=None):
    """Run the five scenes, the network-mode rows and the rank0 probe on
    @device (None = the card) and write the artifact to @out (default
    PARITY_torch_<tag>.json at the repo root).  Returns the artifact."""
    import parity_check_torch as pcm

    from sixdof_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    art = {
        "tag": tag,
        "generated_unix": int(time.time()),
        "weights_dir": WEIGHTS_DIR,
        "git_head": _git_head(),
        "device": device_name(dev),
        "scenes": {},
        "network_mode": {},
    }
    prev_wdir = os.environ.pop("WEIGHTS_DIR", None)  # the bundled networks
    try:
        breaches = []
        for name in pcm.SCENES:
            r = pcm.main(os.path.join(REPO, "demo_data", name), device=dev)
            art["scenes"][name] = r
            breaches += pcm.check_thresholds(name, r)
        os.environ["SCORE_MODE"] = "network"
        try:
            for name in NETWORK_SCENES:
                art["network_mode"][name] = pcm.main(os.path.join(REPO, "demo_data", name),
                                                     device=dev)
        finally:
            del os.environ["SCORE_MODE"]
    finally:
        if prev_wdir is not None:
            os.environ["WEIGHTS_DIR"] = prev_wdir
    art["clutter_rank0"] = rank0_probe(device=dev)
    art["floors"] = {"breaches": breaches, "all_within": not breaches}
    out = out or os.path.join(REPO, f"PARITY_torch_{tag}.json")
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({"wrote": out, "all_within": not breaches,
                      "breaches": breaches,
                      "clutter_rank0_rot": art["clutter_rank0"]["rank0_rot_deg"]}))
    return art


def cli(argv):
    """The JAX tool's command line (a tag), plus --device."""
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    main(argv[0] if argv else "r1", device=device)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
