"""Evaluate a set of candidate weights on the port, in one process: the
accuracy harness on the five 6-frame demo scenes, the two network-mode
rows, and the clutter rank0 probe.  Writes `<weights_dir>/EVAL.json`.

The port's counterpart of `tools/eval_candidate.py`, with its scene list,
its keys and its output file:

  <scene>            tools/parity_check_torch.py's fields on the scene
                     (hybrid scorer), plus `floor_breaches`: the ceilings
                     it breaches (check_thresholds' strings)
  <scene>_network    synth_box and synth_clutter with SCORE_MODE=network
                     (the reference's scorer; a 180 deg flip shows as a
                     rotation error near 180)
  clutter_rank0      the full rotation grid of synth_clutter refined and
                     scored (tools/eval_register_torch.py): the scorer's
                     pick against the grid's best, and the refiner's
                     `occ_sub` as the checkpoint states it

The candidate's `occ_sub` (False, True or a float gate ceiling, from its
refiner's MANIFEST.json cfg, which `parallel/train.py::save_params` writes)
reaches the refine as it is: a float ceiling does not become a bool.

    python tools/eval_candidate_torch.py [weights_dir] [scenes...] [--device cpu]
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NETWORK_SCENES = ("synth_box", "synth_clutter")


def rank0_probe(scene_dir, wdir, device=None):
    """Refine the full rotation grid of @scene_dir's frame 0 with the
    networks of @wdir and report where the scorer's pick sits: its
    rotation and ADD-S, the grid's best achievable numbers, the rank of
    the truly best hypothesis and how many end within 10 deg."""
    import eval_register_torch as er

    probe = er.load(scene_dir, wdir, device)
    # False | True | a float gate ceiling: passed on as the checkpoint states
    # it, or a float-ceiling net would be probed at the 0.6 gate
    occ_sub = probe.refiner.cfg.get("occ_sub", False)
    grid = er.refined_grid(probe, occ_sub)
    rank = er.ranking(probe, grid)
    adds, rots = grid["adds"], grid["rots"]
    i0 = int(rank["order"][0])
    return {
        "occ_sub": occ_sub,
        "rank0_rot_deg": float(rots[i0]),
        "rank0_adds_mm": float(adds[i0] * 1000),
        "grid_best_rot_deg": float(rots.min()),
        "grid_best_adds_mm": float(adds.min() * 1000),
        "true_best_rank": rank["true_best_rank"],
        "n_rot_lt10": int((rots < 10).sum()),
    }


def main(wdir, scenes=None, device=None):
    """Evaluate the candidate in @wdir (a directory under the repo, or an
    absolute one) on @scenes (default the five) on @device (None = the
    card).  Writes and returns the results (EVAL.json)."""
    import parity_check_torch as pc

    prev_wdir = os.environ.get("WEIGHTS_DIR")
    os.environ["WEIGHTS_DIR"] = wdir
    try:
        results = {"weights_dir": wdir}
        for name in scenes or pc.SCENES:
            d = os.path.join(REPO, "demo_data", name)
            if not os.path.exists(d):
                continue
            print(f"== {name} (hybrid) ==", flush=True)
            results[name] = pc.main(d, device=device)
            results[name]["floor_breaches"] = pc.check_thresholds(name, results[name])

        # the network-only scorer: the flip test is frame 0's rotation error
        os.environ["SCORE_MODE"] = "network"
        try:
            for name in NETWORK_SCENES:
                d = os.path.join(REPO, "demo_data", name)
                if not os.path.exists(d):
                    continue
                print(f"== {name} (network) ==", flush=True)
                results[f"{name}_network"] = pc.main(d, device=device)
        finally:
            del os.environ["SCORE_MODE"]
    finally:
        if prev_wdir is None:
            del os.environ["WEIGHTS_DIR"]
        else:
            os.environ["WEIGHTS_DIR"] = prev_wdir

    print("== clutter rank0 probe ==", flush=True)
    results["clutter_rank0"] = rank0_probe(os.path.join(REPO, "demo_data", "synth_clutter"),
                                           wdir, device=device)
    print(json.dumps(results["clutter_rank0"], indent=1))

    out_path = os.path.join(REPO, wdir, "EVAL.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out_path}")
    return results


def cli(argv):
    """The JAX tool's command line, plus --device; default weights_torch."""
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    main(argv[0] if argv else "weights_torch", argv[1:] or None, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
