#!/usr/bin/env python3
"""The PyTorch port's run loop with and without the reader's prefetch thread,
on one CUDA card.

    python3 tools/profile_torch_loop.py [--rounds 4] [--out build/loop.json]

Runs `sixdof_tpu_torch/app/run.py::main` as `run_torch.py --no_server
--max_frames 6 --capture_every 2 --debug 0` does (synth_box, the bundled
networks from weights_torch/, async captures), once to warm up and then
--rounds times each with the prefetch thread on and off, in turns (on, off,
off, on, ...).  "Off" serves every frame by a direct decode in the loop's
thread (`DataReader._prefetched` replaced for the run).  Prints one JSON line
per run: the loop's per-stage host times (`LoopState.stages`) and its
per-frame wall times; then the medians of each side.  Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")


def _direct(self, kind, i, loader):
    return loader(i)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None, help="also write the runs here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_loop: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from sixdof_tpu_torch.app import run as app_run
    from sixdof_tpu_torch.io.readers import DataReader

    argv = ["--test_scene_dir", SCENE, "--no_server", "--max_frames", "6", "--capture_every",
            "2", "--debug", "0", "--debug_dir", os.path.join(REPO, "build", "profile_loop")]
    loop_args = app_run.build_parser().parse_args(argv)
    dev = torch.device("cuda")
    refiner = app_run.PoseRefinePredictor(dev, ckpt_dir=app_run._ckpt(None, "refiner"))
    scorer = app_run.ScorePredictor(dev, ckpt_dir=app_run._ckpt(None, "scorer"))
    if refiner.ckpt_path is None or scorer.ckpt_path is None:
        print("profile_torch_loop: no exported weights under weights_torch/", file=sys.stderr)
        return 1

    def once(prefetch):
        state = app_run.LoopState()
        patch = (contextlib.nullcontext() if prefetch
                 else mock.patch.object(DataReader, "_prefetched", _direct))
        with patch:
            frame_s = app_run.main(loop_args, device=dev, refiner=refiner, scorer=scorer,
                                   state=state)
        torch.cuda.synchronize()
        return {"prefetch": prefetch, "frame_ms": [t * 1e3 for t in frame_s],
                "stages": state.stages,
                "fitness": [r.fitness for _, r in state.captures]}

    once(True)  # warm-up: first-call CUDA, cuDNN and cuBLAS set-up
    runs = []
    for r in range(args.rounds):
        for prefetch in ((True, False) if r % 2 == 0 else (False, True)):
            runs.append(once(prefetch))
            print(json.dumps(runs[-1]), flush=True)

    def med(side, fn):
        return statistics.median(fn(x) for x in runs if x["prefetch"] == side)

    summary = {"device": torch.cuda.get_device_name(0)}
    for side, name in ((True, "prefetch"), (False, "direct")):
        summary[name] = {
            "read_ms_median": med(side, lambda x: x["stages"]["read"]["mean_ms"]),
            "frame_ms_median_excl_frame0": med(side, lambda x: statistics.mean(x["frame_ms"][1:])),
            "track_ms_median": med(side, lambda x: x["stages"]["track"]["mean_ms"]),
        }
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
