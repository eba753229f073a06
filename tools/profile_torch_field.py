#!/usr/bin/env python3
"""Where a training step of the port's neural object field spends its time,
on one CUDA card.

    python3 tools/profile_torch_field.py [--warmup 10] [--steps 30]
        [--top 15] [--trace-dir DIR]

Builds the field's runner on demo_data/synth_box_recon/ (40 frames, the
annotated poses and per-frame masks, as tools/run_object_field_torch.py
reads them) at the JAX tool's configuration (ObjectFieldConfig(): 2048
rays x 128 + 128 samples; HashGridSpec(): 16 levels, a 2^22 table, or
2^FIELD_LOG2 where that is set), takes --warmup steps, then times --steps
steps with CUDA events, the draws, forward+backward and Adam apart
(`step_split`, which chip_smoke.py's phase `field` uses too), and profiles
one more step.  Prints one JSON line: the card, the ms of each part, peak
memory, and the profiled step's wall and device-busy time, kernel launches
and the kernels that take the most device time, each with its count.  With
--trace-dir it writes the step's Chrome trace.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box_recon")


def step_split(runner, device, n):
    """@n more steps of @runner, each split into its draws, forward and
    backward, and Adam (CUDA events on the card, the host clock on the
    CPU); three lists of ms."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    marks = []
    for _ in range(n):
        t = [stamp()]
        draws = runner.draw()
        t.append(stamp())
        runner.loss_and_grad(draws)
        t.append(stamp())
        runner.opt.step()
        t.append(stamp())
        marks.append(t)
    if cuda:
        torch.cuda.synchronize(device)
        return [[m[i].elapsed_time(m[i + 1]) for m in marks] for i in range(3)]
    return [[(m[i + 1] - m[i]) * 1e3 for m in marks] for i in range(3)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_field: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from chip_smoke import _profiled
    from run_object_field_torch import load_frames

    from sixdof_tpu_torch.models.object_field import (
        HashGridSpec, ObjectFieldConfig, ObjectFieldRunner,
    )

    dev = torch.device("cuda")
    spec = HashGridSpec(log2_hashmap_size=int(os.environ["FIELD_LOG2"])) \
        if os.environ.get("FIELD_LOG2") else HashGridSpec()
    runner = ObjectFieldRunner(ObjectFieldConfig(), *load_frames(SCENE), spec=spec, device=dev)
    for _ in range(args.warmup):
        runner.step(runner.draw())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    parts = step_split(runner, dev, args.steps)
    trace = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = os.path.join(args.trace_dir, "torch_field_step.json")
    out = {
        "device": torch.cuda.get_device_name(0), "rays": int(runner.rays.shape[0]),
        "table_mb": runner.params.table.numel() * 4 / 1e6, "steps": args.steps,
        "step_ms": float(np.mean([sum(p) for p in zip(*parts)])),
        "draw_ms": float(np.mean(parts[0])), "forward_backward_ms": float(np.mean(parts[1])),
        "adam_ms": float(np.mean(parts[2])),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "profiled_step": _profiled(lambda: runner.step(runner.draw()), dev, top=args.top,
                                   trace=trace),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
