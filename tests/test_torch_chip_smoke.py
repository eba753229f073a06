"""chip_smoke.py rehearsed on the CPU at a tiny size: every phase runs (K1
through its plain version, the pose server twice) and the kernels line has
the keys the card run reports."""
import json
import os
import sys

import torch

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms"}


def test_chip_smoke_rehearsal_on_cpu(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    kernels = chip_smoke.run("cpu", small=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phases = [x.get("phase") for x in lines]
    assert phases.count("k1") == 2 and "pose" in phases
    assert lines[-1] == {"kernels": kernels}
    (k,) = kernels
    assert KEYS <= set(k) and k["route"] == "cuda" and k["bound_by"] in ("bytes", "operations")
    assert os.path.exists(os.path.join(REPO, k["source"]))
    path, line = k["replaces"].split(":")
    assert "pallas_call" in open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
    pose = next(x for x in lines if x.get("phase") == "pose")
    assert len(pose["adds_m"]) == 3 and max(pose["vs_plain_rot_deg"]) == 0.0
