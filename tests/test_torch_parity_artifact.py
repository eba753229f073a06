"""tools/make_parity_artifact_torch.py against tools/make_parity_artifact.py
on the CPU: the clutter rank0 probe (the product register path) of both
packages on the reduced setup of tests/torch_parity_setup.py (the bundled
weights in float32, 64x64 crops, 64 hypotheses, 32x32 coarse renders,
prune_to 4 in place of 64), and `main`'s artifact (keys, scene rows,
network-mode rows under SCORE_MODE=network, the floors' breach strings,
the summary line) with the harness and the probe stubbed alike in both
packages; and the committed PARITY_torch_r1.json against the JAX
artifact's keys and the ceilings.

Tolerances: the rank0 rotation within 0.5 deg and ADD-S within 0.2 mm
(the register parity tests' 0.5 deg / 2e-4 m)."""
import contextlib
import io
import json
import os
import sys
import types

import pytest
import torch

from test_torch_eval_register import reduce_grid
from torch_parity_setup import REPO, load_predictors

sys.path.insert(0, os.path.join(REPO, "tools"))

import make_parity_artifact as jma  # noqa: E402
import make_parity_artifact_torch as tma  # noqa: E402

torch.set_num_threads(1)

ENGINE = dict(prune_to=4, coarse_hw=(32, 32))
ROT_DEG_TOL, ADDS_MM_TOL = 0.5, 0.2


def _reduced(base):
    class Reduced(base):
        def __init__(self, **kw):
            super().__init__(**{**kw, **ENGINE})
            reduce_grid(self)
    return Reduced


def test_rank0_probe_matches_jax():
    jr, js, tr, ts = load_predictors()
    from sixdof_tpu import estimater as jest
    from sixdof_tpu.models import predict as jpred
    from sixdof_tpu_torch import estimater as test
    from sixdof_tpu_torch.models import predict as tpred

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jest, "FoundationPose", _reduced(jest.FoundationPose))
        mp.setattr(jpred, "PoseRefinePredictor", lambda **kw: jr)
        mp.setattr(jpred, "ScorePredictor", lambda **kw: js)
        ref = jma.rank0_probe()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test, "FoundationPose", _reduced(test.FoundationPose))
        mp.setattr(tpred, "PoseRefinePredictor", lambda *a, **kw: tr)
        mp.setattr(tpred, "ScorePredictor", lambda *a, **kw: ts)
        got = tma.rank0_probe(device="cpu")
    assert list(got) == list(ref)
    assert {k: got[k] for k in ("scene", "depth_polish", "prune_to")} == \
        {"scene": "demo_data/synth_clutter", "depth_polish": True, "prune_to": 64} == \
        {k: ref[k] for k in ("scene", "depth_polish", "prune_to")}
    assert abs(got["rank0_rot_deg"] - ref["rank0_rot_deg"]) <= ROT_DEG_TOL, (got, ref)
    assert abs(got["rank0_adds_mm"] - ref["rank0_adds_mm"]) <= ADDS_MM_TOL, (got, ref)


def _fake_harness(calls):
    """Both packages' parity_check.main stand-in: synth_occl breaches its
    ADD-S ceiling; each call's scene and SCORE_MODE recorded."""
    def main(scene_dir, n_frames=None, device=None):
        name = os.path.basename(scene_dir)
        calls.append((name, os.environ.get("SCORE_MODE")))
        mode = os.environ.get("SCORE_MODE")
        return {"adds_mean_m": 0.009 if name == "synth_occl" and mode is None else 0.002,
                "rot_err_deg_mean": 175.9 if name == "synth_box" and mode else 2.0,
                "icp_adds_mm": 1.0, "defect_surface_median_dist_mm": 2.0}
    return main


def test_main_writes_the_jax_artifacts_keys(tmp_path, monkeypatch):
    import parity_check
    import parity_check_torch

    probe = {"scene": "demo_data/synth_clutter", "rank0_rot_deg": 2.44, "rank0_adds_mm": 0.46,
             "depth_polish": True, "prune_to": 64}
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(parity_check, "main", _fake_harness(calls["jax"]))
    monkeypatch.setattr(parity_check_torch, "main", _fake_harness(calls["port"]))
    monkeypatch.setattr(jma, "rank0_probe", lambda: dict(probe))
    monkeypatch.setattr(tma, "rank0_probe", lambda device=None: dict(probe))
    for pkg, mod in (("jax", jma), ("port", tma)):  # PARITY_*.json under tmp_path
        (tmp_path / pkg).mkdir()
        monkeypatch.setattr(mod, "REPO", str(tmp_path / pkg))
    monkeypatch.delenv("PARITY_ASSERT", raising=False)  # the JAX tool sets it
    monkeypatch.delenv("SCORE_MODE", raising=False)
    monkeypatch.setenv("WEIGHTS_DIR", "elsewhere")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jma.main("t")
        assert "SCORE_MODE" not in os.environ
        art = tma.main("t", device="cpu")
        assert "SCORE_MODE" not in os.environ and os.environ["WEIGHTS_DIR"] == "elsewhere"
    with open(tmp_path / "jax" / "PARITY_t.json") as f:
        j = json.load(f)
    with open(tmp_path / "port" / "PARITY_torch_t.json") as f:
        t = json.load(f)
    assert t == json.loads(json.dumps(art))
    assert [k for k in t if k != "device"] == list(j)
    assert t["device"] == "cpu" and t["weights_dir"] == "weights_torch"
    assert t["tag"] == j["tag"] == "t" and isinstance(t["generated_unix"], int)
    for k in ("scenes", "network_mode", "clutter_rank0", "floors"):
        assert t[k] == j[k], k
    assert t["floors"] == {"breaches": ["synth_occl: adds_mean_m=0.009 > 0.008"],
                           "all_within": False}
    assert list(t["network_mode"]) == ["synth_box", "synth_clutter"]
    assert calls["port"] == calls["jax"]
    # the five scenes with the bundled networks (WEIGHTS_DIR lifted), then
    # the network rows
    assert [m for _, m in calls["port"]] == [None] * 5 + ["network"] * 2
    summaries = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert [list(s) for s in summaries] == [["wrote", "all_within", "breaches",
                                             "clutter_rank0_rot"]] * 2
    assert {k: v for k, v in summaries[0].items() if k != "wrote"} == \
        {k: v for k, v in summaries[1].items() if k != "wrote"}
    assert summaries[1]["wrote"] == str(tmp_path / "port" / "PARITY_torch_t.json")


def test_device_names_the_card_and_its_power_limit(monkeypatch):
    """On a card the artifact carries nvidia-smi's name and power limit."""
    def run(cmd, **kw):
        assert cmd[:2] == ["nvidia-smi", "--query-gpu=name,power.limit"]
        return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(tma.subprocess, "run", run)
    assert tma.device_name(torch.device("cuda", 0)) == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert tma.device_name(torch.device("cpu")) == "cpu"


def test_committed_artifact_is_the_tools_record():
    """PARITY_torch_r1.json, the artifact line of chip_smoke.py's phase
    parity on the H100: the JAX artifact's keys and fields and the card's
    name, every scene within its ceilings (the port's harness's breach
    strings, none), the rank0 probe's ADD-S within the phase's gate."""
    sys.path.insert(0, REPO)
    import chip_smoke
    import parity_check_torch

    with open(os.path.join(REPO, "PARITY_torch_r1.json")) as f:
        t = json.load(f)
    with open(os.path.join(REPO, "PARITY_r5.json")) as f:
        j = json.load(f)
    assert [k for k in t if k != "device"] == list(j)
    assert t["tag"] == "r1" and t["weights_dir"] == "weights_torch" and "H100" in t["device"]
    for part in ("scenes", "network_mode"):
        assert list(t[part]) == list(j[part])
        assert all(list(t[part][k]) == list(j[part][k]) for k in t[part])
    assert list(t["clutter_rank0"]) == list(j["clutter_rank0"])
    assert [b for k, v in t["scenes"].items()
            for b in parity_check_torch.check_thresholds(k, v)] == t["floors"]["breaches"] == []
    assert t["floors"]["all_within"]
    assert t["clutter_rank0"]["rank0_adds_mm"] <= chip_smoke.CLUTTER_RANK0_ADDS_MM_MAX
