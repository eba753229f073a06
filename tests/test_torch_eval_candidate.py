"""tools/eval_candidate_torch.py against tools/eval_candidate.py on the CPU:
the clutter rank0 probe of both packages on the reduced setup of
tests/torch_parity_setup.py (the bundled weights in float32, 64x64 crops,
64 hypotheses of the grid; JAX's refine_poses_jit at those crops), a float
`occ_sub` in a candidate's checkpoint reaching the refine unchanged in
both probes, and `main`'s EVAL.json (keys, breach strings, SCORE_MODE and
WEIGHTS_DIR around each harness run) with the harness and the probe
stubbed alike in both packages.

Tolerances: the rank0 and the grid's best rotation within 0.5 deg and ADD-S
within 0.2 mm (the register parity tests' 0.5 deg / 2e-4 m); the rank of
the truly best hypothesis equal, or the hypotheses between the two ranks
tied within bf16 score noise (2^-8 relative); n_rot_lt10 equal."""
import contextlib
import functools
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_eval_register import reduce_grid, reduced_port, write_candidate
from torch_parity_setup import CFG, REPO, load_predictors

sys.path.insert(0, os.path.join(REPO, "tools"))

import eval_candidate as jec  # noqa: E402
import eval_candidate_torch as tec  # noqa: E402
import eval_register_torch as er  # noqa: E402

torch.set_num_threads(1)

CLUTTER = os.path.join(REPO, "demo_data", "synth_clutter")
ROT_DEG_TOL, ADDS_MM_TOL = 0.5, 0.2
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def predictors():
    return load_predictors()


@contextlib.contextmanager
def reduced_jax(mp, jr, js, refine=None):
    """The JAX probe's engine at 64 hypotheses, its predictors the float32
    ones at 64x64 crops (or built from the checkpoint it names, @jr None),
    and its refine at those crops (or @refine)."""
    import jax.numpy as jnp

    from sixdof_tpu import estimater
    from sixdof_tpu.models import predict

    class Reduced(estimater.FoundationPose):
        def __init__(self, **kw):
            super().__init__(**kw)
            reduce_grid(self)

    refiner_cls = predict.PoseRefinePredictor

    def refiner(ckpt_dir=None):
        if jr is not None:
            return jr
        return refiner_cls(cfg=CFG, ckpt_dir=ckpt_dir, compute_dtype=jnp.float32)

    mp.setattr(estimater, "FoundationPose", Reduced)
    mp.setattr(predict, "PoseRefinePredictor", refiner)
    mp.setattr(predict, "ScorePredictor", lambda **kw: js)
    mp.setattr(predict, "refine_poses_jit", refine or functools.partial(
        predict.refine_poses_jit, out_hw=CFG["input_resize"]))
    yield


def test_rank0_probe_matches_jax(predictors, tmp_path):
    jr, js, tr, ts = predictors
    cand = write_candidate(tmp_path, tr, ts)
    with pytest.MonkeyPatch.context() as mp, reduced_jax(mp, jr, js):
        ref = jec.rank0_probe(CLUTTER, "weights")
    with pytest.MonkeyPatch.context() as mp, reduced_port(mp):
        got = tec.rank0_probe(CLUTTER, cand, device="cpu")
    assert list(got) == list(ref)
    assert got["occ_sub"] is False and ref["occ_sub"] is False
    for key in ("rank0_rot_deg", "grid_best_rot_deg"):
        assert abs(got[key] - ref[key]) <= ROT_DEG_TOL, (key, got[key], ref[key])
    for key in ("rank0_adds_mm", "grid_best_adds_mm"):
        assert abs(got[key] - ref[key]) <= ADDS_MM_TOL, (key, got[key], ref[key])
    assert got["n_rot_lt10"] == ref["n_rot_lt10"]
    if got["true_best_rank"] != ref["true_best_rank"]:
        # the ranks between the two score alike (bf16 noise)
        with pytest.MonkeyPatch.context() as mp, reduced_port(mp):
            probe = er.load(CLUTTER, cand, "cpu")
            rank = er.ranking(probe, er.refined_grid(probe))
        lo, hi = sorted((got["true_best_rank"], ref["true_best_rank"]))
        s = rank["scores"][rank["order"][lo:hi + 1]]
        assert s.max() - s.min() <= BF16_REL * np.abs(s).max()


def test_float_occ_sub_in_the_checkpoint_reaches_the_refine(predictors, tmp_path):
    """A candidate trained with a 0.85 gate ceiling: its checkpoint says so
    (the JAX package's OCC_SUB marker beside the orbax files; the port's
    MANIFEST.json cfg, as save_params writes it), and both probes hand
    0.85, a float, to the refine and report it."""
    _, js, tr, ts = predictors
    jdir = tmp_path / "jax"
    (jdir / "refiner").mkdir(parents=True)
    for entry in os.listdir(os.path.join(REPO, "weights", "refiner")):
        os.symlink(os.path.join(REPO, "weights", "refiner", entry), jdir / "refiner" / entry)
    (jdir / "refiner" / "OCC_SUB").write_text("trained with the visibility substitution, "
                                              "ceiling=0.85\n")
    seen = {"jax": [], "port": []}

    def jax_refine(*args, **kw):
        seen["jax"].append(kw["occ_sub"])
        return args[3]

    def port_refine(model, mesh, poses, *args, **kw):
        seen["port"].append(kw["occ_sub"])
        return poses

    from sixdof_tpu_torch.models import predict as tpred

    with pytest.MonkeyPatch.context() as mp, reduced_jax(mp, None, js, refine=jax_refine):
        ref = jec.rank0_probe(CLUTTER, str(jdir))
    cand = write_candidate(tmp_path / "port", tr, ts, refiner_cfg={"occ_sub": 0.85})
    with pytest.MonkeyPatch.context() as mp, reduced_port(mp):
        mp.setattr(tpred, "refine_poses", port_refine)
        got = tec.rank0_probe(CLUTTER, cand, device="cpu")
    for probe, out in (("jax", ref), ("port", got)):
        assert seen[probe] == [0.85] and type(seen[probe][0]) is float, (probe, seen)
        assert out["occ_sub"] == 0.85 and type(out["occ_sub"]) is float, (probe, out)
    with open(os.path.join(cand, "MANIFEST.json")) as f:
        assert json.load(f)["refiner"]["cfg"] == {"occ_sub": 0.85}


def _fake_harness(calls):
    """A stand-in for both packages' parity_check.main: records the scene,
    SCORE_MODE and WEIGHTS_DIR of each call; synth_box breaches two
    ceilings."""
    def main(scene_dir, n_frames=None, device=None):
        name = os.path.basename(scene_dir)
        calls.append((name, os.environ.get("SCORE_MODE"), os.environ.get("WEIGHTS_DIR")))
        bad = name == "synth_box" and os.environ.get("SCORE_MODE") is None
        return {"frames": 6, "adds_mean_m": 0.01 if bad else 0.002, "rot_err_deg_mean": 2.0,
                "icp_adds_mm": 1.0, "defect_surface_median_dist_mm": 7.5 if bad else 2.0}
    return main


@pytest.mark.parametrize("scenes", [None, ["synth_box"]], ids=["five", "synth_box"])
def test_main_writes_the_jax_tools_eval_json(tmp_path, monkeypatch, scenes):
    import parity_check
    import parity_check_torch

    probe = {"occ_sub": 0.85, "rank0_rot_deg": 1.5, "rank0_adds_mm": 0.4,
             "grid_best_rot_deg": 0.9, "grid_best_adds_mm": 0.3, "true_best_rank": 2,
             "n_rot_lt10": 7}
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(parity_check, "main", _fake_harness(calls["jax"]))
    monkeypatch.setattr(parity_check_torch, "main", _fake_harness(calls["port"]))
    monkeypatch.setattr(jec, "rank0_probe", lambda d, w: dict(probe))
    monkeypatch.setattr(tec, "rank0_probe", lambda d, w, device=None: dict(probe))
    monkeypatch.delenv("SCORE_MODE", raising=False)
    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for pkg, mod, kw in (("jax", jec, {}), ("port", tec, {"device": "cpu"})):
            wdir = tmp_path / pkg
            wdir.mkdir()
            monkeypatch.setenv("WEIGHTS_DIR", "before")  # the JAX tool leaves its own set
            mod.main(str(wdir), scenes, **kw)
            with open(wdir / "EVAL.json") as f:
                out[pkg] = json.load(f)
            assert "SCORE_MODE" not in os.environ
            if pkg == "port":  # the port puts WEIGHTS_DIR back
                assert os.environ["WEIGHTS_DIR"] == "before"
    j, t = out["jax"], out["port"]
    assert list(t) == list(j)
    assert t["weights_dir"] == str(tmp_path / "port")
    names = list(scenes or parity_check_torch.SCENES)
    assert [k for k in t if k != "weights_dir"] == names + [
        "synth_box_network", "synth_clutter_network", "clutter_rank0"]
    for k in t:
        if k != "weights_dir":
            assert t[k] == j[k], k
    assert t["synth_box"]["floor_breaches"] == [
        "synth_box: adds_mean_m=0.01 > 0.005",
        "synth_box: defect_surface_median_dist_mm=7.5 > 5.0"]
    assert t["clutter_rank0"]["occ_sub"] == 0.85
    strip = [[(n, m) for n, m, _ in calls[p]] for p in ("jax", "port")]
    assert strip[0] == strip[1]
    assert [m for _, m in strip[1]] == [None] * len(names) + ["network"] * 2
    assert {w for _, _, w in calls["port"]} == {str(tmp_path / "port")}
