"""tools/parity_check_torch.py against tools/parity_check.py on synth_box
(frames 0-1) on the CPU, both engines at the reduced grid of
tests/torch_parity_setup.py (the bundled weights in float32, 64
hypotheses, 64x64 crops, 32x32 coarse renders, prune_to 4): the same JSON
fields, the poses' errors within the register parity tolerances, the ICP
and defect fields within tests/test_torch_capture.py's; and the
ceilings' breach strings and PARITY_ASSERT exit of the command line."""
import os
import sys

import numpy as np
import pytest
import torch

from torch_parity_setup import N_HYPOTHESES, load_predictors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import parity_check as jpc  # noqa: E402
import parity_check_torch as tpc  # noqa: E402

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SCENE = os.path.join(REPO, "demo_data", "synth_box")
ENGINE = dict(prune_to=4, coarse_hw=(32, 32))
# poses: the register parity tests' 0.5 deg / 2e-4 m give ADD(-S) within
# 2e-4 m; ICP: 0.3 deg / 2 mm (tests/test_torch_capture.py) and fitness
# 0.01; the defect points' count within 2% and their distance within 0.5 mm
TOL = {"adds_mean_m": 2e-4, "add_mean_m": 2e-4, "adds_auc_0.1d": 0.02,
       "rot_err_deg_mean": 0.5, "t_err_m_mean": 2e-4, "icp_rot_err_deg": 0.3,
       "icp_t_err_mm": 2.0, "icp_adds_mm": 2.0, "icp_fitness": 0.01, "icp_rmse_mm": 0.1,
       "defect_surface_median_dist_mm": 0.5, "mesh_diameter_m": 1e-9}


def _reduced(est):
    step = len(est.rot_grid) // N_HYPOTHESES
    est.rot_grid = est.rot_grid[::step][:N_HYPOTHESES]
    return est


@pytest.fixture(scope="module")
def results():
    jr, js, tr, ts = load_predictors()
    from sixdof_tpu import estimater as jest_mod
    from sixdof_tpu.models import predict as jpred
    from sixdof_tpu_torch.estimater import FoundationPose as TFP

    JFP = jest_mod.FoundationPose

    class ReducedJax(JFP):
        def __init__(self, **kw):
            super().__init__(**kw, **ENGINE)
            _reduced(self)

    def port_engine(mesh, device):
        return _reduced(TFP(model_pts=mesh.vertices, model_normals=mesh.vertex_normals,
                            mesh=mesh, device=device, refiner=tr, scorer=ts, **ENGINE))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jest_mod, "FoundationPose", ReducedJax)
        mp.setattr(jpred, "PoseRefinePredictor", lambda **kw: jr)
        mp.setattr(jpred, "ScorePredictor", lambda **kw: js)
        mp.setattr(tpc, "make_engine", port_engine)
        return jpc.main(SCENE, 2), tpc.main(SCENE, 2, device="cpu")


def test_fields_and_values_match_jax_harness(results):
    rj, rt = results
    assert list(rt) == list(rj)
    assert rt["frames"] == rj["frames"] == 2
    for key, tol in TOL.items():
        assert abs(rt[key] - rj[key]) <= tol, (key, rt[key], rj[key])
    assert abs(rt["defect_pts"] - rj["defect_pts"]) <= 0.02 * rj["defect_pts"]
    assert rt["defect_pts"] > 100 and rt["icp_fitness"] > 0.9
    # at this grid register keeps a flipped pose in both packages: the
    # ceilings breach alike
    def breached(breaches):
        return [b.split("=")[0] for b in breaches]

    assert breached(tpc.check_thresholds("synth_box", rt)) == \
        breached(jpc.check_thresholds("synth_box", rj))


def test_thresholds_and_breach_strings_are_jax_tools():
    assert tpc.THRESHOLDS == jpc.THRESHOLDS
    bad = {"adds_mean_m": 0.01, "icp_adds_mm": 1.0, "rot_err_deg_mean": -1,
           "defect_surface_median_dist_mm": 7.5}
    for name in list(jpc.THRESHOLDS) + ["synth_box_recon"]:
        assert tpc.check_thresholds(name, bad) == jpc.check_thresholds(name, bad)
    assert tpc.check_thresholds("synth_box", bad) == [
        "synth_box: adds_mean_m=0.01 > 0.005",
        "synth_box: defect_surface_median_dist_mm=7.5 > 5.0"]


def test_parity_assert_exit_code(monkeypatch, capsys):
    scores = {"synth_box": {"adds_mean_m": 0.01}, "synth_occl": {"adds_mean_m": 0.001}}
    monkeypatch.setattr(tpc, "main", lambda d, n, device=None: scores[os.path.basename(d)])
    monkeypatch.setenv("PARITY_ASSERT", "1")
    assert tpc.cli([os.path.join(SCENE, "../synth_occl"), "--device", "cpu"]) == 0
    assert "within thresholds" in capsys.readouterr().out
    assert tpc.cli([SCENE]) == 1
    assert "adds_mean_m=0.01 > 0.005" in capsys.readouterr().err
    monkeypatch.delenv("PARITY_ASSERT")
    assert tpc.cli([SCENE]) == 0
    runs = []
    monkeypatch.setattr(tpc, "main", lambda d, n, device=None: runs.append((d, n, device))
                        or {"adds_mean_m": 0.0, "adds_auc_0.1d": 1.0, "icp_adds_mm": 0.0,
                            "defect_surface_median_dist_mm": 0.0})
    assert tpc.cli(["all", "3", "--device", "cpu"]) == 0
    assert [os.path.basename(d) for d, _, _ in runs] == list(tpc.SCENES)
    assert {(n, dev) for _, n, dev in runs} == {(3, "cpu")}
    np.testing.assert_equal(len(runs), 5)
