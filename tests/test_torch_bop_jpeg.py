"""The BOP campaign of the port (`tools/run_bop_torch.py`) against the JAX
tool (`tools/run_bop.py::main`) on synth_box converted with its frames
swapped for the JPEG fixtures (tests/data/jpeg, cv2 quality 95 at 4:2:0):
the port reads them through its own decoder, the JAX package through
cv2.imread.  At chip_smoke.py's small setting (2 frames, shorter side 120,
prune_to 4) with the reduced networks of tests/torch_parity_setup.py,
32x32 coarse renders and tests/test_torch_run_bop.py's 64 hypotheses, the
poses, scores and summaries agree to that test's tolerances.  (At
chip_smoke's 8 hypotheses the cascades agree, but the top pose is the
box flipped and the register polish from it leaves the two packages'
poses beyond MAX_ROT_DEG apart: the drift tests/test_torch_run_bop.py
describes.)"""
import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import sixdof_tpu.estimater as jestimater
import sixdof_tpu.models.predict as jpredict
import sixdof_tpu_torch.estimater as testimater
from test_torch_run_bop import (MAX_ROT_DEG, MAX_TRANS_M, POSES_ATOL, SCORES_ATOL,
                                _recording)
from torch_parity_setup import N_HYPOTHESES, load_predictors, rot_deg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import convert_scene_to_bop_torch as tconvert  # noqa: E402
from tools import run_bop as jrun_bop  # noqa: E402
from tools import run_bop_torch as trun_bop  # noqa: E402

SETTING = dict(frames=2, shorter_side=120, prune_to=4, max_hypotheses=N_HYPOTHESES)


def test_jpeg_campaign_matches_jax(tmp_path, monkeypatch):
    jr, js, tr, ts = load_predictors()
    scene = tconvert.main(os.path.join(REPO, "demo_data", "synth_box"), str(tmp_path), obj_id=1)
    for png in glob.glob(os.path.join(scene, "rgb", "*.png")):
        os.remove(png)
    for jpg in glob.glob(os.path.join(REPO, "tests", "data", "jpeg", "rgb", "*.jpg")):
        shutil.copy(jpg, os.path.join(scene, "rgb"))
    j_poses, t_poses, j_cascade, t_cascade = [], [], [], []
    monkeypatch.setattr(jpredict, "PoseRefinePredictor", lambda **_: jr)
    monkeypatch.setattr(jpredict, "ScorePredictor", lambda **_: js)
    monkeypatch.setattr(jestimater, "FoundationPose", _recording(jestimater.FoundationPose,
                                                                 j_poses, j_cascade))
    monkeypatch.setattr(testimater, "FoundationPose", _recording(testimater.FoundationPose,
                                                                 t_poses, t_cascade))
    want = jrun_bop.main(scene, **SETTING)
    got = trun_bop.main(scene, device="cpu", refiner=tr, scorer=ts, **SETTING)
    assert set(got) == set(want) and got["frames"] == 2
    assert len(t_poses) == len(j_poses) == 2
    (tp, ts_), (jp, js_) = t_cascade[0], j_cascade[0]
    np.testing.assert_allclose(ts_, js_, atol=SCORES_ATOL)
    np.testing.assert_allclose(tp[1:], jp[1:], atol=POSES_ATOL)
    for a, b in zip(t_poses, j_poses):
        assert rot_deg(a[:3, :3], b[:3, :3]) < MAX_ROT_DEG
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < MAX_TRANS_M
    for k in ("scene", "obj_id", "frames", "registered_frames", "adds_recall_0.1d",
              "add_recall_0.1d"):
        assert got[k] == want[k], k
    for k in ("adds_mean_m", "add_mean_m", "t_err_m_mean"):
        assert abs(got[k] - want[k]) < MAX_TRANS_M, k
    assert abs(got["rot_err_deg_mean"] - want["rot_err_deg_mean"]) < MAX_ROT_DEG
    assert abs(got["adds_auc_0.1d"] - want["adds_auc_0.1d"]) < 0.01
    assert got["diameter_m"] == pytest.approx(want["diameter_m"], rel=0, abs=1e-12)
