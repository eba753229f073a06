"""The BOP campaign of the port (`tools/run_bop_torch.py`) against the JAX
tool (`tools/run_bop.py::main`) on a converted synth_box, at the reduced
setting of tests/torch_parity_setup.py: the bundled weights in float32,
64x64 crops, 32x32 coarse renders, prune_to 4, its 64 hypotheses (at 8 the
top pose is 20 deg off and the unguarded register polish then drifts
apart), frames at shorter side 240; register on frame 0, track frame 1.
The cascade's poses and scores, the per-frame poses and the summaries'
scalars agree to the scene-parity tolerances of the box."""
import os
import sys

import numpy as np
import pytest
import torch

import sixdof_tpu.estimater as jestimater
import sixdof_tpu.models.predict as jpredict
import sixdof_tpu_torch.estimater as testimater
from torch_parity_setup import N_HYPOTHESES, load_predictors, rot_deg

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import convert_scene_to_bop_torch as tconvert  # noqa: E402
from tools import run_bop as jrun_bop  # noqa: E402
from tools import run_bop_torch as trun_bop  # noqa: E402

# tests/test_torch_parity_scenes.py's limits: the cascade's sorted poses and
# scores (its line 23), and the polished pose of the box's mesh (its
# synth_box_sensor row: the box is weakly constrained in-plane, so the
# register polish turns the cascades' float32 differences into ~0.08 deg;
# held here on the track step too)
POSES_ATOL, SCORES_ATOL = 5e-5, 2e-3
MAX_ROT_DEG, MAX_TRANS_M = 0.5, 2e-4
SETTING = dict(frames=2, shorter_side=240, prune_to=4, max_hypotheses=N_HYPOTHESES)


def _recording(cls, poses, cascade):
    """@cls with 32x32 coarse renders, recording every returned pose and the
    register cascade's sorted poses and scores."""

    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, coarse_hw=(32, 32), **kw)

        def register(self, *args, **kw):
            poses.append(np.array(super().register(*args, **kw)))
            cascade.append((np.array(self.poses), np.array(self.scores)))
            return poses[-1]

        def track_one(self, *args, **kw):
            poses.append(np.array(super().track_one(*args, **kw)))
            return poses[-1]

    return Recording


def test_campaign_matches_jax(tmp_path, monkeypatch):
    jr, js, tr, ts = load_predictors()
    scene = tconvert.main(os.path.join(REPO, "demo_data", "synth_box"), str(tmp_path), obj_id=1)
    j_poses, t_poses, j_cascade, t_cascade = [], [], [], []
    monkeypatch.setattr(jpredict, "PoseRefinePredictor", lambda **_: jr)
    monkeypatch.setattr(jpredict, "ScorePredictor", lambda **_: js)
    monkeypatch.setattr(jestimater, "FoundationPose", _recording(jestimater.FoundationPose,
                                                                 j_poses, j_cascade))
    monkeypatch.setattr(testimater, "FoundationPose", _recording(testimater.FoundationPose,
                                                                 t_poses, t_cascade))
    want = jrun_bop.main(scene, **SETTING)
    got = trun_bop.main(scene, device="cpu", refiner=tr, scorer=ts, **SETTING)
    assert set(got) == set(want)
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
    assert abs(got["adds_auc_0.1d"] - want["adds_auc_0.1d"]) < 0.01  # AUC steps of 1 mm
    assert got["diameter_m"] == pytest.approx(want["diameter_m"], rel=0, abs=1e-12)
