"""The pose server on synth_clutter: the port's FoundationPose against the
JAX one (setup: tests/torch_parity_setup.py).

Compared: the cascade's sorted poses and scores before the depth polish,
and two tracked frames from the annotated pose of frame 0.  Not compared:
the registered pose.  There the register depth polish (`_depth_polish`, no
guard) starts from a wrong top pose and is chaotic in both packages, so
cascades that agree to 1.5e-6 end tens of degrees apart (ROADMAP.md, known
behaviours of the reference)."""
import numpy as np
import torch

from torch_parity_setup import TRACK_ITERS, engines, load_predictors, register_both, rot_deg

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# The cascades agree to 1.5e-6 in the sorted poses and 3e-5 in the scores
# on the CPU (float32 sums in another order); bounds about 30x that.
POSES_ATOL, SCORES_ATOL = 5e-5, 1e-3
# The track step, which decodes and filters the frame as the JAX track
# program does (tests/test_torch_track_decode.py): 4.6e-5 and 9.4e-5 deg,
# 7.1e-8 and 2.1e-7 m after frames 1 and 2 on the CPU; bounds 10x and more.
TRACK_ROT_DEG, TRACK_TRANS_M = 1e-3, 5e-6


def test_cascade_and_track_match_jax(tmp_path):
    jest, test, reader = engines(load_predictors(), "synth_clutter", tmp_path)
    register_both(jest, test, reader)
    np.testing.assert_allclose(test.scores, jest.scores, atol=SCORES_ATOL)
    np.testing.assert_allclose(test.poses[1:], jest.poses[1:], atol=POSES_ATOL)

    # Both track from the annotated pose of frame 0 (per the centred mesh).
    start = reader.get_gt_pose(0) @ np.linalg.inv(test.get_tf_to_centered_mesh())
    for est in (jest, test):
        est.pose_last = start.copy()
        est._crop_pose_host = start.copy()
        est._crop_size = None
        est._pose_hist.clear()
        est._last_center_px = None
    K = reader.color_K
    for i in (1, 2):
        color, depth = reader.get_color(i), reader.get_depth(i)
        qj = jest.track_one(rgb=color, depth=depth, K=K, iteration=TRACK_ITERS)
        qt = test.track_one(rgb=color, depth=depth, K=K, iteration=TRACK_ITERS)
        assert rot_deg(qt[:3, :3], qj[:3, :3]) < TRACK_ROT_DEG, i
        assert np.linalg.norm(qt[:3, 3] - qj[:3, 3]) < TRACK_TRANS_M, i
