"""The `--icp` global registration of the port against the JAX package:
FPFH features, the batched Kabsch fit, RANSAC over feature matches
(`ops/features.py`), `refine_registration`, `determine_pose` on both of its
branches, and the standalone demo's inputs.

The features and the RANSAC trials are host float64 numpy in both packages
with the same seeded draw: features to 1e-12, the chosen trial, its fitness
and rmse exactly, and the same count of valid trials.  The ICP that follows
is float32: on the synthetic cloud of tests/test_icp_pipeline.py the final
pose agrees to 1e-3 deg and 1e-3 mm; on synth_box, where the ICP runs long
on a nearly symmetric box, to tests/test_torch_capture.py's 0.3 deg / 2 mm
and fitness 0.01 (ROADMAP.md, "ICP sensitivity")."""
import copy
import logging
import os
import re

import numpy as np
import pytest
import torch

from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.ops import features as jfeat
from sixdof_tpu.ops import pointcloud as jpc
from sixdof_tpu.ops.lie import euler_matrix
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.io import mesh_io as tmio
from sixdof_tpu_torch.ops import features as tfeat
from sixdof_tpu_torch.ops import pointcloud as tpc
from test_icp_pipeline import ICP_PARAMS, make_object_cloud, make_scene

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
FPFH_ATOL = 1e-12
SYNTH_DEG, SYNTH_MM = 1e-3, 1e-3
BOX_DEG, BOX_MM, FIT_ATOL = 0.3, 2.0, 0.01
# fewer restarts and iterations than the defaults: the comparison, not the
# search, is under test
PARAMS = dict(ICP_PARAMS, run_icp=dict(ICP_PARAMS["run_icp"], n_restarts=8, max_iter=10))


def _rot_deg(a, b):
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord))))


def _valid_trials(caplog):
    """The JAX package's count of valid RANSAC trials, from its log."""
    return [int(n) for n in re.findall(r"over (\d+) valid trials", caplog.text)]


@pytest.fixture(scope="module")
def clouds():
    """tests/test_icp_pipeline.py::test_global_registration_roughly_aligns's
    clouds: a half-ellipsoid posed by a known transform, another sampling
    of it, normals estimated."""
    rng = np.random.RandomState(0)
    true_tf = euler_matrix(0.3, 0.2, 1.0)
    true_tf[:3, 3] = [30, -20, 50.0]
    obj = make_object_cloud(rng, 1500)
    src = obj @ true_tf[:3, :3].T + true_tf[:3, 3]
    tgt = make_object_cloud(rng, 1500)
    out = {}
    for key, mio, pc in (("jax", jmio, jpc), ("port", tmio, tpc)):
        s, t = mio.PointCloud(src.copy()), mio.PointCloud(tgt.copy())
        pc.estimate_normals(s, radius=8, max_nn=12)
        pc.estimate_normals(t, radius=8, max_nn=12)
        out[key] = (s, t)
    return true_tf, out


def test_fpfh_and_ransac_match_jax(clouds, caplog):
    _, c = clouds
    (js, jt), (ts, tt) = c["jax"], c["port"]
    np.testing.assert_array_equal(ts.normals, js.normals)
    feats = {}
    for key, feat, (s, t) in (("jax", jfeat, c["jax"]), ("port", tfeat, c["port"])):
        feats[key] = (feat.compute_fpfh(s, radius=15.0, max_nn=40),
                      feat.compute_fpfh(t, radius=15.0, max_nn=40))
    for a, b in zip(feats["port"], feats["jax"]):
        assert a.shape == b.shape == (1500, 33)
        np.testing.assert_allclose(a, b, rtol=0, atol=FPFH_ATOL)
    with caplog.at_level(logging.INFO):
        rj = jfeat.execute_global_registration(js, jt, *feats["jax"], ICP_PARAMS)
    rt = tfeat.execute_global_registration(ts, tt, *feats["port"], ICP_PARAMS)
    assert isinstance(rt, tip.RegistrationResult)
    np.testing.assert_array_equal(rt.transformation, rj.transformation)
    assert (rt.fitness, rt.inlier_rmse) == (rj.fitness, rj.inlier_rmse)
    assert rt.fitness > 0.2 and [rt.valid_trials] == _valid_trials(caplog)
    assert rt.valid_trials > 0


def test_kabsch_matches_jax():
    rng = np.random.RandomState(1)
    src, tgt = rng.randn(50, 3, 3), rng.randn(50, 3, 3)
    np.testing.assert_array_equal(tfeat._kabsch_batch(src, tgt), jfeat._kabsch_batch(src, tgt))


def test_refine_registration_matches_jax(clouds):
    true_tf, c = clouds
    init = np.linalg.inv(true_tf) @ euler_matrix(0.03, -0.02, 0.02)
    init[:3, 3] += [2.0, -1.0, 1.5]
    rj = jip.refine_registration(*c["jax"], init, ICP_PARAMS)
    rt = tip.refine_registration(*c["port"], init, ICP_PARAMS, device="cpu")
    assert _rot_deg(rt.transformation, rj.transformation) < SYNTH_DEG
    assert np.linalg.norm(rt.transformation[:3, 3] - rj.transformation[:3, 3]) < SYNTH_MM
    assert abs(rt.fitness - rj.fitness) < 1e-6 and rt.fitness > 0.9


def test_determine_pose_icp_matches_jax_on_synthetic_scene(caplog):
    """The half-ellipsoid at tests/test_icp_pipeline.py's global-registration
    pose on a plane (its make_scene), registered with no prior pose."""
    true_tf = euler_matrix(0.3, 0.2, 1.0)
    true_tf[:3, 3] = [30, -20, 50.0]
    rng = np.random.RandomState(0)
    source, background = make_scene(rng, true_tf)
    target = make_object_cloud(rng, 3000)
    with caplog.at_level(logging.INFO):
        _, rj, zj, tpj = jip.determine_pose(
            jmio.PointCloud(source.points.copy()), jmio.PointCloud(target.copy()),
            jmio.PointCloud(background.points.copy()), np.eye(4), copy.deepcopy(PARAMS),
            icp=True)
    trials = []
    execute = tfeat.execute_global_registration

    def record(*a, **kw):
        out = execute(*a, **kw)
        trials.append(out.valid_trials)
        return out

    tfeat.execute_global_registration = record
    try:
        _, rt, zt, tpt = tip.determine_pose(
            tmio.PointCloud(source.points.copy()), tmio.PointCloud(target.copy()),
            tmio.PointCloud(background.points.copy()), np.eye(4), copy.deepcopy(PARAMS),
            icp=True, device="cpu")
    finally:
        tfeat.execute_global_registration = execute
    assert zt == zj == 0
    np.testing.assert_array_equal(tpt.points, tpj.points)
    assert trials == _valid_trials(caplog) and trials[0] > 0
    assert _rot_deg(rt.transformation, rj.transformation) < SYNTH_DEG
    assert np.linalg.norm(rt.transformation[:3, 3] - rj.transformation[:3, 3]) < SYNTH_MM
    assert abs(rt.fitness - rj.fitness) < 1e-6
    # it found the object: object -> scene against the true pose
    est = np.linalg.inv(rt.transformation)
    assert rt.fitness > 0.5 and np.linalg.norm(est[:3, 3] - true_tf[:3, 3]) < 5.0


def _small(params, icp):
    """The scene's parameters with 4 restarts of 5 iterations; with @icp
    also cut to 1000 target points, an 8 mm downsample and 2000 RANSAC
    trials (the search is the same)."""
    p = copy.deepcopy(params)
    p["run_icp"].update(n_restarts=4, max_iter=5)
    if icp:
        p["preprocess_target"]["max_pcd"] = 1000
        p["preprocess_source"]["down_sample"] = 8.0
        p["execute_global_registration"]["ransac_criteria"]["iterations"] = 2000
    return p


@pytest.mark.parametrize("icp", [True, False])
def test_determine_pose_on_synth_box_matches_jax(icp, caplog):
    """The demo inputs (demo_data).  --icp: no trial passes the checkers in
    any of the 10 attempts, in both packages; from the annotated pose, at
    the scene's cloud sizes: the same z step and the same registration."""
    jt, js, jb, jinit, jparams = jip.demo_data(SCENE)
    tt, ts, tb, tinit, tparams = tip.demo_data(SCENE)
    assert tparams == jparams
    for a, b in ((tt, jt), (ts, js), (tb, jb)):
        np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(tinit, jinit)
    with caplog.at_level(logging.INFO):
        _, rj, zj, tpj = jip.determine_pose(js, jt, jb, jinit.copy(), _small(jparams, icp), icp=icp)
    _, rt, zt, tpt = tip.determine_pose(ts, tt, tb, tinit.copy(), _small(tparams, icp), icp=icp,
                                        device="cpu")
    assert zt == zj
    np.testing.assert_array_equal(tpt.points, tpj.points)
    assert abs(rt.fitness - rj.fitness) < FIT_ATOL
    if icp:
        assert _valid_trials(caplog) == [0] * 10 and rt.fitness == rj.fitness == 0.0
    else:
        assert rt.fitness > 0.9
    assert _rot_deg(rt.transformation, rj.transformation) < BOX_DEG
    assert np.linalg.norm(rt.transformation[:3, 3] - rj.transformation[:3, 3]) < BOX_MM
