"""Calls written against the JAX engine's and ICP pipeline's signatures,
run on the port and on the JAX package on the CPU: positional `register`
(ob_id and glctx before iteration), `track_one(..., extra)` at debug 2
(the refiner's visualisation of the tracked pose), the ICP functions in
JAX's argument order without their device clouds or capture context, and
the smaller helpers whose parameters the port lacked.

Bundled weights in float32 on both sides, 8 hypotheses, 64x64 crops (32x32
coarse), the depth and track polishes off, as
tests/test_torch_staged_register.py runs the engines, with its
tolerances (pose 1e-3, vis within 1 level on 99.9% of pixels); the ICP
comparisons use tests/test_torch_capture.py's (0.3 deg, 2 mm, fitness
0.01)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.models import predict as jp
from sixdof_tpu.ops import geometry as jgeo
from sixdof_tpu.ops import hypotheses as jhyp
from sixdof_tpu.utils import logging_utils as jlog
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.app.defect_projection import compute_rays, heatmap_to_points
from sixdof_tpu_torch.estimater import FoundationPose as TFP
from sixdof_tpu_torch.estimater import PendingPose
from sixdof_tpu_torch.io import mesh_io as tmio
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models import predict as tp
from sixdof_tpu_torch.ops import geometry as tgeo
from sixdof_tpu_torch.ops import hypotheses as thyp
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
from sixdof_tpu_torch.parallel import train as T
from sixdof_tpu_torch.utils import logging_utils as tlog

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
MESH = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
POSE_ATOL = 1e-3
VIS_LEVELS, VIS_SHARE = 1, 0.999
ROT_DEG, TRANS_MM, FIT_ATOL = 0.3, 2.0, 0.01


def _rot_deg(a, b):
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(min(1.0, chord)))


def _assert_tf_close(a, b):
    assert _rot_deg(a, b) < ROT_DEG
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < TRANS_MM


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX and the port engine at debug 2 on synth_box frame 0, each
    registered by a positional call, the port's also by keywords; then
    frame 1 tracked with an `extra` dict, positionally, from one pose."""
    os.environ["SIXDOF_AOT_CACHE"] = ""
    tmp = tmp_path_factory.mktemp("engines")
    cfg = {"input_resize": (64, 64)}
    jr = jp.PoseRefinePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=jnp.float32)
    js = jp.ScorePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                           compute_dtype=jnp.float32)
    tr = tp.PoseRefinePredictor("cpu", cfg=cfg, params=jax.tree.map(np.asarray, jr.params),
                                compute_dtype=torch.float32)
    ts = tp.ScorePredictor("cpu", cfg=cfg, params=jax.tree.map(np.asarray, js.params),
                           compute_dtype=torch.float32)
    base = dict(coarse_hw=(32, 32), depth_polish=False, track_polish=False, track_crop=False,
                prune_to=4, debug=2)
    jm, tm = jmio.load_mesh(MESH), tmio.load_mesh(MESH)
    # JAX's positional order: ..., scorer, refiner, glctx, debug, debug_dir
    jest = JFP(jm.vertices, jm.vertex_normals, None, jm, js, jr, None,
               debug_dir=str(tmp / "jax"), **base)
    test = TFP(tm.vertices, tm.vertex_normals, None, tm, ts, tr, None,
               debug_dir=str(tmp / "port"), device="cpu", **base)
    for e in (jest, test):
        e.rot_grid = e.rot_grid[::len(e.rot_grid) // 8][:8]
    reader = DataReader(SCENE, shorter_side=240)
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    K = reader.color_K
    out = dict(reader=reader, jest=jest, test=test)
    out["jax"] = jest.register(K, color, depth, mask, None, None, 4)
    out["port"] = test.register(K, color, depth, mask, None, None, 4)
    out["port_kw"] = test.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=4)
    out["port_id"] = test.register(K, color, depth, mask, 7, None, 4)
    out["ob_id"] = test.ob_id
    # frame 1 from one pose (JAX's register) on both sides
    start = jest.pose_last
    test.pose_last = np.asarray(start, dtype=np.float64)
    c1, d1 = reader.get_color(1), reader.get_depth(1)
    out["extra_j"], out["extra_t"] = {}, {}
    out["track_j"] = jest.track_one(c1, d1, K, 2, out["extra_j"])
    out["track_t"] = test.track_one(c1, d1, K, 2, out["extra_t"])
    return out


def test_positional_register_takes_ob_id_and_glctx(engines):
    np.testing.assert_array_equal(engines["port"], engines["port_kw"])
    np.testing.assert_array_equal(engines["port"], engines["port_id"])
    assert engines["ob_id"] == 7
    np.testing.assert_allclose(engines["port"], engines["jax"], atol=POSE_ATOL)


def test_track_one_fills_extra_with_the_refiner_vis(engines):
    tj, tt = engines["track_j"], engines["track_t"]
    assert isinstance(tt, np.ndarray) and tt.shape == (4, 4)  # not a PendingPose
    np.testing.assert_allclose(tt, tj, atol=POSE_ATOL)
    vj, vt = np.asarray(engines["extra_j"]["vis"]), engines["extra_t"]["vis"]
    assert vt.shape == vj.shape and vt.dtype == vj.dtype
    diff = np.abs(vt.astype(int) - vj.astype(int))
    assert diff.max() <= VIS_LEVELS and (diff == 0).mean() >= VIS_SHARE


def test_engine_helpers_take_jax_parameters(engines):
    test, reader = engines["test"], engines["reader"]
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    hyp = test.generate_random_pose_hypo(reader.color_K, color, depth, mask, None)
    np.testing.assert_array_equal(hyp, engines["jest"].generate_random_pose_hypo(
        reader.color_K, color, depth, mask, None))
    pending = PendingPose(dev=torch.eye(4).reshape(1, 4, 4), tf_to_centered_mesh=np.eye(4))
    np.testing.assert_array_equal(pending.numpy(), np.eye(4))


@pytest.fixture(scope="module")
def clouds():
    """Frame 0's processed source and the processed model cloud, the seed
    from the annotated pose (as tests/test_torch_capture.py)."""
    r = DataReader(SCENE)
    p = r.parameters
    tgt, _ = tip.preprocess_target(r.target.copy(), p)
    src, _, _ = tip.preprocess_source(r.get_source(0), r.background, p, i=0)
    init = r.color_to_depth @ r.scale_translation_to_millimeters(r.get_gt_pose(0))
    return dict(reader=r, params=p, src=src, tgt=tgt, init=init,
                jsrc=jmio.PointCloud(src.points),
                jtgt=jmio.PointCloud(tgt.points, normals=tgt.normals))


def test_icp_functions_in_jax_order(clouds):
    c = clouds
    zj = jip.predict_z_axis_adjustment(c["jsrc"], c["jtgt"], c["init"], c["params"])
    zt = tip.predict_z_axis_adjustment(c["src"], c["tgt"], c["init"], c["params"],
                                       device="cpu")
    assert zt[0] == zj[0] and abs(zt[1] - zj[1]) < FIT_ATOL
    rj = jip.improve_result(c["jsrc"], c["jtgt"], c["init"], c["params"])
    rt = tip.improve_result(c["src"], c["tgt"], c["init"], c["params"], device="cpu")
    assert rt.fitness > 0.9 and abs(rt.fitness - rj.fitness) < FIT_ATOL
    _assert_tf_close(rt.transformation, rj.transformation)
    # the caller's device clouds give the same result, bit for bit
    dc = tip._DeviceClouds(c["src"], c["tgt"], torch.device("cpu"))
    rc = tip.improve_result(c["src"], c["tgt"], c["init"], c["params"], None, 0, dc)
    np.testing.assert_array_equal(rc.transformation, rt.transformation)
    assert (rc.fitness, rc.inlier_rmse) == (rt.fitness, rt.inlier_rmse)


def test_capture_event_without_a_context(clouds):
    """capture_event in JAX's order, with n_restarts and seed by position
    and no context: equal to the call with one, and to JAX's."""
    c = clouds
    r = c["reader"]
    heatmap = r.get_heatmap(r.get_color(0))[0]
    rays, inten = compute_rays(heatmap_to_points(heatmap, 0.75), r.color_pinhole)
    mask = np.ones(len(rays), bool)
    args = (c["init"].copy(), c["params"], r.target_mesh, rays, mask, inten, r.color_to_depth)
    ctx = tip.CaptureContext(c["tgt"], r.target_mesh, r.color_to_depth, device="cpu")
    with_ctx, pcd_ctx = tip.capture_event(c["src"], c["tgt"], *args, 4, 0, ctx=ctx)
    bare, pcd = tip.capture_event(c["src"], c["tgt"], *args, 4, 0, device="cpu")
    dc = tip._DeviceClouds(c["src"], c["tgt"], torch.device("cpu"))
    from_dc, pcd_dc = tip.capture_event(c["src"], c["tgt"], *args, 4, 0, dc)
    for res, p in ((bare, pcd), (from_dc, pcd_dc)):
        np.testing.assert_array_equal(res.transformation, with_ctx.transformation)
        np.testing.assert_array_equal(p.points, pcd_ctx.points)
    rj, pj = jip.capture_event(c["jsrc"], c["jtgt"], c["init"].copy(), c["params"],
                               jmio.TriMesh(r.target_mesh.vertices, r.target_mesh.faces),
                               rays, mask, inten, r.color_to_depth, 4, 0)
    assert abs(bare.fitness - rj.fitness) < FIT_ATOL
    _assert_tf_close(bare.transformation, rj.transformation)
    assert abs(len(pcd) - len(pj)) <= 1 and len(pcd) > 100


@pytest.mark.parametrize("subdivisions,radius", [(1, 1.0), (2, 0.5), (3, 2.0)])
def test_icosphere_and_views_take_radius(subdivisions, radius):
    vt, ft = thyp.icosphere(subdivisions, radius)
    vj, fj = jhyp.icosphere(subdivisions, radius)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(thyp.sample_views_icosphere(10, subdivisions, radius),
                                  jhyp.sample_views_icosphere(10, subdivisions, radius))
    np.testing.assert_array_equal(thyp.sample_views_icosphere(50, None, radius),
                                  jhyp.sample_views_icosphere(50, None, radius))


def test_glcam_in_cvcam_and_set_seed():
    np.testing.assert_array_equal(tgeo.GLCAM_IN_CVCAM, jgeo.GLCAM_IN_CVCAM)
    import random

    draws = []
    for set_seed in (jlog.set_seed, tlog.set_seed):
        set_seed(5)
        draws.append((np.random.rand(3).tolist(), random.random()))
    assert draws[0] == draws[1]
    tlog.set_seed(5)
    a = torch.rand(3)
    tlog.set_seed(5)
    assert torch.equal(a, torch.rand(3))


@pytest.mark.parametrize("cls,net", [(T.RefinerTrainer, tn.RefineNet),
                                     (T.ScorerTrainer, tn.ScoreNetMultiPair)])
def test_trainer_train_returns_the_step_losses(cls, net):
    """train(n_steps, generator, log_every) gives the losses of as many
    steps on the same draws; the trainer takes JAX's order (device_mesh,
    then params)."""
    v = np.array([[-0.04, -0.03, -0.02], [0.04, -0.03, -0.02], [0.04, 0.03, -0.02],
                  [-0.04, 0.03, -0.02], [-0.04, -0.03, 0.02], [0.04, -0.03, 0.02],
                  [0.04, 0.03, 0.02], [-0.04, 0.03, 0.02]])
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]])
    box = make_mesh_arrays(tmio.TriMesh(v, f), "cpu")
    K = np.array([[300.0, 0, 16], [0, 300.0, 16], [0, 0, 1]])
    cfg = T.TrainConfig(batch_size=2, input_hw=(32, 32), n_hypotheses=2)
    first = cls(net(), box, K, 0.1, cfg, None, None)
    state = {k: v.clone() for k, v in first.model.state_dict().items()}
    losses = first.train(2, torch.Generator().manual_seed(3), 1)
    again = cls(net(), box, K, 0.1, cfg, None, state)
    gen = torch.Generator().manual_seed(3)
    assert losses == [float(again.step(gen)) for _ in range(2)]
