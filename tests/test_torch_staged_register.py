"""The staged register path of the port (`FoundationPose.register` at
debug >= 2: refine and score as separate `PoseRefinePredictor.predict` /
`ScorePredictor.predict` calls) against the JAX engine's staged path and
against the port's fused cascade, the scorer's multi-chunk tournament, and
the refiner's crop visualisation.

Bundled weights in float32 on both sides, 8 hypotheses, 64x64 crops (32x32
coarse), the depth and track polishes off, as tests/test_torch_switches.py
runs FoundationPose; its tolerances: top pose 1e-3 (POSE_ATOL), scores 5e-3
(SCORE_ATOL)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models import predict as jp
from sixdof_tpu_torch.estimater import FoundationPose as TFP
from sixdof_tpu_torch.io.mesh_io import load_mesh as t_load
from sixdof_tpu_torch.io.png import read_png
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models import predict as tp
from sixdof_tpu_torch.ops.geometry import depth2xyzmap as t_xyz
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays as t_arrays

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
MESH = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
POSE_ATOL, SCORE_ATOL = 1e-3, 5e-3
# the refiner's crops are float32 renders x 255 cut to uint8: a level where
# the two packages' float32 values straddle an integer
VIS_LEVELS, VIS_SHARE = 1, 0.999


@pytest.fixture(scope="module")
def nets():
    os.environ["SIXDOF_AOT_CACHE"] = ""
    cfg = {"input_resize": (64, 64)}
    jr = jp.PoseRefinePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=jnp.float32)
    js = jp.ScorePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                           compute_dtype=jnp.float32)
    tr = tp.PoseRefinePredictor("cpu", cfg=cfg, params=jax.tree.map(np.asarray, jr.params),
                                compute_dtype=torch.float32)
    ts = tp.ScorePredictor("cpu", cfg=cfg, params=jax.tree.map(np.asarray, js.params),
                           compute_dtype=torch.float32)
    reader = DataReader(SCENE, shorter_side=240)
    color, depth = reader.get_color(0), reader.get_depth(0)
    frame = dict(K=reader.color_K, rgb=color, depth=depth,
                 ob_mask=reader.get_mask(color, 0).astype(bool))
    return jr, js, tr, ts, frame


def _engines(nets, tmp_path, **kw):
    jr, js, tr, ts, _ = nets
    base = dict(coarse_hw=(32, 32), depth_polish=False, track_polish=False, track_crop=False,
                **kw)
    jm, tm = j_load(MESH), t_load(MESH)
    jest = JFP(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm, scorer=js,
               refiner=jr, debug=2, debug_dir=str(tmp_path / "jax"), **base)
    staged = TFP(model_pts=tm.vertices, model_normals=tm.vertex_normals, mesh=tm, device="cpu",
                 refiner=tr, scorer=ts, debug=2, debug_dir=str(tmp_path / "port"), **base)
    fused = TFP(model_pts=tm.vertices, model_normals=tm.vertex_normals, mesh=tm, device="cpu",
                refiner=tr, scorer=ts, **base)
    step = len(jest.rot_grid) // 8
    for e in (jest, staged, fused):
        e.rot_grid = e.rot_grid[::step][:8]
    return jest, staged, fused


@pytest.mark.parametrize("kw", [
    dict(prune_to=4),
    dict(prune_schedule=((1, 6), (1, 4))),
    dict(prune_to=4, polish_top=2, polish_iters=1),
], ids=["prune_to", "prune_schedule", "polish_top"])
def test_staged_register_matches_jax_and_fused(nets, tmp_path, kw):
    jest, staged, fused = _engines(nets, tmp_path, **kw)
    frame = nets[4]
    pj = jest.register(iteration=4, **frame)
    pt = staged.register(iteration=4, **frame)
    pf = fused.register(iteration=4, **frame)
    n = 6 if "polish_top" in kw else 4
    assert staged.poses.shape == jest.poses.shape == fused.poses.shape == (n, 4, 4)
    np.testing.assert_allclose(staged.poses[0], jest.poses[0], atol=POSE_ATOL)
    np.testing.assert_allclose(staged.scores, jest.scores, atol=SCORE_ATOL)
    np.testing.assert_allclose(pt, pj, atol=POSE_ATOL)
    np.testing.assert_allclose(staged.poses[0], fused.poses[0], atol=POSE_ATOL)
    np.testing.assert_allclose(staged.scores, fused.scores, atol=SCORE_ATOL)
    np.testing.assert_allclose(pt, pf, atol=POSE_ATOL)
    # the refiner's crops of the final refine's 4 poses: a 74x143 row a pose
    # (render | real, 64x64 each, 5 px padding), stacked with 5 px padding
    vis_t = read_png(str(tmp_path / "port" / "vis_refiner.png"))
    vis_j = read_png(str(tmp_path / "jax" / "vis_refiner.png"))
    assert vis_t.shape == vis_j.shape == (5 + 4 * (74 + 5), 5 + 143 + 5, 3)
    diff = np.abs(vis_t.astype(int) - vis_j.astype(int))
    assert diff.max() <= VIS_LEVELS and (diff == 0).mean() >= VIS_SHARE


def test_predictors_predict_match_jax(nets):
    """One refine call and one score call through the predictors' JAX
    keyword API; more poses than the scorer's max_batch go through the
    tournament, as in the JAX predictor."""
    jr, js, tr, ts, frame = nets
    from sixdof_tpu.ops.geometry import depth2xyzmap as j_xyz
    from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays

    jm, tm = j_load(MESH), t_load(MESH)
    c = (jm.vertices.max(0) + jm.vertices.min(0)) / 2
    jm.vertices, tm.vertices = jm.vertices - c, tm.vertices - c
    reader = DataReader(SCENE, shorter_side=240)
    gt = reader.get_gt_pose(0).copy()
    gt[:3, 3] += gt[:3, :3] @ c
    rng = np.random.RandomState(0)
    poses = np.tile(gt, (5, 1, 1)).astype(np.float32)
    poses[:, :3, 3] += rng.randn(5, 3).astype(np.float32) * 0.01
    depth = frame["depth"].astype(np.float32)
    K = frame["K"].astype(np.float32)
    common = dict(rgb=frame["rgb"], K=K, mesh_diameter=0.1, backface_cull=True)
    rj, vj = jr.predict(depth=depth, ob_in_cams=poses, xyz_map=j_xyz(jnp.asarray(depth), K),
                        mesh_tensors=j_arrays(jm), iteration=2, get_vis=True, **common)
    rt, vt = tr.predict(depth=depth, ob_in_cams=poses,
                        xyz_map=t_xyz(torch.tensor(depth), torch.tensor(K)),
                        mesh_tensors=t_arrays(tm, "cpu"), iteration=2, get_vis=True, **common)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=POSE_ATOL)
    assert vt.shape == vj.shape and np.abs(vt.astype(int) - vj.astype(int)).max() <= VIS_LEVELS
    for max_batch in (None, 2):
        js.cfg["max_batch"] = ts.cfg["max_batch"] = max_batch
        try:
            sj, _ = js.predict(depth=depth, ob_in_cams=np.asarray(rj), mesh_tensors=j_arrays(jm),
                               **common)
            st, _ = ts.predict(depth=depth, ob_in_cams=rt, mesh_tensors=t_arrays(tm, "cpu"),
                               **common)
        finally:
            js.cfg.pop("max_batch")
            ts.cfg.pop("max_batch")
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SCORE_ATOL)
        assert int(np.argmax(st.numpy())) == int(np.argmax(np.asarray(sj)))
    assert js.cfg.get("score_mode") == ts.cfg.get("score_mode") == "hybrid"


@pytest.mark.parametrize("n,max_batch", [(10, 4), (9, 3), (7, 2), (4, 4), (17, 5)])
def test_tournament_matches_jax(n, max_batch):
    """tests/test_estimater.py::test_scorer_tournament_multichunk's inputs
    (pose i carries its id in [0,0]; quality given), and others: the same
    survivors in every round and the same scores, bit for bit."""
    quality = np.array([0.1, 0.5, 0.2, 0.9, 0.3, 0.8, 0.4, 3.0, 0.6, 0.7])
    quality = np.concatenate([quality, np.random.RandomState(n).rand(max(0, n - 10))])[:n]
    poses = np.zeros((n, 4, 4), dtype=np.float32)
    poses[:, 0, 0] = np.arange(n)
    calls = {"jax": [], "port": []}

    def score_fn(key, as_tensor):
        def fn(p):
            ids = np.asarray(p)[:, 0, 0].astype(int)
            calls[key].append(ids.copy())
            q = quality[ids].astype(np.float32)
            return torch.from_numpy(q) if as_tensor else jnp.asarray(q)
        return fn

    sj = np.asarray(jp.ScorePredictor._tournament(score_fn("jax", False), poses, max_batch))
    st = tp.ScorePredictor._tournament(score_fn("port", True), poses, max_batch)
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), sj)
    assert len(calls["port"]) == len(calls["jax"])
    for a, b in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(a, b)
    assert int(np.argmax(sj)) == int(np.argmax(quality))
