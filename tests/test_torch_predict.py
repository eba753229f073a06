"""Predictors: refine, score, the register cascade and the track polish of
the port against the JAX package, on the demo scene with the bundled
weights, in float32 on both sides, at reduced grids and crop sizes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models import predict as jp
from sixdof_tpu.ops.geometry import depth2xyzmap as j_xyz
from sixdof_tpu.ops.hypotheses import make_rotation_grid
from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays
from sixdof_tpu_torch.io.mesh_io import load_mesh as t_load
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models import predict as tp
from sixdof_tpu_torch.ops.geometry import depth2xyzmap as t_xyz
from sixdof_tpu_torch.ops.lie import so3_exp_map
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays as t_arrays

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
TN, RN = 0.02, 0.3490658503988659


@pytest.fixture(scope="module")
def setup():
    jr = jp.PoseRefinePredictor(ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=jnp.float32)
    js = jp.ScorePredictor(ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                           compute_dtype=jnp.float32)
    tr = tp.PoseRefinePredictor("cpu", params=jax.tree.map(np.asarray, jr.params),
                                compute_dtype=torch.float32)
    ts = tp.ScorePredictor("cpu", params=jax.tree.map(np.asarray, js.params),
                           compute_dtype=torch.float32)
    path = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
    jm, tm = j_load(path), t_load(path)
    c = (jm.vertices.max(0) + jm.vertices.min(0)) / 2
    jm.vertices = jm.vertices - c
    tm.vertices = tm.vertices - c
    reader = DataReader(SCENE, shorter_side=240)
    rgb, depth = reader.get_color(0), reader.get_depth(0).astype(np.float32)
    K = reader.color_K.astype(np.float32)
    gt = reader.get_gt_pose(0).copy()
    gt[:3, 3] += gt[:3, :3] @ c  # the centred mesh's pose
    return dict(jr=jr, js=js, tr=tr, ts=ts, jm=j_arrays(jm), tm=t_arrays(tm, "cpu"), rgb=rgb,
                depth=depth, K=K, gt=gt.astype(np.float32), diameter=0.1)


def _near_gt(s, n, seed):
    rng = np.random.RandomState(seed)
    d = so3_exp_map(torch.tensor(rng.randn(n, 3) * 0.15, dtype=torch.float32)).numpy()
    poses = np.tile(s["gt"], (n, 1, 1))
    poses[:, :3, :3] = d @ poses[:, :3, :3]
    poses[:, :3, 3] += rng.randn(n, 3) * 0.005
    return poses


def _inputs(s):
    rj, rt = jp.to_rgb01(s["rgb"]), tp.to_rgb01(s["rgb"], "cpu")
    xj = j_xyz(jnp.asarray(s["depth"]), jnp.asarray(s["K"]))
    xt = t_xyz(torch.tensor(s["depth"]), torch.tensor(s["K"]))
    return rj, rt, xj, xt


def test_refine_poses_matches_jax(setup):
    s = setup
    rj, rt, xj, xt = _inputs(s)
    poses = _near_gt(s, 5, 0)
    ref = jp.refine_poses_jit(s["jr"].model, s["jr"].params, s["jm"], jnp.asarray(poses), rj, xj,
                              jnp.asarray(s["K"]), s["diameter"], 1.2, TN, RN, 2, (48, 48),
                              backface_cull=True)
    got = tp.refine_poses(s["tr"].model, s["tm"], torch.tensor(poses), rt, xt,
                          torch.tensor(s["K"]), s["diameter"], 1.2, TN, RN, 2, (48, 48),
                          backface_cull=True, compute_dtype=torch.float32)
    assert np.abs(np.asarray(ref) - poses).max() > 1e-3  # the refiner moved them
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("mode", ["network", "depth", "hybrid"])
def test_score_poses_matches_jax(setup, mode):
    s = setup
    rj, rt, xj, xt = _inputs(s)
    poses = _near_gt(s, 6, 1)
    ref = jp.score_poses_jit(s["js"].model, s["js"].params, s["jm"], jnp.asarray(poses), rj, xj,
                             jnp.asarray(s["K"]), s["diameter"], 1.2, out_hw=(48, 48), mode=mode,
                             backface_cull=True)
    got = tp.score_poses(s["ts"].model, s["tm"], torch.tensor(poses), rt, xt,
                         torch.tensor(s["K"]), s["diameter"], 1.2, out_hw=(48, 48), mode=mode,
                         backface_cull=True, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)
    np.testing.assert_array_equal(np.argsort(-got.numpy()), np.argsort(-np.asarray(ref)))


def test_register_cascade_top1_matches_jax(setup):
    s = setup
    grid = make_rotation_grid()[::21][:12].copy()
    grid[:, :3, 3] = s["gt"][:3, 3]
    kw = dict(prune_to=4, coarse_iters=1, iterations=3, out_hw=(48, 48), coarse_hw=(32, 32),
              backface_cull=True)
    pj, sj = jp.register_pipeline_jit(
        s["jr"].model, s["jr"].params, s["js"].model, s["js"].params, s["jm"], jnp.asarray(grid),
        jp.to_rgb01(s["rgb"]), jnp.asarray(s["depth"]), jnp.asarray(s["K"]), s["diameter"], 1.2,
        TN, RN, **kw)
    pt, st = tp.register_pipeline(
        s["tr"].model, s["ts"].model, s["tm"], torch.tensor(grid), tp.to_rgb01(s["rgb"], "cpu"),
        torch.tensor(s["depth"]), torch.tensor(s["K"]), s["diameter"], 1.2, TN, RN,
        compute_dtype=torch.float32, **kw)
    assert pt.shape == (4, 4, 4)
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj)[0], atol=1e-3)  # same top-1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-3)


def test_track_depth_polish_matches_jax(setup):
    s = setup
    rj, rt, xj, xt = _inputs(s)
    pose = _near_gt(s, 1, 2)
    mesh = t_load(os.path.join(SCENE, "mesh", "model_scaled_down.obj"))
    mesh.vertices -= (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    dense = mesh.sample_points(1024, seed=1)
    tgt, n = dense.points.astype(np.float32), dense.normals.astype(np.float32)
    mask = np.ones(len(tgt), bool)
    ref = jp._track_depth_polish(s["jm"], jnp.asarray(pose), rj, xj, jnp.asarray(s["K"]), 1.2,
                                 jnp.asarray(tgt), jnp.asarray(n), jnp.asarray(mask),
                                 s["diameter"], backface_cull=True)
    got = tp._track_depth_polish(s["tm"], torch.tensor(pose), rt, xt, torch.tensor(s["K"]), 1.2,
                                 torch.tensor(tgt), torch.tensor(n), torch.tensor(mask),
                                 s["diameter"], backface_cull=True)
    assert np.abs(np.asarray(ref) - pose).max() > 1e-4  # the polish applied a correction
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("normalize_xyz,occ_sub", [(True, False), (False, True), (False, 0.9)])
def test_make_AB_variants_match_jax(setup, normalize_xyz, occ_sub):
    """Radius-normalised xyz inputs and the occluder substitution."""
    s = setup
    rj, rt, xj, xt = _inputs(s)
    poses = _near_gt(s, 4, 3)
    poses[1, 2, 3] += 0.02  # one hypothesis behind the observed surface
    A_j, B_j, _, rend_j = jp._make_AB(s["jm"], jnp.asarray(poses), rj, xj, jnp.asarray(s["K"]),
                                      1.2, s["diameter"], (40, 40), normalize_xyz, 0.001,
                                      backface_cull=True, occ_sub=occ_sub)
    A_t, B_t, _, rend_t = tp._make_AB(s["tm"], torch.tensor(poses), rt, xt, torch.tensor(s["K"]),
                                      1.2, s["diameter"], (40, 40), normalize_xyz, 0.001,
                                      backface_cull=True, occ_sub=occ_sub)
    # renders may differ on pixels whose centre lies on a triangle edge
    # (<= 0.2%, as in test_torch_rasterize.py); B inherits them through the
    # substitution
    for got, ref in ((A_t, A_j), (B_t, B_j)):
        assert (np.abs(got.numpy() - np.asarray(ref)) > 2e-3).mean() <= 0.002
    np.testing.assert_array_equal(rend_t["obs_validB"].numpy(), np.asarray(rend_j["obs_validB"]))


def test_refine_rot_6d_matches_jax(setup):
    """The 6D rotation head (rot_rep='6d'), on seeded flax parameters."""
    from sixdof_tpu.models.networks import RefineNet as JRefine

    s = setup
    rj, rt, xj, xt = _inputs(s)
    jnet = JRefine(c_in=6, rot_rep="6d")
    x = jnp.zeros((1, 32, 32, 6))
    params = jnet.init(jax.random.PRNGKey(0), x, x)["params"]
    params = jax.tree.map(lambda a: a, params)
    params["rot_linear"]["kernel"] = jax.random.normal(jax.random.PRNGKey(1), (512, 6)) * 0.01
    params["rot_linear"]["bias"] = jnp.asarray([1.0, 0, 0, 0, 1.0, 0])  # near identity
    tr = tp.PoseRefinePredictor("cpu", cfg={"rot_rep": "6d"},
                                params=jax.tree.map(np.asarray, params),
                                compute_dtype=torch.float32)
    poses = _near_gt(s, 3, 4)
    ref = jp.refine_poses_jit(jnet, params, s["jm"], jnp.asarray(poses), rj, xj,
                              jnp.asarray(s["K"]), s["diameter"], 1.2, TN, RN, 1, (32, 32),
                              rot_rep="6d", backface_cull=True)
    got = tp.refine_poses(tr.model, s["tm"], torch.tensor(poses), rt, xt, torch.tensor(s["K"]),
                          s["diameter"], 1.2, TN, RN, 1, (32, 32), rot_rep="6d",
                          backface_cull=True, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
