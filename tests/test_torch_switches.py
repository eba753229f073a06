"""The JAX app's register and track switches in the port, each against the
JAX package on the CPU: the progressive prune schedule and the cascade
polish of the register cascade, the DeepIM translation decode, and
FoundationPose with the register depth polish, the track polish and the
track upload crop off.  Bundled weights in float32 on both sides, reduced
grids and crop sizes; tolerances as in tests/test_torch_predict.py and
tests/test_torch_estimater.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models import predict as jp
from sixdof_tpu.ops.geometry import depth2xyzmap as j_xyz
from sixdof_tpu.ops.hypotheses import make_rotation_grid
from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays
from sixdof_tpu_torch.app.run import _parse_prune_schedule, build_parser
from sixdof_tpu_torch.estimater import FoundationPose as TFP
from sixdof_tpu_torch.io.mesh_io import load_mesh as t_load
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
TN, RN = 0.02, 0.3490658503988659
# the register cascade: same top-1 pose and scores as test_torch_predict.py
POSE_ATOL, SCORE_ATOL = 1e-3, 5e-3
# FoundationPose without the depth polishes: the cascades agree to ~1e-5,
# and nothing chaotic follows them; track as in test_torch_estimater.py
REG_ROT_DEG, REG_TRANS_M = 0.05, 1e-4
TRACK_ROT_DEG, TRACK_TRANS_M = 1.5, 1.5e-3


def _rot_deg(R1, R2):
    chord = np.linalg.norm(R1 - R2) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord))))


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
    jm, tm = j_load(MESH), t_load(MESH)
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


@pytest.mark.parametrize("kw", [
    dict(prune_schedule=((1, 8), (1, 4)), iterations=4),
    dict(prune_schedule=((1, 16), (1, 4)), iterations=3),  # stage 1 keeps all: skipped
    dict(prune_to=4, polish_top=4, polish_iters=2, iterations=3),
], ids=["two_stages", "skipped_stage", "polish_top"])
def test_register_cascade_switches_match_jax(setup, kw):
    s = setup
    grid = make_rotation_grid()[::21][:12].copy()
    grid[:, :3, 3] = s["gt"][:3, 3]
    kw = dict(kw, coarse_iters=1, out_hw=(48, 48), coarse_hw=(32, 32), backface_cull=True)
    kw.setdefault("prune_to", 0)
    pj, sj = jp.register_pipeline_jit(
        s["jr"].model, s["jr"].params, s["js"].model, s["js"].params, s["jm"], jnp.asarray(grid),
        jp.to_rgb01(s["rgb"]), jnp.asarray(s["depth"]), jnp.asarray(s["K"]), s["diameter"], 1.2,
        TN, RN, **kw)
    pt, st = tp.register_pipeline(
        s["tr"].model, s["ts"].model, s["tm"], torch.tensor(grid), tp.to_rgb01(s["rgb"], "cpu"),
        torch.tensor(s["depth"]), torch.tensor(s["K"]), s["diameter"], 1.2, TN, RN,
        compute_dtype=torch.float32, **kw)
    expect = {"two_stages": 4, "skipped_stage": 4, "polish_top": 8}
    assert pt.shape == np.asarray(pj).shape
    assert pt.shape[0] in expect.values()
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj)[0], atol=POSE_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SCORE_ATOL)


class _FixedJaxNet:
    """A stand-in for the refiner with fixed outputs (hashable, static)."""

    def __init__(self, trans, rot):
        self.trans, self.rot = trans, rot

    def apply(self, variables, A, B):
        return {"trans": jnp.asarray(self.trans), "rot": jnp.asarray(self.rot)}


@pytest.mark.parametrize("normalize_xyz", [False, True])
def test_deepim_decode_matches_jax(setup, normalize_xyz):
    s = setup
    rng = np.random.RandomState(0)
    n = 5
    poses = np.tile(s["gt"], (n, 1, 1))
    poses[:, :3, 3] += rng.randn(n, 3).astype(np.float32) * 0.01
    # DeepIM outputs: crop-normalised uv offsets and a depth ratio near 1
    trans = np.concatenate([rng.randn(n, 2) * 0.05, 1.0 + rng.randn(n, 1) * 0.05],
                           axis=1).astype(np.float32)
    rot = (rng.randn(n, 3) * 0.3).astype(np.float32)

    def port_net(A, B):
        return {"trans": torch.from_numpy(trans), "rot": torch.from_numpy(rot)}

    xj = j_xyz(jnp.asarray(s["depth"]), jnp.asarray(s["K"]))
    xt = t_xyz(torch.tensor(s["depth"]), torch.tensor(s["K"]))
    ref = jp.refine_poses_jit(_FixedJaxNet(trans, rot), {}, s["jm"], jnp.asarray(poses),
                              jp.to_rgb01(s["rgb"]), xj, jnp.asarray(s["K"]), s["diameter"], 1.2,
                              TN, RN, 2, (48, 48), normalize_xyz=normalize_xyz,
                              trans_rep="deepim", backface_cull=True)
    got = tp.refine_poses(port_net, s["tm"], torch.tensor(poses), tp.to_rgb01(s["rgb"], "cpu"),
                          xt, torch.tensor(s["K"]), s["diameter"], 1.2, TN, RN, 2, (48, 48),
                          normalize_xyz=normalize_xyz, backface_cull=True,
                          compute_dtype=torch.float32, trans_rep="deepim")
    assert np.abs(np.asarray(ref)[:, :3, 3] - poses[:, :3, 3]).max() > 1e-3  # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both FoundationPose engines with the depth polish, the track polish
    and the track upload crop switched off, 8 hypotheses, 64x64 crops."""
    os.environ["SIXDOF_AOT_CACHE"] = ""
    cfg = {"input_resize": (64, 64)}
    jr = jp.PoseRefinePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=jnp.float32)
    js = jp.ScorePredictor(cfg=cfg, ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                           compute_dtype=jnp.float32)
    jm, tm = j_load(MESH), t_load(MESH)
    kw = dict(prune_to=4, coarse_hw=(32, 32), depth_polish=False, track_polish=False,
              track_crop=False)
    jest = JFP(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm, scorer=js,
               refiner=jr, debug_dir=str(tmp_path_factory.mktemp("fp")), **kw)
    test = TFP(model_pts=tm.vertices, model_normals=tm.vertex_normals, mesh=tm, device="cpu",
               refiner=tp.PoseRefinePredictor("cpu", cfg=cfg,
                                              params=jax.tree.map(np.asarray, jr.params),
                                              compute_dtype=torch.float32),
               scorer=tp.ScorePredictor("cpu", cfg=cfg,
                                        params=jax.tree.map(np.asarray, js.params),
                                        compute_dtype=torch.float32), **kw)
    step = len(jest.rot_grid) // 8
    jest.rot_grid = jest.rot_grid[::step][:8]
    test.rot_grid = test.rot_grid[::step][:8]
    return jest, test


def test_polishes_and_crop_off_match_jax(engines):
    jest, test = engines
    assert not (test.depth_polish or test.track_polish or test.track_crop)
    reader = DataReader(SCENE, shorter_side=240)
    K = reader.color_K
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    pj = jest.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=3)
    pt = test.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=3)
    # no depth polish: the returned pose is the cascade's top pose, unmoved
    np.testing.assert_array_equal(pt, test.poses[0] @ test.get_tf_to_centered_mesh())
    np.testing.assert_allclose(test.poses, jest.poses, atol=1e-4)
    assert _rot_deg(pt[:3, :3], pj[:3, :3]) < REG_ROT_DEG
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < REG_TRANS_M
    for i in (1, 2):
        c, d = reader.get_color(i), reader.get_depth(i)
        qj = jest.track_one(rgb=c, depth=d, K=K, iteration=2)
        qt = test.track_one(rgb=c, depth=d, K=K, iteration=2)
        assert _rot_deg(qt[:3, :3], qj[:3, :3]) < TRACK_ROT_DEG, i
        assert np.linalg.norm(qt[:3, 3] - qj[:3, 3]) < TRACK_TRANS_M, i
    # no upload crop was ever sized: every frame went up whole
    assert test._crop_size is None and jest._crop_size is None


def test_cli_switches_have_the_jax_defaults():
    from sixdof_tpu.app.run import _parse_prune_schedule as j_parse
    from sixdof_tpu.app.run import build_parser as j_parser

    ours = vars(build_parser().parse_args([]))
    theirs = vars(j_parser().parse_args([]))
    for flag in ("track_crop", "depth_polish", "track_polish", "polish_top", "polish_iters",
                 "prune_schedule", "prune_to", "refiner_ckpt", "scorer_ckpt",
                 "est_refine_iter", "track_refine_iter", "track_pipeline"):
        assert ours[flag] == theirs[flag], flag
    for spec in ("", "1x128,1x64", "2X32"):
        assert _parse_prune_schedule(spec) == j_parse(spec)
