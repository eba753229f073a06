"""The data axis of the port's multi-device path (parallel/sharding.py, the
hypothesis-sharded predictors and register, the sharded capture, the
data-parallel trainers and object-field step) against the JAX package on a
2-device mesh of the CPU, and against 1 rank.

The port's ranks are 2 processes started by `spawn_ranks` (spawn, gloo,
a FileStore under a temporary directory, 120 s timeouts, one torch thread
each); their functions are in tests/torch_dist_workers.py, which imports no
JAX.  The 1-rank runs take the same functions in this process with a
1-rank `DeviceMesh`.  JAX pads as the port does (`shard_hypotheses` on
`sh.make_mesh(n_data=2, devices=jax.devices()[:2])`).

Tolerances (float32 networks on both sides):
- refine 1e-4, as tests/test_parallel.py holds JAX's sharded refine and
  tests/test_torch_predict.py the port's; scores 2e-3 with the same
  argmax (tests/test_torch_predict.py), 1e-2 for the seeded networks of
  tests/test_parallel.py (6.0e-3 apart from JAX unsharded too); 2 ranks
  against 1 on the same padded set at 2e-3;
- the capture as tests/test_parallel.py holds JAX's: transforms 2e-4,
  fitness 1e-5, the selected transform 2e-4, hit distances 1e-4;
- the register as tests/test_torch_staged_register.py: pose 1e-3,
  scores 5e-3;
- a trainer step's loss within 1e-5 relative of 1 rank, its averaged
  gradients within 1e-4 of the largest entry;
- the field step as tests/test_torch_object_field.py holds one step: the
  loss 2e-5 relative (tests/test_parallel.py: 1e-4), the gradients 1e-4 of
  each tensor's largest entry, the field after Adam within 1e-4 of a step
  (lr) except where JAX's gradient is below 1e-6 (Adam's first step turns
  rounding there into up to one step)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu.io.mesh_io import TriMesh as JMesh
from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models import object_field as jof
from sixdof_tpu.models import predict as jp
from sixdof_tpu.ops.geometry import depth2xyzmap as j_xyz
from sixdof_tpu.ops.icp import improve_and_raytrace as j_capture
from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays
from sixdof_tpu.parallel import sharding as sh
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models import predict as tp
from sixdof_tpu_torch.ops.lie import so3_exp_map
from sixdof_tpu_torch.parallel import sharding as ts
from sixdof_tpu_torch.parallel import train as ttrain

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
MESH = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
RANKS = dict(backend="gloo", timeout=120.0, threads=1)
REFINE_ATOL, SCORE_ATOL = 1e-4, 2e-3
# the seeded networks' scores lie 6.0e-3 from JAX's unsharded as well: an
# untrained trunk's large activations amplify float32 summation order
SEEDED_SCORE_ATOL = 1e-2
POSE_ATOL, REGISTER_SCORE_ATOL = 1e-3, 5e-3


def jax_mesh():
    return sh.make_mesh(n_data=2, devices=jax.devices()[:2])


# ---------------------------------------------------------------- helpers --


def test_pad_and_slice_helpers_match_jax(tmp_path):
    """Each rank's slice is its part of JAX's padded array: hypotheses
    repeat the first pose, restarts the last restart, rays are padded
    masked off; a field batch must divide the data axis."""
    r = np.random.RandomState(0)
    poses = r.rand(11, 4, 4).astype(np.float32)
    tfs, dists = r.rand(11, 4, 4).astype(np.float32), r.rand(11).astype(np.float32)
    dirs, mask = r.rand(13, 3).astype(np.float32), r.rand(13) > 0.3
    m = jax_mesh()
    jpose, n_hyp = sh.shard_hypotheses(jnp.asarray(poses), m)
    jtfs, jdists, n_res = sh.shard_restarts(jnp.asarray(tfs), jnp.asarray(dists), m)
    jdirs, jmask, n_ray = sh.shard_rays(jnp.asarray(dirs), jnp.asarray(mask), m)
    meshes = [ts.DeviceMesh(2, rank) for rank in range(2)]
    got = [(ts.shard_hypotheses(torch.tensor(poses), mm),
            ts.shard_restarts(torch.tensor(tfs), torch.tensor(dists), mm),
            ts.shard_rays(torch.tensor(dirs), torch.tensor(mask), mm)) for mm in meshes]
    for want, k, i in ((jpose, 0, 0), (jtfs, 1, 0), (jdists, 1, 1), (jdirs, 2, 0),
                       (jmask, 2, 1)):
        np.testing.assert_array_equal(np.concatenate([g[k][i].numpy() for g in got]),
                                      np.asarray(want))
    assert [g[0][1] for g in got] == [n_hyp] * 2 and [g[1][2] for g in got] == [n_res] * 2
    assert [g[2][2] for g in got] == [n_ray] * 2 and (n_hyp, n_res, n_ray) == (11, 11, 13)
    padded, n = ts.pad_hypotheses(torch.tensor(poses), meshes[0])
    assert n == 11 and padded.shape == (12, 4, 4) and torch.equal(padded[11], padded[0])
    batch = torch.rand(32, 11)
    local, n = ts.shard_field_rays(batch, meshes[1])
    assert n == 32 and torch.equal(local, batch[16:])
    # 30 rays: over 4 ranks (as over JAX's 4 devices) and 31 over 2 raise
    m4 = sh.make_mesh(n_data=4, devices=jax.devices()[:4])
    for rays, jmesh, mm in ((30, m4, ts.DeviceMesh(4, 0)), (31, m, meshes[0])):
        with pytest.raises(ValueError):
            sh.shard_field_rays(jnp.asarray(batch.numpy()[:rays]), jmesh)
        with pytest.raises(ValueError, match="divide"):
            ts.shard_field_rays(batch[:rays], mm)
    # make_mesh needs a process group, whose size must be n_data x n_model
    for kw in ({}, dict(n_data=1, n_model=2)):
        with pytest.raises(RuntimeError, match="process group"):
            ts.make_mesh(**kw)
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        for kw in (dict(n_data=1, n_model=2), dict(n_data=2), dict(n_model=0)):
            with pytest.raises(ValueError, match="do not form"):
                ts.make_mesh(**kw)
        assert ts.make_mesh().shape == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


def test_spawned_ranks_gather_in_rank_order_and_report_a_failure():
    """spawn_ranks: results in rank order, every rank sees the gathered
    tensor; a rank that raises fails the call with its traceback."""
    out = ts.spawn_ranks(workers.gather_rank, 2, args=(3,), **RANKS)
    np.testing.assert_array_equal(out[0], [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(out[1], out[0])
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        ts.spawn_ranks(workers.gather_rank, 2, args=(-1,), **RANKS)


# ------------------------------------------------------------- predictors --


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """The bundled networks in float32 through the JAX predictors, and the
    same weights written as port checkpoints for the ranks."""
    os.environ["SIXDOF_AOT_CACHE"] = ""
    jr = jp.PoseRefinePredictor(ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                                compute_dtype=jnp.float32)
    js = jp.ScorePredictor(ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                           compute_dtype=jnp.float32)
    return jr, js, _port_checkpoints(tmp_path_factory, jr.params, js.params)


def _port_checkpoints(tmp_path_factory, rparams, sparams):
    """JAX refiner and scorer parameters written as the port's checkpoints."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    for net, cls, params in (("refiner", tp.PoseRefinePredictor, rparams),
                             ("scorer", tp.ScorePredictor, sparams)):
        pred = cls("cpu", params=jax.tree.map(np.asarray, params), compute_dtype=torch.float32)
        ttrain.save_params(ckpt, net, pred.model)
    return ckpt


def _bundled_case(nets, tmp_path_factory, n=11):
    """11 poses near synth_box frame 0's annotated pose, 48x48 crops."""
    jr, js, ckpt = nets
    jm = j_load(MESH)
    c = (jm.vertices.max(0) + jm.vertices.min(0)) / 2
    reader = DataReader(SCENE, shorter_side=240)
    gt = reader.get_gt_pose(0).copy()
    gt[:3, 3] += gt[:3, :3] @ c
    rng = np.random.RandomState(0)
    d = so3_exp_map(torch.tensor(rng.randn(n, 3) * 0.15, dtype=torch.float32)).numpy()
    poses = np.tile(gt, (n, 1, 1)).astype(np.float32)
    poses[:, :3, :3] = d @ poses[:, :3, :3]
    poses[:, :3, 3] += rng.randn(n, 3).astype(np.float32) * 0.005
    jm.vertices = jm.vertices - c
    return (jr.model, jr.params, js, j_arrays(jm)), dict(
        ckpt=ckpt, mesh_path=MESH, center=c, rgb=reader.get_color(0),
        depth=reader.get_depth(0).astype(np.float32), K=reader.color_K.astype(np.float32),
        poses=poses, diameter=0.1, hw=(48, 48), backface_cull=True, max_batch=4)


def _seeded_case(nets, tmp_path_factory):
    """tests/test_parallel.py's sharded register: flax-initialised networks
    (seeds 0 and 1) on a box, 11 poses along the optical axis, 32x32 crops
    of a random image.  Its random cross attention mixes the set."""
    from sixdof_tpu.models.networks import RefineNet, ScoreNetMultiPair
    from sixdof_tpu_torch.io.mesh_io import TriMesh, save_mesh

    dummy = jnp.zeros((1, 32, 32, 6), dtype=jnp.float32)
    rmodel, smodel = RefineNet(c_in=6), ScoreNetMultiPair(c_in=6)
    rparams = rmodel.init(jax.random.PRNGKey(0), dummy, dummy)["params"]
    sparams = smodel.init(jax.random.PRNGKey(1), dummy, dummy, 1)["params"]
    # flax initialises the score head to zero; a lecun-normal head (seed 2)
    # makes the network's part of the scores count
    head = jax.random.normal(jax.random.PRNGKey(2), (512, 1)) / np.sqrt(512.0)
    sparams = dict(sparams, linear={"kernel": head, "bias": sparams["linear"]["bias"]})
    path = str(tmp_path_factory.mktemp("box") / "box.obj")
    save_mesh(path, TriMesh(BOX_V, BOX_F))
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (11, 1, 1))
    poses[:, 2, 3] = np.linspace(0.4, 0.6, 11)
    return (rmodel, rparams, None, j_arrays(JMesh(BOX_V, BOX_F))), dict(
        ckpt=_port_checkpoints(tmp_path_factory, rparams, sparams), mesh_path=path,
        center=np.zeros(3), rgb=np.random.RandomState(0).rand(48, 64, 3).astype(np.float32),
        depth=np.full((48, 64), 0.5, np.float32),
        K=np.array([[120.0, 0, 32.0], [0, 120.0, 32.0], [0, 0, 1.0]], np.float32), poses=poses,
        diameter=0.1, hw=(32, 32), backface_cull=False, max_batch=None), (smodel, sparams)


@pytest.mark.parametrize("case", ["bundled", "seeded"])
def test_sharded_refine_and_score_match_jax(nets, tmp_path_factory, case):
    """11 hypotheses over 2 ranks (padded to 12, as JAX pads them): refine,
    scores (and the tournament of chunks of 4) against JAX's 2-device mesh
    and against 1 rank.  With the seeded networks, scoring each shard on its
    own (att_cross over half the set) fails that comparison."""
    if case == "bundled":
        (rmodel, rparams, js, arrays), d = _bundled_case(nets, tmp_path_factory)
        smodel, sparams = js.model, js.params
    else:
        (rmodel, rparams, js, arrays), d, (smodel, sparams) = _seeded_case(nets,
                                                                          tmp_path_factory)
    ranks = ts.spawn_ranks(workers.predict_rank, 2, args=(d,), **RANKS)
    sp, n = sh.shard_hypotheses(jnp.asarray(d["poses"]), jax_mesh())
    # 1 rank on the same 12 poses (its pad adds nothing)
    one = workers.predict_rank(ts.DeviceMesh(), dict(d, poses=np.asarray(sp)))
    keys = ("refined", "scores", "per_shard") + (("tournament",) if js else ())
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])  # every rank, the same
    K = jnp.asarray(d["K"])
    rgb01, xyz = jp.to_rgb01(d["rgb"]), j_xyz(jnp.asarray(d["depth"]), K)
    cull = d["backface_cull"]
    jref = np.asarray(jp.refine_poses_jit(rmodel, rparams, arrays, sp, rgb01, xyz, K, 0.1, 1.2,
                                          0.02, 0.3490658503988659, 2, d["hw"],
                                          backface_cull=cull))[:n]
    want = {"scores": np.asarray(jp.score_poses_jit(smodel, sparams, arrays, sp, rgb01, xyz, K,
                                                    0.1, 1.2, out_hw=d["hw"], mode="hybrid",
                                                    backface_cull=cull))}
    if js:
        js.cfg["max_batch"] = d["max_batch"]
        try:
            want["tournament"] = np.asarray(js.predict(
                rgb=d["rgb"], depth=d["depth"], K=d["K"], ob_in_cams=sp, mesh_tensors=arrays,
                mesh_diameter=0.1, out_hw=d["hw"], backface_cull=cull)[0])
        finally:
            js.cfg.pop("max_batch")
    got = ranks[0]
    tol = SCORE_ATOL if case == "bundled" else SEEDED_SCORE_ATOL
    np.testing.assert_allclose(got["refined"], jref, atol=REFINE_ATOL)
    np.testing.assert_allclose(got["refined"], one["refined"][:n], atol=REFINE_ATOL)
    for k, w in want.items():
        assert got[k].shape == w.shape == (12,)
        np.testing.assert_allclose(got[k], w, atol=tol, err_msg=k)
        np.testing.assert_allclose(got[k], one[k], atol=SCORE_ATOL, err_msg=k)
        assert np.argmax(got[k]) == np.argmax(w) == np.argmax(one[k])
    if case == "seeded":
        # a rank that ran att_cross on its own 6 hypotheses scores against
        # half the set (0.19 off here): beyond the parity tolerance
        assert np.abs(got["per_shard"] - want["scores"]).max() > 10 * tol
    assert got["collective_s"] > 0


def test_sharded_register_matches_jax_and_one_rank(nets, tmp_path):
    """FoundationPose(device_mesh=...) on synth_box frame 0, 9 hypotheses
    (padded to 10), prune_to 4, the cascade polish of 3 (padded to 4), on
    2 ranks, on 1 rank, and JAX's FoundationPose on its 2-device mesh."""
    jr, js, ckpt = nets
    hw = (64, 64)
    for pred in (jr, js):
        pred.cfg["input_resize"] = hw
    reader = DataReader(SCENE, shorter_side=240)
    color = reader.get_color(0)
    engine = dict(coarse_hw=(32, 32), depth_polish=False, track_polish=False, track_crop=False,
                  prune_to=4, polish_top=3, polish_iters=1)
    d = dict(ckpt=ckpt, mesh_path=MESH, hw=hw, engine=engine, n_hypotheses=9, K=reader.color_K,
             rgb=color, depth=reader.get_depth(0), mask=reader.get_mask(color, 0).astype(bool),
             iteration=4)
    try:
        jm = j_load(MESH)
        jest = JFP(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm, scorer=js,
                   refiner=jr, debug_dir=str(tmp_path), device_mesh=jax_mesh(), **engine)
        step = len(jest.rot_grid) // 9
        jest.rot_grid = jest.rot_grid[::step][:9]
        pj = jest.register(K=d["K"], rgb=color, depth=d["depth"], ob_mask=d["mask"],
                           iteration=4)
    finally:
        for pred in (jr, js):
            pred.cfg["input_resize"] = (160, 160)
    ranks = ts.spawn_ranks(workers.register_rank, 2, args=(d,), **RANKS)
    one = workers.register_rank(ts.DeviceMesh(), d)
    for k in ("pose", "poses", "scores"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    got = ranks[0]
    assert got["poses"].shape == jest.poses.shape == one["poses"].shape == (7, 4, 4)
    for want in (dict(pose=pj, poses=jest.poses, scores=jest.scores), one):
        np.testing.assert_allclose(got["pose"], want["pose"], atol=POSE_ATOL)
        np.testing.assert_allclose(got["poses"][0], want["poses"][0], atol=POSE_ATOL)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=REGISTER_SCORE_ATOL)


# ---------------------------------------------------------------- capture --


def _capture_inputs():
    """tests/test_parallel.py's sharded capture inputs."""
    r = np.random.RandomState(3)
    xy = r.uniform(-0.06, 0.06, (300, 2))
    tgt = np.concatenate([xy, 0.002 * np.sin(40 * xy[:, :1])], axis=-1).astype(np.float32)
    ang = 0.03
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                   [0, 0, 1]], np.float32)
    src = (tgt @ Rz.T + np.array([0.004, -0.003, 0.002], np.float32)).astype(np.float32)
    init_tfs = np.tile(np.eye(4, dtype=np.float32)[None], (11, 1, 1))
    init_tfs[:, :3, 3] = r.normal(0, 0.002, (11, 3))
    tri = np.array([[[-0.1, -0.1, 0.5], [0.1, -0.1, 0.5], [0.1, 0.1, 0.5]],
                    [[-0.1, -0.1, 0.5], [0.1, 0.1, 0.5], [-0.1, 0.1, 0.5]]], np.float32)
    ray_dirs = r.normal(0, 0.1, (13, 3)).astype(np.float32)
    ray_dirs[:, 2] = 1.0
    return dict(src=src, ones=np.ones((300,), bool), tgt=tgt,
                tgt_n=np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (300, 1)),
                init_tfs=init_tfs, max_dists=np.full((11,), 0.02, np.float32), tri=tri,
                tri_mask=np.ones((2,), bool), ray_dirs=ray_dirs, ray_mask=np.ones((13,), bool))


def test_sharded_capture_matches_jax_and_one_rank():
    """11 restarts and 13 rays over 2 ranks (padded to 12 and 14), as
    tests/test_parallel.py shards JAX's over its mesh."""
    d = _capture_inputs()
    ranks = ts.spawn_ranks(workers.capture_rank, 2, args=(d,), **RANKS)
    one = workers.capture_rank(ts.DeviceMesh(), d)
    m = jax_mesh()
    s_tfs, s_mds, nr = sh.shard_restarts(jnp.asarray(d["init_tfs"]), jnp.asarray(d["max_dists"]),
                                         m)
    s_rd, s_rm, nray = sh.shard_rays(jnp.asarray(d["ray_dirs"]), jnp.asarray(d["ray_mask"]), m)
    j = d
    want = [np.asarray(x) for x in j_capture(
        jnp.asarray(j["src"]), jnp.asarray(j["ones"]), jnp.asarray(j["tgt"]),
        jnp.asarray(j["tgt_n"]), jnp.asarray(j["ones"]), s_tfs, s_mds,
        jnp.eye(4, dtype=jnp.float32), jnp.float32(0.02), jnp.asarray(j["tri"]),
        jnp.asarray(j["tri_mask"]), s_rd, s_rm, jnp.eye(4, dtype=jnp.float32), max_iter=8)]
    for a, b in zip(ranks[0], ranks[1]):
        np.testing.assert_array_equal(a, b)
    tf, fit, rmse, best, th = ranks[0]
    assert tf.shape == want[0].shape == (13, 4, 4) and th.shape == want[4].shape == (14,)
    for ref in (want, [one[0], one[1], None, one[3], one[4]]):
        np.testing.assert_allclose(tf[:nr], ref[0][:nr], atol=2e-4)
        np.testing.assert_allclose(fit[:nr], ref[1][:nr], atol=1e-5)
        # a padded duplicate may win a tie: the SELECTED pose must match
        np.testing.assert_allclose(tf[int(best)], ref[0][int(ref[3])], atol=2e-4)
        np.testing.assert_allclose(th[:nray], ref[4][:nray], atol=1e-4)
    assert np.isfinite(th[:nray]).any() and np.isinf(th[nray:]).all()  # masked-off padding


# --------------------------------------------------------------- training --

BOX_V = np.array([[-0.04, -0.03, -0.02], [0.04, -0.03, -0.02], [0.04, 0.03, -0.02],
                  [-0.04, 0.03, -0.02], [-0.04, -0.03, 0.02], [0.04, -0.03, 0.02],
                  [0.04, 0.03, 0.02], [-0.04, 0.03, 0.02]])
BOX_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])


def test_data_parallel_trainer_steps_match_one_rank(nets):
    """One refiner step (batch 4) and one scorer step (4 scenes of 2) from
    the bundled weights on 2 ranks, each rank rendering its half of the same
    draws, against 1 rank; a batch that does not divide the data axis
    raises.  (The heads of a fresh network start at zero, which leaves its
    first trunk gradient zero: the bundled weights make it count.)"""
    d = dict(v=BOX_V, f=BOX_F, K=np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]]),
             diameter=0.1, seed=5, ckpt=nets[2],
             cfg=dict(batch_size=4, input_hw=(32, 32), n_hypotheses=2, p_occlusion=0.5,
                      p_sensor=0.5))
    ranks = ts.spawn_ranks(workers.trainer_rank, 2, args=(d,), **RANKS)
    one = workers.trainer_rank(ts.DeviceMesh(), d)
    for net in ("refiner", "scorer"):
        got, want = ranks[0][net], one[net]
        assert got["trunk_max"] > 0 and want["trunk_max"] > 0
        assert got["loss"] == ranks[1][net]["loss"]
        np.testing.assert_array_equal(got["grads"], ranks[1][net]["grads"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=net)
        np.testing.assert_allclose(got["grads"], want["grads"], atol=1e-4 * want["grad_max"],
                                   err_msg=net)
    from sixdof_tpu_torch.io.mesh_io import TriMesh
    from sixdof_tpu_torch.models.networks import RefineNet, ScoreNetMultiPair
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays

    class ThreeScenes(ttrain.ScorerTrainer):
        n_scenes = 3

    arrays = make_mesh_arrays(TriMesh(BOX_V, BOX_F), "cpu")
    cfg = ttrain.TrainConfig(**d["cfg"])
    two = ts.DeviceMesh(2, 0)
    with pytest.raises(ValueError, match="3 scenes"):
        ThreeScenes(ScoreNetMultiPair(), arrays, d["K"], 0.1, cfg, device_mesh=two)
    with pytest.raises(ValueError, match="5 pairs"):
        ttrain.RefinerTrainer(RefineNet(), arrays, d["K"], 0.1, cfg._replace(batch_size=5),
                              device_mesh=two)


def _jax_z_draws(key, n, cfg):
    """sample_z_vals' three uniforms, from the key as the JAX loss splits it."""
    k1, k2, k3 = jax.random.split(key, 3)
    U = jax.random.uniform
    return {"u1": np.asarray(U(k1, (n, cfg.n_samples))),
            "u2": np.asarray(U(k2, (n, cfg.n_samples_around_depth))),
            "u3": np.asarray(U(k3, (n, cfg.n_samples_around_depth)))}


def test_data_parallel_field_step_matches_jax_and_one_rank():
    """tests/test_parallel.py's field step (32 rays, a 2-level 2^10 table)
    with the rays split over 2 ranks, against JAX's step with the batch
    sharded over its 2-device mesh, and against 1 rank."""
    import optax

    spec = jof.HashGridSpec(n_levels=2, base_res=8, finest_res=16, level_dim=2,
                            log2_hashmap_size=10)
    cfg = jof.ObjectFieldConfig(n_rand=32, n_samples=8, n_samples_around_depth=8, sh_degree=2)
    params = jof.init_field(jax.random.PRNGKey(7), spec, n_frames=2,
                            frame_feat_dim=cfg.frame_feat_dim, sh_degree=cfg.sh_degree)
    loss_fn = jof.make_loss_fn(cfg, spec, sc=1.0)
    r = np.random.RandomState(11)
    R = 32
    origins = np.tile(np.array([[0.0, 0.0, -1.5]], np.float32), (R, 1))
    dirs = np.concatenate([r.uniform(-0.2, 0.2, (R, 2)), np.ones((R, 1))],
                          axis=-1).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = np.concatenate(
        [origins, dirs, r.rand(R, 3), r.uniform(1.2, 1.8, (R, 1)),
         (np.arange(R) % 2)[:, None]], axis=-1).astype(np.float32)
    tx = optax.adam(cfg.lrate)
    key = jax.random.PRNGKey(5)

    def step(params, opt_state, b):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, b, key)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    rep = sh.replicated(jax_mesh())
    params_r = jax.device_put(params, rep)
    jp_, _, jl, jg = jax.jit(step)(params_r, jax.device_put(tx.init(params_r), rep),
                                   sh.shard_field_rays(jnp.asarray(batch), jax_mesh()))
    tree = {k: jax.tree.map(np.asarray, v) for k, v in params._asdict().items()}
    d = dict(params=tree, cfg=cfg._asdict(), spec=spec._asdict(), batch=batch,
             draws=_jax_z_draws(key, R, cfg))
    ranks = ts.spawn_ranks(workers.field_rank, 2, args=(d,), **RANKS)
    one = workers.field_rank(ts.DeviceMesh(), d)
    got = ranks[0]
    assert got["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(got["loss"], float(jl), rtol=2e-5)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)

    def flat(t):
        out = dict(table=t.table, frame_features=t.frame_features, pose_deltas=t.pose_deltas)
        for name in ("sigma_w", "color_w"):
            for i, (w, b) in enumerate(getattr(t, name)):
                out[f"{name}.{i}.w"], out[f"{name}.{i}.b"] = w, b
        return {k: np.asarray(v) for k, v in out.items()}

    jgrads, jparams = flat(jg), flat(jp_)
    assert set(got["grads"]) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_array_equal(got["grads"][k], ranks[1]["grads"][k])
        for want in (g, one["grads"][k]):
            np.testing.assert_allclose(got["grads"][k], want, atol=1e-4 * np.abs(g).max(),
                                       err_msg=k)
        tol = np.where(np.abs(g) < 1e-6, cfg.lrate, 1e-4 * cfg.lrate)
        assert (np.abs(got["params"][k] - jparams[k]) <= tol).all(), k
