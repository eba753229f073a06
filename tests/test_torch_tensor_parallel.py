"""The model axis of the port's multi-device path (parallel/tensor_parallel.py,
the (data, model) mesh of parallel/sharding.py, the tensor-parallel
trainers) against the JAX package on CPU meshes, and against 1 rank.

JAX's side: `param_shardings` places the bundled fp32 weights (orbax) on
`sh.make_mesh(n_data, n_model)` over the virtual CPU devices,
`data_sharding` the fixed crops, and `jax.value_and_grad` of
`refiner_loss` / `scorer_loss` runs as GSPMD partitions it.  The port's
ranks are `spawn_ranks` processes (gloo, 120 s timeouts, one torch thread
each) running tests/torch_dist_workers.py on the same weights, written as
port checkpoints; the 1-rank runs take the same functions in this process.

Tolerances (float32 on both sides):
- against JAX: the loss 1e-5 relative, each gradient tensor within 1e-3 of
  its largest entry (tests/test_torch_train_step.py's `_grads_close`);
- against 1 rank: the loss 1e-5 relative, the gradients 1e-4 of the
  largest entry (tests/test_torch_sharding.py's trainer gate);
- replicated parameters bit-equal across the model ranks after Adam, and
  every parameter bit-equal across the data ranks;
- the sharded capture on a (2, 2) mesh as tests/test_torch_sharding.py
  holds it against 1 rank."""
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from sixdof_tpu.models import networks as jn
from sixdof_tpu.models.predict import PoseRefinePredictor as JRef
from sixdof_tpu.models.predict import ScorePredictor as JSc
from sixdof_tpu.parallel import sharding as sh
from sixdof_tpu.parallel import train as J
from sixdof_tpu_torch.models import checkpoint
from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models.weights import params_from_jax
from sixdof_tpu_torch.parallel import sharding as ts
from sixdof_tpu_torch.parallel import tensor_parallel as tp
from test_torch_sharding import BOX_F, BOX_V, _capture_inputs, _port_checkpoints

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = dict(backend="gloo", timeout=120.0, threads=1)
HW = (32, 32)
CFG = dict(batch_size=4, input_hw=HW, n_hypotheses=2, p_occlusion=0.5, p_sensor=0.5)
# JAX's choice at the trainers' widths (n_model 2 and 4; at 3 only the
# 1536-wide QKV projections divide)
N_SPLIT = {"refiner": 17, "scorer": 13}


@pytest.fixture(scope="module")
def bundled(tmp_path_factory):
    """The orbax weights through the JAX predictors, float32 (net ->
    params), and the same weights written as port checkpoints."""
    out = {net: jax.tree.map(np.asarray, cls(ckpt_dir=os.path.join(REPO, "weights", net),
                                             compute_dtype=jnp.float32).params)
           for net, cls in (("refiner", JRef), ("scorer", JSc))}
    out["ckpt"] = _port_checkpoints(tmp_path_factory, out["refiner"], out["scorer"])
    return out


def _crops(rng, n):
    rgb = rng.uniform(0, 1, (n, *HW, 3))
    xyz = rng.normal(0, 0.02, (n, *HW, 3))
    return np.concatenate([rgb, xyz], -1).astype(np.float32)


def _inputs(bundled, save=None):
    """The ranks' inputs: the bundled checkpoints, fixed crops for each net
    (the refiner's 4 pairs, the scorer's 4 scenes x 2), and test_torch_
    sharding's trainer box and draws."""
    rng = np.random.RandomState(0)
    fixed = {"refiner": [_crops(rng, 4), _crops(rng, 4),
                         rng.uniform(-0.018, 0.018, (4, 3)).astype(np.float32),
                         rng.uniform(-0.42, 0.42, (4, 3)).astype(np.float32)],
             "scorer": [_crops(rng, 8), _crops(rng, 8),
                        -rng.uniform(0, 6, (4, 2)).astype(np.float32),
                        rng.uniform(-1, 1, (4, 2)).astype(np.float32)]}
    return dict(v=BOX_V, f=BOX_F, K=np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]]),
                diameter=0.1, seed=5, cfg=CFG, ckpt=bundled["ckpt"], fixed=fixed, save=save)


@pytest.fixture(scope="module")
def one_rank(bundled):
    return workers.tensor_parallel_rank(ts.DeviceMesh(), _inputs(bundled))


def _jax_split(params, mesh):
    """The port's names of the leaves `param_shardings` puts over `model`."""
    shardings = sh.param_shardings(params, mesh)
    flags = jax.tree.map(lambda s, a: np.full((1,) * a.ndim, "model" in tuple(s.spec)),
                         shardings, params)
    return {k for k, v in params_from_jax(flags).items() if v.item()}


@pytest.mark.parametrize("n_model", [2, 3, 4])
def test_split_rule_picks_jax_param_shardings(bundled, n_model):
    """split_names and shard_model pick exactly JAX's `param_shardings`
    leaves, by name through models/weights.py: 17 of the refiner's, 13 of
    the scorer's at 2 and 4; at 3 only the QKV projections divide."""
    jmesh = sh.make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    for net, model in (("refiner", tn.RefineNet), ("scorer", tn.ScoreNetMultiPair)):
        want = _jax_split(bundled[net], jmesh)
        shapes = {k: tuple(v.shape) for k, v in model().state_dict().items()}
        got = set(tp.split_names(shapes, n_model))
        assert got == want, (net, got ^ want)
        if n_model == 3:
            assert {k.rsplit(".", 1)[1] for k in got} == {"in_proj_weight"} and len(got) == 2
        else:
            assert len(got) == N_SPLIT[net]
        # the last model rank's shards of a whole model
        mesh = ts.DeviceMesh(1, n_model - 1, n_model=n_model)
        whole = model()
        full = {k: v.clone() for k, v in whole.state_dict().items()}
        assert set(tp.shard_model(whole, mesh)) == got == set(tp.split_parameters(whole))
        for k, v in whole.state_dict().items():
            rows = full[k].shape[0] // n_model
            want_v = full[k][(n_model - 1) * rows:] if k in got else full[k]
            assert torch.equal(v, want_v), k


def _jax_step(bundled, net, fixed, n_data, n_model):
    """JAX's loss and gradients (port names) of @fixed, its parameters
    placed by `param_shardings` and the crops by `data_sharding`."""
    mesh = sh.make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    params = bundled[net]
    placed = jax.tree.map(jax.device_put, params, sh.param_shardings(params, mesh))
    batch = [jax.device_put(x, sh.data_sharding(mesh)) for x in fixed]
    if net == "refiner":
        model, cfg = jn.RefineNet(c_in=6), J.TrainConfig(batch_size=4, input_hw=HW)
        loss_fn = lambda p, A, B, t, w: J.refiner_loss(model, p, A, B, t, w, cfg)  # noqa: E731
    else:
        model = jn.ScoreNetMultiPair(c_in=6)
        loss_fn = lambda p, A, B, t, w: J.scorer_loss(model, p, A, B, t, w)  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed, *batch)
    kernel = grads["trunk"]["encodeAB_0"]["conv1"]["kernel"]
    assert "model" in tuple(kernel.sharding.spec)  # the gradient comes back sharded
    grads = params_from_jax(jax.tree.map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def _grads_close(got, ref, tol=1e-3):
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        assert np.abs(got[k] - r).max() <= tol * scale, (k, float(np.abs(got[k] - r).max()),
                                                         scale)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tensor_parallel_steps_match_jax_and_one_rank(bundled, one_rank, tmp_path, shape):
    """The refiner and the scorer split over a (n_data, n_model) mesh, from
    the bundled weights: fixed crops against JAX's GSPMD step and against 1
    rank, a trainer step against 1 rank, the parameters after Adam
    bit-equal where they are replicated; on (1, 2) save_params writes the
    whole refiner once, which checkpoint.load_params reads back."""
    n_data, n_model = shape
    save = str(tmp_path / "out") if shape == (1, 2) else None
    d = _inputs(bundled, save)
    ranks = ts.spawn_ranks(workers.tensor_parallel_rank, n_data * n_model, args=(d,),
                           n_model=n_model, **RANKS)
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == \
        [(i // n_model, i % n_model) for i in range(n_data * n_model)]
    for net in ("refiner", "scorer"):
        got, one = ranks[0][net], one_rank[net]
        assert len(got["split"]) == N_SPLIT[net]
        jloss, jgrads = _jax_step(bundled, net, d["fixed"][net], n_data, n_model)
        assert got["fixed_trunk_max"] > 0 and one["fixed_trunk_max"] > 0
        np.testing.assert_allclose(got["fixed_loss"], jloss, rtol=1e-5, err_msg=net)
        np.testing.assert_allclose(got["fixed_loss"], one["fixed_loss"], rtol=1e-5, err_msg=net)
        _grads_close(got["fixed_grads"], jgrads)
        gmax = max(np.abs(g).max() for g in one["fixed_grads"].values())
        for k, g in one["fixed_grads"].items():
            np.testing.assert_allclose(got["fixed_grads"][k], g, atol=1e-4 * gmax, err_msg=k)
        step, one_step = got["step"], one["step"]
        assert step["trunk_max"] > 0
        np.testing.assert_allclose(step["loss"], one_step["loss"], rtol=1e-5, err_msg=net)
        np.testing.assert_allclose(step["grads"], one_step["grads"],
                                   atol=1e-4 * one_step["grad_max"], err_msg=net)
        for r in ranks:
            assert r[net]["step"]["loss"] == step["loss"]
            for q in ranks:
                if q["data_rank"] == r["data_rank"]:  # replicated over the model axis
                    for k in set(r[net]["digests"]) - set(got["split"]):
                        assert q[net]["digests"][k] == r[net]["digests"][k], (net, k)
                if q["model_rank"] == r["model_rank"]:  # every shard over the data axis
                    assert q[net]["digests"] == r[net]["digests"], net
    assert all(r["seconds"]["model"] > 0 for r in ranks)
    # the replicated gradients' average over every rank counts as data-axis time
    assert all(r["seconds"]["data"] > 0 for r in ranks)
    if save:
        assert sorted(os.listdir(save)) == ["MANIFEST.json", "refiner.npz"]
        sd = checkpoint.load_params(os.path.join(save, "refiner.npz"), "refiner",
                                    compute_dtype=torch.float32)
        shapes = {k: tuple(v.shape) for k, v in tn.RefineNet().state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
        digests = {k: hashlib.sha1(v.numpy().tobytes()).hexdigest() for k, v in sd.items()}
        assert all(r["refiner"]["saved_digests"] == digests for r in ranks)
        tn.RefineNet().load_state_dict(sd)


def test_data_axis_on_a_2d_mesh_and_mesh_errors():
    """On a (2, 2) mesh the data helpers give each rank its data index's
    slice of JAX's padded arrays on make_mesh(n_data=2, n_model=2); 4
    spawned ranks sit where JAX puts its devices, each axis gathers its own
    ranks, make_mesh refuses worlds that are not n_data x n_model, and the
    sharded capture equals 1 rank."""
    r = np.random.RandomState(0)
    poses = r.rand(11, 4, 4).astype(np.float32)
    tfs, dists = r.rand(11, 4, 4).astype(np.float32), r.rand(11).astype(np.float32)
    dirs, mask = r.rand(13, 3).astype(np.float32), r.rand(13) > 0.3
    jmesh = sh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jpose, _ = sh.shard_hypotheses(jnp.asarray(poses), jmesh)
    jtfs, jdists, _ = sh.shard_restarts(jnp.asarray(tfs), jnp.asarray(dists), jmesh)
    jdirs, jmask, _ = sh.shard_rays(jnp.asarray(dirs), jnp.asarray(mask), jmesh)
    for rank in range(4):
        mesh = ts.DeviceMesh(2, rank, n_model=2)
        assert (mesh.data_rank, mesh.model_rank) == divmod(rank, 2)
        got = [ts.shard_hypotheses(torch.tensor(poses), mesh)[0],
               *ts.shard_restarts(torch.tensor(tfs), torch.tensor(dists), mesh)[:2],
               *ts.shard_rays(torch.tensor(dirs), torch.tensor(mask), mesh)[:2]]
        for g, want in zip(got, (jpose, jtfs, jdists, jdirs, jmask)):
            want = np.asarray(want)
            half = want.shape[0] // 2
            np.testing.assert_array_equal(g.numpy(), want[mesh.data_rank * half:][:half])
    # JAX's device grid is the port's rank layout
    assert np.asarray(jmesh.devices).tolist() == [[jax.devices()[i] for i in (0, 1)],
                                                  [jax.devices()[i] for i in (2, 3)]]
    d = _capture_inputs()
    ranks = ts.spawn_ranks(workers.mesh_capture_rank, 4, args=(d,), n_model=2, **RANKS)
    one = workers.capture_rank(ts.DeviceMesh(), d)
    for rank, got in enumerate(ranks):
        i, j = divmod(rank, 2)
        assert (got["data_rank"], got["model_rank"]) == (i, j)
        assert got["shape"] == {"data": 2, "model": 2}
        np.testing.assert_array_equal(got["data_axis"], [j, 2 + j])
        np.testing.assert_array_equal(got["model_axis"], [2 * i, 2 * i + 1])
        assert len(got["errors"]) == 3 and all("do not form" in e for e in got["errors"])
        for a, b in zip(got["capture"], ranks[0]["capture"]):
            np.testing.assert_array_equal(a, b)
    tf, fit, _, best, th = ranks[0]["capture"]
    nr, nray = 11, 13
    np.testing.assert_allclose(tf[:nr], one[0][:nr], atol=2e-4)
    np.testing.assert_allclose(fit[:nr], one[1][:nr], atol=1e-5)
    np.testing.assert_allclose(tf[int(best)], one[0][int(one[3])], atol=2e-4)
    np.testing.assert_allclose(th[:nray], one[4][:nray], atol=1e-4)
