"""The trainer's step (parallel/train.py, models/networks.py::init_flax_style,
the checkpoint it writes, tools/train_torch_networks.py) against the JAX
package on the CPU.

Tolerances:
- the losses on the bundled weights (orbax, carried over by
  models/weights.py::params_from_jax), float32 on both sides, on seeded
  48x48 crops: 1e-5 relative;
- their gradients: each tensor within 1e-3 of its largest entry (float32
  convolutions and their backward passes summed in another order);
- Adam: the same gradients through torch.optim.Adam and optax.adam for
  three steps of lr 1e-4, parameters within 1e-3 of a step (1e-7) plus
  two float32 ulps of the parameter (the moments and bias corrections are
  applied in another order);
- the init's statistics: zero heads, biases and unit LayerNorm scales
  exactly; each drawn tensor's standard deviation within 5 standard errors
  of flax's variance (and inside its truncation at 2 / 0.8796 std)."""
import json
import math
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sixdof_tpu.models import networks as jn
from sixdof_tpu.models.predict import PoseRefinePredictor as JRef
from sixdof_tpu.models.predict import ScorePredictor as JSc
from sixdof_tpu.parallel import train as J
from sixdof_tpu_torch.io.mesh_io import TriMesh
from sixdof_tpu_torch.models import checkpoint
from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models.predict import PoseRefinePredictor as TRef
from sixdof_tpu_torch.models.predict import ScorePredictor as TSc
from sixdof_tpu_torch.models.weights import params_from_jax
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
from sixdof_tpu_torch.parallel import train as T

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HW = (48, 48)
# tests/test_parallel.py's overfit setting: an 8-vertex box, its K, and the
# gate on the last loss against the first
BOX_V = [[-0.04, -0.03, -0.02], [0.04, -0.03, -0.02], [0.04, 0.03, -0.02], [-0.04, 0.03, -0.02],
         [-0.04, -0.03, 0.02], [0.04, -0.03, 0.02], [0.04, 0.03, 0.02], [-0.04, 0.03, 0.02]]
BOX_F = [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
         [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]]
K_BOX = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
OVERFIT_RATIO = 0.8


@pytest.fixture(scope="module")
def bundled():
    """The orbax weights through the JAX predictors, float32: net -> params."""
    out = {}
    for net, cls in (("refiner", JRef), ("scorer", JSc)):
        pred = cls(ckpt_dir=os.path.join(REPO, "weights", net), compute_dtype=jnp.float32)
        out[net] = jax.tree.map(np.asarray, pred.params)
    out["refiner_sd"] = params_from_jax(out["refiner"])
    return out


def _box():
    from sixdof_tpu.io.mesh_io import TriMesh as JTriMesh
    from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays

    v, f = np.array(BOX_V), np.array(BOX_F)
    return j_arrays(JTriMesh(v, f)), make_mesh_arrays(TriMesh(v, f), "cpu")


def _crops(rng, n):
    """Seeded stand-ins for rendered crops: RGB in [0,1], xyz about the
    object centre (~2 cm)."""
    rgb = rng.uniform(0, 1, (n, *HW, 3))
    xyz = rng.normal(0, 0.02, (n, *HW, 3))
    return np.concatenate([rgb, xyz], -1).astype(np.float32)


def _grads_close(got, ref, tol=1e-3):
    for k, r in ref.items():
        g = got[k]
        scale = max(float(np.abs(r).max()), 1e-12)
        assert np.abs(g - r).max() <= tol * scale, (k, float(np.abs(g - r).max()), scale)


def test_refiner_loss_and_gradients_match_jax(bundled):
    cfg = J.TrainConfig(batch_size=2, input_hw=HW)
    rng = np.random.RandomState(0)
    A, B = _crops(rng, 2), _crops(rng, 2)
    tdt = rng.uniform(-0.018, 0.018, (2, 3)).astype(np.float32)
    tdw = rng.uniform(-0.42, 0.42, (2, 3)).astype(np.float32)
    model = jn.RefineNet(c_in=6)
    params = jax.tree.map(jnp.asarray, bundled["refiner"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: J.refiner_loss(model, p, A, B, tdt, tdw, cfg)))(params)
    net = tn.RefineNet()
    net.load_state_dict(params_from_jax(bundled["refiner"]))
    t = [torch.from_numpy(x) for x in (A, B, tdt, tdw)]
    got = T.refiner_loss(net, *t, T.TrainConfig(**cfg._asdict()))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    ref = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, grads)).items()}
    _grads_close({k: p.grad.numpy() for k, p in net.named_parameters()}, ref)


@pytest.mark.parametrize("w_distill", [0.0, 0.5])
def test_scorer_loss_and_gradients_match_jax(bundled, w_distill):
    rng = np.random.RandomState(1)
    A, B = _crops(rng, 6), _crops(rng, 6)
    target = -rng.uniform(0, 6, (2, 3)).astype(np.float32)
    teacher = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    model = jn.ScoreNetMultiPair(c_in=6)
    params = jax.tree.map(jnp.asarray, bundled["scorer"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: J.scorer_loss(model, p, A, B, target, teacher, w_distill)))(params)
    net = tn.ScoreNetMultiPair()
    net.load_state_dict(params_from_jax(bundled["scorer"]))
    t = [torch.from_numpy(x) for x in (A, B, target, teacher)]
    got = T.scorer_loss(net, *t, w_distill=w_distill)
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    ref = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, grads)).items()}
    _grads_close({k: p.grad.numpy() for k, p in net.named_parameters()}, ref)


def test_adam_steps_match_optax(bundled):
    """torch.optim.Adam(lr) with its defaults is optax.adam(lr): the same
    gradients give the same parameters."""
    params = jax.tree.map(jnp.asarray, bundled["refiner"])
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape, dtype=np.float32) * np.float32(1e-2)), params)
        for _ in range(3)]
    tx = optax.adam(1e-4)
    state = tx.init(params)
    net = tn.RefineNet()
    net.load_state_dict(params_from_jax(bundled["refiner"]))
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    named = dict(net.named_parameters())
    step = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    for g in grads:
        params, state = step(g, state, params)
        for k, v in params_from_jax(jax.tree.map(np.asarray, g)).items():
            named[k].grad = v
        opt.step()
    ref = params_from_jax(jax.tree.map(np.asarray, params))
    moved = 0.0
    for k, p in named.items():
        r = ref[k].numpy()
        tol = 1e-3 * 1e-4 + 2 * np.spacing(np.abs(r))
        assert (np.abs(p.detach().numpy() - r) <= tol).all(), k
        moved = max(moved, float(np.abs(r - bundled["refiner_sd"][k].numpy()).max()))
    assert moved > 1e-4  # the steps moved the parameters


def test_self_biased_cross_attention_init_matches_jax():
    model = jn.ScoreNetMultiPair(c_in=6)
    dummy = jnp.zeros((2, 16, 16, 6), jnp.float32)
    params = jax.jit(model.init, static_argnums=3)(jax.random.PRNGKey(0), dummy, dummy,
                                                   2)["params"]
    ref = params_from_jax(jax.tree.map(np.asarray, J._self_biased_cross_attention_init(params)))
    net = tn.ScoreNetMultiPair()
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    T._self_biased_cross_attention_init(net)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    W = net.att_cross.in_proj_weight
    D = W.shape[1]
    assert torch.equal(W[D:2 * D], W[:D]) and not torch.equal(W[2 * D:], W[:D])


@pytest.mark.parametrize("net", ["refiner", "scorer"])
def test_init_flax_style_statistics(net):
    """The port's draws follow flax's initialisers, layer by layer."""
    dummy = jnp.zeros((2, 16, 16, 6), jnp.float32)
    if net == "refiner":
        jmodel, tmodel, args = jn.RefineNet(c_in=6), tn.RefineNet(), (dummy, dummy)
    else:
        jmodel, tmodel, args = jn.ScoreNetMultiPair(c_in=6), tn.ScoreNetMultiPair(), \
            (dummy, dummy, 2)
    init = jax.jit(jmodel.init, static_argnums=3) if net == "scorer" else jax.jit(jmodel.init)
    flax = params_from_jax(jax.tree.map(np.asarray,
                                        init(jax.random.PRNGKey(0), *args)["params"]))
    tn.init_flax_style(tmodel, torch.Generator().manual_seed(0))
    for k, p in tmodel.named_parameters():
        x, r = p.detach().numpy().astype(np.float64), flax[k].numpy().astype(np.float64)
        if k.startswith(tn.ZERO_HEADS) or (p.ndim == 1 and not k.endswith("norm1.weight")
                                           and not k.endswith("norm2.weight")):
            assert (x == 0).all() and (r == 0).all(), k
            continue
        if p.ndim == 1:  # LayerNorm scales
            assert (x == 1).all() and (r == 1).all(), k
            continue
        fan_in = p[0].numel()
        std = math.sqrt((2.0 if p.ndim == 4 else 1.0) / fan_in)
        # a truncated normal's variance is std^2 by construction; the sample
        # std's standard error is about std * sqrt(0.7 / n) (kurtosis 2.4)
        se = std * math.sqrt(0.7 / x.size)
        assert abs(x.std() - std) < 5 * se and abs(r.std() - std) < 5 * se, (k, x.std(), std)
        assert np.abs(x).max() <= 2 * std / tn._TRUNC_STD * (1 + 1e-6), k
        assert abs(x.mean()) < 5 * std / math.sqrt(x.size), k


def test_fixed_batch_overfit_at_jax_test_setting():
    """tests/test_parallel.py's setting: the full-width refiner, batch 8 at
    48x48, zero heads, gradients clipped to 1 then Adam 3e-4, 40 steps:
    the loss ends below 0.8x its first value."""
    _, box = _box()
    cfg = T.TrainConfig(batch_size=8, input_hw=HW)
    batch = T.make_refiner_batch(T.refiner_draws(torch.Generator().manual_seed(0), cfg), box,
                                 torch.tensor(K_BOX), 0.1, cfg)
    model = tn.init_flax_style(tn.RefineNet(), torch.Generator().manual_seed(0))
    losses = T.overfit_fixed_batch(model, batch, 40, 3e-4, cfg, clip=1.0)
    assert losses[-1] < OVERFIT_RATIO * losses[0], losses


def test_checkpoint_round_trip(tmp_path):
    """save_params -> models/checkpoint.py -> the predictors: the same
    weights, the trained occ_sub back in the refiner's cfg; writing beside
    the bf16 export keeps the scorer's entry, and its dtype, intact."""
    ref_net = tn.init_flax_style(tn.RefineNet(), torch.Generator().manual_seed(3))
    sc_net = T._self_biased_cross_attention_init(
        tn.init_flax_style(tn.ScoreNetMultiPair(), torch.Generator().manual_seed(4)))
    T.save_params(str(tmp_path / "a"), "refiner", ref_net, {"occ_sub": 0.85})
    T.save_params(str(tmp_path / "a"), "scorer", sc_net)
    assert sorted(os.listdir(tmp_path / "a")) == ["MANIFEST.json", "refiner.npz", "scorer.npz"]
    manifest = json.load(open(tmp_path / "a" / "MANIFEST.json"))
    assert manifest["refiner"]["compute_dtype"] == manifest["scorer"]["compute_dtype"] == "float32"
    assert set(manifest["refiner"]["arrays"].values()) == {"fp32"}
    for cls, net, model in ((TRef, "refiner", ref_net), (TSc, "scorer", sc_net)):
        pred = cls("cpu", ckpt_dir=str(tmp_path / "a"), compute_dtype=torch.float32)
        for k, v in model.state_dict().items():
            assert torch.equal(pred.model.state_dict()[k], v), k
    assert TRef("cpu", ckpt_dir=str(tmp_path / "a")).cfg["occ_sub"] == 0.85
    assert "occ_sub" not in manifest["scorer"].get("cfg", {})
    # beside the bundled bf16 export: the refiner is replaced, the scorer kept
    shutil.copytree(os.path.join(REPO, "weights_torch"), tmp_path / "b")
    T.save_params(str(tmp_path / "b"), "refiner", ref_net)
    manifest = json.load(open(tmp_path / "b" / "MANIFEST.json"))
    assert manifest["compute_dtype"] == "bfloat16" and manifest["tool"]
    assert checkpoint.stored_dtype(str(tmp_path / "b" / "refiner.npz"), "refiner") == "float32"
    assert checkpoint.stored_dtype(str(tmp_path / "b" / "scorer.npz"), "scorer") == "bfloat16"
    sd = checkpoint.load_params(str(tmp_path / "b"), "refiner", compute_dtype=torch.float32)
    assert all(torch.equal(sd[k], v) for k, v in ref_net.state_dict().items())
    with pytest.raises(ValueError, match="bf16"):
        checkpoint.load_params(str(tmp_path / "b"), "scorer", compute_dtype=torch.float32)
    assert not [f for f in os.listdir(tmp_path / "b") if "tmp" in f]


def test_fine_tuning_starts_from_the_widened_export():
    sd = T.load_init_params(os.path.join(REPO, "weights_torch"), "refiner")
    ref = checkpoint.load_params(os.path.join(REPO, "weights_torch"), "refiner")
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd)
    assert T.load_init_params("", "refiner") is None


def test_tool_at_a_tiny_size(tmp_path, monkeypatch):
    """tools/train_torch_networks.py: 1 refiner and 1 scorer step on one
    procedural object, batch 2 at 32x32, on the CPU; OCC_SUB lands in the
    manifest, and the predictors load what it wrote."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import train_torch_networks as tool

    monkeypatch.setenv("OCC_SUB", "0.85")
    res = tool.main(["proc:1"], 1, 1, str(tmp_path), device="cpu", batch_size=2,
                    input_hw=(32, 32), n_hypotheses=2)
    assert all(np.isfinite(res[n][0]) for n in ("refiner", "scorer"))
    manifest = json.load(open(tmp_path / "MANIFEST.json"))
    assert manifest["refiner"]["cfg"] == {"occ_sub": 0.85}
    assert TRef("cpu", ckpt_dir=str(tmp_path)).cfg["occ_sub"] == 0.85
    TSc("cpu", ckpt_dir=str(tmp_path), compute_dtype=torch.float32)


def test_trainers_share_one_model_round_robin():
    """`sharing` steps one model and one Adam on another object's mesh, as
    the JAX tool's round-robin shares params and optimiser state; a step
    returns its loss as a 0-d tensor, off the graph."""
    from sixdof_tpu_torch.parallel.procgen import procedural_objects

    _, box = _box()
    proc = procedural_objects(1, K_BOX, "cpu", subdivisions=1)[0]
    cfg = T.TrainConfig(batch_size=2, input_hw=(32, 32), n_hypotheses=2)
    for cls, net in ((T.RefinerTrainer, tn.RefineNet()), (T.ScorerTrainer, tn.ScoreNetMultiPair())):
        first = cls(net, box, K_BOX, 0.1, cfg)
        other = first.sharing(*proc)
        assert other.model is first.model and other.optimizer is first.optimizer
        before = {k: v.clone() for k, v in first.model.state_dict().items()}
        gen = torch.Generator().manual_seed(0)
        for loss in (first.step(gen), other.step(gen)):
            assert loss.ndim == 0 and not loss.requires_grad and torch.isfinite(loss)
        assert first.optimizer.state_dict()["state"][0]["step"] == 2
        assert any(not torch.equal(before[k], v) for k, v in first.model.state_dict().items())
