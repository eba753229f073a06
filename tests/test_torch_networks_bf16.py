"""RefineNet / ScoreNetMultiPair under bf16 autocast against the flax
modules at `dtype=bfloat16`, layer by layer, on the bundled weights.

Each layer is given the input the flax network gives it (flax's own
intermediate, captured on a seeded 96x96 pair), so what is compared is
where that layer rounds, not what earlier layers passed on.  flax's
`nn.Conv` and `nn.Dense` at bf16 round the product to bf16 and then add
the bf16 bias, a second rounding; attention divides its bf16 scores by
sqrt(head dim) rounded to bf16.  Tolerance: at least 99% of each bf16
output bit-equal to flax's, and every element within 2 bf16 ulps of the
layer's largest output magnitude (measured: at most 0.0625 on outputs up to
15.4, 1.06 ulps); what remains is the fp32 accumulators' summation order.  With torch autocast's fused bias
about a quarter of the outputs of a layer round differently.  The
transformer layers' float32 LayerNorms are held by tests/test_torch_networks.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.models import networks as jn
from sixdof_tpu.models.predict import PoseRefinePredictor, ScorePredictor
from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models.weights import params_from_jax

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = jnp.bfloat16
MIN_BIT_EQUAL = 0.99
MAX_ULPS = 2


def _intermediates(st):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(st["intermediates"])[0]:
        out["/".join(k.key for k in path if hasattr(k, "key"))[: -len("/__call__")]] = v
    return out


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_torch(x):
    """flax's NHWC / (B,N,D) activation as the port's input (NCHW)."""
    t = torch.tensor(_f32(x))
    t = t.permute(0, 3, 1, 2) if t.ndim == 4 else t
    return t.to(torch.bfloat16) if jnp.asarray(x).dtype == BF else t


def _compare(name, want, got):
    """Share of elements bit-equal, and the largest difference in bf16 ulps
    of the layer's largest output magnitude."""
    got = got.detach().float()
    got = (got.permute(0, 2, 3, 1) if got.ndim == 4 else got).numpy()
    want = _f32(want)
    assert got.shape == want.shape, name
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)  # at the largest |output|
    return float((got == want).mean()), float(np.abs(got - want).max() / ulp)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for key, pred, jcls, tcls in (("refiner", PoseRefinePredictor, jn.RefineNet, tn.RefineNet),
                                  ("scorer", ScorePredictor, jn.ScoreNetMultiPair,
                                   tn.ScoreNetMultiPair)):
        params = pred(ckpt_dir=os.path.join(REPO, "weights", key),
                      compute_dtype=jnp.float32).params
        net = tcls()
        net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        out[key] = (params, jcls(c_in=6, dtype=BF), net.eval())
    return out


def _layers(key, params, jnet, net, A, B, L):
    """(name, flax module, its params, port module, input) for every layer
    of the network, each input flax's own activation."""
    extra = () if key == "refiner" else (L,)
    _, st = jnet.apply({"params": params}, A, B, *extra, capture_intermediates=True,
                       mutable=["intermediates"])
    inter = _intermediates(st)
    trunk = params["trunk"]
    encA = net.encodeA if key == "refiner" else net.encoderA
    encAB = net.encodeAB if key == "refiner" else net.encoderAB
    x = jnp.concatenate([A, B], 0)
    for i, (m, tm) in enumerate(zip([jn.ConvReLU(64, 7, 2, dtype=BF),
                                     jn.ConvReLU(128, 3, 2, dtype=BF),
                                     jn.ResnetBasicBlock(128, dtype=BF),
                                     jn.ResnetBasicBlock(128, dtype=BF)], encA)):
        yield f"encodeA_{i}", m, trunk[f"encodeA_{i}"], tm, x
        x = inter[f"trunk/encodeA_{i}"]
    n = A.shape[0]
    x = jnp.concatenate([x[:n], x[n:]], -1)
    for i, (m, tm) in enumerate(zip([jn.ResnetBasicBlock(256, dtype=BF),
                                     jn.ResnetBasicBlock(256, dtype=BF),
                                     jn.ConvReLU(512, 3, 2, dtype=BF),
                                     jn.ResnetBasicBlock(512, dtype=BF),
                                     jn.ResnetBasicBlock(512, dtype=BF)], encAB)):
        yield f"encodeAB_{i}", m, trunk[f"encodeAB_{i}"], tm, x
        x = inter[f"trunk/encodeAB_{i}"]
    tokens = inter["trunk"]
    tokens = tokens + jnp.asarray(jn.sinusoidal_position_embedding(400, 512)[:, :tokens.shape[1]],
                                  dtype=BF)
    attention = jn.MultiheadAttention(512, 4, dtype=BF)
    if key == "refiner":
        for head, tm in (("trans", net.trans_head[0]), ("rot", net.rot_head[0])):
            p = params[f"{head}_encoder"]
            yield f"{head}.self_attn", attention, p["self_attn"], tm.self_attn, tokens
            yield (f"{head}.linear1", jn.nn.Dense(512, dtype=BF), p["linear1"], tm.linear1,
                   inter[f"{head}_encoder/norm1"])
            yield (f"{head}.linear2", jn.nn.Dense(512, dtype=BF), p["linear2"], tm.linear2,
                   jax.nn.relu(inter[f"{head}_encoder/linear1"]))
    else:
        yield "att", attention, params["att"], net.att, tokens
        feats = inter["att"].mean(axis=1).reshape(n // L, L, -1)
        yield "att_cross", attention, params["att_cross"], net.att_cross, feats


@pytest.mark.parametrize("key", ["refiner", "scorer"])
def test_bf16_layers_round_as_flax(nets, key):
    params, jnet, net = nets[key]
    rng = np.random.RandomState(2)
    A = rng.rand(4, 96, 96, 6).astype(np.float32)
    B = (A + 0.05 * rng.randn(4, 96, 96, 6)).astype(np.float32)
    report = {}
    for name, jm, jp, tm, x in _layers(key, params, jnet, net, A, B, L=2):
        want = jm.apply({"params": jp}, x)
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            got = tm(_to_torch(x))
        assert got.dtype == torch.bfloat16, name
        report[name] = _compare(name, want, got)
    assert len(report) == (15 if key == "refiner" else 11)
    low = {k: v for k, v in report.items() if v[0] < MIN_BIT_EQUAL or v[1] > MAX_ULPS}
    assert not low, f"layers rounding unlike flax (bit-equal share, ulps): {low}"


def test_fp32_path_unchanged_by_the_bf16_rounding(nets):
    """Outside autocast every layer is the plain nn.Conv2d / nn.Linear call:
    the port's float32 outputs are those of torch's own modules."""
    _, _, net = nets["refiner"]
    x = torch.randn(2, 128, 12, 12, generator=torch.Generator().manual_seed(0))
    conv = net.encodeA[2].conv1
    np.testing.assert_array_equal(conv(x).detach().numpy(),
                                  torch.nn.functional.conv2d(x, conv.weight, conv.bias, 1, 1)
                                  .detach().numpy())
    t = torch.randn(2, 9, 512, generator=torch.Generator().manual_seed(1))
    lin = net.trans_head[0].linear1
    np.testing.assert_array_equal(lin(t).detach().numpy(),
                                  torch.nn.functional.linear(t, lin.weight, lin.bias)
                                  .detach().numpy())
