"""RefineNet / ScoreNetMultiPair: the port's nn.Modules on the bundled
weights (weights/refiner, weights/scorer, loaded through the JAX predictors
and converted by models/weights.py) against the flax modules."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.models.networks import RefineNet as JRefine
from sixdof_tpu.models.networks import ScoreNetMultiPair as JScore
from sixdof_tpu.models.networks import sinusoidal_position_embedding as j_pe
from sixdof_tpu.models.predict import PoseRefinePredictor, ScorePredictor
from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models.weights import params_from_jax

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides: only summation order differs (measured ~1e-6)
FP32_ATOL = 2e-5
# bf16 activations round where flax rounds them (networks.py: the bias added
# after the product's rounding); what differs is the fp32 accumulators'
# summation order, measured up to 6.0e-4 on these inputs (0.0069 while
# autocast fused the bias)
BF16_ATOL = 0.002


@pytest.fixture(scope="module")
def nets():
    jr = PoseRefinePredictor(ckpt_dir=os.path.join(REPO, "weights", "refiner"),
                             compute_dtype=jnp.float32)
    js = ScorePredictor(ckpt_dir=os.path.join(REPO, "weights", "scorer"),
                        compute_dtype=jnp.float32)
    rp = jax.tree.map(np.asarray, jr.params)
    sp = jax.tree.map(np.asarray, js.params)
    R, S = tn.RefineNet(), tn.ScoreNetMultiPair()
    R.load_state_dict(params_from_jax(rp))
    S.load_state_dict(params_from_jax(sp))
    return jr, js, R.eval(), S.eval()


def _pair(seed, n, hw):
    rng = np.random.RandomState(seed)
    A = rng.rand(n, *hw, 6).astype(np.float32)
    B = (A + 0.05 * rng.randn(n, *hw, 6)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("hw", [(160, 160), (96, 96)])
def test_refine_net_fp32(nets, hw):
    jr, _, R, _ = nets
    A, B = _pair(0, 2, hw)
    ref = jr.model.apply({"params": jr.params}, A, B)
    with torch.no_grad():
        got = R(torch.tensor(A), torch.tensor(B))
    for k in ("trans", "rot"):
        assert np.abs(np.asarray(ref[k])).max() > 1e-2  # the bundled weights are live
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=FP32_ATOL)


@pytest.mark.parametrize("hw,L", [((160, 160), 3), ((96, 96), 2)])
def test_score_net_fp32(nets, hw, L):
    _, js, _, S = nets
    A, B = _pair(1, 2 * L, hw)
    ref = np.asarray(js.model.apply({"params": js.params}, A, B, L=L)["score_logit"])
    with torch.no_grad():
        got = S(torch.tensor(A), torch.tensor(B), L)["score_logit"].numpy()
    assert got.shape == ref.shape == (2, L)
    np.testing.assert_allclose(got, ref, atol=FP32_ATOL)


def test_networks_bf16_autocast(nets):
    jr, js, R, S = nets
    A, B = _pair(2, 2, (96, 96))
    jR = JRefine(c_in=6, dtype=jnp.bfloat16)
    jS = JScore(c_in=6, dtype=jnp.bfloat16)
    ref = jR.apply({"params": jr.params}, A, B)
    ref_s = np.asarray(jS.apply({"params": js.params}, A, B, L=2)["score_logit"])
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = R(torch.tensor(A), torch.tensor(B))
        got_s = S(torch.tensor(A), torch.tensor(B), 2)["score_logit"]
    for k in ("trans", "rot"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=BF16_ATOL)
    np.testing.assert_allclose(got_s.float().numpy(), ref_s, atol=BF16_ATOL)


def test_position_embedding_extension():
    """Crops above 160x160 give more than 400 tokens: the table is extended
    by the same formula, as in the JAX modules."""
    np.testing.assert_array_equal(tn.sinusoidal_position_embedding(400, 512), j_pe(400, 512))
    pe = tn._position_embedding(576, 512, "cpu").numpy()
    np.testing.assert_array_equal(pe, j_pe(576, 512))
    np.testing.assert_array_equal(tn._position_embedding(144, 512, "cpu").numpy(),
                                  j_pe(400, 512)[:, :144])
