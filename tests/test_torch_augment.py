"""The sensor model of the trainer's B crops (parallel/augment.py): the
port against the JAX package on the CPU, fed the draws the JAX functions
take from their keys (rebuilt by repeating their key splits,
tests/torch_train_draws.py).

Tolerances: 1e-6 everywhere (float32 ops in another order, or pow/exp of
another library: a few ulps), except at threshold decisions on float math,
where a pixel may flip only where JAX's own value lies within 1e-6 of the
threshold (the margin rule; the test computes JAX's value itself):
- the hole mask `field < thresh` (jax.image.resize's weights are
  reproduced, their contraction order is not: ~5e-7 apart);
- the uint8 quantisation (round half to even of value x 255).
The edge dropout and the pooling are exact (max/min, a difference and a
compare of the same floats)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.parallel import augment as ja
from sixdof_tpu_torch.parallel import augment as ta
from torch_train_draws import pair_draws, rgb_draws, to_torch, xyz_draws

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

MARGIN = 1e-6


def _rgb(N=3, H=24, W=32, seed=0):
    return np.random.RandomState(seed).rand(N, H, W, 3).astype(np.float32)


def _xyz(N=3, H=24, W=32, seed=0):
    """A nearer box over a background plane, an invalid strip, per-sample
    depth offsets: camera-space xyz."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for n in range(N):
        z = np.full((H, W), 0.7 + 0.05 * n, np.float32)
        z[6:18, 8:22] = 0.5 + rng.uniform(-0.02, 0.02)
        z = z + rng.normal(0, 0.002, z.shape).astype(np.float32)
        xyz = np.stack([(xs - W / 2) / 300.0 * z, (ys - H / 2) / 300.0 * z, z], -1)
        xyz[:2] = 0.0
        out.append(xyz)
    return np.stack(out).astype(np.float32)


def _jax_rgb_pre_round(d, rgb, strength):
    """degrade_rgb_batch's lines before the rounding, in JAX, on the draws."""
    gain = 2.0 ** (jnp.asarray(d["gain"]) * strength)
    gamma = 1.0 + jnp.asarray(d["gamma"]) * strength
    wb = 1.0 + jnp.asarray(d["wb"]) * strength
    img = jnp.clip(jnp.asarray(rgb) * gain * wb, 0.0, 1.0) ** gamma
    blend = jnp.asarray(d["blend"]) * strength
    img = (1.0 - blend) * img + blend * ja._blur5(img, sigma=1.0)
    shot = jnp.asarray(d["shot"]) * (0.015 * strength) * jnp.sqrt(jnp.clip(img, 0.01, 1.0))
    read = jnp.asarray(d["read"]) * (0.008 * strength)
    return np.asarray(jnp.clip(img + shot + read, 0.0, 1.0))


def _near_half(pre):
    """Where value x 255 lies within MARGIN (in value) of a rounding tie."""
    x = pre.astype(np.float64) * 255.0
    return np.abs(x - np.floor(x) - 0.5) < MARGIN * 255.0


def test_blur_and_pool_match_jax():
    img = _rgb()
    np.testing.assert_allclose(ta._blur5(torch.tensor(img)).numpy(),
                               np.asarray(ja._blur5(jnp.asarray(img))), rtol=0, atol=MARGIN)
    z = _xyz()[..., 2]
    z[0, 5, 5] = np.inf  # +-inf padding semantics, not zeros
    for op in ("min", "max"):
        np.testing.assert_array_equal(ta._pool(torch.tensor(z), op).numpy(),
                                      np.asarray(ja._pool(jnp.asarray(z), op)))
        np.testing.assert_array_equal(ta._pool(torch.tensor(-z), op, 5).numpy(),
                                      np.asarray(jax.lax.reduce_window(
                                          jnp.asarray(-z), jnp.inf if op == "min" else -jnp.inf,
                                          jax.lax.min if op == "min" else jax.lax.max,
                                          (1, 5, 5), (1, 1, 1), "SAME")))


@pytest.mark.parametrize("shape", [(2, 8, 8, 24, 32), (3, 8, 8, 160, 160), (2, 16, 16, 48, 48)])
def test_resize_linear_matches_jax_image_resize(shape):
    N, h, w, H, W = shape
    x = np.random.RandomState(1).rand(N, h, w, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (N, H, W, 3), method="linear"))
    got = ta.resize_linear(torch.tensor(x), (H, W)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=MARGIN)
    ref2 = np.asarray(jax.image.resize(jnp.asarray(x[..., 0]), (N, H, W), method="bilinear"))
    np.testing.assert_allclose(ta.resize_linear(torch.tensor(x[..., 0]), (H, W)).numpy(), ref2,
                               rtol=0, atol=MARGIN)


@pytest.mark.parametrize("strength", [1.0, 0.6])
@pytest.mark.parametrize("seed", [0, 1])
def test_degrade_rgb_batch_matches_jax(seed, strength):
    rgb = _rgb(seed=seed)
    key = jax.random.PRNGKey(seed)
    d = rgb_draws(key, rgb.shape)
    ref = np.asarray(ja.degrade_rgb_batch(key, jnp.asarray(rgb), strength))
    got = ta.degrade_rgb_batch(to_torch(d), torch.tensor(rgb), strength).numpy()
    pre = _jax_rgb_pre_round(d, rgb, strength)
    # the continuous part first, then the quantised output
    np.testing.assert_allclose(ta.degrade_rgb_linear(to_torch(d), torch.tensor(rgb),
                                                     strength).numpy(), pre, rtol=0, atol=MARGIN)
    flip = np.abs(got - ref) > MARGIN
    assert not (flip & ~_near_half(pre)).any(), "a level flipped away from a rounding tie"
    assert flip.mean() < 1e-3
    np.testing.assert_allclose(got[~flip], ref[~flip], rtol=0, atol=MARGIN)


@pytest.mark.parametrize("strength", [1.0, 2.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_degrade_xyz_batch_matches_jax(seed, strength):
    xyz = _xyz(seed=seed)
    key = jax.random.PRNGKey(10 + seed)
    d = xyz_draws(key, xyz.shape)
    ref = np.asarray(ja.degrade_xyz_batch(key, jnp.asarray(xyz), strength))
    got = ta.degrade_xyz_batch(to_torch(d), torch.tensor(xyz), strength).numpy()
    # JAX's own hole field and threshold, for the margin rule
    N, H, W = xyz.shape[:3]
    field = np.asarray(jax.image.resize(d["field"], (N, H, W), method="bilinear"))
    thresh = np.asarray(0.04 * strength * d["thresh"])
    near = np.abs(field - thresh) < MARGIN
    flip = (ref[..., 2] == 0) != (got[..., 2] == 0)
    assert not (flip & ~near).any(), "a hole flipped away from the threshold"
    assert (got[..., 2] == 0).any() and (got[..., 2] > 0).any()
    np.testing.assert_allclose(got[~flip], ref[~flip], rtol=0, atol=MARGIN)


@pytest.mark.parametrize("p_sensor", [0.5, 1.0, 0.0])
def test_maybe_degrade_pair_matches_jax(p_sensor):
    rgb, xyz = _rgb(N=6, seed=2), _xyz(N=6, seed=2)
    key = jax.random.PRNGKey(20)
    d = pair_draws(key, rgb.shape)
    ref_rgb, ref_xyz = (np.asarray(x) for x in ja.maybe_degrade_pair(
        key, jnp.asarray(rgb), jnp.asarray(xyz), p_sensor, 1.0))
    got_rgb, got_xyz = (x.numpy() for x in ta.maybe_degrade_pair(
        to_torch(d), torch.tensor(rgb), torch.tensor(xyz), p_sensor, 1.0))
    sel = np.asarray(d["select"])[:, 0, 0, 0] < p_sensor
    # the Bernoulli selection as JAX draws it
    np.testing.assert_array_equal(sel, np.asarray(jax.random.bernoulli(
        jax.random.split(key, 3)[0], p_sensor, (6, 1, 1, 1)))[:, 0, 0, 0])
    np.testing.assert_array_equal(got_rgb[~sel], rgb[~sel])
    np.testing.assert_array_equal(got_xyz[~sel], xyz[~sel])
    pre = _jax_rgb_pre_round(d["rgb"], rgb, 1.0)
    flip = np.abs(got_rgb - ref_rgb) > MARGIN
    assert not (flip & ~_near_half(pre)).any()
    np.testing.assert_allclose(got_rgb[~flip], ref_rgb[~flip], rtol=0, atol=MARGIN)
    field = np.asarray(jax.image.resize(d["xyz"]["field"], (6, 24, 32), method="bilinear"))
    near = np.abs(field - np.asarray(0.04 * d["xyz"]["thresh"])) < MARGIN
    hole_flip = (got_xyz[..., 2] == 0) != (ref_xyz[..., 2] == 0)
    assert not (hole_flip & ~near).any()
    np.testing.assert_allclose(got_xyz[~hole_flip], ref_xyz[~hole_flip], rtol=0, atol=MARGIN)
