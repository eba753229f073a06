"""Sensor-degradation augmentation of the trainer's B crops.

Port of `sixdof_tpu/parallel/augment.py`: per-sample exposure gain, gamma,
white balance, a blended 5x5 blur, shot and read noise and uint8
quantisation on RGB; range-dependent axial noise, edge dropout and
low-frequency blob holes on xyz.  The JAX functions draw from a key; here
each takes a dict of draws (`rgb_draws`, `xyz_draws`, `pair_draws` make it
from a `torch.Generator`), every entry the value the JAX function's
`jax.random` call returns, so the same draws give the same result.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _uniform(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _weight_mat(n_in, n_out):
    """`jax.image.resize`'s linear weight matrix (n_in, n_out) for one axis,
    float32: triangle taps at half-pixel centres, each column normalised by
    its sum, columns whose sample lies outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(max(inv_scale, 1.0))
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_linear(x, out_hw):
    """`jax.image.resize(x, (N, *out_hw, ...), "linear")` of a (N,h,w) or
    (N,h,w,C) tensor: the same weights, contracted over h then w.  (Its
    antialias changes nothing when enlarging, the only use here.)"""
    h, w = x.shape[1:3]
    wh = torch.as_tensor(_weight_mat(h, out_hw[0]), device=x.device)
    ww = torch.as_tensor(_weight_mat(w, out_hw[1]), device=x.device)
    if x.ndim == 3:
        return torch.einsum("nhw,hH,wW->nHW", x, wh, ww)
    return torch.einsum("nhwc,hH,wW->nHWc", x, wh, ww)


def _gauss_kernel5(sigma, device):
    x = torch.arange(5.0, device=device) - 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _blur5(img, sigma=1.0):
    """Separable 5x5 gaussian blur of (N,H,W,C), edge-replicate padding;
    the taps summed in order, as the JAX version does."""
    g = _gauss_kernel5(sigma, img.device)
    H, W = img.shape[1:3]
    rows = torch.clamp(torch.arange(-2, H + 2, device=img.device), 0, H - 1)
    x = img[:, rows]
    x = sum(g[i] * x[:, i:i + H] for i in range(5))
    cols = torch.clamp(torch.arange(-2, W + 2, device=img.device), 0, W - 1)
    x = x[:, :, cols]
    return sum(g[i] * x[:, :, i:i + W] for i in range(5))


def _pool(x, op, size=3):
    """(N,H,W) min or max over a size x size window, 'same' shape: the
    border pads with -inf for max and +inf for min, as reduce_window's
    SAME padding does."""
    pad = size // 2
    if op == "max":
        return F.max_pool2d(x[:, None], size, 1, pad)[:, 0]
    return -F.max_pool2d(-x[:, None], size, 1, pad)[:, 0]


def rgb_draws(gen, shape):
    """The draws of `degrade_rgb_batch` for an (N,H,W,3) batch."""
    N = shape[0]
    return dict(gain=_uniform(gen, (N, 1, 1, 1), -0.35, 0.35),
                gamma=_uniform(gen, (N, 1, 1, 1), -0.15, 0.20),
                wb=_uniform(gen, (N, 1, 1, 3), -0.08, 0.08),
                blend=_uniform(gen, (N, 1, 1, 1)),
                shot=_normal(gen, tuple(shape)), read=_normal(gen, tuple(shape)))


def degrade_rgb_linear(draws, rgb, strength=1.0):
    """`degrade_rgb_batch` before its uint8 quantisation."""
    gain = 2.0 ** (draws["gain"] * strength)
    gamma = 1.0 + draws["gamma"] * strength
    wb = 1.0 + draws["wb"] * strength
    img = torch.clamp(rgb * gain * wb, 0.0, 1.0) ** gamma
    blend = draws["blend"] * strength
    img = (1.0 - blend) * img + blend * _blur5(img, sigma=1.0)
    shot = draws["shot"] * (0.015 * strength) * torch.sqrt(torch.clamp(img, 0.01, 1.0))
    read = draws["read"] * (0.008 * strength)
    return torch.clamp(img + shot + read, 0.0, 1.0)


def degrade_rgb_batch(draws, rgb, strength=1.0):
    """(N,H,W,3) in [0,1] -> photometrically degraded, quantised to uint8
    levels (round half to even, as jnp.round)."""
    return torch.round(degrade_rgb_linear(draws, rgb, strength) * 255.0) / 255.0


def xyz_draws(gen, shape):
    """The draws of `degrade_xyz_batch` for an (N,H,W,3) batch."""
    N, H, W = shape[:3]
    return dict(axial=_normal(gen, (N, H, W)), drop=_uniform(gen, (N, H, W)),
                field=_uniform(gen, (N, 8, 8)), thresh=_uniform(gen, (N, 1, 1), 0.0, 2.0))


def degrade_xyz_batch(draws, xyz, strength=1.0):
    """(N,H,W,3) camera-space points (0 = invalid) -> sensor-degraded.
    Every z change rescales the point along its pixel ray."""
    z = xyz[..., 2]
    valid = z > 1e-6
    sigma = (0.0012 + 0.0019 * (z - 0.4) ** 2) * strength
    z_noisy = z + draws["axial"] * sigma
    # invalid = "far": valid/invalid borders count as discontinuities
    big = torch.where(valid, z, 1e3)
    edge = (_pool(big, "max", 3) - _pool(big, "min", 3)) > 0.012
    drop = edge & valid & (draws["drop"] < 0.40 * strength)
    # blob holes: a thresholded low-frequency field (8x8 noise upsampled)
    hole = resize_linear(draws["field"], xyz.shape[1:3]) < 0.04 * strength * draws["thresh"]
    keep = valid & ~drop & ~hole
    scale = torch.where(valid, z_noisy / torch.clamp(z, min=1e-6), 0.0)
    return torch.where(keep[..., None], xyz * scale[..., None], 0.0)


def pair_draws(gen, shape):
    """The draws of `maybe_degrade_pair` for (N,H,W,3) crops."""
    return dict(select=_uniform(gen, (shape[0], 1, 1, 1)), rgb=rgb_draws(gen, shape),
                xyz=xyz_draws(gen, shape))


def maybe_degrade_pair(draws, rgbB, xyzB, p_sensor=0.5, strength=1.0):
    """The sensor model on the samples whose select draw is below
    @p_sensor (Bernoulli per sample)."""
    sel = draws["select"] < p_sensor
    rgb_d = degrade_rgb_batch(draws["rgb"], rgbB, strength)
    xyz_d = degrade_xyz_batch(draws["xyz"], xyzB, strength)
    return torch.where(sel, rgb_d, rgbB), torch.where(sel, xyz_d, xyzB)
