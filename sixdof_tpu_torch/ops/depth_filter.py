"""Depth-map preprocessing: erosion + bilateral filter as window stencils.

Port of `sixdof_tpu/ops/depth_filter.py`: the same (2r+1)^2 stack of shifted
copies over a NaN-padded map, with float sums taken one offset at a time
as XLA takes the window mean.  Erosion matches the JAX package bit for bit;
the bilateral filter's weighted sums are fused by XLA in an order that
torch does not reproduce, so it agrees to a few float32 ulps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _window_stack(depth, radius):
    """(H,W) -> (K,H,W) shifted copies, out-of-bounds = NaN, row-major offsets."""
    H, W = depth.shape
    padded = F.pad(depth[None, None], (radius,) * 4, value=float("nan"))[0, 0]
    k = 2 * radius + 1
    return torch.stack([padded[dv : dv + H, du : du + W]
                        for dv in range(k) for du in range(k)], dim=0)


def _seq_sum(stack):
    """Sum over the offset axis in offset order, one add at a time: the
    order XLA reduces in, which torch.sum does not keep."""
    out = stack[0].clone()
    for k in range(1, stack.shape[0]):
        out = out + stack[k]
    return out


def erode_depth(depth, radius=2, depth_diff_thres=0.001, ratio_thres=0.8, zfar=100.0):
    """Zero a pixel when more than ratio_thres of its in-bounds window is bad
    (<1 mm, >= zfar, or more than depth_diff_thres from the centre)."""
    depth = depth.float()
    win = _window_stack(depth, radius)
    in_bounds = ~torch.isnan(win)
    win0 = torch.where(in_bounds, win, 0.0)
    bad = in_bounds & ((win0 < 0.001) | (win0 >= zfar)
                       | (torch.abs(win0 - depth[None]) > depth_diff_thres))
    total = in_bounds.sum(dim=0).float()
    bad_cnt = bad.sum(dim=0).float()
    return torch.where(bad_cnt / total > ratio_thres, 0.0, depth)


def bilateral_filter_depth(depth, radius=2, zfar=100.0, sigma_d=2.0, sigma_r=100000.0):
    """Gaussian(space) x Gaussian(range) weighted mean over valid neighbours
    within 1 cm of the window's valid-mean depth; 0 where nothing qualifies."""
    depth = depth.float()
    win = _window_stack(depth, radius)
    in_bounds = ~torch.isnan(win)
    win0 = torch.where(in_bounds, win, 0.0)
    valid = in_bounds & (win0 >= 0.001) & (win0 < zfar)
    num_valid = valid.sum(dim=0).float()
    mean_depth = _seq_sum(torch.where(valid, win0, 0.0)) / torch.clamp(num_valid, min=1.0)

    offs = np.arange(-radius, radius + 1)
    dv, du = np.meshgrid(offs, offs, indexing="ij")
    spatial = np.exp(-(du.astype(np.float64) ** 2 + dv**2) / (2.0 * sigma_d**2)).reshape(-1)
    spatial = torch.as_tensor(spatial, dtype=torch.float32, device=depth.device)[:, None, None]

    # the constant divisor as its float32 reciprocal, as XLA compiles the
    # jitted JAX filter
    rng = torch.exp(-((depth[None] - win0) ** 2) * (1.0 / (2.0 * sigma_r**2)))
    w = spatial * rng
    use = valid & (torch.abs(win0 - mean_depth[None]) < 0.01)
    w = torch.where(use, w, 0.0)
    sum_w = _seq_sum(w)
    out = _seq_sum(w * win0) / torch.clamp(sum_w, min=1e-12)
    return torch.where((sum_w > 0) & (num_valid > 0), out, 0.0)


def preprocess_depth(depth, radius=2, zfar=100.0):
    """Erode, then the bilateral filter, as register and track_one apply
    them."""
    return bilateral_filter_depth(erode_depth(depth, radius=radius, zfar=zfar), radius=radius,
                                  zfar=zfar)
