"""Batched crop warps of the real image into hypothesis crop windows.

Port of `sixdof_tpu/ops/warp.py::warp_crop_batch`.  The crop transforms are
axis-aligned affine (diag(sx,sy) + t), so resampling is separable:
out = Ry @ img @ Cx^T with per-pose 1-D interpolation matrices, run as two
batched fp32 matmuls.  Pixel-centre convention as in ops/rasterize.py
(u = column at the pixel centre), zero outside the source.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _interp_matrix(scale, shift, n_out, n_src, mode):
    """(B, n_out, n_src) interpolation weights for src = (dst - shift) / scale."""
    dst = torch.arange(n_out, dtype=torch.float32, device=scale.device)[None]
    src = (dst - shift[:, None]) / scale[:, None]
    if mode == "nearest":
        idx = torch.round(src).long()
        valid = (src >= -0.5) & (src <= n_src - 0.5)
        M = F.one_hot(torch.clamp(idx, 0, n_src - 1), n_src).float()
        return M * valid[..., None]
    x0 = torch.floor(src)
    frac = src - x0
    x0i = x0.long()
    valid = (src >= 0) & (src <= n_src - 1)
    M = (F.one_hot(torch.clamp(x0i, 0, n_src - 1), n_src).float() * (1 - frac)[..., None]
         + F.one_hot(torch.clamp(x0i + 1, 0, n_src - 1), n_src).float() * frac[..., None])
    return M * valid[..., None]


def warp_crop_batch(img, tfs, out_hw, mode="bilinear"):
    """@img: (H,W,C) or (H,W); @tfs: (B,3,3) src->dst; returns (B,Ho,Wo,C)
    (or (B,Ho,Wo) for a 2-D image)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    Ho, Wo = out_hw
    tfs = tfs.float()
    Ry = _interp_matrix(tfs[:, 1, 1], tfs[:, 1, 2], Ho, H, mode)  # (B,Ho,H)
    Cx = _interp_matrix(tfs[:, 0, 0], tfs[:, 0, 2], Wo, W, mode)  # (B,Wo,W)
    tmp = torch.matmul(Ry, img.float().reshape(H, W * C)).reshape(-1, Ho, W, C)
    out = torch.einsum("bhWc,bwW->bhwc", tmp, Cx)
    return out[..., 0] if squeeze else out
