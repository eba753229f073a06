"""Batched crop warps of the real image into hypothesis crop windows, and
the general homography warp.

Port of `sixdof_tpu/ops/warp.py`.
- `warp_crop_batch`: the crop transforms are axis-aligned affine
  (diag(sx,sy) + t), so resampling is separable: out = Ry @ img @ Cx^T
  with per-pose 1-D interpolation matrices, run as two batched fp32
  matmuls.
- `warp_perspective`: any (B,3,3) homography, as an explicit gather that
  follows the JAX function step by step: the inverse transform, the
  homogeneous divide, round-half-even (`torch.round`, as `jnp.round`) for
  "nearest" or the four-tap bilinear, and zero outside the same bounds.
  It is not `grid_sample`, whose pixel convention and border handling
  differ.
Pixel-centre convention as in ops/rasterize.py (u = column at the pixel
centre), zero outside the source.
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


def warp_perspective(img, tfs, out_hw, mode="bilinear"):
    """Warp an image into B crop windows.

    @img: (H,W,C) or (H,W) source image;
    @tfs: (B,3,3) source-pixel -> crop-pixel transforms (forward, like
          kornia: dst(x) = src(M^-1 x));
    @out_hw: (H_out, W_out).
    Returns (B,H_out,W_out,C) (or (B,H_out,W_out) for 2-D input), zero
    where the sample falls outside the source."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    Ho, Wo = out_hw
    dev = img.device
    inv = torch.linalg.inv(tfs.float())  # (B,3,3)
    gy, gx = torch.meshgrid(torch.arange(Ho, dtype=torch.float32, device=dev),
                            torch.arange(Wo, dtype=torch.float32, device=dev), indexing="ij")

    def row(i):  # (B,Ho,Wo): row i of inv applied to (x, y, 1)
        m = inv[:, i, :, None, None]
        return m[:, 0] * gx + m[:, 1] * gy + m[:, 2]

    w = row(2)
    sx = row(0) / w
    sy = row(1) / w

    def gather(iy, ix):
        return img[torch.clamp(iy, 0, H - 1), torch.clamp(ix, 0, W - 1)]  # (B,Ho,Wo,C)

    if mode == "nearest":
        out = gather(torch.round(sy).long(), torch.round(sx).long())
        valid = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    elif mode == "bilinear":
        fx0, fy0 = torch.floor(sx), torch.floor(sy)
        x0, y0 = fx0.long(), fy0.long()
        fx = (sx - fx0)[..., None]
        fy = (sy - fy0)[..., None]
        out = (gather(y0, x0) * (1 - fx) * (1 - fy)
               + gather(y0, x0 + 1) * fx * (1 - fy)
               + gather(y0 + 1, x0) * (1 - fx) * fy
               + gather(y0 + 1, x0 + 1) * fx * fy)
        valid = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    else:
        raise ValueError(mode)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))
    return out[..., 0] if squeeze else out
