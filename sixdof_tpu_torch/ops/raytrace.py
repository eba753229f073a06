"""Batched ray-mesh intersection (Moller-Trumbore) for defect projection.

Port of `sixdof_tpu/ops/raytrace.py` (`ray_mesh_intersect`,
`heatmap_to_rays`, `mesh_to_tri_verts`): every (ray, triangle) pair is
tested, with no tree build; misses return t = +inf.  On the card the pairs
run in kernel K2 (`kernels/raytrace.py`, `csrc/ray_mesh.cu`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import raytrace as k2


def ray_mesh_intersect(origins, dirs, ray_mask, tri_verts, tri_mask, use_pallas=None):
    """First-hit distances of rays against a triangle soup.

    @origins/@dirs: (N,3) rays (dirs need not be unit; t is in dir units);
    @ray_mask: (N,) valid-ray mask; @tri_verts: (T,3,3); @tri_mask: (T,).
    @use_pallas (JAX's name): False takes the kernel's plain PyTorch
    version on any device (a comparison run), as it takes JAX's XLA form;
    None or True kernel K2 on a CUDA tensor.  Returns t_hit (N,) float32,
    +inf for misses and masked rays.
    """
    tris = k2.pack_tris(tri_verts, tri_mask)
    fn = k2.ray_mesh_intersect_plain if use_pallas is False else k2.ray_mesh_intersect
    return fn(origins.to(torch.float32).contiguous(), dirs.to(torch.float32).contiguous(),
              ray_mask.to(torch.bool).contiguous(), tris)


def heatmap_to_rays(heatmap, K, threshold, max_points):
    """The heatmap's pixels above @threshold, brightest first, as unit rays
    through the camera @K, padded to a static count M = min(max_points,
    H*W) (JAX's top-k selection).  Equal values keep their pixel order, as
    `jax.lax.top_k` orders them: the order is a stable sort of (-value,
    index), not `torch.topk`, whose ties are unordered on the card.
    @heatmap: (H,W) tensor.  Returns (dirs (M,3) float32, intensities (M,)
    (0 where masked), mask (M,))."""
    H, W = heatmap.shape
    flat = heatmap.reshape(-1)
    score = torch.where(flat > threshold, flat, float("-inf"))
    M = min(max_points, H * W)
    order = torch.sort(-score, stable=True).indices[:M]
    vals = score[order]
    mask = vals > threshold
    ys = torch.div(order, W, rounding_mode="floor").to(torch.float32)
    xs = (order % W).to(torch.float32)
    K = torch.as_tensor(K, dtype=torch.float32, device=heatmap.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dirs = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    intensities = torch.where(mask, vals, 0.0)
    return dirs, intensities, mask


def mesh_to_tri_verts(vertices, faces):
    """(V,3),(F,3) -> (F,3,3) float32 triangle soup + all-true mask (host)."""
    tri = np.asarray(vertices)[np.asarray(faces)]
    return tri.astype(np.float32), np.ones(len(tri), dtype=bool)
