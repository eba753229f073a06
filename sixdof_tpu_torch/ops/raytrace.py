"""Batched ray-mesh intersection (Moller-Trumbore) for defect projection.

Port of `sixdof_tpu/ops/raytrace.py::ray_mesh_intersect` and
`mesh_to_tri_verts`: every (ray, triangle) pair is tested, with no tree
build; misses return t = +inf.  On the card the pairs run in kernel K2
(`kernels/raytrace.py`, `csrc/ray_mesh.cu`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import raytrace as k2


def ray_mesh_intersect(origins, dirs, ray_mask, tri_verts, tri_mask, plain=False):
    """First-hit distances of rays against a triangle soup.

    @origins/@dirs: (N,3) rays (dirs need not be unit; t is in dir units);
    @ray_mask: (N,) valid-ray mask; @tri_verts: (T,3,3); @tri_mask: (T,).
    @plain: take the kernel's plain PyTorch version on any device (a
    comparison run).  Returns t_hit (N,) float32, +inf for misses and
    masked rays.
    """
    tris = k2.pack_tris(tri_verts, tri_mask)
    fn = k2.ray_mesh_intersect_plain if plain else k2.ray_mesh_intersect
    return fn(origins.to(torch.float32).contiguous(), dirs.to(torch.float32).contiguous(),
              ray_mask.to(torch.bool).contiguous(), tris)


def mesh_to_tri_verts(vertices, faces):
    """(V,3),(F,3) -> (F,3,3) float32 triangle soup + all-true mask (host)."""
    tri = np.asarray(vertices)[np.asarray(faces)]
    return tri.astype(np.float32), np.ones(len(tri), dtype=bool)
