"""Point-cloud downsampling.

Port of `sixdof_tpu/ops/pointcloud.py::voxel_down_sample`, which the
estimator's object setup uses.  The rest of the JAX module serves the
capture slice and is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..io.mesh_io import PointCloud


def voxel_down_sample(pcd: PointCloud, voxel_size: float) -> PointCloud:
    """Average points (and colours/normals) per voxel — Open3D semantics."""
    pts = pcd.points
    if len(pts) == 0:
        return pcd.copy()
    coords = np.floor(pts / voxel_size).astype(np.int64)
    coords -= coords.min(axis=0)
    dims = coords.max(axis=0) + 1
    key = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    n_vox = counts.shape[0]

    def reduce_mean(arr):
        out = np.zeros((n_vox, arr.shape[1]), dtype=np.float64)
        np.add.at(out, inverse, arr)
        return out / counts[:, None]

    out_pts = reduce_mean(pts)
    out_colors = reduce_mean(pcd.colors) if pcd.colors is not None else None
    out_normals = None
    if pcd.normals is not None:
        out_normals = reduce_mean(pcd.normals)
        norm = np.linalg.norm(out_normals, axis=1, keepdims=True)
        out_normals = out_normals / np.clip(norm, 1e-12, None)
    return PointCloud(out_pts, colors=out_colors, normals=out_normals)
