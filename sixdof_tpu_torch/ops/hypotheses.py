"""Rotation-hypothesis grid: icosphere views x in-plane steps, clustered.

Port of `sixdof_tpu/ops/hypotheses.py` with the numpy path of
`cluster_poses` (the JAX package may call its native library instead; the
port never loads it).  Host-side numpy, run once per object.
"""
from __future__ import annotations

import numpy as np

from .lie import euler_matrix


def icosphere(subdivisions=1, radius=1.0):
    """Icosphere of @radius by icosahedron subdivision (12, 42, 162, ...
    vertices)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_cache = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_cache:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_cache[key] = len(verts_list)
                verts_list.append(m)
            return edge_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)
    return verts * radius, faces


def sample_views_icosphere(n_views, subdivisions=None, radius=1.0):
    """Camera-in-object poses looking at the origin from the vertices of an
    icosphere of @radius: @subdivisions times subdivided, or else the first
    with at least @n_views vertices (up=+z; degenerate poles get
    x=[1,0,0]).  Returns (V,4,4)."""
    if subdivisions is not None:
        verts, _ = icosphere(subdivisions=subdivisions, radius=radius)
    else:
        subdivision = 1
        while True:
            verts, _ = icosphere(subdivisions=subdivision, radius=radius)
            if verts.shape[0] >= n_views:
                break
            subdivision += 1
    cam_in_obs = np.tile(np.eye(4)[None], (len(verts), 1, 1))
    cam_in_obs[:, :3, 3] = verts
    up = np.array([0, 0, 1.0])
    z_axis = -cam_in_obs[:, :3, 3]
    z_axis /= np.linalg.norm(z_axis, axis=-1, keepdims=True)
    x_axis = np.cross(up[None], z_axis)
    invalid = (x_axis == 0).all(axis=-1)
    x_axis[invalid] = [1, 0, 0]
    x_axis /= np.linalg.norm(x_axis, axis=-1, keepdims=True)
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis, axis=-1, keepdims=True)
    cam_in_obs[:, :3, 0] = x_axis
    cam_in_obs[:, :3, 1] = y_axis
    cam_in_obs[:, :3, 2] = z_axis
    return cam_in_obs


def cluster_poses(angle_diff_deg, dist_diff, poses_in, symmetry_tfs):
    """Greedy dedup: keep a pose iff, for every kept pose, the translation
    differs by >= dist_diff or every symmetry-composed rotation differs by
    >= angle_diff_deg.  @poses_in: (N,4,4); returns (M,4,4)."""
    poses_in = np.asarray(poses_in, dtype=np.float64)
    symmetry_tfs = np.asarray(symmetry_tfs, dtype=np.float64)
    radian_thres = angle_diff_deg / 180.0 * np.pi
    kept = [poses_in[0]]
    for i in range(1, len(poses_in)):
        cur = poses_in[i]
        Kp = np.stack(kept)
        t_close = np.linalg.norm(Kp[:, :3, 3] - cur[:3, 3], axis=-1) < dist_diff
        cur_rots = (cur[None] @ symmetry_tfs)[:, :3, :3]
        m = np.einsum("sij,mkj->msik", cur_rots, Kp[:, :3, :3])
        cos = np.clip((np.trace(m, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
        rot_close = (np.arccos(cos) < radian_thres).any(axis=-1)
        if not (t_close & rot_close).any():
            kept.append(cur)
    return np.stack(kept)


def make_rotation_grid(min_n_views=40, inplane_step=60, symmetry_tfs=None,
                       cluster_angle=30.0, cluster_dist=99999.0):
    """42 views x 6 in-plane = 252 object-in-camera rotations, clustered at
    30 deg.  Returns (M,4,4) float32."""
    if symmetry_tfs is None:
        symmetry_tfs = np.eye(4)[None]
    cam_in_obs = sample_views_icosphere(n_views=min_n_views)
    rot_grid = []
    for i in range(len(cam_in_obs)):
        for inplane_rot in np.deg2rad(np.arange(0, 360, inplane_step)):
            cam_in_ob = cam_in_obs[i] @ euler_matrix(0, 0, inplane_rot)
            rot_grid.append(np.linalg.inv(cam_in_ob))
    rot_grid = cluster_poses(cluster_angle, cluster_dist, np.asarray(rot_grid), symmetry_tfs)
    return rot_grid.astype(np.float32)
