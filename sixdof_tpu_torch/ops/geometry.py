"""Core geometry ops: homogeneous transforms, pinhole projection, crop windows.

Port of `sixdof_tpu/ops/geometry.py`.  Device functions take and return
float32 tensors with batch-leading dims; host helpers stay numpy.
"""
from __future__ import annotations

import numpy as np
import torch

GLCAM_IN_CVCAM = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenGL camera in the OpenCV camera


def to_homo(pts):
    """(...,N,D) -> (...,N,D+1): append ones."""
    return torch.cat([pts, torch.ones((*pts.shape[:-1], 1), dtype=pts.dtype,
                                      device=pts.device)], dim=-1)


def transform_pts(pts, tf):
    """@pts: (...,N,3); @tf: (...,4,4).  A batched tf gets a point axis
    inserted by RANK (tf (B,4,4) on pts (N,3) -> (B,N,3)), as in the JAX
    package."""
    if tf.ndim >= 3 and tf.ndim >= pts.ndim:
        tf = tf[..., None, :, :]
    return (torch.matmul(tf[..., :-1, :-1], pts[..., None]) + tf[..., :-1, -1:])[..., 0]


def transform_dirs(dirs, tf):
    """Rotate direction vectors by the rotation block of @tf; broadcasting
    as in transform_pts (by rank)."""
    if tf.ndim >= 3 and tf.ndim >= dirs.ndim:
        tf = tf[..., None, :, :]
    return torch.matmul(tf[..., :3, :3], dirs[..., None])[..., 0]


def depth2xyzmap(depth, K, zfar=float("inf")):
    """(H,W) depth -> (H,W,3) camera-frame xyz; invalid (<1mm, >=zfar) -> 0."""
    H, W = depth.shape
    us = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    vs = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    xs = (us - K[0, 2]) * depth / K[0, 0]
    ys = (vs - K[1, 2]) * depth / K[1, 1]
    xyz = torch.stack([xs, ys, depth], dim=-1)
    invalid = (depth < 0.001) | (depth >= zfar)
    return torch.where(invalid[..., None], torch.zeros((), dtype=xyz.dtype, device=xyz.device),
                       xyz)


def depth2xyzmap_batch(depths, Ks, zfar=float("inf")):
    """(B,H,W), (B,3,3) -> (B,H,W,3)."""
    B, H, W = depths.shape
    us = torch.arange(W, dtype=depths.dtype, device=depths.device)[None, None, :]
    vs = torch.arange(H, dtype=depths.dtype, device=depths.device)[None, :, None]
    fx = Ks[:, 0, 0][:, None, None]
    fy = Ks[:, 1, 1][:, None, None]
    cx = Ks[:, 0, 2][:, None, None]
    cy = Ks[:, 1, 2][:, None, None]
    xyz = torch.stack([(us - cx) * depths / fx, (vs - cy) * depths / fy, depths], dim=-1)
    invalid = (depths < 0.001) | (depths >= zfar)
    return torch.where(invalid[..., None], torch.zeros((), dtype=xyz.dtype, device=xyz.device),
                       xyz)


def project_points(pts, K):
    """(...,N,3) camera-frame points -> (...,N,2) pixel coords (u,v)."""
    uvw = torch.matmul(K, pts[..., None])[..., 0]
    return uvw[..., :2] / uvw[..., 2:3]


def compute_crop_window_tf_batch(poses, K, crop_ratio, out_size, mesh_diameter):
    """Per-hypothesis full-image -> crop pixel transform ('box_3d' method).

    @poses: (B,4,4); @K: (3,3); @out_size: (W,H) of the crop.  Returns (B,3,3).
    """
    radius = mesh_diameter * crop_ratio / 2.0
    offsets = torch.tensor(
        [[0, 0, 0], [radius, 0, 0], [-radius, 0, 0], [0, radius, 0], [0, -radius, 0]],
        dtype=poses.dtype, device=poses.device,
    )
    pts = poses[:, None, :3, 3] + offsets[None]  # (B,5,3)
    uvs = project_points(pts, K)  # (B,5,2)
    center = uvs[:, 0]
    B = poses.shape[0]
    rad = torch.abs(uvs - center[:, None, :]).reshape(B, -1).amax(dim=-1)
    left = torch.round(center[:, 0] - rad)
    right = torch.round(center[:, 0] + rad)
    top = torch.round(center[:, 1] - rad)
    bottom = torch.round(center[:, 1] + rad)
    sx = out_size[0] / (right - left)
    sy = out_size[1] / (bottom - top)
    tf = torch.zeros((B, 3, 3), dtype=poses.dtype, device=poses.device)
    tf[:, 0, 0] = sx
    tf[:, 1, 1] = sy
    tf[:, 0, 2] = -left * sx
    tf[:, 1, 2] = -top * sy
    tf[:, 2, 2] = 1.0
    return tf


def pose_to_egocentric_delta_pose(A_in_cam, B_in_cam):
    trans_delta = B_in_cam[:, :3, 3] - A_in_cam[:, :3, 3]
    rot_mat_delta = B_in_cam[:, :3, :3] @ A_in_cam[:, :3, :3].transpose(-1, -2)
    return trans_delta, rot_mat_delta


def egocentric_delta_pose_to_pose(A_in_cam, trans_delta, rot_mat_delta):
    B = A_in_cam.shape[0]
    out = torch.eye(4, dtype=A_in_cam.dtype, device=A_in_cam.device).repeat(B, 1, 1)
    out[:, :3, 3] = A_in_cam[:, :3, 3] + trans_delta
    out[:, :3, :3] = rot_mat_delta @ A_in_cam[:, :3, :3]
    return out


# ---------------------------------------------------------------- host-side --


def compute_mesh_diameter(model_pts, n_sample=10000, seed=0):
    """Max pairwise distance over a seeded random subsample (host numpy)."""
    model_pts = np.asarray(model_pts)
    if n_sample is not None and len(model_pts) > n_sample:
        ids = np.random.RandomState(seed).choice(len(model_pts), size=n_sample, replace=False)
        pts = model_pts[ids]
    else:
        pts = model_pts
    diameter = 0.0
    for i in range(0, len(pts), 2048):
        d = np.linalg.norm(pts[i : i + 2048, None] - pts[None], axis=-1)
        diameter = max(diameter, float(d.max()))
    return diameter


def projection_matrix_from_intrinsics(K, height, width, znear, zfar, window_coords="y_down"):
    """Hartley-Zisserman K -> 4x4 OpenGL projection (host numpy)."""
    w, h = width, height
    depth = float(zfar - znear)
    q = -(zfar + znear) / depth
    qn = -2 * (zfar * znear) / depth
    if window_coords == "y_up":
        row1 = [0, -2 * K[1, 1] / h, (-2 * K[1, 2] + h) / h, 0]
    elif window_coords == "y_down":
        row1 = [0, 2 * K[1, 1] / h, (2 * K[1, 2] - h) / h, 0]
    else:
        raise NotImplementedError(window_coords)
    return np.array([[2 * K[0, 0] / w, -2 * K[0, 1] / w, (-2 * K[0, 2] + w) / w, 0], row1,
                     [0, 0, q, qn], [0, 0, -1, 0]])


def symmetry_tfs_from_info(info, rot_angle_discrete=5):
    """BOP symmetry annotation (models_info.json entry) -> (S,4,4) numpy,
    translations in metres: the identity, the discrete symmetries, then one
    rotation every @rot_angle_discrete degrees about the first continuous
    axis (x, y or z, the first with a positive component)."""
    from .lie import euler_matrix

    symmetry_tfs = [np.eye(4)]
    if "symmetries_discrete" in info:
        tfs = np.array(info["symmetries_discrete"]).reshape(-1, 4, 4).copy()
        tfs[..., :3, 3] *= 0.001
        symmetry_tfs = [np.eye(4)] + list(tfs)
    if "symmetries_continuous" in info:
        axis = np.array(info["symmetries_continuous"][0]["axis"]).reshape(3)
        offset = info["symmetries_continuous"][0]["offset"]
        angles = np.arange(0, 360, rot_angle_discrete) / 180.0 * np.pi
        rxs, rys, rzs = [0], [0], [0]
        if axis[0] > 0:
            rxs = angles
        elif axis[1] > 0:
            rys = angles
        elif axis[2] > 0:
            rzs = angles
        for rx in rxs:
            for ry in rys:
                for rz in rzs:
                    tf = euler_matrix(rx, ry, rz)
                    tf[:3, 3] = offset
                    symmetry_tfs.append(tf)
    return np.array(symmetry_tfs)
