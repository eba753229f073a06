"""Closed-form SO(3) maps and rotation representations.

Port of `sixdof_tpu/ops/lie.py` (the pieces the pose path and the neural
object field use): batched
over leading dims, with the same series fallbacks near the identity and the
same axis recovery near theta = pi.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def hat(v):
    """(...,3) -> (...,3,3) skew-symmetric cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_map(log_rot):
    """Axis-angle (...,3) -> rotation matrices (...,3,3) (Rodrigues)."""
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    th2s = torch.clamp(theta2, min=_EPS)
    theta = torch.sqrt(th2s)
    small = theta2 > _EPS
    # constant divisors as float32 reciprocals, as XLA compiles the JAX maps
    sin_t_t = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 * (1.0 / 6.0))
    one_m_cos_t2 = torch.where(small, (1.0 - torch.cos(theta)) / th2s,
                               0.5 - theta2 * (1.0 / 24.0))
    K = hat(log_rot)
    KK = K @ K
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device)
    return eye + sin_t_t[..., None, None] * K + one_m_cos_t2[..., None, None] * KK


def so3_log_map(R):
    """Rotation matrices (...,3,3) -> axis-angle (...,3), robust at theta=0
    (series) and theta=pi (axis from the symmetric part)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin = 0.5 * torch.linalg.norm(w, dim=-1)
    theta = torch.atan2(sin, cos)
    scale = torch.where(theta > 1e-6, theta / torch.clamp(2.0 * sin, min=1e-12),
                        0.5 + theta * theta * (1.0 / 12.0))
    generic = w * scale[..., None]

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a2 = torch.clamp((diag - cos[..., None]) / torch.clamp(1.0 - cos[..., None], min=1e-9),
                     0.0, 1.0)
    a = torch.sqrt(a2)
    S = R + R.transpose(-1, -2)
    k = torch.nn.functional.one_hot(torch.argmax(a2, dim=-1), 3).to(R.dtype)
    Sk = torch.einsum("...i,...ij->...j", k, S)
    one = torch.ones((), dtype=R.dtype, device=R.device)
    signs = torch.where(k > 0.5, one, torch.where(Sk >= 0, one, -one))
    axis = a * signs
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-9)
    near_pi = axis * theta[..., None]
    return torch.where((theta > math.pi - 1e-3)[..., None], near_pi, generic)


def rotation_6d_to_matrix(d6):
    """Zhou et al. 6D rotation representation (...,6) -> (...,3,3)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp(min=_EPS)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp(min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R):
    """(...,3,3) -> (...,6): the first two rows, flattened."""
    return torch.cat([R[..., 0, :], R[..., 1, :]], dim=-1)


def se3_exp_map(log_tf):
    """(...,6) [trans | rot] twist -> (...,4,4) homogeneous transforms."""
    v, w = log_tf[..., :3], log_tf[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    th2s = torch.clamp(theta2, min=_EPS)  # safe denominator (see so3_exp_map)
    theta = torch.sqrt(th2s)
    small = theta2 > _EPS
    K = hat(w)
    KK = K @ K
    sin_t_t = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 * (1.0 / 6.0))
    one_m_cos_t2 = torch.where(small, (1.0 - torch.cos(theta)) / th2s,
                               0.5 - theta2 * (1.0 / 24.0))
    t_m_sin_t3 = torch.where(small, (theta - torch.sin(theta)) / (th2s * theta),
                             1.0 / 6.0 - theta2 * (1.0 / 120.0))
    eye = torch.eye(3, dtype=log_tf.dtype, device=log_tf.device)
    R = eye + sin_t_t[..., None, None] * K + one_m_cos_t2[..., None, None] * KK
    V = eye + one_m_cos_t2[..., None, None] * K + t_m_sin_t3[..., None, None] * KK
    t = (V @ v[..., None])[..., 0]
    out = torch.zeros((*log_tf.shape[:-1], 4, 4), dtype=log_tf.dtype, device=log_tf.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def euler_matrix(rx, ry, rz):
    """4x4 numpy rotation from static-xyz Euler angles: R = Rz @ Ry @ Rx."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    out = np.eye(4)
    out[:3, :3] = Rz @ Ry @ Rx
    return out


def rotation_geodesic_distance(R1, R2):
    """Geodesic angle (radians) between batched rotations."""
    m = torch.matmul(R1, R2.transpose(-1, -2))
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def normalize_rotation(pose):
    """Remove per-column scale from the rotation block (no-shear assumption)."""
    scales = torch.linalg.norm(pose[..., :3, :3], dim=-2)
    out = pose.clone()
    out[..., :3, :3] = pose[..., :3, :3] / scales[..., None, :]
    return out
