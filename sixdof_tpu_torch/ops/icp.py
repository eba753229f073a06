"""Point-to-plane ICP on padded clouds.

Port of the part of `sixdof_tpu/ops/icp.py` that the pose path runs:
nearest neighbours as chunked brute force in the |s|^2 + |q|^2 - 2 s.q
form, `icp_point_to_plane` (Open3D registration_icp semantics: 6x6 normal
equations per iteration, SE(3) update, convergence freeze), and the
coarse-then-fine `icp_polish_two_pass` of register's depth polish.  The
iterations stay on the device: the freeze is a tensor select, and the 6x6
solve uses `solve_ex`, so no iteration waits on the host.  All fp32.

Conventions follow Open3D: `transformation` maps SOURCE into TARGET frame;
fitness = #inliers/#source; inlier_rmse = RMSE over inliers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import so3_exp_map

_NN_CHUNK = 1024


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4,4) source -> target
    fitness: torch.Tensor  # scalar
    inlier_rmse: torch.Tensor  # scalar


def nearest_neighbors(query, ref, ref_mask):
    """Index and distance of the nearest valid ref point for each query point.
    @query: (N,3); @ref: (M,3); @ref_mask: (M,) bool."""
    ref_sq = (ref * ref).sum(dim=-1)
    idx_out, dist_out = [], []
    for q in torch.split(query, _NN_CHUNK):
        d2 = (q * q).sum(dim=-1, keepdim=True) + ref_sq[None] - 2.0 * torch.matmul(q, ref.T)
        d2 = torch.where(ref_mask[None], d2, float("inf"))
        dmin, idx = d2.min(dim=-1)
        idx_out.append(idx)
        dist_out.append(torch.sqrt(torch.clamp(dmin, min=0.0)))
    return torch.cat(idx_out), torch.cat(dist_out)


def _apply(tf, pts):
    return torch.matmul(pts, tf[:3, :3].T) + tf[:3, 3]


def evaluate_registration(src, src_mask, tgt, tgt_mask, tf, max_dist):
    _, dist = nearest_neighbors(_apply(tf, src), tgt, tgt_mask)
    inlier = src_mask & (dist < max_dist)
    n_src = torch.clamp(src_mask.sum(), min=1)
    n_in = inlier.sum()
    fitness = n_in / n_src
    rmse = torch.sqrt(torch.where(inlier, dist * dist, 0.0).sum() / torch.clamp(n_in, min=1))
    return fitness, rmse


def icp_point_to_plane(src, src_mask, tgt, tgt_normals, tgt_mask, init_tf, max_dist,
                       max_iter: int = 30, relative_eps: float = 1e-6):
    """Point-to-plane ICP.  @src: (N,3) padded source, @src_mask: (N,);
    @tgt/@tgt_normals: (M,3) padded target points / unit normals, @tgt_mask;
    @init_tf: (4,4) source->target; @max_dist: correspondence threshold
    (float or 0-d tensor).  Returns ICPResult."""
    dev, dt = src.device, src.dtype
    n_src = torch.clamp(src_mask.sum(), min=1).to(dt)
    eye4 = torch.eye(4, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    tf = init_tf.to(dt)
    prev_fit = torch.zeros((), dtype=dt, device=dev)
    prev_rmse = torch.zeros((), dtype=dt, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        sp = _apply(tf, src)
        idx, dist = nearest_neighbors(sp, tgt, tgt_mask)
        q = tgt[idx]
        n = tgt_normals[idx]
        w = (src_mask & (dist < max_dist)).to(dt)
        r = ((sp - q) * n).sum(dim=-1)
        J = torch.cat([torch.linalg.cross(sp, n, dim=-1), n], dim=-1)  # (N,6)
        Jw = J * w[:, None]
        A = torch.matmul(Jw.T, J) + 1e-8 * eye6
        b = torch.matmul(Jw.T, r)
        x = -torch.linalg.solve_ex(A, b[:, None])[0][:, 0]
        delta = eye4.clone()
        delta[:3, :3] = so3_exp_map(x[None, :3])[0]
        delta[:3, 3] = x[3:]
        new_tf = torch.matmul(delta, tf)
        n_in = w.sum()
        fitness = n_in / n_src
        rmse = torch.sqrt((w * dist * dist).sum() / torch.clamp(n_in, min=1.0))
        converged = ((prev_fit - fitness).abs() < relative_eps) \
            & ((prev_rmse - rmse).abs() < relative_eps)
        done = done | converged | (n_in < 6)
        tf = torch.where(done, tf, new_tf)
        prev_fit, prev_rmse = fitness, rmse
    fitness, rmse = evaluate_registration(src, src_mask, tgt, tgt_mask, tf, max_dist)
    return ICPResult(tf, fitness, rmse)


def icp_polish_two_pass(src, src_mask, tgt, tgt_normals, tgt_mask, init_tf,
                        thr1, thr2, thr3=None, it1=10, it2=10, it3=10):
    """Coarse-then-fine point-to-plane polish; returns the refined (4,4)."""
    r = icp_point_to_plane(src, src_mask, tgt, tgt_normals, tgt_mask, init_tf, thr1,
                           max_iter=it1)
    r = icp_point_to_plane(src, src_mask, tgt, tgt_normals, tgt_mask, r.transformation, thr2,
                           max_iter=it2)
    if thr3 is None:
        return r.transformation
    r = icp_point_to_plane(src, src_mask, tgt, tgt_normals, tgt_mask, r.transformation, thr3,
                           max_iter=it3)
    return r.transformation
