"""Point-to-plane ICP on padded clouds, batched over restarts, and the
capture program (restart ICP + best pick + defect ray trace).

Port of `sixdof_tpu/ops/icp.py`: nearest neighbours as chunked brute force
in the |s|^2 + |q|^2 - 2 s.q form, point-to-plane ICP (Open3D
registration_icp semantics: 6x6 normal equations per iteration, SE(3)
update, convergence freeze), register's coarse-then-fine polish, and the
capture event as one device program (`improve_and_raytrace`,
`capture_from_pose`).  Where JAX `vmap`s over K restart poses, the port
carries a leading batch dimension (batched matmuls, a batched `solve_ex`);
the single-pose `icp_point_to_plane` is the K = 1 case.  The iterations stay
on the device: the convergence freeze is a tensor select, the solve and the
inverse are the `_ex` forms, and the best restart is an index tensor, so no
iteration and no capture waits on the host.  All fp32.

Conventions follow Open3D: `transformation` maps SOURCE into TARGET frame;
fitness = #inliers/#source; inlier_rmse = RMSE over inliers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.sharding import all_gather, shard_rays, shard_restarts
from .lie import so3_exp_map
from .raytrace import ray_mesh_intersect

_NN_CHUNK = 1024


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4,4) or (K,4,4) source -> target
    fitness: torch.Tensor  # () or (K,)
    inlier_rmse: torch.Tensor  # () or (K,)


def nearest_neighbors(query, ref, ref_mask):
    """Index and distance of the nearest valid ref point for each query point.
    @query: (...,N,3); @ref: (M,3); @ref_mask: (M,) bool.  Returns (...,N)."""
    ref_sq = (ref * ref).sum(dim=-1)
    idx_out, dist_out = [], []
    for q in torch.split(query, _NN_CHUNK, dim=-2):
        d2 = (q * q).sum(dim=-1, keepdim=True) + ref_sq - 2.0 * torch.matmul(q, ref.T)
        d2 = torch.where(ref_mask, d2, float("inf"))
        dmin, idx = d2.min(dim=-1)
        idx_out.append(idx)
        dist_out.append(torch.sqrt(torch.clamp(dmin, min=0.0)))
    return torch.cat(idx_out, dim=-1), torch.cat(dist_out, dim=-1)


def _apply(tf, pts):
    """(...,4,4) transforms applied to (N,3) points -> (...,N,3)."""
    return torch.matmul(pts, tf[..., :3, :3].transpose(-1, -2)) + tf[..., None, :3, 3]


def evaluate_registration(src, src_mask, tgt, tgt_mask, tf, max_dist):
    """Open3D evaluate_registration on padded clouds; @tf (4,4) or (K,4,4),
    @max_dist a float, 0-d or (K,) tensor.  Returns (fitness, rmse)."""
    _, dist = nearest_neighbors(_apply(tf, src), tgt, tgt_mask)
    if isinstance(max_dist, torch.Tensor) and max_dist.dim():
        max_dist = max_dist[:, None]
    inlier = src_mask & (dist < max_dist)
    n_src = torch.clamp(src_mask.sum(), min=1)
    n_in = inlier.sum(dim=-1)
    fitness = n_in / n_src
    rmse = torch.sqrt(torch.where(inlier, dist * dist, 0.0).sum(dim=-1)
                      / torch.clamp(n_in, min=1))
    return fitness, rmse


def icp_batch(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dists,
              max_iter: int = 30, relative_eps: float = 1e-6):
    """Point-to-plane ICP from K initial transforms at once.

    @src: (N,3) padded source, @src_mask: (N,); @tgt/@tgt_normals: (M,3)
    padded target points / unit normals, @tgt_mask; @init_tfs: (K,4,4)
    source->target; @max_dists: (K,) correspondence thresholds.
    Returns a batched ICPResult ((K,4,4), (K,), (K,))."""
    dev, dt = src.device, src.dtype
    K = init_tfs.shape[0]
    max_dists = torch.as_tensor(max_dists, dtype=dt, device=dev).reshape(K)
    n_src = torch.clamp(src_mask.sum(), min=1).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    tf = init_tfs.to(dt)
    prev_fit = torch.zeros(K, dtype=dt, device=dev)
    prev_rmse = torch.zeros(K, dtype=dt, device=dev)
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        sp = _apply(tf, src)  # (K,N,3)
        idx, dist = nearest_neighbors(sp, tgt, tgt_mask)
        q = tgt[idx]
        n = tgt_normals[idx]
        w = (src_mask & (dist < max_dists[:, None])).to(dt)  # (K,N)
        r = ((sp - q) * n).sum(dim=-1)
        J = torch.cat([torch.linalg.cross(sp, n, dim=-1), n], dim=-1)  # (K,N,6)
        Jw = J * w[..., None]
        A = torch.matmul(Jw.transpose(-1, -2), J) + 1e-8 * eye6
        b = torch.matmul(Jw.transpose(-1, -2), r[..., None])  # (K,6,1)
        x = -torch.linalg.solve_ex(A, b)[0][..., 0]  # (K,6)
        delta = torch.zeros((K, 4, 4), dtype=dt, device=dev)
        delta[:, :3, :3] = so3_exp_map(x[:, :3])
        delta[:, :3, 3] = x[:, 3:]
        delta[:, 3, 3] = 1.0
        new_tf = torch.matmul(delta, tf)
        n_in = w.sum(dim=-1)
        fitness = n_in / n_src
        rmse = torch.sqrt((w * dist * dist).sum(dim=-1) / torch.clamp(n_in, min=1.0))
        converged = ((prev_fit - fitness).abs() < relative_eps) \
            & ((prev_rmse - rmse).abs() < relative_eps)
        done = done | converged | (n_in < 6)
        tf = torch.where(done[:, None, None], tf, new_tf)
        prev_fit, prev_rmse = fitness, rmse
    fitness, rmse = evaluate_registration(src, src_mask, tgt, tgt_mask, tf, max_dists)
    return ICPResult(tf, fitness, rmse)


def icp_point_to_plane(src, src_mask, tgt, tgt_normals, tgt_mask, init_tf, max_dist,
                       max_iter: int = 30, relative_eps: float = 1e-6):
    """Single-pose point-to-plane ICP (the K = 1 case of `icp_batch`).
    @init_tf: (4,4); @max_dist: float or 0-d tensor.  Returns ICPResult."""
    r = icp_batch(src, src_mask, tgt, tgt_normals, tgt_mask, init_tf[None],
                  torch.as_tensor(max_dist, dtype=src.dtype, device=src.device).reshape(1),
                  max_iter=max_iter, relative_eps=relative_eps)
    return ICPResult(r.transformation[0], r.fitness[0], r.inlier_rmse[0])


def icp_one_iter_batch(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dist):
    """One-iteration ICP from each of K transforms (the z-ladder probes)."""
    K = init_tfs.shape[0]
    return icp_batch(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs,
                     torch.full((K,), float(max_dist), dtype=src.dtype, device=src.device),
                     max_iter=1)


def icp_batch_with_eval(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dists,
                        eval_tf, eval_dist, max_iter=30):
    """`icp_batch` plus the evaluation of the unrefined @eval_tf (4,4) at
    @eval_dist.  Returns (ICPResult, fitness0, rmse0)."""
    res = icp_batch(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dists,
                    max_iter=max_iter)
    f0, r0 = evaluate_registration(src, src_mask, tgt, tgt_mask, eval_tf, eval_dist)
    return res, f0, r0


def improve_and_raytrace(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dists,
                         eval_tf, eval_dist, mesh_tri, mesh_tri_mask, ray_dirs, ray_mask,
                         inv_color_to_depth, max_iter=30, plain_raytrace=False,
                         device_mesh=None):
    """One capture event as one device program: restart ICP + the initial
    transform's evaluation + the best pick + the defect ray trace against the
    re-posed mesh.

    @mesh_tri: (T,3,3) model-frame mm triangles; @ray_dirs: (M,3) colour-frame
    rays; @inv_color_to_depth: (4,4); @plain_raytrace: K2's plain version.
    @device_mesh: each rank runs its slice of the restarts and of the rays
    (through K2), padded as `shard_restarts` / `shard_rays` pad them, and
    the transforms, fitness, RMSE and hit distances are gathered before the
    best pick: K and M are then the padded counts (a padded duplicate may
    win a tie; the chosen pose is the same).
    Returns (tf_all (K+1,4,4), fit (K+1,), rmse (K+1,), best index (),
    t_hit (M,))."""
    if device_mesh is not None:
        init_tfs, max_dists, _ = shard_restarts(init_tfs, max_dists, device_mesh)
        ray_dirs, ray_mask, _ = shard_rays(ray_dirs, ray_mask, device_mesh)

    def gather(x):  # every rank's rows, the padding kept
        return x if device_mesh is None else all_gather(x, device_mesh)

    res, f0, r0 = icp_batch_with_eval(src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs,
                                      max_dists, eval_tf, eval_dist, max_iter=max_iter)
    fit = torch.cat([gather(res.fitness), f0.reshape(1)])
    rmse = torch.cat([gather(res.inlier_rmse), r0.reshape(1)])
    tf_all = torch.cat([gather(res.transformation), eval_tf.reshape(1, 4, 4).to(fit.dtype)])

    valid = (fit > 0) & (rmse > 0)
    # improve_result's np.lexsort((rmse, -fit)) — fitness descending, then
    # rmse ascending — in two exact stages; every restart shares the source
    # cloud, so equal inlier counts give bitwise-equal fitness
    max_fit = torch.where(valid, fit, float("-inf")).max()
    key = torch.where(valid & (fit == max_fit), rmse, float("inf"))
    # nothing valid: the appended initial transform
    best = torch.where(valid.any(), key.argmin(), fit.shape[0] - 1)

    best_tf = torch.index_select(tf_all, 0, best.reshape(1))[0]  # scene -> object
    obj_in_scene = torch.linalg.inv_ex(best_tf)[0]
    M = torch.matmul(inv_color_to_depth, obj_in_scene)
    tri_w = torch.einsum("ij,tkj->tki", M[:3, :3], mesh_tri) + M[:3, 3]
    origins = torch.zeros_like(ray_dirs)
    t_hit = gather(ray_mesh_intersect(origins, ray_dirs, ray_mask, tri_w, mesh_tri_mask,
                                      use_pallas=not plain_raytrace))
    return tf_all, fit, rmse, best, t_hit


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


def capture_from_pose(src, src_mask, tgt, tgt_normals, tgt_mask, pose_dev, tf_to_centered,
                      color_to_depth, noise_tfs, max_dists, eval_dist, mesh_tri, mesh_tri_mask,
                      ray_dirs, ray_mask, inv_color_to_depth, max_iter=30,
                      plain_raytrace=False, device_mesh=None):
    """Capture event seeded from the DEVICE tracked pose: the restart seeds
    (mm scaling, extrinsic compose, rigid inverse, noise) are computed on the
    device, so a capture frame never waits for the tracked pose on the host.

    @pose_dev: (4,4) or (1,4,4) pose of the CENTRED mesh, colour camera,
    metres; @tf_to_centered: (4,4) centred -> original mesh compose;
    @color_to_depth: (4,4) mm extrinsic; @noise_tfs: (K,4,4) restart noise
    (identity first).  Other arguments as `improve_and_raytrace`."""
    pose_orig = torch.matmul(pose_dev.reshape(4, 4), tf_to_centered)
    scale = torch.ones((4, 4), dtype=pose_orig.dtype, device=pose_orig.device)
    scale[:3, 3] = 1000.0  # metres -> mm (the ICP frame)
    cap_tf = torch.matmul(color_to_depth, pose_orig * scale)  # object in scene, depth cam
    # rigid inverse (R^T, -R^T t): exact where a general fp32 inverse loses
    # ~1e-4 relative on a ~500 mm translation
    Rt = cap_tf[:3, :3].T
    eval_tf = torch.eye(4, dtype=cap_tf.dtype, device=cap_tf.device)
    eval_tf[:3, :3] = Rt
    eval_tf[:3, 3] = -torch.matmul(Rt, cap_tf[:3, 3])
    init_tfs = torch.matmul(noise_tfs, eval_tf)
    return improve_and_raytrace(
        src, src_mask, tgt, tgt_normals, tgt_mask, init_tfs, max_dists, eval_tf, eval_dist,
        mesh_tri, mesh_tri_mask, ray_dirs, ray_mask, inv_color_to_depth, max_iter,
        plain_raytrace, device_mesh)
