"""FPFH features + RANSAC global registration (the `--icp` path).

Port of `sixdof_tpu/ops/features.py`: host numpy in float64 with KD-tree
neighbour queries and the same seeded draw of RANSAC trials
(`RandomState(0)`), so the features, the trials, the chosen trial and the
early stop at fitness > 0.9 are the JAX package's.  The RANSAC stage only
seeds the pose; the device ICP (ops/icp.py) does the precise work.
"""
from __future__ import annotations

import logging

import numpy as np
from scipy.spatial import cKDTree

from ..io.mesh_io import PointCloud
from .pointcloud import estimate_normals

N_BINS = 11  # per angle, 33-D total, like PCL/Open3D


def _pair_features(p_s, n_s, p_t, n_t):
    """Darboux-frame angle triplet (alpha, phi, theta) for point pairs."""
    d = p_t - p_s
    dist = np.linalg.norm(d, axis=-1)
    dist = np.clip(dist, 1e-12, None)
    d_unit = d / dist[..., None]
    u = n_s
    v = np.cross(d_unit, u)
    v_norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.clip(v_norm, 1e-12, None)
    w = np.cross(u, v)
    alpha = np.einsum("...i,...i->...", v, n_t)
    phi = np.einsum("...i,...i->...", u, d_unit)
    theta = np.arctan2(np.einsum("...i,...i->...", w, n_t), np.einsum("...i,...i->...", u, n_t))
    return alpha, phi, theta, dist


def _histogram(alpha, phi, theta, weights=None):
    """(K,) angle arrays -> (33,) concatenated histogram."""
    bins_a = np.clip(((alpha + 1.0) / 2.0 * N_BINS).astype(np.int64), 0, N_BINS - 1)
    bins_p = np.clip(((phi + 1.0) / 2.0 * N_BINS).astype(np.int64), 0, N_BINS - 1)
    bins_t = np.clip(((theta + np.pi) / (2 * np.pi) * N_BINS).astype(np.int64), 0, N_BINS - 1)
    h = np.zeros(3 * N_BINS)
    w = np.ones_like(alpha) if weights is None else weights
    np.add.at(h, bins_a, w)
    np.add.at(h, N_BINS + bins_p, w)
    np.add.at(h, 2 * N_BINS + bins_t, w)
    s = h.sum()
    return h / s * 100.0 if s > 0 else h


def compute_fpfh(pcd: PointCloud, radius=20.0, max_nn=100):
    """(N,33) FPFH feature matrix."""
    if pcd.normals is None:
        estimate_normals(pcd, radius=2, max_nn=5)
    pts = pcd.points
    nrm = pcd.normals
    n = len(pts)
    tree = cKDTree(pts)
    k = min(max_nn, n)
    dists, idx = tree.query(pts, k=k, workers=-1)
    if dists.ndim == 1:
        dists, idx = dists[:, None], idx[:, None]
    valid = (dists <= radius) & (dists > 0)

    spfh = np.zeros((n, 3 * N_BINS))
    for i in range(n):
        nbrs = idx[i][valid[i]]
        if len(nbrs) == 0:
            continue
        a, p, t, _ = _pair_features(pts[i], nrm[i], pts[nbrs], nrm[nbrs])
        spfh[i] = _histogram(a, p, t)

    fpfh = spfh.copy()
    for i in range(n):
        nbrs = idx[i][valid[i]]
        d = dists[i][valid[i]]
        if len(nbrs) == 0:
            continue
        w = 1.0 / np.clip(d, 1e-9, None)
        fpfh[i] = spfh[i] + (spfh[nbrs] * w[:, None]).sum(axis=0) / len(nbrs)
    return fpfh


def _kabsch_batch(src, tgt):
    """Batched rigid point-to-point fit: (T,3,3)x2 -> (T,4,4)."""
    cs = src.mean(axis=1, keepdims=True)
    ct = tgt.mean(axis=1, keepdims=True)
    H = np.einsum("tki,tkj->tij", src - cs, tgt - ct)
    U, _, Vt = np.linalg.svd(H)
    d = np.linalg.det(np.einsum("tij,tjk->tik", np.swapaxes(Vt, 1, 2), np.swapaxes(U, 1, 2)))
    S = np.tile(np.eye(3)[None], (len(src), 1, 1))
    S[:, 2, 2] = d
    R = np.einsum("tij,tjk,tkl->til", np.swapaxes(Vt, 1, 2), S, np.swapaxes(U, 1, 2))
    t = ct[:, 0] - np.einsum("tij,tj->ti", R, cs[:, 0])
    out = np.tile(np.eye(4)[None], (len(src), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out


def execute_global_registration(source, target, source_fpfh, target_fpfh, param):
    """RANSAC over FPFH nearest-neighbor correspondences.

    The checkers are edge length, distance and normal angle, over
    vectorised trials.  Returns a RegistrationResult whose transformation
    maps source->target.
    """
    from ..app.icp_pipeline import RegistrationResult

    params = param["execute_global_registration"]
    dist_thresh = float(params["distance_threshold"])
    edge_sim = float(params["correspondence_checkers"][0]["value"])
    iters = int(params["ransac_criteria"]["iterations"])
    iters = min(iters, 20000)

    ftree = cKDTree(target_fpfh)
    _, corr = ftree.query(source_fpfh, k=1, workers=-1)
    src_pts = source.points
    tgt_pts = target.points[corr]

    rng = np.random.RandomState(0)
    n = len(src_pts)
    tri = rng.randint(0, n, size=(iters, 3))
    s3 = src_pts[tri]  # (T,3,3)
    t3 = tgt_pts[tri]

    # edge-length checker (vectorized)
    def edges(x):
        return np.stack(
            [
                np.linalg.norm(x[:, 0] - x[:, 1], axis=-1),
                np.linalg.norm(x[:, 1] - x[:, 2], axis=-1),
                np.linalg.norm(x[:, 0] - x[:, 2], axis=-1),
            ],
            axis=-1,
        )

    es, et = edges(s3), edges(t3)
    ok = np.all((es > edge_sim * et) & (et > edge_sim * es), axis=-1)

    tfs = _kabsch_batch(s3, t3)

    # distance checker (CorrespondenceCheckerBasedOnDistance): the sampled
    # correspondences themselves must land within distance_threshold
    sp3 = np.einsum("tij,tkj->tki", tfs[:, :3, :3], s3) + tfs[:, None, :3, 3]
    ok &= np.all(np.linalg.norm(sp3 - t3, axis=-1) < dist_thresh, axis=-1)

    # normal checker (CorrespondenceCheckerBasedOnNormal): rotated source
    # normals within angle_threshold of the target normals (unoriented, like
    # Open3D FPFH clouds: compare |cos|)
    angle_thresh = float(params.get("angle_threshold", 0.0) or 0.0)
    if angle_thresh > 0 and source.normals is not None and target.normals is not None:
        sn3 = source.normals[tri]
        tn3 = target.normals[corr][tri]
        rn3 = np.einsum("tij,tkj->tki", tfs[:, :3, :3], sn3)
        cosang = np.abs(np.einsum("tki,tki->tk", rn3, tn3))
        cosang /= np.maximum(
            np.linalg.norm(rn3, axis=-1) * np.linalg.norm(tn3, axis=-1), 1e-12)
        ok &= np.all(cosang >= np.cos(angle_thresh), axis=-1)
    best = RegistrationResult()
    n_eval = 0
    for ti in np.where(ok)[0]:
        tf = tfs[ti]
        sp = src_pts @ tf[:3, :3].T + tf[:3, 3]
        d = np.linalg.norm(sp - tgt_pts, axis=-1)
        inlier = d < dist_thresh
        cnt = int(inlier.sum())
        fitness = cnt / n
        if cnt and (fitness > best.fitness or (fitness == best.fitness and
                    np.sqrt((d[inlier] ** 2).mean()) < best.inlier_rmse)):
            best.fitness = fitness
            best.inlier_rmse = float(np.sqrt((d[inlier] ** 2).mean()))
            best.transformation = tf
        n_eval += 1
        if best.fitness > 0.9:
            break
    best.valid_trials = n_eval
    logging.info(
        f":: RANSAC global registration: fitness={best.fitness:.4f} "
        f"rmse={best.inlier_rmse:.4f} over {n_eval} valid trials"
    )
    return best
