"""Pose-accuracy metrics: ADD / ADD-S (reference Utils.py:232-266).

Port of `sixdof_tpu/metrics.py`'s pose error (ADD, ADD-S, their AUC, the
rotation angle) and mesh error (the chamfer distance the neural object
field is gated by); host numpy + scipy.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _transform(pts, tf):
    return pts @ tf[:3, :3].T + tf[:3, 3]


def add_err(pred, gt, model_pts):
    """Average distance of model points (Hinterstoisser ADD)."""
    return float(np.linalg.norm(_transform(model_pts, pred) - _transform(model_pts, gt),
                                axis=-1).mean())


def adds_err(pred, gt, model_pts):
    """Symmetric ADD-S: mean nearest-neighbour distance."""
    nn_dists, _ = cKDTree(_transform(model_pts, pred)).query(_transform(model_pts, gt), k=1)
    return float(nn_dists.mean())



def compute_auc(errs, max_val=0.1, step=0.001):
    """Area under the accuracy-threshold curve, normalized to [0,1]
    (reference Utils.py:255-266 compute_auc_sklearn, without sklearn)."""
    errs = np.sort(np.asarray(errs))
    X = np.arange(0, max_val + step, step)
    Y = np.ones(len(X))
    for i, x in enumerate(X):
        y = (errs <= x).sum() / len(errs)
        Y[i] = y
        if y >= 1:
            break
    return float(np.sum((Y[1:] + Y[:-1]) * np.diff(X)) / 2 / max_val)  # the trapezoid rule


def rotation_angle_deg(R1, R2):
    """Geodesic rotation error in degrees."""
    cos = (np.trace(R1 @ R2.T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def sample_surface(vertices, faces, n, seed=0):
    """Uniform area-weighted point sampling on a triangle mesh."""
    vertices = np.asarray(vertices, dtype=np.float64)
    tri = vertices[np.asarray(faces)]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    p = area / max(area.sum(), 1e-12)
    rng = np.random.RandomState(seed)
    fi = rng.choice(len(faces), size=n, p=p)
    r1, r2 = rng.uniform(size=(2, n))
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], axis=-1)
    return np.einsum("nk,nkd->nd", w, tri[fi])


def chamfer_distance(mesh_a, mesh_b, n_sample=20000, seed=0):
    """Symmetric chamfer distance between two meshes: the mean of the two
    directed mean nearest-neighbour distances over surface samples (the
    neural object field's fit-quality metric)."""
    pa = sample_surface(mesh_a.vertices, mesh_a.faces, n_sample, seed=seed)
    pb = sample_surface(mesh_b.vertices, mesh_b.faces, n_sample, seed=seed + 1)
    d_ab, _ = cKDTree(pb).query(pa, k=1, workers=-1)
    d_ba, _ = cKDTree(pa).query(pb, k=1, workers=-1)
    return float((d_ab.mean() + d_ba.mean()) / 2)
