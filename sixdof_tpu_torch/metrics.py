"""Pose-accuracy metrics: ADD / ADD-S (reference Utils.py:232-266).

Port of the part of `sixdof_tpu/metrics.py` that reports pose error (ADD,
ADD-S, their AUC, the rotation angle); host numpy + scipy.
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
