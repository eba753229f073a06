"""Pose-accuracy metrics: ADD / ADD-S (reference Utils.py:232-266).

Port of the part of `sixdof_tpu/metrics.py` that reports pose error;
host numpy + scipy.
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

