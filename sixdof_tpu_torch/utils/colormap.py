"""JET colormap without matplotlib or OpenCV.

Port of `sixdof_tpu/utils/colormap.py`: `jet_colormap` colours the defect
point clouds, `apply_jet` the heatmap overlay and the depth visualisation.
"""
from __future__ import annotations

import numpy as np


def jet_colormap(x):
    """Map values in [0,1] (any-shape numpy array) -> RGB in [0,1] (matplotlib
    'jet' piecewise-linear segments)."""
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    r = np.interp(x, [0.0, 0.35, 0.66, 0.89, 1.0], [0.0, 0.0, 1.0, 1.0, 0.5])
    g = np.interp(x, [0.0, 0.125, 0.375, 0.64, 0.91, 1.0], [0.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    b = np.interp(x, [0.0, 0.11, 0.34, 0.65, 1.0], [0.5, 1.0, 1.0, 0.0, 0.0])
    return np.stack([r, g, b], axis=-1)


# apply_jet's colour of each uint8 level: the JAX package's per-pixel
# formula, evaluated once
_JET_BGR_U8 = (jet_colormap(np.arange(256) / 255.0)[:, ::-1] * 255).astype(np.uint8)


def apply_jet(gray_u8):
    """uint8 (H,W) -> BGR uint8 (H,W,3), the JAX package's stand-in for
    cv2.applyColorMap(..., COLORMAP_JET)."""
    return _JET_BGR_U8[np.asarray(gray_u8, dtype=np.uint8)]
