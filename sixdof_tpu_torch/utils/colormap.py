"""JET colormap without matplotlib or OpenCV.

Port of `sixdof_tpu/utils/colormap.py::jet_colormap`, which colours the
defect point clouds.  The overlay form (`apply_jet`) feeds the viewer and
is not ported.
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
