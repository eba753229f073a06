"""Depth erosion and bilateral filter: the port against the JAX package on
the demo depth maps, including the sensor-noise scenes (holes, flying
pixels)."""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.ops import depth_filter as jd
from sixdof_tpu_torch.ops import depth_filter as td

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = [os.path.join(REPO, "demo_data", s, "depth", f"depth_000{i}.png")
          for s, i in [("synth_box", 0), ("synth_box_sensor", 1), ("synth_clutter_sensor", 2),
                       ("synth_occl", 3)]]
# XLA fuses the bilateral filter's weighted sums in an order torch does not
# reproduce; the results agree to a few float32 ulps at these depths (~0.6 m)
BILATERAL_ATOL = 1e-6


@pytest.mark.parametrize("path", DEPTHS, ids=lambda p: p.split(os.sep)[-3])
def test_filters_match_jax(path):
    d = (cv2.imread(path, -1) / 1e3).astype(np.float32)
    e_j = np.asarray(jd.erode_depth(jnp.asarray(d), radius=2))
    e_t = td.erode_depth(torch.from_numpy(d.copy()), radius=2).numpy()
    np.testing.assert_array_equal(e_t, e_j)  # exact
    assert (e_t == 0).sum() > (d == 0).sum()  # it did erode something
    b_j = np.asarray(jd.bilateral_filter_depth(jnp.asarray(e_j), radius=2))
    b_t = td.bilateral_filter_depth(torch.from_numpy(e_j.copy()), radius=2).numpy()
    np.testing.assert_array_equal(b_t == 0, b_j == 0)  # same support
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=BILATERAL_ATOL)


def test_filters_on_synthetic_holes(rng):
    d = (0.5 + 0.002 * rng.randn(40, 50)).astype(np.float32)
    d[rng.rand(40, 50) < 0.2] = 0.0
    d[5:9, 10:30] = 0.9  # a step: discontinuity handling
    e_j = np.asarray(jd.erode_depth(jnp.asarray(d)))
    np.testing.assert_array_equal(td.erode_depth(torch.from_numpy(d)).numpy(), e_j)
    np.testing.assert_allclose(
        td.bilateral_filter_depth(torch.from_numpy(e_j.copy())).numpy(),
        np.asarray(jd.bilateral_filter_depth(jnp.asarray(e_j))), rtol=0, atol=BILATERAL_ATOL)
