"""tools/sensor_model_torch.py against OpenCV and against
tools/sensor_model.py on the CPU: each ported OpenCV routine bit-equal to
its cv2 call on hypothesis-drawn inputs (blur sigmas 0.3-1.5; 3x3 and 5x5
morphology on uint8 and float32 with invalid fills; circles centred on
and off the image, radii 3-13; odd motion kernels up to 31), and each
sensor-model function equal to its JAX-package counterpart on the same
seeded RandomState.

Two stated tolerances: cv2.filter2D correlates kernels of 130 taps or
more (13x13 and up) through a DFT, and the port sums them directly; there
the two agree within FILTER2D_DFT_ATOL (2 ulp of values in [0, 1]).  And
in GaussianBlur's scalar tail (the last (width x channels) % 8 floats of a
row) about one pixel in 10^4 ends 1 ulp apart (GAUSSIAN_TAIL_ULP); rows
of a multiple of 8 floats, as every generated frame has, are bit-equal."""
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import sensor_model as jsm  # noqa: E402
import sensor_model_torch as tsm  # noqa: E402

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

FILTER2D_DFT_ATOL = 2.4e-7
GAUSSIAN_TAIL_ULP = 1
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _image(seed, h, w, cn, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shape = (h, w) if cn == 1 else (h, w, cn)
    return rng.rand(*shape).astype(dtype)


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(16, 64), w8=st.integers(2, 10),
       cn=st.sampled_from([1, 3]), sigma=st.floats(0.3, 1.5))
def test_gaussian_blur_is_cv2s(seed, h, w8, cn, sigma):
    """Rows of a multiple of 8 floats (the generator's frames: 640 x 3 and
    128 x 3) take OpenCV's vector loops only: bit-equal."""
    img = _image(seed, h, 8 * w8, cn)
    np.testing.assert_array_equal(tsm.gaussian_blur(img, sigma),
                                  cv2.GaussianBlur(img, (0, 0), sigma))


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(16, 64), w=st.integers(16, 80),
       cn=st.sampled_from([1, 3]), sigma=st.floats(0.3, 1.5))
def test_gaussian_blur_tail_columns(seed, h, w, cn, sigma):
    """Any width: bit-equal on the columns OpenCV's vector loops cover; on
    the last (w * cn) % 8 floats of a row, its scalar tail, within 1 ulp
    (rarely 1 ulp apart: GAUSSIAN_TAIL_ULP)."""
    img = _image(seed, h, w, cn)
    got = tsm.gaussian_blur(img, sigma).reshape(h, -1)
    want = cv2.GaussianBlur(img, (0, 0), sigma).reshape(h, -1)
    vec = w * cn // 8 * 8
    np.testing.assert_array_equal(got[:, :vec], want[:, :vec])
    np.testing.assert_array_max_ulp(got[:, vec:], want[:, vec:], maxulp=GAUSSIAN_TAIL_ULP)


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.6, 0.9, 1.2, 1.5])
def test_gaussian_kernel_is_cv2s(sigma):
    n = len(tsm.gaussian_kernel(sigma))
    np.testing.assert_array_equal(tsm.gaussian_kernel(sigma),
                                  cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel())


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(8, 48), w=st.integers(8, 48),
       ksize=st.sampled_from([3, 5]), iterations=st.sampled_from([1, 2]),
       dtype=st.sampled_from(["uint8", "float32"]), cn=st.sampled_from([1, 3]))
def test_morphology_is_cv2s(seed, h, w, ksize, iterations, dtype, cn):
    rng = np.random.RandomState(seed)
    shape = (h, w) if cn == 1 else (h, w, cn)
    if dtype == "uint8":
        img = (rng.rand(*shape) < 0.3).astype(np.uint8) * rng.randint(1, 256, shape).astype(
            np.uint8)
    else:  # depth-like values with the invalid fills degrade_depth uses
        img = rng.uniform(0.3, 0.9, shape).astype(np.float32)
        img[rng.rand(*shape) < 0.2] = 1e3
        img[rng.rand(*shape) < 0.2] = 0.0
    kern = np.ones((ksize, ksize), np.uint8)
    np.testing.assert_array_equal(tsm.dilate(img, ksize, iterations),
                                  cv2.dilate(img, kern, iterations=iterations))
    np.testing.assert_array_equal(tsm.erode(img, ksize, iterations),
                                  cv2.erode(img, kern, iterations=iterations))


@SETTINGS
@given(h=st.integers(16, 64), w=st.integers(16, 64), cx=st.integers(-20, 84),
       cy=st.integers(-20, 84), r=st.integers(3, 13))
def test_fill_circle_is_cv2s(h, w, cx, cy, r):
    a = np.zeros((h, w), np.uint8)
    b = a.copy()
    tsm.fill_circle(a, (cx, cy), r, 1)
    cv2.circle(b, (cx, cy), r, 1, -1)
    np.testing.assert_array_equal(a, b)


@SETTINGS
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(40, 64), w=st.integers(40, 80),
       length=st.floats(1.0, 51.0), angle=st.floats(0.0, 6.283))
def test_filter2d_is_cv2s(seed, h, w, length, angle):
    kern = tsm.motion_kernel(np.array([np.cos(angle), np.sin(angle)]) * length / 0.6)
    img = _image(seed, h, w, 3)
    got, want = tsm.filter2d(img, kern), cv2.filter2D(img, -1, kern)
    if kern.size < 130:
        np.testing.assert_array_equal(got, want)
    else:  # OpenCV's DFT correlation
        np.testing.assert_allclose(got, want, rtol=0, atol=FILTER2D_DFT_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_sensor_functions_match_jax_packages(seed, strength):
    """Every function on the same seeded RandomState, on a frame with a
    depth edge, invalid pixels and a mask; the generators end in step."""
    h, w = 48, 64
    base = np.random.RandomState(100 + seed)
    color = base.rand(h, w, 3).astype(np.float32)
    depth = np.full((h, w), 0.62, np.float32)
    depth[10:30, 20:44] = 0.55 + base.rand(20, 24).astype(np.float32) * 0.01
    depth[base.rand(h, w) < 0.05] = 0.0
    mask = np.zeros((h, w), np.uint8)
    mask[10:30, 20:44] = 255
    K = np.array([[600.0, 0, 32], [0, 600.0, 24], [0, 0, 1]])
    rngs = [np.random.RandomState(seed), np.random.RandomState(seed)]
    outs = []
    for mod, rng in zip((jsm, tsm), rngs):
        outs.append([mod.perturb_K(K, rng, strength), mod.sequence_drift(5, rng, strength),
                     mod.degrade_depth(depth, rng, strength),
                     mod.degrade_rgb(color, rng, strength),
                     mod.degrade_mask(mask, rng, strength),
                     mod.motion_blur_rgb(color, np.array([3.5, -2.0]), strength),
                     mod.motion_blur_rgb(color, np.array([0.5, 0.2]), strength)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30)
