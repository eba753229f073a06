"""DBSCAN labels of the port (`sixdof_tpu_torch/ops/pointcloud.py`) against
the JAX package's native routine (`native/sixdof_native.cpp::dbscan`, which
the JAX package loads by default), border points included; and the capture
call of the run loop, `preprocess_source(..., i=i)`, on the capture frames of
every 6-frame demo scene."""
import os

import numpy as np
import pytest
import torch

from sixdof_tpu import native
from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.ops import pointcloud as tpc

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["synth_box", "synth_box_sensor", "synth_clutter", "synth_clutter_sensor", "synth_occl"]
N_CLOUDS = 200


def _cloud(seed):
    """A seeded cloud: blobs, uniform noise and, every other seed, chains of
    points between two blobs at about eps spacing, so that border points
    touch cores of two clusters."""
    rng = np.random.RandomState(seed)
    eps = float(rng.uniform(2.0, 6.0))
    min_points = int(rng.randint(3, 12))
    parts = [rng.randn(int(rng.randint(20, 200)), 3) * rng.uniform(1, 4) + rng.uniform(-60, 60, 3)
             for _ in range(rng.randint(1, 5))]
    parts.append(rng.rand(int(rng.randint(0, 80)), 3) * 150 - 75)
    if seed % 2:
        a, b = rng.uniform(-10, 10, 3), rng.uniform(-10, 10, 3)
        b = a + (b - a) / np.linalg.norm(b - a) * 2.2 * eps  # a gap of one border point
        parts += [a + rng.randn(60, 3) * 0.4 * eps, b + rng.randn(60, 3) * 0.4 * eps,
                  ((a + b) / 2 + rng.randn(6, 3) * 0.05 * eps)]
    pts = np.concatenate(parts)
    return pts[rng.permutation(len(pts))], eps, min_points


def test_native_library_is_the_reference():
    assert native.available()


@pytest.mark.parametrize("block", range(4))
def test_labels_equal_native(block):
    shared_borders = 0
    for seed in range(block * N_CLOUDS // 4, (block + 1) * N_CLOUDS // 4):
        pts, eps, min_points = _cloud(seed)
        want = native.dbscan_labels(pts, eps, min_points)
        got = tpc.dbscan_labels(pts, eps, min_points)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        # count the border points within eps of cores of two clusters
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        near = d <= eps
        core = near.sum(1) >= min_points
        for i in np.flatnonzero(~core & (got >= 0)):
            shared_borders += len(set(got[near[i] & core])) > 1
    assert shared_borders > 0  # the case where the order of labelling matters


def test_degenerate_clouds():
    for pts in (np.zeros((0, 3)), np.zeros((1, 3)), np.zeros((5, 3)),
                np.arange(30.0).reshape(10, 3) * 100):
        for min_points in (1, 3, 6):
            np.testing.assert_array_equal(tpc.dbscan_labels(pts, 1.0, min_points),
                                          native.dbscan_labels(pts, 1.0, min_points))


@pytest.mark.parametrize("scene", SCENES)
def test_capture_preprocess_matches_jax(scene):
    """The run loop's capture call (no near point) on frames 0, 2 and 4:
    the same points, to 1e-9 mm (the clouds come from the same seeded
    numpy calls)."""
    reader = DataReader(os.path.join(REPO, "demo_data", scene))
    jreader = JReader(os.path.join(REPO, "demo_data", scene))
    counts = {}
    for i in (0, 2, 4):
        src = reader.get_source(i)
        got, _, _ = tip.preprocess_source(src, reader.background, reader.parameters, i=i)
        want, _, _ = jip.preprocess_source(jreader.get_source(i), jreader.background,
                                           jreader.parameters, i=i)
        assert len(got) == len(want), (scene, i)
        np.testing.assert_allclose(got.points, want.points, rtol=0, atol=1e-9)
        counts[i] = len(got)
    if scene == "synth_occl":
        assert counts[2] == 286

