"""The small functions the port had left out, against the JAX package:
`ops/geometry.py::{to_homo, transform_dirs,
projection_matrix_from_intrinsics, symmetry_tfs_from_info}`,
`ops/lie.py::{matrix_to_rotation_6d, rotation_geodesic_distance}` and
`ops/depth_filter.py::preprocess_depth`."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.ops import depth_filter as jdf
from sixdof_tpu.ops import geometry as jgeo
from sixdof_tpu.ops import lie as jlie
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.ops import depth_filter as tdf
from sixdof_tpu_torch.ops import geometry as tgeo
from sixdof_tpu_torch.ops import lie as tlie

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DISCRETE = [float(x) for x in np.array([[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 12.5],
                                         [0, 0, 0, 1]]).reshape(-1)]
INFOS = {
    "empty": {"diameter": 100.0},
    "discrete": {"diameter": 100.0, "symmetries_discrete": [_DISCRETE, _DISCRETE]},
    "continuous_x": {"symmetries_continuous": [{"axis": [1, 0, 0], "offset": [0, 0, 0]}]},
    "continuous_y": {"symmetries_continuous": [{"axis": [0, 1, 0], "offset": [0.5, 0, 0]}]},
    "continuous_z": {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                     "symmetries_discrete": [_DISCRETE]},
    "continuous_negative_axis": {"symmetries_continuous": [{"axis": [0, 0, -1],
                                                            "offset": [0, 0, 0]}]},
}


@pytest.mark.parametrize("name", list(INFOS))
@pytest.mark.parametrize("step", [5, 30])
def test_symmetry_tfs_match_jax(name, step):
    got = tgeo.symmetry_tfs_from_info(INFOS[name], rot_angle_discrete=step)
    want = jgeo.symmetry_tfs_from_info(INFOS[name], rot_angle_discrete=step)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_small_geometry_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 7, 3).astype(np.float32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    tfs[:, :3, :3] = np.linalg.qr(rng.randn(2, 3, 3))[0]
    tfs[:, :3, 3] = rng.randn(2, 3)
    np.testing.assert_array_equal(tgeo.to_homo(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jgeo.to_homo(jnp.asarray(pts))))
    for d, tf in ((pts[0], tfs), (pts, tfs), (pts[0], tfs[0])):
        np.testing.assert_allclose(
            tgeo.transform_dirs(torch.as_tensor(d), torch.as_tensor(tf)).numpy(),
            np.asarray(jgeo.transform_dirs(jnp.asarray(d), jnp.asarray(tf))), rtol=0, atol=1e-6)
    K = np.array([[600.0, 0.5, 320.0], [0, 610.0, 240.0], [0, 0, 1]])
    for wc in ("y_up", "y_down"):
        np.testing.assert_array_equal(
            tgeo.projection_matrix_from_intrinsics(K, 480, 640, 0.01, 10.0, wc),
            jgeo.projection_matrix_from_intrinsics(K, 480, 640, 0.01, 10.0, wc))
    with pytest.raises(NotImplementedError):
        tgeo.projection_matrix_from_intrinsics(K, 480, 640, 0.01, 10.0, "y_sideways")


def test_lie_leftovers_match_jax():
    rng = np.random.RandomState(1)
    R1 = np.linalg.qr(rng.randn(5, 3, 3))[0].astype(np.float32)
    R2 = np.linalg.qr(rng.randn(5, 3, 3))[0].astype(np.float32)
    R2[0] = R1[0]  # the identity case
    np.testing.assert_array_equal(tlie.matrix_to_rotation_6d(torch.as_tensor(R1)).numpy(),
                                  np.asarray(jlie.matrix_to_rotation_6d(jnp.asarray(R1))))
    np.testing.assert_allclose(
        tlie.rotation_geodesic_distance(torch.as_tensor(R1), torch.as_tensor(R2)).numpy(),
        np.asarray(jlie.rotation_geodesic_distance(jnp.asarray(R1), jnp.asarray(R2))),
        rtol=0, atol=1e-3)  # arccos near 1 amplifies the float32 trace's last ulp


def test_preprocess_depth_matches_jax():
    """On a synth_box frame at 120x160: erosion is bit-equal, the bilateral
    filter's sums agree to 1e-6 m (XLA's fused order, tests of
    ops/depth_filter.py)."""
    depth = DataReader(os.path.join(REPO, "demo_data", "synth_box"),
                       shorter_side=120).get_depth(0).astype(np.float32)
    got = tdf.preprocess_depth(torch.as_tensor(depth), radius=2, zfar=1.0).numpy()
    want = np.asarray(jdf.preprocess_depth(jnp.asarray(depth), radius=2, zfar=1.0))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
