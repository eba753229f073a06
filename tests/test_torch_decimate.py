"""`decimate_mesh` and `TriMesh.triangles` of the port
(`sixdof_tpu_torch/io/mesh_io.py`) against the JAX package's, in float64 on
both sides: synth_box's pose mesh with seeded uv, subdivided to 20,480
triangles (the size at which the BOP campaign decimates), cut to 5000
triangles and at fixed voxel sizes.  Faces, vertices, colours and uv come
out equal."""
import os
import sys

import numpy as np
import pytest

from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu_torch.io import mesh_io as tmio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its subdivision builds the 20,480-triangle mesh)


@pytest.fixture(scope="module")
def meshes():
    mesh = tmio.load_mesh(os.path.join(REPO, "demo_data", "synth_box", "mesh",
                                       "model_scaled_down.obj"))
    mesh.uv = np.random.RandomState(0).rand(len(mesh.vertices), 2)
    fine = chip_smoke._subdivide(chip_smoke._subdivide(mesh))
    assert len(fine.faces) == 20480
    twin = jmio.TriMesh(fine.vertices.copy(), fine.faces.copy(),
                        vertex_colors=fine.vertex_colors.copy(), uv=fine.uv.copy())
    return fine, twin


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    for x, y in ((a.vertex_colors, b.vertex_colors), (a.uv, b.uv)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [{"target_tris": 5000}, {"target_tris": 1000},
                                {"voxel_size": 0.004}, {"voxel_size": 0.0015},
                                {"target_tris": 30000}])
def test_decimate_matches_jax(meshes, kw):
    fine, twin = meshes
    got = tmio.decimate_mesh(fine, **kw)
    _assert_equal(got, jmio.decimate_mesh(twin, **kw))
    if "target_tris" in kw:
        assert len(got.faces) <= kw["target_tris"]
    np.testing.assert_array_equal(got.triangles, got.faces)


def test_decimate_without_attributes_matches_jax(meshes):
    fine, _ = meshes
    plain_t = tmio.TriMesh(fine.vertices, fine.faces)
    plain_j = jmio.TriMesh(fine.vertices.copy(), fine.faces.copy())
    _assert_equal(tmio.decimate_mesh(plain_t, target_tris=5000),
                  jmio.decimate_mesh(plain_j, target_tris=5000))
