"""Procedural training objects (parallel/procgen.py): the port against the
JAX package.  Host numpy with the same seeded draws, so the meshes must be
bit-equal (tolerance 0)."""
import numpy as np
import pytest
import torch

from sixdof_tpu.parallel import procgen as jp
from sixdof_tpu_torch.parallel import procgen as tp

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])


@pytest.mark.parametrize("seed,subdivisions", [(100, 4), (101, 4), (7, 2), (12345, 3)])
def test_procedural_mesh_bit_equal(seed, subdivisions):
    a = jp.make_procedural_mesh(seed, subdivisions=subdivisions)
    b = tp.make_procedural_mesh(seed, subdivisions=subdivisions)
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.faces, a.faces)
    np.testing.assert_array_equal(b.vertex_colors, a.vertex_colors)
    assert b.vertex_colors.dtype == np.uint8
    if subdivisions == 4:  # the shared training topology
        assert b.faces.shape == (5120, 3) and b.vertices.shape == (2562, 3)


def test_procedural_objects_match():
    ref = jp.procedural_objects(2, K, subdivisions=2)
    got = tp.procedural_objects(2, K, "cpu", subdivisions=2)
    for (ja, jK, jd), (ta, tK, td) in zip(ref, got):
        assert td == jd  # the same float64 host computation
        np.testing.assert_array_equal(tK, jK)
        np.testing.assert_array_equal(ta.pos.numpy(), np.asarray(ja.pos))
        np.testing.assert_array_equal(ta.faces.numpy(), np.asarray(ja.faces))
        np.testing.assert_array_equal(ta.vertex_color.numpy(), np.asarray(ja.vertex_color))
        assert ta.tex is None and ta.uv is None
