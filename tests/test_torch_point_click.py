"""The point-click and depth-projection defect paths of the port against the
JAX package: `heatmap_to_rays` (ties included), marching tetrahedra,
`create_mesh`, `ray_tracing_points` (through K2's plain version on the
CPU), the depth projections, `choose_points` and `visualize`; and K2's
wrapper refusing counts its kernel cannot index.

Tolerances: rays in JAX's order with the same mask and intensities, their
directions within 1e-6; marching tetrahedra, the crust, the depth
projections and the PLY snapshot bit-equal; ray-traced points to a
relative 1e-6, as tests/test_torch_defect_projection.py's PTS_RTOL (float32
hit distances ~520 mm out, where an ulp is 6e-5 mm, and JAX's XLA pair test
rounds its dot products in another order)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.app import defect_projection as jdp
from sixdof_tpu.app import web_vis as jweb
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.ops import marching as jmarch
from sixdof_tpu.ops.raytrace import heatmap_to_rays as j_rays
from sixdof_tpu_torch.app import defect_projection as tdp
from sixdof_tpu_torch.app import web_vis as tweb
from sixdof_tpu_torch.io import mesh_io as tmio
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.kernels import raytrace as k2
from sixdof_tpu_torch.ops import marching as tmarch
from sixdof_tpu_torch.ops.raytrace import heatmap_to_rays as t_rays

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
DIR_ATOL = 1e-6
PTS_RTOL = 1e-6
RESOLUTION = 24  # the crust's grid (the app's default is 64)


@pytest.fixture(scope="module")
def scene():
    r = DataReader(SCENE)
    heatmap = r.get_heatmap(r.get_color(0))[0].astype(np.float32)
    in_depth = r.color_to_depth @ r.scale_translation_to_millimeters(r.get_gt_pose(0))
    model = r.target.points[::4]  # 5000 of model.ply's points
    posed = model @ in_depth[:3, :3].T + in_depth[:3, 3]
    return dict(reader=r, heatmap=heatmap, model=model, posed=posed)


@pytest.mark.parametrize("levels,threshold,max_points", [
    (None, 0.75, 8192),  # the app's rays
    (8, 0.5, 8192),  # 8 levels: long runs of equal values
    (4, 0.2, 100),  # ties cut by the static count
    (2, 0.99, 50),  # nothing above: every ray masked
])
def test_heatmap_to_rays_matches_jax_with_ties(scene, levels, threshold, max_points):
    hm = scene["heatmap"] if levels is None else \
        (np.round(scene["heatmap"] * levels) / levels).astype(np.float32)
    K = scene["reader"].color_K
    dj, ij, mj = (np.asarray(x) for x in j_rays(jnp.asarray(hm), K, threshold, max_points))
    dt, it, mt = (x.numpy() for x in t_rays(torch.as_tensor(hm), K, threshold, max_points))
    assert dt.shape == dj.shape and dt.dtype == np.float32
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=DIR_ATOL)
    if levels is None:
        assert mt.sum() == 587


def test_marching_tetrahedra_matches_jax():
    g = np.linspace(-1, 1, 20)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    rng = np.random.RandomState(0)
    for field in (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6,  # a sphere
                  np.maximum(np.abs(x), np.abs(y)) - 0.5 + 0.1 * z,  # a prism with flat faces
                  rng.randn(9, 9, 9)):  # every case
        vt, ft = tmarch.marching_tetrahedra(field, 0.0)
        vj, fj = jmarch.marching_tetrahedra(field, 0.0)
        assert len(ft) > 0
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
    assert tmarch.marching_tetrahedra(np.ones((4, 4, 4)))[1].shape == (0, 3)


def test_create_mesh_matches_jax(scene):
    mt = tdp.create_mesh(tmio.PointCloud(scene["model"]), resolution=RESOLUTION)
    mj = jdp.create_mesh(jmio.PointCloud(scene["model"]), resolution=RESOLUTION)
    assert len(mt.faces) > 1000
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)
    for mesh in (tdp.create_mesh(tmio.PointCloud(scene["model"][:3])),
                 tdp.create_mesh(tmio.PointCloud(scene["model"]), iso=1e-9)):
        assert mesh.faces.shape == (0, 3)  # too few points; a band thinner than the grid


def _clicks(scene, n=12):
    """Seeded pixels inside the object's projection in the colour frame."""
    r = scene["reader"]
    in_color = (scene["posed"] - r.color_to_depth[:3, 3]) @ r.color_to_depth[:3, :3]
    K = r.color_pinhole.intrinsic_matrix
    uv = in_color[:, :2] / in_color[:, 2:3] * K[[0, 1], [0, 1]] + K[:2, 2]
    pix = np.unique(np.round(uv).astype(np.int64), axis=0)
    return pix[np.random.RandomState(0).choice(len(pix), n, replace=False)].tolist()


def test_ray_tracing_points_matches_jax(scene, monkeypatch):
    """The scene-posed model cloud meshed inside ray_tracing_points (at the
    reduced grid), and the same crust given as a mesh."""
    r = scene["reader"]
    for mod in (jdp, tdp):
        create = mod.create_mesh
        monkeypatch.setattr(mod, "create_mesh",
                            lambda pcd, create=create: create(pcd, resolution=RESOLUTION))
    clicks = _clicks(scene) + [[0, 0]]  # the corner misses the object
    color = r.get_color(0)
    pj, mj = jdp.ray_tracing_points(SCENE, jmio.PointCloud(scene["posed"]), r.color_pinhole,
                                    color, points=clicks)
    before = k2.ray_mesh_intersect.launches
    pt, mt = tdp.ray_tracing_points(SCENE, tmio.PointCloud(scene["posed"]), r.color_pinhole,
                                    color, points=clicks, device="cpu")
    assert k2.ray_mesh_intersect.launches == before  # the plain version, on the CPU
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    assert 0 < len(pt) == len(pj) < len(clicks)
    np.testing.assert_allclose(pt.points, pj.points, rtol=PTS_RTOL, atol=0)
    np.testing.assert_array_equal(pt.colors, pj.colors)
    crust = tdp.create_mesh(tmio.PointCloud(scene["posed"]))
    again, _ = tdp.ray_tracing_points(SCENE, crust, r.color_pinhole, color, points=clicks,
                                      device="cpu")
    np.testing.assert_array_equal(again.points, pt.points)
    # no click, and clicks that all miss: JAX's empty cloud and debug rays
    for pts in ([], [[0, 0], [1, 1]]):
        et, _ = tdp.ray_tracing_points(SCENE, crust, r.color_pinhole, color, points=pts,
                                       device="cpu")
        ej, _ = jdp.ray_tracing_points(SCENE, jmio.TriMesh(crust.vertices, crust.faces),
                                       r.color_pinhole, color, points=pts)
        np.testing.assert_allclose(et.points, ej.points, rtol=PTS_RTOL, atol=0)


def test_depth_projections_match_jax(scene):
    r = scene["reader"]
    depth = r.get_depth(0) * 1000.0  # mm, as the reference's depth image
    pin = r.color_pinhole
    tgt_t = tmio.PointCloud(scene["posed"])
    tgt_j = jmio.PointCloud(scene["posed"])
    clicks = _clicks(scene) + [[0, 0]]  # no depth at the corner: skipped
    for a, b in zip(tdp.depth_projection_points(depth, pin, tgt_t, points=clicks),
                    jdp.depth_projection_points(depth, pin, tgt_j, points=clicks)):
        assert len(a) == len(clicks) - 1
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgt_t.normals, tgt_j.normals)
    for a, b in zip(tdp.depth_projection_heatmap(depth, pin, tgt_t, scene["heatmap"]),
                    jdp.depth_projection_heatmap(depth, pin, tgt_j, scene["heatmap"])):
        assert len(a) > 1000
        np.testing.assert_array_equal(a, b)


def test_choose_points_headless():
    assert tdp.choose_points(None, points=[(1.7, 2), [3, 4]]) == [(1, 2), (3, 4)]
    pytest.importorskip("matplotlib")
    import matplotlib

    if matplotlib.get_backend().lower() == "agg":
        with pytest.raises(RuntimeError, match="no display"):
            tdp.choose_points(np.zeros((4, 4)))


def test_visualize_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    pts, cols, verts = rng.rand(20, 3), rng.rand(20, 3), rng.rand(9, 3)
    faces = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    tdp.visualize([tmio.PointCloud(pts, colors=cols), tmio.PointCloud(pts[:5]),
                   tmio.TriMesh(verts, faces)], out_path=str(tmp_path / "port.ply"))
    jdp.visualize([jmio.PointCloud(pts, colors=cols), jmio.PointCloud(pts[:5]),
                   jmio.TriMesh(verts, faces)], out_path=str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = tmio.load_point_cloud(str(tmp_path / "port.ply"))
    assert len(back) == 34
    # with the viewer's queue: its payload
    tdp.visualize([tmio.PointCloud(pts)], data_queue=object())
    jdp.visualize([jmio.PointCloud(pts), jmio.TriMesh(verts, faces)], data_queue=object())
    assert tweb._latest_payload["pcds"] == jweb._latest_payload["pcds"]
    assert tweb._latest_payload["faces"] == []


def test_ray_kernel_refuses_counts_it_cannot_index(monkeypatch):
    """Above the kernel's int offsets the wrapper raises (it never falls
    back to the plain version)."""
    class FakeCuda:  # a tensor that claims to be on the card
        device = torch.device("cuda")

        def __init__(self, shape):
            self.shape = shape

    before = k2.ray_mesh_intersect.launches
    for n, t in ((k2.MAX_RAYS + 1, 10), (10, k2.MAX_TRIS + 1)):
        with pytest.raises(ValueError, match="at most"):
            k2.ray_mesh_intersect(FakeCuda((n, 3)), None, None, FakeCuda((t, 9)))
    assert k2.ray_mesh_intersect.launches == before
