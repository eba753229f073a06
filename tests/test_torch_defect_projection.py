"""Defect projection of the port against the JAX package: the heatmap
reader, heatmap -> rays, the ray trace onto the posed CAD mesh and the
defect cloud, on synth_box with the same numpy inputs.

Tolerances: hit sets equal, defect points to rtol 1e-6 (K2's plain version
against the JAX XLA path, tests/test_torch_raytrace.py); the heatmap
resample to 5e-7 on values in [0, 1] (OpenCV's INTER_LINEAR sums its two
taps in an order numpy does not reproduce: up to 2 float32 ulps); everything
else bit-equal."""
import os

import numpy as np
import pytest
import torch

from sixdof_tpu.app import defect_projection as jdp
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu.utils.colormap import jet_colormap as jjet
from sixdof_tpu_torch.app import defect_projection as tdp
from sixdof_tpu_torch.io.readers import DataReader as TReader
from sixdof_tpu_torch.io.readers import resize_linear
from sixdof_tpu_torch.utils.colormap import jet_colormap as tjet

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
RESAMPLE_ATOL = 5e-7
PTS_RTOL = 1e-6


@pytest.mark.parametrize("shorter_side", [None, 240, 123])
def test_get_heatmap_matches_jax(shorter_side):
    """JAX's 4-tuple.  The heatmap: 480 -> 480 at the native size and at 240
    (a copy); 480 -> 476 at shorter_side 123, where int() rounding makes it
    a real resample.  The colour crop bit-equal: the frame itself at the
    native size, enlarged by INTER_AREA at 240 (x2) and 123 (x3.9)."""
    jr, tr = JReader(SCENE, shorter_side=shorter_side), TReader(SCENE, shorter_side=shorter_side)
    full_j, col_j, vis_j, col2_j = jr.get_heatmap(jr.get_color(0))
    full_t, col_t, vis_t, col2_t = tr.get_heatmap(tr.get_color(0))
    assert col_t.dtype == col_j.dtype == np.uint8 and col2_t is col_t and col2_j is col_j
    np.testing.assert_array_equal(col_t, col_j)
    assert full_t.dtype == full_j.dtype == np.float64 and vis_t.dtype == vis_j.dtype
    assert full_t.shape == full_j.shape and vis_t.shape == vis_j.shape
    if shorter_side == 123:
        assert vis_t.shape == (476, 476)
        np.testing.assert_allclose(full_t, full_j, rtol=0, atol=RESAMPLE_ATOL)
        np.testing.assert_array_equal(full_t > 0.75, full_j > 0.75)
    else:
        np.testing.assert_array_equal(full_t, full_j)


@pytest.mark.parametrize("shape", [(480, 480, 479, 479), (50, 70, 123, 31), (9, 7, 3, 20)])
def test_resize_linear_matches_opencv(shape):
    import cv2

    h, w, H, W = shape
    img = np.random.RandomState(h).rand(h, w).astype(np.float32)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, W, H)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)


def test_reader_capture_inputs_match_jax():
    jr, tr = JReader(SCENE), TReader(SCENE)
    assert tr.parameters == jr.parameters
    for name in ("color_to_depth", "depth_to_color", "inverse_color_to_depth"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))
    np.testing.assert_array_equal(tr.color_pinhole.intrinsic_matrix,
                                  jr.color_pinhole.intrinsic_matrix)
    assert (tr.color_pinhole.width, tr.color_pinhole.height) == (jr.color_pinhole.width,
                                                                 jr.color_pinhole.height)
    np.testing.assert_array_equal(tr.get_source(2).points, jr.get_source(2).points)
    np.testing.assert_array_equal(tr.background.points, jr.background.points)
    np.testing.assert_array_equal(tr.target.points, jr.target.points)
    np.testing.assert_array_equal(tr.target_mesh.vertices, jr.target_mesh.vertices)
    np.testing.assert_array_equal(tr.target_mesh.vertex_normals, jr.target_mesh.vertex_normals)
    pose = jr.get_gt_pose(1)
    np.testing.assert_array_equal(tr.scale_translation_to_millimeters(pose),
                                  jr.scale_translation_to_millimeters(pose))
    ct, dt = tdp.load_intrinsics(os.path.join(SCENE, "configs", "camera_intrinsics.json"))
    cj, dj = jdp.load_intrinsics(os.path.join(SCENE, "configs", "camera_intrinsics.json"))
    np.testing.assert_array_equal(ct.intrinsic_matrix, cj.intrinsic_matrix)
    np.testing.assert_array_equal(dt.intrinsic_matrix, dj.intrinsic_matrix)


def test_rays_and_colours_match_jax():
    reader = TReader(SCENE)
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    pt, pj = tdp.heatmap_to_points(heatmap, 0.75), jdp.heatmap_to_points(heatmap, 0.75)
    assert pt == pj and len(pt) == 587
    K = tdp.PinholeCameraIntrinsic.from_params(640, 480, 600.0, 600.0, 320.0, 240.0)
    rt_, it_ = tdp.compute_rays(pt, K)
    rj, ij = jdp.compute_rays(pj, jdp.PinholeCameraIntrinsic.from_params(
        640, 480, 600.0, 600.0, 320.0, 240.0))
    np.testing.assert_array_equal(rt_, rj)
    np.testing.assert_array_equal(it_, ij)
    x = np.linspace(-0.1, 1.1, 97)
    np.testing.assert_array_equal(tjet(x), jjet(x))
    pts = np.random.RandomState(0).randn(20, 3)
    a, b = tdp.create_intersection_pcd(pts, it_[:20]), jdp.create_intersection_pcd(pts, ij[:20])
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.colors, b.colors)
    a, b = tdp.project_debug_rays(rt_[:5], np.zeros(3)), jdp.project_debug_rays(rj[:5],
                                                                                np.zeros(3))
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("frame", [0, 2])
def test_ray_tracing_matches_jax(frame):
    """The app's frame-0 ray trace: model.obj posed (depth camera, mm) by
    the annotated pose, heatmap threshold 0.75."""
    tr = TReader(SCENE)
    heatmap = tr.get_heatmap(tr.get_color(0))[0]
    pose = tr.color_to_depth @ tr.scale_translation_to_millimeters(tr.get_gt_pose(frame))
    mesh_t = tr.target_mesh.copy().transform(pose)
    mesh_j = jmio.TriMesh(mesh_t.vertices.copy(), mesh_t.faces.copy())
    pcd_t, m_t = tdp.ray_tracing(SCENE, mesh_t, heatmap, tr.color_pinhole, 0.75, device="cpu")
    pcd_j, m_j = jdp.ray_tracing(SCENE, mesh_j, heatmap, tr.color_pinhole, 0.75)
    np.testing.assert_array_equal(m_t.vertices, m_j.vertices)
    assert len(pcd_t) == len(pcd_j) > 100
    np.testing.assert_allclose(pcd_t.points, pcd_j.points, rtol=PTS_RTOL)
    np.testing.assert_array_equal(pcd_t.colors, pcd_j.colors)
    # no hit: the debug rays cloud, as in the JAX app
    shift = np.eye(4)
    shift[0, 3] = 5000.0
    far = mesh_t.copy().transform(shift)
    pcd_t, _ = tdp.ray_tracing(SCENE, far, heatmap, tr.color_pinhole, 0.75, device="cpu")
    assert len(pcd_t) == 2 * 587 and np.allclose(pcd_t.colors, [1, 0, 0])
