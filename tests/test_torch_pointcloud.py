"""Host point-cloud preprocessing of the port against the JAX package on
the demo scene's clouds (synth_box frames 0 and 2, mm): the same seeded
numpy calls, so every cloud is expected bit-equal."""
import os

import numpy as np
import pytest
import torch

from sixdof_tpu import native
from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.ops import pointcloud as jpc
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.io import mesh_io as tmio
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.ops import pointcloud as tpc

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")


@pytest.fixture(scope="module")
def scene():
    return DataReader(SCENE)


def _pair(t_pcd):
    """A JAX-package PointCloud with the same arrays."""
    return jmio.PointCloud(t_pcd.points.copy(),
                           None if t_pcd.colors is None else t_pcd.colors.copy(),
                           None if t_pcd.normals is None else t_pcd.normals.copy())


def _assert_same(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.points, b.points)
    for name in ("colors", "normals"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("frame", [0, 2])
def test_cloud_functions_match_jax(scene, frame):
    src = scene.get_source(frame)
    down_t = tpc.voxel_down_sample(src, 4.0)
    down_j = jpc.voxel_down_sample(_pair(src), 4.0)
    _assert_same(down_t, down_j)
    _assert_same(tpc.random_down_sample(src, 3000), jpc.random_down_sample(_pair(src), 3000))
    nt = tpc.estimate_normals(down_t.copy(), radius=2, max_nn=5)
    nj = jpc.estimate_normals(_pair(down_t), radius=2, max_nn=5)
    _assert_same(nt, nj)
    plane_t, inl_t = tpc.segment_plane(down_t, 2.0, num_iterations=100)
    plane_j, inl_j = jpc.segment_plane(_pair(down_t), 2.0, num_iterations=100)
    np.testing.assert_array_equal(plane_t, plane_j)
    np.testing.assert_array_equal(inl_t, inl_j)
    avg_t = tpc.compute_average_normal(nt)
    np.testing.assert_array_equal(avg_t, jpc.compute_average_normal(nj))
    ft, nrm_t = tpc.flip_plane_normal_if_needed(plane_t, -avg_t)
    fj, nrm_j = jpc.flip_plane_normal_if_needed(plane_j, -avg_t)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(nrm_t, nrm_j)
    above_t = tpc.remove_points_below_plane(down_t, ft)
    _assert_same(above_t, jpc.remove_points_below_plane(_pair(down_t), fj))
    _assert_same(tpc.remove_plane(down_t, inl_t), jpc.remove_plane(_pair(down_t), inl_j))
    bg_t = tpc.voxel_down_sample(scene.background, 8.0)
    fg_t = tpc.background_removal(above_t, bg_t)
    _assert_same(fg_t, jpc.background_removal(_pair(above_t), _pair(bg_t)))
    np.testing.assert_array_equal(tpc.dbscan_labels(fg_t.points, 10.0, 10),
                                  jpc.dbscan_labels(fg_t.points, 10.0, 10))
    near = scene.get_gt_pose(frame)[:3, 3] * 1000.0
    for kw in ({}, {"near_point": near, "near_radius": 60.0}):
        _assert_same(tpc.filter_largest_cluster(fg_t, **kw),
                     jpc.filter_largest_cluster(_pair(fg_t), **kw))
    _assert_same(tpc.remove_statistical_outliers(fg_t, 75, 0.01),
                 jpc.remove_statistical_outliers(_pair(fg_t), 75, 0.01))
    _assert_same(tpc.smooth_resample(fg_t, 5.0, 3, 200),
                 jpc.smooth_resample(_pair(fg_t), 5.0, 3, 200))


def test_dbscan_matches_jax_scipy_path(monkeypatch):
    """The port gives the labels of the native library the JAX package
    loads by default; the JAX package's scipy fallback names the same
    clusters (on this cloud no border point touches two of them)."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.randn(300, 3) * 3.0, rng.randn(200, 3) * 3.0 + 40.0,
                          rng.rand(40, 3) * 200.0])
    want_native = jpc.dbscan_labels(pts, 5.0, 8)
    monkeypatch.setattr(native, "available", lambda: False)
    want = jpc.dbscan_labels(pts, 5.0, 8)
    got = tpc.dbscan_labels(pts, 5.0, 8)
    np.testing.assert_array_equal(got, want_native)
    assert len(set(got[got >= 0])) == 2
    # the scipy path's labels name the same clusters
    np.testing.assert_array_equal(got >= 0, want >= 0)
    for lab in set(got[got >= 0]):
        assert len(set(want[got == lab])) == 1


@pytest.mark.parametrize("frame", [0, 2])
def test_preprocess_matches_jax(scene, frame):
    params = scene.parameters
    tgt_t, fpfh_t = tip.preprocess_target(scene.target.copy(), params)
    tgt_j, fpfh_j = jip.preprocess_target(_pair(scene.target), params)
    assert fpfh_t is None and fpfh_j is None
    _assert_same(tgt_t, tgt_j)
    src = scene.get_source(frame)
    kw = {}
    if frame == 0:
        tb = scene.target.points.max(axis=0) - scene.target.points.min(axis=0)
        kw = dict(near_point=scene.get_gt_pose(0)[:3, 3] * 1000.0,
                  near_radius=0.75 * float(np.linalg.norm(tb)))
    bg_t = scene.background
    bg_j = _pair(bg_t)
    out_t, _, _ = tip.preprocess_source(src.copy(), bg_t, params, i=frame, **kw)
    out_j, _, _ = jip.preprocess_source(_pair(src), bg_j, params, i=frame, **kw)
    _assert_same(out_t, out_j)
    assert len(out_t) > 100


def test_point_cloud_and_mesh_methods_match_jax():
    rng = np.random.RandomState(1)
    tf = np.eye(4)
    tf[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    tf[:3, 3] = rng.randn(3)
    pts, nrm = rng.randn(50, 3), rng.randn(50, 3)
    a = tmio.PointCloud(pts, normals=nrm).transform(tf).paint_uniform_color([1, 0, 0])
    b = jmio.PointCloud(pts, normals=nrm).transform(tf).paint_uniform_color([1, 0, 0])
    _assert_same(a, b)
    idx = [3, 7, 11]
    for inv in (False, True):
        _assert_same(a.select_by_index(idx, invert=inv), b.select_by_index(idx, invert=inv))
    path = os.path.join(SCENE, "mesh", "model.obj")
    mt, mj = tmio.load_mesh(path), jmio.load_mesh(path)
    mt.compute_vertex_normals().apply_transform(tf)
    mj.compute_vertex_normals().apply_transform(tf)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.vertex_normals, mj.vertex_normals)
    np.testing.assert_array_equal(mt.bounds(), mj.bounds())
    np.testing.assert_array_equal(mt.copy().transform(tf).vertices,
                                  mj.copy().transform(tf).vertices)
