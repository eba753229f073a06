"""Geometry, Lie maps, rotation grid and crop warps: the port against the
JAX package on the same seeded numpy inputs (float32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.ops import geometry as jg
from sixdof_tpu.ops import hypotheses as jh
from sixdof_tpu.ops import lie as jl
from sixdof_tpu.ops import warp as jw
from sixdof_tpu_torch.ops import geometry as tg
from sixdof_tpu_torch.ops import hypotheses as th
from sixdof_tpu_torch.ops import lie as tl
from sixdof_tpu_torch.ops import warp as tw

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ATOL = 1e-5  # float32 arithmetic in another order on each side


def _np(x):
    return np.asarray(x)


def _rand_poses(rng, n):
    R = _np(jl.so3_exp_map(jnp.asarray(rng.randn(n, 3), dtype=jnp.float32)))
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = np.c_[rng.randn(n, 2) * 0.05, 0.4 + rng.rand(n) * 0.3]
    return poses


def test_transform_project_depth2xyz(rng):
    pts = rng.randn(2, 50, 3).astype(np.float32)
    tfs = _rand_poses(rng, 2)
    np.testing.assert_allclose(tg.transform_pts(torch.tensor(pts), torch.tensor(tfs)).numpy(),
                               _np(jg.transform_pts(jnp.asarray(pts), jnp.asarray(tfs))),
                               atol=ATOL)
    # rank rule: a batch of tfs on one shared point set
    np.testing.assert_allclose(tg.transform_pts(torch.tensor(pts[0]), torch.tensor(tfs)).numpy(),
                               _np(jg.transform_pts(jnp.asarray(pts[0]), jnp.asarray(tfs))),
                               atol=ATOL)
    K = np.array([[600, 0, 320], [0, 610, 240], [0, 0, 1]], np.float32)
    cam = pts.copy()
    cam[..., 2] = np.abs(cam[..., 2]) + 0.5
    np.testing.assert_allclose(tg.project_points(torch.tensor(cam), torch.tensor(K)).numpy(),
                               _np(jg.project_points(jnp.asarray(cam), jnp.asarray(K))),
                               rtol=1e-5, atol=1e-3)
    depth = (rng.rand(3, 24, 32) * 1.2).astype(np.float32)
    depth[:, :3] = 0.0
    np.testing.assert_array_equal(
        tg.depth2xyzmap(torch.tensor(depth[0]), torch.tensor(K)).numpy(),
        _np(jg.depth2xyzmap(jnp.asarray(depth[0]), jnp.asarray(K))))
    Ks = np.stack([K, K * 0.5, K * 2])
    Ks[:, 2, 2] = 1
    np.testing.assert_array_equal(
        tg.depth2xyzmap_batch(torch.tensor(depth), torch.tensor(Ks)).numpy(),
        _np(jg.depth2xyzmap_batch(jnp.asarray(depth), jnp.asarray(Ks))))


def test_crop_window_and_delta_pose(rng):
    poses = _rand_poses(rng, 7)
    K = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
    for hw in [(160, 160), (96, 96)]:
        np.testing.assert_allclose(
            tg.compute_crop_window_tf_batch(torch.tensor(poses), torch.tensor(K), 1.2, hw,
                                            0.1).numpy(),
            _np(jg.compute_crop_window_tf_batch(jnp.asarray(poses), jnp.asarray(K), 1.2, hw,
                                                0.1)), rtol=1e-6, atol=1e-4)
    other = _rand_poses(rng, 7)
    tj, Rj = jg.pose_to_egocentric_delta_pose(jnp.asarray(poses), jnp.asarray(other))
    tt, Rt = tg.pose_to_egocentric_delta_pose(torch.tensor(poses), torch.tensor(other))
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=ATOL)
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=ATOL)
    back = tg.egocentric_delta_pose_to_pose(torch.tensor(poses), tt, Rt).numpy()
    np.testing.assert_allclose(
        back, _np(jg.egocentric_delta_pose_to_pose(jnp.asarray(poses), tj, Rj)), atol=ATOL)
    np.testing.assert_allclose(back, other, atol=1e-5)
    pts = rng.randn(3000, 3)
    assert tg.compute_mesh_diameter(pts, n_sample=1000) == jg.compute_mesh_diameter(
        pts, n_sample=1000)


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-4, 0.3, 2.0, np.pi - 1e-4, np.pi])
def test_so3_exp_log(scale):
    rng = np.random.RandomState(int(scale * 1000) % 2**31)
    axis = rng.randn(16, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = (axis * scale).astype(np.float32)
    Rj = _np(jl.so3_exp_map(jnp.asarray(w)))
    Rt = tl.so3_exp_map(torch.tensor(w)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=2e-6)
    lj = _np(jl.so3_log_map(jnp.asarray(Rj)))
    lt = tl.so3_log_map(torch.tensor(Rj)).numpy()
    np.testing.assert_allclose(lt, lj, atol=5e-5)
    # near pi the axis sign is ambiguous; the rotation it encodes is not
    np.testing.assert_allclose(tl.so3_exp_map(torch.tensor(lt)).numpy(), Rj, atol=5e-4)


def test_rotation_6d_euler_normalize(rng):
    d6 = rng.randn(9, 6).astype(np.float32)
    np.testing.assert_allclose(tl.rotation_6d_to_matrix(torch.tensor(d6)).numpy(),
                               _np(jl.rotation_6d_to_matrix(jnp.asarray(d6))), atol=2e-6)
    for a in rng.randn(5, 3):
        np.testing.assert_array_equal(tl.euler_matrix(*a), jl.euler_matrix(*a))
    poses = _rand_poses(rng, 4)
    poses[:, :3, :3] *= np.array([1.5, 0.7, 2.0], np.float32)
    np.testing.assert_allclose(tl.normalize_rotation(torch.tensor(poses)).numpy(),
                               _np(jl.normalize_rotation(jnp.asarray(poses))), atol=1e-6)


def test_rotation_grid_matches_jax(monkeypatch):
    jgrid = jh.make_rotation_grid(min_n_views=40, inplane_step=60)
    tgrid = th.make_rotation_grid(min_n_views=40, inplane_step=60)
    assert tgrid.shape == jgrid.shape == (252, 4, 4)
    np.testing.assert_allclose(tgrid, jgrid, atol=1e-6)
    # the numpy clustering path, with a symmetry, against the JAX package's
    # numpy path (its native library switched off)
    import sixdof_tpu.native

    monkeypatch.setattr(sixdof_tpu.native, "available", lambda: False)
    sym = np.stack([np.eye(4), jl.euler_matrix(0, 0, np.pi)])
    views = th.sample_views_icosphere(40)
    poses = np.stack([np.linalg.inv(v @ tl.euler_matrix(0, 0, r)) for v in views
                      for r in np.deg2rad(np.arange(0, 360, 30))])
    kept = th.cluster_poses(30.0, 99999.0, poses, sym)
    assert 0 < len(kept) < len(poses)
    np.testing.assert_array_equal(kept, jh.cluster_poses(30.0, 99999.0, poses, sym))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_crop_batch(rng, mode):
    img = rng.rand(60, 80, 3).astype(np.float32)
    poses = _rand_poses(rng, 5)
    K = np.array([[90, 0, 40], [0, 90, 30], [0, 0, 1]], np.float32)
    tfs = _np(jg.compute_crop_window_tf_batch(jnp.asarray(poses), jnp.asarray(K), 1.2, (32, 24),
                                              0.1))
    ref = _np(jw.warp_crop_batch(jnp.asarray(img), jnp.asarray(tfs), (24, 32), mode=mode))
    got = tw.warp_crop_batch(torch.tensor(img), torch.tensor(tfs), (24, 32), mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    ref2 = _np(jw.warp_crop_batch(jnp.asarray(img[..., 0]), jnp.asarray(tfs), (24, 32), mode=mode))
    got2 = tw.warp_crop_batch(torch.tensor(img[..., 0]), torch.tensor(tfs), (24, 32), mode=mode)
    np.testing.assert_allclose(got2.numpy(), ref2, atol=1e-5)
