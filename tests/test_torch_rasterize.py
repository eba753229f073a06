"""Rasterizer and raster kernel K1: the port against the JAX package.

The JAX reference runs on the CPU as its own tests run it: the XLA scan path
(use_pallas=False) for render_batch, and the Pallas kernel in interpret mode
for the z-buffer core.  On the CPU the port's K1 wrapper runs its plain
PyTorch version; the CUDA kernel itself is held against that version on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.io import mesh_io as jm
from sixdof_tpu.ops import rasterize as jr
from sixdof_tpu.ops.geometry import compute_crop_window_tf_batch as j_crop
from sixdof_tpu.ops.lie import so3_exp_map as j_exp
from sixdof_tpu.ops.pallas.raster_kernel import group_coefficients, rasterize_zbuffer_pallas
from sixdof_tpu_torch.io import mesh_io as tm
from sixdof_tpu_torch.kernels import raster as k1
from sixdof_tpu_torch.ops import rasterize as tr

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
K_IMG = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
K_SMALL = np.array([[200, 0, 24], [0, 200, 20], [0, 0, 1]], np.float32)
# float32 vertex math in another order on each side: positions agree to
# ~1e-4 m, colours/normals to ~2e-4; a pixel whose centre lies on an edge
# may fall on either side, so up to 0.2% of pixels may switch coverage
ATTR_ATOL = {"depth": 5e-4, "xyz_map": 5e-4, "color": 1e-3, "normal": 1e-3}
MAX_COVER_DIFF = 0.002


@pytest.fixture(scope="module")
def meshes():
    a, b = jm.load_mesh(MESH), tm.load_mesh(MESH)
    c = (a.vertices.max(0) + a.vertices.min(0)) / 2
    a.vertices = a.vertices - c
    b.vertices = b.vertices - c
    return jr.make_mesh_arrays(a), tr.make_mesh_arrays(b, "cpu")


def _poses(seed, n):
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = np.asarray(j_exp(jnp.asarray(rng.randn(n, 3) * 1.5, dtype=jnp.float32)))
    poses[:, :3, 3] = np.c_[rng.randn(n, 2) * 0.01, 0.5 + rng.rand(n) * 0.1]
    return poses


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
@pytest.mark.parametrize("crop", [False, True], ids=["nocrop", "crop"])
def test_render_batch_matches_xla(meshes, cull, crop):
    ja, ta = meshes
    poses = _poses(1, 5)
    if crop:
        K, hw = K_IMG, (40, 48)
        tfs = np.asarray(j_crop(jnp.asarray(poses), jnp.asarray(K), 1.2, (48, 40), 0.1))
    else:
        K, hw, tfs = K_SMALL, (40, 48), None
    ref = jr.render_batch(ja, jnp.asarray(poses), jnp.asarray(K),
                          None if tfs is None else jnp.asarray(tfs), out_hw=hw, use_pallas=False,
                          backface_cull=cull, get_normal=True)
    got = tr.render_batch(ta, torch.tensor(poses), torch.tensor(K),
                          None if tfs is None else torch.tensor(tfs), out_hw=hw,
                          backface_cull=cull, get_normal=True)
    a_ref, a_got = np.asarray(ref["alpha"]), got["alpha"].numpy()
    assert a_got.mean() > 0.1  # the object is in view
    same = a_ref == a_got
    assert 1 - same.mean() <= MAX_COVER_DIFF
    for k, tol in ATTR_ATOL.items():
        r, g = np.asarray(ref[k]), got[k].numpy()
        np.testing.assert_allclose(g[same], r[same], atol=tol, err_msg=k)


def _raster_inputs(ta, poses, K, hw, cull):
    tfs = j_crop(jnp.asarray(poses), jnp.asarray(K), 1.2, (hw[1], hw[0]), 0.1)
    s = tr.zbuffer_setup(ta, torch.tensor(poses), torch.tensor(K), torch.tensor(np.asarray(tfs)),
                         backface_cull=cull)
    return s, tfs


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
def test_tid_matches_xla_scan_outside_ties(meshes, cull):
    ja, ta = meshes
    hw = (32, 40)
    poses = _poses(2, 4)
    s, tfs = _raster_inputs(ta, poses, K_IMG, hw, cull)
    z, tid_c = k1.rasterize_zbuffer(s["coef_c"], s["counts"], *hw)
    tid = torch.where(tid_c >= 0, torch.gather(s["order"], 1, tid_c.clamp(min=0).long()), -1)
    valid = (torch.arange(s["order"].shape[1])[None] < s["counts"][:, None])
    valid_orig = torch.zeros_like(valid).scatter(1, s["order"], valid).numpy()
    # the JAX scan on the same vertex setup, one pose at a time
    for b in range(len(poses)):
        p = jnp.asarray(poses[b])
        pc = ja.pos @ p[:3, :3].T + p[:3, 3]
        uvw = pc @ jnp.asarray(K_IMG).T
        uv = uvw[:, :2] / jnp.maximum(uvw[:, 2:3], 0.001)
        uv = (jnp.concatenate([uv, jnp.ones_like(uv[:, :1])], -1) @ tfs[b].T)[:, :2]
        t_ref, _, z_ref = jr._rasterize_one(uv, pc[:, 2], ja.faces, hw, 64, 0.001,
                                            valid_override=jnp.asarray(valid_orig[b]))
        t_ref, z_ref = np.asarray(t_ref).reshape(-1), np.asarray(z_ref).reshape(-1)
        t_got, z_got = tid[b].numpy(), z[b].numpy()
        assert (t_got >= 0).mean() > 0.1
        cover = (t_ref >= 0) == (t_got >= 0)
        assert 1 - cover.mean() <= MAX_COVER_DIFF
        np.testing.assert_allclose(z_got[cover], z_ref[cover], atol=5e-4)
        diff = cover & (t_ref != t_got)
        assert diff.mean() <= 0.002
        # where the winners differ, the two surfaces are at the same depth (a tie)
        np.testing.assert_allclose(z_got[diff], z_ref[diff], atol=1e-4)


@pytest.mark.parametrize("cull", [False, True], ids=["nocull", "cull"])
def test_zbuffer_core_matches_pallas_interpret(meshes, cull):
    """Same plane coefficients into the Pallas kernel (interpret mode) and
    into the port's K1 wrapper (plain version on the CPU)."""
    _, ta = meshes
    hw = (32, 32)
    poses = _poses(3, 2)
    s, _ = _raster_inputs(ta, poses, K_IMG, hw, cull)
    coef = s["coef"].numpy()
    valid = (torch.arange(coef.shape[1])[None] < s["counts"][:, None])
    valid = torch.zeros_like(valid).scatter(1, s["order"], valid).numpy()
    grouped = group_coefficients(jnp.asarray(coef), jnp.asarray(valid), tri_chunk=128)
    z_ref, t_ref = rasterize_zbuffer_pallas(grouped, *hw, tri_chunk=128, tile=512,
                                            interpret=True)
    z_ref, t_ref = np.asarray(z_ref), np.asarray(t_ref)
    z, tid_c = k1.rasterize_zbuffer(s["coef_c"], s["counts"], *hw)
    t_got = torch.where(tid_c >= 0, torch.gather(s["order"], 1, tid_c.clamp(min=0).long()),
                        -1).numpy()
    assert (t_got >= 0).mean() > 0.1
    cover = (t_ref >= 0) == (t_got >= 0)
    assert 1 - cover.mean() <= MAX_COVER_DIFF
    np.testing.assert_allclose(z.numpy()[cover], z_ref[cover], atol=1e-6)
    assert (t_got[cover] != t_ref[cover]).mean() <= 0.002


def test_plain_zbuffer_tie_rule():
    """Equal inverse depth: the lowest candidate index wins; misses read -1."""
    coef = torch.zeros((1, 3, 4, 3))
    coef[0, :, 0, 2] = coef[0, :, 1, 2] = coef[0, :, 2, 2] = 1.0  # inside everywhere
    coef[0, :, 3, 2] = torch.tensor([2.0, 4.0, 4.0])  # iz; triangles 1 and 2 tie
    z, t = k1.rasterize_zbuffer(coef, torch.tensor([3], dtype=torch.int32), 2, 2)
    assert (t == 1).all() and torch.allclose(z, torch.full_like(z, 0.25))
    z, t = k1.rasterize_zbuffer(coef, torch.tensor([1], dtype=torch.int32), 2, 2)
    assert (t == 0).all() and torch.allclose(z, torch.full_like(z, 0.5))
    z, t = k1.rasterize_zbuffer(coef, torch.tensor([0], dtype=torch.int32), 2, 2)
    assert (t == -1).all() and (z == 0).all()
