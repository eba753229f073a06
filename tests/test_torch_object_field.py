"""The neural object field (sixdof_tpu_torch/models/object_field.py, with
ops/lie.py::se3_exp_map and metrics.py's chamfer distance) against the JAX
package on the CPU, on the same numpy inputs and JAX's own draws, at a
small spec (8 levels, a 2^15 table, 64 rays, 8 + 8 samples).

Tolerances (float32 on both sides):
- hash-grid indices equal; trilinear weights, the SH basis, ray-box spans,
  the samples along each ray and the se(3) maps within 1e-6 (the same
  float32 operations, which XLA may contract or reorder);
- the encode's forward within 1e-9 (table values ~1e-4), its backward
  (d_table, d_w) within 1e-6 of the largest entry (duplicate-index sums
  in another order);
- the loss and each of its parts within 2e-5 relative; its gradients
  within 1e-4 of each tensor's largest entry (float32 matmuls and
  scatter-adds summed in another order);
- one full step, Adam included: each parameter within 1e-4 of its step
  (lr 0.01), except where JAX's gradient is below 1e-6: Adam's first step
  is lr * g / (|g| + 1e-8), which multiplies a gradient's rounding by up
  to lr / 1e-8 there, so those entries are held to one step (lr);
- the ray table, the dilation, the chamfer distance and the occupancy
  grid: equal (the same host numpy, scipy and comparisons); the
  optimized poses within 1e-6;
- the SDF grid within 1e-5; the extracted meshes within 1% in faces, 99%
  of the port's vertices within 1e-4 of one of JAX's (grid values within
  1e-5 of the level can fall on either side of it); the texture
  bake: the same UVs and vertices, texels within 1 of 255 (the float32
  colour rounded to uint8)."""
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sixdof_tpu import metrics as jmetrics
from sixdof_tpu.io.mesh_io import TriMesh as JMesh
from sixdof_tpu.models import object_field as jof
from sixdof_tpu.ops import lie as jlie
from sixdof_tpu.ops.hypotheses import icosphere
from sixdof_tpu_torch import metrics as tmetrics
from sixdof_tpu_torch.io.mesh_io import TriMesh, load_mesh, save_mesh
from sixdof_tpu_torch.models import object_field as tof
from sixdof_tpu_torch.ops import lie as tlie

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

JSPEC = jof.HashGridSpec(n_levels=8, base_res=8, finest_res=64, log2_hashmap_size=15)
TSPEC = tof.HashGridSpec(*JSPEC)
CFG = dict(n_rand=64, n_samples=8, n_samples_around_depth=8, lrate=0.01)


def _np(x):
    return np.asarray(x)


def _points(seed, n):
    """Seeded points in [-1,1]^3, with the cube's faces and corners among them."""
    x = np.random.RandomState(seed).uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:8] = np.array([[(c >> d) & 1 for d in range(3)] for c in range(8)]) * 2.0 - 1.0
    return x


def _jax_init_draws(key, spec, frame_feat_dim=2, sh_degree=3):
    """init_field's draws, from the key's splits as jof.init_field makes them."""
    ks = jax.random.split(key, 8)
    c_in = sh_degree**2 + frame_feat_dim + 15
    shapes = dict(sigma1=(spec.out_dim, 64), sigma2=(64, 16), color1=(c_in, 64),
                  color2=(64, 64), color3=(64, 3))
    draws = {k: torch.tensor(_np(jax.random.normal(ks[i], s)))
             for i, (k, s) in enumerate(shapes.items())}
    draws["table"] = torch.tensor(_np(jof.init_hash_grid(ks[5], spec)))
    return draws


def _jax_z_draws(key, n, cfg):
    """sample_z_vals' three uniforms, from the key as the JAX body splits it."""
    k1, k2, k3 = jax.random.split(key, 3)
    U = jax.random.uniform
    return {"u1": torch.tensor(_np(U(k1, (n, cfg.n_samples)))),
            "u2": torch.tensor(_np(U(k2, (n, cfg.n_samples_around_depth)))),
            "u3": torch.tensor(_np(U(k3, (n, cfg.n_samples_around_depth))))}


def _jax_step_draws(key, cfg, n_rays):
    """The JAX step's draws for its key: the minibatch, then the samples."""
    kidx, key = jax.random.split(key)
    idx = jax.random.randint(kidx, (cfg.n_rand,), 0, n_rays)
    return {"idx": torch.tensor(_np(idx)).long(), **_jax_z_draws(key, cfg.n_rand, cfg)}


def _tree(params):
    return {k: jax.tree.map(np.asarray, v) for k, v in params._asdict().items()}


def _assert_close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * max(np.abs(want).max(), 1e-30))


def _scene(n_frames=2, R=24):
    """The JAX tests' flat 2-view depth patch (tests/test_object_field.py)."""
    K = np.array([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]])
    rgbs, depths, masks, cams = [], [], [], []
    rng = np.random.RandomState(3)
    for k in range(n_frames):
        depths.append(np.full((R, R), 0.3) + 0.01 * rng.rand(R, R))
        masks.append((rng.rand(R, R) > 0.2).astype(np.uint8))
        rgbs.append(rng.randint(0, 255, (R, R, 3)).astype(np.uint8))
        pose = np.eye(4)
        pose[2, 3] = -0.3 + 0.02 * k
        cams.append(pose)
    return K, np.stack(rgbs), np.stack(depths), np.stack(masks), np.stack(cams)


def _runners(scene=None, **cfg):
    """A JAX runner and a port runner on the same scene, the port holding
    the JAX runner's initial field."""
    scene = scene or _scene()
    jc = jof.ObjectFieldConfig(**{**CFG, **cfg})
    jr = jof.ObjectFieldRunner(jc, *scene, spec=JSPEC)
    tr = tof.ObjectFieldRunner(tof.ObjectFieldConfig(*jc), *scene, spec=TSPEC, device="cpu")
    tr.params = tof.field_params_from_numpy(_tree(jr.params), "cpu")
    tr.opt = torch.optim.Adam(tr.params.parameters(), lr=jc.lrate)
    return jr, tr


def test_hash_grid_spec_and_indices():
    assert TSPEC.offsets == JSPEC.offsets and TSPEC.out_dim == JSPEC.out_dim
    default = tof.HashGridSpec()
    assert default.offsets == jof.HashGridSpec().offsets  # 2^22: the hashed levels too
    for spec_t, spec_j in ((TSPEC, JSPEC), (default, jof.HashGridSpec())):
        x = _points(0, 512)
        ji, jw = jof.hash_grid_indices(jnp.asarray(x), spec_j)
        ti, tw = tof.hash_grid_indices(torch.tensor(x), spec_t)
        assert ti.dtype == torch.int32 and ti.shape == (8, spec_t.n_levels, 512)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-6)
        assert ti.min() >= 0 and ti.max() < spec_t.offsets[-1]


def test_encode_forward_and_custom_backward():
    key = jax.random.PRNGKey(0)
    table = jof.init_hash_grid(key, JSPEC)
    x = _points(1, 300)
    cot = np.random.RandomState(2).randn(300, JSPEC.out_dim).astype(np.float32)

    # the encode and its gradients through x and the table
    jout, jvjp = jax.vjp(lambda t, p: jof.hash_grid_encode(t, p, JSPEC), table, jnp.asarray(x))
    jdt, jdx = jvjp(jnp.asarray(cot))
    tt = torch.tensor(_np(table), requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tout = tof.hash_grid_encode(tt, tx, TSPEC)
    np.testing.assert_allclose(tout.detach().numpy(), _np(jout), atol=1e-9)
    tout.backward(torch.tensor(cot))
    _assert_close_rel(tt.grad.numpy(), jdt, 1e-6)
    _assert_close_rel(tx.grad.numpy(), jdx, 1e-4)

    # d_table and d_w of the lookup itself against the JAX custom VJP
    idx, w = jof.hash_grid_indices(jnp.asarray(x), JSPEC)
    cot_l = jnp.asarray(np.random.RandomState(3).randn(2, JSPEC.n_levels, 300)
                        .astype(np.float32))

    def lookup(t, w):
        return jnp.stack([jof._lookup_col(JSPEC, t[:, f], idx, w) for f in range(2)])

    _, vjp = jax.vjp(lookup, table, w)
    jd_table, jd_w = vjp(cot_l)
    tt = torch.tensor(_np(table), requires_grad=True)
    tw_ = torch.tensor(_np(w), requires_grad=True)
    out = tof._LookupCorners.apply(tt, torch.tensor(_np(idx)), tw_, TSPEC)  # (L,N,2)
    out.backward(torch.tensor(_np(cot_l)).permute(1, 2, 0))
    _assert_close_rel(tt.grad.numpy(), jd_table, 1e-6)
    _assert_close_rel(tw_.grad.numpy(), jd_w, 1e-6)


def test_sh_encode_and_ray_box():
    d = np.random.RandomState(4).randn(200, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for degree in (1, 2, 3):
        np.testing.assert_allclose(tof.sh_encode(torch.tensor(d), degree).numpy(),
                                   _np(jof.sh_encode(jnp.asarray(d), degree)), atol=1e-6)
    o = np.random.RandomState(5).uniform(-2, 2, (200, 3)).astype(np.float32)
    d[:4] = [[0, 0, 1], [1, 0, 0], [0, -1, 0], [1e-12, 0, 1]]
    for a, b in zip(tof.ray_box_intersect(torch.tensor(o), torch.tensor(d)),
                    jof.ray_box_intersect(jnp.asarray(o), jnp.asarray(d))):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)


def test_sample_z_vals_and_sdf2weights():
    cfg = jof.ObjectFieldConfig(**CFG)
    rng = np.random.RandomState(6)
    n = 64
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) + np.float32([0, 0, -1.5])
    d = rng.randn(n, 3).astype(np.float32) * 0.1 + np.float32([0, 0, 1])
    td = rng.uniform(0.8, 1.6, n).astype(np.float32)
    td[:8] = 99.0  # no depth: the second stratified set
    td[8:12] = 0.0
    key = jax.random.PRNGKey(7)
    args = (cfg.n_samples, cfg.n_samples_around_depth, 0.05, 1.0, 3.0)
    jz, jv = jof.sample_z_vals(key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(td), *args)
    tz, tv = tof.sample_z_vals(torch.tensor(o), torch.tensor(d), torch.tensor(td), *args,
                               _jax_z_draws(key, n, cfg))
    np.testing.assert_allclose(tz.numpy(), _np(jz), atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    sdf = rng.randn(*tz.shape).astype(np.float32)
    jw = jof.sdf2weights(jnp.asarray(sdf), jz, jnp.asarray(td), 0.05, 5.0, 1.0, 3.0)
    tw = tof.sdf2weights(torch.tensor(sdf), torch.tensor(_np(jz)), torch.tensor(td), 0.05, 5.0,
                         1.0, 3.0)
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-6)


@pytest.mark.parametrize("size", [10, 5, 4, 3])
def test_mask_dilation_matches_opencv(size):
    rng = np.random.RandomState(size)
    for shape in ((24, 31), (7, 5)):
        m = (rng.rand(*shape) > 0.93).astype(np.uint8)
        m[0, 0] = m[-1, -1] = 1  # the borders
        np.testing.assert_array_equal(tof.dilate_mask(m, size),
                                      cv2.dilate(m, np.ones((size, size), np.uint8)))


def test_frame_rays_and_scene_bounds():
    K, rgbs, depths, masks, cams = _scene(3)
    depths[1, :3] = 99.0  # bad depth
    masks[2] = 0
    masks[2, 10, 12] = 1  # one pixel: the 10x10 dilation's window
    pts = np.random.RandomState(8).randn(100, 3)
    sj, tj = jof.compute_scene_bounds(pts)
    st, tt = tof.compute_scene_bounds(pts)
    assert sj == st
    np.testing.assert_array_equal(tj, tt)
    np.testing.assert_array_equal(
        tof.make_frame_rays(rgbs / 255.0, depths, masks, cams, K, 1.7),
        jof.make_frame_rays(rgbs / 255.0, depths, masks, cams, K, 1.7))


def test_init_field_from_jax_draws():
    key = jax.random.PRNGKey(11)
    jp = jof.init_field(key, JSPEC, 3)
    tp = tof.init_field(TSPEC, 3, _jax_init_draws(key, JSPEC))
    for k, v in tp.tree().items():
        want = _tree(jp)
        for part in k.split("/"):
            want = want[int(part)] if part.isdigit() else want[part]
        np.testing.assert_array_equal(v, want, err_msg=k)
    carried = tof.field_params_from_numpy(_tree(jp), "cpu").tree()
    assert all(np.array_equal(carried[k], v) for k, v in tp.tree().items())


def test_loss_parts_and_gradients():
    jr, tr = _runners()
    cfg = jr.cfg
    # non-zero latents and pose corrections, so every term and the se(3) path count
    rng = np.random.RandomState(9)
    ff = rng.randn(*jr.params.frame_features.shape).astype(np.float32) * 0.3
    pd = rng.randn(*jr.params.pose_deltas.shape).astype(np.float32) * 0.3
    jp = jr.params._replace(frame_features=jnp.asarray(ff), pose_deltas=jnp.asarray(pd))
    tp = tof.field_params_from_numpy(_tree(jp), "cpu")
    batch = jr.rays[np.random.RandomState(10).randint(0, len(jr.rays), cfg.n_rand)]
    key = jax.random.PRNGKey(12)
    jloss = jof.make_loss_fn(cfg, JSPEC, jr.sc_factor)
    (jl, jparts), jg = jax.value_and_grad(jloss, has_aux=True)(jp, jnp.asarray(batch), key)
    tl, tparts = tof.make_loss_fn(tr.cfg, TSPEC, tr.sc_factor)(
        tp, torch.tensor(batch), _jax_z_draws(key, cfg.n_rand, cfg))
    assert float(jparts["sdf"]) > 0 and float(jparts["fs"]) > 0 and float(jparts["empty"]) > 0
    for k in jparts:
        np.testing.assert_allclose(tparts[k].item(), float(jparts[k]), rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-5)
    tl.backward()
    _assert_close_rel(tp.table.grad.numpy(), jg.table, 1e-4)
    _assert_close_rel(tp.frame_features.grad.numpy(), jg.frame_features, 1e-4)
    _assert_close_rel(tp.pose_deltas.grad.numpy(), jg.pose_deltas, 1e-4)
    for name in ("sigma_w", "color_w"):
        for layer, (gw, gb) in zip(getattr(tp, name), getattr(jg, name)):
            _assert_close_rel(layer.w.grad.numpy(), gw, 1e-4)
            _assert_close_rel(layer.b.grad.numpy(), gb, 1e-4)


def test_one_full_step_with_adam():
    jr, tr = _runners()
    key = jax.random.PRNGKey(13)
    rays = jnp.asarray(jr.rays)
    _, gkey = jax.random.split(key)
    batch = rays[jnp.asarray(_jax_step_draws(key, jr.cfg, len(jr.rays))["idx"].numpy())]
    jg = jax.grad(lambda p: jof.make_loss_fn(jr.cfg, JSPEC, jr.sc_factor)(p, batch, gkey)[0])(
        jr.params)
    jp, _, jl, jparts = jr._step(jr.params, jr.opt_state, rays, key)
    before = tr.params.tree()
    tl, tparts = tr.step(_jax_step_draws(key, jr.cfg, len(jr.rays)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    assert tr.global_step == 1
    got = tr.params.tree()
    want, grads = {}, {}
    for tree, out in ((jp, want), (jg, grads)):
        out.update(table=tree.table, frame_features=tree.frame_features,
                   pose_deltas=tree.pose_deltas)
        for name in ("sigma_w", "color_w"):
            for i, (w, b) in enumerate(getattr(tree, name)):
                out[f"{name}/{i}/0"], out[f"{name}/{i}/1"] = w, b
    lr = jr.cfg.lrate
    for k, v in want.items():
        assert np.abs(_np(v) - before[k]).max() > 0 or k == "pose_deltas", k
        tol = np.where(np.abs(_np(grads[k])) < 1e-6, lr, 1e-4 * lr)
        assert (np.abs(got[k] - _np(v)) <= tol).all(), (k, np.abs(got[k] - _np(v)).max())


def test_se3_exp_map():
    tw = np.random.RandomState(14).randn(64, 6).astype(np.float32) * 0.5
    tw[:4, 3:] = [[0, 0, 0], [1e-5, 0, 0], [0, 2e-4, -1e-4], [3.0, 0.1, 0]]
    np.testing.assert_allclose(tlie.se3_exp_map(torch.tensor(tw)).numpy(),
                               _np(jlie.se3_exp_map(jnp.asarray(tw))), atol=1e-6)


def test_chamfer_distance_and_surface_samples():
    v, f = icosphere(subdivisions=2, radius=0.1)
    a, b = (JMesh(v, f), JMesh(v * 1.1 + [0.02, 0, 0], f))
    ta, tb = TriMesh(v, f), TriMesh(v * 1.1 + [0.02, 0, 0], f)
    np.testing.assert_array_equal(tmetrics.sample_surface(v, f, 500, seed=3),
                                  jmetrics.sample_surface(v, f, 500, seed=3))
    assert tmetrics.chamfer_distance(ta, tb, n_sample=3000) == \
        jmetrics.chamfer_distance(a, b, n_sample=3000)
    assert tmetrics.chamfer_distance(ta, ta, n_sample=3000) < 5e-3


def test_occupancy_grid():
    rng = np.random.RandomState(0)
    d = rng.randn(2000, 3)
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 0.5
    for dilate in (0, 1, 2):
        jg = jof.OccupancyGrid(pts, resolution=32, dilate=dilate)
        tg = tof.OccupancyGrid(pts, resolution=32, dilate=dilate, device="cpu")
        np.testing.assert_array_equal(tg.grid.numpy(), _np(jg.grid))
    q = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.query(torch.tensor(q)).numpy(), _np(jg.query(jnp.asarray(q))))
    o = rng.uniform(-1, 1, (100, 3)).astype(np.float32) * [1, 1, 0] + np.float32([0, 0, -1.5])
    dd = np.tile(np.float32([[0, 0, 1]]), (100, 1))
    for a, b in zip(tg.ray_near_far(torch.tensor(o), torch.tensor(dd)),
                    jg.ray_near_far(jnp.asarray(o), jnp.asarray(dd))):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)


def test_optimized_poses():
    jr, tr = _runners()
    np.testing.assert_array_equal(tr.poses_normalized, jr.poses_normalized)
    pd = np.random.RandomState(15).randn(2, 6).astype(np.float32)
    jr.params = jr.params._replace(pose_deltas=jnp.asarray(pd))
    with torch.no_grad():
        tr.params.pose_deltas.copy_(torch.tensor(pd))
    got, want = tr.get_optimized_poses(), jr.get_optimized_poses()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got[1] - jr.poses_normalized[1]).max() > 1e-4  # the correction applied
    np.testing.assert_allclose(got[0][:3, :3], jr.poses_normalized[0][:3, :3], atol=1e-6)


def test_save_load_round_trip(tmp_path):
    _, r1 = _runners()
    r1.train(3, log_every=0)
    path = str(tmp_path / "field_ckpt")
    r1.save_weights(path)
    assert sorted(os.listdir(path)) == ["field.npz"]
    with np.load(os.path.join(path, "field.npz")) as z:
        assert set(z.files) == {"field/table", "field/frame_features", "field/pose_deltas",
                                "field/sigma_w/0/0", "field/sigma_w/0/1", "field/sigma_w/1/0",
                                "field/sigma_w/1/1", "field/color_w/0/0", "field/color_w/0/1",
                                "field/color_w/1/0", "field/color_w/1/1", "field/color_w/2/0",
                                "field/color_w/2/1", "step", "sc_factor", "translation"}
    # a runner over other frames restores the trained normalization
    K, rgbs, depths, masks, cams = _scene()
    r2 = tof.ObjectFieldRunner(r1.cfg, K, rgbs, depths * 1.5, masks, cams, spec=TSPEC,
                               device="cpu")
    assert r2.sc_factor != r1.sc_factor
    r2.load_weights(path)
    assert r2.global_step == r1.global_step == 3 and r2.sc_factor == r1.sc_factor
    np.testing.assert_array_equal(r2.translation, r1.translation)
    for k, v in r1.params.tree().items():
        np.testing.assert_array_equal(r2.params.tree()[k], v)
    losses = r2.train(2, log_every=0)
    assert np.isfinite(losses).all() and r2.global_step == 5


def test_extract_color_and_bake_texture(tmp_path):
    jr, tr = _runners()
    jr.train(2, log_every=0)
    tr.params = tof.field_params_from_numpy(_tree(jr.params), "cpu")
    grid = jr.query_sdf_grid(16)
    np.testing.assert_allclose(tr.query_sdf_grid(16), grid, atol=1e-5)
    iso = float(np.median(grid))  # a level set the 2-step field has
    jm, tm = jr.extract_mesh(16, iso), tr.extract_mesh(16, iso)
    # grid values within 1e-5 of the level may fall on either side of it
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces) and len(jm.faces) > 0
    dist, _ = cKDTree(jm.vertices).query(tm.vertices)
    assert (dist < 1e-4).mean() > 0.99
    np.testing.assert_allclose(tr.mesh_to_real_world(tm.copy()).vertices,
                               tm.vertices / tr.sc_factor - tr.translation)
    v = np.array([[0.3, 0, 0], [-0.3, 0, 0], [0, 0.3, 0], [0, -0.3, 0],
                  [0, 0, 0.3], [0, 0, -0.3]])
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    jc = jr.color_mesh(JMesh(v, f))
    tc = tr.color_mesh(TriMesh(v, f))
    np.testing.assert_allclose(tc.vertex_colors, jc.vertex_colors, atol=1e-3)
    jb = jr.bake_texture(JMesh(v, f), cell=8)
    tb = tr.bake_texture(TriMesh(v, f), cell=8, chunk=100)  # chunks of whole faces
    np.testing.assert_array_equal(tb.uv, jb.uv)
    np.testing.assert_array_equal(tb.vertices, jb.vertices)
    np.testing.assert_array_equal(tb.faces, jb.faces)
    assert tb.texture.shape == jb.texture.shape == (24, 24, 3)
    assert np.abs(tb.texture.astype(int) - jb.texture.astype(int)).max() <= 1
    p = str(tmp_path / "baked.obj")
    save_mesh(p, tb)
    back = load_mesh(p)
    np.testing.assert_array_equal(back.texture, tb.texture)
    np.testing.assert_allclose(back.uv, tb.uv, atol=1e-6)


def test_object_field_fits_sphere():
    """The port's counterpart of tests/test_object_field.py's sphere fit:
    render a sphere's depth from 4 views, fit, extract, and check the
    recovered radius and the chamfer distance to the true sphere."""
    R_img = 48
    K = np.array([[60.0, 0, 24], [0, 60.0, 24], [0, 0, 1]])
    radius = 0.05
    rgbs, depths, masks, cam_in_obs = [], [], [], []
    for k in range(4):
        ang = k * np.pi / 2
        cam_pos = np.array([0.25 * np.sin(ang), 0, -0.25 * np.cos(ang)])
        z_axis = -cam_pos / np.linalg.norm(cam_pos)
        x_axis = np.cross([0, 1, 0], z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        cam_in_ob = np.eye(4)
        cam_in_ob[:3, 0], cam_in_ob[:3, 1], cam_in_ob[:3, 2] = x_axis, y_axis, z_axis
        cam_in_ob[:3, 3] = cam_pos
        c = np.linalg.inv(cam_in_ob)[:3, 3]  # sphere centre in the camera
        us, vs = np.meshgrid(np.arange(R_img), np.arange(R_img))
        dirs = np.stack([(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
                         np.ones_like(us, float)], axis=-1)
        dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        b = dn @ c
        disc = b**2 - (c @ c - radius**2)
        hit = disc > 0
        t = b - np.sqrt(np.where(hit, disc, 0))
        depths.append(np.where(hit, t * dn[..., 2], 0.0))
        rgbs.append(np.full((R_img, R_img, 3), 180, dtype=np.uint8))
        masks.append(hit.astype(np.uint8))
        cam_in_obs.append(cam_in_ob)

    cfg = tof.ObjectFieldConfig(n_step=80, n_rand=512, n_samples=32,
                                n_samples_around_depth=32, lrate=0.01)
    runner = tof.ObjectFieldRunner(cfg, K, np.stack(rgbs), np.stack(depths), np.stack(masks),
                                   np.stack(cam_in_obs), spec=tof.HashGridSpec(
                                       n_levels=8, base_res=8, finest_res=64,
                                       log2_hashmap_size=15), device="cpu")
    losses = runner.train(80, log_every=0)
    assert losses[-1] < losses[0]
    mesh = runner.extract_mesh(resolution=48)
    assert len(mesh.vertices) > 100
    mesh = runner.mesh_to_real_world(mesh)
    r = np.linalg.norm(mesh.vertices, axis=-1)
    assert abs(np.median(r) - radius) < 0.02, f"median radius {np.median(r)} vs {radius}"
    gv, gf = icosphere(subdivisions=3, radius=radius)
    cd = tmetrics.chamfer_distance(mesh, TriMesh(gv, gf), n_sample=5000)
    assert cd < 0.01, f"chamfer {cd * 1e3:.2f} mm vs the true sphere ({radius * 1e3:.0f} mm)"
