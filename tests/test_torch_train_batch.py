"""The trainer's batch makers (parallel/train.py): the port against the
JAX package on the CPU, from the same draws.  The JAX functions take a key;
the port takes the draws that key gives, rebuilt by repeating the JAX
bodies' key splits (tests/torch_train_draws.py).

Two comparisons per configuration:
- the body: the port's compose step (background, depth noise, erosion,
  clutter, sensor model, visibility substitution) and the scorer's targets
  and teacher, fed JAX's own poses, crop windows and renders (rebuilt from
  the key with JAX's functions), against JAX's batch: A, B, targets and
  teacher within 1e-5.  Threshold decisions on float math may flip only
  under the margin rule: where JAX's value lies within 1e-6 of the
  threshold (the occluder ellipse, the hole field; the test computes the
  values with JAX), plus the 3-pixel ring that the depth erosion and the
  dropout's 3x3 pooling spread a flip over; a uint8 quantisation level may
  step by one (a value at a rounding tie); a sample's visibility
  substitution may differ only where its occluded share lies within 1e-6
  of its gate.  This comparison also holds the rebuilt draws: a wrong draw
  moves the batch.
- the whole slice: the port's own renders, which differ from JAX's
  (vertex math in another order; depth moves up to ~3e-5 m for a 1-ulp
  change of a pose): the refiner's targets within 1e-6, the scorer's
  within 1e-5; A and B within test_torch_rasterize.py's render tolerances
  (colour 1e-3, xyz 5e-4) on all but 0.5% of values; the teacher within
  0.02."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_draws as draws_of
from sixdof_tpu.io import mesh_io as jm
from sixdof_tpu.ops import rasterize as jr
from sixdof_tpu.ops.geometry import compute_crop_window_tf_batch as j_crop
from sixdof_tpu.ops.geometry import compute_mesh_diameter
from sixdof_tpu.ops.geometry import egocentric_delta_pose_to_pose as j_ego
from sixdof_tpu.ops.lie import so3_exp_map as j_exp
from sixdof_tpu.parallel import train as J
from sixdof_tpu_torch.io import mesh_io as tm
from sixdof_tpu_torch.models.predict import occlusion_mask
from sixdof_tpu_torch.ops import rasterize as tr
from sixdof_tpu_torch.parallel import train as T

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
K_IMG = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
HW = (48, 48)
ATOL, MARGIN, RING = 1e-5, 1e-6, 3
# scorer batches: 2 scenes x L hypotheses.  At L=2 the ladder is the truth
# and an exact flip; at the trainer's L=12 rungs 1-5 take graded rotations
# and rungs 6-7 sit on the float32 flip threshold
N_SCENES = 2


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def meshes():
    """synth_box's box, centred: vertex-coloured, and with seeded uv and a
    smooth texture.  kind -> (JAX arrays, port arrays, diameter)."""
    m = jm.load_mesh(MESH)
    v = m.vertices - (m.vertices.max(0) + m.vertices.min(0)) / 2
    yy, xx = np.mgrid[0:32, 0:32]
    tex = np.stack([xx * 8, yy * 8, (xx + yy) * 4], -1).astype(np.uint8)
    uv = np.random.RandomState(0).rand(len(v), 2)
    diam = float(compute_mesh_diameter(v))
    out = {}
    for kind, kw in (("vertex_colour", dict(vertex_colors=m.vertex_colors)),
                     ("textured", dict(uv=uv, texture=tex))):
        out[kind] = (jr.make_mesh_arrays(jm.TriMesh(v, m.faces, **kw)),
                     tr.make_mesh_arrays(tm.TriMesh(v, m.faces, **kw), "cpu"), diam)
    return out


def _renders(jmesh, hyp, true, diam):
    """JAX's crop windows and renders, as its batch makers call them."""
    K = jnp.asarray(K_IMG)
    tf = j_crop(hyp, K, crop_ratio=1.2, out_size=(HW[1], HW[0]), mesh_diameter=diam)
    rA = jr.render_batch(jmesh, hyp, K, tf, out_hw=HW, use_light=True)
    rB = jr.render_batch(jmesh, true, K, tf, out_hw=HW, use_light=True)
    return tf, rA, rB


def _jax_refiner_parts(key, jmesh, diam, cfg):
    """make_refiner_batch's poses and renders, from its own key splits."""
    k1, k2, _, _ = jax.random.split(key, 4)
    gt = J._random_poses(k1, cfg.batch_size, cfg.z_range)
    pert, _, _ = J._perturb(k2, gt, cfg.trans_normalizer * 0.9, cfg.rot_normalizer * 1.2)
    return (gt, pert) + _renders(jmesh, pert, gt, diam)


def _jax_scorer_parts(key, jmesh, diam, cfg):
    """make_scorer_batch's hypothesis ladder and renders: its lines, in JAX."""
    L = cfg.n_hypotheses
    N = N_SCENES * L
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    gt = jnp.repeat(J._random_poses(k1, N_SCENES, cfg.z_range), L, axis=0)
    scale = jnp.tile(jnp.linspace(0.0, 1.0, L), N_SCENES)
    dt = jax.random.uniform(k2, (N, 3), minval=-1, maxval=1) * (scale[:, None] * diam * 0.3)
    rot_amp = jnp.where(scale > 0.5, jnp.pi, 0.6 * scale)
    dw = jax.random.uniform(k3, (N, 3), minval=-1, maxval=1) * rot_amp[:, None]
    is_flip = (scale > 0.5) & (scale <= 0.5 + 2.0 / jnp.maximum(L - 1, 1))
    ang = jax.random.uniform(k4, (N,), minval=0.0, maxval=2 * jnp.pi)
    flip_axis = jnp.stack([jnp.cos(ang), jnp.sin(ang), jnp.zeros_like(ang)], axis=-1)
    dw = jnp.where(is_flip[:, None], flip_axis * jnp.pi + 0.05 * dw, dw)
    hyp = j_ego(gt, dt, j_exp(dw))
    return (gt, hyp) + _renders(jmesh, hyp, gt, diam)


def _margin_pixels(d, cfg):
    """(N,H,W): pixels where one of JAX's threshold values lies within
    MARGIN of its threshold, dilated by the RING that erosion and pooling
    spread a flip over."""
    H, W = HW
    near = np.zeros((len(np.asarray(d["noise"])), H, W), bool)
    for o in d.get("occluders", []):  # _crop_occluder's ellipse, in JAX
        c, r, ang = (jnp.asarray(o[k]) for k in ("c", "r", "ang"))
        cx, cy, rx, ry = c[:, 0] * W, c[:, 1] * H, r[:, 0] * W, r[:, 1] * H
        dx = jnp.arange(W, dtype=jnp.float32)[None, None, :] - cx
        dy = jnp.arange(H, dtype=jnp.float32)[None, :, None] - cy
        xr = dx * jnp.cos(ang) + dy * jnp.sin(ang)
        yr = -dx * jnp.sin(ang) + dy * jnp.cos(ang)
        near |= np.abs(np.asarray((xr / rx) ** 2 + (yr / ry) ** 2) - 1.0) < MARGIN
    if "sensor" in d:  # degrade_xyz_batch's hole field and threshold
        x = d["sensor"]["xyz"]
        field = jax.image.resize(x["field"], (near.shape[0], H, W), method="bilinear")
        near |= np.abs(np.asarray(field - 0.04 * cfg.sensor_strength * x["thresh"])) < MARGIN
    ring = torch.nn.functional.max_pool2d(torch.tensor(near, dtype=torch.float32)[:, None],
                                          2 * RING + 1, 1, RING)[:, 0]
    return ring.numpy() > 0


def _quantisation_steps(got, ref):
    """RGB values that differ by one uint8 level (a value at a rounding tie)."""
    return np.abs(np.abs(got[..., :3] - ref[..., :3]) - 1.0 / 255.0) < ATOL


def _substitution_near_gate(A, xyzB, rA, cfg):
    """Samples whose occluded share lies within MARGIN of the gate's bounds."""
    if not cfg.occ_sub:
        return np.zeros(A.shape[0], bool)
    hi = 0.6 if cfg.occ_sub is True else float(cfg.occ_sub)
    zA, zB = np.asarray(rA["xyz_map"])[..., 2], xyzB.numpy()[..., 2]
    both = (zA > 0.001) & (zB > 0.001)
    frac = (both & (zB < zA - 0.01)).sum((1, 2)) / np.maximum(both.sum((1, 2)), 1)
    return (np.abs(frac - 0.02) < MARGIN) | (np.abs(frac - hi) < MARGIN)


def _check_B(got_B, ref_B, d, cfg, near_gate):
    """B within ATOL outside the margin rule's pixels; returns the samples
    with any flipped pixel."""
    off = np.abs(got_B - ref_B) > ATOL
    off[..., :3] &= ~_quantisation_steps(got_B, ref_B)
    off_px = off.any(-1)
    allowed = _margin_pixels(d, cfg) | near_gate[:, None, None]
    assert not (off_px & ~allowed).any(), \
        f"{int((off_px & ~allowed).sum())} pixels differ outside the margin rule"
    assert off_px.mean() < 0.01
    flipped = off_px.any((1, 2)) | (np.abs(got_B - ref_B) > ATOL).any((1, 2, 3))
    return flipped


CONFIGS = [  # (p_occlusion, p_sensor, occ_sub)
    (0.0, 0.0, False), (0.5, 0.0, True), (0.5, 1.0, 0.85), (0.0, 1.0, False)]


@pytest.mark.parametrize("kind", ["vertex_colour", "textured"])
@pytest.mark.parametrize("p_occ,p_sensor,occ_sub", CONFIGS)
def test_refiner_batch_matches_jax(meshes, kind, p_occ, p_sensor, occ_sub):
    jmesh, tmesh, diam = meshes[kind]
    cfg = J.TrainConfig(batch_size=4, input_hw=HW, p_occlusion=p_occ, p_sensor=p_sensor,
                        occ_sub=occ_sub)
    tcfg = T.TrainConfig(**cfg._asdict())
    key = jax.random.PRNGKey(int(p_occ * 10 + p_sensor * 100) + (kind == "textured"))
    ref = [np.asarray(x) for x in J.make_refiner_batch(key, jmesh, jnp.asarray(K_IMG), diam, cfg)]
    d = draws_of.refiner_draws(key, cfg)
    draws = draws_of.to_torch(d)

    # the body on JAX's own poses and renders
    gt, pert, tf, rA, rB = _jax_refiner_parts(key, jmesh, diam, cfg)
    tA = {k: _t(v) for k, v in rA.items()}
    A, B, xyzB = T.compose_pair(draws, tA, {k: _t(v) for k, v in rB.items()}, _t(pert),
                                _t(gt), _t(tf), _t(K_IMG), tcfg)
    if tcfg.occ_sub:
        B = torch.where(occlusion_mask(tA["xyz_map"][..., 2], xyzB[..., 2], tcfg.occ_sub, 0.001),
                        A, B)
    np.testing.assert_allclose(A.numpy(), ref[0], rtol=0, atol=ATOL)
    _check_B(B.numpy(), ref[1], d, cfg, _substitution_near_gate(A, xyzB, rA, cfg))

    # the whole slice: the port's poses, crop windows and renders
    got = [x.numpy() for x in T.make_refiner_batch(draws, tmesh, _t(K_IMG), diam, tcfg)]
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-6)  # target_dt
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-6)  # target_dw
    for g, r in zip(got[:2], ref[:2]):
        tol = np.array([1e-3] * 3 + [5e-4] * 3)
        assert (np.abs(g - r) > tol).mean() <= 0.005


SCORER_CASES = [  # (p_occlusion, p_sensor, kind, L); the ids of the L=2 cases name no L
    pytest.param(p_occ, p_sensor, kind, 2, id=f"{p_occ}-{p_sensor}-{kind}")
    for kind in ("vertex_colour", "textured") for p_occ, p_sensor in ((0.0, 0.0), (0.5, 1.0))
] + [
    # L=12, as the trainer and chip_smoke.py run the scorer, with clutter and
    # the sensor model on.  One case: the ladder does not depend on the
    # mesh's kind, and each new batch shape costs the JAX side ~20 s of CPU
    # compiles
    pytest.param(0.5, 1.0, "vertex_colour", 12, id="0.5-1.0-vertex_colour-L12")]


@pytest.mark.parametrize("p_occ,p_sensor,kind,n_hyp", SCORER_CASES)
def test_scorer_batch_matches_jax(meshes, kind, p_occ, p_sensor, n_hyp):
    jmesh, tmesh, diam = meshes[kind]
    cfg = J.TrainConfig(batch_size=4, input_hw=HW, p_occlusion=p_occ, p_sensor=p_sensor,
                        n_hypotheses=n_hyp)
    tcfg = T.TrainConfig(**cfg._asdict())
    key = jax.random.PRNGKey(40 + int(p_sensor) + 2 * (kind == "textured"))
    ref = [np.asarray(x) for x in J.make_scorer_batch(key, jmesh, jnp.asarray(K_IMG), diam, cfg,
                                                       n_scenes=N_SCENES)]
    d = draws_of.scorer_draws(key, cfg, N_SCENES)
    draws = draws_of.to_torch(d)

    # the hypothesis ladder from the draws
    gt, hyp, tf, rA, rB = _jax_scorer_parts(key, jmesh, diam, cfg)
    t_gt, t_hyp = T.scorer_hypotheses(draws, diam, cfg.n_hypotheses)
    np.testing.assert_allclose(t_gt.numpy(), np.asarray(gt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_hyp.numpy(), np.asarray(hyp), rtol=0, atol=1e-6)

    # the body, targets and teacher on JAX's own poses and renders
    tA = {k: _t(v) for k, v in rA.items()}
    A, B, xyzB = T.compose_pair(draws, tA, {k: _t(v) for k, v in rB.items()}, _t(hyp), _t(gt),
                                _t(tf), _t(K_IMG), tcfg)
    target, teacher = T.scorer_targets(A, B, tA, xyzB, _t(hyp), _t(gt), tmesh.pos, diam,
                                       cfg.n_hypotheses)
    np.testing.assert_allclose(A.numpy(), ref[0], rtol=0, atol=ATOL)
    flipped = _check_B(B.numpy(), ref[1], d, cfg, np.zeros(len(A), bool))
    np.testing.assert_allclose(target.numpy(), ref[2], rtol=0, atol=ATOL)
    keep = ~flipped.reshape(N_SCENES, -1)
    np.testing.assert_allclose(teacher.numpy()[keep], ref[3][keep], rtol=0, atol=ATOL)

    # the whole slice
    got = [x.numpy() for x in T.make_scorer_batch(draws, tmesh, _t(K_IMG), diam, tcfg)]
    for g, r in zip(got[:2], ref[:2]):
        tol = np.array([1e-3] * 3 + [5e-4] * 3)
        assert (np.abs(g - r) > tol).mean() <= 0.005
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=0.02)


def test_rebuilt_draws_reproduce_jax_pieces(meshes):
    """Each JAX piece that draws from a key, against the port's piece fed
    the rebuilt draws: poses, perturbation, background, both clutter
    ellipses and the sensor selection."""
    cfg = J.TrainConfig(batch_size=4, input_hw=HW, p_occlusion=0.7, p_sensor=0.5)
    key = jax.random.PRNGKey(77)
    d = draws_of.refiner_draws(key, cfg)
    td = draws_of.to_torch(d)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    gt = J._random_poses(k1, 4, cfg.z_range)
    np.testing.assert_allclose(T._random_poses(td["poses"]).numpy(), np.asarray(gt), atol=1e-6)
    pert, dt, dw = J._perturb(k2, gt, cfg.trans_normalizer * 0.9, cfg.rot_normalizer * 1.2)
    t_pert, t_dt, t_dw = T._perturb(td["perturb"], _t(gt))
    np.testing.assert_allclose(t_pert.numpy(), np.asarray(pert), atol=1e-6)
    np.testing.assert_array_equal(t_dw.numpy(), np.asarray(dw))
    tf = j_crop(pert, jnp.asarray(K_IMG), 1.2, (HW[1], HW[0]), 0.1)
    rgb, xyz = J._crop_background(k3, tf, jnp.asarray(K_IMG), gt[:, 2, 3], HW)
    t_rgb, t_xyz = T._crop_background(td["background"], _t(tf), _t(K_IMG), _t(gt[:, 2, 3]), HW)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(rgb), atol=MARGIN)
    np.testing.assert_allclose(t_xyz.numpy(), np.asarray(xyz), atol=MARGIN)
    q = jax.random.split(jax.random.fold_in(k4, 1))
    near = _margin_pixels({"noise": d["noise"], "occluders": d["occluders"]}, cfg)
    for kk, z_off, o in zip(q, T.OCCLUDER_Z_OFF, td["occluders"]):
        occ, rgb_o, xyz_o = J._crop_occluder(kk, tf, jnp.asarray(K_IMG), gt[:, 2, 3], HW,
                                             cfg.p_occlusion, z_off)
        t_occ, t_rgb_o, t_xyz_o = T._crop_occluder(o, _t(tf), _t(K_IMG), _t(gt[:, 2, 3]), HW,
                                                   cfg.p_occlusion)
        flip = t_occ.numpy()[..., 0] != np.asarray(occ)[..., 0]
        assert not (flip & ~near).any()
        assert np.asarray(occ).any()
        np.testing.assert_allclose(t_rgb_o.numpy(), np.asarray(rgb_o), atol=MARGIN)
        np.testing.assert_allclose(t_xyz_o.numpy(), np.asarray(xyz_o), atol=MARGIN)
    sel = np.asarray(jax.random.bernoulli(jax.random.split(jax.random.fold_in(k4, 2), 3)[0],
                                          cfg.p_sensor, (4, 1, 1, 1)))
    np.testing.assert_array_equal(td["sensor"]["select"].numpy() < cfg.p_sensor, sel)
