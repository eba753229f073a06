"""The capture path of the port against the JAX package on synth_box:
batched restart ICP, the fused capture program (restart ICP + best pick +
defect ray trace) seeded from the host or from the device pose,
`refine_pose_with_icp`, and async against sync captures.  Same numpy
inputs on both sides: the processed clouds of frames 0 and 2, seeds from
the annotated poses, the scene's icp_parameters.json (8 restarts, 12
iterations, 5 mm).

Tolerances: the best restart index equal; transforms within 0.3 deg and
2 mm (ICP re-gates its inliers every iteration, so float32 sums taken in
another order move long runs apart: ROADMAP.md, "ICP sensitivity");
fitness within 0.01; defect hit distances to rtol 1e-5 where the best
transforms agree to 1e-5."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu.ops import icp as jicp
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.app.defect_projection import compute_rays, heatmap_to_points
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.ops.lie import euler_matrix
from sixdof_tpu_torch.ops import icp as ticp

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
ROT_DEG, TRANS_MM = 0.3, 2.0
FIT_ATOL = 0.01
ADDS_MM = 3.0
T_RTOL = 1e-5
CPU = torch.device("cpu")


def _rot_deg(a, b):
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(min(1.0, chord)))


def _assert_tf_close(a, b):
    assert _rot_deg(a, b) < ROT_DEG
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < TRANS_MM


@pytest.fixture(scope="module")
def scene():
    """Processed clouds and capture inputs: frame 0's source (the first
    frame's preprocessing), frame 2's (capture-time preprocessing)."""
    r = DataReader(SCENE)
    p = r.parameters
    tgt, _ = tip.preprocess_target(r.target.copy(), p)
    out = dict(reader=r, params=p, target=tgt)
    for f in (0, 2):
        out[f"src{f}"], _, _ = tip.preprocess_source(r.get_source(f), r.background, p, i=f)
        pose = r.get_gt_pose(f)
        out[f"pose{f}"] = pose
        out[f"init{f}"] = r.color_to_depth @ r.scale_translation_to_millimeters(pose)
    heatmap = r.get_heatmap(r.get_color(0))[0]
    rays, inten = compute_rays(heatmap_to_points(heatmap, 0.75), r.color_pinhole)
    mask = np.ones(len(rays), bool)
    mask[::11] = False  # some rays masked
    out.update(rays=rays, inten=inten, ray_mask=mask)
    return out


def _padded(scene, f):
    src, smask = tip._pad_cloud(scene[f"src{f}"].points, CPU)
    tgt, tn, tmask = tip._pad_target(scene["target"], CPU)
    t = [x.numpy() for x in (src, smask, tgt, tn, tmask)]
    return t, [jnp.asarray(x) for x in t]


def _restarts(scene, f, K=8):
    noise, thr = tip._restart_noise(5.0, K, 0)
    eval_tf = np.linalg.inv(scene[f"init{f}"]).astype(np.float32)
    tfs = (noise @ np.linalg.inv(scene[f"init{f}"])).astype(np.float32)
    return tfs, thr, eval_tf, noise


def test_restart_noise_matches_jax():
    for K, seed in ((8, 0), (5, 2)):
        nt, tt = tip._restart_noise(5.0, K, seed)
        nj, tj = jip._restart_noise(5.0, K, seed)
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(tt, tj)


def test_icp_one_iter_batch_matches_jax(scene):
    (t, j) = _padded(scene, 0)
    zs = np.arange(-10.0, 10.1, 2.5)
    tfs = np.stack([np.linalg.inv(scene["init0"] + np.pad([[0, 0, 0, z]], ((2, 1), (0, 0))))
                    for z in zs]).astype(np.float32)
    rt = ticp.icp_one_iter_batch(*map(torch.from_numpy, t), torch.from_numpy(tfs), 5.0)
    rj = jicp.icp_one_iter_batch(*j, jnp.asarray(tfs), 5.0)
    np.testing.assert_allclose(rt.fitness.numpy(), np.asarray(rj.fitness), atol=FIT_ATOL)
    np.testing.assert_allclose(rt.inlier_rmse.numpy(), np.asarray(rj.inlier_rmse), atol=0.05)
    for a, b in zip(rt.transformation.numpy(), np.asarray(rj.transformation)):
        _assert_tf_close(a, b)


def test_icp_batch_with_eval_matches_jax(scene):
    (t, j) = _padded(scene, 2)
    tfs, thr, eval_tf, _ = _restarts(scene, 2)
    rt, f0t, r0t = ticp.icp_batch_with_eval(*map(torch.from_numpy, t), torch.from_numpy(tfs),
                                            torch.from_numpy(thr), torch.from_numpy(eval_tf),
                                            5.0, max_iter=12)
    rj, f0j, r0j = jicp.icp_batch_with_eval(*j, jnp.asarray(tfs), jnp.asarray(thr),
                                            jnp.asarray(eval_tf), 5.0, max_iter=12)
    assert float(rt.fitness.min()) > 0.9
    np.testing.assert_allclose(rt.fitness.numpy(), np.asarray(rj.fitness), atol=FIT_ATOL)
    np.testing.assert_allclose(float(f0t), float(f0j), atol=1e-6)
    np.testing.assert_allclose(float(r0t), float(r0j), rtol=1e-4)
    for a, b in zip(rt.transformation.numpy(), np.asarray(rj.transformation)):
        _assert_tf_close(a, b)


def _compare_capture(out_t, out_j):
    tf_t, fit_t, rmse_t, best_t, t_t = (x.numpy() for x in out_t)
    tf_j, fit_j, rmse_j, best_j, t_j = (np.asarray(x) for x in out_j)
    assert int(best_t) == int(best_j)
    b = int(best_t)
    _assert_tf_close(tf_t[b], tf_j[b])
    np.testing.assert_allclose(fit_t, fit_j, atol=FIT_ATOL)
    assert fit_t[b] > 0.9
    hit = np.isfinite(t_j)
    assert hit.sum() > 100
    if np.abs(tf_t[b] - tf_j[b]).max() <= 1e-5 * np.abs(tf_j[b]).max():
        assert (np.isfinite(t_t) == hit).all()
        np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=T_RTOL)
    else:  # the best poses differ by ICP sensitivity: the hits still agree closely
        both = hit & np.isfinite(t_t)
        assert both.sum() >= 0.98 * hit.sum()
        np.testing.assert_allclose(t_t[both], t_j[both], rtol=2e-3)


def _mesh_tri(scene):
    from sixdof_tpu_torch.ops.raytrace import mesh_to_tri_verts

    m = scene["reader"].target_mesh
    return mesh_to_tri_verts(m.vertices, m.faces)


def test_improve_and_raytrace_matches_jax(scene):
    (t, j) = _padded(scene, 2)
    tfs, thr, eval_tf, _ = _restarts(scene, 2)
    tri, tri_mask = _mesh_tri(scene)
    d2c = np.linalg.inv(scene["reader"].color_to_depth).astype(np.float32)
    rays = scene["rays"].astype(np.float32)
    args = (tfs, thr, eval_tf, np.float32(5.0), tri, tri_mask, rays, scene["ray_mask"], d2c)
    out_t = ticp.improve_and_raytrace(*map(torch.from_numpy, t),
                                      *(torch.as_tensor(a) for a in args[:3]), 5.0,
                                      *(torch.from_numpy(a) for a in args[4:]), max_iter=12)
    out_j = jicp.improve_and_raytrace(*j, *(jnp.asarray(a) for a in args[:3]), 5.0,
                                      *(jnp.asarray(a) for a in args[4:]), max_iter=12)
    _compare_capture(out_t, out_j)
    assert np.isinf(out_t[4].numpy()[~scene["ray_mask"]]).all()


def test_capture_from_pose_matches_jax(scene):
    """The device-seeded form: the centred-mesh pose in metres with a
    non-identity centring compose."""
    (t, j) = _padded(scene, 2)
    _, thr, _, noise = _restarts(scene, 2)
    center = np.eye(4)
    center[:3, 3] = [-0.004, 0.002, -0.011]
    pose_c = scene["pose2"] @ np.linalg.inv(center)  # pose of the centred mesh
    tri, tri_mask = _mesh_tri(scene)
    c2d = scene["reader"].color_to_depth
    consts = [a.astype(np.float32) for a in (pose_c, center, c2d, noise)] + [thr]
    tail = [tri, tri_mask, scene["rays"].astype(np.float32), scene["ray_mask"],
            np.linalg.inv(c2d).astype(np.float32)]
    out_t = ticp.capture_from_pose(*map(torch.from_numpy, t), *map(torch.from_numpy, consts),
                                   5.0, *map(torch.from_numpy, tail), max_iter=12)
    out_j = jicp.capture_from_pose(*j, *map(jnp.asarray, consts), 5.0, *map(jnp.asarray, tail),
                                   max_iter=12)
    _compare_capture(out_t, out_j)


def test_refine_pose_with_icp_matches_jax(scene):
    """Frame 0 end to end from a seed 6 mm and ~1.5 deg off the annotated
    pose: the z ladder picks the same step, and the refined pose matches."""
    r = scene["reader"]
    off = euler_matrix(0.015, -0.02, 0.01)
    off[:3, 3] = [3.0, -2.0, 5.0]
    init = scene["init0"] @ off
    _, res_t, z_t, tp_t = tip.refine_pose_with_icp(r.get_source(0), r.target.copy(),
                                                   r.background, init.copy(), r.parameters,
                                                   device="cpu")
    src = r.get_source(0)
    _, res_j, z_j, tp_j = jip.refine_pose_with_icp(
        jmio.PointCloud(src.points), jmio.PointCloud(r.target.points.copy()),
        jmio.PointCloud(r.background.points), init.copy(), r.parameters)
    assert z_t == z_j
    np.testing.assert_array_equal(tp_t.points, tp_j.points)
    assert res_t.fitness > 0.9 and abs(res_t.fitness - res_j.fitness) < FIT_ATOL
    _assert_tf_close(res_t.transformation, res_j.transformation)
    # against the annotated pose: ADD-S of the model cloud (the box is
    # nearly symmetric, so ICP slides a few degrees along it)
    from scipy.spatial import cKDTree

    pts = r.target.points[::10]
    est = pts @ np.linalg.inv(res_t.transformation)[:3, :3].T \
        + np.linalg.inv(res_t.transformation)[:3, 3]
    gt = pts @ scene["init0"][:3, :3].T + scene["init0"][:3, 3]
    assert cKDTree(gt).query(est)[0].mean() < ADDS_MM


def test_capture_event_async_matches_sync(scene):
    """capture_event_async (device-pose seed, deferred readback) gives the
    same result and defect points as the sync capture_event seeded with
    color_to_depth @ mm(pose): the pipelined capture changes latency, not
    results."""
    r = scene["reader"]
    ctx = tip.CaptureContext(scene["target"], r.target_mesh, r.color_to_depth, device="cpu")
    args = (scene["rays"], scene["ray_mask"], scene["inten"])
    res_s, pcd_s = tip.capture_event(scene["src2"], scene["target"], scene["init2"].copy(),
                                     scene["params"], r.target_mesh, *args, r.color_to_depth,
                                     ctx=ctx)
    pend = tip.capture_event_async(scene["src2"], torch.as_tensor(scene["pose2"]), np.eye(4),
                                   scene["params"], *args, ctx)
    res_a, pcd_a = pend.result()
    assert pend.result() is pend.result()  # cached
    assert res_s.fitness > 0.9 and abs(res_a.fitness - res_s.fitness) < FIT_ATOL
    _assert_tf_close(res_a.transformation, res_s.transformation)
    assert abs(len(pcd_a) - len(pcd_s)) <= 1 and len(pcd_s) > 100
    if len(pcd_a) == len(pcd_s):
        np.testing.assert_allclose(pcd_a.points, pcd_s.points, atol=TRANS_MM)
    # the sync capture against the JAX package's
    res_j, pcd_j = jip.capture_event(
        jmio.PointCloud(scene["src2"].points), jmio.PointCloud(scene["target"].points,
                                                               normals=scene["target"].normals),
        scene["init2"].copy(), scene["params"], jmio.TriMesh(r.target_mesh.vertices,
                                                             r.target_mesh.faces),
        *args, r.color_to_depth)
    assert abs(res_s.fitness - res_j.fitness) < FIT_ATOL
    _assert_tf_close(res_s.transformation, res_j.transformation)
    assert abs(len(pcd_s) - len(pcd_j)) <= 1


def test_capture_with_no_rays_gives_an_empty_cloud(scene):
    r = scene["reader"]
    ctx = tip.CaptureContext(scene["target"], r.target_mesh, r.color_to_depth, device="cpu")
    res, pcd = tip.capture_event(scene["src2"], scene["target"], scene["init2"].copy(),
                                 scene["params"], r.target_mesh, np.array([[0.0, 0.0, 1.0]]),
                                 np.zeros(1, bool), np.zeros(1), r.color_to_depth, ctx=ctx,
                                 n_restarts=2)
    assert len(pcd) == 0 and res.fitness > 0.9
    with pytest.raises(ValueError):
        tip.capture_event(scene["src2"], scene["src0"], scene["init2"].copy(), scene["params"],
                          r.target_mesh, np.array([[0.0, 0.0, 1.0]]), np.zeros(1, bool),
                          np.zeros(1), r.color_to_depth, ctx=ctx)
