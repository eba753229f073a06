"""The port's run loop (`sixdof_tpu_torch/app/run.py`) on the CPU at a tiny
size: synth_box at shorter_side 120, 3 frames, a capture on frame 2, 8
hypotheses, seeded networks at 32x32.  It writes a pose per frame, consumes
its captures and accumulates the defect clouds; the pipelined (async) and
the synchronous loop give the same poses, and the same capture from the
same seed."""
import argparse
import os

import numpy as np
import pytest
import torch

from sixdof_tpu.app import run as jrun
from sixdof_tpu.io.mesh_io import load_mesh as jload_mesh
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu_torch.app import run as trun
from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.kernels import raytrace as k2
from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
N_FRAMES = 3


@pytest.fixture
def small_icp(monkeypatch):
    """Every DataReader reads the scene's ICP parameters with the work cut to
    a tiny size: 1000 target points, an 8 mm first-frame downsample, 4
    restarts of 5 iterations."""
    update_config = DataReader.update_config

    def small(self, args):
        p = update_config(self, args)
        p["preprocess_target"]["max_pcd"] = 1000
        p["preprocess_source"]["down_sample"] = 8.0
        p["run_icp"].update(n_restarts=4, max_iter=5)
        return p

    monkeypatch.setattr(DataReader, "update_config", small)


def _run(tmp_path, debug):
    args = trun.build_parser().parse_args([
        "--test_scene_dir", SCENE, "--no_server", "--shorter_side", "120",
        "--max_frames", str(N_FRAMES), "--capture_every", "2", "--max_hypotheses", "8",
        "--prune_to", "4", "--est_refine_iter", "1", "--track_refine_iter", "1",
        "--debug", str(debug), "--debug_dir", str(tmp_path / f"debug{debug}"),
        "--device", "cpu", "--precompile", "0"])
    refiner = PoseRefinePredictor("cpu", cfg={"input_resize": (32, 32)}, seed=0)
    scorer = ScorePredictor("cpu", cfg={"input_resize": (32, 32)}, seed=1)
    state = trun.LoopState()
    frame_times = trun.main(args, refiner=refiner, scorer=scorer, state=state)
    poses = [np.loadtxt(tmp_path / f"debug{debug}" / "ob_in_cam" / f"{i:04d}.txt")
             for i in range(N_FRAMES)]
    return frame_times, poses, state


def test_run_loop_async_and_sync(tmp_path, small_icp, monkeypatch):
    calls = {"async": [], "sync": []}

    def recorded(fn, key):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[key].append((args, kwargs, out))
            return out
        return call

    monkeypatch.setattr(trun, "capture_event_async",
                        recorded(trun.capture_event_async, "async"))
    monkeypatch.setattr(trun, "capture_event", recorded(trun.capture_event, "sync"))
    before = k2.ray_mesh_intersect.launches
    ft_a, poses_a, st_a = _run(tmp_path, 0)  # pipelined: async capture
    ft_s, poses_s, st_s = _run(tmp_path, 1)  # every frame synced
    assert k2.ray_mesh_intersect.launches == before  # CPU tensors take the plain version
    for ft, poses, st in ((ft_a, poses_a, st_a), (ft_s, poses_s, st_s)):
        assert len(ft) == N_FRAMES and all(t > 0 for t in ft)
        for p in poses:
            assert p.shape == (4, 4) and np.isfinite(p).all()
            np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-5)
        # frame 0's ICP refinement and the capture on frame 2, both consumed
        assert [f for f, _ in st.captures] == [0, 2]
        assert len(st.intersection_pcds) == 2
        assert all(len(p) > 0 for p in st.intersection_pcds)
        assert st.target_mesh is not None and len(st.target_mesh.faces) == 1280
    for a, b in zip(poses_a, poses_s):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # The capture on frame 2.  Both loops hand it the same frame (source
    # cloud, heatmap rays, parameters) and a seed that differs by rounding
    # alone: the async loop's computed in float32 from the device pose
    # (ops/icp.py::capture_from_pose), the sync loop's on the host in
    # float64, as in the JAX app.
    [(a_args, a_kw, pending)] = calls["async"]
    [(s_args, s_kw, (rs, pcd_s))] = calls["sync"]
    src_a, pose_dev, tf_center, params_a, rays_a, mask_a, intens_a = a_args
    src_s, _, seed_s, params_s, _, rays_s, mask_s, intens_s, c2d = s_args
    np.testing.assert_array_equal(src_a.points, src_s.points)
    np.testing.assert_array_equal(rays_a, rays_s)
    np.testing.assert_array_equal(mask_a, mask_s)
    np.testing.assert_array_equal(intens_a, intens_s)
    assert params_a == params_s
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    scale = torch.ones(4, 4)
    scale[:3, 3] = 1000.0  # metres -> mm
    seed_a = (f32(c2d) @ ((f32(pose_dev).reshape(4, 4) @ f32(tf_center)) * scale)).double().numpy()
    np.testing.assert_allclose(seed_a[:3, :3], seed_s[:3, :3], atol=1e-6)
    np.testing.assert_allclose(seed_a[:3, 3], seed_s[:3, 3], atol=1e-3)  # mm
    ra, pcd_a = pending.result()
    assert st_a.captures[1][1] is ra and st_s.captures[1][1] is rs
    assert len(st_a.intersection_pcds[1]) == len(pcd_a.points)
    assert len(st_s.intersection_pcds[1]) == len(pcd_s.points)
    # The restart ICP is chaotic at that rounding (tests/test_icp_pipeline.py
    # says so of the JAX package's two paths), so the two loops' outcomes are
    # compared at one seed: the sync loop's capture, seeded with the async
    # loop's float32 seed, gives the async loop's result.  What remains is
    # the float32 restart seeds' own rounding (a ~500 mm translation).
    rx, pcd_x = trun.capture_event(src_s, s_args[1], seed_a, *s_args[3:], **s_kw)
    assert rx.fitness == ra.fitness
    np.testing.assert_allclose(rx.inlier_rmse, ra.inlier_rmse, rtol=1e-5)
    np.testing.assert_allclose(rx.transformation[:3, :3], ra.transformation[:3, :3], atol=1e-5)
    np.testing.assert_allclose(rx.transformation[:3, 3], ra.transformation[:3, 3], atol=2e-3)
    np.testing.assert_allclose(pcd_x.points, pcd_a.points, atol=2e-3)  # mm
    np.testing.assert_array_equal(pcd_x.colors, pcd_a.colors)


def _rigid(rng, trans_scale):
    """A seeded rigid transform: rotation about a random axis by up to 0.3
    rad, translation up to @trans_scale."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-0.3, 0.3)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    tf = np.eye(4)
    tf[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    tf[:3, 3] = rng.uniform(-trans_scale, trans_scale, 3)
    return tf


class _Pending:
    """A tracked pose in flight, as both packages' PendingPose present it."""

    def __init__(self, pose):
        self._dev = pose

    def numpy(self):
        return self._dev.copy()

    def device_pose(self):
        return self._dev.copy()


def _stub_loop(monkeypatch, mod, mio, registration_result, scripted, calls):
    """Replace everything below the run loop of @mod with @scripted results,
    so that only the loop's own bookkeeping runs: the estimator gives the
    scripted poses, ICP refinement, ray tracing and the captures give the
    scripted transforms and defect clouds (in @mio's PointCloud).  What the
    loop passes down is recorded in @calls."""
    poses, refine_tf, capture_tfs, clouds = scripted
    tf_center = np.eye(4)
    tf_center[:3, 3] = [0.01, -0.02, 0.005]

    class Est:
        rot_grid = np.zeros(1)

        def __init__(self, **_):
            self.frame = 0

        def register(self, **_):
            return poses[0].copy()

        def track_one(self, sync=True, **_):
            self.frame += 1
            return poses[self.frame].copy() if sync else _Pending(poses[self.frame])

        def get_tf_to_centered_mesh(self):
            return tf_center

        def precompile_async(self, *_, **__):
            pass

    class Capture:
        def __init__(self, n):
            self.n = n

        def result(self):
            return (registration_result(capture_tfs[self.n].copy(), 0.9, 1.0),
                    mio.PointCloud(clouds[self.n + 1].copy()))

    def refine(source, target, background, init, params, device=None):
        calls.append(("refine", init.copy()))
        return None, registration_result(refine_tf.copy(), 0.95, 1.0), 0.0, target

    def ray_tracing(base_dir, mesh, heatmap, pinhole, **_):
        calls.append(("ray_tracing", np.asarray(mesh.vertices).copy()))
        return mio.PointCloud(clouds[0].copy()), None

    def capture_sync(source, target, init, *_, **__):
        calls.append(("capture", np.asarray(init, dtype=np.float64).copy()))
        return Capture(sum(c[0] == "capture" for c in calls) - 1).result()

    def capture_async(source, pose_dev, tf_to_centered, *_, **__):
        calls.append(("capture", np.asarray(pose_dev) @ tf_to_centered))
        return Capture(sum(c[0] == "capture" for c in calls) - 1)

    for name, value in dict(
            FoundationPose=Est, refine_pose_with_icp=refine, ray_tracing=ray_tracing,
            capture_event=capture_sync, capture_event_async=capture_async,
            CaptureContext=lambda *_, **__: None,
            preprocess_source=lambda *_, **__: (None, None, 0)).items():
        monkeypatch.setattr(mod, name, value)


@pytest.mark.parametrize("debug", [0, 1])  # 0: async captures, 1: every frame synced
def test_run_loop_bookkeeping_matches_jax(tmp_path, monkeypatch, debug):
    """The loop's own bookkeeping (pose conversion to ICP millimetres, the
    re-posing of the accumulated defect clouds by inv(current) @ previous,
    the colour->depth move of each new cloud, the posed mesh, the pose
    files) against the JAX app's `main`, with everything below the loop
    scripted alike for both: the clouds, the posed mesh and what the loop
    passes down are bit-equal."""
    from sixdof_tpu.app import icp_pipeline as jip
    from sixdof_tpu.io import mesh_io as jmio
    from sixdof_tpu_torch.app import icp_pipeline as tip
    from sixdof_tpu_torch.io import mesh_io as tmio

    n_frames = 6  # all of the scene; a capture on every later frame, async ones
    # drain 4 frames late (frame 1's on frame 5, the others at the end)
    rng = np.random.RandomState(0)
    scripted = ([_rigid(rng, 0.3) for _ in range(n_frames)], _rigid(rng, 300.0),
                [_rigid(rng, 300.0) for _ in range(n_frames - 1)],
                [rng.uniform(-50, 50, (30 + 7 * k, 3)) for k in range(n_frames)])
    argv = ["--test_scene_dir", SCENE, "--no_server", "--shorter_side", "120",
            "--max_frames", str(n_frames), "--capture_every", "1", "--track_pipeline", "3",
            "--debug", str(debug)]
    # synth_box's colour and depth cameras coincide; a scripted extrinsic
    # makes the colour->depth moves show
    color_to_depth = _rigid(rng, 30.0)

    def get_extrinsics(reader):
        reader.color_to_depth = color_to_depth.copy()
        reader.depth_to_color = np.linalg.inv(color_to_depth)
        reader.inverse_color_to_depth = reader.depth_to_color.copy()
        reader.inverse_depth_to_color = color_to_depth.copy()

    monkeypatch.setattr(JReader, "get_extrinsics", get_extrinsics)
    monkeypatch.setattr(DataReader, "get_extrinsics", get_extrinsics)

    # the JAX app, with its viewer hooks recording what they would show
    j_calls, j_shown = [], []
    _stub_loop(monkeypatch, jrun, jmio, jip.RegistrationResult, scripted, j_calls)
    monkeypatch.setattr(jrun, "ScorePredictor", lambda **_: None)
    monkeypatch.setattr(jrun, "PoseRefinePredictor", lambda **_: None)
    monkeypatch.setattr(jrun, "ASSETS_DIR", str(tmp_path / "assets"))
    monkeypatch.setattr(jrun, "save_overlay", lambda *_, **__: None)
    monkeypatch.setattr(jrun, "create_heatmap_overlay", lambda *_, **__: None)
    monkeypatch.setattr(jrun, "update_dash_data", lambda pcds, mesh: j_shown.append(
        ([p.points.copy() for p in pcds], np.asarray(mesh.vertices).copy())))
    if debug >= 1:  # the JAX app draws the pose box on every frame then
        monkeypatch.setattr(jrun, "draw_posed_3d_box", lambda *_, img, **__: img)
        monkeypatch.setattr(jrun, "draw_xyz_axis", lambda img, **_: img)
    jrun.main(jrun.build_parser().parse_args(
        argv + ["--demo", "--precompile", "0", "--debug_dir", str(tmp_path / "jax")]))

    # the port, its LoopState recording the same
    t_calls, t_shown = [], []
    _stub_loop(monkeypatch, trun, tmio, tip.RegistrationResult, scripted, t_calls)

    class State(trun.LoopState):
        def update(self, pcds, mesh):
            super().update(pcds, mesh)
            t_shown.append(([p.points.copy() for p in pcds], np.asarray(mesh.vertices).copy()))

    trun.main(trun.build_parser().parse_args(
        argv + ["--debug_dir", str(tmp_path / "port"), "--device", "cpu"]),
        refiner=object(), scorer=object(), state=State())

    assert [c[0] for c in t_calls] == [c[0] for c in j_calls] == \
        ["refine", "ray_tracing"] + ["capture"] * (n_frames - 1)
    for (_, a), (_, b) in zip(t_calls, j_calls):
        np.testing.assert_array_equal(a, b)
    assert len(t_shown) == len(j_shown) == n_frames
    for (t_pcds, t_mesh), (j_pcds, j_mesh) in zip(t_shown, j_shown):
        assert len(t_pcds) == len(j_pcds)
        for a, b in zip(t_pcds, j_pcds):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_mesh, j_mesh)
    for i in range(n_frames):
        name = f"ob_in_cam/{i:04d}.txt"
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "port" / name),
                                      np.loadtxt(tmp_path / "jax" / name))


def test_oriented_bounds_matches_jax():
    path = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
    for a, b in zip(trun.oriented_bounds(load_mesh(path)),
                    jrun.oriented_bounds(jload_mesh(path))):
        np.testing.assert_array_equal(a, b)


def test_parser_defaults_match_jax():
    t = vars(trun.build_parser().parse_args([]))
    j = vars(jrun.build_parser().parse_args([]))
    shared = set(t) & set(j)
    assert {"est_refine_iter", "track_refine_iter", "debug", "shorter_side", "max_frames",
            "capture_every", "prune_to", "track_pipeline", "no_server"} <= shared
    for k in shared - {"test_scene_dir", "debug_dir"}:
        assert t[k] == j[k], k
    assert t["test_scene_dir"].endswith("demo_data/synth_box")


def test_entry_points_take_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(args)
