"""The start-up path: `FoundationPose.precompile_async` (the engine's warm-up
thread), its joins, the kernel libraries' build query and the app's
`--precompile`, on the CPU at a small size (synth_box at 120 px, 8
hypotheses, 32x32 crops, 16x16 coarse renders, the scene's ICP cut to 1000
target points and 4 restarts of 5 iterations, the depth polish against
2048 of its 16384 target points).

A run after the warm-up joined must be bit-equal to one without it
(tolerance 0): the warm-up keeps no result, touches no state of the engine,
draws from no seeded generator and counts its kernel launches apart.  The
JAX engine's `precompile_async` is held to by its signature."""
import inspect
import os
import threading

import numpy as np
import pytest
import torch

from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu_torch import estimater
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.app import run as trun
from sixdof_tpu_torch.app.defect_projection import compute_rays, heatmap_to_points
from sixdof_tpu_torch.estimater import FoundationPose as TFP
from sixdof_tpu_torch.io import png
from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.kernels import build, raster, raytrace
from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
SMALL = dict(input_resize=(32, 32), coarse_hw=(16, 16), n_hypotheses=8, polish_points=2048)


def _small_icp(params):
    params["preprocess_target"]["max_pcd"] = 1000
    params["preprocess_source"]["down_sample"] = 6.0
    params["run_icp"].update(n_restarts=4, max_iter=5)
    return params


def _engine(mesh):
    cfg = {"input_resize": SMALL["input_resize"]}
    est = TFP(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
              device="cpu", refiner=PoseRefinePredictor("cpu", cfg=cfg, seed=0),
              scorer=ScorePredictor("cpu", cfg=cfg, seed=1), prune_to=4,
              coarse_hw=SMALL["coarse_hw"])
    n = SMALL["n_hypotheses"]
    est.rot_grid = est.rot_grid[:: len(est.rot_grid) // n][:n]
    m = SMALL["polish_points"]
    est._polish_tgt, est._polish_tn, est._polish_tmask = (
        est._polish_tgt[:m], est._polish_tn[:m], est._polish_tmask[:m])
    return est


def _generators():
    """Every generator the main path could draw from, as comparable values."""
    state = np.random.get_state()
    return (state[0], state[1].tobytes(), state[2:], torch.get_rng_state().numpy().tobytes())


def _engine_state(est):
    return dict(pose_last=est.pose_last, crop=est._crop_pose_host, hist=len(est._pose_hist),
                poses=getattr(est, "poses", None), scores=getattr(est, "scores", None),
                crop_size=est._crop_size, center=est._last_center_px)


def _frames_run(reader, mesh, warm):
    """Frame 0 registered and refined by ICP, frames 1-2 tracked, frame 2's
    capture seeded from the device pose; with @warm the warm-up first,
    joined before frame 0.  Returns (results, what the warm-up left)."""
    est = _engine(mesh)
    params = _small_icp(reader.update_config(None))
    K = reader.color_K
    left = {}
    if warm:
        before = (_generators(), _engine_state(est), raster.rasterize_zbuffer.launches,
                  raytrace.ray_mesh_intersect.launches)
        thread = est.precompile_async(K, (reader.color_H, reader.color_W), iteration=2,
                                      track_iteration=1, icp_parameters=params)
        assert isinstance(thread, threading.Thread)
        estimater.join_precompile()
        assert not thread.is_alive()
        after = (_generators(), _engine_state(est), raster.rasterize_zbuffer.launches,
                 raytrace.ray_mesh_intersect.launches)
        left = dict(before=before, after=after, record=est.precompile_record)
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    out = {"register": est.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=2)}
    init = reader.color_to_depth @ reader.scale_translation_to_millimeters(out["register"])
    _, icp, _, target = tip.refine_pose_with_icp(reader.get_source(0), reader.target,
                                                 reader.background, init, params, device="cpu")
    out["icp"] = icp.transformation
    for i in (1, 2):
        pending = est.track_one(rgb=reader.get_color(i), depth=reader.get_depth(i), K=K,
                                iteration=1, sync=i == 1)
        out[f"track_{i}"] = pending if i == 1 else pending.numpy()
    ctx = tip.CaptureContext(target, reader.target_mesh, reader.color_to_depth, device="cpu")
    source, _, _ = tip.preprocess_source(reader.get_source(2), reader.background, params, i=2)
    heatmap = reader.get_heatmap(reader.get_color(2))[0]
    rays, intensities = compute_rays(heatmap_to_points(heatmap, 0.75), reader.color_pinhole)
    result, cloud = tip.capture_event_async(
        source, pending.device_pose(), est.get_tf_to_centered_mesh(), params, rays,
        np.ones(len(rays), dtype=bool), intensities, ctx=ctx).result()
    out.update(capture=result.transformation, capture_fitness=result.fitness,
               cloud=cloud.points)
    return out, left


@pytest.fixture(scope="module")
def runs_with_and_without():
    reader = DataReader(SCENE, shorter_side=120)
    mesh = load_mesh(os.path.join(SCENE, "mesh", "model_scaled_down.obj"))
    return _frames_run(reader, mesh, warm=False), _frames_run(reader, mesh, warm=True)


def test_warm_up_leaves_the_results_bit_equal(runs_with_and_without):
    (cold, _), (warm, left) = runs_with_and_without
    assert set(cold) == set(warm)
    for key in cold:
        np.testing.assert_array_equal(warm[key], cold[key], err_msg=key)
    assert len(cold["cloud"]) > 0 and cold["capture_fitness"] > 0
    # every part ran: the PNG routine built (K1 and K2 are the card's), the
    # cascade, the depth polish, a track step, the capture program
    assert list(left["record"]["seconds"]) == ["build", "register", "depth_polish", "track",
                                               "capture"]
    assert set(left["record"]["built_before"]) == {"png_unfilter"}
    assert left["record"]["launches"] == {}  # the CPU takes the plain versions
    assert left["record"]["started"] <= left["record"]["finished"] <= left["record"]["joined"]


@pytest.mark.parametrize("what", ["generators", "engine", "k1_launches", "k2_launches"])
def test_warm_up_moves_no_state(runs_with_and_without, what):
    """np.random's and torch's default generators, the engine's pose and
    crop state, and the wrappers' launch counts, before and after the
    warm-up."""
    _, (_, left) = runs_with_and_without
    i = ["generators", "engine", "k1_launches", "k2_launches"].index(what)
    before, after = left["before"][i], left["after"][i]
    if what == "engine":
        assert after == before == dict(pose_last=None, crop=None, hist=0, poses=None,
                                       scores=None, crop_size=None, center=None)
    else:
        assert after == before


def test_warm_up_launches_count_apart():
    """A thread inside launches_apart counts into its own dict; the
    wrapper's count, and other threads, are untouched."""
    def wrapper():
        pass

    wrapper.launches = 0
    build.count_launch(wrapper)
    counts = {}

    def apart():
        with build.launches_apart(counts):
            build.count_launch(wrapper)
            build.count_launch(wrapper)

    thread = threading.Thread(target=apart)
    thread.start()
    thread.join()
    build.count_launch(wrapper)
    assert wrapper.launches == 2 and counts == {"wrapper": 2}


@pytest.fixture(scope="module")
def engine():
    return _engine(load_mesh(os.path.join(SCENE, "mesh", "model_scaled_down.obj")))


ENTRIES = {
    "register": lambda est: est.register(K=None, rgb=None, depth=None, ob_mask=None),
    "track_one": lambda est: est.track_one(rgb=None, depth=None, K=None, iteration=1),
    "refine_pose_with_icp": lambda est: tip.refine_pose_with_icp(None, None, None, None, None),
    "capture_event": lambda est: tip.capture_event(*[None] * 9, ctx=None),
    "capture_event_async": lambda est: tip.capture_event_async(*[None] * 7, ctx=None),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_warm_up_error_is_raised_at_the_first_join(engine, entry, monkeypatch):
    """A warm-up that fails (here its kernel build) fails the first entry
    that joins it, with its own error; the next join is clean."""
    def failing(libraries):
        raise RuntimeError("nvcc failed on ray_mesh.cu")

    monkeypatch.setattr(estimater, "build_all", failing)
    monkeypatch.setattr(engine, "pose_last", np.eye(4))  # track_one's precondition
    thread = engine.precompile_async(np.eye(3), (120, 160))
    thread.join()
    with pytest.raises(RuntimeError, match="nvcc failed on ray_mesh.cu"):
        ENTRIES[entry](engine)
    estimater.join_precompile()
    engine._join_precompile()
    assert engine.precompile_record["seconds"] == {}


def test_device_mesh_takes_no_warm_up(engine, monkeypatch):
    monkeypatch.setattr(engine, "device_mesh", object())
    assert engine.precompile_async(np.eye(3), (120, 160)) is None
    assert engine._warmup is None


def test_precompile_async_takes_the_jax_arguments():
    """JAX's four arguments, their names and defaults, then the port's one
    keyword (the scene's ICP parameters, off by default)."""
    jax_sig = inspect.signature(JFP.precompile_async).parameters
    port_sig = inspect.signature(TFP.precompile_async).parameters
    assert list(port_sig)[: len(jax_sig)] == list(jax_sig)
    for name, p in jax_sig.items():
        assert port_sig[name].default == p.default, name
    assert list(port_sig)[len(jax_sig):] == ["icp_parameters"]
    assert port_sig["icp_parameters"].default is None


def test_library_built_query(monkeypatch, tmp_path):
    """`built()` is False in an empty build directory, True once `load()`
    built the library there (the PNG routine, with the C compiler here)."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    lib = build.KernelLibrary("png_unfilter", png.LIBRARY._bind, ext=".c")
    assert not lib.built() and lib.path().startswith(str(tmp_path))
    assert build.build_all([lib]) > 0 and lib.lib is not None
    assert lib.built() and os.path.exists(lib.info["library"])


def test_app_starts_the_warm_up_after_the_reader(tmp_path, monkeypatch):
    """`--precompile 1` (the default) starts the warm-up with the reader's
    intrinsics, frame size and ICP parameters once the reader exists; the
    loop's poses, ICP results and defect clouds equal a `--precompile 0`
    run's bit for bit."""
    calls = []
    start = TFP.precompile_async

    def recorded(self, K, image_hw, iteration=5, track_iteration=2, icp_parameters=None):
        calls.append((np.asarray(K).copy(), tuple(image_hw), iteration, track_iteration,
                      icp_parameters))
        return start(self, K, image_hw, iteration, track_iteration, icp_parameters)

    monkeypatch.setattr(TFP, "precompile_async", recorded)
    update_config = DataReader.update_config
    monkeypatch.setattr(DataReader, "update_config",
                        lambda self, args: _small_icp(update_config(self, args)))
    runs = {}
    for flag in ("0", "1"):
        out = tmp_path / f"precompile{flag}"
        state = trun.LoopState()
        trun.main(trun.build_parser().parse_args([
            "--test_scene_dir", SCENE, "--no_server", "--shorter_side", "120", "--max_frames",
            "3", "--capture_every", "2", "--max_hypotheses", "8", "--prune_to", "4",
            "--est_refine_iter", "1", "--track_refine_iter", "1", "--depth_polish", "0",
            "--track_polish", "0", "--debug_dir", str(out), "--device", "cpu",
            "--precompile", flag]),
            refiner=PoseRefinePredictor("cpu", cfg={"input_resize": (32, 32)}, seed=0),
            scorer=ScorePredictor("cpu", cfg={"input_resize": (32, 32)}, seed=1), state=state)
        labels = [label for label, _ in state.marks]
        runs[flag] = dict(
            poses=[np.loadtxt(out / "ob_in_cam" / f"{i:04d}.txt") for i in range(3)],
            tfs=[r.transformation for _, r in state.captures],
            clouds=[p.points for p in state.intersection_pcds], labels=labels)
    assert len(calls) == 1
    K, hw, iteration, track_iteration, params = calls[0]
    assert hw == (120, 160) and (iteration, track_iteration) == (1, 1)
    assert params["run_icp"]["n_restarts"] == 4
    assert runs["1"]["labels"].index("reader") < runs["1"]["labels"].index("precompile started")
    assert "precompile started" not in runs["0"]["labels"]
    for key in ("poses", "tfs", "clouds"):
        assert len(runs["0"][key]) == len(runs["1"][key]) > 0
        for a, b in zip(runs["0"][key], runs["1"][key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
