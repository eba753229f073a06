"""The live-camera path of the port against the JAX package, on fake
`pykinect_azure` devices (tests/torch_kinect_fake.py copies the JAX tests'
fakes; chip_smoke.scene_kinect serves a demo scene): every case of
tests/test_kinect_shim.py and tests/test_kinect_tools.py through both
packages with equal frames, intrinsics, retries, saved files (decoded) and
background clouds; the numpy Gaussian blur against OpenCV's; and the run
loop at --no-demo against the JAX loop on the same stand-in camera."""
import functools
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import torch_kinect_fake as fake
from sixdof_tpu.io import kinect_tools as jkt
from sixdof_tpu.io import readers as jreaders
from sixdof_tpu_torch.app import defect_projection as tdp
from sixdof_tpu_torch.io import kinect_tools as tkt
from sixdof_tpu_torch.io import readers as treaders
from sixdof_tpu_torch.io.mesh_io import load_point_cloud

cv2 = pytest.importorskip("cv2")

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the stand-in camera that serves a demo scene)

PACKAGES = {"jax": (jreaders, jkt), "port": (treaders, tkt)}


@pytest.fixture(autouse=True)
def no_countdowns(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)


def _device(monkeypatch, kind):
    """A fresh fake device of @kind ("shim" or "tools") in sys.modules."""
    device = fake.ShimDevice() if kind == "shim" else fake.ToolsDevice()
    module = fake.shim_module(device) if kind == "shim" else fake.tools_module(device)
    monkeypatch.setitem(sys.modules, "pykinect_azure", module)
    return device


def _scene_dir(tmp_path, name):
    base = tmp_path / name
    for sub in ("configs", "mesh"):
        shutil.copytree(os.path.join(SCENE, sub), base / sub)
    return str(base)


def _assert_trees_equal(a, b):
    """The same files: JSON equal, PNGs decoded equal, PLYs byte-equal."""
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)  # noqa: E731
                                for d, _, fs in os.walk(root) for f in fs)
    assert files(a) == files(b)
    for rel in files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".png"):
            x, y = cv2.imread(pa, -1), cv2.imread(pb, -1)
            assert x.dtype == y.dtype, rel
            np.testing.assert_array_equal(x, y, err_msg=rel)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


def _live_reader(monkeypatch, tmp_path, name, **kw):
    device = _device(monkeypatch, "shim")
    readers = PACKAGES[name][0]
    return device, readers.KinectReader(base_dir=_scene_dir(tmp_path, name), **kw)


def test_kinect_reader_live_loop(monkeypatch, tmp_path):
    out = {}
    for name in PACKAGES:
        device, reader = _live_reader(monkeypatch, tmp_path, name, capture_background=True,
                                      shorter_side=360, zfar=2.0)
        rec = dict(background=load_point_cloud(
            os.path.join(reader.base_dir, "background", "box.ply")).points,
            points=reader.background.points, hw=(reader.color_H, reader.color_W),
            color_K=reader.color_K, depth_K=reader.depth_K, n=len(reader),
            gt=reader.get_gt_pose(0), name=reader.get_video_name(),
            color_pinhole=reader.color_pinhole.intrinsic_matrix)
        device._color_failures = 2
        before = device.updates
        reader.update()
        rec.update(retries=device.updates - before, file_id=reader.file_id,
                   color=reader.get_color(), depth=reader.get_depth(),
                   source=reader.get_source().points)
        reader.stop_camera()
        rec.update(stopped=device.stopped and device.closed)
        out[name] = rec
    assert out["port"]["retries"] == 3 and out["port"]["hw"] == (360, 640)
    for k, want in out["jax"].items():
        got = out["port"][k]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert got == want, k


def test_kinect_reader_zfar_filters_depth(monkeypatch, tmp_path):
    for name in PACKAGES:
        device = _device(monkeypatch, "shim")
        device._depth = np.full((fake.DH, fake.DW), 3000, np.uint16)  # 3 m > zfar 2 m
        reader = PACKAGES[name][0].KinectReader(base_dir=_scene_dir(tmp_path, name),
                                                capture_background=True, shorter_side=360,
                                                zfar=2.0)
        reader.update()
        assert (reader.get_depth() == 0).all()


def test_kinect_reader_save_frame_bgra_to_bgr(monkeypatch, tmp_path):
    for name in PACKAGES:
        _, reader = _live_reader(monkeypatch, tmp_path, name, capture_background=True,
                                 shorter_side=360)
        reader.update()
        out = tmp_path / f"frames_{name}"
        out.mkdir()
        reader.save_frame(reader.last_color, reader.last_depth, reader.last_points, str(out), 7)
        reader.save_intrinsics(str(out))
    _assert_trees_equal(str(tmp_path / "frames_port"), str(tmp_path / "frames_jax"))
    png = cv2.imread(str(tmp_path / "frames_port" / "rgb_007.png"), -1)
    np.testing.assert_array_equal(png, fake.ShimDevice()._color[..., :3])


def test_ycbineoat_heatmap(monkeypatch, tmp_path):
    maps = {}
    for name in PACKAGES:
        _device(monkeypatch, "shim")
        reader = PACKAGES[name][0].YcbineoatReader(base_dir=_scene_dir(tmp_path, name),
                                                   capture_background=True, shorter_side=360)
        reader.update()
        maps[name] = reader.get_heatmap(reader.get_color())
    assert maps["port"].shape == (360, 640)
    np.testing.assert_allclose(maps["port"], maps["jax"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["shim", "tools"])
def test_kinect_tools_campaign(monkeypatch, tmp_path, kind):
    """The shim's campaign (a frame 0 saved before: the campaign resumes at
    1) and the tools test's two campaigns after a background capture."""
    for name, (_, kt) in PACKAGES.items():
        dev = _device(monkeypatch, kind)
        device, config = kt.initialize_kinect()
        assert device is dev
        save_dir = str(tmp_path / f"campaign_{name}")
        os.makedirs(save_dir)
        if kind == "shim":
            cv2.imwrite(os.path.join(save_dir, "rgb_0000.png"), np.zeros((4, 4, 3), np.uint8))
            kt.pvnet_data_capture(device, config, save_dir, total_captures=3, interval=0,
                                  dim_light_frame=10, dim_interval=0)
            assert kt.get_last_frame_id(save_dir) == 3
        else:
            kt.capture_background(device, save_dir, countdown=1)
            kt.pvnet_data_capture(device, config, save_dir, total_captures=3, interval=0,
                                  dim_light_frame=2, dim_interval=0)
            kt.pvnet_data_capture(device, config, save_dir, total_captures=2, interval=0,
                                  dim_light_frame=10, dim_interval=0)
            assert kt.get_last_frame_id(save_dir) == 4
    _assert_trees_equal(str(tmp_path / "campaign_port"), str(tmp_path / "campaign_jax"))


def test_initialize_and_calibration_dump(monkeypatch, tmp_path):
    for name, (_, kt) in PACKAGES.items():
        dev = _device(monkeypatch, "tools")
        device, config = kt.initialize_kinect()
        assert config.color_format == "bgra32" and config.depth_mode == "nfov"
        c2d, d2c = kt.get_extrinsics(device, config)
        jc2d, jd2c = jkt.get_extrinsics(device, config)
        np.testing.assert_array_equal(c2d, jc2d)
        np.testing.assert_array_equal(d2c, jd2c)
        for a, b in zip(kt.get_intrinsics(device, config), jkt.get_intrinsics(device, config)):
            np.testing.assert_array_equal(a, b)
        kt.dump_calibration(str(tmp_path / f"calib_{name}"))
        assert dev.stopped
    _assert_trees_equal(str(tmp_path / "calib_port"), str(tmp_path / "calib_jax"))


def test_capture_retry_and_save(monkeypatch, tmp_path):
    frames = {}
    for name, (_, kt) in PACKAGES.items():
        dev = _device(monkeypatch, "tools")
        device, _ = kt.initialize_kinect()
        dev.fail_first = 2  # the depth image fails twice before a capture succeeds
        frames[name] = kt.capture_frame(device)
        assert kt.capture_save(device, str(tmp_path / f"save_{name}"), frame_count=3)
        assert kt.get_last_frame_id(str(tmp_path / f"save_{name}")) == 3
    for a, b in zip(frames["port"], frames["jax"]):
        np.testing.assert_array_equal(a, b)
    _assert_trees_equal(str(tmp_path / "save_port"), str(tmp_path / "save_jax"))


def test_requires_sdk_without_fake(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pykinect_azure", None)  # import raises ImportError
    for name, (readers, kt) in PACKAGES.items():
        with pytest.raises(RuntimeError, match="pykinect_azure"):
            kt.initialize_kinect()
        with pytest.raises(RuntimeError, match="pykinect_azure"):
            readers.KinectReader(base_dir=_scene_dir(tmp_path, name))


def test_preview_windows_raise_naming_imshow():
    for show in (tkt.display_color_image, tkt.display_depth_image):
        with pytest.raises(RuntimeError, match="imshow"):
            show(np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("shape,sigma", [((360, 640), 50.0), ((31, 47), 1.0),
                                         ((31, 47), 2.5), ((100, 120), 0.7),
                                         ((12, 9), 3.0), ((1, 20), 1.5)])
def test_gaussian_blur_matches_opencv(shape, sigma):
    img = np.random.RandomState(int(sigma * 10)).rand(*shape)
    want = cv2.GaussianBlur(img, (0, 0), sigma)
    got = treaders.gaussian_blur(img, sigma)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape,sigma", [((360, 640), 50), ((480, 640), 50), ((60, 80), 4)])
def test_centered_heatmap_matches_jax(shape, sigma):
    from sixdof_tpu.app.defect_projection import generate_centered_heatmap

    want = generate_centered_heatmap(shape, sigma=sigma)
    got = tdp.generate_centered_heatmap(shape, sigma=sigma)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_parser_takes_the_jax_command_line():
    """The JAX app's command lines (README, a --no-demo run) parse in
    the port, with the JAX parser's values."""
    from sixdof_tpu.app import run as jrun
    from sixdof_tpu_torch.app import run as trun

    for argv in (["--test_scene_dir", SCENE, "--demo"],
                 ["--no-demo", "--capture_background", "true", "--icp", "1", "--info", "0",
                  "--precompile", "0", "--box", "true", "--mesh", "false"],
                 ["--no-demo", "--demo"]):
        t = vars(trun.build_parser().parse_args(argv))
        j = vars(jrun.build_parser().parse_args(argv))
        for k in set(t) & set(j) - {"test_scene_dir", "debug_dir"}:
            assert t[k] == j[k], (argv, k)
    precompile = next(a for a in trun.build_parser()._actions
                      if "--precompile" in a.option_strings)
    assert "warm up" in precompile.help and "join" in precompile.help \
        and precompile.default == 1


def test_cli_demo_runs(tmp_path):
    """`run_torch.py --demo ...` on the CPU: the README's JAX command line,
    cut to two frames."""
    from sixdof_tpu_torch.app import run as trun

    frame_times = trun.cli(["--test_scene_dir", SCENE, "--demo", "--max_frames", "2",
                            "--device", "cpu", "--no_server", "--shorter_side", "120",
                            "--max_hypotheses", "8", "--prune_to", "4", "--est_refine_iter", "1",
                            "--track_refine_iter", "1", "--depth_polish", "0", "--track_polish",
                            "0", "--precompile", "0", "--icp", "false", "--info", "true",
                            "--debug_dir", str(tmp_path)])
    assert len(frame_times) == 2
    assert os.path.exists(tmp_path / "ob_in_cam" / "0001.txt")


def _small_icp(monkeypatch, readers):
    """The rehearsal's ICP work (chip_smoke._icp_parameters) for every reader
    of @readers."""
    update_config = readers._ReaderCommon.update_config
    monkeypatch.setattr(readers._ReaderCommon, "update_config",
                        lambda self, args: chip_smoke._icp_parameters(update_config(self, args),
                                                                      True))


def test_no_demo_loop_matches_jax(monkeypatch, tmp_path):
    """Both apps at --no-demo --capture_background true --max_frames 3
    --capture_every 2 against chip_smoke's stand-in camera serving synth_box:
    the bundled weights in float32 at 64x64 crops, 32x32 coarse renders, the
    parity setup's 64 hypotheses, without the depth polishes (the box's
    unguarded register polish turns float32 differences into ~0.1 deg);
    poses to the run-loop tolerances (1e-5), captures as the run-loop test
    holds async against sync."""
    from sixdof_tpu.app import run as jrun
    from sixdof_tpu.estimater import FoundationPose as JFP
    from sixdof_tpu_torch.app import run as trun
    from sixdof_tpu_torch.estimater import FoundationPose as TFP
    from torch_parity_setup import N_HYPOTHESES, load_predictors

    jr, js, tr, ts = load_predictors()
    for readers in (jreaders, treaders):
        _small_icp(monkeypatch, readers)
    monkeypatch.setattr(jrun, "PoseRefinePredictor", lambda **_: jr)
    monkeypatch.setattr(jrun, "ScorePredictor", lambda **_: js)
    monkeypatch.setattr(jrun, "FoundationPose", functools.partial(JFP, coarse_hw=(32, 32)))
    monkeypatch.setattr(trun, "FoundationPose", functools.partial(TFP, coarse_hw=(32, 32)))
    monkeypatch.setattr(jrun, "ASSETS_DIR", str(tmp_path / "assets"))
    argv = ["--no-demo", "--capture_background", "true", "--no_server", "--max_frames", "3",
            "--capture_every", "2", "--shorter_side", "120", "--max_hypotheses",
            str(N_HYPOTHESES), "--prune_to", "4", "--depth_polish", "0", "--track_polish", "0",
            "--debug", "0"]
    runs = {}
    for name in ("jax", "port"):
        base = chip_smoke.live_scene_dir(SCENE, str(tmp_path / name / "scene"))
        mod, cam = chip_smoke.scene_kinect(SCENE, chip_smoke.LIVE_SCHEDULE)
        monkeypatch.setitem(sys.modules, "pykinect_azure", mod)
        debug_dir = str(tmp_path / name / "debug")
        shown = []
        if name == "jax":
            # the JAX loop's ICP results, recorded where it consumes them:
            # frame 0's refinement and each async capture's result
            captures = []
            refine, capture_async = jrun.refine_pose_with_icp, jrun.capture_event_async

            def refine_recorded(*a, **kw):
                out = refine(*a, **kw)
                captures.append((0, out[1]))
                return out

            class Recorded:
                def __init__(self, frame, pcap):
                    self.frame, self.pcap = frame, pcap

                def result(self):
                    res, pcd = self.pcap.result()
                    captures.append((self.frame, res))
                    return res, pcd

            monkeypatch.setattr(jrun, "refine_pose_with_icp", refine_recorded)
            monkeypatch.setattr(jrun, "capture_event_async", lambda *a, **kw: Recorded(
                cam.served[-1], capture_async(*a, **kw)))
            monkeypatch.setattr(jrun, "update_dash_data",
                                lambda pcds, mesh: shown.append([p.points.copy() for p in pcds]))
            jrun.main(jrun.build_parser().parse_args(
                argv + ["--test_scene_dir", base, "--debug_dir", debug_dir, "--precompile",
                        "0"]))
        else:
            state = trun.LoopState()
            trun.main(trun.build_parser().parse_args(
                argv + ["--test_scene_dir", base, "--debug_dir", debug_dir, "--device", "cpu",
                        "--precompile", "0"]),
                refiner=tr, scorer=ts, state=state)
            captures = state.captures
            shown.append([p.points for p in state.intersection_pcds])
        assert cam.served == ["background", 0, 0, 1, 2] and cam.stopped
        runs[name] = dict(
            poses=[np.loadtxt(os.path.join(debug_dir, "ob_in_cam", f"{i:04d}.txt"))
                   for i in range(3)],
            background=load_point_cloud(os.path.join(base, "background", "box.ply")).points,
            clouds=shown[-1], captures=captures)
    np.testing.assert_array_equal(runs["port"]["background"], runs["jax"]["background"])
    for a, b in zip(runs["port"]["poses"], runs["jax"]["poses"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # the captures and the defect clouds as the loop accumulates them (each
    # re-posed by the later captures), to the run-loop test's tolerances
    assert [f for f, _ in runs["port"]["captures"]] == [f for f, _ in runs["jax"]["captures"]] \
        == [0, 2]
    for (_, a), (_, b) in zip(runs["port"]["captures"], runs["jax"]["captures"]):
        assert abs(a.fitness - b.fitness) < 0.01
        np.testing.assert_allclose(a.transformation, b.transformation, atol=0.05)
    # each defect point within 0.05 mm of the other run's nearest one, both
    # ways (a ray grazing an edge may hit in one run only)
    assert len(runs["port"]["clouds"]) == len(runs["jax"]["clouds"]) == 2
    for a, b in zip(runs["port"]["clouds"], runs["jax"]["clouds"]):
        assert len(a) > 0 and abs(len(a) - len(b)) <= 1
        assert cKDTree(b).query(a)[0].max() <= 0.05 and cKDTree(a).query(b)[0].max() <= 0.05
