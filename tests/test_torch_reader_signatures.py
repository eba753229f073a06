"""The readers' constructor signatures and leftover attributes against the
JAX package's: `DataReader` and `KinectReader` take `downscale` where JAX's
do (a positional second or third argument means the same in both), and
`get_intrinsics`, `depth_K`, `depth_pinhole`, `file_id`, `color_files`,
`id_strs`, `capture_background`, `get_initial_pose` and
`build_pinhole_intrinsics` equal JAX's on every demo scene and on the
stand-in Kinect (tests/torch_kinect_fake.py); and the logging helpers
`rle_to_mask` and `make_yaml_dumpable` against JAX's on
tests/test_config.py's cases."""
import inspect
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest

import torch_kinect_fake as fake
from sixdof_tpu.io import readers as jreaders
from sixdof_tpu.utils import logging_utils as jlog
from sixdof_tpu_torch.io import readers as treaders
from sixdof_tpu_torch.utils import logging_utils as tlog

pytest.importorskip("cv2")  # the JAX reader decodes with OpenCV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = sorted(os.listdir(os.path.join(REPO, "demo_data")))
PACKAGES = {"jax": jreaders, "port": treaders}
# the attributes held equal, beside the frames' and cameras' fields
ATTRS = ("downscale", "file_id", "color_H", "color_W", "depth_H", "depth_W", "depth_K",
         "color_K", "color_files", "id_strs", "zfar", "base_dir")


def _pinhole(p):
    return p.width, p.height, p.intrinsic_matrix.tolist()


def _state(reader):
    """The reader's public state as plain values, for comparison."""
    out = {}
    for k in ATTRS:
        v = getattr(reader, k)
        out[k] = (v.dtype.str, v.tolist()) if isinstance(v, np.ndarray) else v
    out["depth_pinhole"] = _pinhole(reader.depth_pinhole)
    out["color_pinhole"] = _pinhole(reader.color_pinhole)
    out["initial_pose"] = reader.get_initial_pose().tolist()
    out["built_pinhole"] = _pinhole(reader.build_pinhole_intrinsics(33, 17, reader.color_K))
    return out


@pytest.mark.parametrize("cls", ["DataReader", "KinectReader"])
def test_constructor_signatures_match_jax(cls):
    sig = lambda m: [(p.name, p.default) for p in  # noqa: E731
                     inspect.signature(getattr(m, cls).__init__).parameters.values()]
    assert sig(treaders) == sig(jreaders)


@pytest.mark.parametrize("scene", SCENES)
def test_data_reader_attributes_match_jax(scene):
    path = os.path.join(REPO, "demo_data", scene)
    j, t = jreaders.DataReader(path), treaders.DataReader(path)
    assert _state(t) == _state(j)
    for reader in (j, t):  # get_intrinsics again: the file's sizes and cameras
        reader.get_intrinsics()
    assert _state(t) == _state(j)


@pytest.mark.parametrize("args", [(2,), (2, 120), (0.5, None, 1.0)])
def test_positional_construction_matches_jax(args):
    """DataReader(d, 2): downscale 2, replaced at once (native size, as
    JAX); DataReader(d, 2, 120): shorter side 120; a third positional zfar."""
    path = os.path.join(REPO, "demo_data", "synth_box")
    j, t = jreaders.DataReader(path, *args), treaders.DataReader(path, *args)
    assert _state(t) == _state(j)
    np.testing.assert_array_equal(t.get_color(0), j.get_color(0))
    np.testing.assert_array_equal(t.get_depth(1), j.get_depth(1))


def test_frame_sizes_overwrite_the_intrinsics_files(tmp_path):
    """A camera_intrinsics.json whose sizes differ from the frames': the
    frames' sizes win for color_H/W and depth_H/W, the file's stay in the
    pinholes, in both packages."""
    src = os.path.join(REPO, "demo_data", "synth_box")
    scene = tmp_path / "scene"
    scene.mkdir()
    for sub in os.listdir(src):
        if sub != "configs":
            os.symlink(os.path.join(src, sub), scene / sub)
    shutil.copytree(os.path.join(src, "configs"), scene / "configs")
    path = scene / "configs" / "camera_intrinsics.json"
    intr = json.loads(path.read_text())
    intr["color"].update(width=1280, height=720)
    intr["depth"].update(width=320, height=288, fx=250.0)
    path.write_text(json.dumps(intr))
    j, t = jreaders.DataReader(str(scene)), treaders.DataReader(str(scene))
    assert _state(t) == _state(j)
    assert (t.color_H, t.color_W, t.depth_H, t.depth_W) == (480, 640, 480, 640)
    assert _pinhole(t.depth_pinhole)[:2] == (320, 288)


@pytest.mark.parametrize("args,kw", [((), dict(capture_background=True, shorter_side=360)),
                                     ((False, 2, 288), {}), ((True, 1), dict(zfar=2.0))])
def test_kinect_reader_attributes_match_jax(monkeypatch, tmp_path, args, kw):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    out = {}
    for name, readers in PACKAGES.items():
        device = fake.ShimDevice()
        monkeypatch.setitem(sys.modules, "pykinect_azure", fake.shim_module(device))
        base = tmp_path / name / "scene"
        for sub in ("configs", "mesh", "background"):
            shutil.copytree(os.path.join(REPO, "demo_data", "synth_box", sub), base / sub)
        reader = readers.KinectReader(str(base), *args, **kw)
        out[name] = dict(_state(reader), capture_background=reader.capture_background,
                         base_dir=os.path.basename(reader.base_dir))
    assert out["port"] == out["jax"]


RLE_CASES = [{"size": [3, 2], "counts": [2, 3, 1]}, {"size": [1, 1], "counts": [0, 1]},
             {"size": [4, 5], "counts": [7, 2, 0, 5, 6]}, {"size": [2, 3], "counts": [6]}]


@pytest.mark.parametrize("rle", RLE_CASES)
def test_rle_to_mask_matches_jax(rle):
    got, want = tlog.rle_to_mask(rle), jlog.rle_to_mask(rle)
    assert got.dtype == want.dtype == bool and got.shape == want.shape == tuple(rle["size"])
    np.testing.assert_array_equal(got, want)


def test_make_yaml_dumpable_matches_jax():
    import yaml

    d = {"a": np.float32(1.5), "b": np.arange(3), "c": {"d": np.int64(2)},
         "e": [np.float64(0.5)], "f": (np.uint8(7), "s", None), "g": np.eye(2)}
    got, want = tlog.make_yaml_dumpable(d), jlog.make_yaml_dumpable(d)
    assert got == want and yaml.safe_dump(got) == yaml.safe_dump(want)
    assert [type(v) for v in got["f"]] == [int, str, type(None)]
