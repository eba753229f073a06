"""Fake `pykinect_azure` devices for the live-camera tests of the port
(tests/test_torch_kinect.py): copies of the two fakes the JAX package's
tests drive its live path with, so that the port and the JAX package run
on identical devices.

- `ShimDevice` / `shim_module`: tests/test_kinect_shim.py's device, a
  seeded 1280x720 BGRA colour frame, 320x288 depth at 600 mm and 5000
  random points, whose colour image can fail a set number of times.
- `ScheduledDevice`: a ShimDevice serving a schedule of given frames
  (chip_smoke.scene_kinect serves a demo scene through it).
- `ToolsDevice` / `tools_module`: tests/test_kinect_tools.py's device, a
  30x40 frame whose depth fails a set number of times after each update.
"""
import types

import numpy as np

CW, CH = 1280, 720  # K4A_COLOR_RESOLUTION_720P
DW, DH = 320, 288  # K4A_DEPTH_MODE_NFOV_2X2BINNED


class _Params:
    def __init__(self, fx, fy, cx, cy):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy


class Calibration:
    """The device calibration: each camera's (fx, fy, cx, cy) and the
    colour->depth extrinsic (identity rotation, @translation in mm)."""

    def __init__(self, color=(600.0, 600.0, CW / 2, CH / 2), depth=(250.0, 250.0, DW / 2, DH / 2),
                 translation=(1.5, -0.5, 2.0)):
        self.color_params, self.depth_params = _Params(*color), _Params(*depth)
        self.color_calibration = types.SimpleNamespace(extrinsics=types.SimpleNamespace(
            rotation=tuple(np.eye(3).ravel()), translation=tuple(translation)))


class _Capture:
    def __init__(self, device):
        self._device = device

    def get_depth_image(self):
        return True, self._device._depth

    def get_color_image(self):
        if self._device._color_failures > 0:
            self._device._color_failures -= 1
            return False, None
        return True, self._device._color

    def get_pointcloud(self):
        return True, self._device._points


class ShimDevice:
    def __init__(self, calibration=None):
        self._calibration = calibration or Calibration()
        rng = np.random.RandomState(0)
        color = rng.randint(0, 255, (CH, CW, 4), dtype=np.uint8)
        color[..., 3] = 255
        self._color = color  # BGRA, as the real SDK delivers
        self._depth = np.full((DH, DW), 600, np.uint16)  # mm
        self._points = rng.rand(5000, 3) * 400.0  # mm
        self._color_failures = 0
        self.updates = 0
        self.stopped = False
        self.closed = False

    def update(self):
        self.updates += 1
        return _Capture(self)

    def get_calibration(self, depth_mode, color_resolution):
        assert depth_mode == 1 and color_resolution == 1
        return self._calibration

    def stop_cameras(self):
        self.stopped = True

    def close(self):
        self.closed = True


class ScheduledDevice(ShimDevice):
    """A ShimDevice whose `update()` serves the next entry of @schedule, the
    last one again once it runs out, as the images `frames(entry)` returns
    ((colour BGRA, depth uint16 mm, points mm)); `served` lists the entries."""

    def __init__(self, frames, schedule, calibration):
        super().__init__(calibration)
        self._frames, self._schedule, self.served = frames, schedule, []

    def update(self):
        entry = self._schedule[min(len(self.served), len(self._schedule) - 1)]
        self.served.append(entry)
        self._color, self._depth, self._points = self._frames(entry)
        return super().update()


def shim_module(device):
    mod = types.ModuleType("pykinect_azure")
    mod.initialize_libraries = lambda: None
    mod.default_configuration = types.SimpleNamespace(
        color_format=None, color_resolution=None, depth_mode=None)
    mod.K4A_IMAGE_FORMAT_COLOR_BGRA32 = 0
    mod.K4A_COLOR_RESOLUTION_720P = 1
    mod.K4A_DEPTH_MODE_NFOV_2X2BINNED = 1

    def start_device(config=None):
        assert config.color_resolution == 1 and config.depth_mode == 1
        return device

    mod.start_device = start_device
    return mod


class _ToolsCapture:
    def __init__(self, fail_first=0):
        self._fails = fail_first

    def _ret(self):
        if self._fails > 0:
            self._fails -= 1
            return False
        return True

    def get_depth_image(self):
        ok = self._ret()
        return ok, (np.full((30, 40), 500, np.uint16) if ok else None)

    def get_color_image(self):
        return True, np.full((30, 40, 4), 128, np.uint8)

    def get_pointcloud(self):
        return True, np.random.RandomState(0).rand(100, 3) * 100


class ToolsDevice:
    def __init__(self):
        self.fail_first = 0
        self.stopped = False

    def update(self):
        c = _ToolsCapture(self.fail_first)
        self.fail_first = 0
        return c

    def get_calibration(self, depth_mode, color_resolution):
        class P:
            fx, fy, cx, cy = 600.0, 600.0, 320.0, 240.0

        class E:
            rotation = list(np.eye(3).reshape(-1))
            translation = [1.0, -2.0, 3.0]

        class CC:
            extrinsics = E

        class C:
            color_params = P
            depth_params = P
            color_calibration = CC

        return C

    def stop_cameras(self):
        self.stopped = True

    def close(self):
        pass


def tools_module(device):
    mod = types.ModuleType("pykinect_azure")
    mod.initialize_libraries = lambda: None
    mod.default_configuration = types.SimpleNamespace(
        color_format=None, color_resolution=None, depth_mode=None)
    mod.K4A_IMAGE_FORMAT_COLOR_BGRA32 = "bgra32"
    mod.K4A_COLOR_RESOLUTION_720P = "720p"
    mod.K4A_DEPTH_MODE_NFOV_2X2BINNED = "nfov"
    mod.start_device = lambda config: device
    return mod
