"""Offline demo-scene reader.

Port of `sixdof_tpu/io/readers.py::DataReader`, the pose path's part: the
colour intrinsics, colour/depth frames, the first-frame mask and the
annotated poses of a scene laid out as

  configs/camera_intrinsics.json  rgb/rgb_*.png  depth/depth_*.png (mm uint16)
  masks/0000.png  annotated_poses/*.txt

PNG decoding is `io/png.py` and resizing reimplements OpenCV's
``INTER_NEAREST`` index rule, so no OpenCV is needed.  The Otsu auto-mask
(used by the JAX reader when masks/0000.png is missing), the ICP sources and
the heatmap belong to the capture slice and are not ported yet.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from .png import read_png


def resize_nearest(img, width, height):
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``:
    source index = floor(dst * (1 / (dst_size / src_size))), clipped."""
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    ifx = 1.0 / (width / W)
    ify = 1.0 / (height / H)
    xs = np.minimum(np.floor(np.arange(width) * ifx).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(height) * ify).astype(np.int64), H - 1)
    return img[ys[:, None], xs[None, :]]


class DataReader:
    """Offline demo-data replay (reference datareader.py:508-792)."""

    def __init__(self, base_dir, shorter_side=None, zfar=np.inf):
        self.base_dir = base_dir
        self.zfar = zfar
        self.color_files = sorted(glob.glob(f"{self.base_dir}/rgb/*.png"))
        if not self.color_files:
            raise FileNotFoundError(f"no colour frames under {self.base_dir}/rgb")
        with open(f"{self.base_dir}/configs/camera_intrinsics.json", "r") as f:
            intr = json.load(f)["color"]
        self.color_K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]],
                                 [0, 0, 1]], dtype=np.float64)
        self.id_strs = [os.path.basename(f).replace(".png", "") for f in self.color_files]
        self.color_H, self.color_W = read_png(self.color_files[0]).shape[:2]
        depth_H, depth_W = read_png(self._depth_path(self.color_files[0])).shape[:2]
        if shorter_side is None:
            shorter_side = min(self.color_H, self.color_W, depth_H, depth_W)
        self.downscale = shorter_side / min(self.color_H, self.color_W)
        self.color_H = int(self.color_H * self.downscale)
        self.color_W = int(self.color_W * self.downscale)
        self.color_K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{self.base_dir}/annotated_poses/*"))

    def __len__(self):
        return len(self.color_files)

    def get_gt_pose(self, i=0):
        if i >= len(self.gt_pose_files):
            return None
        return np.loadtxt(self.gt_pose_files[i]).reshape(4, 4)

    @staticmethod
    def _depth_path(color_path):
        """Swap only the rgb directory and the rgb_ filename prefix."""
        d, b = os.path.split(color_path)
        parent, leaf = os.path.split(d)
        if leaf == "rgb":
            d = os.path.join(parent, "depth")
        if b.startswith("rgb"):
            b = "depth" + b[3:]
        return os.path.join(d, b)

    def get_color(self, i=0):
        """(H,W,3) uint8 RGB."""
        img = read_png(self.color_files[i])
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        rgb = np.ascontiguousarray(img[..., :3][..., ::-1])
        return resize_nearest(rgb, self.color_W, self.color_H)

    def get_depth(self, i=0):
        """(H,W) float64 meters; <1 mm or >= zfar set to 0."""
        depth = read_png(self._depth_path(self.color_files[i])) / 1e3
        depth = resize_nearest(depth, self.color_W, self.color_H)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0
        return depth

    def get_mask(self, color_image=None, i=None):
        """masks/0000.png as a (H,W) uint8 0/1 mask."""
        mask = read_png(f"{self.base_dir}/masks/0000.png")
        if mask.ndim == 3:
            for c in range(mask.shape[-1]):
                if mask[..., c].sum() > 0:
                    mask = mask[..., c]
                    break
        return resize_nearest(mask, self.color_W, self.color_H).astype(bool).astype(np.uint8)
