"""Scene readers: offline demo-scene replay and live Azure-Kinect capture.

Port of `sixdof_tpu/io/readers.py`.  `DataReader` replays a recorded
scene: the colour intrinsics, colour/depth frames, the first-frame mask and
the annotated poses (the pose path), and the per-scene ICP parameters,
camera extrinsics, scene clouds, CAD mesh and defect heatmap (the capture
path), of a scene laid out as

  configs/{camera_intrinsics,camera_extrinsics,icp_parameters}.json
  rgb/rgb_*.png  depth/depth_*.png (mm uint16)  pcd/cloud_*.ply
  masks/0000.png  annotated_poses/*.txt  background/box.ply
  mesh/{model.obj, model.ply}  heatmap/0002.npy

PNG decoding is `io/png.py`, and resizing, the grey conversion, Otsu's
threshold, the morphology of the auto-mask and the Gaussian blur
reimplement OpenCV's rules in numpy, so no OpenCV is needed.  Frame i+1 is
decoded on a background thread while frame i is in use, as the JAX reader
does.  `KinectReader` (and `YcbineoatReader`, its variant with a Gaussian
heatmap) read the live camera through `pykinect_azure`, imported when one
is built; the scene directory then holds the configs, mesh, background and
heatmap.
"""
from __future__ import annotations

import glob
import json
import logging
import math
import os
import sys
import threading
import time

import numpy as np
from scipy import ndimage

from ..app.defect_projection import PinholeCameraIntrinsic, load_extrinsics
from ..config import IcpConfig
from .mesh_io import PointCloud, load_mesh, load_point_cloud, save_point_cloud
from .png import read_png, write_png_gray8, write_png_gray16, write_png_rgb8


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


def _area_taps(ssize, dsize):
    """OpenCV's computeResizeAreaTab for one axis (scale = src / dst >= 1):
    every destination cell's (source index, float32 weight) pairs in
    OpenCV's order, padded to (dsize, taps) with weight 0."""
    scale = 1.0 / (dsize / ssize)
    rows = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        taps = [(s1 - 1, (s1 - f1) / cell)] if s1 - f1 > 1e-3 else []
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dsize, n), np.int64)
    w = np.zeros((dsize, n), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k], w[d, k] = s, a
    return idx, w


def _area_linear_taps(dsize, ssize):
    """The two taps and 11-bit fixed-point weights OpenCV's INTER_AREA uses
    along an axis it does not shrink (its bilinear emulation): s =
    floor(d * scale), weight frac((d + 1) - (s + 1) / scale) on s + 1; at
    the last source sample the tap is single.  Returns (s0, s1, w0, w1,
    single)."""
    inv = dsize / ssize
    scale = 1.0 / inv
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    single = s + 1 >= ssize
    last = s >= ssize - 1
    s = np.where(last, ssize - 1, s)
    f = np.where(last, np.float32(0), f)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return s, np.minimum(s + 1, ssize - 1), w0, w1, single


def resize_area(img, width, height):
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`` of
    a uint8 (H,W) or (H,W,C) image, as OpenCV computes it:
    - shrinking both axes by whole factors: the block sums, rounded as
      (sum + 2) >> 2 for 2x2 blocks and as rint(float32(sum) / area) else;
    - shrinking both axes otherwise: area weights (computeResizeAreaTab),
      a horizontal then a vertical float32 pass in OpenCV's order, rint;
    - otherwise OpenCV's bilinear emulation in 11-bit fixed point, the
      vertical pass as its vector code computes it (a 16-bit multiply-high
      of the 4-bit-shifted rows, then a rounding shift by 2).
    A same-size call is a copy."""
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8 images, got {img.dtype}")
    ex = (1,) * (img.ndim - 2)
    sx, sy = 1.0 / (width / W), 1.0 / (height / H)
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(float).eps and abs(sy - iy) < np.finfo(float).eps:
            s = img.astype(np.int32).reshape((height, iy, width, ix) + img.shape[2:]).sum(
                axis=(1, 3))
            if (ix, iy) == (2, 2):
                return ((s + 2) >> 2).astype(np.uint8)
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (ix * iy)))
            return np.clip(out, 0, 255).astype(np.uint8)
        xi, xw = _area_taps(W, width)
        yi, yw = _area_taps(H, height)
        src = img.astype(np.float32)
        buf = np.zeros((H, width) + img.shape[2:], np.float32)
        for k in range(xi.shape[1]):
            buf = buf + src[:, xi[:, k]] * xw[:, k].reshape((1, width) + ex)
        out = yw[:, 0].reshape((height, 1) + ex) * buf[yi[:, 0]]
        for k in range(1, yi.shape[1]):
            out = out + yw[:, k].reshape((height, 1) + ex) * buf[yi[:, k]]
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    x0, x1, a0, a1, single = _area_linear_taps(width, W)
    y0, y1, b0, b1, _ = _area_linear_taps(height, H)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0.reshape((1, width) + ex) + src[:, x1] * a1.reshape((1, width) + ex)
    rows = np.where(single.reshape((1, width) + ex), src[:, x0] * 2048, rows)
    m0 = ((rows[y0] >> 4) * b0.reshape((height, 1) + ex)) >> 16
    m1 = ((rows[y1] >> 4) * b1.reshape((height, 1) + ex)) >> 16
    return np.clip((m0 + m1 + 2) >> 2, 0, 255).astype(np.uint8)


def _linear_taps(dst, src):
    """OpenCV's INTER_LINEAR source taps and float32 weights for one axis:
    f = (d + 0.5) * (1 / (dst / src)) - 0.5 in float64, s = floor(f), weight
    float32(f - s) on s + 1 and 1 - that on s, clamped to the border with
    weight 0."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    frac[(s < 0) | (s >= src - 1)] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), np.float32(1.0) - frac, frac


def resize_linear(img, width, height):
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`` of
    a float32 (H,W) image: half-pixel centres, clamped border, a horizontal
    then a vertical pass in float32.  A same-size call is a copy."""
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    img = np.asarray(img, dtype=np.float32)
    x0, x1, a0, a1 = _linear_taps(width, W)
    y0, y1, b0, b1 = _linear_taps(height, H)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


def _linear_u8_taps(dst, scale):
    """OpenCV's INTER_LINEAR taps for one axis: f = float32((d + 0.5) *
    scale - 0.5), s = floor(f), frac = f - s in float32."""
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    return s.astype(np.int64), frac


def resize_linear_u8(img, factor):
    """``cv2.resize(img, None, fx=factor, fy=factor)`` (INTER_LINEAR) of a
    uint8 (H,W) or (H,W,C) image, as OpenCV computes it: the size rounds
    to nearest, the sampling scale is 1 / factor (not the size ratio); an
    exact halving is OpenCV's 2x2 block average; otherwise 11-bit fixed
    point weights rint(frac * 2048) on s + 1 and rint((1 - frac) * 2048) on
    s.  A column tap outside the source moves to the border with the whole
    weight; a row tap outside keeps its weights and reads the border row.
    The vertical pass is computed as OpenCV's vector code does (a 16-bit
    multiply-high of the 4-bit-shifted rows, then a rounding shift by 2)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8 images, got {img.dtype}")
    H, W = img.shape[:2]
    width, height = int(round(W * factor)), int(round(H * factor))
    if (width, height) == (W, H) and factor == 1:
        return img.copy()
    scale = 1.0 / factor
    if scale == 2.0 and 2 * width == W and 2 * height == H:
        return resize_area(img, width, height)
    ex = (1,) * (img.ndim - 2)

    def taps(dst, src, columns):
        s, frac = _linear_u8_taps(dst, scale)
        if columns:
            frac = np.where((s < 0) | (s >= src - 1), np.float32(0), frac).astype(np.float32)
        w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
        w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
        return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1

    x0, x1, a0, a1 = taps(width, W, True)
    y0, y1, b0, b1 = taps(height, H, False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0.reshape((1, width) + ex) + src[:, x1] * a1.reshape((1, width) + ex)
    m0 = ((rows[y0] >> 4) * b0.reshape((height, 1) + ex)) >> 16
    m1 = ((rows[y1] >> 4) * b1.reshape((height, 1) + ex)) >> 16
    return np.clip((m0 + m1 + 2) >> 2, 0, 255).astype(np.uint8)


def bgr_to_gray(img):
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` of a uint8 (H,W,3) image:
    OpenCV's 15-bit fixed-point weights (gray_shift), rounded."""
    b, g, r = (img[..., c].astype(np.int32) for c in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def otsu_threshold(gray):
    """The threshold ``cv2.THRESH_OTSU`` picks for a uint8 image: the first
    maximum of the between-class variance, in OpenCV's double-precision
    order of operations."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = float(np.arange(256) @ hist) * scale  # an exact integer sum, as in double
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return max_val


def otsu_mask(color):
    """The JAX reader's auto-mask of a colour frame as cv2 computes it:
    grey (COLOR_BGR2GRAY applied to the frame as given), Otsu threshold,
    inverted, then a 3x3 open and a 3x3 close of 2 iterations each.  OpenCV
    runs 2 iterations of a full 3x3 kernel as one 5x5 pass, and its default
    border never wins a min or a max.  Returns 0/255 uint8."""
    gray = bgr_to_gray(color)
    refined = np.where(gray > otsu_threshold(gray), 0, 255).astype(np.uint8)
    return erode5(dilate5(dilate5(erode5(refined))))


def erode5(img):
    """``cv2.erode`` of a uint8 image by a full 5x5 kernel (OpenCV's default
    border never wins the min)."""
    return ndimage.minimum_filter(img, size=5, mode="constant", cval=255)


def dilate5(img):
    """``cv2.dilate`` of a uint8 image by a full 5x5 kernel (OpenCV's
    default border never wins the max)."""
    return ndimage.maximum_filter(img, size=5, mode="constant", cval=0)


def write_color_png(path, img):
    """``cv2.imwrite(path, img[..., :3])`` of a BGR or BGRA uint8 frame (the
    alpha dropped), or of a grey one."""
    img = np.asarray(img)
    if img.ndim == 2:
        write_png_gray8(path, img)
    else:
        write_png_rgb8(path, np.ascontiguousarray(img[..., 2::-1]))


def _gaussian_kernel(n, sigma):
    """OpenCV's getGaussianKernel(n, sigma) for sigma > 0, in float64:
    exp(-(x^2) / (2 sigma^2)) at x = i - (n-1)/2, scaled by 1 / sum with the
    sum taken as OpenCV takes it (one half doubled, plus the centre)."""
    x = 2 * np.arange((n - 1) // 2) - (n - 1)  # OpenCV's x = 2i - (n-1), scale -1/8
    half = np.exp((x * x).astype(np.float64) * (-0.125 / (sigma * sigma)))
    total = 0.0
    for t in half:  # in order, as OpenCV sums (np.sum would pair the terms)
        total += t
    total = total * 2.0 + 1.0
    if n % 2 == 0:
        total += 1.0
    mul = 1.0 / total
    centre = [mul] * (2 - n % 2)
    return np.concatenate([half * mul, centre, (half * mul)[::-1]])


def gaussian_blur(img, sigma):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float64 (H,W) image:
    kernel size round(sigma * 8 + 1) | 1, BORDER_REFLECT_101, a row pass
    summed tap by tap, then a column pass over symmetric pairs as OpenCV's
    separable filter computes it."""
    img = np.asarray(img, dtype=np.float64)
    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    k = _gaussian_kernel(n, sigma)
    r = n // 2
    src = np.pad(img, ((0, 0), (r, r)), mode="reflect") if img.shape[1] > 1 else \
        np.repeat(img, n, axis=1)
    W = img.shape[1]
    rows = k[0] * src[:, 0:W]
    for j in range(1, n):
        rows = rows + k[j] * src[:, j : j + W]
    cols = np.pad(rows, ((r, r), (0, 0)), mode="reflect") if img.shape[0] > 1 else \
        np.repeat(rows, n, axis=0)
    H = img.shape[0]
    out = k[r] * cols[r : r + H]
    for j in range(1, r + 1):
        out = out + k[r + j] * (cols[r + j : r + j + H] + cols[r - j : r - j + H])
    return out


class _ReaderCommon:
    """What the offline and the live reader share: the mask, the heatmap,
    the ICP parameters, the extrinsics, the background cloud and the CAD
    mesh, all read from `self.base_dir`."""

    def get_mask(self, color_image=None, i=None):
        """masks/0000.png as a (H,W) uint8 0/1 mask; where it is missing, the
        Otsu auto-mask of @color_image, written back as masks/0000.png."""
        path = f"{self.base_dir}/masks/0000.png"
        if not os.path.exists(path):
            logging.info(f"{path} not found: writing the Otsu auto-mask of the frame")
            refined = otsu_mask(color_image)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_png_gray8(path, refined)
            return resize_nearest(refined, self.color_W, self.color_H).astype(bool).astype(
                np.uint8)
        mask = read_png(path)
        if mask.ndim == 3:
            for c in range(mask.shape[-1]):
                if mask[..., c].sum() > 0:
                    mask = mask[..., c]
                    break
        return resize_nearest(mask, self.color_W, self.color_H).astype(bool).astype(np.uint8)

    def update_config(self, args):
        """icp_parameters.json with the CLI overrides applied (CLI > JSON >
        defaults); keeps the typed form in `icp_config` and returns the
        nested dict the pipeline functions read."""
        cfg = self.get_icp_config()
        if args is not None:
            cfg = cfg.apply_cli_overrides(args)
        self.icp_config = cfg
        return cfg.to_reference_dict()

    def get_icp_config(self):
        path = f"{self.base_dir}/configs/icp_parameters.json"
        if os.path.exists(path):
            return IcpConfig.from_json(path)
        return IcpConfig()

    def get_parameters(self):
        with open(f"{self.base_dir}/configs/icp_parameters.json", "r") as f:
            return json.load(f)

    def get_extrinsics(self):
        self.color_to_depth, self.depth_to_color = load_extrinsics(self.base_dir)
        self.inverse_color_to_depth = np.linalg.inv(self.color_to_depth)
        self.inverse_depth_to_color = np.linalg.inv(self.depth_to_color)

    def get_background(self):
        self.background = load_point_cloud(f"{self.base_dir}/background/box.ply")

    def get_target(self):
        """The CAD mesh in millimetres (`target_mesh`, ray-traced) and its
        point cloud (`target`, the ICP target)."""
        self.target_mesh = load_mesh(f"{self.base_dir}/mesh/model.obj")
        self.target_mesh.compute_vertex_normals()
        self.target = load_point_cloud(f"{self.base_dir}/mesh/model.ply")

    def get_initial_pose(self):
        return np.eye(4)

    @staticmethod
    def scale_translation_to_millimeters(pose):
        out = pose.copy()
        out[:3, -1] *= 1000
        return out

    @staticmethod
    def build_pinhole_intrinsics(width, height, K):
        """The camera of intrinsic matrix @K (nested lists or an array) at
        @width x @height."""
        return PinholeCameraIntrinsic.from_params(width, height, K[0][0], K[1][1], K[0][2],
                                                  K[1][2])

    def get_heatmap(self, color_image):
        """heatmap/0002.npy normalised to [0,1], resized to the colour frame's
        shorter native side (OpenCV's INTER_LINEAR) and centred on a float64
        canvas of the native colour size; and the crop of @color_image that
        the heatmap covers (INTER_AREA to the heatmap's scale, a centre crop,
        INTER_NEAREST to the same side), which the overlay blends with it.
        Returns (heatmap_full (H0,W0) float64, color_original, heatmap_vis
        float32, color_original)."""
        heatmap_data = np.load(f"{self.base_dir}/heatmap/0002.npy")
        heatmap_size = heatmap_data.shape[0]
        scale = heatmap_size / min(color_image.shape[:2])
        new_height = int(color_image.shape[0] * scale)
        new_width = int(color_image.shape[1] * scale)
        color_resized = resize_area(color_image, new_width, new_height)
        start_y = (new_height - heatmap_size) // 2
        start_x = (new_width - heatmap_size) // 2
        color_cropped = color_resized[start_y : start_y + heatmap_size,
                                      start_x : start_x + heatmap_size]
        heatmap = heatmap_data - np.min(heatmap_data)
        heatmap = heatmap / np.max(heatmap)
        H0 = int(self.color_H / self.downscale)
        W0 = int(self.color_W / self.downscale)
        output_size = min(H0, W0)
        heatmap_vis = resize_linear(heatmap, output_size, output_size)
        color_original = resize_nearest(color_cropped, output_size, output_size)
        heatmap_full = np.zeros((H0, W0))
        y_start = (H0 - output_size) // 2
        x_start = (W0 - output_size) // 2
        heatmap_full[y_start : y_start + output_size,
                     x_start : x_start + output_size] = heatmap_vis
        return heatmap_full, color_original, heatmap_vis, color_original


class DataReader(_ReaderCommon):
    """Offline demo-data replay (reference datareader.py:508-792).

    @downscale is kept until the frame sizes are read, then replaced by
    shorter_side / the colour frame's shorter side (@shorter_side: by
    default the least of the colour and depth frames' sides), as the JAX
    reader does."""

    def __init__(self, base_dir, downscale=1, shorter_side=None, zfar=np.inf, arguments=None):
        self.base_dir = base_dir
        self.downscale = downscale
        self.zfar = zfar
        # frames decoded ahead on a thread (_prefetched): kind -> {i: frame},
        # kind -> {i: decoding thread}, kind -> the frame served last
        self._pf_cache = {"color": {}, "depth": {}}
        self._pf_inflight = {"color": {}, "depth": {}}
        self._pf_served = {"color": None, "depth": None}
        self._pf_lock = threading.Lock()
        self.color_files = sorted(glob.glob(f"{self.base_dir}/rgb/*.png"))
        if not self.color_files:
            raise FileNotFoundError(f"no colour frames under {self.base_dir}/rgb")
        self.file_id = 0
        self.parameters = self.update_config(arguments)
        self.get_intrinsics()
        self.get_extrinsics()
        self.color_K = np.array(self.color_K)
        self.id_strs = [os.path.basename(f).replace(".png", "") for f in self.color_files]
        # the frames' own sizes replace the intrinsics file's
        self.color_H, self.color_W = read_png(self.color_files[0]).shape[:2]
        self.depth_H, self.depth_W = read_png(self._depth_path(self.color_files[0])).shape[:2]
        if shorter_side is None:
            shorter_side = min(self.color_H, self.color_W, self.depth_H, self.depth_W)
        self.downscale = shorter_side / min(self.color_H, self.color_W)
        self.color_H = int(self.color_H * self.downscale)
        self.color_W = int(self.color_W * self.downscale)
        self.color_K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{self.base_dir}/annotated_poses/*"))
        self.get_background()
        self.get_target()

    def __len__(self):
        return len(self.color_files)

    def get_intrinsics(self):
        """configs/camera_intrinsics.json: `depth_K` and `color_K` (nested
        lists), the native sizes, and the depth and colour cameras at them
        (`depth_pinhole`, `color_pinhole`; the defect rays use the latter)."""
        with open(f"{self.base_dir}/configs/camera_intrinsics.json", "r") as f:
            intr = json.load(f)
        K = {cam: [[intr[cam]["fx"], 0, intr[cam]["cx"]], [0, intr[cam]["fy"], intr[cam]["cy"]],
                   [0, 0, 1]] for cam in ("depth", "color")}
        self.depth_K, self.color_K = K["depth"], K["color"]
        self.depth_H, self.depth_W = intr["depth"]["height"], intr["depth"]["width"]
        self.color_H, self.color_W = intr["color"]["height"], intr["color"]["width"]
        self.depth_pinhole = self.build_pinhole_intrinsics(self.depth_W, self.depth_H, self.depth_K)
        self.color_pinhole = self.build_pinhole_intrinsics(self.color_W, self.color_H, self.color_K)

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

    def _prefetched(self, kind, i, loader):
        """Serve frame i of @kind, then start decoding frame i+1 on a daemon
        thread, so the next read finds it decoded.  The cache keeps frames i
        and i+1 only; a frame read twice (a capture frame) decodes once, and
        a read of a frame still decoding waits for it."""
        with self._pf_lock:
            cache, inflight = self._pf_cache[kind], self._pf_inflight[kind]
            worker = inflight.get(i)
        if worker is not None:
            worker.join()
        with self._pf_lock:
            val = cache.get(i)
        if val is None:
            val = loader(i)
        nxt = i + 1
        with self._pf_lock:
            self._pf_served[kind] = i
            cache[i] = val
            for k in [k for k in cache if k < i or k > nxt]:
                del cache[k]
            if nxt < len(self.color_files) and nxt not in cache and nxt not in inflight:
                # started under the lock: a thread that finds it in flight may join it
                inflight[nxt] = threading.Thread(target=self._decode_ahead,
                                                 args=(kind, nxt, loader), daemon=True)
                inflight[nxt].start()
        return val

    def _decode_ahead(self, kind, i, loader):
        try:
            val = loader(i)
            with self._pf_lock:
                if self._pf_served[kind] == i - 1:  # else the reader moved on
                    self._pf_cache[kind][i] = val
        finally:  # a failed decode leaves no entry: the reader decodes again
            with self._pf_lock:
                del self._pf_inflight[kind][i]

    def get_color(self, i=0):
        """(H,W,3) uint8 RGB."""
        return self._prefetched("color", i, self._load_color)

    def get_depth(self, i=0):
        """(H,W) float64 meters; <1 mm or >= zfar set to 0."""
        return self._prefetched("depth", i, self._load_depth)

    def _load_color(self, i):
        img = read_png(self.color_files[i])
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        rgb = np.ascontiguousarray(img[..., :3][..., ::-1])
        return resize_nearest(rgb, self.color_W, self.color_H)

    def _load_depth(self, i):
        depth = read_png(self._depth_path(self.color_files[i])) / 1e3
        depth = resize_nearest(depth, self.color_W, self.color_H)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0
        return depth

    def get_source(self, i=0):
        """The scene cloud of frame i (pcd/cloud_*.ply, depth camera, mm)."""
        pcd_path = (self.color_files[i].replace("/rgb/", "/pcd/").replace(".png", ".ply")
                    .replace("/rgb_", "/cloud_"))
        return load_point_cloud(pcd_path)

    def get_video_name(self):
        return self.base_dir.split("/")[-1]

    def get_xyz_map(self, i=0):
        """Frame i's depth as a (H,W,3) float32 camera-frame xyz map."""
        import torch

        from ..ops.geometry import depth2xyzmap

        return depth2xyzmap(torch.as_tensor(self.get_depth(i), dtype=torch.float32),
                            torch.as_tensor(self.color_K, dtype=torch.float32)).numpy()

    def update(self):
        """A recorded scene has no camera to poll."""

    def stop_camera(self):
        """A recorded scene has no camera to stop."""


class KinectReader(_ReaderCommon):
    """Live Azure-Kinect capture through `pykinect_azure` (BGRA32 colour at
    720p, NFOV 2x2-binned depth), imported when the reader is built: without
    it, building one raises.  Each `update()` grabs a frame, retrying until
    the colour, depth and point cloud all arrive; the getters serve the last
    frame.  @capture_background: capture the empty scene's cloud at start
    (after a countdown) and save it as background/box.ply, else read that
    file.  @downscale is replaced as in `DataReader`."""

    COLOR_RESOLUTIONS = {1: (1280, 720), 2: (1920, 1080), 3: (2560, 1440),
                         4: (2048, 1536), 5: (3840, 2160), 6: (4096, 3072)}
    DEPTH_MODES = {1: (320, 288), 2: (640, 576), 3: (512, 512), 4: (1024, 1024),
                   5: (1024, 1024)}

    def __init__(self, base_dir, capture_background=False, downscale=1, shorter_side=None,
                 zfar=np.inf, arguments=None):
        try:
            import pykinect_azure as pykinect
        except ImportError as e:
            raise RuntimeError("KinectReader requires pykinect_azure (live capture); use "
                               "DataReader for recorded scenes") from e
        self._pykinect = pykinect
        pykinect.initialize_libraries()
        self.base_dir = base_dir
        self.downscale = downscale
        self.zfar = zfar
        self.file_id = 0
        self.color_files = []  # a live stream has no files
        self.id_strs = []
        self.parameters = self.update_config(arguments)
        self.device, self.device_config = self.initialize()
        self.get_intrinsics()
        self.get_extrinsics()
        if shorter_side is None:
            shorter_side = min(self.color_H, self.color_W, self.depth_H, self.depth_W)
        self.downscale = shorter_side / min(self.color_H, self.color_W)
        self.color_H = int(self.color_H * self.downscale)
        self.color_W = int(self.color_W * self.downscale)
        self.color_K = np.array(self.color_K)
        self.depth_K = np.array(self.depth_K)
        self.color_K[:2] *= self.downscale
        self.depth_K[:2] *= self.downscale
        self.last_color = None
        self.last_depth = None
        self.last_points = None
        self.capture_background = capture_background
        if capture_background:
            self.background = self.capture_new_background()
        else:
            self.get_background()
        self.get_target()

    def initialize(self):
        pykinect = self._pykinect
        device_config = pykinect.default_configuration
        device_config.color_format = pykinect.K4A_IMAGE_FORMAT_COLOR_BGRA32
        device_config.color_resolution = pykinect.K4A_COLOR_RESOLUTION_720P
        device_config.depth_mode = pykinect.K4A_DEPTH_MODE_NFOV_2X2BINNED
        device = pykinect.start_device(config=device_config)
        time.sleep(1)
        return device, device_config

    def stop_camera(self):
        self.device.stop_cameras()
        self.device.close()

    def get_video_name(self):
        return "KinectLiveStream"

    def __len__(self):
        return sys.maxsize  # a live stream has no end; len() must be an int

    def get_gt_pose(self, i=None):
        logging.info("GT pose not available for live data")
        return None

    def update(self):
        self.last_color, self.last_depth, self.last_points = self.capture_frame()
        self.file_id += 1

    def get_intrinsics(self):
        calibration = self.device.get_calibration(self.device_config.depth_mode,
                                                  self.device_config.color_resolution)
        dp, cp = calibration.depth_params, calibration.color_params
        self.depth_K = [[dp.fx, 0, dp.cx], [0, dp.fy, dp.cy], [0, 0, 1]]
        self.color_K = [[cp.fx, 0, cp.cx], [0, cp.fy, cp.cy], [0, 0, 1]]
        cw, ch = self.COLOR_RESOLUTIONS[self.device_config.color_resolution]
        dw, dh = self.DEPTH_MODES[self.device_config.depth_mode]
        self.color_W, self.color_H = cw, ch
        self.depth_W, self.depth_H = dw, dh
        # the defect rays use the colour camera at its native size
        self.depth_pinhole = self.build_pinhole_intrinsics(dw, dh, self.depth_K)
        self.color_pinhole = self.build_pinhole_intrinsics(cw, ch, self.color_K)

    def get_color(self, i=None):
        """The last frame as (H,W,3) uint8 RGB, or None before the first."""
        if self.last_color is None:
            logging.warning("No color image captured yet.")
            return None
        rgb = np.ascontiguousarray(self.last_color[..., 2::-1])  # BGR(A) -> RGB
        return resize_nearest(rgb, self.color_W, self.color_H)

    def get_depth(self, i=None):
        """The last depth frame in metres (float32), or None."""
        if self.last_depth is None:
            logging.warning("No depth image captured yet.")
            return None
        depth = self.last_depth.astype(np.float32) / 1e3
        depth = resize_nearest(depth, self.color_W, self.color_H)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0
        return depth

    def get_source(self, i=None):
        """The last frame's point cloud (depth camera, mm), or None."""
        if self.last_points is None:
            logging.warning("No point cloud captured yet.")
            return None
        return PointCloud(self.last_points)

    def capture_frame(self):
        capture = self.device.update()
        ret_depth, depth_image = capture.get_depth_image()
        ret_color, color_image = capture.get_color_image()
        ret_points, points = capture.get_pointcloud()
        while not ret_color or not ret_depth or not ret_points:
            logging.error("Failed to get image or point cloud.")
            capture = self.device.update()
            ret_depth, depth_image = capture.get_depth_image()
            ret_color, color_image = capture.get_color_image()
            ret_points, points = capture.get_pointcloud()
        return color_image, depth_image, points

    def capture_new_background(self):
        logging.info("Please make sure the scene is empty.")
        self.countdown(5, message="Capturing background in")
        _, _, points = self.capture_frame()
        background = PointCloud(points)
        save_path = f"{self.base_dir}/background/box.ply"
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        save_point_cloud(save_path, background)
        logging.info(f"Background point cloud captured and saved to {save_path}")
        logging.info("Please put the object in the Box.")
        self.countdown(5, message="Capturing object in")
        return background

    def countdown(self, seconds, message=""):
        for i in range(seconds, 0, -1):
            print(f"{message} {i} seconds...")
            time.sleep(1)
        print("Capturing now...")

    def save_intrinsics(self, save_dir):
        intrinsics = {
            "depth": {"fx": self.depth_K[0][0], "fy": self.depth_K[1][1],
                      "cx": self.depth_K[0][2], "cy": self.depth_K[1][2],
                      "width": self.depth_W, "height": self.depth_H},
            "color": {"fx": self.color_K[0][0], "fy": self.color_K[1][1],
                      "cx": self.color_K[0][2], "cy": self.color_K[1][2],
                      "width": self.color_W, "height": self.color_H},
        }
        path = os.path.join(save_dir, "camera_intrinsics.json")
        with open(path, "w") as f:
            json.dump(intrinsics, f, indent=4)
        logging.info(f"Intrinsic parameters saved to {path}")

    def save_frame(self, color_image, depth_image, point_cloud, save_dir, frame_id):
        """rgb_<id>.png (the BGR(A) frame as an RGB PNG, alpha dropped),
        depth_<id>.png (16-bit mm) and cloud_<id>.ply in @save_dir."""
        write_color_png(os.path.join(save_dir, f"rgb_{frame_id:03d}.png"), color_image)
        write_png_gray16(os.path.join(save_dir, f"depth_{frame_id:03d}.png"),
                         np.asarray(depth_image))
        save_point_cloud(os.path.join(save_dir, f"cloud_{frame_id:03d}.ply"),
                         PointCloud(point_cloud))


class YcbineoatReader(KinectReader):
    """The live reader with a Gaussian heatmap at the frame's centre in
    place of heatmap/0002.npy."""

    def get_heatmap(self, color, max_intensity=1.0, sigma=50):
        from ..app.defect_projection import generate_centered_heatmap

        return generate_centered_heatmap(color.shape[:2], max_intensity, sigma)
