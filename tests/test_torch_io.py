"""Host IO of the port: PNG decoding against OpenCV, the scene reader and
mesh loading against the JAX package."""
import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from sixdof_tpu.io import mesh_io as jm
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu.ops.pointcloud import voxel_down_sample as j_voxel
from sixdof_tpu_torch.io import mesh_io as tm
from sixdof_tpu_torch.io.png import read_png
from sixdof_tpu_torch.io.readers import DataReader as TReader
from sixdof_tpu_torch.io.readers import resize_nearest
from sixdof_tpu_torch.ops.pointcloud import voxel_down_sample as t_voxel

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")


def test_png_matches_opencv_on_demo_scene():
    files = sorted(glob.glob(os.path.join(SCENE, "**", "*.png"), recursive=True))
    assert len(files) >= 13
    for f in files:
        ref = cv2.imread(f, -1)
        got = read_png(f)
        assert got.dtype == ref.dtype and got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


def _encode_png(img, bit_depth, color_type, filters):
    """A PNG whose row i uses filter filters[i % len]: every filter type runs."""
    h, w = img.shape[:2]
    raw = img.astype(">u2").tobytes() if bit_depth == 16 else img.astype(np.uint8).tobytes()
    stride = len(raw) // h
    bpp = max(1, stride // w)
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int32)
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(f)
        out += (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_all_filters_match_opencv(tmp_path, rng, kind):
    h, w = 13, 17
    if kind == "gray16":
        img, bd, ct = rng.randint(0, 65536, (h, w)), 16, 0
    elif kind == "gray8":
        img, bd, ct = rng.randint(0, 256, (h, w)), 8, 0
    elif kind == "rgb8":
        img, bd, ct = rng.randint(0, 256, (h, w, 3)), 8, 2
    else:
        img, bd, ct = rng.randint(0, 256, (h, w, 4)), 8, 6
    path = tmp_path / f"{kind}.png"
    path.write_bytes(_encode_png(img, bd, ct, [0, 1, 2, 3, 4]))
    ref = cv2.imread(str(path), -1)
    got = read_png(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


class _Args:
    debug = 0
    box = None
    mesh = None
    voxel_size = None


@pytest.mark.parametrize("shorter_side", [None, 240])
def test_reader_matches_jax(shorter_side):
    jr = JReader(base_dir=SCENE, shorter_side=shorter_side, arguments=_Args())
    tr = TReader(SCENE, shorter_side=shorter_side)
    assert (tr.color_H, tr.color_W) == (jr.color_H, jr.color_W)
    assert len(tr) == len(jr) and tr.id_strs == jr.id_strs
    np.testing.assert_array_equal(tr.color_K, np.asarray(jr.color_K, dtype=np.float64))
    for i in (0, 3):
        np.testing.assert_array_equal(tr.get_color(i), jr.get_color(i))
        d_t, d_j = tr.get_depth(i), jr.get_depth(i)
        assert d_t.dtype == d_j.dtype
        np.testing.assert_array_equal(d_t, d_j)
        np.testing.assert_array_equal(tr.get_gt_pose(i), jr.get_gt_pose(i))
    c = jr.get_color(0)
    np.testing.assert_array_equal(tr.get_mask(c, 0), jr.get_mask(c, 0))


@pytest.mark.parametrize("size", [(240, 320), (100, 133), (700, 900)])
def test_resize_nearest_matches_opencv(rng, size):
    img = rng.randint(0, 65535, (480, 640)).astype(np.uint16)
    ref = cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(img, size[1], size[0]), ref)


def test_mesh_and_cloud_loading_match_jax():
    for name in ("model_scaled_down.obj", "model.obj"):
        path = os.path.join(SCENE, "mesh", name)
        a, b = jm.load_mesh(path), tm.load_mesh(path)
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)
        if a.vertex_colors is None:
            assert b.vertex_colors is None
        else:
            np.testing.assert_array_equal(b.vertex_colors, a.vertex_colors)
        np.testing.assert_allclose(b.vertex_normals, a.vertex_normals, atol=1e-12)
        assert b.is_watertight() == a.is_watertight()
        assert b.signed_volume() == a.signed_volume()
        pa, pb = a.sample_points(500, seed=3), b.sample_points(500, seed=3)
        np.testing.assert_array_equal(pb.points, pa.points)
        np.testing.assert_array_equal(pb.normals, pa.normals)
    for cloud in (os.path.join(SCENE, "pcd", "cloud_0000.ply"),
                  os.path.join(SCENE, "mesh", "model.ply")):
        ca, cb = jm.load_point_cloud(cloud), tm.load_point_cloud(cloud)
        np.testing.assert_array_equal(cb.points, ca.points)
        for attr in ("colors", "normals"):
            if getattr(ca, attr) is None:
                assert getattr(cb, attr) is None
            else:
                np.testing.assert_array_equal(getattr(cb, attr), getattr(ca, attr))
    va = j_voxel(jm.PointCloud(ca.points, normals=ca.points), 5.0)
    vb = t_voxel(tm.PointCloud(cb.points, normals=cb.points), 5.0)
    np.testing.assert_array_equal(vb.points, va.points)
    np.testing.assert_array_equal(vb.normals, va.normals)
