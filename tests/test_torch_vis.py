"""The port's images against the JAX package's: OpenCV's INTER_AREA resize
(`io/readers.py::resize_area`), the reader's 4-tuple `get_heatmap`, the
RGB/RGBA PNG writer, the heatmap overlay and its file, and the debug
drawings of `utils/vis.py`.

Tolerances: the resizes, `get_heatmap`'s colour crop, the overlay, the
overlay's file, `make_grid_image` and `depth_to_vis` are bit-equal (0);
a heatmap that `get_heatmap` resamples agrees to 5e-7 (OpenCV's
INTER_LINEAR sums in another order).
The drawings are OpenCV's anti-aliased thick lines redrawn from the
distance to the segment: of the pixels OpenCV changes by more than 64 in a
channel, at least 95% are changed by the port, and no pixel the port
changes lies more than 1 px (3x3 neighbourhood) from one OpenCV changes;
of the pixels OpenCV paints a pure red, green or blue, the port paints 95%
alike (the anti-aliased rims differ)."""
import os

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from sixdof_tpu.app import defect_projection as jdp
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu.utils import vis as jvis
from sixdof_tpu_torch.app import defect_projection as tdp
from sixdof_tpu_torch.app.run import oriented_bounds
from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.io.png import read_png, write_png_rgb8
from sixdof_tpu_torch.io.readers import DataReader, resize_area, resize_nearest
from sixdof_tpu_torch.utils import vis as tvis

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
RESAMPLE_ATOL = 5e-7  # as tests/test_torch_defect_projection.py
STRONG = 64  # a channel change OpenCV's line surely made
COVERED = 0.95  # the share of those the port must change too
PURE = 0.95  # the share of OpenCV's pure-colour line pixels the port paints alike


@pytest.mark.parametrize("shape", [
    (480, 640, 3, 240, 320),  # whole 2x2 blocks
    (480, 640, 3, 120, 160),  # whole 4x4 blocks
    (480, 640, 3, 288, 384),  # area weights
    (97, 61, 4, 40, 25),
    (50, 70, 1, 17, 23),
    (120, 160, 3, 480, 640),  # enlarging: OpenCV's bilinear emulation
    (123, 164, 3, 480, 640),
    (7, 9, 3, 20, 31),
    (40, 30, 3, 20, 90),  # one axis each way
])
def test_resize_area_matches_opencv(shape):
    h, w, c, H, W = shape
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, c)).astype(np.uint8)
    if c == 1:
        img = img[..., 0]
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    got = resize_area(img, W, H)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(480, 480), (476, 476), (20, 7)])
def test_resize_nearest_of_colour_matches_opencv(size):
    img = np.random.RandomState(1).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_nearest(img, size[1], size[0]),
                                  cv2.resize(img, (size[1], size[0]),
                                             interpolation=cv2.INTER_NEAREST))


def _scene_with_heatmap(tmp_path, size):
    """synth_box by symlinks, with a seeded heatmap of side @size."""
    dst = tmp_path / f"scene{size}"
    dst.mkdir()
    for name in os.listdir(SCENE):
        if name != "heatmap":
            os.symlink(os.path.join(SCENE, name), dst / name)
    (dst / "heatmap").mkdir()
    hm = np.random.RandomState(size).rand(size, size).astype(np.float32)
    np.save(dst / "heatmap" / "0002.npy", hm)
    return str(dst)


@pytest.mark.parametrize("heatmap_size,shorter_side", [(240, None), (300, None), (300, 240)])
def test_get_heatmap_four_tuple_at_other_heatmap_scales(tmp_path, heatmap_size, shorter_side):
    """The colour crop at heatmap scales 0.5 (2x2 blocks), 0.625 (area
    weights) and 1.25 (enlarging) is bit-equal to JAX's.  These heatmaps
    are resampled to 480x480, where OpenCV's INTER_LINEAR agrees to 2
    float32 ulps (ROADMAP.md section 3; tests/test_torch_defect_projection.py's
    RESAMPLE_ATOL), with the same pixels above the app's 0.75."""
    scene = _scene_with_heatmap(tmp_path, heatmap_size)
    jr, tr = JReader(scene, shorter_side=shorter_side), DataReader(scene,
                                                                   shorter_side=shorter_side)
    want = jr.get_heatmap(jr.get_color(0))
    got = tr.get_heatmap(tr.get_color(0))
    assert len(got) == 4 and got[3] is got[1]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(got[1], want[1])  # the colour crop
    for k in (0, 2):  # the heatmap, on its canvas and alone
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RESAMPLE_ATOL)
        np.testing.assert_array_equal(got[k] > 0.75, want[k] > 0.75)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_rgb_writer_reads_back(tmp_path, channels):
    img = np.random.RandomState(channels).randint(0, 256, (13, 29, channels)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png_rgb8(path, img)
    back = read_png(path)
    np.testing.assert_array_equal(back, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    order = [2, 1, 0] if channels == 3 else [2, 1, 0, 3]  # both decode to BGR(A)
    np.testing.assert_array_equal(back, img[..., order])
    with pytest.raises(ValueError):
        write_png_rgb8(path, img[..., 0])


def test_overlay_and_its_file_match_jax(tmp_path):
    jr, tr = JReader(SCENE), DataReader(SCENE)
    _, col_j, vis_j, _ = jr.get_heatmap(jr.get_color(2))
    _, col_t, vis_t, _ = tr.get_heatmap(tr.get_color(2))
    ov_j = jdp.create_heatmap_overlay(col_j, vis_j)
    ov_t = tdp.create_heatmap_overlay(col_t, vis_t)
    np.testing.assert_array_equal(ov_t, ov_j)
    jdp.save_overlay(ov_j, str(tmp_path / "jax.png"))
    tdp.save_overlay(ov_t, str(tmp_path / "sub" / "port.png"))  # makes its directory
    assert os.listdir(tmp_path / "sub") == ["port.png"]  # no temporary left behind
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "sub" / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))
    # grey and RGBA inputs blend as in the JAX package
    for img in (col_t[..., 0], np.concatenate([col_t, col_t[..., :1]], axis=-1)):
        np.testing.assert_array_equal(tdp.create_heatmap_overlay(img, vis_t),
                                      jdp.create_heatmap_overlay(img, vis_j))


def test_grid_and_depth_vis_match_jax():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (11, 9, 3)).astype(np.uint8) for _ in range(5)]
    imgs.append(rng.randint(0, 256, (7, 12)).astype(np.uint8))
    for nrow in (1, 2, 4):
        np.testing.assert_array_equal(tvis.make_grid_image(imgs, nrow),
                                      jvis.make_grid_image(imgs, nrow))
    depth = DataReader(SCENE).get_depth(0)
    for kw in (dict(), dict(mode="gray"), dict(inverse=False, zmin=0.3, zmax=0.8),
               dict(inverse=False, mode="gray")):
        np.testing.assert_array_equal(tvis.depth_to_vis(depth, **kw),
                                      jvis.depth_to_vis(depth, **kw))


def _changed(a, b):
    return np.abs(a.astype(int) - b.astype(int)).max(axis=-1)


def test_drawings_match_opencv_within_a_pixel():
    """The box and axes of the JAX app's --debug 1 on every synth_box frame,
    at the annotated pose and at three seeded offsets from it."""
    reader = DataReader(SCENE)
    to_origin, extents = oriented_bounds(load_mesh(os.path.join(SCENE, "mesh",
                                                                "model_scaled_down.obj")))
    bbox = np.stack([-extents / 2, extents / 2], axis=0).reshape(2, 3)
    rng = np.random.RandomState(0)
    K = reader.color_K
    for i in range(len(reader)):
        color = reader.get_color(i)
        for trial in range(4):
            pose = reader.get_gt_pose(i).copy()
            if trial:
                pose[:3, 3] += rng.uniform(-0.1, 0.1, 3)
            c = pose @ np.linalg.inv(to_origin)
            out = []
            for m in (jvis, tvis):
                v = m.draw_posed_3d_box(K, img=color.copy(), ob_in_cam=c, bbox=bbox)
                out.append(m.draw_xyz_axis(v, ob_in_cam=c, scale=0.1, K=K, thickness=3,
                                           transparency=0, is_input_rgb=True))
            want, got = (_changed(x, color) for x in out)
            strong = want > STRONG
            assert strong.sum() > 500
            assert (strong & (got > 0)).sum() >= COVERED * strong.sum(), (i, trial)
            near = ndimage.binary_dilation(want > 0, np.ones((3, 3), bool))
            assert not ((got > 0) & ~near).any(), (i, trial)
            # the colours: where OpenCV paints a pure red, green or blue (the
            # box green, the axes red, green and blue), so does the port
            for pure in np.eye(3, dtype=np.uint8) * 255:
                at = (out[0] == pure).all(axis=-1) & (want > 0)
                assert (out[1][at] == pure).all(axis=-1).mean() >= PURE, (i, trial, pure)


def test_drawings_in_bgr_and_off_the_image():
    """BGR input swaps the axis colours as OpenCV's does; a pose behind the
    camera or far off the image draws without error."""
    img = np.zeros((60, 80, 3), np.uint8)
    K = np.array([[50.0, 0, 40], [0, 50.0, 30], [0, 0, 1]])
    pose = np.eye(4)
    pose[2, 3] = 1.0
    a = tvis.draw_xyz_axis(img, pose, scale=0.3, K=K, is_input_rgb=False)
    b = jvis.draw_xyz_axis(img, pose, scale=0.3, K=K, is_input_rgb=False)
    x_axis = (slice(29, 32), slice(50, 54))  # along +x from the centre
    assert a[x_axis].max(axis=(0, 1)).tolist() == b[x_axis].max(axis=(0, 1)).tolist() \
        == [0, 0, 255]
    for z in (-1.0, 1e-9, 1e3):
        pose[2, 3] = z
        pose[0, 3] = 5.0
        out = tvis.draw_posed_3d_box(K, img.copy(), pose, np.array([[-1, -1, -1], [1, 1, 1.0]]))
        assert out.shape == img.shape and out.dtype == np.uint8
