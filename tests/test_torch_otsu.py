"""The Otsu auto-mask (`sixdof_tpu_torch/io/readers.py::otsu_mask`, used by
`DataReader.get_mask` when masks/0000.png is missing) against the JAX
reader's cv2 pipeline: grey conversion, Otsu threshold, inversion, 3x3 open
and close of 2 iterations, nearest resize, and the mask written back as a
PNG (`io/png.py::write_png_gray8`).  Bit-equal throughout (tolerance 0)."""
import os

import cv2
import numpy as np
import pytest
import torch

from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu_torch.io.png import read_png, write_png_gray8
from sixdof_tpu_torch.io.readers import DataReader, bgr_to_gray, otsu_mask, otsu_threshold

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_data")
SCENES = sorted(d for d in os.listdir(DEMO) if os.path.isdir(os.path.join(DEMO, d, "rgb")))


def _cv2_mask(color):
    """The JAX reader's auto-mask, line for line (sixdof_tpu/io/readers.py)."""
    gray = cv2.cvtColor(color, cv2.COLOR_BGR2GRAY)
    _, binary = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    refined = cv2.bitwise_not(binary)
    kernel = np.ones((3, 3), np.uint8)
    refined = cv2.morphologyEx(refined, cv2.MORPH_OPEN, kernel, iterations=2)
    return cv2.morphologyEx(refined, cv2.MORPH_CLOSE, kernel, iterations=2)


def _scene_without_mask(src, dst):
    """@dst: the scene @src by symlinks, without its masks/ directory."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name != "masks":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


class _Args:
    debug = 0
    box = mesh = voxel_size = None


@pytest.mark.parametrize("scene", SCENES)
def test_auto_mask_matches_jax_reader_on_demo_scene(tmp_path, scene):
    src = os.path.join(DEMO, scene)
    ours = DataReader(_scene_without_mask(src, tmp_path / "port"))
    theirs = JReader(_scene_without_mask(src, tmp_path / "jax"), arguments=_Args())
    color = ours.get_color(0)
    assert np.array_equal(color, theirs.get_color(0))
    got, want = ours.get_mask(color, 0), theirs.get_mask(theirs.get_color(0), 0)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert 0 < got.sum() < got.size
    # the written masks: ours decodes (io/png.py and cv2) to the JAX file's pixels
    ours_png = str(tmp_path / "port" / "masks" / "0000.png")
    theirs_png = str(tmp_path / "jax" / "masks" / "0000.png")
    assert np.array_equal(read_png(ours_png), cv2.imread(theirs_png, -1))
    assert np.array_equal(cv2.imread(ours_png, -1), read_png(theirs_png))
    # the second read takes the written file
    assert np.array_equal(ours.get_mask(color, 0), want)


def _seeded_images():
    rng = np.random.RandomState(0)
    out = [rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),  # uniform noise
           np.full((16, 16, 3), 77, np.uint8)]  # one grey level: no split
    two = np.zeros((40, 30, 3), np.uint8)
    two[:, 15:] = 200  # two equal classes: a flat plateau of maxima (first wins)
    out.append(two)
    for k in range(6):  # bimodal scenes with a blob, noise and odd sizes
        h, w = rng.randint(20, 90, 2)
        img = rng.normal(60 + 20 * k, 15, (h, w, 3))
        yy, xx = np.mgrid[:h, :w]
        blob = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 3) ** 2
        img[blob] += rng.uniform(60, 120, 3)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    three = np.zeros((9, 12, 3), np.uint8)
    three[:, 4:8], three[:, 8:] = (10, 80, 200), (255, 255, 255)  # three levels, channels differ
    out.append(three)
    return out


@pytest.mark.parametrize("k", range(len(_seeded_images())))
def test_auto_mask_matches_cv2_on_seeded_images(k):
    img = _seeded_images()[k]
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert np.array_equal(bgr_to_gray(img), gray)
    thresh, _ = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    assert otsu_threshold(gray) == thresh
    assert np.array_equal(otsu_mask(img), _cv2_mask(img))


def test_gray_conversion_every_value():
    """Every one of the 256^3 colours."""
    v = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), axis=-1).reshape(4096, 4096, 3)
    assert np.array_equal(bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (480, 640)])
def test_png_writer_round_trip(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "m.png")
    write_png_gray8(path, img)
    assert np.array_equal(read_png(path), img)
    assert np.array_equal(cv2.imread(path, -1), img)
    with pytest.raises(ValueError):
        write_png_gray8(path, img.astype(np.uint16))
