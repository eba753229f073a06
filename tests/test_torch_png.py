"""The port's PNG decoder (`sixdof_tpu_torch/io/png.py`) against OpenCV:
every row filter type, on every row, in every supported format, and the
Average and Paeth filters at the speed of the others (they run in C)."""
import os
import struct
import time
import zlib

import cv2
import numpy as np
import pytest

from sixdof_tpu_torch.io import png
from sixdof_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = os.path.join(REPO, "demo_data", "synth_box", "rgb", "rgb_0000.png")
# a frame filtered with Paeth on every row may take at most this many times
# as long to decode as the same frame filtered with Sub (the calling
# thread's CPU time; the byte-by-byte Python filters took 25-60x)
MAX_PAETH_OVER_SUB = 3.0
DECODES = 10  # of each filter, in turns; the best of each is compared


def _encode(img, bit_depth, color_type, ftype):
    """A PNG of @img with row filter @ftype on every row."""
    h, w = img.shape[:2]
    raw = img.astype(">u2").tobytes() if bit_depth == 16 else img.astype(np.uint8).tobytes()
    stride = len(raw) // h
    bpp = stride // w
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int32)
    prev = np.vstack([np.zeros((1, stride), np.int32), rows[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), prev[:, :-bpp]])
    if ftype == 0:
        enc = rows
    elif ftype == 1:
        enc = rows - left
    elif ftype == 2:
        enc = rows - prev
    elif ftype == 3:
        enc = rows - (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        enc = rows - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    body = np.hstack([np.full((h, 1), ftype, np.int32), enc & 0xFF]).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(body))
            + chunk(b"IEND", b""))


KINDS = {"gray8": ((), 8, 0), "rgb8": ((3,), 8, 2), "rgba8": ((4,), 8, 6),
         "gray16": ((), 16, 0)}


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_each_filter_matches_opencv(tmp_path, kind, ftype):
    chans, bd, ct = KINDS[kind]
    rng = np.random.RandomState(17 * ftype + len(kind))
    # smooth ramps plus noise, so the predictors see both flat and busy rows
    h, w = 23, 37
    ramp = np.add.outer(np.arange(h) * 7, np.arange(w) * 3)
    ramp = ramp.reshape(h, w, *([1] * len(chans))) * (1 + np.arange(chans[0] if chans else 1))
    img = (ramp + rng.randint(0, 40, (h, w, *chans))) % (1 << bd)
    path = tmp_path / f"{kind}_{ftype}.png"
    path.write_bytes(_encode(img, bd, ct, ftype))
    ref = cv2.imread(str(path), -1)
    got = png.read_png(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_bad_filter_type_raises(tmp_path):
    data = bytearray(_encode(np.zeros((3, 5), np.uint8), 8, 0, 0))
    body = bytearray(zlib.decompress(bytes(data[8 + 25 + 8:-12 - 4])))
    body[6] = 7  # row 1's filter byte
    comp = zlib.compress(bytes(body))
    head = bytes(data[:8 + 25])
    idat = struct.pack(">I", len(comp)) + b"IDAT" + comp + struct.pack(
        ">I", zlib.crc32(b"IDAT" + comp) & 0xFFFFFFFF)
    path = tmp_path / "bad.png"
    path.write_bytes(head + idat + bytes(data[-12:]))
    with pytest.raises(ValueError, match="filter type 7"):
        png.read_png(str(path))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    path = tmp_path / "g.png"
    path.write_bytes(_encode(np.zeros((2, 3), np.uint8), 8, 0, 4))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(png.LIBRARY, "lib", None)
    with pytest.raises(RuntimeError, match="C compiler"):
        png.read_png(str(path))


def test_paeth_decodes_as_fast_as_sub(tmp_path):
    """A 640x480 colour frame filtered with Paeth on every row decodes in at
    most MAX_PAETH_OVER_SUB times the time of the same frame with Sub.

    Each decode is timed as the CPU time of the calling thread, which runs
    both zlib and the C routine, so time the process spends waiting for a
    core under load is not counted; the two filters are decoded in turns,
    so a burst of load hits both, and the best of DECODES of each is kept."""
    img = cv2.imread(FRAME, -1)[..., ::-1]  # BGR -> RGB rows as the file stores them
    assert img.shape == (480, 640, 3)
    paths = {}
    for ftype in (1, 4):
        paths[ftype] = str(tmp_path / f"f{ftype}.png")
        with open(paths[ftype], "wb") as f:
            f.write(_encode(img, 8, 2, ftype))
        np.testing.assert_array_equal(png.read_png(paths[ftype]), cv2.imread(paths[ftype], -1))
    times = dict.fromkeys(paths, float("inf"))
    for _ in range(DECODES):
        for ftype, path in paths.items():
            t0 = time.thread_time()
            png.read_png(path)
            times[ftype] = min(times[ftype], time.thread_time() - t0)
    assert times[4] <= MAX_PAETH_OVER_SUB * times[1], times
