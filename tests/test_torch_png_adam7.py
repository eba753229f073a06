"""Adam7-interlaced PNGs in the port's decoder (`sixdof_tpu_torch/io/png.py`):
each kind, written here by a small interlacer (the seven passes, each row
filtered None, Sub or Up against its own pass), decodes bit-equal to
``cv2.imread`` (``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``) and, as a
texture, to PIL's ``convert("RGB")``; sizes include passes that are empty."""
import struct
import zlib

import numpy as np
import pytest

from sixdof_tpu_torch.io import png
from sixdof_tpu_torch.io.mesh_io import _read_texture

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# kind: (bit depth, colour type, samples per pixel)
KINDS = {"gray1": (1, 0, 1), "gray2": (2, 0, 1), "gray8": (8, 0, 1), "gray16": (16, 0, 1),
         "rgb8": (8, 2, 3), "rgb16": (16, 2, 3), "rgba8": (8, 6, 4), "gray_alpha8": (8, 4, 2),
         "palette4_trns": (4, 3, 1), "palette8": (8, 3, 1)}


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _pack_rows(samples, bit_depth):
    """(h, w, c) samples as h packed rows of bytes."""
    h, w = samples.shape[:2]
    if bit_depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if bit_depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = (samples.reshape(h, w, 1) >> np.arange(bit_depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filtered(rows, bpp):
    """Each row with a filter byte: None, Sub and Up in turn."""
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for i, row in enumerate(rows):
        kind = i % 3
        if kind == 1:
            left = np.concatenate([np.zeros(bpp, np.uint8), row[:-bpp]])[:len(row)]
            body = row - left
        elif kind == 2:
            body = row - prev
        else:
            body = row
        out.append(np.concatenate([[kind], body]).astype(np.uint8))
        prev = row
    return b"".join(r.tobytes() for r in out)


def _adam7_png(path, samples, bit_depth, color_type, extra=b""):
    h, w, c = samples.shape
    bpp = max(1, c * bit_depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_pack_rows(sub, bit_depth), bpp)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (13, 21), (23, 37)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_adam7_decodes_as_opencv_and_pil(tmp_path, kind, shape):
    bit_depth, color_type, c = KINDS[kind]
    rng = np.random.RandomState(list(KINDS).index(kind) * 7 + shape[0])
    extra = b""
    if color_type == 3:
        n = 1 << bit_depth
        samples = rng.randint(0, n, shape + (1,))
        extra = _chunk(b"PLTE", rng.randint(0, 256, (n, 3)).astype(np.uint8).tobytes())
        if kind.endswith("trns"):
            extra += _chunk(b"tRNS", rng.randint(0, 256, n // 2).astype(np.uint8).tobytes())
    else:
        samples = rng.randint(0, 1 << bit_depth, shape + (c,))
    path = str(tmp_path / f"{kind}.png")
    _adam7_png(path, samples, bit_depth, color_type, extra)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(png.read_png_color(path), cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(_read_texture(path),
                                  np.array(Image.open(path).convert("RGB")))
