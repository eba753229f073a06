"""PNG decoding with numpy and zlib, standing in for ``cv2.imread(path, -1)``
and ``cv2.imread(path, cv2.IMREAD_COLOR)``, and a minimal writer of 8-bit
greyscale, RGB and RGBA and 16-bit greyscale images (what ``cv2.imwrite``
writes for a mask, an overlay, a debug drawing or a depth frame).

Decodes every PNG: greyscale at 1, 2, 4, 8 and 16 bits (the
low depths scaled to 0..255), RGB, RGBA and grey+alpha at 8 and 16 bits,
and palette images at 1-8 bits, with a `tRNS` chunk turning palette and RGB
images into BGRA (a grey image's `tRNS` is ignored), as OpenCV's libpng
reader does, Adam7-interlaced or not.  The row filters are undone in C
(`csrc/png_unfilter.c`, built with the system C compiler at first use;
without one, decoding raises).  `read_png` returns what OpenCV returns for
``IMREAD_UNCHANGED``: (H,W) grey, (H,W,3) BGR, or (H,W,4) BGRA, uint8 or
uint16.

PNGs held in memory (the H5 pose-pair layout keeps them as byte blobs,
`io/h5_dataset.py`) go through `encode_png` and `decode_png`, which follow
``imageio.v2`` instead: RGB(A) in the file's channel order.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..kernels.build import KernelLibrary

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _bind(lib):
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.png_unfilter.restype = ctypes.c_int


# the row filters run in C (csrc/png_unfilter.c), built on first use
LIBRARY = KernelLibrary("png_unfilter", _bind, ext=".c")


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters; @raw holds h rows of 1 + stride bytes."""
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((h, stride), dtype=np.uint8)
    rc = LIBRARY.load().png_unfilter(src.ctypes.data, out.ctypes.data, h, stride, bpp)
    if rc:
        raise ValueError(f"bad PNG filter type {raw[(rc - 1) * (stride + 1)]}")
    return out


def _chunks(path, data):
    """The IHDR fields, the joined IDAT bodies, PLTE and tRNS of a PNG."""
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return ihdr, b"".join(idat), plte, trns


def _samples(rows, width, bit_depth, ch):
    """(H, W, ch) samples of the unfiltered rows: bytes, big-endian 16-bit
    words, or 1/2/4-bit fields unpacked most significant first."""
    h = rows.shape[0]
    if bit_depth == 16:
        words = rows.reshape(h, width * ch, 2).astype(np.uint16)
        return ((words[..., 0] << 8) | words[..., 1]).reshape(h, width, ch)
    if bit_depth == 8:
        return rows.reshape(h, width, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, bit_depth)
    weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :width, None]


# the seven Adam7 passes: first column and row, column and row steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _deinterlace(raw, width, height, bit_depth, ch, bpp):
    """The (H, W, ch) samples of Adam7-interlaced image data: each pass a
    small image of its own (its rows filtered apart from the other passes'),
    scattered to its pixels of the whole."""
    img = np.zeros((height, width, ch), np.uint16 if bit_depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no rows, not even filter bytes
        stride = (pw * ch * bit_depth + 7) // 8
        size = ph * (stride + 1)
        img[y0::dy, x0::dx] = _samples(_unfilter(raw[pos:pos + size], ph, stride, bpp), pw,
                                       bit_depth, ch)
        pos += size
    return img


def _decode(name, data):
    """The samples of the PNG bytes @data in the file's channel order, a
    palette expanded to RGB (RGBA with a `tRNS` chunk); returns (image
    (H,W,ch), colour type, bit depth, the tRNS body or None)."""
    (width, height, bit_depth, color_type, _, _, interlace), idat, plte, trns = \
        _chunks(name, data)
    if bit_depth not in _DEPTHS.get(color_type, ()):
        raise ValueError(f"{name}: invalid PNG colour type {color_type} at bit depth "
                         f"{bit_depth}")
    ch = _CHANNELS[color_type]
    bpp = max(1, ch * bit_depth // 8)
    raw = zlib.decompress(idat)
    if interlace:
        img = _deinterlace(raw, width, height, bit_depth, ch, bpp)
    else:
        stride = (width * ch * bit_depth + 7) // 8
        img = _samples(_unfilter(raw, height, stride, bpp), width, bit_depth, ch)
    if color_type == 3:  # palette -> RGB(A), entries past PLTE's end black
        if plte is None:
            raise ValueError(f"{name}: a palette PNG without a PLTE chunk")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        pal = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)[:256]
        table[: len(pal), :3] = pal
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[: len(alpha), 3] = alpha
        img = table[img[..., 0]][..., : 4 if trns is not None else 3]
    return img, color_type, bit_depth, trns


def read_png(path):
    """Decode a PNG file as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does."""
    with open(path, "rb") as f:
        data = f.read()
    img, color_type, bit_depth, trns = _decode(path, data)
    if color_type == 0:
        img = img[..., 0]
        if bit_depth < 8:
            img = img * np.uint8(255 // ((1 << bit_depth) - 1))
        return img
    elif color_type == 4:  # grey + alpha -> BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    elif color_type == 2 and trns is not None:  # the tRNS colour key -> alpha
        key = np.array(struct.unpack(">HHH", trns[:6]), dtype=img.dtype)
        top = np.iinfo(img.dtype).max
        alpha = np.where((img == key).all(axis=-1), 0, top).astype(img.dtype)
        img = np.concatenate([img, alpha[..., None]], axis=-1)
    if img.shape[-1] == 3:
        return np.ascontiguousarray(img[..., ::-1])  # RGB -> BGR
    return np.ascontiguousarray(img[..., [2, 1, 0, 3]])  # RGBA -> BGRA


def decode_png(data):
    """Decode PNG bytes in memory as ``imageio.v2.imread`` does for the
    kinds `encode_png` writes: (H,W) grey (uint8, or uint16 for 16-bit),
    (H,W,3) RGB, (H,W,4) RGBA, (H,W,2) grey+alpha, palettes expanded to
    RGB(A); channels in the file's order, not OpenCV's BGR."""
    img, color_type, bit_depth, _ = _decode("PNG bytes", bytes(data))
    if bit_depth < 8 and color_type != 3:
        raise NotImplementedError(f"a {bit_depth}-bit PNG: in memory, 8- and 16-bit "
                                  "samples are decoded")
    if color_type == 0:
        return np.ascontiguousarray(img[..., 0])
    return np.ascontiguousarray(img)


def read_png_color(path):
    """Decode a PNG file as ``cv2.imread(path, cv2.IMREAD_COLOR)`` does:
    (H,W,3) uint8 BGR, grey replicated, alpha dropped, 16-bit samples
    shifted down to their high byte."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _png_bytes(w, h, bit_depth, color_type, rows):
    """A PNG of @rows (each a filter byte and the row), deflated at zlib
    level 1, OpenCV's default for PNG."""
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def encode_png(img):
    """PNG bytes of an image, no row filter: (H,W) uint8 or uint16 grey,
    (H,W,2) uint8 grey+alpha, (H,W,3) uint8 RGB or (H,W,4) uint8 RGBA,
    channels in that order (what ``imageio.v2.imwrite`` writes for the same
    array, and `decode_png` reads back)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2 and img.dtype == np.uint16:
        h, w = img.shape
        rows = np.zeros((h, 2 * w + 1), dtype=np.uint8)  # filter type 0 before each row
        rows[:, 1:] = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
        return _png_bytes(w, h, 16, 0, rows)
    color_type = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if img.dtype != np.uint8 or color_type is None:
        raise ValueError(f"expected a (H,W) uint8/uint16 or (H,W,2|3|4) uint8 image, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    stride = w * _CHANNELS[color_type]
    rows = np.zeros((h, stride + 1), dtype=np.uint8)
    rows[:, 1:] = img.reshape(h, stride)
    return _png_bytes(w, h, 8, color_type, rows)


def _write(path, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_png_gray16(path, img):
    """Write a (H,W) uint16 image as a 16-bit greyscale PNG (a depth frame in
    millimetres, as ``cv2.imwrite`` writes one)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError(f"expected a (H,W) uint16 image, got {img.shape} {img.dtype}")
    _write(path, img)


def write_png_gray8(path, img):
    """Write a (H,W) uint8 image as an 8-bit greyscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a (H,W) uint8 image, got {img.shape} {img.dtype}")
    _write(path, img)


def write_png_rgb8(path, img):
    """Write a (H,W,3) RGB or (H,W,4) RGBA uint8 image as an 8-bit PNG in
    that channel order (``cv2.imwrite`` of the array reversed to BGR)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError(f"expected a (H,W,3|4) uint8 image, got {img.shape} {img.dtype}")
    _write(path, img)
