"""PNG decoding with numpy and zlib, standing in for ``cv2.imread(path, -1)``,
and a minimal writer of 8-bit greyscale, RGB and RGBA images (what
``cv2.imwrite`` writes for a mask, an overlay or a debug drawing).

Supports 8-bit gray, RGB and RGBA and 16-bit gray, non-interlaced, with
all five row filters (the demo scenes use 8-bit RGB, 8-bit gray and 16-bit
gray).  The row filters are undone in C (`csrc/png_unfilter.c`, built with
the system C compiler at first use; without one, decoding raises).  Returns
what OpenCV returns for ``IMREAD_UNCHANGED``: (H,W) for gray, (H,W,3) BGR
for RGB, (H,W,4) BGRA for RGBA; uint8 or uint16.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..kernels.build import KernelLibrary

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


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


def read_png(path):
    """Decode a PNG file as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    width = height = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if interlace:
                raise NotImplementedError(f"{path}: interlaced PNG")
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if color_type not in _CHANNELS or bit_depth not in (8, 16) \
            or (bit_depth == 16 and color_type != 0):
        raise NotImplementedError(f"{path}: colour type {color_type}, bit depth {bit_depth}")
    ch = _CHANNELS[color_type]
    bpp = ch * bit_depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    img = _unfilter(raw, height, stride, bpp)
    if bit_depth == 16:
        img = img.reshape(height, width * ch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1].astype(np.uint16)
    img = img.reshape(height, width, ch)
    if ch == 1:
        return img[..., 0]
    if ch == 3:
        return np.ascontiguousarray(img[..., ::-1])  # RGB -> BGR
    return np.ascontiguousarray(img[..., [2, 1, 0, 3]])  # RGBA -> BGRA


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _write_png8(path, img, color_type):
    """Write an 8-bit image (no row filter; colour type 0, 2 or 6), deflated
    at zlib level 1, OpenCV's default for PNG."""
    h, w = img.shape[:2]
    stride = w * _CHANNELS[color_type]
    rows = np.zeros((h, stride + 1), dtype=np.uint8)  # filter type 0 before each row
    rows[:, 1:] = img.reshape(h, stride)
    data = (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def write_png_gray8(path, img):
    """Write a (H,W) uint8 image as an 8-bit greyscale PNG."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a (H,W) uint8 image, got {img.shape} {img.dtype}")
    _write_png8(path, img, 0)


def write_png_rgb8(path, img):
    """Write a (H,W,3) RGB or (H,W,4) RGBA uint8 image as an 8-bit PNG in
    that channel order (``cv2.imwrite`` of the array reversed to BGR)."""
    img = np.ascontiguousarray(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError(f"expected a (H,W,3|4) uint8 image, got {img.shape} {img.dtype}")
    _write_png8(path, img, 2 if img.shape[2] == 3 else 6)
