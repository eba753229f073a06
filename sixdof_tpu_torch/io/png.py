"""PNG decoding with numpy and zlib, standing in for ``cv2.imread(path, -1)``.

Supports 8-bit gray, RGB and RGBA and 16-bit gray, non-interlaced, with
all five row filters (the demo scenes use 8-bit RGB, 8-bit gray and 16-bit
gray).  Returns what OpenCV returns for ``IMREAD_UNCHANGED``: (H,W) for
gray, (H,W,3) BGR for RGB, (H,W,4) BGRA for RGBA; uint8 or uint16.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters; @raw holds h rows of 1 + stride bytes."""
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride + 1)
    ftypes = rows[:, 0]
    data = rows[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), dtype=np.int32)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(h):
        f = int(ftypes[y])
        cur = data[y]
        if f == 0:
            rec = cur
        elif f == 2:  # up
            rec = (cur + prev) & 0xFF
        elif f in (1, 3, 4):  # sub / average / paeth depend on the left byte
            rec = np.empty(stride, dtype=np.int32)
            if f == 1:
                # sub: running sum per byte lane
                for lane in range(bpp):
                    rec[lane::bpp] = np.cumsum(cur[lane::bpp]) & 0xFF
            else:
                for x in range(stride):
                    a = int(rec[x - bpp]) if x >= bpp else 0
                    b = int(prev[x])
                    if f == 3:
                        rec[x] = (int(cur[x]) + ((a + b) >> 1)) & 0xFF
                    else:
                        c = int(prev[x - bpp]) if x >= bpp else 0
                        p = a + b - c
                        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                        rec[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = rec
        prev = rec
    return out.astype(np.uint8)


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
