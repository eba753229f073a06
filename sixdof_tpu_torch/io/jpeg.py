"""JPEG decoding, standing in for ``cv2.imread(path, cv2.IMREAD_COLOR)`` and
``PIL.Image.open(path).convert("RGB")``, bit for bit.

Both of those run libjpeg-turbo's default decode: the integer "islow"
inverse DCT, "fancy" (triangle-filter) upsampling of 2:1 subsampled
chroma and fixed-point YCbCr tables, all integer arithmetic.  The markers
are parsed here; the entropy decoding and the pixel work run in C
(`csrc/jpeg_decode.c`, built with the system C compiler at first use;
without one, decoding raises).

Decodes baseline and extended sequential Huffman JPEGs (SOF0, SOF1) and
progressive Huffman JPEGs (SOF2) of 8-bit samples with 1 or 3 components,
any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), restart
intervals, any image size, an Adobe APP14 transform of 0 (RGB stored as
is), and scans without Huffman tables (Motion-JPEG frames: the standard
tables, as libjpeg-turbo).  Arithmetic coding, 12-bit samples, lossless and hierarchical
JPEGs, 2- and 4-component (CMYK, YCCK) images, and a progressive file
whose scans leave low-frequency coefficients unrefined (libjpeg then
smooths the blocks) raise `NotImplementedError` naming the kind.
"""
from __future__ import annotations

import ctypes
import re
import struct

import numpy as np

from ..kernels.build import KernelLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    lib.jpeg_scan.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P] + [_I] * 6
    lib.jpeg_scan.restype = _I
    lib.jpeg_pixels.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.jpeg_pixels.restype = _I


# the entropy decoding and pixel work run in C (csrc/jpeg_decode.c), built on first use
LIBRARY = KernelLibrary("jpeg_decode", _bind, ext=".c")

# zigzag position -> natural (row-major) position in the 8x8 block
_NATURAL = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
                     40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                     36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
                     61, 54, 47, 55, 62, 63])

# the frame kinds that raise, by SOF marker
_UNSUPPORTED_SOF = {0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
                    0xC6: "hierarchical progressive (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
                    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
                    0xCB: "arithmetic-coded lossless (SOF11)",
                    0xCD: "hierarchical arithmetic-coded (SOF13)",
                    0xCE: "hierarchical arithmetic-coded progressive (SOF14)",
                    0xCF: "hierarchical arithmetic-coded lossless (SOF15)"}
_SOF = (0xC0, 0xC1, 0xC2)
# the end of an entropy-coded segment: a marker other than a restart marker
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_SMOOTHED_COEFS = 10  # libjpeg's block smoothing looks at the first 10 coefficients
# (DC = 0 / AC = 1, table 0 luminance / 1 chrominance): the counts of each
# code length and the symbols of ITU T.81 Annex K.3's tables, which
# libjpeg-turbo uses for a table a scan names but no DHT defined
_STD_HUFFMAN = {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107227114328191a1"
            "082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a43444546"
            "4748494a535455565758595a636465666768696a737475767778797a838485868788898a9293"
            "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
            "d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (1, 1): "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
            "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
            "48494a535455565758595a636465666768696a737475767778797a82838485868788898a9293"
            "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
            "d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg does
        self.bits = np.full(64, -1)  # progressive: the coefficients' known bits


def _unsupported(name, kind):
    raise NotImplementedError(f"{name}: a {kind} JPEG; the port decodes 8-bit Huffman-coded "
                              "sequential and progressive JPEGs with 1 or 3 components")


class _Decoder:
    def __init__(self, name, data):
        self.name, self.data = name, data
        self.qtables, self.dc, self.ac = {}, {}, {}
        self.restart, self.frame, self.comps = 0, None, []
        self.jfif = self.adobe_transform = None
        self.orientation, self.scans = 1, 0

    def fail(self, what):
        raise ValueError(f"{self.name}: {what}")

    def run(self, bgr):
        data = self.data
        if data[:2] != b"\xff\xd8":
            self.fail("not a JPEG file")
        pos = 2
        while pos < len(data):
            if data[pos] != 0xFF:  # garbage between markers: libjpeg skips to the next
                nxt = data.find(b"\xff", pos)
                if nxt < 0:
                    break
                pos = nxt
                continue
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                break
            marker = data[pos]
            pos += 1
            if marker == 0xD9:  # EOI
                break
            if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:  # no length
                continue
            if pos + 2 > len(data):
                break
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            pos += length
            if marker in _SOF:
                self.sof(marker, body)
            elif marker in _UNSUPPORTED_SOF:
                _unsupported(self.name, _UNSUPPORTED_SOF[marker])
            elif marker == 0xCC:
                _unsupported(self.name, "arithmetic-coded (DAC)")
            elif marker in (0xDE, 0xDF):
                _unsupported(self.name, "hierarchical (DHP/EXP)")
            elif marker == 0xC4:
                self.dht(body)
            elif marker == 0xDB:
                self.dqt(body)
            elif marker == 0xDD:
                self.restart = struct.unpack(">H", body[:2])[0]
            elif marker == 0xDA:
                pos = self.sos(body, pos)
            elif marker == 0xE0:
                if len(body) >= 14 and body[:5] == b"JFIF\x00":
                    self.jfif = True
            elif marker == 0xE1:
                self.exif(body)
            elif marker == 0xEE:
                if len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe_transform = body[11]
        if self.scans == 0:
            self.fail("no image data")
        return self.pixels(bgr)

    def sof(self, marker, body):
        if self.frame is not None:
            self.fail("a second SOF marker")
        p, height, width, n = struct.unpack(">BHHB", body[:6])
        if p != 8:
            _unsupported(self.name, f"{p}-bit")
        if height == 0:
            _unsupported(self.name, "DNL-sized (image height 0 in SOF)")
        if n in (2, 4):
            _unsupported(self.name, {2: "2-component", 4: "4-component (CMYK/YCCK)"}[n])
        if n not in (1, 3) or width == 0:
            self.fail(f"bad SOF: {n} components, width {width}")
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                self.fail(f"bad sampling factors {hv >> 4}x{hv & 15}")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.frame = dict(progressive=marker == 0xC2, H=height, W=width)
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        self.hmax, self.vmax = hmax, vmax
        self.mcux, self.mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        for c in self.comps:
            if hmax % c.h or vmax % c.v:
                _unsupported(self.name, f"fractionally subsampled ({c.h}x{c.v} of "
                                        f"{hmax}x{vmax})")
            c.cw, c.ch = -(-width * c.h // hmax), -(-height * c.v // vmax)
            c.stride = self.mcux * c.h
            c.coef = np.zeros((self.mcuy * c.v * c.stride, 64), np.int16)

    def dht(self, body):
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = body[pos + 1:pos + 17]
            n = sum(counts)
            if tc_th >> 4 > 1 or n > 256 or pos + 17 + n > len(body):
                self.fail("bad DHT")
            spec = np.zeros(272, np.uint8)
            spec[:16] = np.frombuffer(counts, np.uint8)
            spec[16:16 + n] = np.frombuffer(body[pos + 17:pos + 17 + n], np.uint8)
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = spec
            pos += 17 + n

    def dqt(self, body):
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            size = 128 if pq else 64
            vals = np.frombuffer(body[pos + 1:pos + 1 + size], ">u2" if pq else np.uint8)
            if len(vals) != 64:
                self.fail("bad DQT")
            table = np.zeros(64, np.uint16)
            table[_NATURAL] = vals
            self.qtables[tq] = table
            pos += 1 + size

    def exif(self, body):
        """The orientation tag (0x0112) of IFD0 in an Exif APP1 block."""
        if self.orientation != 1 or body[:6] != b"Exif\x00\x00":
            return
        tiff = body[6:]
        order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if order is None or len(tiff) < 8:
            return
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        if ifd + 2 > len(tiff):
            return
        (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
        for i in range(count):
            at = ifd + 2 + 12 * i
            if at + 12 > len(tiff):
                return
            tag, kind = struct.unpack(order + "HH", tiff[at:at + 4])
            if tag == 0x0112 and kind == 3:
                self.orientation = struct.unpack(order + "H", tiff[at + 8:at + 10])[0]
                return

    def sos(self, body, pos):
        """Decode one scan; returns the position of the marker after its data."""
        if self.frame is None:
            self.fail("SOS before SOF")
        n = body[0]
        by_id = {c.cid: c for c in self.comps}
        comps = []
        for i in range(n):
            if body[1 + 2 * i] not in by_id:
                self.fail(f"scan component {body[1 + 2 * i]} is not in the frame")
            comps.append(by_id[body[1 + 2 * i]])
        ss, se, ahal = body[1 + 2 * n:4 + 2 * n]
        ah, al = ahal >> 4, ahal & 15
        progressive = self.frame["progressive"]
        self.check_scan(comps, ss, se, ah, al)
        tables = np.zeros((n, 2, 272), np.uint8)
        for i, tdta in enumerate(body[2:2 + 2 * n:2]):
            need_dc = not progressive or (ss == 0 and ah == 0)
            need_ac = not progressive or ss > 0
            for j, store, t, need in ((0, self.dc, tdta >> 4, need_dc),
                                      (1, self.ac, tdta & 15, need_ac)):
                if need and t not in store:
                    if t not in (0, 1):
                        self.fail(f"a scan uses Huffman table {t}, which is not defined")
                    # no DHT (a Motion-JPEG frame): libjpeg-turbo's standard tables
                    store[t] = np.frombuffer(bytes.fromhex(_STD_HUFFMAN[j, t]).ljust(272, b"\0"),
                                             np.uint8)
                if need:
                    tables[i, j] = store[t]
        for c in comps:
            if c.qt is None:
                if c.tq not in self.qtables:
                    self.fail(f"quantisation table {c.tq} is not defined")
                c.qt = self.qtables[c.tq]
        m = _SEGMENT_END.search(self.data, pos)
        end = m.start() if m else len(self.data)
        segment = np.frombuffer(self.data, np.uint8, count=end - pos, offset=pos)
        if len(comps) == 1:
            c = comps[0]
            mcux, mcuy = -(-c.cw // 8), -(-c.ch // 8)
        else:
            mcux, mcuy = self.mcux, self.mcuy
        ptrs = (ctypes.c_void_p * n)(*[c.coef.ctypes.data for c in comps])
        ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
        rc = LIBRARY.load().jpeg_scan(
            segment.ctypes.data, len(segment), n, ptrs, ints([c.stride for c in comps]),
            ints([c.h for c in comps]), ints([c.v for c in comps]), mcux, mcuy,
            tables.ctypes.data, ss, se, ah, al, int(progressive), self.restart)
        if rc:
            self.fail("bad Huffman table" if rc == 1 else "out of memory")
        self.scans += 1
        return end

    def check_scan(self, comps, ss, se, ah, al):
        """The scan's parameters as libjpeg accepts them and, in a
        progressive file, the coefficients' known bits."""
        n = len(comps)
        if not 1 <= n <= 4 or (n > 1 and sum(c.h * c.v for c in comps) > 10):
            self.fail(f"bad scan: {n} components")
        if not self.frame["progressive"]:
            return
        if ss == 0:
            bad = se != 0
        else:
            bad = se < ss or se > 63 or n != 1
        if bad or (ah != 0 and al != ah - 1) or al > 13:
            self.fail(f"bad progressive scan: Ss={ss} Se={se} Ah={ah} Al={al}")
        for c in comps:
            c.bits[ss:se + 1] = al

    def pixels(self, bgr):
        f, comps = self.frame, self.comps
        if f["progressive"] and all(c.bits[0] >= 0 for c in comps) and \
                any((c.bits[1:_SMOOTHED_COEFS] != 0).any() for c in comps):
            _unsupported(self.name, "progressive (scans leave low-frequency coefficients "
                                    "unrefined, which libjpeg's block smoothing fills in)")
        n = len(comps)
        if n == 1:
            color = 0
        elif self.jfif:
            color = 1
        elif self.adobe_transform is not None:
            color = 2 if self.adobe_transform == 0 else 1
        else:
            ids = [c.cid for c in comps]
            color = 2 if ids == [82, 71, 66] else 1  # 'R', 'G', 'B'
        qt = np.stack([c.qt if c.qt is not None else np.zeros(64, np.uint16) for c in comps])
        out = np.empty((f["H"], f["W"], 3), np.uint8)
        ptrs = (ctypes.c_void_p * n)(*[c.coef.ctypes.data for c in comps])
        ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
        rc = LIBRARY.load().jpeg_pixels(
            n, ptrs, ints([c.stride for c in comps]), qt.ctypes.data,
            ints([c.cw for c in comps]), ints([c.ch for c in comps]),
            ints([self.hmax // c.h for c in comps]), ints([self.vmax // c.v for c in comps]),
            f["W"], f["H"], color, int(bgr), out.ctypes.data)
        if rc:
            self.fail("out of memory")
        return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _orient(img, orientation):
    """OpenCV's EXIF orientation transform (imgcodecs' ExifTransform)."""
    if orientation >= 5 and orientation <= 8:
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def read_jpeg_color(path):
    """Decode a JPEG file as ``cv2.imread(path, cv2.IMREAD_COLOR)`` does:
    (H,W,3) uint8 BGR, grey replicated, turned as its EXIF orientation tag
    says."""
    dec = _Decoder(path, _read(path))
    return _orient(dec.run(bgr=True), dec.orientation)


def read_jpeg_rgb(path):
    """Decode a JPEG file as ``PIL.Image.open(path).convert("RGB")`` does:
    (H,W,3) uint8 RGB, grey replicated, the EXIF orientation not applied."""
    return _Decoder(path, _read(path)).run(bgr=False)
