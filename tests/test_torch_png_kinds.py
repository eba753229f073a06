"""The port's PNG decoder (`sixdof_tpu_torch/io/png.py`) on every kind of
PNG that ``cv2.imread(path, -1)`` reads: low-depth grey, palette with and
without transparency, grey+alpha, 16-bit colour, colour keys; each decodes
bit-equal to OpenCV, each texture bit-equal to PIL's ``convert("RGB")``,
and synth_box's mask re-saved as 1-bit or palette gives the JAX reader's
mask."""
import os
import struct
import zlib

import numpy as np
import pytest

from sixdof_tpu_torch.io import png
from sixdof_tpu_torch.io.mesh_io import _read_texture

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
H, W = 13, 21  # odd sizes: the low-depth rows end inside a byte


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _raw_png(path, samples, bit_depth, color_type, extra=b"", interlace=0):
    """A PNG of @samples ((H,W,C) ints) with row filter None, packed most
    significant first below 8 bits, big-endian at 16; @extra chunks (PLTE,
    tRNS) go before IDAT."""
    h, w = samples.shape[:2]
    if bit_depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif bit_depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = (samples.reshape(h, w, 1) >> np.arange(bit_depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    body = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


def _write_kind(path, kind, rng):
    """Write a PNG of @kind: by cv2.imwrite, by PIL, or by _raw_png where
    neither writes it."""
    u8 = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)  # noqa: E731
    u16 = lambda *shape: rng.randint(0, 65536, shape).astype(np.uint16)  # noqa: E731
    pal = u8(16, 3)
    if kind == "cv2_gray8":
        cv2.imwrite(path, u8(H, W))
    elif kind == "cv2_gray16":
        cv2.imwrite(path, u16(H, W))
    elif kind == "cv2_bgr8":
        cv2.imwrite(path, u8(H, W, 3))
    elif kind == "cv2_bgra8":
        cv2.imwrite(path, u8(H, W, 4))
    elif kind == "cv2_bgr16":
        cv2.imwrite(path, u16(H, W, 3))
    elif kind == "cv2_bgra16":
        cv2.imwrite(path, u16(H, W, 4))
    elif kind == "cv2_bilevel":
        cv2.imwrite(path, (u8(H, W) > 127).astype(np.uint8) * 255, [cv2.IMWRITE_PNG_BILEVEL, 1])
    elif kind == "pil_1bit":
        Image.fromarray(u8(H, W) > 127).save(path)
    elif kind.startswith("pil_palette"):  # colours 2, 4, 16, 200 -> 1, 2, 4, 8 bits
        colors = int(kind.split("_")[2])
        img = Image.fromarray(u8(H, W, 3)).quantize(colors=colors)
        if kind.endswith("trns"):
            img.save(path, transparency=bytes(u8(max(1, colors // 2))))
        else:
            img.save(path)
    elif kind == "pil_la":
        Image.fromarray(u8(H, W, 2), mode="LA").save(path)
    elif kind == "pil_i16":
        Image.fromarray(u16(H, W)).save(path)
    elif kind in ("raw_gray2", "raw_gray4"):
        bits = int(kind[-1])
        _raw_png(path, rng.randint(0, 1 << bits, (H, W, 1)), bits, 0)
    elif kind.startswith("raw_palette"):  # 1, 2 or 4 bits, a short tRNS
        bits = int(kind[-1])
        n = 1 << bits
        _raw_png(path, rng.randint(0, n, (H, W, 1)), bits, 3,
                 _chunk(b"PLTE", pal[:n].tobytes()) + _chunk(b"tRNS", bytes(u8(max(1, n - 1)))))
    elif kind == "raw_gray_alpha16":
        _raw_png(path, u16(H, W, 2), 16, 4)
    elif kind == "raw_gray_trns":
        img = u8(H, W, 1)
        _raw_png(path, img, 8, 0, _chunk(b"tRNS", struct.pack(">H", int(img[0, 0, 0]))))
    elif kind in ("raw_rgb_trns8", "raw_rgb_trns16"):
        img = u8(H, W, 3) if kind.endswith("8") else u16(H, W, 3)
        img[3:6, 4:9] = img[0, 0]  # the key colour on more pixels than one
        _raw_png(path, img, 16 if kind.endswith("16") else 8, 2,
                 _chunk(b"tRNS", struct.pack(">HHH", *[int(x) for x in img[0, 0]])))
    else:
        raise ValueError(kind)


KINDS = ["cv2_gray8", "cv2_gray16", "cv2_bgr8", "cv2_bgra8", "cv2_bgr16", "cv2_bgra16",
         "cv2_bilevel", "pil_1bit", "pil_palette_2", "pil_palette_4", "pil_palette_16",
         "pil_palette_200", "pil_palette_4_trns", "pil_palette_200_trns", "pil_la", "pil_i16",
         "raw_gray2", "raw_gray4", "raw_palette1", "raw_palette2", "raw_palette4",
         "raw_gray_alpha16", "raw_gray_trns", "raw_rgb_trns8", "raw_rgb_trns16"]


@pytest.mark.parametrize("kind", KINDS)
def test_kind_decodes_as_opencv_and_pil(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    _write_kind(path, kind, np.random.RandomState(KINDS.index(kind)))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(png.read_png_color(path), cv2.imread(path, cv2.IMREAD_COLOR))
    # a texture decodes as the JAX loader's PIL convert("RGB")
    np.testing.assert_array_equal(_read_texture(path),
                                  np.array(Image.open(path).convert("RGB")))


def test_interlaced_png_raises_naming_adam7(tmp_path):
    """An Adam7-interlaced PNG, once refused, now decodes as OpenCV reads it
    (tests/test_torch_png_adam7.py holds every kind): a flat image, whose
    passes hold the same rows whichever way they are interleaved."""
    path = str(tmp_path / "adam7.png")
    samples = np.full((4, 4, 1), 77)
    samples[:, :2] = 200  # columns, not rows: the passes' rows differ in length
    body = b""
    for x0, y0, dx, dy in png._ADAM7:  # each pass's rows, filter type None
        sub = samples[y0::dy, x0::dx, 0].astype(np.uint8)
        body += b"".join(b"\x00" + row.tobytes() for row in sub if sub.shape[1])
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(png.read_png(path), samples[..., 0])


@pytest.mark.parametrize("shape", [(1, 1), (H, W), (480, 640)])
def test_gray16_writer_round_trips(tmp_path, shape):
    img = np.random.RandomState(shape[0]).randint(0, 65536, shape).astype(np.uint16)
    img.flat[0], img.flat[-1] = 0, 65535
    path = str(tmp_path / "d.png")
    png.write_png_gray16(path, img)
    for decoded in (cv2.imread(path, -1), png.read_png(path)):
        assert decoded.dtype == np.uint16
        np.testing.assert_array_equal(decoded, img)
    with pytest.raises(ValueError, match="uint16"):
        png.write_png_gray16(path, img.astype(np.int32))


@pytest.mark.parametrize("save", ["1bit", "palette"])
def test_resaved_mask_gives_the_jax_readers_mask(tmp_path, save):
    """masks/0000.png saved as 1-bit grey or as a palette PNG: the port's
    DataReader.get_mask gives the JAX reader's 6282-pixel mask."""
    from sixdof_tpu.io.readers import DataReader as JReader
    from sixdof_tpu_torch.io.readers import DataReader

    scene = tmp_path / "scene"
    scene.mkdir()
    for sub in os.listdir(SCENE):
        if sub != "masks":
            os.symlink(os.path.join(SCENE, sub), scene / sub)
    (scene / "masks").mkdir()
    mask = cv2.imread(os.path.join(SCENE, "masks", "0000.png"), -1)
    img = Image.fromarray(mask > 0)
    (img if save == "1bit" else img.convert("P")).save(scene / "masks" / "0000.png")
    assert Image.open(scene / "masks" / "0000.png").mode == ("1" if save == "1bit" else "P")
    jm = JReader(str(scene)).get_mask(None, 0)
    tm = DataReader(str(scene)).get_mask(None, 0)
    assert int(jm.sum()) == 6282
    np.testing.assert_array_equal(tm, jm)
