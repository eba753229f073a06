"""The port's JPEG decoder (`sixdof_tpu_torch/io/jpeg.py`): every committed
fixture (tests/data/jpeg, written by tools/make_jpeg_fixtures_torch.py)
decodes bit-equal to ``cv2.imread(path, cv2.IMREAD_COLOR)`` and to PIL's
``convert("RGB")`` and to the manifest's digests of both; random images
(1-70 px a side, qualities 5-100, every sampling the encoders write,
progressive, restart intervals, Huffman-optimised, grey, Adobe RGB)
encoded here by OpenCV or Pillow decode bit-equal too; every EXIF
orientation turns as OpenCV turns it; a file without Huffman tables takes
the standard ones; and each kind the decoder does not read raises, naming
itself."""
import hashlib
import json
import os
import re
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sixdof_tpu_torch.io.jpeg import read_jpeg_color, read_jpeg_rgb

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
with open(os.path.join(FIXTURES, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)


def _digest(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_decodes_as_opencv_and_pil(rel):
    path = os.path.join(FIXTURES, rel)
    got_bgr, got_rgb = read_jpeg_color(path), read_jpeg_rgb(path)
    assert got_bgr.dtype == got_rgb.dtype == np.uint8
    np.testing.assert_array_equal(got_bgr, cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(got_rgb, np.asarray(Image.open(path).convert("RGB")))
    entry = MANIFEST["files"][rel]
    assert _digest(got_bgr) == entry["cv2"] and _digest(got_rgb) == entry["pil"]


def _image(rng, h, w, grey):
    """A smooth field with noise on it: edges and gradients for the
    upsampler, detail for the entropy coder."""
    base = rng.randint(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR).astype(int)
    img = np.clip(img + rng.randint(-40, 41, img.shape), 0, 255).astype(np.uint8)
    return img[..., 1] if grey else img


SAMPLINGS = ["444", "422", "420", "440", "411"]


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(5, 100),
       sampling=st.sampled_from(SAMPLINGS), progressive=st.booleans(),
       restart=st.sampled_from([0, 0, 1, 3, 7]), optimise=st.booleans(),
       writer=st.sampled_from(["cv2", "pil", "pil_rgb"]), grey=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_random_images_decode_as_opencv_and_pil(tmp_path, h, w, quality, sampling, progressive,
                                                restart, optimise, writer, grey, seed):
    img = _image(np.random.RandomState(seed), h, w, grey)
    path = str(tmp_path / "x.jpg")
    if writer == "cv2":
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}"),
                                cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                                cv2.IMWRITE_JPEG_OPTIMIZE, int(optimise),
                                cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    else:  # Pillow: 4:4:4, 4:2:2 or 4:2:0; keep_rgb stores RGB untransformed at 4:4:4
        kw = dict(quality=quality, progressive=progressive, optimize=optimise)
        if not grey:
            kw["subsampling"] = {"444": 0, "422": 1}.get(sampling, 2)
            if writer == "pil_rgb":
                kw.update(keep_rgb=True, subsampling=0)
        Image.fromarray(img if grey else img[..., ::-1]).save(path, format="JPEG", **kw)
    np.testing.assert_array_equal(read_jpeg_color(path), cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(read_jpeg_rgb(path),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_as_opencv(tmp_path, orientation):
    """read_jpeg_color turns the image as cv2.imread does; read_jpeg_rgb,
    like PIL's convert, leaves it as stored."""
    img = _image(np.random.RandomState(orientation), 21, 34, grey=False)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "o.jpg")
    Image.fromarray(img).save(path, format="JPEG", exif=exif.tobytes())
    np.testing.assert_array_equal(read_jpeg_color(path), cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(read_jpeg_rgb(path), np.asarray(Image.open(path).convert("RGB")))
    assert read_jpeg_rgb(path).shape == (21, 34, 3)


@pytest.mark.parametrize("kind", ["420", "444", "grey"])
def test_table_less_jpeg_uses_the_standard_tables(tmp_path, kind):
    """A JPEG without DHT segments (a Motion-JPEG frame) decodes with the
    standard Huffman tables, as libjpeg-turbo does: cv2's default
    (unoptimised) tables are those, so it decodes as the file with them."""
    img = _image(np.random.RandomState(5), 29, 43, grey=kind == "grey")
    params = [] if kind == "grey" else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{kind}")]
    data = cv2.imencode(".jpg", img, params)[1].tobytes()
    stripped, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:  # every segment before the scan but the DHTs
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            stripped += data[pos:pos + 2 + length]
        pos += 2 + length
    stripped += data[pos:]
    assert len(stripped) < len(data)
    (tmp_path / "with.jpg").write_bytes(data)
    (tmp_path / "without.jpg").write_bytes(stripped)
    want = cv2.imread(str(tmp_path / "without.jpg"), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(read_jpeg_color(str(tmp_path / "without.jpg")), want)
    np.testing.assert_array_equal(read_jpeg_color(str(tmp_path / "with.jpg")), want)


def _fixture_bytes(rel="kinds/444.jpg"):
    with open(os.path.join(FIXTURES, rel), "rb") as f:
        return bytearray(f.read())


def _patched_sof(marker=None, precision=None, height=None, components=None):
    """The 4:4:4 fixture with its SOF0 marker's fields patched."""
    data = _fixture_bytes()
    at = data.index(b"\xff\xc0")
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    if height is not None:
        data[at + 5:at + 7] = struct.pack(">H", height)
    if components is not None:
        data[at + 9] = components
    return bytes(data)


def _truncated_progressive():
    """The progressive fixture cut after its first two scans: the AC bands
    never arrive, which libjpeg fills in by block smoothing."""
    data = _fixture_bytes("kinds/progressive.jpg")
    third = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"][2]
    return bytes(data[:third]) + b"\xff\xd9"


def _cmyk(tmp_path):
    path = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_image(np.random.RandomState(0), 16, 16, False)).convert("CMYK").save(path)
    with open(path, "rb") as f:
        return f.read()


UNSUPPORTED = {
    "lossless (SOF3)": lambda _: _patched_sof(marker=0xC3),
    "hierarchical (SOF5)": lambda _: _patched_sof(marker=0xC5),
    "arithmetic-coded (SOF9)": lambda _: _patched_sof(marker=0xC9),
    "arithmetic-coded progressive (SOF10)": lambda _: _patched_sof(marker=0xCA),
    "arithmetic-coded lossless (SOF11)": lambda _: _patched_sof(marker=0xCB),
    "12-bit": lambda _: _patched_sof(precision=12),
    "DNL-sized": lambda _: _patched_sof(height=0),
    "2-component": lambda _: _patched_sof(components=2),
    "4-component (CMYK/YCCK)": _cmyk,
    "unrefined": lambda _: _truncated_progressive(),
}


@pytest.mark.parametrize("kind", list(UNSUPPORTED))
def test_unsupported_kind_raises_naming_itself(tmp_path, kind):
    path = tmp_path / "kind.jpg"
    path.write_bytes(UNSUPPORTED[kind](tmp_path))
    with pytest.raises(NotImplementedError, match=re.escape(kind)):
        read_jpeg_color(str(path))


def test_not_a_jpeg_raises(tmp_path):
    (tmp_path / "x.jpg").write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="not a JPEG"):
        read_jpeg_rgb(str(tmp_path / "x.jpg"))
