#!/usr/bin/env python3
"""Write the JPEG fixtures that the port's decoder (`sixdof_tpu_torch/io/jpeg.py`)
is held to, where no JPEG encoder is installed (the H100 machine).

    JAX_PLATFORMS=cpu python tools/make_jpeg_fixtures_torch.py [--out tests/data/jpeg]

Runs on a machine with OpenCV, Pillow and the JAX package.  Writes into
--out:

- rgb/00000N.jpg: synth_box's six colour frames, by ``cv2.imwrite`` at
  quality 95 and 4:2:0, the frames of the JPEG BOP scene (chip_smoke.py's
  run `synth_box_jpeg` swaps them for the converted scene's PNGs);
- kinds/*.jpg: one small crop of frame 0 (96x64 around the box) of each kind
  the decoder reads: grey, 4:4:4, 4:2:2, 4:4:0, 4:1:1, progressive (OpenCV
  and Pillow), restart interval 4, 37x23, Huffman-optimised, Adobe RGB (no
  colour transform) and EXIF orientation 6;
- texture.jpg: a 256x256 texture written by Pillow at quality 90;
- MANIFEST.json: each file's writer and settings, and the shape and sha256
  of ``cv2.imread(path, cv2.IMREAD_COLOR)``'s bytes (`cv2`) and of
  ``Image.open(path).convert("RGB")``'s (`pil`); and the JAX package's BOP
  campaign on the JPEG scene (`jax_bop`, keyed by prune_to 0 and 64):
  tools/convert_scene_to_bop.py's conversion of synth_box with rgb/
  replaced by these frames, scored by tools/run_bop.py's main at the app's
  width on the bundled weights/ in bfloat16, as tools/bop_jax_reference.py
  runs it (about 1 min a run on the CPU).
"""
from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
CROP = (slice(184, 248), slice(284, 380))  # 64 x 96 around the box in frame 0


def _digest(img):
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def _kinds(cv2, Image, frame):
    """(name, description, writer) of each small fixture; a writer takes the
    output path."""
    crop = np.ascontiguousarray(frame[CROP])
    rgb = Image.fromarray(crop[..., ::-1])
    S = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}") for s in ("444", "422", "440",
                                                                         "411")}

    def cv(img, *params):
        return lambda p: cv2.imwrite(p, img, list(params))

    def pil(**kw):
        return lambda p: rgb.save(p, format="JPEG", **kw)

    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 degrees clockwise to view
    return [
        ("grey", "cv2 grey, quality 90", cv(crop[..., 1], cv2.IMWRITE_JPEG_QUALITY, 90)),
        ("444", "cv2 quality 75, 4:4:4", cv(crop, cv2.IMWRITE_JPEG_QUALITY, 75,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S["444"])),
        ("422", "cv2 quality 90, 4:2:2", cv(crop, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S["422"])),
        ("440", "cv2 quality 90, 4:4:0", cv(crop, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S["440"])),
        ("411", "cv2 quality 90, 4:1:1", cv(crop, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S["411"])),
        ("progressive", "cv2 progressive, 4:2:0", cv(crop, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)),
        ("progressive_pil", "Pillow progressive, quality 40, 4:2:2",
         pil(progressive=True, quality=40, subsampling=1)),
        ("restart", "cv2 restart interval 4", cv(crop, cv2.IMWRITE_JPEG_RST_INTERVAL, 4)),
        ("odd_37x23", "cv2 37x23, 4:2:0", cv(np.ascontiguousarray(crop[5:28, 11:48]))),
        ("optimised", "cv2 Huffman-optimised", cv(crop, cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
        ("adobe_rgb", "Pillow keep_rgb (Adobe APP14 transform 0)", pil(keep_rgb=True)),
        ("exif_rot6", "Pillow, EXIF orientation 6", pil(exif=exif.tobytes())),
    ]


def _jax_bop(frames_dir, work):
    """The JAX package's campaign on synth_box converted with these frames,
    at prune_to 0 and 64 (tools/bop_jax_reference.py's setting)."""
    os.environ["SIXDOF_AOT_CACHE"] = ""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_scene_to_bop
    import run_bop
    from sixdof_tpu.models import predict

    jax.config.update("jax_enable_compilation_cache", False)
    for name, net in (("PoseRefinePredictor", "refiner"), ("ScorePredictor", "scorer")):
        pred = getattr(predict, name)(ckpt_dir=os.path.join(REPO, "weights", net),
                                      compute_dtype=jnp.bfloat16)
        setattr(predict, name, lambda pred=pred, **_: pred)
    scene = convert_scene_to_bop.main(SCENE, work, obj_id=1)
    for png in glob.glob(os.path.join(scene, "rgb", "*.png")):
        os.remove(png)
    for jpg in sorted(glob.glob(os.path.join(frames_dir, "*.jpg"))):
        shutil.copy(jpg, os.path.join(scene, "rgb"))
    out = {}
    for prune_to in (0, 64):
        out[str(prune_to)] = run_bop.main(scene, prune_to=prune_to)
        print(json.dumps({"prune_to": prune_to, **out[str(prune_to)]}), flush=True)
    return out


def main(out):
    import cv2
    from PIL import Image

    frames = sorted(glob.glob(os.path.join(SCENE, "rgb", "*.png")))
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "rgb"))
    os.makedirs(os.path.join(out, "kinds"))
    entries = {}
    for i, path in enumerate(frames):
        rel = f"rgb/{i:06d}.jpg"
        cv2.imwrite(os.path.join(out, rel), cv2.imread(path),
                    [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        entries[rel] = "cv2 quality 95, 4:2:0, synth_box " + os.path.basename(path)
    for name, desc, write in _kinds(cv2, Image, cv2.imread(frames[0])):
        write(os.path.join(out, "kinds", f"{name}.jpg"))
        entries[f"kinds/{name}.jpg"] = desc
    tex = cv2.resize(cv2.imread(frames[0])[112:368, 192:448], (256, 256))[..., ::-1]
    Image.fromarray(np.ascontiguousarray(tex)).save(os.path.join(out, "texture.jpg"),
                                                    format="JPEG", quality=90)
    entries["texture.jpg"] = "Pillow quality 90, 256x256"
    files = {}
    for rel, desc in entries.items():
        path = os.path.join(out, rel)
        files[rel] = {"written_by": desc,
                      "cv2": _digest(cv2.imread(path, cv2.IMREAD_COLOR)),
                      "pil": _digest(np.asarray(Image.open(path).convert("RGB")))}
    manifest = {"cv2": cv2.__version__, "pillow": Image.__version__, "files": files,
                "jax_bop": _jax_bop(os.path.join(out, "rgb"),
                                    os.path.join(REPO, "build", "jpeg_fixture_bop"))}
    with open(os.path.join(out, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jpeg"))
    main(ap.parse_args().out)
