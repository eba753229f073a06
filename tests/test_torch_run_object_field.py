"""The port's field tools (tools/run_object_field_torch.py,
tools/extract_field_mesh_torch.py) on demo_data/synth_box_recon/ on the CPU,
at a tiny spec (4 levels, a 2^12 table, 64 rays, 8 + 8 samples, 10 steps,
3 frames, resolution 24): the frames and masks read as the JAX tool reads
them (equal arrays, its masks through cv2), the JAX tool's campaign.json
keys, a checkpoint that the extraction tool resumes to the same mesh."""
import glob
import json
import os
import sys

import cv2
import numpy as np
import torch

from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.models.object_field import HashGridSpec, ObjectFieldConfig

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
SCENE = os.path.join(REPO, "demo_data", "synth_box_recon")
SPEC = HashGridSpec(n_levels=4, base_res=4, finest_res=16, log2_hashmap_size=12)
# tools/run_object_field.py's campaign.json keys
JAX_KEYS = {"scene", "steps", "resumed_from_ckpt", "log2_hashmap_size", "mesh", "n_vertices",
            "train_s", "step_s", "final_loss", "n_rand", "n_samples", "chamfer_m",
            "gt_diameter_m", "vox_size_m", "chamfer_ok", "textured_mesh"}


def test_frames_read_as_the_jax_tool_reads_them():
    import run_object_field_torch

    K, rgbs, depths, masks, cams = run_object_field_torch.load_frames(SCENE, max_frames=3)

    class Args:
        debug = 0
        box = None
        mesh = None
        voxel_size = None

    jr = JReader(base_dir=SCENE, shorter_side=None, zfar=np.inf, arguments=Args())
    np.testing.assert_array_equal(K, jr.color_K)
    poses = sorted(glob.glob(f"{SCENE}/annotated_poses/*.txt"))
    for i in range(3):
        np.testing.assert_array_equal(rgbs[i], jr.get_color(i))
        np.testing.assert_array_equal(depths[i], jr.get_depth(i))
        np.testing.assert_array_equal(cams[i], np.linalg.inv(np.loadtxt(poses[i]).reshape(4, 4)))
    np.testing.assert_array_equal(masks[0], (jr.get_mask(jr.get_color(0), 0) > 0))
    for i in (1, 2):
        m = cv2.imread(f"{SCENE}/masks/{i:04d}.png", -1)
        m = m[..., 0] if m.ndim == 3 else m
        np.testing.assert_array_equal(masks[i], (m > 0).astype(np.uint8))
    assert masks[1].sum() > 1000


def test_campaign_and_resume(tmp_path):
    import extract_field_mesh_torch
    import run_object_field_torch

    cfg = ObjectFieldConfig(n_step=10, n_rand=64, n_samples=8, n_samples_around_depth=8)
    ckpt = str(tmp_path / "field_ckpt")
    out = str(tmp_path / "model_free.obj")
    result, runner = run_object_field_torch.main(SCENE, out, steps=10, resolution=24,
                                                 device="cpu", ckpt_dir=ckpt, cfg=cfg, spec=SPEC,
                                                 max_frames=3)
    assert set(result) == JAX_KEYS and result["steps"] == 10 and runner.global_step == 10
    assert result["log2_hashmap_size"] == 12 and result["n_samples"] == 16
    with open(os.path.join(ckpt, "campaign.json")) as f:
        assert json.load(f) == result
    mesh = load_mesh(out)
    assert len(mesh.vertices) == result["n_vertices"] > 0
    textured = load_mesh(result["textured_mesh"])
    assert textured.texture is not None and len(textured.faces) == len(mesh.faces)
    assert set(runner.stage_seconds) == {"rays", "train", "extract", "colour", "write", "bake",
                                         "write_textured"}

    again, resumed = extract_field_mesh_torch.main(SCENE, str(tmp_path / "again.obj"),
                                                   resolution=24, device="cpu", ckpt_dir=ckpt,
                                                   spec=SPEC, max_frames=3)
    assert again["resumed_from_ckpt"] and again["steps"] == 10
    assert again["n_vertices"] == result["n_vertices"]
    assert again["chamfer_m"] == result["chamfer_m"]
    for k, v in runner.params.tree().items():
        np.testing.assert_array_equal(resumed.params.tree()[k], v)
