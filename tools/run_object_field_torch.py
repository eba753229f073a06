#!/usr/bin/env python3
"""Model-free mesh creation on the PyTorch/CUDA port (`tools/run_object_field.py`
on the port).

    python tools/run_object_field_torch.py [scene_dir] [out_mesh.obj] [steps]

Fits the neural object field (sixdof_tpu_torch/models/object_field.py) to a
recorded scene's masked RGB-D frames using the tracked poses
(annotated_poses/ or debug/ob_in_cam/), extracts a coloured mesh and writes
it where the pose pipeline expects a CAD model (default
`<scene>/mesh/model_free.obj`), with a texture-baked copy beside it
(`*_textured.obj`).  The checkpoint and `campaign.json` (the JAX tool's
keys: steps, table size, vertices, seconds a step, final loss, and, when
the scene has `mesh/model_scaled_down.obj`, the chamfer distance to it with
`chamfer_ok` = at most 2 of the pose engine's voxels) go to
`<scene>/field_ckpt/`.  FIELD_LOG2 sets the hash table's log2 size
(default 22); FIELD_CPU=1 runs on the CPU, else the CUDA card.  Masks are
`masks/NNNN.png` where the scene has them, frame 0's from the reader, else a
band around frame 0's object depth.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_frames(scene_dir, max_frames=None):
    """(K, rgbs, depths, masks, cam_in_obs) of a scene, as the JAX tool
    reads them: the reader at full size, poses from annotated_poses/ (else
    the app's debug/ob_in_cam/ logs)."""
    from sixdof_tpu_torch.io.png import read_png
    from sixdof_tpu_torch.io.readers import DataReader

    reader = DataReader(base_dir=scene_dir, shorter_side=None, zfar=np.inf)
    pose_files = sorted(glob.glob(f"{scene_dir}/annotated_poses/*.txt"))
    if not pose_files:
        pose_files = sorted(glob.glob(f"{REPO}/debug/ob_in_cam/*.txt"))
    if not pose_files:
        raise RuntimeError("no poses found (annotated_poses/ or debug/ob_in_cam/)")

    rgbs, depths, masks, cam_in_obs = [], [], [], []
    mask0 = reader.get_mask(reader.get_color(0), 0)
    n = min(len(reader), len(pose_files))
    for i in range(n if max_frames is None else min(n, max_frames)):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        cam_in_obs.append(np.linalg.inv(np.loadtxt(pose_files[i]).reshape(4, 4)))
        rgbs.append(color)
        depths.append(depth)
        mask_path = f"{scene_dir}/masks/{i:04d}.png"
        if i == 0:
            masks.append((mask0 > 0).astype(np.uint8))
        elif os.path.exists(mask_path):
            m = read_png(mask_path)
            if m.ndim == 3:
                m = m[..., 0]
            masks.append((m > 0).astype(np.uint8))
        else:
            m = (depth > 0.001) & (np.abs(depth - np.median(depth[mask0 > 0])) < 0.2)
            masks.append(m.astype(np.uint8))
    return (np.asarray(reader.color_K), np.stack(rgbs), np.stack(depths), np.stack(masks),
            np.stack(cam_in_obs))


def mesh_metrics(scene_dir, mesh):
    """The chamfer gate against the scene's GT mesh, when it has one."""
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.metrics import chamfer_distance
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter

    gt_path = f"{scene_dir}/mesh/model_scaled_down.obj"
    if not os.path.exists(gt_path):
        return {}
    gt = load_mesh(gt_path)
    cd = chamfer_distance(mesh, gt, n_sample=8000)
    diam = compute_mesh_diameter(gt.vertices, n_sample=5000)
    vox = max(diam / 20.0, 0.003)  # the pose engine's voxel size (reset_object)
    return dict(chamfer_m=float(cd), gt_diameter_m=float(diam), vox_size_m=float(vox),
                chamfer_ok=bool(cd <= 2.0 * vox))


def bake(runner, mesh, out_mesh, result):
    """Texture-bake @mesh (real world) into `*_textured.obj`: in the field's
    NORMALIZED frame, then the baked copy back to the real world.  A bake
    failure is recorded in @result (`texture_error`), not raised: the
    texture is an artifact, not a gate."""
    from sixdof_tpu_torch.io.mesh_io import save_mesh

    try:
        t0 = time.perf_counter()
        mesh_norm = mesh.copy()
        mesh_norm.vertices = (mesh.vertices + np.asarray(runner.translation).reshape(1, 3)) \
            * runner.sc_factor
        textured = runner.mesh_to_real_world(runner.bake_texture(mesh_norm))
        t1 = time.perf_counter()
        tex_path = out_mesh.replace(".obj", "_textured.obj")
        save_mesh(tex_path, textured)
        runner.stage_seconds.update(bake=t1 - t0, write_textured=time.perf_counter() - t1)
        result["textured_mesh"] = tex_path
    except Exception as e:
        result["texture_error"] = f"{type(e).__name__}: {e}"


def main(scene_dir, out_mesh=None, steps=1000, resolution=128, device=None, ckpt_dir=None,
         cfg=None, spec=None, max_frames=None):
    """The campaign; returns (the campaign.json dict, the runner).  @cfg /
    @spec default to the JAX tool's (`ObjectFieldConfig(n_step=steps)`,
    `HashGridSpec()` at FIELD_LOG2); @ckpt_dir to `<scene>/field_ckpt`;
    @max_frames caps the frames read (all by default)."""
    from sixdof_tpu_torch.io.mesh_io import save_mesh
    from sixdof_tpu_torch.models.object_field import (
        HashGridSpec, ObjectFieldConfig, run_neural_object_field,
    )

    cfg = cfg or ObjectFieldConfig(n_step=steps)
    if spec is None:
        spec = HashGridSpec(log2_hashmap_size=int(os.environ["FIELD_LOG2"])) \
            if os.environ.get("FIELD_LOG2") else HashGridSpec()
    ckpt_dir = ckpt_dir or f"{scene_dir}/field_ckpt"
    mesh, runner = run_neural_object_field(
        cfg, *load_frames(scene_dir, max_frames), resolution=resolution, train_steps=steps,
        ckpt_dir=ckpt_dir, spec=spec, device=device)
    out_mesh = out_mesh or f"{scene_dir}/mesh/model_free.obj"
    t0 = time.perf_counter()
    save_mesh(out_mesh, mesh)
    runner.stage_seconds["write"] = time.perf_counter() - t0

    result = {"scene": os.path.basename(scene_dir.rstrip("/")), "steps": steps,
              "resumed_from_ckpt": False,  # this tool trains from scratch;
              # tools/extract_field_mesh_torch.py resumes from the checkpoint
              "log2_hashmap_size": int(spec.log2_hashmap_size),
              "mesh": out_mesh, "n_vertices": int(len(mesh.vertices)),
              "train_s": round(runner.train_seconds, 1),
              "step_s": round(runner.train_seconds / max(steps, 1), 3),
              "final_loss": round(runner.final_loss, 4),
              "n_rand": int(cfg.n_rand),
              "n_samples": int(cfg.n_samples + cfg.n_samples_around_depth)}
    result.update(mesh_metrics(scene_dir, mesh))
    bake(runner, mesh, out_mesh, result)
    with open(f"{ckpt_dir}/campaign.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result, runner


if __name__ == "__main__":
    from sixdof_tpu_torch.utils.logging_utils import set_logging_format

    set_logging_format()
    scene = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "demo_data", "synth_box")
    out = sys.argv[2] if len(sys.argv) > 2 else None
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    main(scene, out, n, device="cpu" if os.environ.get("FIELD_CPU") else None)
