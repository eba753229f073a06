#!/usr/bin/env python3
"""Convert a demo scene into the BOP layout, with the PyTorch/CUDA port's
readers and writers (no OpenCV, no JAX).

    python tools/convert_scene_to_bop_torch.py <scene_dir> <bop_root> [obj_id]

Writes <bop_root>/test/000001/ (scene_camera.json, scene_gt.json,
scene_gt_info.json, rgb/, depth/ as 16-bit millimetres, mask_visib/) and
<bop_root>/models/ (obj_<id>.ply in millimetres, models_info.json), as
`tools/convert_scene_to_bop.py` does, for `tools/run_bop_torch.py`.  The
visible mask is masks/0000.png on frame 0 and, on later frames, the
annotated pose's mesh samples whose depth the frame confirms, closed by a
5x5 kernel.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(scene_dir, bop_root, obj_id=1):
    from sixdof_tpu_torch.io.mesh_io import load_mesh, save_mesh
    from sixdof_tpu_torch.io.png import write_png_gray8, write_png_gray16, write_png_rgb8
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.ops.geometry import compute_mesh_diameter

    reader = DataReader(scene_dir, shorter_side=None, zfar=np.inf)
    scene = os.path.join(bop_root, "test", "000001")
    models = os.path.join(bop_root, "models")
    for sub in ("rgb", "depth", "mask_visib"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    os.makedirs(models, exist_ok=True)

    K = np.asarray(reader.color_K, dtype=float)
    cam, gt, gt_info = {}, {}, {}
    for i in range(len(reader)):
        color = reader.get_color(i)
        depth_m = reader.get_depth(i)
        write_png_rgb8(f"{scene}/rgb/{i:06d}.png", color)
        write_png_gray16(f"{scene}/depth/{i:06d}.png", (depth_m * 1000).astype(np.uint16))
        cam[str(i)] = {"cam_K": [float(x) for x in K.reshape(-1)], "depth_scale": 1.0}
        pose = reader.get_gt_pose(i)
        gt[str(i)] = [{
            "obj_id": int(obj_id),
            "cam_R_m2c": [float(x) for x in pose[:3, :3].reshape(-1)],
            "cam_t_m2c": [float(x) for x in (pose[:3, 3] * 1000.0)],
        }]
        if i == 0:
            mask = (np.asarray(reader.get_mask(color, 0)) > 0).astype(np.uint8) * 255
        else:
            mask = _mask_from_gt(reader, depth_m, pose, K)
        write_png_gray8(f"{scene}/mask_visib/{i:06d}_000000.png", mask)
        gt_info[str(i)] = [{"visib_fract": float((mask > 0).mean() > 0) and 1.0}]

    for name, payload in (("scene_camera", cam), ("scene_gt", gt), ("scene_gt_info", gt_info)):
        with open(f"{scene}/{name}.json", "w") as f:
            json.dump(payload, f)

    # the dataset's model in mm, and its models_info
    mesh_mm = load_mesh(os.path.join(scene_dir, "mesh", "model_scaled_down.obj")).copy()
    mesh_mm.vertices = mesh_mm.vertices * 1000.0
    save_mesh(f"{models}/obj_{int(obj_id):06d}.ply", mesh_mm)
    diam_mm = compute_mesh_diameter(mesh_mm.vertices, n_sample=5000)
    with open(f"{models}/models_info.json", "w") as f:
        json.dump({str(int(obj_id)): {"diameter": float(diam_mm)}}, f)
    print(f"wrote BOP scene to {scene} (obj {obj_id}, diameter {diam_mm:.1f}mm)")
    return scene


def _mask_from_gt(reader, depth_m, pose, K):
    """The object's visible mask: mesh samples projected by the annotated
    pose where the frame's depth agrees to 8 mm, closed by a 5x5 kernel."""
    from sixdof_tpu_torch.io.readers import dilate5, erode5

    pts = reader.target_mesh.sample_points(20000, seed=0).points / 1000.0  # m, model frame
    p_cam = pts @ pose[:3, :3].T + pose[:3, 3]
    uvw = p_cam @ K.T
    uv = (uvw[:, :2] / uvw[:, 2:3]).round().astype(int)
    H, W = depth_m.shape
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    uv, z = uv[ok], p_cam[ok, 2]
    vis = np.abs(depth_m[uv[:, 1], uv[:, 0]] - z) < 0.008
    mask = np.zeros((H, W), np.uint8)
    mask[uv[vis, 1], uv[vis, 0]] = 255
    return erode5(dilate5(mask))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "demo_data", "synth_box"),
         sys.argv[2] if len(sys.argv) > 2 else os.path.join(REPO, "demo_data", "bop_synth"),
         int(sys.argv[3]) if len(sys.argv) > 3 else 1)
