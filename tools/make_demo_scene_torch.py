"""Synthesize a demo scene with the port: the same files as
`tools/make_demo_scene.py`, rendered through `ops/rasterize.py` (kernel K1
at full frame on the card, its plain version on the CPU), without JAX or
OpenCV.

The layout, poses, meshes, clouds, masks, heatmap and configs are the JAX
tool's, from the same numpy draws in the same order (the sensor model is
`tools/sensor_model_torch.py`); PNGs go through `io/png.py`, meshes and
clouds through `io/mesh_io.py`.  Each frame renders the object and the
static scene (plane, fixtures) as two B=1 full-frame renders.

    python tools/make_demo_scene_torch.py [out_dir] [n_frames] [variant] [--sensor]
        [--device cpu]

The variant (box, clutter, occl, recon) and --sensor follow the JAX tool's
command line and its inference from the directory's name.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import sensor_model_torch as sensor_model  # noqa: E402
from sixdof_tpu_torch.device import resolve_device  # noqa: E402
from sixdof_tpu_torch.io.mesh_io import (PointCloud, TriMesh, save_mesh,  # noqa: E402
                                         save_point_cloud)
from sixdof_tpu_torch.io.png import write_png_gray8, write_png_gray16, write_png_rgb8  # noqa: E402
from sixdof_tpu_torch.ops.hypotheses import icosphere  # noqa: E402
from sixdof_tpu_torch.ops.lie import euler_matrix  # noqa: E402
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays, render_batch  # noqa: E402

ICP_PARAMETERS = {
    "debug_vis": False,
    "box": True,
    "mesh": False,
    "voxel_size": 2.0,
    "preprocess_target": {"max_pcd": 3000, "fpfh_radius": 20, "fpfh_max_nn": 60},
    "preprocess_source": {
        "down_sample": 4.0,
        "plane_removal": {"distance_threshold": 2.0, "num_iterations": 100},
        "fpfh_radius": 20,
        "fpfh_max_nn": 60,
    },
    "execute_global_registration": {
        "distance_threshold": 10.0,
        "correspondence_checkers": [{"value": 0.9}],
        "angle_threshold": 0.52,
        "ransac_criteria": {"iterations": 4000, "confidence": 0.999},
    },
    "refine_registration": {"distance_threshold": 5.0},
    "run_icp": {"fitness_threshold": 0.9, "rmse_threshold": 2.0, "n_restarts": 12,
                "max_iter": 15},
}


def make_object_mesh(seed=0):
    """Bumpy ellipsoid (meters; diameter ~0.09 m) with a saturated
    checker-and-stripe vertex texture."""
    v, f = icosphere(subdivisions=3)
    rng = np.random.RandomState(seed)
    dirs = rng.randn(6, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    amp = 0.22 * np.cos(3 * (v @ dirs.T) + rng.rand(6) * 6.28).sum(axis=1) / 6
    radii = np.array([0.048, 0.034, 0.027])
    verts = v * (1.0 + amp)[:, None] * radii[None]
    checker = np.sign(np.sin(9.0 * v[:, 0]) * np.sin(7.0 * v[:, 1]) * np.sin(8.0 * v[:, 2]))
    stripes = np.sign(np.sin(14.0 * (v[:, 0] + 0.7 * v[:, 1])))
    r = 0.5 + 0.45 * checker
    g = 0.5 + 0.45 * stripes
    b = 0.5 + 0.5 * v[:, 2]
    colors = (np.stack([r, g, b], axis=-1) * 255).clip(0, 255)
    return TriMesh(verts, f, vertex_colors=colors)


def make_scene_plane(z=0.62, half=0.25, textured=False, seed=0):
    if not textured:
        v = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]])
        f = np.array([[0, 1, 2], [0, 2, 3]])
        return TriMesh(v, f, vertex_colors=np.full((4, 3), 90.0))
    # a vertex grid with noise colours
    n = 24
    rng = np.random.RandomState(seed + 77)
    xs = np.linspace(-half, half, n)
    gx, gy = np.meshgrid(xs, xs)
    v = np.stack([gx.ravel(), gy.ravel(), np.full(n * n, z)], axis=-1)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            f.append([a, a + 1, a + n])
            f.append([a + 1, a + n + 1, a + n])
    base = 60 + 120 * rng.rand(n * n, 1)
    tint = rng.rand(n * n, 3) * 60
    return TriMesh(v, np.array(f), vertex_colors=np.clip(base + tint, 0, 255))


def make_target_part(seed=1):
    """The clutter scenes' target: a flattened bumpy ellipsoid with a lug."""
    v, f = icosphere(subdivisions=3)
    rng = np.random.RandomState(seed)
    lug = np.exp(-((v[:, 0] - 1.0) ** 2 + v[:, 1] ** 2 + v[:, 2] ** 2) / 0.18) * 0.75
    dirs = rng.randn(4, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bumps = 0.12 * np.cos(5 * (v @ dirs.T) + rng.rand(4) * 6.28).sum(axis=1) / 4
    radii = np.array([0.055, 0.030, 0.018])
    verts = v * (1.0 + bumps + lug)[:, None] * radii[None]
    rings = np.sign(np.sin(22.0 * v[:, 2] + 4.0 * np.arctan2(v[:, 1], v[:, 0])))
    patch = np.sign(np.sin(11.0 * v[:, 0]) * np.sin(9.0 * v[:, 1]))
    r = 0.55 + 0.40 * rings
    g = 0.45 + 0.35 * patch
    b = 0.35 + 0.30 * rings * patch
    colors = (np.stack([r, g, b], axis=-1) * 255).clip(0, 255)
    return TriMesh(verts, f, vertex_colors=colors)


def make_distractor(seed, radius=0.025):
    """Small textured blob used as clutter / occluder."""
    v, f = icosphere(subdivisions=2)
    rng = np.random.RandomState(seed)
    amp = 0.25 * rng.randn(len(v), 3).mean(axis=1)
    verts = v * (1.0 + amp)[:, None] * radius
    colors = (rng.rand(1, 3) * 0.5 + 0.25) * 255 * np.ones((len(v), 1))
    return TriMesh(verts, f, vertex_colors=np.tile(colors.mean(axis=-1, keepdims=True), (1, 3))
                   + rng.rand(len(v), 3) * 60)


def merge(a: TriMesh, b: TriMesh) -> TriMesh:
    return TriMesh(np.concatenate([a.vertices, b.vertices]),
                   np.concatenate([a.faces, b.faces + len(a.vertices)]),
                   vertex_colors=np.concatenate([a.vertex_colors, b.vertex_colors]))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(out_dir="demo_data/synth_box", n_frames=6, H=480, W=640, seed=0, variant="box",
         sensor=False, sensor_strength=1.0, device=None, stats=None, render=render_batch):
    """The JAX tool's scene (see its docstring for the variants) on @device
    (None = the card).  @stats: a dict that gets the seconds spent
    rendering, in the sensor chain and writing files, the frame count and
    the rendering intrinsics K' (the sensor scenes' perturbed K).
    @render: the renderer, render_batch's signature (a checking caller's
    wrapper).  Returns @out_dir."""
    dev = resolve_device(device)
    seconds = {"render": 0.0, "sensor": 0.0, "write": 0.0}
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    for sub in ["rgb", "depth", "pcd", "masks", "mesh", "background", "heatmap", "configs",
                "annotated_poses"]:
        os.makedirs(f"{out_dir}/{sub}", exist_ok=True)

    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]])
    # the sensor scenes render with the true K' while the dataset reports K
    K_render = sensor_model.perturb_K(K, rng, sensor_strength) if sensor else K

    if variant in ("clutter", "occl"):
        obj = make_target_part(seed + 1)
        plane = make_scene_plane(textured=True, seed=seed)
        heavy = variant == "occl"
        front = (0.041, -0.010, 0.468) if heavy else (0.045, -0.012, 0.47)
        front_r = 0.036 if heavy else 0.028
        fixtures = []
        for k, (cx, cy, cz) in enumerate([(0.09, -0.05, 0.60), (-0.10, 0.06, 0.595), front]):
            d = make_distractor(seed + 10 + k, radius=front_r if k == 2 else 0.032)
            d.vertices = d.vertices + np.array([[cx, cy, cz]])
            fixtures.append(d)
        statics = plane
        for d in fixtures:
            statics = merge(statics, d)
    else:
        obj = make_object_mesh(seed)
        statics = make_scene_plane()

    base_pose = euler_matrix(0.4, 0.2, 0.3)
    base_pose[:3, 3] = [0.01, -0.02, 0.55]

    extr = {
        "color_to_depth": {"rotation_matrix": np.eye(3).tolist(),
                           "translation_vector": [[0.0, 0.0, 0.0]]},
        "depth_to_color": {"rotation_matrix": np.eye(3).tolist(),
                           "translation_vector": [[0.0, 0.0, 0.0]]},
    }
    with open(f"{out_dir}/configs/camera_extrinsics.json", "w") as f:
        json.dump(extr, f, indent=2)
    intr = {
        "color": {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
                  "width": W, "height": H},
        "depth": {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
                  "width": W, "height": H},
    }
    with open(f"{out_dir}/configs/camera_intrinsics.json", "w") as f:
        json.dump(intr, f, indent=2)
    with open(f"{out_dir}/configs/icp_parameters.json", "w") as f:
        json.dump(ICP_PARAMETERS, f, indent=2)

    # meshes: model.obj + model.ply in mm, model_scaled_down.obj in meters
    obj_mm = obj.copy()
    obj_mm.vertices = obj_mm.vertices * 1000.0
    save_mesh(f"{out_dir}/mesh/model.obj", obj_mm)
    save_mesh(f"{out_dir}/mesh/model_scaled_down.obj", obj)
    save_point_cloud(f"{out_dir}/mesh/model.ply", obj_mm.sample_points(20000, seed=1))

    # background: the empty scene's cloud in mm (depth frame)
    if variant == "clutter":
        bg_pts = statics.sample_points(24000, seed=2).points
    else:
        bg_pts = np.concatenate(
            [(rng.rand(20000, 2) - 0.5) * 0.5, np.full((20000, 1), 0.62)], axis=-1)
    if sensor:
        bg_pts = bg_pts + rng.randn(*np.shape(bg_pts)) * 0.0015
    save_point_cloud(f"{out_dir}/background/box.ply", PointCloud(bg_pts * 1000.0))

    # heatmap: a gaussian blob on the centre square crop, scaled to 480
    hm_size = 480
    yy, xx = np.mgrid[0:hm_size, 0:hm_size]
    scale = hm_size / min(H, W)
    uvw = K_render @ base_pose[:3, 3]
    u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
    u_hm = (u - (W / 2 - min(H, W) / 2)) * scale
    v_hm = (v - (H / 2 - min(H, W) / 2)) * scale
    heatmap = np.exp(-(((xx - u_hm) ** 2 + (yy - v_hm) ** 2) / (2 * 18.0**2)))
    np.save(f"{out_dir}/heatmap/0002.npy", heatmap.astype(np.float32))

    arrays_obj = make_mesh_arrays(obj, dev)
    arrays_statics = make_mesh_arrays(statics, dev)
    K_t = torch.as_tensor(K_render, dtype=torch.float32, device=dev)
    identity = torch.eye(4, dtype=torch.float32, device=dev)[None]

    if sensor:
        drift_gains = sensor_model.sequence_drift(n_frames, rng, sensor_strength)
    prev_uv = None
    for i in range(n_frames):
        if variant == "recon":
            # a full revolution in the object frame with a tilt oscillation
            spin = 2.0 * np.pi * i / n_frames
            tilt = 0.7 * np.sin(2.0 * np.pi * i / n_frames * 2.0)
            pose = base_pose @ euler_matrix(tilt, spin, 0.3 * np.sin(spin))
            pose[:3, 3] = base_pose[:3, 3]
        else:
            delta = euler_matrix(0.015 * i, -0.01 * i, 0.02 * i)
            delta[:3, 3] = [0.002 * i, 0.001 * i, -0.003 * i]
            pose = delta @ base_pose

        t0 = time.perf_counter()
        pose_t = torch.as_tensor(pose[None], dtype=torch.float32, device=dev)
        rend_o = render(arrays_obj, pose_t, K_t, None, out_hw=(H, W))
        rend_p = render(arrays_statics, identity, K_t, None, out_hw=(H, W))
        do, dp = rend_o["depth"][0].cpu().numpy(), rend_p["depth"][0].cpu().numpy()
        co, cp = rend_o["color"][0].cpu().numpy(), rend_p["color"][0].cpu().numpy()
        _sync(dev)
        t1 = time.perf_counter()
        seconds["render"] += t1 - t0
        obj_front = (do > 0) & ((dp <= 0) | (do < dp))
        depth = np.where(obj_front, do, dp)
        color = np.where(obj_front[..., None], co, cp)
        if sensor:
            # motion blur (shutter), exposure drift (gain), then noise
            uvw_i = K_render @ pose[:3, 3]
            uv_i = uvw_i[:2] / uvw_i[2]
            if prev_uv is not None:
                color = sensor_model.motion_blur_rgb(color, uv_i - prev_uv, sensor_strength)
            prev_uv = uv_i
            color = np.clip(color * drift_gains[i], 0.0, 1.0)
            depth = sensor_model.degrade_depth(depth, rng, sensor_strength)
            color = sensor_model.degrade_rgb(color, rng, sensor_strength)
        else:
            noise = rng.randn(H, W) * 0.0015
            depth = np.where(depth > 0, depth + noise, 0.0)
            color = np.clip(color + rng.randn(H, W, 3) * 0.01, 0, 1)
        mask = None
        if i == 0 or variant == "recon":
            mask = (obj_front * 255).astype(np.uint8)
            if sensor:
                mask = sensor_model.degrade_mask(mask, rng, sensor_strength)
        # scene cloud in mm (depth frame)
        ys, xs = np.where(depth > 0)
        sel = rng.choice(len(ys), size=min(len(ys), 60000), replace=False)
        ys, xs = ys[sel], xs[sel]
        z = depth[ys, xs]
        px = (xs - K[0, 2]) * z / K[0, 0]
        py = (ys - K[1, 2]) * z / K[1, 1]
        cloud = np.stack([px, py, z], axis=-1) * 1000.0
        t2 = time.perf_counter()
        seconds["sensor"] += t2 - t1

        write_png_rgb8(f"{out_dir}/rgb/rgb_{i:04d}.png", (color * 255).astype(np.uint8))
        write_png_gray16(f"{out_dir}/depth/depth_{i:04d}.png", (depth * 1000).astype(np.uint16))
        if mask is not None:
            write_png_gray8(f"{out_dir}/masks/{i:04d}.png", mask)
        np.savetxt(f"{out_dir}/annotated_poses/{i:04d}.txt", pose.reshape(4, 4))
        save_point_cloud(f"{out_dir}/pcd/cloud_{i:04d}.ply", PointCloud(cloud))
        seconds["write"] += time.perf_counter() - t2

    if stats is not None:
        stats.update(seconds=seconds, frames=n_frames, K_render=K_render)
    print(f"wrote {n_frames} frames to {out_dir}")
    return out_dir


# What a generated scene is held to against the JAX tool's files of the
# same scene (chip_smoke.py phase `scene`, tests/test_torch_demo_scene.py).
# Poses, meshes, model.ply, the background cloud, the heatmap, the camera
# configs and the masks are equal.  The rest differs where the port's
# float32 raster set-up rounds apart from XLA's: plane depths tens of ulp
# apart (up to 0.4 mm on grazing triangles), and on a pixel at the edge of
# a nearer surface the edge test can decide the other way, so the surface
# behind shows there (a coverage flip; the object's mask is the same).
# Measured over the six committed scenes (the port on the CPU and on the
# card against the files, the same counts on both): depth PNGs differ on
# at most 0.06% of pixels, by 1-2 mm but on 1 pixel (a 30 mm flip in
# synth_box_recon's 40 self-occluding views); RGB within 1 level but on 9
# of 21.5 million pixels (flips, up to 70 levels); clouds within 1 mm
# (the sensor model's mm rounding) but on 1 point (1.55 mm).  The gates: at most `depth_share` of pixels differ,
# at most `far_share` of pixels (of cloud points) by more than `depth_mm`
# (`cloud_mm`), and at most `far_share` of pixels by more than
# `rgb_levels`.
SCENE_GATES = dict(depth_mm=2, cloud_mm=1.0 + 1e-6, rgb_levels=1, depth_share=2e-3,
                   far_share=2e-4)
EXACT_FILES = ["configs/camera_extrinsics.json", "configs/camera_intrinsics.json",
               "mesh/model.obj", "mesh/model_scaled_down.obj", "mesh/model.ply",
               "background/box.ply", "heatmap/0002.npy"]


def compare_scenes(a, b, n_frames):
    """How scene directory @b differs from @a over @n_frames frames: the
    files that differ of those that must be equal (and the annotated
    poses), the masks' differing pixels, the depth and RGB PNGs' differing
    pixels, those beyond SCENE_GATES' depth_mm / rgb_levels and the
    largest difference, and the clouds' largest point distance (mm), the
    share of points more than 1e-3 mm apart and beyond cloud_mm."""
    import filecmp

    from sixdof_tpu_torch.io.mesh_io import load_point_cloud
    from sixdof_tpu_torch.io.png import read_png

    exact = EXACT_FILES + [f"annotated_poses/{i:04d}.txt" for i in range(n_frames)]
    out = {"exact_differ": [f for f in exact
                            if not filecmp.cmp(f"{a}/{f}", f"{b}/{f}", shallow=False)],
           "pixels": 0, "mask_px": 0, "depth_px": 0, "depth_far_px": 0, "depth_max": 0,
           "rgb_px": 0, "rgb_over_px": 0, "rgb_max": 0, "cloud_mm": 0.0,
           "cloud_changed_share": 0.0, "cloud_far_share": 0.0, "cloud_sizes_equal": True}
    masks = sorted(os.listdir(f"{a}/masks"))
    if masks != sorted(os.listdir(f"{b}/masks")):
        out["exact_differ"].append("masks/")
    for kind, files in (("mask", [f"masks/{m}" for m in masks]),
                        ("depth", [f"depth/depth_{i:04d}.png" for i in range(n_frames)]),
                        ("rgb", [f"rgb/rgb_{i:04d}.png" for i in range(n_frames)])):
        for f in files:
            x = read_png(f"{a}/{f}").astype(np.int64)
            y = read_png(f"{b}/{f}").astype(np.int64)
            d = np.abs(x - y).reshape(x.shape[0], x.shape[1], -1).max(axis=-1)
            out[f"{kind}_px"] += int((d > 0).sum())
            if kind == "rgb":
                out["pixels"] += d.size
                out["rgb_over_px"] += int((d > SCENE_GATES["rgb_levels"]).sum())
            if kind == "depth":
                out["depth_far_px"] += int((d > SCENE_GATES["depth_mm"]).sum())
            if kind != "mask":
                out[f"{kind}_max"] = max(out[f"{kind}_max"], int(d.max()))
    changed, far, total = 0, 0, 0
    for i in range(n_frames):
        p = load_point_cloud(f"{a}/pcd/cloud_{i:04d}.ply").points
        q = load_point_cloud(f"{b}/pcd/cloud_{i:04d}.ply").points
        if p.shape != q.shape:
            out["cloud_sizes_equal"] = False
            continue
        d = np.abs(p - q).max(axis=-1) if len(p) else np.zeros(0)
        out["cloud_mm"] = max(out["cloud_mm"], float(d.max()) if len(d) else 0.0)
        changed += int((d > 1e-3).sum())
        far += int((d > SCENE_GATES["cloud_mm"]).sum())
        total += len(d)
    out["cloud_changed_share"] = changed / max(total, 1)
    out["cloud_far_share"] = far / max(total, 1)
    return out


def scene_breaches(diff):
    """The SCENE_GATES a `compare_scenes` result breaks (empty: it holds)."""
    g = SCENE_GATES
    far = g["far_share"] * diff["pixels"]
    checks = [
        (diff["exact_differ"] == [], f"files differ: {diff['exact_differ']}"),
        (diff["mask_px"] == 0, f"{diff['mask_px']} mask pixels differ"),
        (diff["depth_px"] <= g["depth_share"] * diff["pixels"] and diff["depth_far_px"] <= far,
         f"depth: {diff['depth_px']} px differ, {diff['depth_far_px']} by over "
         f"{g['depth_mm']} mm"),
        (diff["rgb_over_px"] <= far,
         f"rgb: {diff['rgb_over_px']} px over {g['rgb_levels']} level"),
        (diff["cloud_sizes_equal"] and diff["cloud_far_share"] <= g["far_share"],
         f"clouds: sizes equal {diff['cloud_sizes_equal']}, a share "
         f"{diff['cloud_far_share']} over {g['cloud_mm']} mm"),
    ]
    return [msg for ok, msg in checks if not ok]


def parse_args(argv):
    """The JAX tool's command line: [out_dir] [n_frames] [variant], --sensor,
    the variant and the sensor model inferred from the directory's name;
    plus --device."""
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    pos = [a for a in argv if not a.startswith("--")]
    out = pos[0] if pos else "demo_data/synth_box"
    n = int(pos[1]) if len(pos) > 1 else 6
    if len(pos) > 2:
        variant = pos[2]
    elif "occl" in out:
        variant = "occl"
    elif "clutter" in out:
        variant = "clutter"
    elif "recon" in out:
        variant = "recon"
    else:
        variant = "box"
    sensor = "--sensor" in argv or "sensor" in os.path.basename(out)
    if variant.endswith("_sensor"):
        variant = variant[: -len("_sensor")]
        sensor = True
    return dict(out_dir=out, n_frames=n, variant=variant, sensor=sensor, device=device)


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
