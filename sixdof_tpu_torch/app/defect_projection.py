"""Defect projection: 2-D heatmap -> rays -> 3-D mesh intersections + overlay.

Port of `sixdof_tpu/app/defect_projection.py`: camera intrinsics and
extrinsics, `heatmap_to_points`, `compute_rays`, `intersect_rays_with_mesh`,
`create_intersection_pcd`, `project_debug_rays`, `ray_tracing`, the heatmap
overlay (`create_heatmap_overlay`, `save_overlay`), the depth-projection
path (`heatmap_to_point3d`, `align_to_surface`, `calc_coordinates`,
`depth_projection_heatmap`) and the point-click paths (`choose_points`,
`create_mesh`, `ray_tracing_points`, `depth_projection_points`,
`visualize`).  Every ray-mesh intersection runs on the caller's device
through kernel K2 (`ops/raytrace.py`).  `generate_centered_heatmap`, a
test-data helper of the JAX package built on OpenCV's Gaussian blur, is not
ported.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..device import resolve_device
from ..io.mesh_io import PointCloud, TriMesh
from ..io.png import write_png_rgb8
from ..ops import raytrace as rt
from ..utils.colormap import apply_jet, jet_colormap

MAX_DEFECT_RAYS = 8192  # the JAX app's static padding for thresholded heatmap pixels


@dataclass
class PinholeCameraIntrinsic:
    """Open3D PinholeCameraIntrinsic stand-in."""

    width: int
    height: int
    intrinsic_matrix: np.ndarray

    @classmethod
    def from_params(cls, width, height, fx, fy, cx, cy):
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        return cls(width, height, K)


def load_intrinsics(json_file_path):
    """configs/camera_intrinsics.json -> (color, depth) pinhole intrinsics."""
    with open(json_file_path, "r") as f:
        intr = json.load(f)
    depth = PinholeCameraIntrinsic.from_params(
        intr["depth"]["width"], intr["depth"]["height"],
        intr["depth"]["fx"], intr["depth"]["fy"], intr["depth"]["cx"], intr["depth"]["cy"],
    )
    color = PinholeCameraIntrinsic.from_params(
        intr["color"]["width"], intr["color"]["height"],
        intr["color"]["fx"], intr["color"]["fy"], intr["color"]["cx"], intr["color"]["cy"],
    )
    return color, depth


def load_extrinsics(file_path):
    """{file_path}/configs/camera_extrinsics.json -> (color_to_depth,
    depth_to_color) 4x4 transforms."""
    with open(f"{file_path}/configs/camera_extrinsics.json", "r") as f:
        data = json.load(f)

    def build(key):
        tf = np.eye(4)
        tf[:3, :3] = np.array(data[key]["rotation_matrix"])
        tf[:3, 3] = np.array(data[key]["translation_vector"]).reshape(-1)[:3]
        return tf

    return build("color_to_depth"), build("depth_to_color")


def generate_centered_heatmap(image_shape, max_intensity=1.0, sigma=50):
    """A Gaussian blob at the image centre (OpenCV's GaussianBlur of an
    impulse), scaled to a peak of 1."""
    from ..io.readers import gaussian_blur

    heatmap = np.zeros(image_shape)
    heatmap[image_shape[0] // 2, image_shape[1] // 2] = max_intensity
    heatmap = gaussian_blur(heatmap, sigma)
    return heatmap / np.max(heatmap)


def heatmap_to_points(heatmap, threshold=0.5):
    """Thresholded pixel list [(x, y, intensity), ...]."""
    y_coords, x_coords = np.where(heatmap > threshold)
    intensities = heatmap[y_coords, x_coords]
    return list(zip(x_coords, y_coords, intensities))


def compute_rays(points, intrinsic):
    """2-D points (+intensity) -> unit rays in the colour camera, intensities."""
    K = intrinsic.intrinsic_matrix
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    rays = np.stack(
        [(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy, np.ones(len(pts))], axis=-1
    )
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays, pts[:, 2].copy()


def intersect_rays_with_mesh(mesh: TriMesh, rays, origin, intensities, device=None,
                             plain_raytrace=False):
    """First hits of rays from @origin on @mesh, on @device (None = the card).

    Returns (intersection_points (M,3), intersection_intensities (M,))."""
    dev = resolve_device(device)
    tri, tri_mask = rt.mesh_to_tri_verts(mesh.vertices, mesh.faces)
    n = len(rays)
    origins = np.tile(np.asarray(origin, dtype=np.float32)[None], (n, 1))
    t = rt.ray_mesh_intersect(
        torch.as_tensor(origins, device=dev),
        torch.as_tensor(np.asarray(rays), dtype=torch.float32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.as_tensor(tri, device=dev), torch.as_tensor(tri_mask, device=dev),
        use_pallas=not plain_raytrace,
    ).cpu().numpy()
    valid = np.isfinite(t)
    pts = origins[valid] + np.asarray(rays)[valid] * t[valid, None]
    return pts, np.asarray(intensities)[valid]


def create_intersection_pcd(intersections, intensities):
    """Jet-coloured defect point cloud."""
    rng = np.max(intensities) - np.min(intensities)
    normalized = (intensities - np.min(intensities)) / (rng if rng > 0 else 1.0)
    return PointCloud(intersections, colors=jet_colormap(normalized))


def project_debug_rays(rays, origin):
    """The cloud shown when nothing intersects: the ray origins and the ray
    endpoints 1000 units out, in red."""
    logging.info("No intersections found.")
    pts = np.vstack([np.tile(origin, (len(rays), 1)), origin + rays * 1000])
    pcd = PointCloud(pts)
    pcd.paint_uniform_color([1, 0, 0])
    return pcd


def create_heatmap_overlay(color_image, heatmap, min_intensity=0.1, max_intensity=0.9):
    """The heatmap in JET (BGR, as the JAX package's apply_jet gives it)
    blended 0.2 over @color_image at 0.8, as uint8."""
    hm_min, hm_max = np.min(heatmap), np.max(heatmap)
    normalized = (heatmap - hm_min) / max(hm_max - hm_min, 1e-12)
    clipped = np.clip(normalized, min_intensity, max_intensity)
    clipped = (clipped - min_intensity) / (max_intensity - min_intensity)
    heatmap_rgb = apply_jet((clipped * 255).astype(np.uint8))
    img = np.asarray(color_image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] == 4:
        img = img[..., :3]
    overlay = (img.astype(np.float64) * 0.8 + heatmap_rgb.astype(np.float64) * 0.2)
    return np.clip(overlay, 0, 255).astype(np.uint8)


def save_overlay(overlay, save_path="overlay_image.png"):
    """Write @overlay as the JAX package's ``cv2.imwrite(save_path,
    overlay)`` does: the array is taken as BGR, so the file's RGB is the
    array reversed.  The file is replaced at once (a temporary file, then a
    rename), so the viewer never serves a half-written image."""
    directory = os.path.dirname(save_path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".png", dir=directory or ".")
    os.close(fd)
    try:
        write_png_rgb8(tmp, np.asarray(overlay)[..., 2::-1])
        os.replace(tmp, save_path)
    except BaseException:
        os.unlink(tmp)
        raise


def ray_tracing(data_dir, target_mesh, heatmap, color_intrinsics, heatmap_threshold=0.5,
                device=None, plain_raytrace=False):
    """Project heatmap defects onto the posed mesh.

    The mesh arrives posed in the DEPTH frame; rays live in the COLOUR frame,
    so the mesh is moved by inv(color_to_depth) before intersecting.
    @device: None = the card; @plain_raytrace: K2's plain version (a
    comparison run).  Returns (intersection_pcd_or_debug_rays,
    transformed_mesh).
    """
    origin = np.array([0.0, 0.0, 0.0])
    color_to_depth_trans, _ = load_extrinsics(data_dir)

    target_mesh_copy = target_mesh.copy()
    target_mesh_copy.transform(np.linalg.inv(color_to_depth_trans))
    points_with_intensity = heatmap_to_points(heatmap, heatmap_threshold)
    if len(points_with_intensity) == 0:
        return PointCloud(np.zeros((0, 3))), target_mesh_copy

    rays, intensities = compute_rays(points_with_intensity, color_intrinsics)
    intersections, intersection_intensities = intersect_rays_with_mesh(
        target_mesh_copy, rays, origin, intensities, device=device,
        plain_raytrace=plain_raytrace,
    )
    if len(intersections) > 0:
        return create_intersection_pcd(intersections, intersection_intensities), target_mesh_copy
    return project_debug_rays(rays, origin), target_mesh_copy


# ----------------------------------------------- depth-projection alt path --


def heatmap_to_point3d(heatmap, depth_image, intrinsic, threshold=0.1):
    """Back-project the heatmap's pixels above @threshold (of its maximum)
    through the depth image: (M,4) rows (x, y, 0.98 z, intensity)."""
    H, W = heatmap.shape
    dh, dw = depth_image.shape
    h = min(H, dh)
    w = min(W, dw)
    hm = heatmap[:h, :w] / np.max(heatmap)
    dp = depth_image[:h, :w]
    ys, xs = np.where((hm > threshold) & (dp > 0))
    K = intrinsic.intrinsic_matrix
    depth = dp[ys, xs].astype(np.float64)
    x3d = (xs - K[0, 2]) * depth / K[0, 0]
    y3d = (ys - K[1, 2]) * depth / K[1, 1]
    return np.stack([x3d, y3d, depth * 0.98, hm[ys, xs]], axis=-1)


def align_to_surface(defect_points, target_pcd: PointCloud, offset=0.1):
    """Snap defect points to their nearest target point, and that point
    moved @offset along its normal.  Returns (offset points, snapped)."""
    from ..ops.pointcloud import estimate_normals

    if target_pcd.normals is None:
        estimate_normals(target_pcd, radius=0.1, max_nn=30)
    tree = cKDTree(target_pcd.points)
    _, idx = tree.query(np.asarray(defect_points)[:, :3], k=1, workers=-1)
    aligned = target_pcd.points[idx]
    offsets = aligned + target_pcd.normals[idx] * offset
    return offsets, aligned


def calc_coordinates(depth_image, points, intrinsic):
    """Clicked pixels [(x, y), ...] + depth -> (M,3) camera points; pixels
    without depth are skipped."""
    K = intrinsic.intrinsic_matrix
    out = []
    for x, y in points:
        depth = depth_image[y, x]
        if depth == 0:
            logging.info(f"Depth is zero at coordinates x = {x}, y = {y}. Skipping this point.")
            continue
        out.append([(x - K[0, 2]) * depth / K[0, 0], (y - K[1, 2]) * depth / K[1, 1], depth])
    return np.array(out, dtype=np.float64)


def depth_projection_heatmap(depth_image, intrinsic, target, defects):
    """The heatmap's defects back-projected through the depth image and
    snapped to @target.  Returns (offset points, snapped points, point3d)."""
    point3d = heatmap_to_point3d(defects, depth_image, intrinsic)
    offset_points, aligned_points = align_to_surface(point3d, target, offset=0.5)
    return offset_points, aligned_points, point3d


# ------------------------------------------------ point-click defect paths --


def choose_points(image, points=None):
    """Defect pixels of @image: @points, pre-selected [(x, y), ...] (the
    headless path), or, when omitted, clicked in a matplotlib window (left
    click adds, ESC finishes; needs a display)."""
    if points is not None:
        return [tuple(int(v) for v in p) for p in points]
    import matplotlib

    if matplotlib.get_backend().lower() == "agg":
        raise RuntimeError(
            "choose_points: no display available — pass points=[(x, y), ...] "
            "(the headless path) instead of interactive selection"
        )
    import matplotlib.pyplot as plt

    chosen = []
    fig, ax = plt.subplots()
    if image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        ax.imshow(image, cmap="gray")
    else:
        ax.imshow(image)
    ax.set_title("Click to select points. Press ESC to finish.")

    def onclick(event):
        if event.button == 1 and event.xdata is not None and event.ydata is not None:
            chosen.append((int(event.xdata), int(event.ydata)))
            ax.plot(int(event.xdata), int(event.ydata), "ro")
            fig.canvas.draw()

    def onkey(event):
        if event.key == "escape":
            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", onclick)
    fig.canvas.mpl_connect("key_press_event", onkey)
    plt.show()
    return chosen


def create_mesh(pcd: PointCloud, resolution=64, iso=None):
    """A surface mesh of a point cloud: the isosurface of its unsigned
    distance field at @iso (default: 2.5x the median nearest-neighbour
    spacing, at least 1.2 grid cells) on a @resolution^3 grid, by marching
    tetrahedra — a closed crust that rays meet where they would meet the
    sampled surface."""
    from ..ops.marching import marching_tetrahedra

    pts = np.asarray(pcd.points, dtype=np.float64)
    if len(pts) < 4:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    pad = 0.05 * (hi - lo).max() + 1e-9
    lo, hi = lo - pad, hi + pad
    lin = [np.linspace(lo[k], hi[k], resolution) for k in range(3)]
    grid = np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1).reshape(-1, 3)
    tree = cKDTree(pts)
    d, _ = tree.query(grid, k=1, workers=-1)
    if iso is None:
        # the crust must cover the sampling gaps (2-2.5x the median nearest-
        # neighbour distance), and the band must span more than one grid
        # cell or marching misses it
        nn, _ = tree.query(pts, k=2, workers=-1)
        voxel = float((hi - lo).max()) / (resolution - 1)
        iso = max(2.5 * float(np.median(nn[:, 1])), 1.2 * voxel)
    field = (d - iso).reshape(resolution, resolution, resolution)
    verts, faces = marching_tetrahedra(field, 0.0)
    if len(verts) == 0:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    verts = lo[None] + verts / (resolution - 1) * (hi - lo)[None]
    return TriMesh(verts, faces)


def ray_tracing_points(data_dir, target, intrinsic_parameters, image, points=None, device=None,
                       plain_raytrace=False):
    """Point-click ray tracing: @target (a PointCloud, meshed by
    create_mesh, or a TriMesh; depth camera) is moved into the colour camera
    and the rays through the chosen pixels meet it on @device (None = the
    card), through K2 (@plain_raytrace: its plain version).
    Returns (intersection PointCloud | debug rays, mesh)."""
    origin = np.zeros(3)
    color_to_depth_trans, _ = load_extrinsics(data_dir)

    mesh = create_mesh(target) if isinstance(target, PointCloud) else target.copy()
    mesh.vertices = (
        mesh.vertices @ np.linalg.inv(color_to_depth_trans)[:3, :3].T
        + np.linalg.inv(color_to_depth_trans)[:3, 3]
    )

    sel = choose_points(image, points=points)
    if not sel:
        return PointCloud(np.zeros((0, 3))), mesh
    pts = [(x, y, 1.0) for x, y in sel]
    rays, intensities = compute_rays(pts, intrinsic_parameters)
    hits, _ = intersect_rays_with_mesh(mesh, rays, origin, intensities, device=device,
                                       plain_raytrace=plain_raytrace)
    if len(hits) > 0:
        return PointCloud(hits, colors=np.tile([[255.0, 0.0, 0.0]], (len(hits), 1))), mesh
    logging.info("No intersections found.")
    return project_debug_rays(rays, origin), mesh


def depth_projection_points(depth_image, intrinsic, target, points=None):
    """The chosen depth-image pixels back-projected and snapped to @target.
    Returns (offset points, snapped points, point3d)."""
    sel = choose_points(depth_image, points=points)
    point3d = calc_coordinates(depth_image, sel, intrinsic)
    offset_points, aligned_points = align_to_surface(point3d, target, offset=0.5)
    return offset_points, aligned_points, point3d


def visualize(list_of_objects, out_path=None, data_queue=None):
    """Show meshes and point clouds: with @data_queue, push them to the
    viewer (app/web_vis.py); else write them merged to a PLY file
    (@out_path, default debug/visualize_snapshot.ply)."""
    from ..io.mesh_io import save_point_cloud

    pcds = [o for o in list_of_objects if isinstance(o, PointCloud)]
    meshes = [o for o in list_of_objects if isinstance(o, TriMesh)]
    if data_queue is not None:
        from .web_vis import update_dash_data

        update_dash_data(pcds, meshes[0] if meshes else None)
        return

    def as01(c):
        # every source in [0,1] before merging: 0-255 fills beside [0,1]
        # defect colours would defeat the writer's max() <= 1 rescale
        c = np.asarray(c, dtype=np.float64)
        return c / 255.0 if c.size and c.max() > 1.0 else c

    all_pts, all_cols = [], []
    for p in pcds:
        all_pts.append(np.asarray(p.points))
        all_cols.append(as01(p.colors) if p.colors is not None
                        else np.full((len(p.points), 3), 200.0 / 255.0))
    for m in meshes:
        all_pts.append(np.asarray(m.vertices))
        all_cols.append(as01(m.vertex_colors) if m.vertex_colors is not None
                        else np.full((len(m.vertices), 3), 120.0 / 255.0))
    if not all_pts:
        return
    out_path = out_path or "debug/visualize_snapshot.ply"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_point_cloud(out_path, PointCloud(np.concatenate(all_pts),
                                          colors=np.concatenate(all_cols)))
    logging.info(f"visualize: wrote {out_path}")
