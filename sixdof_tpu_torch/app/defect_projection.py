"""Defect projection: 2-D heatmap -> rays -> 3-D mesh intersections.

Port of `sixdof_tpu/app/defect_projection.py:25-200` (camera intrinsics and
extrinsics, `heatmap_to_points`, `compute_rays`, `intersect_rays_with_mesh`,
`create_intersection_pcd`, `project_debug_rays`, `ray_tracing`).  The
ray-mesh intersection runs on the caller's device through kernel K2
(`ops/raytrace.py`).  The overlay images and the depth-projection
alternative path feed the viewer and are not ported.
"""
from __future__ import annotations

import json
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.mesh_io import PointCloud, TriMesh
from ..ops import raytrace as rt
from ..utils.colormap import jet_colormap

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
        plain=plain_raytrace,
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
