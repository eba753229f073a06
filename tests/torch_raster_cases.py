"""Inputs for raster kernel K1 and its tile-binning rule, shared by
tests/test_torch_raster_binning.py (CPU) and tests/test_torch_kernels_cuda.py
(the card).  Imports no JAX.

Each case is (coef_c, counts, H, W): compacted plane coefficients as
`zbuffer_setup` makes them, either from synth_box's mesh at seeded poses or
from triangles placed by hand in crop pixels to hit the binning rule's
edges: slivers one ulp wide, triangles larger than the crop, vertices on
tile borders and pixel centres, exact inverse-depth ties across tiles,
poses with no candidates, crops whose sides are not multiples of 16."""
import os

import numpy as np
import torch

from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch
from sixdof_tpu_torch.ops.hypotheses import make_rotation_grid
from sixdof_tpu_torch.ops.rasterize import _tri_setup, make_mesh_arrays, zbuffer_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
K_IMG = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)


def scene_case(device, B, hw, cull=True, seed=0):
    """synth_box's mesh at B seeded poses of the rotation grid, 0.55 m away,
    rendered into (H, W) crop windows."""
    mesh = load_mesh(MESH)
    mesh.vertices -= (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    arrays = make_mesh_arrays(mesh, device)
    grid = make_rotation_grid()[:: max(1, 252 // B)][:B].copy()
    grid[:, :3, 3] = np.array([0.0, 0.0, 0.55]) + np.random.RandomState(seed).uniform(
        -0.02, 0.02, (B, 3))
    poses = torch.tensor(grid, dtype=torch.float32, device=device)
    K = torch.tensor(K_IMG, device=device)
    tfs = compute_crop_window_tf_batch(poses, K, 1.2, (hw[1], hw[0]), 0.1)
    s = zbuffer_setup(arrays, poses, K, tfs, backface_cull=cull)
    return s["coef_c"], s["counts"], hw[0], hw[1]


def from_triangles(uv, z, device):
    """Planes of hand-placed triangles: @uv (B,T,3,2) crop pixels, @z (B,T,3)
    camera depths, float32; compacted valid-first as zbuffer_setup does."""
    B, T = uv.shape[:2]
    faces = torch.arange(3 * T, device=device).reshape(T, 3)
    uv = torch.as_tensor(np.asarray(uv, np.float32).reshape(B, 3 * T, 2), device=device)
    z = torch.as_tensor(np.asarray(z, np.float32).reshape(B, 3 * T), device=device)
    coef, valid = _tri_setup(uv, z, faces)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    coef_c = torch.take_along_dim(coef, order[..., None, None], dim=1).contiguous()
    return coef_c, valid.sum(dim=1).to(torch.int32)


def _slivers(rng):
    """Triangles one float32 ulp wide along pixel rows, columns and a
    diagonal, over a background at several depths."""
    tris, zs = [], []
    for y in (0.0, 7.0, 15.0, 16.0, 23.0):
        up = float(np.nextafter(np.float32(y), np.float32(np.inf)))
        tris.append([[1.0, y], [44.0, y], [22.5, up]])  # along a pixel row
        zs.append([0.4, 0.4, 0.4])
    for x in (15.0, 16.0, 30.0):
        right = float(np.nextafter(np.float32(x), np.float32(np.inf)))
        tris.append([[x, 0.0], [right, 20.0], [x, 39.0]])  # along a pixel column
        zs.append([0.45, 0.5, 0.55])
    d = float(np.nextafter(np.float32(33.0), np.float32(np.inf)))
    tris.append([[0.0, 0.0], [33.0, d], [33.0, 33.0]])  # along the diagonal
    zs.append([0.3, 0.3, 0.3])
    for _ in range(6):  # background
        tris.append(rng.uniform(-5, 50, (3, 2)).tolist())
        zs.append(rng.uniform(0.6, 0.9, 3).tolist())
    return np.array([tris]), np.array([zs]), 40, 50


def _huge(rng):
    """Triangles far larger than the crop, one with an edge through it."""
    tris = [[[-1e4, -1e4], [1e4, -1e4], [0.0, 1e4]],
            [[-3e3, 2e3], [3e3, 2e3], [0.0, -4e3]],
            [[-500.0, 8.5], [600.0, 8.5], [50.0, 900.0]],  # bottom part only
            [[5.0, 5.0], [12.0, 5.0], [5.0, 11.0]]]  # small, in front
    zs = [[0.5, 0.6, 0.7], [0.45, 0.45, 0.45], [0.3, 0.3, 0.3], [0.2, 0.2, 0.2]]
    return np.array([tris]), np.array([zs]), 33, 17


def _borders(rng, n=120):
    """Vertices on tile borders (15, 16, 31, 32, ...) and pixel centres."""
    coords = np.array([0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 63], np.float32)
    xy = rng.choice(coords, size=(2, n, 3, 2))
    z = rng.uniform(0.3, 0.9, (2, n, 3))
    return xy, z, 47, 63


def _ties(rng):
    """Exact inverse-depth ties: fronto-parallel triangles at one depth that
    overlap across tiles, duplicates at several indices, and two halves of
    a quad meeting on a tile border."""
    big = [[2.0, 3.0], [60.0, 10.0], [20.0, 36.0]]
    tris = [big, [[10.0, 1.0], [50.0, 30.0], [5.0, 30.0]], big, big,
            [[0.0, 0.0], [32.0, 0.0], [32.0, 32.0]], [[0.0, 0.0], [32.0, 32.0], [0.0, 32.0]],
            [[16.0, 16.0], [48.0, 16.0], [16.0, 48.0]]]
    zs = [[0.5, 0.5, 0.5]] * len(tris)
    return np.array([tris, tris[::-1]]), np.array([zs, zs]), 37, 53


def _soup(rng, n=300):
    """A random soup of overlapping triangles of every size."""
    centre = rng.uniform(-8, 72, (2, n, 1, 2))
    xy = centre + rng.randn(2, n, 3, 2) * rng.choice([1.0, 6.0, 30.0], (2, n, 1, 1))
    return xy, rng.uniform(0.3, 1.5, (2, n, 3)), 64, 80


ADVERSARIAL = {"slivers": _slivers, "huge": _huge, "borders": _borders, "ties": _ties,
               "soup": _soup}


def adversarial_case(name, device):
    uv, z, H, W = ADVERSARIAL[name](np.random.RandomState(len(name)))
    coef, counts = from_triangles(uv, z, device)
    return coef, counts, H, W


def empty_case(device):
    """Three poses of a soup: the middle one with its count set to 0, the
    last with every triangle behind the camera (so its count is 0)."""
    uv, z, H, W = _soup(np.random.RandomState(5), n=40)
    uv = np.concatenate([uv, uv[:1]])
    z = np.concatenate([z, -z[:1]])
    coef, counts = from_triangles(uv, z, device)
    counts[1] = 0
    return coef, counts, H, W
