"""Inputs for ray-mesh kernel K2 and its per-block cull test, shared by
tests/test_torch_ray_binning.py (CPU) and tests/test_torch_kernels_cuda.py
(the card).  Imports no JAX.

Each case is (origins, dirs, valid, tri_verts, tri_mask) as numpy float32 /
bool arrays.  `scene_case` is synth_box's model.obj posed by the annotated
pose of frame 0 in the colour camera (mm), traced from the camera centre;
the hand-placed cases aim at the cull test's edges.  A case that needs each
ray judged alone puts one valid ray in each block of the kernel (the rays
between are invalid), so a block's direction box is that one ray."""
import os

import numpy as np
import torch

from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.kernels import raytrace as k2
from sixdof_tpu_torch.ops.raytrace import mesh_to_tri_verts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")


def posed_box():
    """(T,3,3) triangles of model.obj at the annotated pose of frame 0 (mm)."""
    mesh = load_mesh(os.path.join(SCENE, "mesh", "model.obj"))
    gt = np.loadtxt(os.path.join(SCENE, "annotated_poses", "0000.txt"))
    gt[:3, 3] *= 1000.0
    mesh.transform(gt)
    return mesh_to_tri_verts(mesh.vertices, mesh.faces)[0]


def scene_case(step):
    """Every @step-th pixel of the 640x480 colour frame, from the camera
    centre, against the posed box."""
    cam = DataReader(SCENE).color_pinhole
    K = cam.intrinsic_matrix
    ys, xs = np.mgrid[0:cam.height:step, 0:cam.width:step]
    d = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)],
                 axis=-1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tri = posed_box()
    return np.zeros_like(d), d, np.ones(len(d), bool), tri, np.ones(len(tri), bool)


def _tri(v0, e1, e2):
    v0 = np.asarray(v0, np.float64)
    return np.stack([v0, v0 + e1, v0 + e2]).astype(np.float32)


def _unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _one_per_block(dirs, origins=None):
    """Each ray alone in a block of the kernel: the others invalid."""
    R = k2.THREADS >> 5  # these cases stay under a few hundred rays: 32 threads a ray
    n = len(dirs)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n * R, 1))
    d[::R] = dirs
    o = np.zeros_like(d)
    if origins is not None:
        o[::R] = origins
    valid = np.zeros(n * R, bool)
    valid[::R] = True
    assert k2.threads_per_ray_log2(n * R) == 5
    return o, d, valid


def _plain_t(o, d, tri):
    """The plain pair test's t for each ray against each triangle (numpy)."""
    tris = k2.pack_tris(torch.from_numpy(tri), torch.ones(len(tri), dtype=torch.bool))
    return k2.pair_t(torch.from_numpy(o), torch.from_numpy(d),
                     torch.ones(len(o), dtype=torch.bool), tris).numpy()


def exact_bary(o, d, tri):
    """(u, v, det) of every (ray, triangle) pair in float64 from the float32
    inputs: what the pair test would give without rounding."""
    o, d, tri = (np.asarray(x, np.float64) for x in (o, d, tri))
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = np.cross(d[:, None], e2[None])
    det = (p * e1[None]).sum(-1)
    s = o[:, None] - v0[None]
    q = np.cross(s, e1[None])
    with np.errstate(divide="ignore", invalid="ignore"):
        return (s * p).sum(-1) / det, (q * d[:, None]).sum(-1) / det, det


def grazing_case():
    """A 0.2 mm triangle 5 m out, turned by a seeded rotation, whose plane
    passes 0.1 um from the origin: the rays towards it graze it,
    |det| is about 7e-12 (just above the 1e-12 cut), and the pair test's
    rounding makes most of the rays that hit it hit where the exact
    barycentrics lie far outside.  Kept: 30 such false hits, 30 true hits
    and 30 misses, each ray alone in its block."""
    rng = np.random.RandomState(0)
    rot = np.linalg.qr(rng.randn(3, 3))[0]  # no component exactly zero
    tri = _tri(rot @ [-1e-4, 1e-7, 5.0], rot @ [2e-4, 0, 1e-4], rot @ [5e-5, 0, 2e-4])
    v0, e1, e2 = (tri[0].astype(np.float64), (tri[1] - tri[0]).astype(np.float64),
                  (tri[2] - tri[0]).astype(np.float64))
    m = 100_000
    a, b = rng.rand(2, m, 1) * 1.5 - 0.2
    d = _unit(v0 + a * e1 + b * e2)
    o = np.zeros_like(d)
    hit = np.isfinite(_plain_t(o, d, tri[None])[:, 0])
    u, v, det = (x[:, 0] for x in exact_bary(o, d, tri[None]))
    inside = np.minimum(np.minimum(u, v), 1.0 - u - v)
    false_hit = hit & (inside < -1e-5)
    assert false_hit.sum() >= 30 and np.abs(det[hit]).max() < 1e-11
    pick = np.concatenate([np.nonzero(false_hit)[0][:30], np.nonzero(hit & ~false_hit)[0][:30],
                           np.nonzero(~hit)[0][:30]])
    return (*_one_per_block(d[pick]), tri[None], np.ones(1, bool))


def slack_case():
    """A triangle whose vertex v0 lies 33 mm from the origin, 1 m wide:
    rays that cross each edge's line outside the triangle by 2e-7 to 1e-6
    (in barycentric units) hit within the 1e-6 slack.  Each ray alone in
    its block; the rounding margin there is ~5e-8, so only the slack keeps
    the triangle."""
    rng = np.random.RandomState(1)
    tri = _tri([0.01, 0.01, 0.03], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5])
    v0, e1, e2 = (tri[0].astype(np.float64), (tri[1] - tri[0]).astype(np.float64),
                  (tri[2] - tri[0]).astype(np.float64))
    n = 300
    out = -(2e-7 + rng.rand(n) * 8e-7)  # how far outside the edge
    along = 0.2 + rng.rand(n) * 0.6
    edge = np.arange(n) % 3
    a = np.where(edge == 0, out, np.where(edge == 1, along, along - out))
    b = np.where(edge == 0, along, np.where(edge == 1, out, 1.0 - along))
    d = _unit(v0 + a[:, None] * e1 + b[:, None] * e2)
    o = np.zeros_like(d)
    hit = np.isfinite(_plain_t(o, d, tri[None])[:, 0])
    u, v, _ = (x[:, 0] for x in exact_bary(o, d, tri[None]))
    outside = np.minimum(np.minimum(u, v), 1.0 - u - v) < -2e-7
    pick = np.nonzero(hit & outside)[0][:200]
    assert len(pick) >= 30 and {0, 1, 2} <= set(edge[pick].tolist())
    return (*_one_per_block(d[pick]), tri[None], np.ones(1, bool))


def each_edge_case():
    """Three blocks, each with four rays outside exactly one edge of a
    triangle none of whose edges is axis-aligned, and inside the triangle's
    bounding box (so no side plane of the block's box separates them): only
    that edge's plane can drop the triangle, and it must."""
    tri = _tri([0.0, 0.0, 1.0], [1.0, 0.3, 0.0], [0.3, 1.0, 0.0])
    jitter = np.array([[0, 0], [0.01, 0], [0, 0.01], [0.01, 0.01]])
    targets = [np.array([0.8, 0.1]), np.array([0.1, 0.8]), np.array([0.9, 0.9])]
    R = k2.THREADS >> 5  # 3 blocks of rays: 32 threads a ray
    assert k2.threads_per_ray_log2(3 * R) == 5
    xy = np.tile([0.4, 0.4], (3 * R, 1))  # the rays past the first four: invalid
    valid = np.zeros(3 * R, bool)
    for b, t in enumerate(targets):
        xy[b * R:b * R + 4] = t + jitter
        valid[b * R:b * R + 4] = True
    d = _unit(np.concatenate([xy, np.ones((3 * R, 1))], axis=1))
    return np.zeros_like(d), d, valid, tri[None], np.ones(1, bool)


def shared_edges_case():
    """A fan of eight triangles around a vertex on the axis, 2 units out;
    rays aimed exactly at every vertex and every edge's midpoint."""
    ring = np.array([[np.cos(a), np.sin(a), 2.0 + 0.1 * np.sin(3 * a)]
                     for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)])
    c = np.array([0.0, 0.0, 2.0])
    tri = np.stack([np.stack([c, ring[i], ring[(i + 1) % 8]]) for i in range(8)])
    tri = tri.astype(np.float32)
    aims = np.concatenate([tri.reshape(-1, 3), (tri + np.roll(tri, 1, axis=1)).reshape(-1, 3) / 2])
    d = _unit(aims)
    return np.zeros_like(d), d, np.ones(len(d), bool), tri, np.ones(len(tri), bool)


def sliver_case():
    """Triangles one float32 ulp tall at z = 1 (apex 1.2e-7 above the base
    line), and rays aimed at points on them."""
    rng = np.random.RandomState(2)
    k = 16
    base = np.stack([rng.rand(k) - 0.5, rng.rand(k) - 0.5, np.ones(k)], axis=1)
    v1 = base + np.array([0.3, 0.0, 0.0])
    v2 = base + np.array([0.15, 1.2e-7, 0.0])
    tri = np.stack([base, v1, v2], axis=1).astype(np.float32)
    w = rng.dirichlet([1, 1, 1], size=(4 * k,))
    owner = np.repeat(np.arange(k), 4)
    aims = (w[:, :, None] * tri[owner].astype(np.float64)).sum(1)
    d = _unit(aims)
    return np.zeros_like(d), d, np.ones(len(d), bool), tri, np.ones(k, bool)


def inside_case():
    """Rays from the centre of the posed box (inside the closed mesh) in
    seeded directions: every ray hits."""
    tri = posed_box()
    c = tri.reshape(-1, 3).mean(axis=0)
    d = _unit(np.random.RandomState(3).randn(256, 3))
    o = np.tile(c.astype(np.float32), (len(d), 1))
    return o, d, np.ones(len(d), bool), tri, np.ones(len(tri), bool)


def masked_case():
    """The scene at a coarse stride with every third triangle masked and
    every seventh ray invalid."""
    o, d, valid, tri, tri_mask = scene_case(8)
    tri_mask[::3] = False
    valid[::7] = False
    return o, d, valid, tri, tri_mask


def overflow_case():
    """3000 triangles (1500 stacked squares 1 unit apart) in front of 8
    rays: every block keeps more than the kernel's 512-entry list."""
    z = 2.0 + np.arange(1500, dtype=np.float64)
    sq = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64) * 1e3
    tri = []
    for zi in z:
        v = np.concatenate([sq, np.full((4, 1), zi)], axis=1)
        tri += [v[[0, 1, 2]], v[[0, 2, 3]]]
    tri = np.asarray(tri, np.float32)
    d = _unit(np.random.RandomState(4).randn(8, 3) * [0.1, 0.1, 0] + [0, 0, 1])
    return np.zeros_like(d), d, np.ones(8, bool), tri, np.ones(len(tri), bool)


def mixed_origin_case():
    """Rays whose origins differ: seeded points inside and outside the posed
    box's bounding box, aimed at its centre with seeded scatter."""
    rng = np.random.RandomState(5)
    tri = posed_box()
    pts = tri.reshape(-1, 3)
    lo, hi = pts.min(0), pts.max(0)
    n = 512
    o = lo + rng.rand(n, 3) * (hi - lo) * 3.0 - (hi - lo)
    d = _unit(pts.mean(0) + rng.randn(n, 3) * 20.0 - o)
    return o.astype(np.float32), d, rng.rand(n) > 0.1, tri, np.ones(len(tri), bool)


HAND_PLACED = {"grazing": grazing_case, "slack": slack_case, "each_edge": each_edge_case,
               "shared_edges": shared_edges_case, "slivers": sliver_case,
               "inside": inside_case, "masked": masked_case, "overflow": overflow_case,
               "mixed_origins": mixed_origin_case}


def to_torch(case, device):
    """(origins, dirs, valid, packed tris) tensors on @device."""
    o, d, valid, tri, tri_mask = case
    tris = k2.pack_tris(torch.tensor(tri, device=device), torch.tensor(tri_mask, device=device))
    return (torch.tensor(o, device=device), torch.tensor(d, device=device),
            torch.tensor(valid, device=device), tris)
