"""Procedural training objects: superquadric-deformed icospheres with
high-frequency vertex colours.

Port of `sixdof_tpu/parallel/procgen.py` (host numpy with the same seeded
`RandomState` calls, so the meshes are the JAX package's bit for bit).
Every mesh shares one topology (icosphere subdivision 4: V=2562, T=5120)
with only vertex data varying, so the trainer round-robins many objects
through one set of shapes.
"""
from __future__ import annotations

import numpy as np

from ..io.mesh_io import TriMesh
from ..ops.geometry import compute_mesh_diameter
from ..ops.hypotheses import icosphere
from ..ops.rasterize import make_mesh_arrays


def make_procedural_mesh(seed: int, subdivisions: int = 4) -> TriMesh:
    """Deterministic procedural object: diameter ~U(0.08, 0.18) m, vertex
    colours in [0, 255]; the topology depends only on @subdivisions."""
    rng = np.random.RandomState(seed)
    verts, faces = icosphere(subdivisions=subdivisions)
    d = verts / np.linalg.norm(verts, axis=-1, keepdims=True)

    # superquadric radius: p=2 sphere ... p=8 rounded box
    p = rng.uniform(2.0, 8.0)
    r = (np.abs(d) ** p).sum(axis=-1) ** (-1.0 / p)

    # low-frequency radial displacement (asymmetric bumps/dents)
    disp = np.zeros(len(d))
    for _ in range(rng.randint(2, 5)):
        k = rng.randn(3) * rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * np.pi)
        disp += rng.uniform(0.02, 0.12) * np.sin(d @ k * np.pi + phase)
    r = r * (1.0 + disp)

    # anisotropic half-extents; overall size targets the scene-object range
    half = rng.uniform(0.3, 1.0, 3)
    half = half / half.max()
    size = rng.uniform(0.08, 0.18) / 2.0
    v = d * r[:, None] * half[None] * size

    # random-Fourier vertex colours: base hue + 6 high-frequency terms
    base = rng.uniform(0.15, 0.85, 3)
    col = np.tile(base[None], (len(v), 1))
    for _ in range(6):
        k = rng.randn(3) * rng.uniform(40.0, 220.0)  # cycles/metre scale
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.22)
        ch = rng.randn(3)
        ch = ch / np.abs(ch).max()
        col += amp * np.sin(v @ k + phase)[:, None] * ch[None]
    col = np.clip(col, 0.02, 0.98)

    return TriMesh(v, faces, vertex_colors=(col * 255.0).astype(np.uint8))


def procedural_objects(n: int, K, device, subdivisions: int = 4, seed0: int = 100):
    """@n (mesh_arrays on @device, K, diameter) tuples, centred meshes, for
    the trainer's round-robin."""
    out = []
    for i in range(n):
        mesh = make_procedural_mesh(seed0 + i, subdivisions=subdivisions)
        center = (mesh.vertices.min(axis=0) + mesh.vertices.max(axis=0)) / 2
        mesh.vertices = mesh.vertices - center
        diameter = compute_mesh_diameter(mesh.vertices, n_sample=2000)
        out.append((make_mesh_arrays(mesh, device), np.asarray(K, dtype=np.float64),
                    float(diameter)))
    return out
