"""Isosurface extraction: marching tetrahedra on a regular SDF grid.

Port of `sixdof_tpu/ops/marching.py` (host numpy; vertices and faces
bit-equal).  Each grid cube splits into six tetrahedra whose cases follow
from sign patterns; faces are oriented outward along the field's gradient.
"""
from __future__ import annotations

import numpy as np

# cube corners (Bourke numbering) and its 6-tetrahedra decomposition
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]]
)


def _interp(p_a, p_b, f_a, f_b, iso):
    t = (iso - f_a) / np.where(np.abs(f_b - f_a) > 1e-12, f_b - f_a, 1e-12)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p_a + t * (p_b - p_a)


def marching_tetrahedra(sdf, isolevel=0.0):
    """@sdf: (R,R,R) scalar field.  Returns (verts (V,3) in index coords,
    faces (F,3) int64), outward-oriented w.r.t. increasing sdf."""
    R = sdf.shape[0]
    # cube base coords
    idx = np.arange(R - 1)
    bx, by, bz = np.meshgrid(idx, idx, idx, indexing="ij")
    base = np.stack([bx, by, bz], axis=-1).reshape(-1, 3)  # (Nc,3)

    corner_pos = base[:, None, :] + _CORNERS[None]  # (Nc,8,3)
    vals = sdf[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]  # (Nc,8)

    # skip cubes with no crossing
    crossing = (vals.min(axis=1) <= isolevel) & (vals.max(axis=1) > isolevel)
    base = base[crossing]
    corner_pos = corner_pos[crossing].astype(np.float64)
    vals = vals[crossing]
    if len(base) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    tris = []
    for tet in _TETS:
        p = corner_pos[:, tet]  # (Nc,4,3)
        f = vals[:, tet]  # (Nc,4)
        below = f <= isolevel  # (Nc,4)
        case = below @ np.array([1, 2, 4, 8])

        others = {0: [1, 2, 3], 1: [0, 2, 3], 2: [0, 1, 3], 3: [0, 1, 2]}
        # single-vertex cases: one triangle on the 3 edges at that vertex
        for v in range(4):
            for cid in (1 << v, 0b1111 ^ (1 << v)):
                m = case == cid
                if not m.any():
                    continue
                o = others[v]
                pa = p[m, v]
                fa = f[m, v]
                tri = np.stack(
                    [_interp(pa, p[m, o[k]], fa, f[m, o[k]], isolevel) for k in range(3)],
                    axis=1,
                )
                tris.append(tri)
        # two-vertex cases: quad -> two triangles
        for a in range(4):
            for b in range(a + 1, 4):
                cid = (1 << a) | (1 << b)
                m = case == cid
                if not m.any():
                    continue
                cd = [v for v in range(4) if v not in (a, b)]
                c, dd = cd
                q0 = _interp(p[m, a], p[m, c], f[m, a], f[m, c], isolevel)
                q1 = _interp(p[m, a], p[m, dd], f[m, a], f[m, dd], isolevel)
                q2 = _interp(p[m, b], p[m, dd], f[m, b], f[m, dd], isolevel)
                q3 = _interp(p[m, b], p[m, c], f[m, b], f[m, c], isolevel)
                tris.append(np.stack([q0, q1, q2], axis=1))
                tris.append(np.stack([q0, q2, q3], axis=1))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tris = np.concatenate(tris)  # (F,3,3)

    # dedup vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat * 1e5).astype(np.int64)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    # representative positions (first occurrence)
    seen = np.full(len(uniq), len(flat) - 1, dtype=np.int64)
    order = np.arange(len(flat))
    np.minimum.at(seen, inverse, order)
    verts = flat[seen]
    faces = inverse.reshape(-1, 3)

    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]

    # orient outward: face normal should align with SDF gradient (sdf grows
    # outward for SDF conventions where inside < iso)
    grad = np.stack(np.gradient(sdf), axis=-1)  # (R,R,R,3)
    centroids = verts[faces].mean(axis=1)
    ci = np.clip(np.round(centroids).astype(np.int64), 0, R - 1)
    g = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    flip = np.einsum("ij,ij->i", n, g) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces.astype(np.int64)
