"""Ray-mesh first-hit kernel K2: wrapper, build, and its plain PyTorch version.

Replaces `sixdof_tpu/ops/pallas/raytrace_kernel.py::ray_mesh_intersect_pallas`
(the function at its `pl.pallas_call`); the CUDA source is
`csrc/ray_mesh.cu`, which states what it computes and what bounds it.

`ray_mesh_intersect` dispatches on the tensor's device: a CPU tensor takes
`ray_mesh_intersect_plain`; a CUDA tensor launches the kernel or raises.
Both read the same packed triangles (`pack_tris`), so the edge vectors are
rounded once, and both do the same IEEE fp32 operations in the same order.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary

# the plain version's ray chunk (sixdof_tpu/ops/raytrace.py::_RAY_CHUNK):
# (RAY_CHUNK, T) temporaries
RAY_CHUNK = 512
FLOPS_PER_PAIR = 46  # csrc/ray_mesh.cu: 45 multiplies/adds/subtracts + 1 division


def _bind(lib):
    lib.ray_mesh_intersect.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.ray_mesh_intersect.restype = ctypes.c_int


LIBRARY = KernelLibrary("ray_mesh", _bind)
build = LIBRARY.load
build_info = LIBRARY.info


def pack_tris(tri_verts, tri_mask):
    """(T,3,3) vertices + (T,) mask -> (T,9) float32 rows [v0 | e1 | e2];
    masked triangles get e1 = e2 = 0, so det = 0 and they never hit
    (`raytrace_kernel.py::pack_tris`)."""
    tv = tri_verts.to(torch.float32)
    v0 = tv[:, 0]
    m = tri_mask.to(torch.bool)[:, None]
    e1 = torch.where(m, tv[:, 1] - v0, 0.0)
    e2 = torch.where(m, tv[:, 2] - v0, 0.0)
    return torch.cat([v0, e1, e2], dim=-1).contiguous()


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _first_hit(o, d, valid, tris):
    """Min hit distance of rays (C,3) against all triangles; (C,) float32."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (c[None, :] for c in tris.unbind(-1))
    ox, oy, oz = (c[:, None] for c in o.unbind(-1))
    dx, dy, dz = (c[:, None] for c in d.unbind(-1))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = _dot3(px, py, pz, e1x, e1y, e1z)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, torch.ones_like(det) / det, 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = _dot3(sx, sy, sz, px, py, pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = _dot3(qx, qy, qz, dx, dy, dz) * inv_det
    t = _dot3(qx, qy, qz, e2x, e2y, e2z) * inv_det
    hit = ok & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & (t > 1e-6)
    tmin = torch.where(hit, t, float("inf")).amin(dim=1)
    return torch.where(valid, tmin, float("inf"))


def ray_mesh_intersect_plain(origins, dirs, valid, tris):
    """Plain PyTorch first hits, chunked over RAY_CHUNK rays (mirrors
    `sixdof_tpu/ops/raytrace.py::ray_mesh_intersect`'s XLA path, with the
    kernel's operation order).  Arguments as `ray_mesh_intersect`."""
    n = origins.shape[0]
    if tris.shape[0] == 0:
        return torch.full((n,), float("inf"), dtype=torch.float32, device=origins.device)
    out = [_first_hit(o, d, m, tris) for o, d, m in
           zip(torch.split(origins, RAY_CHUNK), torch.split(dirs, RAY_CHUNK),
               torch.split(valid, RAY_CHUNK))]
    return torch.cat(out) if out else origins.new_empty((0,))


def ray_mesh_intersect(origins, dirs, valid, tris):
    """First-hit distance of each ray against a packed triangle soup.

    @origins/@dirs: (N,3) float32 (t is in units of |dir|); @valid: (N,)
    bool; @tris: (T,9) float32 from `pack_tris`.  Returns t (N,) float32,
    +inf for a miss or an invalid ray.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch per call, counted in
    `ray_mesh_intersect.launches`).
    """
    if origins.device.type == "cpu":
        return ray_mesh_intersect_plain(origins, dirs, valid, tris)
    if origins.device.type != "cuda":
        raise ValueError(f"ray_mesh_intersect: unsupported device {origins.device}")
    N, T = origins.shape[0], tris.shape[0]
    for name, x, shape, dtype in (("origins", origins, (N, 3), torch.float32),
                                  ("dirs", dirs, (N, 3), torch.float32),
                                  ("valid", valid, (N,), torch.bool),
                                  ("tris", tris, (T, 9), torch.float32)):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != origins.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{origins.device}")
    lib = build()
    t = torch.full((N,), float("inf"), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    rc = lib.ray_mesh_intersect(origins.data_ptr(), dirs.data_ptr(), valid.data_ptr(),
                                tris.data_ptr(), t.data_ptr(), N, T, stream)
    if rc != 0:
        raise RuntimeError(f"ray_mesh_intersect launch failed: CUDA error {rc}")
    ray_mesh_intersect.launches += 1
    return t


ray_mesh_intersect.launches = 0
