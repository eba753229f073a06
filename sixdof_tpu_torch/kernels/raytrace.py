"""Ray-mesh first-hit kernel K2: wrapper, build, and its plain PyTorch version.

Replaces `sixdof_tpu/ops/pallas/raytrace_kernel.py::ray_mesh_intersect_pallas`
(the function at its `pl.pallas_call`); the CUDA source is
`csrc/ray_mesh.cu`, which states what it computes and what bounds it.

`ray_mesh_intersect` dispatches on the tensor's device: a CPU tensor takes
`ray_mesh_intersect_plain`; a CUDA tensor launches the kernel or raises.
Both read the same packed triangles (`pack_tris`), so the edge vectors are
rounded once, and both do the same IEEE fp32 operations in the same order.
`cull_keep` states the kernel's per-block cull test in PyTorch, operation
for operation, so that it can be checked and counted off the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary, count_launch

# the plain version's ray chunk (sixdof_tpu/ops/raytrace.py::_RAY_CHUNK):
# (RAY_CHUNK, T) temporaries
RAY_CHUNK = 512
FLOPS_PER_PAIR = 46  # csrc/ray_mesh.cu: 45 multiplies/adds/subtracts + 1 division
# csrc/ray_mesh.cu: threads a block, and the blocks a launch aims for (two
# an SM of an H100) before it gives a ray more than one thread
THREADS = 256
TARGET_BLOCKS = 2 * 132
# the cull test's constants (csrc/ray_mesh.cu, where the note proves them)
EPS = 2.0 ** -19    # barycentric slack, its rounding included
KAPPA = 2.0 ** -19  # rounding margin, 32 u
MU = 2.0 ** -80     # underflow margin
RANGE = 2.0 ** 40   # a non-zero input's magnitude: below RANGE ...
TINY = 2.0 ** -60   # ... and at least TINY
SPREAD = 2.0 ** -20  # rescale a block's box when its axis holds this share
# csrc/ray_mesh.cu indexes rays as 3 r + i and walks the triangles in int
# steps of THREADS: the counts it takes
MAX_RAYS = (2 ** 31 - 1) // 3
MAX_TRIS = 2 ** 31 - 1 - THREADS


def _bind(lib):
    lib.ray_mesh_intersect.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
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


def pair_t(o, d, valid, tris):
    """Hit distance of every (ray, triangle) pair, +inf where it misses:
    (C,T) float32 for rays (C,3)."""
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
    return torch.where(hit & valid[:, None], t, float("inf"))


def _first_hit(o, d, valid, tris):
    """Min hit distance of rays (C,3) against all triangles; (C,) float32."""
    return pair_t(o, d, valid, tris).amin(dim=1)


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


def threads_per_ray_log2(n):
    """log2 of the threads the kernel gives each of @n rays: one while the
    rays fill TARGET_BLOCKS blocks, up to 32 for a few hundred rays."""
    k = 0
    while k < 5 and -(-n * (1 << k) // THREADS) < TARGET_BLOCKS:
        k += 1
    return k


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _abs_cross(ax, ay, az, bx, by, bz):
    """X(a, b)_i = |a_j b_k| + |a_k b_j|."""
    return ((ay * bz).abs() + (az * by).abs(), (az * bx).abs() + (ax * bz).abs(),
            (ax * by).abs() + (ay * bx).abs())


def _plane_drops(N, W, lo, hi, dmax):
    """N.d < -(KAPPA W.dmax + MU) over the whole box: the largest N.d over
    [lo, hi] is sum_i max(N_i lo_i, N_i hi_i)."""
    terms = [torch.fmax(n * lo_i, n * hi_i) for n, lo_i, hi_i in zip(N, lo, hi)]
    return (terms[0] + terms[1]) + terms[2] < -(KAPPA * _dot3(*W, *dmax) + MU)


def _in_window(x):
    """Zero, or a magnitude in [TINY, RANGE) (False for inf and NaN)."""
    a = x.abs()
    return (a < RANGE) & ((a >= TINY) | (a == 0))


def _box(d, live):
    """[lo, hi] over the valid rays of each block; NaN components pass, as
    in fminf / fmaxf.  @d: (blocks, R, 3)."""
    use = live & ~d.isnan()
    return (torch.where(use, d, float("inf")).amin(dim=1),
            torch.where(use, d, float("-inf")).amax(dim=1))


def cull_keep(origins, dirs, valid, tris):
    """The kernel's cull test (csrc/ray_mesh.cu), in float32 with the
    kernel's operations in its order: (blocks, T) bool, True where the block
    of rays keeps the triangle.  Blocks are the kernel's: runs of
    THREADS >> threads_per_ray_log2(N) consecutive rays.  A block without a
    valid ray keeps nothing; one whose valid rays do not share an origin
    (bitwise), or have a direction outside the window, keeps every
    triangle.  Arguments as `ray_mesh_intersect`."""
    n = origins.shape[0]
    R = THREADS >> threads_per_ray_log2(n)
    nb = -(-n // R)
    pad = nb * R - n
    o = torch.cat([origins, origins.new_zeros((pad, 3))]).reshape(nb, R, 3)
    d = torch.cat([dirs, dirs.new_zeros((pad, 3))]).reshape(nb, R, 3)
    live = torch.cat([valid, valid.new_zeros(pad)]).reshape(nb, R, 1)
    lo, hi = _box(d, live)
    bits = o.view(torch.int32).long() & 0xFFFFFFFF
    omin = torch.where(live, bits, 0xFFFFFFFF).amin(dim=1)
    omax = torch.where(live, bits, 0).amax(dim=1)
    has_live = lo[:, 0] <= hi[:, 0]
    cull = (omin == omax).all(dim=-1) & (~live[..., 0] | _in_window(d).all(dim=-1)).all(dim=1)
    c = torch.where(omin >= 2 ** 31, omin - 2 ** 32, omin).to(torch.int32).view(torch.float32)
    # the box of d / |d_k| where axis k keeps one strict sign and holds at
    # least SPREAD of the largest component
    gk = torch.zeros(nb, dtype=d.dtype, device=d.device)
    k = torch.zeros(nb, dtype=torch.long, device=d.device)
    for i in range(3):
        ci = torch.where(lo[:, i] > 0, lo[:, i], torch.where(hi[:, i] < 0, -hi[:, i], 0.0))
        k = torch.where(ci > gk, i, k)
        gk = torch.where(ci > gk, ci, gk)
    top = torch.fmax(lo.abs(), hi.abs()).amax(dim=1)
    scale = (gk > 0) & (gk >= SPREAD * top)
    dk = torch.take_along_dim(d, k[:, None, None], dim=2).abs()
    lo2, hi2 = _box(d / dk, live)
    lo = torch.where(scale[:, None], lo2, lo)
    hi = torch.where(scale[:, None], hi2, hi)
    sk = torch.where(torch.take_along_dim(lo, k[:, None], dim=1) > 0, 1.0, -1.0)  # (nb,1)
    dmax = torch.fmax(lo.abs(), hi.abs())

    ox, oy, oz = (v[:, None] for v in c.unbind(-1))
    lo, hi, dmax = ([v[:, None] for v in x.unbind(-1)] for x in (lo, hi, dmax))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (v[None, :] for v in tris.unbind(-1))
    s = [ox - v0x, oy - v0y, oz - v0z]
    e1, e2 = [e1x, e1y, e1z], [e2x, e2y, e2z]
    q = _cross(*s, *e1)
    Tq = _dot3(*q, *e2)
    no_t = ~((Tq > 0) | (Tq < 0))
    tame = _in_window(tris[:, 3:])[None].all(dim=-1)
    for x in s:
        tame = tame & _in_window(x)
    sg = torch.where(Tq > 0, 1.0, -1.0)
    nv, a = _cross(*e2, *e1), _cross(*e2, *s)
    wn, wa = _abs_cross(*e2, *e1), _abs_cross(*e2, *s)
    en, ewn = [EPS * x for x in nv], [EPS * x for x in wn]
    N = [[sg * (ai + x) for ai, x in zip(a, en)], [sg * (qi + x) for qi, x in zip(q, en)],
         [sg * (((ni + x) - ai) - qi) for ni, x, ai, qi in zip(nv, en, a, q)]]
    W = [[w + x for w, x in zip(wa, ewn)], [qi.abs() + x for qi, x in zip(q, ewn)],
         [((y + x) + w) + qi.abs() for y, x, w, qi in zip(wn, ewn, wa, q)]]
    drop = torch.zeros_like(no_t)
    for Nj, Wj in zip(N, W):
        drop |= _plane_drops(Nj, Wj, lo, hi, dmax)

    # the box's side planes as non-negative combinations of the edge functions
    V = [[-x for x in s], [y - x for y, x in zip(e1, s)], [y - x for y, x in zip(e2, s)]]
    kb = k[:, None]
    f = [sk * torch.where(kb == 0, v[0], torch.where(kb == 1, v[1], v[2])) for v in V]
    front = scale[:, None] & (f[0] > 0) & (f[1] > 0) & (f[2] > 0)
    rf = [1.0 / x for x in f]  # correctly rounded, as __frcp_rn
    off = (1, 2, 0)  # edge function j is zero at two vertices; off[j] is the third
    rden = [1.0 / _dot3(*N[j], *V[off[j]]) for j in range(3)]
    inf = float("inf")
    for i in range(3):
        p = [V[j][i] * rf[j] for j in range(3)]
        pmin = torch.fmin(torch.fmin(torch.fmin(torch.full_like(p[0], inf), p[0]), p[1]), p[2])
        pmax = torch.fmax(torch.fmax(torch.fmax(torch.full_like(p[0], -inf), p[0]), p[1]), p[2])
        for up in (True, False):
            beyond = (pmin > hi[i]) if up else (pmax < lo[i])
            c = 0.5 * ((hi[i] + pmin) if up else (lo[i] + pmax))
            sgn = 1.0 if up else -1.0
            mu = [(sgn * (V[off[j]][i] - c * f[off[j]])) * rden[j] for j in range(3)]
            top = torch.fmax(torch.fmax(torch.fmax(torch.zeros_like(mu[0]), mu[0]), mu[1]), mu[2])
            ok = (mu[0] >= 0) & (mu[1] >= 0) & (mu[2] >= 0) & (top > 0) & (top < inf)
            rtop = 1.0 / top
            mu = [m * rtop for m in mu]
            M = [(mu[0] * N[0][a] + mu[1] * N[1][a]) + mu[2] * N[2][a] for a in range(3)]
            WM = [(mu[0] * W[0][a] + mu[1] * W[1][a]) + mu[2] * W[2][a] for a in range(3)]
            drop |= front & (kb != i) & beyond & ok & _plane_drops(M, WM, lo, hi, dmax)
    drop = no_t | (tame & drop)
    return has_live[:, None] & (~cull[:, None] | ~drop)


def ray_mesh_intersect(origins, dirs, valid, tris):
    """First-hit distance of each ray against a packed triangle soup.

    @origins/@dirs: (N,3) float32 (t is in units of |dir|); @valid: (N,)
    bool; @tris: (T,9) float32 from `pack_tris`.  Returns t (N,) float32,
    +inf for a miss or an invalid ray.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch per call, counted in
    `ray_mesh_intersect.launches`, or apart in a thread inside
    `build.launches_apart`).
    """
    if origins.device.type == "cpu":
        return ray_mesh_intersect_plain(origins, dirs, valid, tris)
    if origins.device.type != "cuda":
        raise ValueError(f"ray_mesh_intersect: unsupported device {origins.device}")
    N, T = origins.shape[0], tris.shape[0]
    if N > MAX_RAYS or T > MAX_TRIS:
        raise ValueError(f"ray_mesh_intersect takes at most {MAX_RAYS} rays and {MAX_TRIS} "
                         f"triangles a launch, got {N} and {T}")
    for name, x, shape, dtype in (("origins", origins, (N, 3), torch.float32),
                                  ("dirs", dirs, (N, 3), torch.float32),
                                  ("valid", valid, (N,), torch.bool),
                                  ("tris", tris, (T, 9), torch.float32)):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != origins.device:
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{origins.device}")
    lib = build()
    t = torch.empty((N,), dtype=torch.float32, device=origins.device)  # every t written
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    rc = lib.ray_mesh_intersect(origins.data_ptr(), dirs.data_ptr(), valid.data_ptr(),
                                tris.data_ptr(), t.data_ptr(), N, T,
                                threads_per_ray_log2(N), stream)
    if rc != 0:
        raise RuntimeError(f"ray_mesh_intersect launch failed: CUDA error {rc}")
    count_launch(ray_mesh_intersect)
    return t


ray_mesh_intersect.launches = 0
