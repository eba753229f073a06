"""Z-buffer raster kernel K1: wrapper, build, and its plain PyTorch version.

Replaces `sixdof_tpu/ops/pallas/raster_kernel.py::rasterize_zbuffer_pallas`
(the function at its `pl.pallas_call`); the CUDA source is
`csrc/raster_zbuffer.cu`, which states what it computes and what bounds it.

`rasterize_zbuffer` dispatches on the tensor's device: a CPU tensor takes
`rasterize_zbuffer_plain`; a CUDA tensor launches the kernel or raises.
The library is built on first use by `kernels/build.py`.
"""
from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary, count_launch

# plain version's chunking: (POSE_CHUNK, TRI_CHUNK, 4, H*W) temporaries
POSE_CHUNK, TRI_CHUNK = 8, 32


def _bind(lib):
    lib.raster_zbuffer.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.raster_zbuffer.restype = ctypes.c_int


LIBRARY = KernelLibrary("raster_zbuffer", _bind)
build = LIBRARY.load
build_info = LIBRARY.info  # library path, seconds, nvcc's -Xptxas -v report


def rasterize_zbuffer_plain(coef, counts, H, W):
    """Plain PyTorch z-buffer (mirrors `sixdof_tpu/ops/rasterize.py::_rasterize_one`,
    chunked over triangles, with the kernel's max-iz accumulation and tie rule).

    @coef: (B,T,4,3) float32 plane coefficients [l0,l1,l2,iz] x (c0,c1,c2);
    @counts: (B,) int32, triangles t >= counts[b] are skipped.
    Returns (zbuf (B,H*W) float32 [0 = miss], tid (B,H*W) int32 [-1 = miss]).
    """
    B, T = coef.shape[:2]
    P = H * W
    dev = coef.device
    pid = torch.arange(P, device=dev)
    px = (pid % W).float()
    py = torch.div(pid, W, rounding_mode="floor").float()
    zbuf = torch.empty((B, P), dtype=torch.float32, device=dev)
    tid = torch.empty((B, P), dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    n_max = int(counts.max()) if B else 0
    for b0 in range(0, B, POSE_CHUNK):
        c = coef[b0 : b0 + POSE_CHUNK]
        cnt = counts[b0 : b0 + POSE_CHUNK].long()
        nb = c.shape[0]
        iz_acc = torch.zeros((nb, P), dtype=torch.float32, device=dev)
        tid_acc = torch.full((nb, P), -1, dtype=torch.int32, device=dev)
        for t0 in range(0, n_max, TRI_CHUNK):
            cc = c[:, t0 : t0 + TRI_CHUNK]  # (nb,C,4,3)
            idx = torch.arange(t0, t0 + cc.shape[1], device=dev)
            # ((c0*px) + (c1*py)) + c2: the kernel's exact operation order
            vals = cc[..., 0, None] * px + cc[..., 1, None] * py + cc[..., 2, None]
            l0, l1, l2, iz = vals.unbind(2)  # (nb,C,P) each
            live = (idx[None, :] < cnt[:, None])[..., None]
            inside = (torch.minimum(l0, torch.minimum(l1, l2)) >= 0) & (iz > 1e-12) & live
            key = torch.where(inside, iz, -1.0)
            izmax = key.amax(dim=1)  # (nb,P)
            cand = torch.where(key >= izmax[:, None], idx[None, :, None].int(), big).amin(dim=1)
            closer = izmax > iz_acc
            iz_acc = torch.where(closer, izmax, iz_acc)
            tid_acc = torch.where(closer, cand, tid_acc)
        zbuf[b0 : b0 + nb] = torch.where(tid_acc >= 0, 1.0 / torch.clamp(iz_acc, min=1e-12), 0.0)
        tid[b0 : b0 + nb] = tid_acc
    return zbuf, tid


def rasterize_zbuffer(coef, counts, H, W):
    """Z-buffer of (B,T,4,3) plane coefficients with per-pose counts.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch per call, counted in `rasterize_zbuffer.launches`, or apart
    in a thread inside `build.launches_apart`).
    Returns (zbuf (B,H*W) float32, tid (B,H*W) int32).
    """
    if coef.device.type == "cpu":
        return rasterize_zbuffer_plain(coef, counts, H, W)
    if coef.device.type != "cuda":
        raise ValueError(f"rasterize_zbuffer: unsupported device {coef.device}")
    B, T = coef.shape[:2]
    if coef.dtype != torch.float32 or coef.shape[2:] != (4, 3) or not coef.is_contiguous():
        raise ValueError("coef must be a contiguous float32 (B,T,4,3) tensor")
    if counts.dtype != torch.int32 or counts.shape != (B,) or counts.device != coef.device:
        raise ValueError("counts must be an int32 (B,) tensor on the coef's device")
    if coef.data_ptr() % 16:
        raise ValueError("coef must be 16-byte aligned")
    counts = counts.contiguous()  # held until return: the launch is asynchronous
    lib = build()
    zbuf = torch.empty((B, H * W), dtype=torch.float32, device=coef.device)
    tid = torch.empty((B, H * W), dtype=torch.int32, device=coef.device)
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    rc = lib.raster_zbuffer(coef.data_ptr(), counts.data_ptr(), zbuf.data_ptr(),
                            tid.data_ptr(), B, T, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"raster_zbuffer launch failed: CUDA error {rc}")
    count_launch(rasterize_zbuffer)
    return zbuf, tid


rasterize_zbuffer.launches = 0
