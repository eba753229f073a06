#!/usr/bin/env python3
"""Where raster kernel K1's time goes, by timing variants of its source on
one CUDA card.

    python3 tools/profile_k1_variants.py

Splices `sixdof_tpu_torch/csrc/raster_zbuffer.cu` into variants, builds
them at once with nvcc into build/k1var/, checks each full variant against
the plain version (zbuf and tid equal) and prints its CUDA-event time per
launch (mean of 100, twice) at chip_smoke.py's register shapes and the
5120-triangle mesh:

  A_current             the committed source
  B_prefetch            the scan loads the next chunk's rows ahead (registers)
  C_scan_only           the scan and list building alone (no per-warp filter
                        or pixel test; its output is not checked)
  E_prefetch_scan_only  B without the per-warp filter and pixel test
  D_four_corners        the corner test evaluated at all four corners

A splice that no longer matches the source fails with an AssertionError.
Needs a card and nvcc.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from sixdof_tpu_torch.io.mesh_io import load_mesh  # noqa: E402
from sixdof_tpu_torch.io.readers import DataReader  # noqa: E402
from sixdof_tpu_torch.kernels.build import NVCC_FLAGS, nvcc  # noqa: E402
from sixdof_tpu_torch.kernels.raster import rasterize_zbuffer_plain  # noqa: E402
from sixdof_tpu_torch.ops.geometry import (compute_crop_window_tf_batch,  # noqa: E402
                                           compute_mesh_diameter)
from sixdof_tpu_torch.ops.hypotheses import make_rotation_grid  # noqa: E402
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays, zbuffer_setup  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("profile_k1_variants: no CUDA device")
print(cs._nvidia_smi(), flush=True)

src = open(os.path.join(REPO, "sixdof_tpu_torch/csrc/raster_zbuffer.cu")).read()
V = {"A_current": src}
old = """    const int t = t0 + threadIdx.x;
    float4 a = {}, c = {}, d = {};
    bool keep = false;
    if (t < n) {
      a = cb[static_cast<size_t>(t) * 3];      // l0.c0 l0.c1 l0.c2 l1.c0
      c = cb[static_cast<size_t>(t) * 3 + 1];  // l1.c1 l1.c2 l2.c0 l2.c1
      d = cb[static_cast<size_t>(t) * 3 + 2];  // l2.c2 iz.c0 iz.c1 iz.c2
      keep ="""
new = """    const int t = t0 + threadIdx.x;
    const float4 a = na, c = nc, d = nd;
    if (t + kThreads < n) {
      na = cb[static_cast<size_t>(t + kThreads) * 3];
      nc = cb[static_cast<size_t>(t + kThreads) * 3 + 1];
      nd = cb[static_cast<size_t>(t + kThreads) * 3 + 2];
    }
    bool keep = false;
    if (t < n) {
      keep ="""
assert old in src
b = src.replace(old, new).replace(
    "  int m = 0;  // entries in the list; the same value in every thread\n",
    "  int m = 0;  // entries in the list; the same value in every thread\n"
    "  float4 na = {}, nc = {}, nd = {};\n"
    "  if (static_cast<int>(threadIdx.x) < n) {\n"
    "    na = cb[threadIdx.x * 3]; nc = cb[threadIdx.x * 3 + 1]; nd = cb[threadIdx.x * 3 + 2];\n"
    "  }\n")
V["B_prefetch"] = b


def scan_only(s):
    i0 = s.index("      // each warp: the entries that may cover its region")
    i1 = s.index("      m = 0;\n    }")
    return s[:i0] + s[i1:]


V["C_scan_only"] = scan_only(src)
V["E_prefetch_scan_only"] = scan_only(b)
oldb = src[src.index("__device__ __forceinline__ bool below_tile"):src.index("__global__")]
newb = """__device__ __forceinline__ bool below_tile(float c0, float c1, float c2, float x0,
                                           float x1, float y0, float y1) {
  const float delta = __fadd_rn(
      __fmul_rn(kRound, plane(fabsf(c0), fabsf(c1), fabsf(c2), x1, y1)), FLT_MIN);
  const float lim = -2.0f * delta;
  return plane(c0, c1, c2, x0, y0) < lim && plane(c0, c1, c2, x1, y0) < lim &&
         plane(c0, c1, c2, x0, y1) < lim && plane(c0, c1, c2, x1, y1) < lim;
}

"""
V["D_four_corners"] = src.replace(oldb, newb)

out = os.path.join(REPO, "build", "k1var")
os.makedirs(out, exist_ok=True)
procs = {}
for k, s in V.items():
    cu = os.path.join(out, k + ".cu")
    open(cu, "w").write(s)
    procs[k] = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
libs = {}
for k, p in procs.items():
    _, err = p.communicate()
    assert p.returncode == 0, err
    print(k, [line for line in err.splitlines() if "registers" in line], flush=True)
    lib = ctypes.CDLL(os.path.join(out, k + ".so"))
    lib.raster_zbuffer.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    libs[k] = lib

dev = torch.device("cuda")
scene = os.path.join(REPO, "demo_data", "synth_box")
mesh = load_mesh(os.path.join(scene, "mesh", "model_scaled_down.obj"))
mesh.vertices = mesh.vertices - (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
diameter = compute_mesh_diameter(mesh.vertices)
K = torch.as_tensor(DataReader(scene).color_K, dtype=torch.float32, device=dev)
grid = make_rotation_grid()
rng = np.random.RandomState(0)
grid[:, :3, 3] = np.array([0.0, 0.0, 0.55]) + rng.uniform(-0.02, 0.02, (len(grid), 3))
poses = torch.as_tensor(grid, dtype=torch.float32, device=dev)
arrays = make_mesh_arrays(mesh, dev)
fine = make_mesh_arrays(cs._subdivide(mesh), dev)
for label, arr, B, hw in [("rc", arrays, 252, 96), ("rr", arrays, 64, 160), ("sub", fine, 64, 160)]:
    p = poses[:B]
    tfs = compute_crop_window_tf_batch(p, K, 1.2, (hw, hw), diameter)
    s = zbuffer_setup(arr, p, K, tfs, backface_cull=True)
    coef, counts = s["coef_c"], s["counts"]
    zp, tp = rasterize_zbuffer_plain(coef, counts, hw, hw)
    T = coef.shape[1]
    for rep in range(2):
        for k, lib in libs.items():
            z = torch.empty((B, hw * hw), device=dev)
            t = torch.empty((B, hw * hw), dtype=torch.int32, device=dev)
            st = torch.cuda.current_stream().cuda_stream

            def f():
                lib.raster_zbuffer(coef.data_ptr(), counts.data_ptr(), z.data_ptr(),
                                   t.data_ptr(), B, T, hw, hw, st)
            f()
            torch.cuda.synchronize()
            ok = bool(torch.equal(z, zp) and torch.equal(t, tp))
            for _ in range(3):
                f()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(100):
                f()
            e1.record()
            e1.synchronize()
            print(label, rep, k, "equal" if ok else "DIFF",
                  round(e0.elapsed_time(e1) / 100 * 1e3, 2), "us", flush=True)
