#!/usr/bin/env python3
"""Where ray-mesh kernel K2's time goes, by timing variants of its source on
one CUDA card.

    python3 tools/profile_k2_variants.py

Splices `sixdof_tpu_torch/csrc/ray_mesh.cu` into variants, builds them at
once with nvcc into build/k2var/, checks each full variant against the
plain version (t bit-equal) and prints its CUDA-event time per launch (mean
of 100, twice) at chip_smoke.py's K2 shapes (`chip_smoke.k2_cases`):

  A_current      the committed source
  B_sides_first  the box's side planes tried before the edge planes
  C_no_sides     the edge planes alone (no side-plane test)
  D_128          blocks of 128 threads
  E_512          blocks of 512 threads
  F_scan_only    the scan and list building alone (no pair test; its output
                 is not checked)

Each variant launches with the threads a ray that kernels/raytrace.py's
rule gives for its block size.  A splice that no
longer matches the source fails with an AssertionError.  Needs a card and
nvcc.
"""
import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from sixdof_tpu_torch.kernels import raytrace as k2  # noqa: E402
from sixdof_tpu_torch.kernels.build import NVCC_FLAGS, nvcc  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("profile_k2_variants: no CUDA device")
print(cs._nvidia_smi(), flush=True)

src = open(os.path.join(REPO, "sixdof_tpu_torch/csrc/ray_mesh.cu")).read()


def splice(s, old, new):
    assert old in s, old
    return s.replace(old, new)


sides = "  if (b.scaled && side_planes_drop(s, e1, e2, N, W, b)) return false;\n"
edges = ("#pragma unroll\n  for (int j = 0; j < 3; ++j)\n"
         "    if (plane_drops(N[j], W[j], b)) return false;\n")
threads = "constexpr int kThreads = 256;"
# name: (source, threads a block)
V = {"A_current": (src, 256),
     "B_sides_first": (splice(src, edges + sides, sides + edges), 256),
     "C_no_sides": (splice(src, sides, ""), 256),
     "D_128": (splice(src, threads, "constexpr int kThreads = 128;"), 128),
     "E_512": (splice(src, threads, "constexpr int kThreads = 512;"), 512)}
i0 = src.index("      for (int j = sub; live && j < m; j += P) {")
i1 = src.index("      m = 0;\n    }")
V["F_scan_only"] = (src[:i0] + src[i1:], 256)


def log2_p(n, block):
    """kernels/raytrace.py's rule for a block of @block threads."""
    k = 0
    while k < 5 and -(-n * (1 << k) // block) < k2.TARGET_BLOCKS:
        k += 1
    return k


out = os.path.join(REPO, "build", "k2var")
os.makedirs(out, exist_ok=True)
procs = {}
for name, (s, _) in V.items():
    cu = os.path.join(out, name + ".cu")
    open(cu, "w").write(s)
    procs[name] = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
libs = {}
for name, p in procs.items():
    _, err = p.communicate()
    assert p.returncode == 0, err
    print(name, [line for line in err.splitlines() if "registers" in line], flush=True)
    lib = ctypes.CDLL(os.path.join(out, name + ".so"))
    lib.ray_mesh_intersect.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    libs[name] = lib

dev = torch.device("cuda")
tris, _, cases = cs.k2_cases(dev, os.path.join(REPO, "demo_data", "synth_box"), small=False)
T = tris.shape[0]
for label, o, d, m in cases:
    want = k2.ray_mesh_intersect_plain(o, d, m, tris)
    N = o.shape[0]
    for rep in range(2):
        for name, lib in libs.items():
            t = torch.empty(N, device=dev)
            st = torch.cuda.current_stream().cuda_stream
            lp = log2_p(N, V[name][1])

            def f():
                rc = lib.ray_mesh_intersect(o.data_ptr(), d.data_ptr(), m.data_ptr(),
                                            tris.data_ptr(), t.data_ptr(), N, T, lp, st)
                assert rc == 0, rc
            f()
            torch.cuda.synchronize()
            ok = "n/a" if name == "F_scan_only" else (
                "equal" if torch.equal(t, want) else "DIFF")
            for _ in range(3):
                f()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(100):
                f()
            e1.record()
            e1.synchronize()
            print(label, rep, name, ok, round(e0.elapsed_time(e1) / 100 * 1e3, 2), "us",
                  flush=True)
