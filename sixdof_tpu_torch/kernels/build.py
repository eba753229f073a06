"""Build and load the hand-written CUDA kernels and the port's C routines.

Each source in `csrc/` has a plain C interface.  `KernelLibrary` compiles
it on first use into `build/kernels/` under the repository root
(git-ignored): a CUDA source (`.cu`) with `nvcc` for `sm_90a`, a host C
source (`.c`) with the system C compiler (`cc -O2 -shared -fPIC`).  It names
the library by a hash of the source and the flags and loads it with ctypes:
no PyTorch headers and no ninja, so a build takes seconds.  Nothing is
built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O2", "-shared", "-fPIC"]


def nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def cc():
    path = shutil.which("cc")
    if path is None:
        raise RuntimeError("no C compiler (cc) found: the port's C routines are built with it")
    return path


class KernelLibrary:
    """One `csrc/<name><ext>` source, built and loaded at the first `load()`.

    @bind: sets the argtypes/restype of the library's C functions;
    @ext: ".cu" (nvcc) or ".c" (the system C compiler).
    `info` holds the library path, the build seconds and the compiler's
    report (nvcc's `-Xptxas -v`) once loaded."""

    def __init__(self, name, bind, ext=".cu"):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}{ext}")
        self._bind = bind
        self.lib = None
        self.info = {}
        self._lock = threading.Lock()  # one build when threads first load at once

    def compile(self):
        """Start nvcc on the source unless its library exists; returns the
        running process (or None) and the library path, so several sources
        can compile at once."""
        cuda = self.source.endswith(".cu")
        flags = NVCC_FLAGS if cuda else CC_FLAGS
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{self.name}_{digest}.so")
        if os.path.exists(so):
            return None, so
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc() if cuda else cc(), *flags, "-o", tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        proc.tmp = tmp
        return proc, so

    def load(self, pending=None):
        """The loaded ctypes library, building it first if needed.
        @pending: what `compile()` returned, when the caller started it."""
        if self.lib is not None:
            return self.lib
        with self._lock:
            if self.lib is None:
                self._load(pending)
        return self.lib

    def _load(self, pending):
        t0 = time.perf_counter()
        proc, so = pending if pending is not None else self.compile()
        log = ""
        if proc is not None:
            _, log = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{proc.args[0]} failed on {self.source}:\n{log}")
            os.replace(proc.tmp, so)
        lib = ctypes.CDLL(so)
        self._bind(lib)
        self.info.update(library=so, seconds=time.perf_counter() - t0, ptxas=log)
        self.lib = lib


def build_all(libraries):
    """Compile every library at once (one nvcc each, started together) and
    load them; returns the wall seconds."""
    t0 = time.perf_counter()
    pending = [(lib, lib.compile()) for lib in libraries if lib.lib is None]
    for lib, p in pending:
        lib.load(p)
    return time.perf_counter() - t0
