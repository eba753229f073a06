"""Build and load the hand-written CUDA kernels and the port's C routines.

Each source in `csrc/` has a plain C interface.  `KernelLibrary` compiles
it on first use into `build/kernels/` under the repository root
(git-ignored): a CUDA source (`.cu`) with `nvcc` for `sm_90a`, a host C
source (`.c`) with the system C compiler (`cc -O2 -shared -fPIC`).  It names
the library by a hash of the source and the flags and loads it with ctypes:
no PyTorch headers and no ninja, so a build takes seconds.  Nothing is
built at import.  `KernelLibrary.built()` says whether a source's library
is already on disk: the hash-named libraries are the port's build cache.

Each kernel wrapper counts its launches through `count_launch`; a thread
inside `launches_apart` (the engine's warm-up) counts its own apart, so the
wrappers' counts hold the main path's launches only.
"""
from __future__ import annotations

import contextlib
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


_counting = threading.local()


@contextlib.contextmanager
def launches_apart(counts):
    """Inside the block, this thread's kernel launches are added to @counts
    (a dict: wrapper name -> launches) instead of the wrappers' own
    `launches`; other threads count as before."""
    previous = getattr(_counting, "counts", None)
    _counting.counts = counts
    try:
        yield counts
    finally:
        _counting.counts = previous


def count_launch(wrapper):
    """One launch of @wrapper's kernel: to the wrapper's `launches`, or to
    the thread's `launches_apart` dict."""
    counts = getattr(_counting, "counts", None)
    if counts is None:
        wrapper.launches += 1
    else:
        counts[wrapper.__name__] = counts.get(wrapper.__name__, 0) + 1


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

    def path(self):
        """The library's file under `BUILD_DIR`, named by a hash of the
        source and the compiler flags."""
        flags = NVCC_FLAGS if self.source.endswith(".cu") else CC_FLAGS
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"lib{self.name}_{digest}.so")

    def built(self):
        """True when the library for the current source and flags is
        already built (a later `load()` only opens it)."""
        return os.path.exists(self.path())

    def compile(self):
        """Start nvcc on the source unless its library exists; returns the
        running process (or None) and the library path, so several sources
        can compile at once."""
        cuda = self.source.endswith(".cu")
        flags = NVCC_FLAGS if cuda else CC_FLAGS
        so = self.path()
        if os.path.exists(so):
            return None, so
        os.makedirs(BUILD_DIR, exist_ok=True)
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
    load them; returns the wall seconds.  It holds every library's lock
    throughout, so a thread that loads one of them meanwhile waits for this
    build instead of starting its own."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as held:
        for lib in sorted(set(libraries), key=lambda lib: lib.source):
            held.enter_context(lib._lock)
        pending = [(lib, lib.compile()) for lib in libraries if lib.lib is None]
        for lib, p in pending:
            lib._load(p)
    return time.perf_counter() - t0
