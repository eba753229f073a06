"""Frame-loop stage timing.

Port of the host parts of `sixdof_tpu/utils/profiling.py::StageTimer`.
Stage times are host wall clock: a stage that ends without a device synchronise measures dispatch.
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall-clock stats for the frame loop."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {
            k: {"total_s": round(v, 4), "n": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 2)}
            for k, v in sorted(self.totals.items())
        }

    def log(self):
        for k, v in self.summary().items():
            logging.info(f"[stage] {k}: {v['mean_ms']}ms x{v['n']}")
