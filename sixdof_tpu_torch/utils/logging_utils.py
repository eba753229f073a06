"""Logging and timing helpers.

Port of `sixdof_tpu/utils/logging_utils.py::{set_logging_format, timeit}`
(the seeding helper is `utils/profiling.py::set_seed`).
"""
from __future__ import annotations

import functools
import importlib
import logging
import time


def set_logging_format(level=logging.INFO):
    """Reset logging to `[function()] message` lines at @level."""
    importlib.reload(logging)
    logging.basicConfig(level=level, format="[%(funcName)s()] %(message)s")


def timeit(func):
    """Log @func's wall time on every call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        logging.info(f":: {func.__name__} executed in {time.time() - start:.6f} seconds")
        return result

    return wrapper
