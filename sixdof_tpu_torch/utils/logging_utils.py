"""Logging and timing helpers.

Port of `sixdof_tpu/utils/logging_utils.py::{set_logging_format, timeit,
rle_to_mask, make_yaml_dumpable, set_seed}`.
"""
from __future__ import annotations

import functools
import importlib
import logging
import random
import time

import numpy as np
import torch


def set_seed(random_seed):
    """Seed numpy's and Python's global generators, as JAX's set_seed does,
    and torch's (the main path's own randomness uses explicit
    `np.random.RandomState`s)."""
    np.random.seed(random_seed)
    random.seed(random_seed)
    torch.manual_seed(random_seed)


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


def rle_to_mask(rle: dict):
    """An uncompressed RLE ({"size": [h, w], "counts": [...]}, column-major
    runs starting with 0s, COCO's layout) as a (h, w) bool mask."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx : idx + count] = parity
        idx += count
        parity ^= True
    return mask.reshape(w, h).transpose()


def make_yaml_dumpable(D):
    """@D with numpy arrays as lists and numpy scalars as Python ints and
    floats, through nested dicts, lists and tuples (tuples become lists)."""
    if isinstance(D, np.ndarray):
        return D.tolist()
    if isinstance(D, dict):
        return {k: make_yaml_dumpable(v) for k, v in D.items()}
    if isinstance(D, (list, tuple)):
        return [make_yaml_dumpable(v) for v in D]
    if isinstance(D, np.integer):
        return int(D)
    if isinstance(D, np.floating):
        return float(D)
    return D
