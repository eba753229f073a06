"""Network checkpoints for the port's predictors.

Counterpart of `sixdof_tpu/models/predict.py::_PredictorBase._init_params`
and of the predictors' `OCC_SUB` handling.  Two formats load:

- the numpy export of the bundled checkpoints (`weights_torch/<net>.npz`
  with `weights_torch/MANIFEST.json`, written by
  `tools/export_torch_weights.py`), or the same format as the port's
  trainer writes it (`parallel/train.py::save_params`, every array
  float32): state-dict keys of the port's networks; `uint16` arrays hold
  bf16 bit patterns, which widen to float32 exactly;
- a reference PyTorch checkpoint (`.pth`, possibly under a "model" key),
  whose module names are the port's.

The orbax checkpoints under `weights/` need JAX, orbax and zstandard, which
the port does not use: asking for one raises with the export command.
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

EXPORT_TOOL = "JAX_PLATFORMS=cpu python tools/export_torch_weights.py"
MANIFEST = "MANIFEST.json"


def resolve(ckpt, net):
    """The file @ckpt names for network @net ("refiner" or "scorer"): a
    `.npz` or `.pth` file, `<ckpt>.npz`, or `<ckpt>/<net>.npz`; None where
    nothing exists.  Raises for an orbax checkpoint directory."""
    if not ckpt:
        return None
    if os.path.isdir(ckpt):
        if any(os.path.exists(os.path.join(ckpt, m))
               for m in ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")):
            raise ValueError(f"{ckpt} is an orbax checkpoint, which the PyTorch port does not "
                             f"read; export it to numpy first: {EXPORT_TOOL}")
        ckpt = os.path.join(ckpt, f"{net}.npz")
    elif not os.path.exists(ckpt) and os.path.exists(ckpt + ".npz"):
        ckpt = ckpt + ".npz"
    return ckpt if os.path.isfile(ckpt) else None


def _manifest(path, net):
    mpath = os.path.join(os.path.dirname(path), MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"{path}: no {MANIFEST} beside the export ({EXPORT_TOOL})")
    with open(mpath) as f:
        manifest = json.load(f)
    if net not in manifest:
        raise KeyError(f"{mpath} describes no {net}")
    return manifest


def cfg_overrides(path, net):
    """The predictor cfg entries the checkpoint was trained with (the JAX
    predictor's OCC_SUB marker), from the export's manifest; {} for `.pth`."""
    if not path.endswith(".npz"):
        return {}
    return dict(_manifest(path, net)[net].get("cfg", {}))


def stored_dtype(path, net):
    """"bfloat16" where the export at @path rounded @net's weights for bf16
    compute, "float32" where they are the trained values; None for `.pth`.
    The trainer records each net's dtype; the export, one for the file."""
    if not path.endswith(".npz"):
        return None
    manifest = _manifest(path, net)
    return manifest[net].get("compute_dtype", manifest.get("compute_dtype"))


def load_params(ckpt, net, compute_dtype=torch.bfloat16):
    """State dict (float32 tensors) of network @net from @ckpt, or None
    where @ckpt names nothing that exists (the caller then initialises from
    its seed).  A bf16 export is refused for float32 compute: JAX's fp32
    path would use the unrounded weights."""
    path = resolve(ckpt, net)
    if path is None:
        logging.info(f"No checkpoint found at {ckpt!r}: initializing {net} from its seed")
        return None
    if path.endswith(".pth"):
        logging.info(f"Loading torch checkpoint {path}")
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd and not isinstance(sd["model"], torch.Tensor):
            sd = sd["model"]
        return {k: v.float() for k, v in sd.items()}
    manifest = _manifest(path, net)
    if stored_dtype(path, net) == "bfloat16" and compute_dtype != torch.bfloat16:
        raise ValueError(f"{path} stores bf16-rounded weights for bf16 compute; a "
                         f"{compute_dtype} predictor needs the fp32 checkpoint")
    logging.info(f"Loading exported checkpoint {path}")
    kinds = manifest[net]["arrays"]
    sd = {}
    with np.load(path) as z:
        for key in z.files:
            a = z[key]
            if kinds[key] == "bf16":
                if a.dtype != np.uint16:
                    raise ValueError(f"{path}: {key} is marked bf16 but stored as {a.dtype}")
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float()
            else:
                t = torch.from_numpy(np.array(a, dtype=np.float32))
            sd[key] = t
    return sd
