"""Device resolution and numeric precision for the port.

Entry points take an explicit ``device``.  ``None`` means the card: without
CUDA that raises instead of silently running on the CPU, so a measurement
can never come from the wrong device.  ``"cpu"`` is an explicit request
(the tests use it).

Geometry (positions, raster setup, backprojection, warps, ICP) stays in
full fp32: TF32 is switched off for both matmuls and cuDNN convolutions.
The networks alone run under bf16 autocast, as the JAX predictors run them
(``compute_dtype=jnp.bfloat16``).
"""
from __future__ import annotations

import contextlib

import torch


def set_fp32_precision():
    """Full fp32 for float32 matmuls and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA card (raises without one); else the given
    device.  Sets fp32 precision whenever a CUDA device is returned."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        set_fp32_precision()
    return dev


def network_autocast(device: torch.device, dtype=torch.bfloat16):
    """Autocast context for the networks: bf16 activations, or nothing when
    @dtype is float32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)
