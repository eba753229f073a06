"""JAX (flax) parameter trees -> state dicts of the port's networks.

The inverse of `sixdof_tpu/models/torch_convert.py` (its key map, turned the
other way, is copied here): Conv kernel HWIO -> weight OIHW, Dense kernel
(in,out) -> Linear weight (out,in), packed-QKV Dense -> in_proj_weight/bias,
LayerNorm scale -> weight.  Input is a nested dict of numpy arrays (e.g.
``jax.tree.map(np.asarray, predictor.params)``), so this module needs
neither JAX nor orbax.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _mha(sd, key, p):
    sd[f"{key}.in_proj_weight"] = _t(np.asarray(p["in_proj"]["kernel"]).T)
    sd[f"{key}.in_proj_bias"] = _t(p["in_proj"]["bias"])
    _dense(sd, f"{key}.out_proj", p["out_proj"])


def _encoder_layer(sd, key, p):
    _mha(sd, f"{key}.self_attn", p["self_attn"])
    _dense(sd, f"{key}.linear1", p["linear1"])
    _dense(sd, f"{key}.linear2", p["linear2"])
    for n in ("norm1", "norm2"):
        sd[f"{key}.{n}.weight"] = _t(p[n]["scale"])
        sd[f"{key}.{n}.bias"] = _t(p[n]["bias"])


def _trunk(sd, a_name, ab_name, p):
    """flax encodeA_i / encodeAB_i -> Sequential indices (ConvReLU = net.0)."""
    for i in (0, 1):
        _conv(sd, f"{a_name}.{i}.net.0", p[f"encodeA_{i}"]["conv"])
    for i in (2, 3):
        for c in ("conv1", "conv2"):
            _conv(sd, f"{a_name}.{i}.{c}", p[f"encodeA_{i}"][c])
    for i in (0, 1, 3, 4):
        for c in ("conv1", "conv2"):
            _conv(sd, f"{ab_name}.{i}.{c}", p[f"encodeAB_{i}"][c])
    _conv(sd, f"{ab_name}.2.net.0", p["encodeAB_2"]["conv"])


def refine_state_dict(params):
    """flax RefineNet params -> state dict of models.networks.RefineNet."""
    sd = {}
    _trunk(sd, "encodeA", "encodeAB", params["trunk"])
    _encoder_layer(sd, "trans_head.0", params["trans_encoder"])
    _dense(sd, "trans_head.1", params["trans_linear"])
    _encoder_layer(sd, "rot_head.0", params["rot_encoder"])
    _dense(sd, "rot_head.1", params["rot_linear"])
    return sd


def score_state_dict(params):
    """flax ScoreNetMultiPair params -> state dict of models.networks.ScoreNetMultiPair."""
    sd = {}
    _trunk(sd, "encoderA", "encoderAB", params["trunk"])
    _mha(sd, "att", params["att"])
    _mha(sd, "att_cross", params["att_cross"])
    _dense(sd, "linear", params["linear"])
    return sd


def params_from_jax(params):
    """Either network's flax params -> state dict (chosen by the tree's keys)."""
    return refine_state_dict(params) if "trans_encoder" in params else score_state_dict(params)
