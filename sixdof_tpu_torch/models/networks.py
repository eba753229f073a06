"""RefineNet + ScoreNetMultiPair as PyTorch modules.

Port of `sixdof_tpu/models/networks.py` (itself a mirror of the reference's
learning/models/refine_network.py and score_network.py).  Module and
parameter names follow the reference's state dict (encodeA.0.net.0,
trans_head.0.self_attn.in_proj_weight, ...), so `models/weights.py` maps the
JAX parameter tree onto them one to one.

Shared conv trunk: c_in -> 64 (7x7 s2) -> 128 (3x3 s2) -> 2x ResBlock(128);
concat(A,B) 256 -> 2x ResBlock(256) -> 512 (3x3 s2) -> 2x ResBlock(512);
then sinusoidal position embedding over the H/8 x W/8 tokens and the
attention heads.  Inputs and the public layout are NHWC, as in the JAX
package; convolutions run NCHW inside.

`init_flax_style` draws fresh parameters as the JAX modules initialise
them for training from scratch (he-normal convolutions, lecun-normal
linears, both truncated; zero biases; unit LayerNorm scales; zero output
heads).

Numerics follow the JAX modules: attention is matmul + fp32 softmax, the
LayerNorms use epsilon 1e-6 (flax's default) and compute in fp32, and the
output heads (trans/rot/score linears) run in fp32 outside autocast.  Under
bf16 autocast everything else runs in bf16, as `compute_dtype=bf16` does,
and rounds where flax rounds: a convolution or linear layer rounds its
product to bf16 and then adds its bf16 bias (a second rounding), where
autocast alone would fuse the bias into the fp32 accumulator; attention
divides by sqrt(head dim) rounded to bf16, as JAX's weak-typed scalar is.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def sinusoidal_position_embedding(max_len, d_model):
    """(1, max_len, d_model) torch-PositionalEmbedding table (numpy float32)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


def _position_embedding(n_tokens, d_model, device):
    """The 400-row table, extended by the same formula for larger crops."""
    pe = sinusoidal_position_embedding(max(400, n_tokens), d_model)[:, :n_tokens]
    return torch.as_tensor(pe, device=device)


def _bf16_autocast(x):
    """True under bf16 autocast on @x's device."""
    dev = x.device.type
    return torch.is_autocast_enabled(dev) and torch.get_autocast_dtype(dev) == torch.bfloat16


def _linear(x, weight, bias):
    """F.linear; under bf16 autocast the product is rounded before the bias
    is added in bf16, as flax's `nn.Dense(dtype=bfloat16)` computes it."""
    if _bf16_autocast(x):
        return F.linear(x, weight) + bias.to(torch.bfloat16)
    return F.linear(x, weight, bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d rounding as flax's `nn.Conv(dtype=bfloat16)` under bf16
    autocast (product, then the bf16 bias); unchanged otherwise."""

    def forward(self, x):
        if _bf16_autocast(x):
            return self._conv_forward(x, self.weight, None) + \
                self.bias.to(torch.bfloat16)[:, None, None]
        return super().forward(x)


class Linear(nn.Linear):
    """nn.Linear rounding as flax's `nn.Dense(dtype=bfloat16)` under bf16
    autocast; unchanged otherwise."""

    def forward(self, x):
        return _linear(x, self.weight, self.bias)


class ConvReLU(nn.Module):
    def __init__(self, c_in, c_out, kernel_size=3, stride=1):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.net = nn.Sequential(Conv2d(c_in, c_out, kernel_size, stride, pad), nn.ReLU())

    def forward(self, x):
        return self.net(x)


class ResnetBasicBlock(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 3, 1, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        return F.relu(self.conv2(out) + x)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention-compatible self-attention (packed QKV)."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def in_proj(self, x):
        """The packed QKV projection (a tensor-parallel trainer replaces it
        on the instance with its split product)."""
        return _linear(x, self.in_proj_weight, self.in_proj_bias)

    def forward(self, x):
        B, N, D = x.shape
        H = self.num_heads
        hd = D // H
        qkv = self.in_proj(x)
        q, k, v = (t.reshape(B, N, H, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = torch.matmul(q, k.transpose(-1, -2))
        # the scale in the product's dtype, as JAX casts a Python scalar
        attn = attn / torch.tensor(math.sqrt(hd), dtype=attn.dtype)
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
        return self.out_proj(out)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 with flax's epsilon (1e-6)."""

    def __init__(self, d):
        super().__init__(d, eps=1e-6)

    def forward(self, x):
        with torch.autocast(device_type=x.device.type, enabled=False):
            return super().forward(x.float())


class Linear32(nn.Linear):
    """Output head: fp32 inputs and weights, outside autocast."""

    def forward(self, x):
        with torch.autocast(device_type=x.device.type, enabled=False):
            return super().forward(x.float())


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer (post-norm, relu) at eval."""

    def __init__(self, d_model, nhead, dim_feedforward=512):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm32(d_model)
        self.norm2 = LayerNorm32(d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        f = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + f)


def _encoders(c_in):
    encA = nn.Sequential(ConvReLU(c_in, 64, 7, 2), ConvReLU(64, 128, 3, 2),
                         ResnetBasicBlock(128), ResnetBasicBlock(128))
    encAB = nn.Sequential(ResnetBasicBlock(256), ResnetBasicBlock(256), ConvReLU(256, 512, 3, 2),
                          ResnetBasicBlock(512), ResnetBasicBlock(512))
    return encA, encAB


def _trunk(encA, encAB, A, B):
    """NHWC A,B (n,H,W,c_in) -> (n, H/8*W/8, 512) tokens in row-major order."""
    n = A.shape[0]
    x = torch.cat([A, B], dim=0).permute(0, 3, 1, 2)
    x = encA(x)
    ab = encAB(torch.cat([x[:n], x[n:]], dim=1))
    return ab.flatten(2).transpose(1, 2)


class RefineNet(nn.Module):
    """(learning/models/refine_network.py:26-93)"""

    def __init__(self, c_in=6, rot_rep="axis_angle"):
        super().__init__()
        self.encodeA, self.encodeAB = _encoders(c_in)
        rot_out = 3 if rot_rep == "axis_angle" else 6
        self.trans_head = nn.Sequential(TransformerEncoderLayer(512, 4, 512), Linear32(512, 3))
        self.rot_head = nn.Sequential(TransformerEncoderLayer(512, 4, 512), Linear32(512, rot_out))

    def forward(self, A, B):
        tokens = _trunk(self.encodeA, self.encodeAB, A, B)
        tokens = tokens + _position_embedding(tokens.shape[1], 512, tokens.device).to(tokens.dtype)
        trans = self.trans_head(tokens).mean(dim=1)
        rot = self.rot_head(tokens).mean(dim=1)
        return {"trans": trans.float(), "rot": rot.float()}


class ScoreNetMultiPair(nn.Module):
    """(learning/models/score_network.py:27-90)"""

    def __init__(self, c_in=6):
        super().__init__()
        self.encoderA, self.encoderAB = _encoders(c_in)
        self.att = MultiheadAttention(512, 4)
        self.att_cross = MultiheadAttention(512, 4)
        self.linear = Linear32(512, 1)

    def features(self, A, B):
        """The per-hypothesis part: the trunk, `att` and the token mean.
        A,B: (N,H,W,c_in) NHWC; returns (N, 512)."""
        tokens = _trunk(self.encoderA, self.encoderAB, A, B)
        tokens = tokens + _position_embedding(tokens.shape[1], 512, tokens.device).to(tokens.dtype)
        return self.att(tokens).mean(dim=1)

    extract_feat = features  # the flax module's name for this part

    def cross(self, feats, L):
        """The cross-hypothesis part: `att_cross` over each group of L
        features, then `linear`.  feats: (n*L, 512); returns (n, L).  Every
        score depends on its whole group, so a sharded scorer gathers the
        features of all its ranks before this part."""
        x = self.att_cross(feats.reshape(feats.shape[0] // L, L, -1))
        return self.linear(x)[..., 0]

    def forward(self, A, B, L):
        """A,B: (n*L,H,W,c_in) NHWC; returns {"score_logit": (n, L)}."""
        return {"score_logit": self.cross(self.features(A, B), L)}


# flax's truncated-normal variance scaling draws from N(0, 1) cut at +-2 and
# divides the standard deviation by that distribution's own (0.8796...),
# so the kept values have the requested variance
_TRUNC_STD = 0.87962566103423978
# the output heads flax initialises to zero (RefineNet's trans_linear and
# rot_linear, ScoreNet's linear): random heads start tanh-saturated
ZERO_HEADS = ("trans_head.1.", "rot_head.1.", "linear.")


def _truncated_normal_(p, std, generator):
    """@p <- std / _TRUNC_STD * x, x ~ N(0, 1) truncated to [-2, 2] (the
    bounds are in units of the unscaled x, as flax draws them).  Values
    outside are redrawn (about 4.6% a round): the same truncated
    distribution as torch's inverse-CDF `trunc_normal_`, several times
    faster on the CPU."""
    x = torch.empty(p.numel(), dtype=torch.float32).normal_(generator=generator)
    redraw = (x.abs() > 2.0).nonzero().squeeze(1)
    while redraw.numel():
        y = torch.empty(redraw.numel()).normal_(generator=generator)
        x[redraw] = y
        redraw = redraw[y.abs() > 2.0]
    p.copy_(x.view(p.shape) * (std / _TRUNC_STD))


@torch.no_grad()
def init_flax_style(model: nn.Module, generator: torch.Generator):
    """Initialise @model (RefineNet or ScoreNetMultiPair) as its JAX module
    initialises for training: convolutions he_normal (variance 2 / fan_in,
    truncated), every other linear lecun_normal (1 / fan_in, truncated;
    the packed QKV projection draws its (3D, D) weight as one dense kernel
    of fan_in D), biases zero, LayerNorm scales one, output heads zero.
    Draws on the CPU from @generator, then copies to the model's device."""
    for name, p in model.named_parameters():
        if p.ndim == 1:
            p.fill_(1.0 if name.endswith(("norm1.weight", "norm2.weight")) else 0.0)
        elif name.startswith(ZERO_HEADS):
            p.zero_()
        else:
            fan_in = p[0].numel()  # OIHW / (out, in): every dim but the first
            _truncated_normal_(p, math.sqrt((2.0 if p.ndim == 4 else 1.0) / fan_in), generator)
    return model
