"""The `model` axis: the trainers' large layers split by output feature.

Port of `sixdof_tpu/parallel/sharding.py::param_shardings` and of what
GSPMD makes of it in `sixdof_tpu/parallel/train.py`'s trainers.  JAX's rule
shards the last (output-feature) dim of every kernel with at least 2 dims
whose output size is at least `MIN_SPLIT` and divides the model axis; the
rest is replicated.  Flax's last kernel dim is dim 0 of the port's weights
(`Conv2d` (out, in, kh, kw), `Linear` (out, in), the packed QKV
`in_proj_weight` (3D, D)), so the same rule on the port's state dict picks
the same parameters (`models/weights.py` maps the names): at the trainers'
widths the nine 256- and 512-channel trunk convolutions, and each
attention's QKV and output projections and the encoder layers' two
linears.

`shard_model` splits the layers (`models/networks.py`'s `Conv2d`, `Linear`
and `MultiheadAttention`'s QKV projection, its `in_proj`) and installs
their column-parallel product: a model rank holds rows [i*out/n,
(i+1)*out/n) of the weight, computes its slice of the output without the
bias, gathers the slices over the model group along the channel axis and
adds the whole, replicated bias (JAX keeps biases replicated too).  The
collectives are Megatron's pair of autograd functions: the input enters
through `_CopyToModel` (identity; the backward sums the input gradient
over the model group) and the output leaves through `_GatherFromModel`
(all_gather; the backward keeps this rank's slice of the output
gradient).  Each split weight carries its mesh as `split_mesh`.

The optimiser runs per rank on its shards and replicated parameters (Adam
is elementwise, so that is a slice of the unsharded update).  Gradients:
each shard's is averaged over its data group, each replicated one over
every rank of the mesh, so replicated parameters stay bit-equal across the
model ranks even where the backward passes round otherwise."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.networks import Conv2d, Linear, MultiheadAttention
from .sharding import all_gather, all_reduce, average_gradients

MIN_SPLIT = 256  # JAX param_shardings' min_size default


def split_names(shapes, n_model):
    """The parameters JAX's `param_shardings` shards over a model axis of
    @n_model, by name, from {name: shape} (a state dict's names): at least
    2 dims, dim 0 (the output features) at least MIN_SPLIT and divisible by
    @n_model."""
    if n_model <= 1:
        return []
    return [name for name, shape in shapes.items()
            if len(shape) >= 2 and shape[0] >= MIN_SPLIT and shape[0] % n_model == 0]


class _CopyToModel(torch.autograd.Function):
    """Forward the identity; backward the input gradient summed over the
    model group (each rank's split layer saw only its slice of the output)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, "model"), None


class _GatherFromModel(torch.autograd.Function):
    """Forward the model ranks' output slices concatenated along @dim;
    backward this rank's slice of the output gradient."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, y.shape[dim]
        return all_gather(y, mesh, dim=dim, axis="model")

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.model_rank * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None, None


def column_parallel(x, product, bias, mesh, dim):
    """A split layer's output: @product (this rank's weight rows applied to
    @x, no bias) gathered over @mesh's model axis along @dim, plus the whole
    @bias (already shaped to broadcast), added in the product's dtype (bf16
    under autocast, as flax adds its bf16 bias after the product)."""
    y = _GatherFromModel.apply(product(_CopyToModel.apply(x, mesh)), mesh, dim)
    return y + bias.to(y.dtype)


def _split_product(layer, attr, mesh):
    """Route @layer's product with its split weight @attr through
    `column_parallel` over @mesh."""
    kind = type(layer)
    if kind is MultiheadAttention and attr == "in_proj_weight":
        layer.in_proj = lambda x: column_parallel(
            x, lambda x: F.linear(x, layer.in_proj_weight), layer.in_proj_bias, mesh, dim=-1)
    elif kind is Conv2d and attr == "weight":
        layer.forward = lambda x: column_parallel(
            x, lambda x: layer._conv_forward(x, layer.weight, None), layer.bias[:, None, None],
            mesh, dim=1)
    elif kind is Linear and attr == "weight":
        layer.forward = lambda x: column_parallel(
            x, lambda x: F.linear(x, layer.weight), layer.bias, mesh, dim=-1)
    else:
        raise TypeError(f"the model axis splits no {kind.__name__}.{attr}")


def shard_model(model: nn.Module, mesh):
    """Split @model's parameters that `split_names` picks over @mesh's model
    axis, in place: each keeps this model rank's rows (tagged `split_mesh`),
    and its layer computes that product through `column_parallel`.  Call it
    on the whole, initialised model; returns the names split."""
    n = mesh.shape["model"]
    names = split_names({k: tuple(p.shape) for k, p in model.named_parameters()}, n)
    layers = dict(model.named_modules())
    for name in names:
        owner, attr = name.rsplit(".", 1)
        layer = layers[owner]
        w = getattr(layer, attr)
        rows = w.shape[0] // n
        part = nn.Parameter(w.detach()[mesh.model_rank * rows:(mesh.model_rank + 1) * rows]
                            .clone(), requires_grad=w.requires_grad)
        part.split_mesh = mesh
        _split_product(layer, attr, mesh)
        setattr(layer, attr, part)
    return names


def split_parameters(model: nn.Module):
    """{name: (parameter, mesh)} of @model's split weights."""
    return {name: (p, p.split_mesh) for name, p in model.named_parameters()
            if getattr(p, "split_mesh", None) is not None}


def model_mesh(model: nn.Module):
    """The mesh @model is split over, or None."""
    split = split_parameters(model)
    return next(iter(split.values()))[1] if split else None


def full_tensors(model: nn.Module, grads=False):
    """{name: tensor} of @model's whole parameters (@grads: their
    gradients), each split weight gathered over the model axis.  Every rank
    of the model group must call it."""
    split = split_parameters(model)
    out = {}
    for name, p in model.named_parameters():
        t = (p.grad if grads else p).detach()
        out[name] = all_gather(t, split[name][1], axis="model") if name in split else t
    return out


def full_state_dict(model: nn.Module):
    """@model's state dict with every split weight gathered: the names and
    shapes of the unsplit model.  Every rank of the model group must call it."""
    params = full_tensors(model)
    return {k: params.get(k, v) for k, v in model.state_dict().items()}


def reduce_gradients(model: nn.Module, mesh):
    """The trainers' gradient average: each split weight's over its data
    group, every other parameter's over the whole mesh."""
    split = {id(p) for p, _ in split_parameters(model).values()}
    params = list(model.parameters())
    average_gradients([p for p in params if id(p) in split], mesh)
    average_gradients([p for p in params if id(p) not in split], mesh, axis="world")
