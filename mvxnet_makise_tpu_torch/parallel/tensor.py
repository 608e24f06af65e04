"""Collectives with autograd, and the model axis's column-parallel layers.

JAX's model axis is a sharding annotation: XLA's SPMD partitioner splits
a kernel's output channels over ``'model'`` and inserts the collectives
(``mvxnet_makise_tpu/parallel/mesh.py``).  PyTorch has no such route for
convolutions (DTensor's convolution strategy shards only the batch, and
``ColwiseParallel`` takes only ``Linear`` and ``Embedding``), so the port
writes the column-parallel layer out: each model rank holds its slice of
a layer's output channels (weight and bias), computes that slice, and
all-gathers the slices along the channel axis.  Every model rank then
holds the whole output and computes the same replicated downstream, the
same loss included.  That fixes both backwards:

* the gather's backward is this rank's slice of the cotangent (every
  rank's cotangent is the same whole one): not a sum over ranks, which
  would scale the slice's gradient by the model-axis size;
* the layer's input gradient is a sum over ranks of each slice's part, so
  the input passes through :func:`copy_to_model`, the identity whose
  backward all-reduces.

The data axis is the opposite case: each data rank's loss term is its
own, so :func:`all_reduce_sum` (batch-scope norm statistics) sums the
cotangents in its backward.

Folded norms' ``scale`` and ``bias`` stay replicated: the output they act
on is already gathered.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, on every rank; its
    backward sums the cotangents over the ranks (each rank's loss term is
    its own)."""
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its backward sums the cotangent over the model ranks,
    whose column slices each contributed a part of the input's
    gradient."""
    return _CopyToModel.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[dim]
        parts = [torch.empty_like(x.contiguous())
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width)
                .contiguous(), None, None)


def gather_channels(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model ranks' slices of ``x`` concatenated along ``dim``, in
    rank order; the backward is this rank's slice of the cotangent."""
    return _GatherChannels.apply(x, dim % x.dim(), group)


class ColumnParallel(nn.Module):
    """One rank's column slice of a layer: ``weight`` and ``bias`` keep the
    layer's parameter names and hold output channels ``[rank * n, (rank +
    1) * n)`` of the whole layer's.  ``load_state_dict`` takes the whole
    layer's tensors and slices them (or this rank's slices as they are).

    ``kind`` is the layer type the slice computes: "linear"
    (``nn.Linear``, output channels last), "conv2d" (``nn.Conv2d``),
    "deconv2d" (``nn.ConvTranspose2d``, whose weight keeps its output
    channels on dim 1) or "conv3d" (``models.voxelnet.Conv3dParams``,
    called with its stride and padding)."""

    OUT_DIM = {"linear": 0, "conv2d": 0, "deconv2d": 1, "conv3d": 0}

    def __init__(self, layer: nn.Module, kind: str, group,
                 config: Optional[dict] = None):
        super().__init__()
        self.kind, self.group = kind, group
        self.config = dict(config or {})
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        dim = self.OUT_DIM[kind]
        out = layer.weight.shape[dim]
        if out % size:
            raise ValueError(f"{out} output channels do not split over "
                             f"{size} model ranks")
        self.width, self.rank = out // size, rank
        self.whole = out
        start = rank * self.width
        self.weight = nn.Parameter(
            layer.weight.detach().narrow(dim, start, self.width).clone(),
            requires_grad=layer.weight.requires_grad)
        bias = getattr(layer, "bias", None)
        if bias is None:
            self.bias = None
        else:
            self.bias = nn.Parameter(
                bias.detach().narrow(0, start, self.width).clone(),
                requires_grad=bias.requires_grad)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("weight", "bias"):
            t = state_dict.get(prefix + name)
            dim = self.OUT_DIM[self.kind] if name == "weight" else 0
            if t is not None and t.dim() > dim and t.shape[dim] == self.whole:
                state_dict[prefix + name] = t.narrow(
                    dim, self.rank * self.width, self.width)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, stride=None, padding=None
                ) -> torch.Tensor:
        x = copy_to_model(x, self.group)
        c = self.config
        if self.kind == "linear":
            return gather_channels(F.linear(x, self.weight, self.bias), -1,
                                   self.group)
        if self.kind == "conv2d":
            y = F.conv2d(x, self.weight, self.bias, c["stride"],
                         c["padding"], c["dilation"], c["groups"])
        elif self.kind == "deconv2d":
            y = F.conv_transpose2d(x, self.weight, self.bias, c["stride"],
                                   c["padding"], c["output_padding"],
                                   c["groups"], c["dilation"])
        else:
            y = F.conv3d(x, self.weight, self.bias, stride, padding)
        return gather_channels(y, 1, self.group)


def column_parallel(layer: nn.Module, group) -> ColumnParallel:
    """The column-parallel twin of ``layer`` over ``group`` (the model
    ranks); convolutions pad with zeros, as every one of the models'
    does."""
    from mvxnet_makise_tpu_torch.models.voxelnet import Conv3dParams

    if isinstance(layer, nn.Linear):
        return ColumnParallel(layer, "linear", group)
    if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
        config = dict(stride=layer.stride, padding=layer.padding,
                      dilation=layer.dilation, groups=layer.groups)
        if isinstance(layer, nn.ConvTranspose2d):
            config["output_padding"] = layer.output_padding
            return ColumnParallel(layer, "deconv2d", group, config)
        return ColumnParallel(layer, "conv2d", group, config)
    if isinstance(layer, Conv3dParams):
        return ColumnParallel(layer, "conv3d", group)
    raise TypeError(f"no column-parallel form of {type(layer).__name__}")
