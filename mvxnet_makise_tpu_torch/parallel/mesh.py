"""Device mesh and sharding rules over ``torch.distributed``.

Port of ``mvxnet_makise_tpu/parallel/mesh.py``.  JAX's single controller
holds a ``('data', 'model')`` mesh of devices and XLA's SPMD partitioner
inserts the collectives; here every rank is a process holding one
device, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of
ranks with the same two axes:

* **data parallelism**: every per-frame array is cut along its batch axis
  over ``'data'`` (:func:`shard_batch`: each rank keeps its contiguous
  rows); the train step (``train/step.make_train_step(mesh=...)``)
  averages the gradients and metrics over the data ranks, and batch-scope
  norms pool their statistics over them (``models/blocks.set_norm_scope``);
* **model (tensor) parallelism**: JAX's rule shards a kernel's output
  channels over ``'model'`` when the axis has more than one rank and the
  layer has at least 256 output channels, a multiple of the axis size.
  :func:`shard_params` replaces every layer the rule picks with its
  column-parallel twin (``parallel/tensor.py``).

A :class:`Placement` stands for JAX's ``NamedSharding``: the mesh and a
``PartitionSpec``-like tuple naming, per dimension, the mesh axis it is
cut over.  Every rank passes the whole batch and the whole parameters,
as JAX's single controller holds them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")
# JAX's _MIN_SHARD_CHANNELS
_MIN_SHARD_CHANNELS = 256


class Placement(NamedTuple):
    """How a tensor lies over a mesh: ``spec[i]`` is the mesh axis that
    dimension ``i`` is cut over (None: whole); dimensions past the spec
    are whole.  ``spec == ()`` is replicated."""
    mesh: Any
    spec: Tuple[Optional[str], ...]


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[int]] = None):
    """A ``('data', 'model')`` DeviceMesh over the ranks ``devices``
    (default: every rank of the initialized world), on the CUDA card
    under NCCL and on the CPU under gloo.  ``shape=None`` puts every rank
    on the data axis.  Every rank of the world calls it."""
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialized process "
                               "group (parallel.initialize_distributed)")
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.initialize_distributed)")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor(np.asarray(devices, np.int64).reshape(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` ("data" or "model")."""
    return int(mesh.size(AXES.index(axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharding(mesh) -> Placement:
    """Placement of every batch field: the leading (batch) axis over
    'data'."""
    return Placement(mesh, ("data",))


def local_part(x, placement: Placement):
    """This rank's part of the whole tensor or array ``x`` under
    ``placement``: contiguous equal blocks along each cut dimension, in
    the order of the axis's ranks."""
    for dim, axis in enumerate(placement.spec):
        if axis is None:
            continue
        n = axis_size(placement.mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                             f"not split over {n} '{axis}' ranks")
        w = x.shape[dim] // n
        i = axis_index(placement.mesh, axis)
        index = (slice(None),) * dim + (slice(i * w, (i + 1) * w),)
        x = x[index]
    return x


def shard_batch(batch, mesh):
    """This rank's rows of every field of ``batch`` (a tensor, an array,
    or a tuple, NamedTuple, list or dict of them; None fields stay
    None): the batch is cut into contiguous equal blocks over the data
    ranks, block i on data rank i.  Every rank passes the whole batch."""
    s = batch_sharding(mesh)

    def cut(x):
        if x is None:
            return None
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return local_part(x, s)
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(cut(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        raise TypeError(f"cannot shard a batch field of type {type(x)}")

    return cut(batch)


# -- parameter partitioning rules -------------------------------------------

def _shardable_layers():
    from mvxnet_makise_tpu_torch.models.voxelnet import Conv3dParams

    return (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, Conv3dParams)


def _out_channels(layer: nn.Module) -> int:
    dim = 1 if isinstance(layer, nn.ConvTranspose2d) else 0
    return int(layer.weight.shape[dim])


def sharded_layers(model: nn.Module, model_axis_size: int) -> Dict[str, int]:
    """JAX's output-channel rule (``_spec_for_param``) over ``model``'s
    layers: name -> output channels of every ``nn.Linear``,
    ``nn.Conv2d``, ``nn.ConvTranspose2d`` and ``Conv3dParams`` whose
    output channels split over the model axis (more than one rank, at
    least 256 channels, a multiple of the axis size)."""
    if model_axis_size <= 1:
        return {}
    from mvxnet_makise_tpu_torch.parallel.tensor import ColumnParallel

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ColumnParallel):
            out[name] = m.whole
        elif isinstance(m, _shardable_layers()):
            c = _out_channels(m)
            if c >= _MIN_SHARD_CHANNELS and c % model_axis_size == 0:
                out[name] = c
    return out


def param_sharding(model: nn.Module, mesh) -> Dict[str, Placement]:
    """Placement of every parameter of ``model`` (by its
    ``named_parameters`` name) under JAX's rule: the output-channel
    dimension of a picked layer's weight (dim 1 of a ConvTranspose2d's,
    dim 0 of the others') and its bias over 'model'; everything else,
    folded norms included, replicated."""
    from mvxnet_makise_tpu_torch.parallel.tensor import ColumnParallel

    picked = sharded_layers(model, axis_size(mesh, "model"))
    mods = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        layer, _, leaf = name.rpartition(".")
        spec: Tuple[Optional[str], ...] = ()
        if layer in picked and leaf in ("weight", "bias"):
            m = mods[layer]
            deconv = (isinstance(m, nn.ConvTranspose2d)
                      or (isinstance(m, ColumnParallel)
                          and m.kind == "deconv2d"))
            spec = ((None, "model") if leaf == "weight" and deconv
                    else ("model",))
        out[name] = Placement(mesh, spec)
    return out


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Place ``model`` on the mesh, in place, and return it: every layer
    :func:`param_sharding` cuts becomes its column-parallel twin over the
    mesh's model ranks (this rank's slice of the layer's weight and bias,
    under the same parameter names), and with more than one data rank
    every batch-scope norm pools its statistics over the data ranks
    (``models/blocks.set_norm_scope``), as JAX's SPMD program takes them
    over the global batch.  The model must hold the same whole weights on
    every rank.  On a (1, 1) mesh nothing changes.  K1's layer (the
    column CML's conv1, 64 channels) and the fusion MLP (16 out) stay
    whole, so every kernel's arguments are unchanged."""
    from mvxnet_makise_tpu_torch.parallel.tensor import (
        ColumnParallel,
        column_parallel,
    )

    if axis_size(mesh, "data") > 1:
        data = mesh.get_group("data")
        for m in model.modules():
            if getattr(m, "batch_stats", False):
                m.stats_group = data
    picked = sharded_layers(model, axis_size(mesh, "model"))
    if not picked:
        return model
    group = mesh.get_group("model")
    mods = dict(model.named_modules())
    for name in picked:
        layer = mods[name]
        if isinstance(layer, ColumnParallel):
            continue
        parent_name, _, attr = name.rpartition(".")
        parent = mods[parent_name] if parent_name else model
        setattr(parent, attr, column_parallel(layer, group))
    return model

