"""Weights: seeded initialization, and the bridge from the JAX parameter
tree.

:func:`load_jax_params` writes the JAX package's Flax parameters (nested
dicts of numpy arrays, e.g. ``jax.device_get(state.params)`` from
``mvxnet_makise_tpu.train.loop.build_model_and_state``) into an
:class:`~mvxnet_makise_tpu_torch.models.mvxnet.MVXNetPM`, or into one of
its parts given that part's own subtree, so both packages compute the
same function.  Layout facts:

* Dense kernel (in, out)   -> Linear weight (out, in)
* Conv kernel HWIO         -> Conv2d weight OIHW
* Conv kernel DHWIO        -> Conv3d weight OIDHW
* ConvTranspose kernel (kh, kw, in, out), flipped in both spatial axes
  (flax's ``transpose_kernel=False``) -> ConvTranspose2d weight
  (in, out, kh, kw)
* folded norms stay ``scale`` / ``bias``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mvxnet_makise_tpu_torch.models.image_head import PointImageHead
from mvxnet_makise_tpu_torch.models.mvxnet import MVXNetPM
from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
from mvxnet_makise_tpu_torch.models.voxelnet import RPN, Conv3dParams
from mvxnet_makise_tpu_torch.models.voxelnet_pm import VoxelNetBranchPM

# std of a unit normal truncated to [-2, 2] (flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978

StateDict = Dict[str, np.ndarray]


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initializers (the values
    differ: the generators differ): lecun-normal kernels, xavier-uniform
    for the RPN's convolutions, zero biases, identity folded norms."""
    xavier = set()
    for m in model.modules():
        if isinstance(m, RPN):
            xavier.update(id(c) for c in m.modules()
                          if isinstance(c, (nn.Conv2d, nn.ConvTranspose2d)))
    for m in model.modules():
        if not isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d,
                              Conv3dParams)):
            continue
        if id(m) in xavier:
            nn.init.xavier_uniform_(m.weight, generator=generator)
        else:
            _lecun_normal_(m.weight, generator)
        if m.bias is not None:
            m.bias.zero_()


# -- one layer: (state dict, key prefix, flax subtree) ---------------------

def _dense(sd: StateDict, key: str, tree) -> None:
    sd[key + ".weight"] = np.asarray(tree["kernel"]).T
    sd[key + ".bias"] = np.asarray(tree["bias"])


def _conv2d(sd: StateDict, key: str, tree) -> None:
    sd[key + ".weight"] = np.transpose(np.asarray(tree["kernel"]),
                                       (3, 2, 0, 1))
    if "bias" in tree:
        sd[key + ".bias"] = np.asarray(tree["bias"])


def _conv3d(sd: StateDict, key: str, tree) -> None:
    sd[key + ".weight"] = np.transpose(np.asarray(tree["kernel"]),
                                       (4, 3, 0, 1, 2))
    sd[key + ".bias"] = np.asarray(tree["bias"])


def _deconv2d(sd: StateDict, key: str, tree) -> None:
    k = np.asarray(tree["kernel"])[::-1, ::-1]
    sd[key + ".weight"] = np.transpose(k, (2, 3, 0, 1))
    sd[key + ".bias"] = np.asarray(tree["bias"])


def _norm(sd: StateDict, key: str, tree) -> None:
    sd[key + ".scale"] = np.asarray(tree["scale"])
    sd[key + ".bias"] = np.asarray(tree["bias"])


# -- one module: flax subtree -> state dict relative to the torch module ---

def resnet_fpn_state(ext: Mapping) -> StateDict:
    """JAX ``ResNet50FPN`` subtree -> :class:`ResNet50FPN` state."""
    sd: StateDict = {}
    _conv2d(sd, "body.conv1", ext["conv1"])
    _norm(sd, "body.bn1", ext["bn1"])
    li = 0
    while f"layer{li + 1}_0" in ext:
        bi = 0
        while f"layer{li + 1}_{bi}" in ext:
            blk = ext[f"layer{li + 1}_{bi}"]
            t = f"body.layer{li + 1}.{bi}"
            for i in (1, 2, 3):
                _conv2d(sd, f"{t}.conv{i}", blk[f"conv{i}"])
                _norm(sd, f"{t}.bn{i}", blk[f"bn{i}"])
            if "down_conv" in blk:
                _conv2d(sd, t + ".downsample.0", blk["down_conv"])
                _norm(sd, t + ".downsample.1", blk["down_bn"])
            bi += 1
        li += 1
    for i in range(li):
        _conv2d(sd, f"fpn.inner_blocks.{i}.0", ext[f"fpn_inner{i}"])
        _norm(sd, f"fpn.inner_blocks.{i}.1", ext[f"fpn_inner_bn{i}"])
    i = 0
    while f"fpn_layer{i}" in ext:
        _conv2d(sd, f"fpn.layer_blocks.{i}.0", ext[f"fpn_layer{i}"])
        _norm(sd, f"fpn.layer_blocks.{i}.1", ext[f"fpn_layer_bn{i}"])
        i += 1
    return sd


def image_head_state(head: Mapping) -> StateDict:
    """JAX ``PointImageHead`` subtree -> :class:`PointImageHead` state."""
    sd = {"extractor.backbone." + k: v
          for k, v in resnet_fpn_state(head["extractor"]).items()}
    for name, layer in head["fusion"].items():
        _dense(sd, f"fusion.{name}.fc", layer["fc"])
    return sd


def rpn_state(rpn: Mapping) -> StateDict:
    """JAX ``RPN`` subtree -> :class:`RPN` state."""
    sd: StateDict = {}
    for b in (1, 2, 3):
        _conv2d(sd, f"blk{b}.0.conv", rpn[f"blk{b}_down"]["conv"])
        j = 0
        while f"blk{b}_conv{j}" in rpn:
            _conv2d(sd, f"blk{b}.{j + 1}.conv", rpn[f"blk{b}_conv{j}"]["conv"])
            j += 1
    for d in (1, 2, 3):
        _deconv2d(sd, f"deconv{d}.deconv", rpn[f"deconv{d}"]["deconv"])
    _conv2d(sd, "cls", rpn["cls"])
    _conv2d(sd, "reg", rpn["reg"])
    return sd


def lidar_branch_state(bb: Mapping) -> StateDict:
    """JAX ``VoxelNetBranchPM`` subtree -> :class:`VoxelNetBranchPM`
    state."""
    sd: StateDict = {}
    _dense(sd, "svfe.vfe1.fcn.fc", bb["svfe"]["vfe1"]["fcn"]["fc"])
    _dense(sd, "svfe.vfe2.fcn.fc", bb["svfe"]["vfe2"]["fcn"]["fc"])
    _dense(sd, "fcn.fc", bb["fcn"]["fc"])
    for c in ("conv1", "conv2", "conv3"):
        _conv3d(sd, f"cml.{c}.conv", bb["cml"][c]["conv"])
    sd.update({"rpn." + k: v for k, v in rpn_state(bb["rpn"]).items()})
    return sd


def mvxnet_state(p: Mapping) -> StateDict:
    """JAX ``MVXNetPM`` tree -> :class:`MVXNetPM` state."""
    sd = {"head." + k: v for k, v in image_head_state(p["head"]).items()}
    sd.update({"backbone." + k: v
               for k, v in lidar_branch_state(p["backbone"]).items()})
    return sd


_STATE_OF: Dict[type, Callable[[Mapping], StateDict]] = {
    MVXNetPM: mvxnet_state,
    PointImageHead: image_head_state,
    ResNet50FPN: resnet_fpn_state,
    VoxelNetBranchPM: lidar_branch_state,
    RPN: rpn_state,
}


def _count_leaves(tree: Mapping) -> int:
    return sum(_count_leaves(v) if isinstance(v, Mapping) else 1
               for v in tree.values())


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a JAX parameter tree into ``model``: an :class:`MVXNetPM`
    with the whole model's tree, or a :class:`PointImageHead`,
    :class:`ResNet50FPN`, :class:`VoxelNetBranchPM` or :class:`RPN` with
    the tree of its JAX counterpart.  Every parameter of the model must
    be covered and every leaf of the tree used."""
    p = params["params"] if "params" in params else params
    convert = _STATE_OF.get(type(model))
    if convert is None:
        raise TypeError(f"no JAX parameter mapping for {type(model)}")
    sd = convert(p)
    if _count_leaves(p) != len(sd):
        raise ValueError(f"{_count_leaves(p)} JAX parameters but {len(sd)} "
                         f"mapped: not a {type(model).__name__} tree")
    model.load_state_dict(
        {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=True)
