"""Weights to and from the reference PyTorch MVXNet.

Port of ``mvxnet_makise_tpu/models/import_reference.py``.  The reference
saves ``MVXNet().state_dict()`` per epoch; :func:`import_reference_checkpoint`
turns one into an :class:`~mvxnet_makise_tpu_torch.models.mvxnet.MVXNetPM`
state dict (or, with ``with_images=False``, the LiDAR-only
``VoxelNetBranchPM``'s), and :func:`export_reference_checkpoint` goes back,
so a model trained here loads into the reference
(``MVXNet().load_state_dict(...)``).

The port's modules already hold PyTorch layouts and the reference's
module names (``models/weights.py`` converts the JAX tree the other way),
so the facts are few, each read off the port's own modules:

* Linear, Conv3d (``Conv3dParams``), Conv2d and ConvTranspose2d weights go
  across as they are: same names, same layouts;
* the fusion MLP's ``conv1``/``conv2`` are 1x1 ``Conv2d`` layers in the
  reference (``head.fusion.conv{1,2}.conv``, weight (out, in, 1, 1)) and
  ``Linear`` layers here (``head.fusion.conv{1,2}.fc``, (out, in));
* the frozen extractor's BatchNorms are :class:`FoldedNorm` ``scale`` /
  ``bias`` here (``resnet_fpn.load_torchvision_fpn_weights`` folds them);
  export writes each as ``weight=scale, bias=bias, running_mean=0,
  running_var=1-eps`` (eps = 1e-5), which BatchNorm computes the same in
  eval mode, and which imports back to the same bits;
* the reference's stateless norms (affine=False, no running statistics)
  hold no state on either side.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mvxnet_makise_tpu_torch.models.resnet_fpn import (
    BN_EPS,
    load_torchvision_fpn_weights,
)

_EXTRACTOR = "head.extractor.backbone."
# reference 1x1 Conv2d <-> port Linear, in the fusion MLP
_FUSION_CONV = re.compile(r"head\.fusion\.(conv\d+)\.conv\.(weight|bias)")
_FUSION_FC = re.compile(r"head\.fusion\.(conv\d+)\.fc\.(weight|bias)")

StateDict = Dict[str, torch.Tensor]


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def import_reference_checkpoint(state_dict: Mapping[str, Any],
                                with_images: bool = True) -> StateDict:
    """Reference ``MVXNet().state_dict()`` (tensors or numpy arrays) ->
    the state dict of :class:`MVXNetPM`, or with ``with_images=False``
    of the LiDAR-only ``VoxelNetBranchPM`` (the ``backbone.*`` keys, the
    prefix dropped).  Load it with ``load_state_dict(..., strict=True)``,
    which names any key the reference and the model do not share."""
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    lidar = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    if not with_images:
        return {k.removeprefix("backbone."): v for k, v in lidar.items()}

    out = dict(lidar)
    for k, v in sd.items():
        if not k.startswith("head.fusion."):
            continue
        m = _FUSION_CONV.fullmatch(k)
        if m:
            layer, kind = m.groups()
            out[f"head.fusion.{layer}.fc.{kind}"] = (
                v[:, :, 0, 0] if kind == "weight" else v)
        else:
            out[k] = v
    extractor = load_torchvision_fpn_weights(
        {k.removeprefix(_EXTRACTOR): v for k, v in sd.items()
         if k.startswith(_EXTRACTOR)})
    out.update({_EXTRACTOR + k: v for k, v in extractor.items()})
    return out


def export_reference_checkpoint(state_dict: Mapping[str, torch.Tensor],
                                with_images: bool = True) -> StateDict:
    """Inverse of :func:`import_reference_checkpoint`: an
    :class:`MVXNetPM` state dict (or the LiDAR-only branch's with
    ``with_images=False``) -> a reference-layout state dict of CPU
    tensors, for ``torch.save``."""
    sd = {k if with_images else "backbone." + k: _tensor(v)
          for k, v in state_dict.items()}
    out: StateDict = {}
    for k, v in sd.items():
        m = _FUSION_FC.fullmatch(k)
        if m:
            layer, kind = m.groups()
            out[f"head.fusion.{layer}.conv.{kind}"] = (
                v[:, :, None, None] if kind == "weight" else v)
        elif k.startswith(_EXTRACTOR) and k.endswith(".scale"):
            # a FoldedNorm: its bias follows under the same prefix
            norm = k.removesuffix(".scale")
            out[norm + ".weight"] = v
            out[norm + ".bias"] = sd[norm + ".bias"]
            out[norm + ".running_mean"] = torch.zeros_like(v)
            # BatchNorm in eval mode divides by sqrt(running_var + eps)
            out[norm + ".running_var"] = torch.full_like(v, 1.0 - BN_EPS)
            out[norm + ".num_batches_tracked"] = torch.tensor(0)
        elif not (k.startswith(_EXTRACTOR)
                  and k.removesuffix(".bias") + ".scale" in sd):
            out[k] = v
    return {k: v.contiguous() for k, v in out.items()}
