"""ResNet50 + FPN image backbone with folded norms, built by hand.

Port of ``mvxnet_makise_tpu/models/resnet_fpn.py`` (torchvision is not a
dependency).  The reference's frozen torchvision
``fasterrcnn_resnet50_fpn_v2`` backbone runs in eval mode, where every
batch norm is an affine map, so each is a per-channel ``scale``/``bias``
(:class:`FoldedNorm`).  7x7/2 stem, 3-4-6-3 bottleneck stages, FPN v2
(conv + norm, no activation, in both the lateral and output blocks) with
nearest-neighbour top-down upsampling; returns pyramid levels 0..2
(strides 4/8/16, 256 channels).

Module names follow the torchvision state dict (``body.conv1``,
``body.layer1.0.downsample.0``, ``fpn.inner_blocks.0.0``, ...), with the
norms' parameters named ``scale`` and ``bias``.
:func:`load_torchvision_fpn_weights` turns a torchvision Faster R-CNN
ResNet50-FPN(-v2) state dict into this module's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FoldedNorm(nn.Module):
    """Frozen batch norm folded to y = x * scale + bias (per channel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) + skip."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FoldedNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = FoldedNorm(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = FoldedNorm(features * 4)
        self.downsample = (nn.Sequential(_conv(cin, features * 4, 1, stride),
                                         FoldedNorm(features * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNetBody(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FoldedNorm(64)
        cin, features = 64, 64
        for li, blocks in enumerate(stage_sizes):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, features,
                                        stride if bi == 0 else 1,
                                        downsample=(bi == 0)))
                cin = features * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            features *= 2
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for li in range(self.num_stages):
            x = getattr(self, f"layer{li + 1}")(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], channels: int = 256,
                 num_levels: int = 3):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(_conv(c, channels, 1), FoldedNorm(channels))
            for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(_conv(channels, channels, 3), FoldedNorm(channels))
            for _ in range(num_levels))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        merged = laterals[-1]
        outs = [None] * len(laterals)
        outs[-1] = merged
        for li in range(len(laterals) - 2, -1, -1):
            h, w = laterals[li].shape[-2:]
            up = merged.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            merged = laterals[li] + up[..., :h, :w]
            outs[li] = merged
        return [blk(outs[li]) for li, blk in enumerate(self.layer_blocks)]


class ResNet50FPN(nn.Module):
    """ResNet50 trunk + FPN pyramid.  Input (B, 3, H, W); returns levels
    0..2 as (B, 256, H/4, W/4), (B, 256, H/8, W/8), (B, 256, H/16, W/16)."""

    def __init__(self, fpn_channels: int = 256,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_levels: int = 3):
        super().__init__()
        self.body = ResNetBody(stage_sizes)
        self.fpn = FPN([256 * 2 ** i for i in range(len(stage_sizes))],
                       fpn_channels, num_levels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.fpn(self.body(x))


# ---------------------------------------------------------------------------
# torchvision weight import
# ---------------------------------------------------------------------------

# torchvision's BatchNorm2d eps
BN_EPS = 1e-5


def _fold_bn(sd: Mapping[str, torch.Tensor], prefix: str,
             eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """torch BN parameters and running statistics -> the folded affine's
    float32 (scale, bias): y = x * scale + bias in eval mode.  Computed in
    numpy, whose float32 division and square root round once each (the
    JAX package's loader gives the same bits)."""
    w, b, mean, var = (sd[f"{prefix}.{k}"].numpy().astype(np.float32)
                       for k in ("weight", "bias", "running_mean",
                                 "running_var"))
    scale = w / np.sqrt(var + np.float32(eps))
    return {"scale": torch.from_numpy(scale),
            "bias": torch.from_numpy(b - mean * scale)}


class _Recording(dict):
    """A dict that remembers which keys were read."""

    def __init__(self, items):
        super().__init__(items)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


def load_torchvision_fpn_weights(state_dict: Mapping[str, Any],
                                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                                 num_levels: int = 3,
                                 strict: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """A torchvision Faster R-CNN ResNet50-FPN(-v2) ``state_dict`` (or just
    its ``backbone.*`` keys, with or without the prefix; tensors or numpy
    arrays) -> a float32 :class:`ResNet50FPN` state dict.

    The keys read are the ones this module holds: each ``Conv2d`` takes
    its weight as it is (both use OIHW), each :class:`FoldedNorm` folds
    the BatchNorm of the same name (torchvision's eps, 1e-5); the v2 FPN
    blocks are ``inner_blocks.{i}.0/.1`` and ``layer_blocks.{i}.0/.1``
    (conv, norm).  ``strict=True`` also raises a ValueError naming every
    input key left unread (a renamed block would otherwise leave random
    weights in its place), except BatchNorm ``num_batches_tracked``
    counters and the FPN output blocks past ``num_levels``, which the
    reference does not consume.  A key the module needs and the input
    lacks raises a KeyError."""
    sd = _Recording(
        (k.removeprefix("backbone."), torch.as_tensor(
            v.detach() if hasattr(v, "detach") else np.asarray(v)).cpu())
        for k, v in state_dict.items())
    with torch.device("meta"):
        target = ResNet50FPN(stage_sizes=stage_sizes, num_levels=num_levels)
    out: Dict[str, torch.Tensor] = {}
    for name, m in target.named_modules():
        if isinstance(m, nn.Conv2d):
            out[name + ".weight"] = sd[name + ".weight"].to(torch.float32)
        elif isinstance(m, FoldedNorm):
            out.update({f"{name}.{k}": v
                        for k, v in _fold_bn(sd, name).items()})
    if strict:
        exempt = tuple(f"fpn.layer_blocks.{li}." for li in
                       range(num_levels, len(stage_sizes)))
        leftover = sorted(k for k in sd if k not in sd.consumed
                          and not k.endswith("num_batches_tracked")
                          and not k.startswith(exempt))
        if leftover:
            raise ValueError(
                "torchvision state_dict keys not consumed by the FPN "
                f"import ({len(leftover)}): {leftover[:8]}...")
    return out
