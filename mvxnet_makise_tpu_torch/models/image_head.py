"""Image branch: detection transform, frozen ResNet50-FPN, per-point FPN
gather (K2) and the 768 -> 16 fusion MLP.

Port of ``transform_output_shape``, ``gather_image_size``,
``detection_transform``, ``PointImageFusion`` and ``PointImageHead`` from
``mvxnet_makise_tpu/models/image_head.py``.  The JAX package's gather
backends ("raw4", "raw4f", "xla", "pallas") are layouts of one function;
here it is K2 (``ops/gather.fpn_gather``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvxnet_makise_tpu_torch.device import device_constant
from mvxnet_makise_tpu_torch.models.blocks import DenseReluNormVirtual
from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
from mvxnet_makise_tpu_torch.ops.gather import fpn_gather

# torchvision GeneralizedRCNNTransform defaults
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_MIN_SIZE = 800.0
_MAX_SIZE = 1333.0
_PAD_STRIDE = 32


def _transform_scale(h: int, w: int, min_side: float) -> float:
    """GeneralizedRCNNTransform scale for an (h, w) image; ``min_side <=
    0`` = native scale.  Sub-800 settings shrink the max-side cap in
    proportion; larger ones keep the fixed 1333 cap."""
    if min_side <= 0:
        return 1.0
    max_side = _MAX_SIZE * min(min_side / _MIN_SIZE, 1.0)
    return min(min_side / min(h, w), max_side / max(h, w))


def transform_output_shape(image_size: Sequence[int],
                           min_side: float = _MIN_SIZE
                           ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((resized h, w), (padded h, w)) for an input (h, w); the resized
    sizes are int-floored, the padded ones rounded up to 32."""
    h, w = image_size
    scale = _transform_scale(h, w, min_side)
    rh, rw = int(h * scale), int(w * scale)
    ph = int(math.ceil(rh / _PAD_STRIDE) * _PAD_STRIDE)
    pw = int(math.ceil(rw / _PAD_STRIDE) * _PAD_STRIDE)
    return (rh, rw), (ph, pw)


def gather_image_size(image_size: Sequence[int],
                      min_side: float = _MIN_SIZE) -> Tuple[float, float]:
    """Effective (h, w) mapping original pixels to feature cells: the raw
    image size at the reference operating point (min_side 800, the
    reference's own convention), else the content-correct ``padded *
    original / resized``."""
    h, w = image_size
    if min_side == _MIN_SIZE:
        return (float(h), float(w))
    (rh, rw), (ph, pw) = transform_output_shape(image_size, min_side)
    return (ph * h / rh, pw * w / rw)


def detection_transform(images: torch.Tensor,
                        min_side: float = _MIN_SIZE) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> normalized, resized, zero-padded
    (B, Hp, Wp, 3), computed in float32 and returned in the input dtype:
    ImageNet normalization first, then a bilinear resize, then padding
    bottom/right to a multiple of 32.

    ``jax.image.resize`` antialiases when it downsamples and
    ``F.interpolate`` does not unless asked, so a shrinking resize passes
    ``antialias=True``."""
    h, w = images.shape[1:3]
    (rh, rw), (ph, pw) = transform_output_shape((h, w), min_side)
    mean = device_constant(_IMAGENET_MEAN, torch.float32, images.device)
    std = device_constant(_IMAGENET_STD, torch.float32, images.device)
    x = (images.to(torch.float32) - mean) / std
    if (rh, rw) != (h, w):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(rh, rw),
                          mode="bilinear", align_corners=False,
                          antialias=(rh < h or rw < w))
        x = x.permute(0, 2, 3, 1)
    x = F.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
    return x.to(images.dtype)


@torch.no_grad()
def fpn_pyramid(backbone: ResNet50FPN, images: torch.Tensor,
                min_side: float = _MIN_SIZE) -> List[torch.Tensor]:
    """(B, H, W, 3) images -> FPN levels 0..2 of the frozen ``backbone``,
    each (B, Hf, Wf, 256) contiguous channels-last.  Detached: the
    extractor is frozen."""
    x = detection_transform(images, min_side)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return [p.permute(0, 2, 3, 1).contiguous() for p in backbone(x)]


class PointImageFusion(nn.Module):
    """768 -> 16 fusion MLP over points, with the empty sample slots as
    virtual rows in every layer's statistics (names fcn1, conv1, fcn2,
    conv2, fcn3 as in the reference's ImageFeatureFusion)."""

    LAYERS = (("fcn1", 768), ("conv1", 128), ("fcn2", 128),
              ("conv2", 16), ("fcn3", 16))

    def __init__(self, in_features: int = 768, eps: float = 1e-6):
        super().__init__()
        cin = in_features
        for name, width in self.LAYERS:
            setattr(self, name, DenseReluNormVirtual(cin, width, eps))
            cin = width

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                n_virtual: torch.Tensor):
        """x: (B, P, 768); mask: (B, P); n_virtual: (B,) empty sample
        slots per sample.  Returns ((B, P, 16) point features, (B, 16)
        empty-slot feature)."""
        z = x.new_zeros((x.shape[0], x.shape[-1]))
        for name, _ in self.LAYERS:
            x, z = getattr(self, name)(x, mask, z, n_virtual)
        return x, z


class Extractor(nn.Module):
    """Holder that gives the backbone the reference's
    ``head.extractor.backbone`` prefix."""

    def __init__(self):
        super().__init__()
        self.backbone = ResNet50FPN()


class PointImageHead(nn.Module):
    """Frozen FPN extractor + per-point gather (K2) + fusion MLP."""

    def __init__(self, image_size: Tuple[int, int] = (370, 1224),
                 eps: float = 1e-6, swapped_bilerp: bool = False,
                 image_min_side: float = _MIN_SIZE):
        super().__init__()
        self.image_size = tuple(image_size)
        self.eps = eps
        self.swapped_bilerp = swapped_bilerp
        self.image_min_side = image_min_side
        self.extractor = Extractor()
        self.fusion = PointImageFusion(768, eps)

    def pyramid(self, images: torch.Tensor) -> List[torch.Tensor]:
        """:func:`fpn_pyramid` of the extractor."""
        return fpn_pyramid(self.extractor.backbone, images,
                           self.image_min_side)

    def forward(self, images: torch.Tensor, points_rc: torch.Tensor,
                point_mask: torch.Tensor, n_virtual: torch.Tensor):
        """images: (B, H, W, 3); points_rc: (B, P, 2) (row, col);
        point_mask: (B, P) rows that landed in a voxel slot; n_virtual:
        (B,) empty sample slots per sample.  Returns ((B, P, 16),
        (B, 16) empty-slot feature)."""
        gathered = fpn_gather(
            self.pyramid(images), points_rc.contiguous(),
            point_mask.contiguous(),
            gather_image_size(self.image_size, self.image_min_side),
            eps=self.eps, swapped_weights=self.swapped_bilerp)
        return self.fusion(gathered, point_mask, n_virtual)
