"""Floating-point operations that a frame needs, by layer, from the
configuration and the frame's voxels: multiply-adds of every matrix
product and convolution count two, elementwise work is not counted.

The count is of what the inputs need, whatever computes it:
- the fusion MLP at each kept point, plus one row for a frame's empty
  slots (they all hold one value);
- the VFE stack at each kept point, plus one empty-slot row per voxel;
- CML conv1 at the (output cell, tap) pairs whose input cell holds a
  voxel (the columns the inputs occupy); conv2 and conv3 over the whole
  grid (after conv1's norm every cell holds a value);
- the ResNet50-FPN trunk and the RPN over their whole maps.

Training counts each trainable layer's forward once and its backward
twice (the input's and the weights' gradients); the frozen image trunk
runs forward only.  The CML's recomputation under ``remat`` is not
counted.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

RESNET_STAGES = (3, 4, 6, 3)


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def resnet_fpn(hp: int, wp: int) -> float:
    """The trunk at a padded (hp, wp) image: ResNet50 and FPN levels 0..2
    (the lateral 1x1 of all four stages, the 3x3 output of three)."""
    total = 0.0
    h, w = math.ceil(hp / 2), math.ceil(wp / 2)
    total += conv(3, 64, 7, h, w)
    h, w = math.ceil(h / 2), math.ceil(w / 2)          # max pool
    cin, width = 64, 64
    sizes = []
    for li, blocks in enumerate(RESNET_STAGES):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and li > 0) else 1
            ho, wo = math.ceil(h / stride), math.ceil(w / stride)
            total += conv(cin, width, 1, h, w)
            total += conv(width, width, 3, ho, wo)
            total += conv(width, width * 4, 1, ho, wo)
            if bi == 0:
                total += conv(cin, width * 4, 1, ho, wo)
            h, w, cin = ho, wo, width * 4
        sizes.append((cin, h, w))
        width *= 2
    for i, (c, fh, fw) in enumerate(sizes):
        total += conv(c, 256, 1, fh, fw)
        if i < 3:
            total += conv(256, 256, 3, fh, fw)
    return total


def padded_image(image_hw: Sequence[int], min_side: float = 800.0
                 ) -> Tuple[int, int]:
    h, w = image_hw
    scale = 1.0
    if min_side > 0:
        cap = 1333.0 * min(min_side / 800.0, 1.0)
        scale = min(min_side / min(h, w), cap / max(h, w))
    rh, rw = int(h * scale), int(w * scale)
    return math.ceil(rh / 32) * 32, math.ceil(rw / 32) * 32


FUSION = ((768, 768), (768, 128), (128, 128), (128, 16), (16, 16))


def rpn(h: int, w: int, cin: int = 128, anchors: int = 2) -> float:
    """The reference RPN trunk (128, 128, 256) / (3, 5, 5) / 256 on an
    (h, w) map."""
    total = 0.0
    h1, w1 = math.ceil(h / 2), math.ceil(w / 2)
    total += conv(cin, 128, 3, h1, w1) + 3 * conv(128, 128, 3, h1, w1)
    h2, w2 = math.ceil(h1 / 2), math.ceil(w1 / 2)
    total += conv(128, 128, 3, h2, w2) + 5 * conv(128, 128, 3, h2, w2)
    h3, w3 = math.ceil(h2 / 2), math.ceil(w2 / 2)
    total += conv(128, 256, 3, h3, w3) + 5 * conv(256, 256, 3, h3, w3)
    # transposed convolutions: every input cell times every tap
    total += conv(128, 256, 3, h1, w1)
    total += conv(128, 256, 2, h2, w2)
    total += conv(256, 256, 4, h3, w3)
    total += conv(768, anchors * 8, 1, h1, w1)
    return total


def frame(stats: Dict[str, int], cfg: Dict, with_images: bool
          ) -> Dict[str, float]:
    """Forward FLOPs of one frame by layer.  ``stats``: kept_points,
    voxels, conv1_pairs (``perfbench.accounting.frames``)."""
    nx, ny, nz = cfg["voxel_shape"]
    K, V = stats["kept_points"], stats["voxels"]
    out: Dict[str, float] = {}
    cin = 7
    if with_images:
        hp, wp = padded_image(cfg["image_size"],
                              cfg.get("image_min_side", 800.0))
        out["image_trunk"] = resnet_fpn(hp, wp)
        out["fusion_mlp"] = sum(2.0 * a * b for a, b in FUSION) * (K + 1)
        cin = 23
    out["vfe"] = 2.0 * (cin * 16 + 32 * 64 + 128 * 128) * (K + V)
    d1 = (nz + 2 - 3) // 2 + 1
    d2 = d1 - 2
    d3 = (d2 + 2 - 3) // 2 + 1
    out["cml"] = (2.0 * 128 * 64 * stats["conv1_pairs"]
                  + 2.0 * 64 * 64 * 27 * nx * ny * (d2 + d3))
    out["rpn"] = rpn(nx, ny, 64 * d3)
    return out


def forward(stats, cfg, with_images) -> float:
    return sum(frame(stats, cfg, with_images).values())


def train(stats, cfg, with_images) -> float:
    """Forward and backward of one frame in a training step."""
    parts = frame(stats, cfg, with_images)
    return sum(v if k == "image_trunk" else 3.0 * v
               for k, v in parts.items())
