"""Prediction decoding: score/reg maps -> final detections (port of
``mvxnet_makise_tpu/eval/decode.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvxnet_makise_tpu_torch.geometry.boxes import decode_boxes
from mvxnet_makise_tpu_torch.ops.nms import rotated_nms_bev


class Detections(NamedTuple):
    boxes: torch.Tensor    # (K, 7) xyzlwhr
    scores: torch.Tensor   # (K,)
    valid: torch.Tensor    # (K,) bool
    classes: torch.Tensor  # (K,) int32 — anchor-slot class (slot // 2)


def decode_predictions(score: torch.Tensor,
                       reg: torch.Tensor,
                       anchors: torch.Tensor,
                       *,
                       score_threshold: float = 0.3,
                       nms_iou_threshold: float = 0.1,
                       pre_max_size: int = 256,
                       post_max_size: int = 64) -> Detections:
    """Single frame.  score: (H, W, A); reg: (H, W, A*7) or (H, W, A, 7);
    anchors: (H, W, A, 7).  ``pre_max_size`` bounds the NMS candidate
    pool."""
    H, W, A, _ = anchors.shape
    flat_scores = score.reshape(-1)
    deltas = reg.reshape(H, W, A, 7)
    boxes = decode_boxes(deltas, anchors).reshape(-1, 7)
    idx, scores, valid = rotated_nms_bev(
        boxes, flat_scores,
        iou_threshold=nms_iou_threshold,
        score_threshold=score_threshold,
        pre_max_size=pre_max_size, post_max_size=post_max_size)
    # anchor slot ordering is [cls0_yaw0, cls0_yaw90, cls1_yaw0, ...]
    # (ops/assign.create_anchors), so class = slot // 2
    classes = torch.div(idx % A, 2, rounding_mode="floor").to(torch.int32)
    return Detections(boxes=boxes[idx], scores=scores, valid=valid,
                      classes=classes)
