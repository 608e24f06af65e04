"""Prediction decoding: score/reg maps -> final detections (port of
``mvxnet_makise_tpu/eval/decode.py``), and their host form per frame
(``FrameDetections``, which serving and the evaluator hand out)."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from mvxnet_makise_tpu_torch.geometry.boxes import decode_boxes
from mvxnet_makise_tpu_torch.ops.nms import rotated_nms_bev_batch
from mvxnet_makise_tpu_torch.utils.profiling import span, sync_point


class Detections(NamedTuple):
    boxes: torch.Tensor    # ([B,] K, 7) xyzlwhr
    scores: torch.Tensor   # ([B,] K)
    valid: torch.Tensor    # ([B,] K) bool
    classes: torch.Tensor  # ([B,] K) int32 — anchor-slot class (slot // 2)


class FrameDetections(NamedTuple):
    boxes: np.ndarray     # (K, 7) xyzlwhr (LiDAR frame)
    scores: np.ndarray    # (K,)
    classes: np.ndarray   # (K,) int — index into cfg.target_classes


def decode_batch(score: torch.Tensor,
                 reg: torch.Tensor,
                 anchors: torch.Tensor,
                 *,
                 score_threshold: float = 0.3,
                 nms_iou_threshold: float = 0.1,
                 pre_max_size: int = 256,
                 post_max_size: int = 64) -> Detections:
    """A batch of frames in one pass.  score: (B, H, W, A); reg:
    (B, H, W, A*7) or (B, H, W, A, 7); anchors: (H, W, A, 7).  Returns
    :class:`Detections` whose fields carry a leading B: what
    :func:`decode_predictions` gives each frame.  ``pre_max_size`` bounds
    the NMS candidate pool; the batch's IoU is (B, pre_max_size,
    pre_max_size)."""
    H, W, A, _ = anchors.shape
    B = score.shape[0]
    flat_scores = score.reshape(B, -1)
    deltas = reg.reshape(B, H, W, A, 7)
    boxes = decode_boxes(deltas, anchors).reshape(B, -1, 7)
    with span("mvx.serve.nms"):
        idx, scores, valid = rotated_nms_bev_batch(
            boxes, flat_scores,
            iou_threshold=nms_iou_threshold,
            score_threshold=score_threshold,
            pre_max_size=pre_max_size, post_max_size=post_max_size)
    # anchor slot ordering is [cls0_yaw0, cls0_yaw90, cls1_yaw0, ...]
    # (ops/assign.create_anchors), so class = slot // 2
    classes = torch.div(idx % A, 2, rounding_mode="floor").to(torch.int32)
    picked = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 7))
    return Detections(boxes=picked, scores=scores, valid=valid,
                      classes=classes)


def decode_predictions(score: torch.Tensor,
                       reg: torch.Tensor,
                       anchors: torch.Tensor,
                       *,
                       score_threshold: float = 0.3,
                       nms_iou_threshold: float = 0.1,
                       pre_max_size: int = 256,
                       post_max_size: int = 64) -> Detections:
    """Single frame.  score: (H, W, A); reg: (H, W, A*7) or (H, W, A, 7);
    anchors: (H, W, A, 7).  The one-frame case of :func:`decode_batch`,
    without the batch dimension."""
    det = decode_batch(score[None], reg[None], anchors,
                       score_threshold=score_threshold,
                       nms_iou_threshold=nms_iou_threshold,
                       pre_max_size=pre_max_size,
                       post_max_size=post_max_size)
    return Detections(*(f[0] for f in det))


def _to_host(t: torch.Tensor) -> np.ndarray:
    with sync_point():
        return t.cpu().numpy()


def unpack(det: Detections) -> List[FrameDetections]:
    """The valid detections of each frame of a batch (:func:`decode_batch`'s
    output), on the host: each field is copied to the host once, then
    split into frames there."""
    boxes, scores, valid, classes = (_to_host(f) for f in det)
    return [FrameDetections(boxes=boxes[b][v], scores=scores[b][v],
                            classes=classes[b][v])
            for b, v in enumerate(valid)]
