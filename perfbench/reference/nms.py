"""The detections a frame's maps give: the reference's decode, then plain
greedy rotated bird's-eye-view non-maximum suppression.

- Candidates: the ``pre_max_size`` highest scores, ties to the lower
  anchor index, of which those above ``score_threshold`` stay.
- Greedy: in score order, a candidate is kept where its IoU
  (:func:`perfbench.reference.train.iou_bev`, float64) with every box kept
  before it is at most ``nms_iou_threshold``; the first
  ``post_max_size`` kept are the frame's detections.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference import model as R
from perfbench.reference.train import iou_bev


def nms(boxes: torch.Tensor, scores: torch.Tensor, post: Dict) -> torch.Tensor:
    """Indices of the kept boxes, in score order.  boxes (N, 7), scores
    (N,); ``post``: score_threshold, nms_iou_threshold, pre_max_size,
    post_max_size."""
    order = torch.sort(scores, descending=True,
                       stable=True).indices[:post["pre_max_size"]]
    order = order[scores[order] > post["score_threshold"]]
    iou = iou_bev(boxes[order], boxes[order]).cpu().numpy()
    kept = []
    for i in range(len(order)):
        if len(kept) == post["post_max_size"]:
            break
        if all(iou[j, i] <= post["nms_iou_threshold"] for j in kept):
            kept.append(i)
    return order[torch.as_tensor(kept, dtype=torch.long,
                                 device=order.device)]


def detections(score: torch.Tensor, reg: torch.Tensor,
               anchors: torch.Tensor, post: Dict
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (K, 7), scores (K,)) of one frame's maps: score (H, W, A),
    reg (H, W, A*7), anchors (H, W, A, 7)."""
    s = score.reshape(-1).float()
    b = R.decode(reg.reshape(*anchors.shape[:3], 7).float(),
                 anchors).reshape(-1, 7)
    keep = nms(b, s, post)
    return b[keep], s[keep]
