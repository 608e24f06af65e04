"""Detection loss: the mask-based form of the reference's ``VoxelLoss``.

Port of ``mvxnet_makise_tpu/train/loss.py``.  For one frame:

* positive term: sum of ``-log(score + eps)`` over positive anchors over
  ``num_pos + eps``, weight ``pos_weight``;
* negative term: sum of ``-log(1 - score + eps)`` over the anchors outside
  the ignore set (IoU >= neg threshold, a superset of the positives) over
  ``total - num_not_neg + eps``, weight ``neg_weight``; a frame with no GT
  reduces to the mean over all anchors;
* ``mode="focal"``: sigmoid focal loss with both terms over
  ``max(num_pos, 1)``;
* regression: smooth-L1 between the predicted deltas and the encoded
  GT-vs-anchor targets over ``num_pos * 7`` elements, 0 without positives.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mvxnet_makise_tpu_torch.geometry.boxes import encode_boxes
from mvxnet_makise_tpu_torch.ops.assign import AnchorTargets


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (torch SmoothL1Loss semantics)."""
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def voxel_loss(score: torch.Tensor,
               reg: torch.Tensor,
               targets: AnchorTargets,
               gt_boxes: torch.Tensor,
               anchors: torch.Tensor,
               *,
               pos_weight: float = 1.5,
               neg_weight: float = 1.0,
               eps: float = 1e-6,
               mode: str = "reference",
               focal_gamma: float = 2.0,
               focal_alpha: float = 0.25,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-frame detection loss.

    Args:
      score: (H, W, A) sigmoid scores; reg: (H, W, A * 7).
      targets: dense assignment masks for this frame.
      gt_boxes: (G, 7) padded GT boxes (rows indexed by targets.gt_index).
      anchors: (H, W, A, 7) anchor boxes.

    Returns (total loss, metrics: cls_loss, reg_loss, num_pos,
    num_not_neg).
    """
    H, W, A = score.shape
    pos = targets.pos
    not_neg = targets.ignore
    zero = score.new_zeros(())

    num_pos = pos.sum()
    num_not_neg = not_neg.sum()
    total = H * W * A
    # counts in the maps' dtype: an integer tensor plus a Python float
    # would be float32 in PyTorch
    n_pos = num_pos.to(score.dtype)
    n_not_neg = num_not_neg.to(score.dtype)

    pos_nll = -torch.log(score + eps)
    neg_nll = -torch.log(1.0 - score + eps)

    if mode == "focal":
        pos_focal = focal_alpha * (1.0 - score) ** focal_gamma * pos_nll
        neg_focal = (1.0 - focal_alpha) * score ** focal_gamma * neg_nll
        denom = torch.clamp(n_pos, min=1.0)
        pos_loss = torch.where(pos, pos_focal, zero).sum() / denom
        neg_loss = torch.where(not_neg, zero, neg_focal).sum() / denom
    elif mode == "reference":
        pos_loss = torch.where(pos, pos_nll, zero).sum() / (n_pos + eps)
        neg_loss = torch.where(not_neg, zero, neg_nll).sum() / (
            total - n_not_neg + eps)
    else:
        raise ValueError(f"unknown cls_loss_mode {mode!r}")
    cls_loss = pos_weight * pos_loss + neg_weight * neg_loss

    reg = reg.reshape(H, W, A, -1)
    gi = torch.clamp(targets.gt_index, 0, gt_boxes.shape[0] - 1).long()
    deltas = encode_boxes(gt_boxes[gi], anchors)            # (H, W, A, 7)
    per_elem = smooth_l1(reg, deltas)
    reg_loss = torch.where(pos[..., None], per_elem, zero).sum() / (
        torch.clamp(n_pos, min=1.0) * deltas.shape[-1])
    reg_loss = torch.where(num_pos > 0, reg_loss, zero)

    metrics = {"cls_loss": cls_loss, "reg_loss": reg_loss,
               "num_pos": num_pos, "num_not_neg": num_not_neg}
    return cls_loss + reg_loss, metrics
