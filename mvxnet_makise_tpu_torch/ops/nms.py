"""Rotated BEV non-maximum suppression on tensors.

Port of ``mvxnet_makise_tpu/ops/nms.py``: take the top-K boxes by score,
compute their K x K rotated IoU once, then run greedy NMS as a fixpoint
sweep over a K-long keep mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvxnet_makise_tpu_torch.geometry.boxes import rotated_iou_bev

# sweeps between convergence checks: sweeps past the fixpoint change
# nothing, so checking less often only saves host synchronisations
_SWEEPS_PER_CHECK = 4


def rotated_nms_bev(boxes: torch.Tensor,
                    scores: torch.Tensor,
                    *,
                    iou_threshold: float = 0.1,
                    score_threshold: float = 0.0,
                    pre_max_size: int = 256,
                    post_max_size: int = 64,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS.  boxes (N, 7), scores (N,).

    Returns (indices (post_max_size,) into the input, scores, valid bool),
    padded with index 0 / score 0 where invalid.  Ties in score keep the
    lower index first, as ``jax.lax.top_k`` does: the top-K selection is a
    stable descending sort.
    """
    N = boxes.shape[0]
    K = min(pre_max_size, N)
    sorted_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:K], order[:K]
    top_boxes = boxes[top_idx]
    alive = top_scores > score_threshold

    iou = rotated_iou_bev(top_boxes, top_boxes)              # (K, K)
    ar = torch.arange(K, device=boxes.device)
    sup = (iou > iou_threshold) & (ar[:, None] < ar[None, :])  # j by i

    # keep[i] <- alive[i] and no kept higher-scored box overlaps it.  The
    # update is antitone in keep; iterating from all-alive settles on the
    # greedy solution within K sweeps (entry i is final after i+1).
    keep = alive
    for _ in range(0, K + 1, _SWEEPS_PER_CHECK):
        for _ in range(_SWEEPS_PER_CHECK):
            prev = keep
            keep = alive & ~(sup & keep[:, None]).any(dim=0)
        if bool(torch.equal(keep, prev)):
            break

    # compact kept indices to the front (stable), cap at post_max_size
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    sel = order[:post_max_size]
    valid = keep[sel]
    out_idx = torch.where(valid, top_idx[sel], torch.zeros_like(sel))
    out_scores = torch.where(valid, top_scores[sel],
                             torch.zeros_like(top_scores[sel]))
    return out_idx, out_scores, valid
