"""Rotated BEV non-maximum suppression on tensors.

Port of ``mvxnet_makise_tpu/ops/nms.py``: take the top-K boxes by score,
compute their K x K rotated IoU once, then run greedy NMS as a fixpoint
sweep over a K-long keep mask.  :func:`rotated_nms_bev_batch` does this for
a batch of frames at once, as JAX's NMS does under ``jax.vmap``;
:func:`rotated_nms_bev` is its one-frame case.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvxnet_makise_tpu_torch.geometry.boxes import rotated_iou_bev
from mvxnet_makise_tpu_torch.utils.profiling import sync_point

# sweeps between convergence checks: sweeps past the fixpoint change
# nothing, so checking less often only saves host synchronisations
_SWEEPS_PER_CHECK = 4


def rotated_nms_bev_batch(boxes: torch.Tensor,
                          scores: torch.Tensor,
                          *,
                          iou_threshold: float = 0.1,
                          score_threshold: float = 0.0,
                          pre_max_size: int = 256,
                          post_max_size: int = 64,
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Greedy rotated NMS of each row.  boxes (B, N, 7), scores (B, N).

    Returns (indices (B, post_max_size) into each row, scores, valid
    bool), padded with index 0 / score 0 where invalid.  Ties in score
    keep the lower index first, as ``jax.lax.top_k`` does: the top-K
    selection is a stable descending sort.  One (B, K, K) IoU serves the
    whole batch, and the fixpoint is checked once per
    ``_SWEEPS_PER_CHECK`` sweeps for all rows together: a row that has
    settled stays as it is while the others go on.
    """
    B, N = scores.shape
    K = min(pre_max_size, N)
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
    top_scores, top_idx = sorted_scores[:, :K], order[:, :K]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(B, K, 7))
    alive = top_scores > score_threshold

    iou = rotated_iou_bev(top_boxes, top_boxes)              # (B, K, K)
    ar = torch.arange(K, device=boxes.device)
    sup = (iou > iou_threshold) & (ar[:, None] < ar[None, :])  # j by i

    # keep[i] <- alive[i] and no kept higher-scored box overlaps it.  The
    # update is antitone in keep; iterating from all-alive settles on the
    # greedy solution within K sweeps (entry i is final after i+1).
    keep = alive
    for _ in range(0, K + 1, _SWEEPS_PER_CHECK):
        for _ in range(_SWEEPS_PER_CHECK):
            prev = keep
            keep = alive & ~(sup & keep[..., :, None]).any(dim=-2)
        with sync_point():
            settled = torch.equal(keep, prev)
        if settled:
            break

    # compact kept indices to the front of each row (stable), cap at
    # post_max_size
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    sel = order[:, :post_max_size]
    valid = torch.gather(keep, 1, sel)
    out_idx = torch.where(valid, torch.gather(top_idx, 1, sel),
                          torch.zeros_like(sel))
    sel_scores = torch.gather(top_scores, 1, sel)
    out_scores = torch.where(valid, sel_scores, torch.zeros_like(sel_scores))
    return out_idx, out_scores, valid


def rotated_nms_bev(boxes: torch.Tensor,
                    scores: torch.Tensor,
                    *,
                    iou_threshold: float = 0.1,
                    score_threshold: float = 0.0,
                    pre_max_size: int = 256,
                    post_max_size: int = 64,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS of one frame.  boxes (N, 7), scores (N,).

    The one-row case of :func:`rotated_nms_bev_batch`: (indices
    (post_max_size,) into the input, scores, valid bool)."""
    idx, out_scores, valid = rotated_nms_bev_batch(
        boxes[None], scores[None], iou_threshold=iou_threshold,
        score_threshold=score_threshold, pre_max_size=pre_max_size,
        post_max_size=post_max_size)
    return idx[0], out_scores[0], valid[0]
