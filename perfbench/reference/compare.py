"""The numbers that decide ``correct``, each held against its limit.

Serving (the program's detections against the reference's maps of the
same frame):
- ``det_gap``, ``det_gap_p90``, ``det_gap_p50``: for each served
  detection, the distance to the nearest of
  the reference's decoded anchors, where the distance is the larger of the
  score's gap and the box's (each of the 7 values' gap over the larger of
  1 and the reference value); the largest, the 90th and the 50th
  percentile over the detections of the sampled frames.  A
  detection is served from one anchor's prediction, so the nearest anchor
  is its own unless the program computed it wrongly; which anchors the
  rotated NMS keeps may flip on a rounding, and this number does not
  care.
- ``top_gap``: the gap between the frame's highest served score and the
  reference's highest score (0 where it is under the score threshold, as
  where nothing is served); the largest over the sampled frames.  The
  top score is continuous in the maps, and a frame served without its
  detections reads the whole score.
- ``nms_unmatched``: the share of boxes, of the served detections and of
  the reference's own (its decode and rotated NMS of the frame,
  :mod:`perfbench.reference.nms`), that have no partner in the other set
  of the same frame, a partner overlapping at a bird's-eye-view IoU of
  0.5 or more; over the sampled frames.  An NMS that keeps too few boxes
  leaves reference boxes alone, one that keeps too many served boxes.
- ``nms_overlap``: the largest IoU between two served boxes of one frame:
  NMS leaves none above its IoU threshold, a duplicate reads far above.

Training (the program's first three steps against the reference's three
steps from the same weights on the same batches):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: for each leaf, the gap between the norms of the program's
  first gradient (AdamW's first moment after one step, over 1 - beta1)
  and the reference's, over the larger of the reference leaf's norm and
  the median leaf's; the worst leaf;
- ``update_gap``: the same for the change of each leaf after the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (AdamW moves those by round-off alone).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import model as R
from perfbench.reference import nms as ref_nms
from perfbench.reference.train import iou_bev

# the IoU at which a served box and a reference box are one detection
PARTNER_IOU = 0.5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding for a float32 configuration: each operand's
    mantissa rounded to TF32's 10 bits (to nearest, ties to even), which
    is what a tensor core multiplies in TF32 mode."""
    xi = x.detach().float().contiguous().view(torch.int32)
    r = (xi + (((xi >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    y = r.view(torch.float32).to(x.dtype)
    return x + (y - x).detach() if x.requires_grad else y


def control_rounding(dtype: torch.dtype):
    """The nearest precision below the one the configuration computes in:
    float8 for bfloat16, TF32 for float32 with TF32 off."""
    return fp8 if dtype == torch.bfloat16 else tf32


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: to float8 e4m3 with one scale per tensor,
    and back."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach() if x.requires_grad else y


def det_gaps(boxes: np.ndarray, scores: np.ndarray, ref_score: torch.Tensor,
             ref_boxes: torch.Tensor) -> List[float]:
    """Each served detection's distance to the nearest reference anchor.
    ref_score (N,), ref_boxes (N, 7) on the reference's device."""
    dev = ref_score.device
    b = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    scale = ref_boxes.abs().clamp(min=1.0)
    out = []
    for i in range(len(s)):
        gap = torch.maximum((ref_score - s[i]).abs(),
                            ((ref_boxes - b[i]).abs() / scale).amax(dim=1))
        out.append(float(gap.min()))
    return out


def top_gap(scores: np.ndarray, ref_score: torch.Tensor,
            threshold: float) -> float:
    served = float(scores.max()) if len(scores) else 0.0
    ref = float(ref_score.max())
    ref = ref if ref >= threshold else 0.0
    return abs(served - ref)


def nms_gaps(boxes: np.ndarray, ref_boxes: torch.Tensor):
    """(boxes without a partner, boxes of both sets, the largest IoU
    between two served boxes) of one frame."""
    b = torch.as_tensor(boxes, dtype=torch.float32, device=ref_boxes.device)
    alone = len(b) + len(ref_boxes)
    if len(b) and len(ref_boxes):
        pair = iou_bev(b, ref_boxes) >= PARTNER_IOU
        alone = int((~pair.any(1)).sum()) + int((~pair.any(0)).sum())
    overlap = 0.0
    if len(b) > 1:
        iou = iou_bev(b, b)
        iou.fill_diagonal_(0.0)
        overlap = float(iou.max())
    return alone, len(b) + len(ref_boxes), overlap


def serve_numbers(served: Sequence, ref_maps: Sequence, anchors: torch.Tensor,
                  post: Dict) -> Dict[str, float]:
    """served: (boxes (K, 7), scores (K,)) per frame; ref_maps: (score
    (H, W, A), reg (H, W, A*7)) per frame; ``post``: the decode's score
    threshold and NMS settings (:func:`perfbench.reference.nms.nms`)."""
    gaps, top, alone, count, overlap = [], 0.0, 0, 0, 0.0
    n_served = n_ref = 0
    for (boxes, scores), (score, reg) in zip(served, ref_maps):
        rs = score.reshape(-1).float()
        rb = R.decode(reg.reshape(*anchors.shape[:3], 7).float(),
                      anchors).reshape(-1, 7)
        gaps += det_gaps(boxes, scores, rs, rb)
        top = max(top, top_gap(scores, rs, post["score_threshold"]))
        kept = rb[ref_nms.nms(rb, rs, post)]
        a, c, o = nms_gaps(boxes, kept)
        alone, count, overlap = alone + a, count + c, max(overlap, o)
        n_served, n_ref = n_served + len(boxes), n_ref + len(kept)
    gaps = gaps or [0.0]
    return {"det_gap": max(gaps),
            "det_gap_p90": float(np.quantile(gaps, 0.9)),
            "det_gap_p50": float(np.quantile(gaps, 0.5)),
            "top_gap": top,
            "nms_unmatched": alone / max(count, 1),
            "nms_overlap": overlap,
            "served_boxes": n_served, "reference_boxes": n_ref}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys: List[str]) -> Dict[str, float]:
    median = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def train_numbers(prog_losses: Sequence[float], ref_losses: Sequence[float],
                  prog_grad: Dict[str, float], ref_grad: Dict[str, float],
                  prog_change: Dict[str, float],
                  ref_change: Dict[str, float]) -> Dict[str, float]:
    """Each dict maps a leaf to its norm."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog_losses, ref_losses)]
    keys = sorted(ref_grad)
    gmed = float(np.median([ref_grad[k] for k in keys]))
    moved = [k for k in keys if ref_grad[k] >= 1e-3 * gmed]
    grad = _leaf_gaps(prog_grad, ref_grad, keys)
    upd = _leaf_gaps(prog_change, ref_change, moved)
    worst_g = max(grad, key=grad.get)
    worst_u = max(upd, key=upd.get)
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": grad[worst_g],
            "update_gap": upd[worst_u],
            "update_gap_p50": float(np.median(list(upd.values()))),
            "grad_gap_leaf": worst_g, "update_gap_leaf": worst_u,
            "losses": list(prog_losses), "ref_losses": list(ref_losses)}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, rows): each number the cell holds (its limits file names
    it) beside its limit; a cell without limits holds every number, and
    a number without a limit, or not finite, is not correct."""
    rows = []
    ok = True
    for name in (limits or [k for k, v in numbers.items()
                            if isinstance(v, float)]):
        value = numbers.get(name, float("nan"))
        limit = limits.get(name)
        good = (limit is not None and np.isfinite(value)
                and value <= limit)
        ok &= bool(good)
        rows.append({"name": name, "value": value, "limit": limit})
    return ok, rows
