"""KITTI-style 3D average precision (port of
``mvxnet_makise_tpu/eval/ap.py``).

Greedy matching of detections (score-descending) to GTs at a 3D IoU
threshold (0.7 for Car), R40 interpolated AP (mean of the maximum
precision at recalls 1/40 .. 1; R11 with ``num_recall_points=11``), and
ignored GTs for the easy/moderate/hard buckets.  Host-side numpy; the IoU
is :func:`geometry.boxes.rotated_iou_3d` on the CPU in the boxes' own
dtype (float32 from the decoder, as the JAX evaluator computes it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mvxnet_makise_tpu_torch.geometry.boxes import rotated_iou_3d


def _match_frame(det_boxes: np.ndarray, det_scores: np.ndarray,
                 gt_boxes: np.ndarray, iou_threshold: float,
                 gt_ignored: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy per-frame matching (KITTI protocol).

    ``gt_ignored`` marks GTs outside the current difficulty bucket: a
    detection matching an ignored GT counts as neither TP nor FP.
    Returns (tp flags, counted flags) per det sorted by score desc, and
    the number of non-ignored GTs.
    """
    order = np.argsort(-det_scores)
    det_boxes = det_boxes[order]
    n_det, n_gt = len(det_boxes), len(gt_boxes)
    if gt_ignored is None:
        gt_ignored = np.zeros(n_gt, dtype=bool)
    tp = np.zeros(n_det, dtype=bool)
    counted = np.ones(n_det, dtype=bool)
    num_gt = int((~gt_ignored).sum())
    if n_det == 0 or n_gt == 0:
        return tp, counted, num_gt
    iou = rotated_iou_3d(torch.from_numpy(np.ascontiguousarray(det_boxes)),
                         torch.from_numpy(np.ascontiguousarray(gt_boxes))
                         ).numpy()
    taken = np.zeros(n_gt, dtype=bool)
    for i in range(n_det):
        # prefer a non-ignored match
        cand = np.where(taken | gt_ignored, -1.0, iou[i])
        j = int(np.argmax(cand))
        if cand[j] >= iou_threshold:
            tp[i] = True
            taken[j] = True
            continue
        # overlap only with an ignored GT: drop from the statistics
        cand_ign = np.where(taken | ~gt_ignored, -1.0, iou[i])
        k = int(np.argmax(cand_ign))
        if cand_ign[k] >= iou_threshold:
            counted[i] = False
            taken[k] = True
    return tp, counted, num_gt


def average_precision_3d(detections: Sequence[Tuple[np.ndarray, np.ndarray]],
                         ground_truths: Sequence[np.ndarray],
                         iou_threshold: float = 0.7,
                         num_recall_points: int = 40,
                         gt_ignored: Optional[Sequence[np.ndarray]] = None,
                         ) -> Dict[str, float]:
    """AP over a set of frames.

    Args:
      detections: per frame (boxes (D, 7), scores (D,)).
      ground_truths: per frame GT boxes (G, 7).
      gt_ignored: optional per-frame bool masks — GTs outside the current
        difficulty bucket (matched dets count as neither TP nor FP).

    Returns dict with 'ap' (R40 by default), 'precision', 'recall' at the
    operating point, 'num_gt', 'num_det'.
    """
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    total_gt = 0
    for fi, ((boxes, scores), gts) in enumerate(
            zip(detections, ground_truths)):
        ign = gt_ignored[fi] if gt_ignored is not None else None
        tp, counted, n_gt = _match_frame(boxes, scores, gts,
                                         iou_threshold, ign)
        total_gt += n_gt
        all_tp.append(tp[counted])
        all_scores.append(np.sort(scores)[::-1][:len(tp)][counted])

    if total_gt == 0:
        return {"ap": 0.0, "precision": 0.0, "recall": 0.0,
                "num_gt": 0, "num_det": 0}

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    order = np.argsort(-scores)
    tps = tps[order]

    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(~tps)
    recall = cum_tp / total_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)

    # interpolated AP at num_recall_points samples (KITTI R40: 1/40..1)
    ap = 0.0
    for r in np.linspace(1.0 / num_recall_points, 1.0, num_recall_points):
        prec_at = precision[recall >= r]
        ap += (prec_at.max() if len(prec_at) else 0.0)
    ap /= num_recall_points

    return {
        "ap": float(ap),
        "precision": float(precision[-1]) if len(precision) else 0.0,
        "recall": float(recall[-1]) if len(recall) else 0.0,
        "num_gt": int(total_gt),
        "num_det": int(len(tps)),
    }


def evaluate_frames(decoded, gt_boxes: np.ndarray, gt_mask: np.ndarray,
                    iou_threshold: float = 0.7,
                    num_recall_points: int = 40) -> Dict[str, float]:
    """AP over per-frame ``Detections`` (a sequence, as the port's
    decoder returns them) and padded GT arrays: gt_boxes (B, G, 7),
    gt_mask (B, G)."""
    def host(x):
        return torch.as_tensor(x).cpu().numpy()

    dets, gts = [], []
    for b, d in enumerate(decoded):
        v = host(d.valid)
        dets.append((host(d.boxes)[v], host(d.scores)[v]))
        gts.append(host(gt_boxes[b])[host(gt_mask[b])])
    return average_precision_3d(dets, gts, iou_threshold, num_recall_points)
