"""Evaluation runner: frames + model -> per-class difficulty-binned AP
(port of ``mvxnet_makise_tpu/eval/runner.py``).

Shared by ``tools.evaluate`` and the training loop's periodic validation.
The model is the fused detector or, with ``with_images=False``, the
LiDAR-only one; under ``cfg.use_bf16`` it runs on bfloat16 copies of its
parameters, cast once per call (``train/state.cast_for_compute``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.device import (
    parameter_dtype,
    use_deterministic_convolutions,
    use_full_f32,
)
from mvxnet_makise_tpu_torch.eval.ap import average_precision_3d
from mvxnet_makise_tpu_torch.eval.decode import (
    FrameDetections,
    decode_batch,
    unpack,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train.state import cast_for_compute
from mvxnet_makise_tpu_torch.train.step import forward, frames_to_batch


@torch.no_grad()
def detect_for_eval(cfg: Config, frames: Sequence[KittiFrame],
                    model: torch.nn.Module, score_threshold: float = 0.05,
                    batch_size: int = 4, with_images: bool = True
                    ) -> List[FrameDetections]:
    """Detections of every frame, on the host, as the evaluator sees them.

    The model runs in eval mode without gradients on its own device and
    dtype (it is put back in train mode if it was there), on the card
    under ``device.use_full_f32`` and ``device.use_deterministic_convolutions``
    (the latter restored afterwards), so the same weights give the same
    detections in the training loop and in ``tools.evaluate``.  Host prep
    is the training loop's without augmentation, from one
    ``default_rng(0)`` over the frames in order; the tail is padded to the
    batch with copies of the last frame."""
    from mvxnet_makise_tpu_torch.train.loop import preprocess_train_frame

    dev = next(model.parameters()).device
    dtype = parameter_dtype(model)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(dev)
    was_training = model.training
    deterministic = torch.backends.cudnn.deterministic
    if dev.type == "cuda":
        use_full_f32()
        use_deterministic_convolutions()
    model.eval()
    tensors = cast_for_compute(model, cfg.use_bf16, with_images)
    rng = np.random.default_rng(0)
    out: List[FrameDetections] = []
    try:
        for i in range(0, len(frames), batch_size):
            chunk = list(frames[i:i + batch_size])
            real = len(chunk)
            chunk += [chunk[-1]] * (batch_size - real)
            arrays = [preprocess_train_frame(f, cfg, None, rng)
                      for f in chunk]
            pts = torch.from_numpy(np.stack([a.points for a in arrays]))
            nps = torch.tensor([a.num_points for a in arrays])
            imgs = torch.from_numpy(np.stack([a.image for a in arrays]))
            batch = frames_to_batch(pts.to(dev, dtype), nps.to(dev),
                                    imgs.to(dev, dtype), cfg)
            score, reg = forward(model, batch, cfg, with_images, tensors)
            out += unpack(decode_batch(
                score[:real].float(), reg[:real].float(), anchors,
                score_threshold=score_threshold))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        model.train(was_training)
    return out


def run_eval(cfg: Config, frames: Sequence[KittiFrame],
             model: torch.nn.Module, score_threshold: float = 0.05,
             batch_size: int = 4, iou_threshold: Optional[float] = None,
             with_images: bool = True) -> Dict[str, Dict[str, dict]]:
    """AP of ``model`` on ``frames``: {class: {"all", "easy", "moderate",
    "hard": average_precision_3d's dict}}.

    ``score_threshold`` is low on purpose: AP integrates the precision /
    recall curve over the whole score ranking, so evaluating at a serving
    threshold (0.3) truncates the curve and reports AP=0 for a model whose
    scores sit below it.  The IoU threshold is KITTI's per class (Car 0.7,
    others 0.5) unless ``iou_threshold`` is given."""
    detections = detect_for_eval(cfg, frames, model, score_threshold,
                                 batch_size, with_images)
    n_cls = cfg.num_classes
    dets = {c: [] for c in range(n_cls)}
    gts = {c: [] for c in range(n_cls)}
    difficulties = {c: [] for c in range(n_cls)}
    for frame, det in zip(frames, detections):
        for ci, cname in enumerate(cfg.target_classes):
            sel = det.classes == ci
            dets[ci].append((det.boxes[sel], det.scores[sel]))
            g = frame.boxes.get(cname)
            gts[ci].append(np.asarray(g, np.float32) if g is not None
                           and len(g) else np.zeros((0, 7), np.float32))
            d = frame.difficulty.get(cname)
            # a box without a difficulty counts as moderate
            difficulties[ci].append(
                np.asarray(d, np.int32) if d is not None
                and len(gts[ci][-1]) == len(d)
                else np.full(len(gts[ci][-1]), 1, np.int32))

    results = {}
    buckets = {"easy": 0, "moderate": 1, "hard": 2}
    for ci, cname in enumerate(cfg.target_classes):
        thr = iou_threshold if iou_threshold is not None \
            else (0.7 if cname == "Car" else 0.5)
        out = {"all": average_precision_3d(dets[ci], gts[ci],
                                           iou_threshold=thr)}
        for bname, dmax in buckets.items():
            ignored = [~((d >= 0) & (d <= dmax)) for d in difficulties[ci]]
            out[bname] = average_precision_3d(
                dets[ci], gts[ci], iou_threshold=thr, gt_ignored=ignored)
        results[cname] = out
    return results
