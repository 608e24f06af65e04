"""The training loop: host prep -> device step -> per-epoch checkpoints.

Port of ``mvxnet_makise_tpu/train/loop.py`` without augmentation and
eval (the GT-paste augmenter and the evaluator come with the host-data
slice): epoch shuffle, running average/max of the losses every
``log_every`` iterations, a checkpoint per epoch with ``keep_last``
pruning, resume from an epoch, and a wall-clock budget.  Each batch's
voxelizer shuffle is a permutation drawn from the loop's own
``torch.Generator`` (seeded with ``cfg.seed``).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.device import (
    DeviceLike,
    resolve_device,
    use_full_f32,
)
from mvxnet_makise_tpu_torch.geometry.calib import Calib, lidar_to_image
from mvxnet_makise_tpu_torch.models.mvxnet import MVXNetPM, build_model
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    make_train_step,
)
from mvxnet_makise_tpu_torch.utils.metrics import LossTracker, PhaseTimer


class Frame(NamedTuple):
    """One training frame on the host."""
    frame_id: str
    points: np.ndarray               # (N, 4) x y z reflectance, LiDAR frame
    image: Optional[np.ndarray]      # (H, W, 3) float in [0, 1], or None
    calib: Calib
    boxes: Dict[str, np.ndarray]     # class name -> (G, 7) xyzlwhr


class TrainArrays(NamedTuple):
    """One frame, projected and padded to the config's capacities."""
    points: np.ndarray      # (max_points, 6) [x y z refl row col]
    num_points: int
    image: np.ndarray       # (H, W, 3)
    gt_boxes: np.ndarray    # (max_boxes, 7)
    gt_mask: np.ndarray     # (max_boxes,) bool
    gt_classes: np.ndarray  # (max_boxes,) int32


def preprocess_train_frame(frame: Frame, cfg: Config,
                           rng: np.random.Generator) -> TrainArrays:
    """Project every point to the image, shuffle with ``rng``, pad to
    ``max_points``; gather the target classes' boxes, padded to
    ``max_boxes``.  Voxelization and assignment happen on the device."""
    uv = lidar_to_image(frame.points, frame.calib, keep_all=True)
    cloud = np.concatenate([frame.points[:, :4], uv[:, 1:2], uv[:, 0:1]],
                           axis=1).astype(np.float32)
    rng.shuffle(cloud, axis=0)
    n = min(len(cloud), cfg.max_points)
    pts = np.zeros((cfg.max_points, 6), dtype=np.float32)
    pts[:n] = cloud[:n]

    all_boxes, all_cls = [], []
    for ci, c in enumerate(cfg.target_classes):
        if c in frame.boxes and len(frame.boxes[c]):
            all_boxes.append(frame.boxes[c])
            all_cls.append(np.full(len(frame.boxes[c]), ci, np.int32))
    gt = np.zeros((cfg.max_boxes, 7), np.float32)
    gcls = np.zeros((cfg.max_boxes,), np.int32)
    gmask = np.zeros((cfg.max_boxes,), bool)
    if all_boxes:
        cat = np.concatenate(all_boxes, axis=0)[:cfg.max_boxes]
        gt[:len(cat)] = cat
        gcls[:len(cat)] = np.concatenate(all_cls, axis=0)[:cfg.max_boxes]
        gmask[:len(cat)] = True

    img = frame.image if frame.image is not None else np.zeros(
        (*cfg.image_size, 3), np.float32)
    return TrainArrays(points=pts, num_points=n,
                       image=np.asarray(img, np.float32), gt_boxes=gt,
                       gt_mask=gmask, gt_classes=gcls)


def build_model_and_state(cfg: Config, device: DeviceLike = None,
                          seed: int = 0) -> Tuple[MVXNetPM, TrainState]:
    """The detector ``cfg`` describes, with random weights from ``seed``,
    in train mode on ``device`` (default: the CUDA card), and a fresh
    :class:`TrainState`."""
    model = build_model(cfg, seed=seed, device=device).train()
    return model, TrainState.create(cfg, model)


def make_full_train_step(cfg: Config, anchors: torch.Tensor):
    """Voxelize + assign + forward + loss + backward + update:
    ``step(state, points, num_points, images, gt_boxes, gt_mask,
    gt_classes, perm)`` on tensors of the model's device; returns the
    metrics."""
    inner = make_train_step(cfg, anchors)

    def step(state: TrainState, points, num_points, images, gt_boxes,
             gt_mask, gt_classes, perm):
        batch = frames_to_batch(points, num_points, images, cfg,
                                gt_boxes=gt_boxes, gt_mask=gt_mask,
                                gt_classes=gt_classes, perm=perm)
        return inner(state, batch)

    return step


def collate(arrays: Sequence[TrainArrays], device: torch.device):
    """Stack frames into the step's tensors (points, num_points, images,
    gt_boxes, gt_mask, gt_classes) on ``device``."""
    def stack(name):
        return torch.from_numpy(np.stack(
            [getattr(a, name) for a in arrays])).to(device)
    return tuple(stack(n) for n in ("points", "num_points", "image",
                                    "gt_boxes", "gt_mask", "gt_classes"))


def _flush_metrics(tracker: LossTracker, pending: List[dict]) -> None:
    """Move the queued step metrics to the tracker with one read-back."""
    if not pending:
        return
    keys = list(pending[0])
    values = torch.stack([torch.stack([m[k].detach().double().cpu()
                                       for k in keys]) for m in pending])
    for row in values.tolist():
        tracker.update(dict(zip(keys, row)))
    pending.clear()


def train(cfg: Config,
          frames: Sequence[Frame],
          *,
          resume_epoch: int = 0,
          num_epochs: Optional[int] = None,
          log_every: int = 50,
          time_budget_s: Optional[float] = None,
          device: DeviceLike = None,
          seed: int = 0) -> TrainState:
    """Train on in-RAM frames for ``num_epochs`` (default
    ``cfg.num_epochs``) after ``resume_epoch``; returns the final state.

    Random weights come from ``seed``; with ``resume_epoch`` > 0 the
    model, optimizer and step count are restored from that epoch's
    checkpoint in ``cfg.checkpoint_dir``.  ``time_budget_s``: stop after
    the last fully checkpointed epoch once the wall-clock budget is spent.
    On the card, float32 runs in full float32 (TF32 off, process-wide,
    ``device.use_full_f32``)."""
    t_start = time.monotonic()
    num_epochs = num_epochs or cfg.num_epochs
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_full_f32()
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(dev)
    _, state = build_model_and_state(cfg, device=dev, seed=seed)
    if resume_epoch > 0:
        ckpt.restore_checkpoint(cfg.checkpoint_dir, resume_epoch, state)

    step = make_full_train_step(cfg, anchors)
    timer = PhaseTimer()
    shuffle = torch.Generator().manual_seed(cfg.seed)
    frames = list(frames)
    B = cfg.batch_size

    for epoch in range(resume_epoch, resume_epoch + num_epochs):
        random.Random(cfg.seed + epoch).shuffle(frames)
        tracker = LossTracker()
        pending: List[dict] = []
        it = 0
        for start in range(0, len(frames) - B + 1, B):
            with timer.phase("host_prep"):
                # a private generator per frame keeps the feed
                # deterministic whatever the batching
                arrays = [preprocess_train_frame(
                    fr, cfg, np.random.default_rng(
                        np.random.SeedSequence([cfg.seed, epoch, idx])))
                    for idx, fr in enumerate(frames[start:start + B],
                                             start=start)]
                tensors = collate(arrays, dev)
                perm = torch.stack([torch.randperm(cfg.max_points,
                                                   generator=shuffle)
                                    for _ in range(B)]).to(dev)
            with timer.phase("device_step"):
                pending.append(step(state, *tensors, perm))
            it += 1
            if it % log_every == 0:
                _flush_metrics(tracker, pending)
                print(f"epoch {epoch + 1} it {it}: "
                      f"avg cls {tracker.average('cls_loss'):.6f} "
                      f"avg reg {tracker.average('reg_loss'):.6f} "
                      f"max cls {tracker.maximum('cls_loss'):.6f} "
                      f"max reg {tracker.maximum('reg_loss'):.6f}")
        _flush_metrics(tracker, pending)

        with timer.phase("device_wait"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with timer.phase("checkpoint"):
            ckpt.save_checkpoint(cfg.checkpoint_dir, epoch + 1, state)
            if cfg.checkpoint_keep_last:
                ckpt.prune_checkpoints(cfg.checkpoint_dir,
                                       cfg.checkpoint_keep_last)
        print(f"epoch {epoch + 1} done | step {state.step} | "
              f"avg total {tracker.average('total_loss'):.6f} | "
              f"{timer.report()}")
        if time_budget_s is not None \
                and time.monotonic() - t_start > time_budget_s:
            print(f"time budget ({time_budget_s:.0f}s) spent: stopping "
                  f"after epoch {epoch + 1} (resume with -r {epoch + 1})")
            break
    return state
