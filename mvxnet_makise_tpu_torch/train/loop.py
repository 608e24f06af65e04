"""The training loop: host prep -> device step -> per-epoch checkpoints
and validation.

Port of ``mvxnet_makise_tpu/train/loop.py``: epoch shuffle, GT-paste
augmentation (``data/augment``) when a GT database is given, running
average/max of the losses every ``log_every`` iterations, a checkpoint per
epoch with ``keep_last`` pruning, AP on held-out frames every
``eval_every`` epochs (``eval/runner``), resume from an epoch, and a
wall-clock budget.  Host prep runs in a thread pool of ``workers``, a
bounded number of frames ahead of the device, each frame with its own
``np.random.Generator`` (seeded with the seed, the epoch and its place in
the epoch), so the feed is the same for any number of workers.  Each
batch's voxelizer shuffle is a permutation drawn from the loop's own
``torch.Generator`` (seeded with ``cfg.seed``).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import random
import time
from typing import (
    Iterable,
    Iterator,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch
from torch import nn

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.augment import (
    SceneAugmenter,
    assemble_augmented_cloud,
)
from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
from mvxnet_makise_tpu_torch.device import (
    DeviceLike,
    resolve_device,
    use_full_f32,
)
from mvxnet_makise_tpu_torch.eval import runner
from mvxnet_makise_tpu_torch.geometry.calib import lidar_to_image
from mvxnet_makise_tpu_torch.models.mvxnet import (
    build_model,
    image_extractor,
)
from mvxnet_makise_tpu_torch.models.resnet_fpn import (
    load_torchvision_fpn_weights,
)
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.state import TrainState
from mvxnet_makise_tpu_torch.train.step import (
    frames_to_batch,
    make_train_step,
)
from mvxnet_makise_tpu_torch.utils.metrics import LossTracker, PhaseTimer


class TrainArrays(NamedTuple):
    """One frame, projected and padded to the config's capacities."""
    points: np.ndarray      # (max_points, 6) [x y z refl row col]
    num_points: int
    image: np.ndarray       # (H, W, 3)
    gt_boxes: np.ndarray    # (max_boxes, 7)
    gt_mask: np.ndarray     # (max_boxes,) bool
    gt_classes: np.ndarray  # (max_boxes,) int32


def preprocess_train_frame(frame: KittiFrame, cfg: Config,
                           augmenter: Optional[SceneAugmenter],
                           rng: np.random.Generator) -> TrainArrays:
    """Paste objects with ``augmenter`` (None: none), project every point
    to the image (a pasted cloud with its own calib), shuffle with ``rng``
    and pad to ``max_points``; gather the target classes' boxes, padded to
    ``max_boxes``.  Voxelization and assignment happen on the device."""
    if augmenter is not None:
        pasted, image, boxes, _ = augmenter(
            frame.points, frame.image, frame.bbox2d, frame.boxes,
            list(cfg.target_classes), list(cfg.augment_fill_to))
        cloud = assemble_augmented_cloud(frame.points, frame.calib, pasted)
    else:
        image, boxes = frame.image, frame.boxes
        uv = lidar_to_image(frame.points, frame.calib, keep_all=True)
        cloud = np.concatenate(
            [frame.points[:, :4], uv[:, 1:2], uv[:, 0:1]],
            axis=1).astype(np.float32)
    rng.shuffle(cloud, axis=0)
    n = min(len(cloud), cfg.max_points)
    pts = np.zeros((cfg.max_points, 6), dtype=np.float32)
    pts[:n] = cloud[:n]

    all_boxes, all_cls = [], []
    for ci, c in enumerate(cfg.target_classes):
        if c in boxes and len(boxes[c]):
            all_boxes.append(boxes[c])
            all_cls.append(np.full(len(boxes[c]), ci, np.int32))
    gt = np.zeros((cfg.max_boxes, 7), np.float32)
    gcls = np.zeros((cfg.max_boxes,), np.int32)
    gmask = np.zeros((cfg.max_boxes,), bool)
    if all_boxes:
        cat = np.concatenate(all_boxes, axis=0)[:cfg.max_boxes]
        gt[:len(cat)] = cat
        gcls[:len(cat)] = np.concatenate(all_cls, axis=0)[:cfg.max_boxes]
        gmask[:len(cat)] = True

    img = image if image is not None else np.zeros(
        (*cfg.image_size, 3), np.float32)
    return TrainArrays(points=pts, num_points=n,
                       image=np.asarray(img, np.float32), gt_boxes=gt,
                       gt_mask=gmask, gt_classes=gcls)


def build_model_and_state(cfg: Config, device: DeviceLike = None,
                          seed: int = 0, with_images: bool = True,
                          image_weights: Optional[Mapping] = None
                          ) -> Tuple[nn.Module, TrainState]:
    """The detector ``cfg`` describes (the LiDAR-only branch with
    ``with_images=False``), with random weights from ``seed``, in train
    mode on ``device`` (default: the CUDA card), and a fresh
    :class:`TrainState`.  ``image_weights``, a torchvision Faster R-CNN
    ResNet50-FPN state dict, goes into the frozen extractor of the fused
    model (``models/resnet_fpn.load_torchvision_fpn_weights``); the
    LiDAR-only model has none and ignores it."""
    model = build_model(cfg, seed=seed, device=device,
                        with_images=with_images).train()
    if image_weights is not None and with_images:
        image_extractor(model).load_state_dict(
            load_torchvision_fpn_weights(image_weights), strict=True)
    return model, TrainState.create(cfg, model)


def make_full_train_step(cfg: Config, anchors: torch.Tensor,
                         with_images: bool = True):
    """Voxelize + assign + forward + loss + backward + update:
    ``step(state, points, num_points, images, gt_boxes, gt_mask,
    gt_classes, perm)`` on tensors of the model's device; returns the
    metrics."""
    inner = make_train_step(cfg, anchors, with_images)

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


def _prefetch(pool: cf.Executor, fn, items: Iterable,
              depth: int) -> Iterator:
    """``fn(item)`` for each item, run on ``pool`` and yielded in order,
    with at most ``depth`` calls queued or running at a time: a feed that
    outruns the device holds ``depth`` frames, not the epoch's (``pool.map``
    queues every call at once, and a KITTI epoch is ~20 GB of frames)."""
    items = iter(items)
    queue = collections.deque(pool.submit(fn, x)
                              for _, x in zip(range(depth), items))
    while queue:
        head = queue.popleft()
        for x in items:
            queue.append(pool.submit(fn, x))
            break
        yield head.result()


def train(cfg: Config,
          frames: Sequence[KittiFrame],
          *,
          gt_db=None,
          resume_epoch: int = 0,
          num_epochs: Optional[int] = None,
          log_every: int = 50,
          workers: Optional[int] = None,
          eval_frames: Optional[Sequence[KittiFrame]] = None,
          eval_every: int = 1,
          time_budget_s: Optional[float] = None,
          device: DeviceLike = None,
          seed: int = 0,
          with_images: bool = True,
          image_weights: Optional[Mapping] = None) -> TrainState:
    """Train on in-RAM frames for ``num_epochs`` (default
    ``cfg.num_epochs``) after ``resume_epoch``; returns the final state.
    ``with_images=False`` trains the LiDAR-only detector (frames may then
    come without images); ``cfg.use_bf16`` computes in bfloat16 from
    float32 masters (``train/state``).

    ``gt_db`` (``data/gt_database.load_database``) turns on the paste
    augmentation.  ``image_weights`` (a torchvision Faster R-CNN
    ResNet50-FPN state dict) initializes the frozen extractor
    (:func:`build_model_and_state`).  Host prep runs on ``workers``
    threads (default ``cfg.num_workers``).  After each epoch's checkpoint, every
    ``eval_every`` epochs, the AP on ``eval_frames`` is printed as
    ``epoch N val CLASS: AP=... R=... gt=...``.  Random weights come from
    ``seed``; with ``resume_epoch`` > 0 the model, optimizer and step count
    are restored from that epoch's checkpoint in ``cfg.checkpoint_dir``.
    ``time_budget_s``: stop after the last fully checkpointed epoch once
    the wall-clock budget is spent.  On the card, float32 runs in full
    float32 (TF32 off, process-wide, ``device.use_full_f32``).

    Each epoch ends with one line of the loop's phase times
    (:class:`utils.metrics.PhaseTimer`): ``host_prep`` per frame (summed
    over the workers), ``host_wait`` (the device loop waiting for the
    feed), ``host_collate``, ``device_step``, ``device_wait``,
    ``checkpoint`` and ``eval``."""
    t_start = time.monotonic()
    num_epochs = num_epochs or cfg.num_epochs
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_full_f32()
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(dev)
    _, state = build_model_and_state(cfg, device=dev, seed=seed,
                                     with_images=with_images,
                                     image_weights=image_weights)
    if resume_epoch > 0:
        ckpt.restore_checkpoint(cfg.checkpoint_dir, resume_epoch, state)

    step = make_full_train_step(cfg, anchors, with_images)
    timer = PhaseTimer()
    shuffle = torch.Generator().manual_seed(cfg.seed)
    frames = list(frames)
    B = cfg.batch_size
    workers = max(cfg.num_workers if workers is None else workers, 1)

    for epoch in range(resume_epoch, resume_epoch + num_epochs):
        random.Random(cfg.seed + epoch).shuffle(frames)
        tracker = LossTracker()
        pending: List[dict] = []
        it = 0

        def prep(args, epoch=epoch):
            # a private generator per frame: Generators are not
            # thread-safe, and per-frame seeding keeps the feed the same
            # under any thread interleaving
            idx, fr = args
            with timer.phase("host_prep"):
                frame_rng = np.random.default_rng(
                    np.random.SeedSequence([cfg.seed, epoch, idx]))
                augmenter = (SceneAugmenter(cfg, gt_db, rng=frame_rng)
                             if gt_db else None)
                return preprocess_train_frame(fr, cfg, augmenter,
                                              frame_rng)

        steps = len(frames) // B
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            feed = _prefetch(pool, prep, enumerate(frames[:steps * B]),
                             2 * max(B, workers))
            for _ in range(steps):
                with timer.phase("host_wait"):
                    arrays = [next(feed) for _ in range(B)]
                with timer.phase("host_collate"):
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
        if eval_frames and (epoch + 1 - resume_epoch) % eval_every == 0:
            with timer.phase("eval"):
                res = runner.run_eval(cfg, list(eval_frames), state.model,
                                      batch_size=min(B, 4),
                                      with_images=with_images)
            for cname, buckets in res.items():
                r = buckets["all"]
                print(f"epoch {epoch + 1} val {cname}: "
                      f"AP={r['ap']:.4f} R={r['recall']:.4f} "
                      f"gt={r['num_gt']}")
        print(f"epoch {epoch + 1} done | step {state.step} | "
              f"avg total {tracker.average('total_loss'):.6f} | "
              f"{timer.report()}")
        if time_budget_s is not None \
                and time.monotonic() - t_start > time_budget_s:
            print(f"time budget ({time_budget_s:.0f}s) spent: stopping "
                  f"after epoch {epoch + 1} (resume with -r {epoch + 1})")
            break
    return state
