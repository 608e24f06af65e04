"""The device batch, and the train and eval steps over it.

Port of ``Batch``, ``frames_to_batch``, ``cast_batch_for_compute``, the
point-major branches of ``_model_inputs``, ``_assign_batch``,
``compute_loss``, ``make_train_step`` and ``make_eval_step`` from
``mvxnet_makise_tpu/train/step.py``.  The JAX package's
``train/state.make_apply`` runs the model once per sample; here every
norm keeps the batch axis instead (``models/blocks.py``).  The step runs
eagerly: assignment, forward, loss, backward (K1's and K4's backward
kernels on the card) and the AdamW update.  ``with_images=False`` is the
LiDAR-only detector (``models/mvxnet.build_model``); under ``use_bf16``
the forward runs on bfloat16 copies of the parameters
(``train/state.cast_for_compute``).

Spans (``utils/profiling``): ``mvx.model.voxelize`` in
:func:`frames_to_batch`; each step is ``mvx.train.step`` around
``mvx.train.assign``, ``mvx.train.forward``, ``mvx.train.loss``,
``mvx.train.backward``, ``mvx.train.finite_check``,
``mvx.train.allreduce`` (under a mesh) and ``mvx.train.optimizer``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.models.voxelnet_pm import point_lidar_features
from mvxnet_makise_tpu_torch.ops.assign import (
    AnchorTargets,
    assign_anchor_targets,
)
from mvxnet_makise_tpu_torch.ops.voxelize import voxelize
from mvxnet_makise_tpu_torch.train.loss import voxel_loss
from mvxnet_makise_tpu_torch.train.state import TrainState, cast_for_compute
from mvxnet_makise_tpu_torch.utils.profiling import span, sync_point


class Batch(NamedTuple):
    """One device batch of voxelized frames (point-major fields)."""
    coords: torch.Tensor         # (B, V, 3) int32
    vmask: torch.Tensor          # (B, V) bool
    images: torch.Tensor         # (B, H, W, 3) float in [0, 1]
    points: torch.Tensor         # (B, P, 6) padded clouds
    sorted_points: torch.Tensor  # (B, P, 6) voxel-sorted
    sorted_kept: torch.Tensor    # (B, P) bool
    sorted_seg: torch.Tensor     # (B, P) int32
    counts: torch.Tensor         # (B, V) int32
    gt_boxes: Optional[torch.Tensor] = None    # (B, G, 7)
    gt_mask: Optional[torch.Tensor] = None     # (B, G) bool
    gt_classes: Optional[torch.Tensor] = None  # (B, G) int; None = class 0


def frames_to_batch(points: torch.Tensor, num_points: torch.Tensor,
                    images: torch.Tensor, cfg: Config,
                    gt_boxes: Optional[torch.Tensor] = None,
                    gt_mask: Optional[torch.Tensor] = None,
                    gt_classes: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None) -> Batch:
    """Voxelize padded frames on their device.  points: (B, P, 6);
    num_points: (B,); images: (B, H, W, 3); ``perm``: (B, P) permutation
    of each cloud for the training shuffle (None: no shuffle)."""
    with span("mvx.model.voxelize"):
        g = voxelize(points, num_points, velo_range=cfg.velo_range,
                     voxel_size=cfg.voxel_size, grid_shape=cfg.voxel_shape,
                     max_voxels=cfg.max_voxels,
                     samples_per_voxel=cfg.samples_per_voxel, perm=perm)
    return Batch(coords=g.coords, vmask=g.mask, images=images,
                 points=points, sorted_points=g.sorted_points,
                 sorted_kept=g.sorted_kept, sorted_seg=g.sorted_seg,
                 counts=g.counts, gt_boxes=gt_boxes, gt_mask=gt_mask,
                 gt_classes=gt_classes)


def cast_batch_for_compute(batch: Batch, use_bf16: bool) -> Batch:
    """Under ``use_bf16`` the images in bfloat16; the points, which carry
    geometry (bfloat16 is +-0.25 m at 70 m and +-8 px at column 1000),
    stay float32: the model casts what it derives from them after the
    geometry is consumed."""
    if not use_bf16:
        return batch
    return batch._replace(images=batch.images.to(torch.bfloat16))


def model_inputs(batch: Batch) -> tuple:
    """Arguments of ``MVXNetPM``'s forward, in order."""
    return (batch.sorted_points, batch.sorted_kept, batch.sorted_seg,
            batch.counts, batch.coords, batch.vmask, batch.images)


def lidar_inputs(batch: Batch, samples_per_voxel: int) -> tuple:
    """Arguments of the LiDAR-only ``VoxelNetBranchPM``'s forward, in
    order: its 7-channel point features are computed here from the
    points, in their dtype, as JAX's ``_model_inputs`` does."""
    with span("mvx.model.vfe"):
        pf7 = point_lidar_features(batch.sorted_points, batch.sorted_seg,
                                   batch.sorted_kept, batch.counts,
                                   samples_per_voxel)
    return (pf7, batch.sorted_kept, batch.sorted_seg, batch.counts,
            batch.coords, batch.vmask)


def forward(model: nn.Module, batch: Batch, cfg: Config, with_images: bool,
            tensors: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's (score, reg) maps for a batch, in the compute dtype:
    the fused model, or with ``with_images=False`` the LiDAR-only one.
    Under ``use_bf16`` the model runs on ``tensors``, the copies of
    :func:`train.state.cast_for_compute` (cast here when None; a caller
    that runs many batches on the same weights casts once and passes
    them)."""
    if tensors is None:
        tensors = cast_for_compute(model, cfg.use_bf16, with_images)
    batch = cast_batch_for_compute(batch, cfg.use_bf16)
    inputs = (model_inputs(batch) if with_images
              else lidar_inputs(batch, cfg.samples_per_voxel))
    if tensors is None:
        return model(*inputs)
    return torch.func.functional_call(model, tensors, inputs)


def _assign_batch(batch: Batch, cfg: Config) -> AnchorTargets:
    """Targets of every frame, stacked: fields (B, H, W, A)."""
    classes = batch.gt_classes
    if classes is None:
        classes = torch.zeros(batch.gt_mask.shape, dtype=torch.int32,
                              device=batch.gt_mask.device)
    per_frame = [assign_anchor_targets(
        boxes, mask, grid_hw=cfg.feature_map_shape,
        velo_range=cfg.velo_range, box_size=cfg.anchor_sizes,
        neg_threshold=cfg.class_neg_thresholds,
        pos_threshold=cfg.class_pos_thresholds, window=cfg.assign_window,
        gt_classes=cls,
        best_anchor_fallback=cfg.assign_best_anchor_fallback)
        for boxes, mask, cls in zip(batch.gt_boxes, batch.gt_mask, classes)]
    return AnchorTargets(*(torch.stack(f) for f in zip(*per_frame)))


def compute_loss(model: nn.Module, batch: Batch, targets: AnchorTargets,
                 anchors: torch.Tensor, cfg: Config, with_images: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean over frames of :func:`voxel_loss`, and the mean of each
    metric.  The maps enter the loss in at least float32, as JAX casts
    them to float32; a float64 model keeps float64."""
    with span("mvx.train.forward"):
        score, reg = forward(model, batch, cfg, with_images)
    with span("mvx.train.loss"):
        dtype = torch.promote_types(score.dtype, torch.float32)
        score, reg = score.to(dtype), reg.to(dtype)
        anchors = anchors.to(dtype)
        losses, metrics = [], []
        for b in range(score.shape[0]):
            loss, m = voxel_loss(
                score[b], reg[b], AnchorTargets(*(f[b] for f in targets)),
                batch.gt_boxes[b].to(dtype), anchors,
                pos_weight=cfg.pos_loss_weight,
                neg_weight=cfg.neg_loss_weight, eps=cfg.eps,
                mode=cfg.cls_loss_mode, focal_gamma=cfg.focal_gamma,
                focal_alpha=cfg.focal_alpha)
            losses.append(loss)
            metrics.append(m)
        return (torch.stack(losses).mean(),
                {k: torch.stack([m[k] for m in metrics]).to(dtype).mean()
                 for k in metrics[0]})


# elements per all-reduce of the flattened gradients (64 MiB of float32)
GRAD_BUCKET = 1 << 24


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of consecutive tensors of one dtype and at most GRAD_BUCKET
    elements together (a larger tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype
                       or size + t.numel() > GRAD_BUCKET):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def _data_mean(tensors: Sequence[torch.Tensor], group, n: int) -> None:
    """Replace each tensor in place by its mean over the ``n`` data ranks
    of ``group``: one all-reduce per flattened bucket."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= n
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def make_train_step(cfg: Config, anchors: torch.Tensor,
                    with_images: bool = True, mesh=None
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The train step: assign, forward, loss, backward, AdamW update (of
    the float32 masters under ``use_bf16``).  ``anchors``: (H, W, A, 7)
    on the model's device.

    ``step(state, batch)`` updates ``state`` in place and returns the
    metrics.  A non-finite loss leaves the parameters, the optimizer state
    and the step count (and so the schedule) as they were, and reports
    ``skipped_nonfinite`` = 1.

    With ``mesh`` (``parallel.make_mesh``), the step of JAX's SPMD program
    on a sharded batch: ``state.model`` went through
    ``parallel.shard_params`` before its optimizer was made, and ``batch``
    is this rank's rows (``parallel.shard_batch``).  The loss is the mean
    over the global batch: each rank's mean, averaged over the data
    ranks (the shards are equal).  The masters' gradients are averaged
    over the data ranks in flattened buckets (model ranks already agree
    on the replicated parameters' gradients and own their slices'), and
    the metrics are the global means, the same on every rank.  The
    non-finite skip is global: it reads the all-reduced loss, which is
    non-finite on every rank when any rank's loss is.  The model is not
    wrapped in ``DistributedDataParallel``: the forward runs
    ``torch.func.functional_call`` on cast copies, and DDP's reducer is
    armed only by its own forward."""
    group = n_data = None
    if mesh is not None:
        from mvxnet_makise_tpu_torch.parallel.mesh import axis_size

        group, n_data = mesh.get_group("data"), axis_size(mesh, "data")

    def train_step(state: TrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        with span("mvx.train.step"):
            with span("mvx.train.assign"):
                targets = _assign_batch(batch, cfg)
            state.optimizer.zero_grad(set_to_none=True)
            loss, metrics = compute_loss(state.model, batch, targets,
                                         anchors, cfg, with_images)
            with span("mvx.train.backward"):
                loss.backward()
            loss = loss.detach()
            if group is not None:
                with span("mvx.train.allreduce"):
                    names = list(metrics)
                    flat = torch.stack([loss, *(metrics[k].detach().to(
                        loss.dtype) for k in names)])
                    dist.all_reduce(flat, group=group)
                    flat /= n_data
                    loss = flat[0]
                    metrics = {k: v.to(metrics[k].dtype)
                               for k, v in zip(names, flat[1:])}
            with span("mvx.train.finite_check"), sync_point():
                finite = bool(torch.isfinite(loss))
            if finite:
                if group is not None:
                    with span("mvx.train.allreduce"):
                        _data_mean([p.grad for p in state.model.parameters()
                                    if p.grad is not None], group, n_data)
                with span("mvx.train.optimizer"):
                    state.apply_gradients()
            return dict(metrics, total_loss=loss,
                        skipped_nonfinite=torch.tensor(int(not finite)))

    return train_step


def make_eval_step(cfg: Config, with_images: bool = True
                   ) -> Callable[[nn.Module, Batch],
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Forward-only step returning float32 (score, reg) maps."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Batch):
        score, reg = forward(model, batch, cfg, with_images)
        return score.float(), reg.float()

    return eval_step
