"""The device batch the point-major model consumes.

Port of ``Batch``, ``frames_to_batch`` and the point-major branch of
``_model_inputs`` from ``mvxnet_makise_tpu/train/step.py``; the train and
eval steps come with the training slice.  The JAX package's
``train/state.make_apply`` runs the model once per sample; here every
norm keeps the batch axis instead (``models/blocks.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.ops.voxelize import voxelize


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
    gt_boxes: Optional[torch.Tensor] = None  # (B, G, 7)
    gt_mask: Optional[torch.Tensor] = None   # (B, G) bool


def frames_to_batch(points: torch.Tensor, num_points: torch.Tensor,
                    images: torch.Tensor, cfg: Config,
                    gt_boxes: Optional[torch.Tensor] = None,
                    gt_mask: Optional[torch.Tensor] = None) -> Batch:
    """Voxelize padded frames on their device.  points: (B, P, 6);
    num_points: (B,); images: (B, H, W, 3)."""
    g = voxelize(points, num_points, velo_range=cfg.velo_range,
                 voxel_size=cfg.voxel_size, grid_shape=cfg.voxel_shape,
                 max_voxels=cfg.max_voxels,
                 samples_per_voxel=cfg.samples_per_voxel)
    return Batch(coords=g.coords, vmask=g.mask, images=images,
                 points=points, sorted_points=g.sorted_points,
                 sorted_kept=g.sorted_kept, sorted_seg=g.sorted_seg,
                 counts=g.counts, gt_boxes=gt_boxes, gt_mask=gt_mask)


def model_inputs(batch: Batch):
    """Arguments of ``MVXNetPM.forward`` in order."""
    return (batch.sorted_points, batch.sorted_kept, batch.sorted_seg,
            batch.counts, batch.coords, batch.vmask, batch.images)
