"""Host-side frame preprocessing: project, pad, collate (port of
``mvxnet_makise_tpu/data/pipeline.py``, numpy).

The voxelizer and the anchor assignment run on the device, so the host's
jobs are the cheap numpy parts: projection, padding to static capacity,
and batch collation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.geometry.calib import Calib, lidar_to_image


class FrameArrays(NamedTuple):
    """One frame, padded to static capacities, ready for device transfer."""
    points: np.ndarray     # (max_points, 6) [x y z refl row col]
    num_points: np.int32
    image: np.ndarray      # (H, W, 3) float32 in [0, 1]
    gt_boxes: np.ndarray   # (max_boxes, 7)
    gt_mask: np.ndarray    # (max_boxes,) bool


def preprocess_frame(points: np.ndarray,
                     calib: Calib,
                     image: Optional[np.ndarray],
                     gt_boxes: Optional[np.ndarray],
                     cfg: Config) -> FrameArrays:
    """points: (N, 4) [x y z refl] already range/frustum cropped;
    image: (H, W, 3) uint8 or float; gt_boxes: (G, 7) xyzlwhr or None."""
    if len(points) > cfg.max_points:
        # deterministic, spatially unbiased subsample of an over-capacity
        # frame: raw scan order is azimuth-sorted, so a strided pick keeps
        # uniform angular coverage
        sel = np.linspace(0, len(points) - 1, cfg.max_points).astype(np.int64)
        points = points[sel]
    n = len(points)
    pts = np.zeros((cfg.max_points, 6), dtype=np.float32)
    pts[:n, :4] = points[:n, :4]
    # append image-plane (row, col)
    uv = lidar_to_image(points[:n], calib, keep_all=True)
    pts[:n, 4] = uv[:, 1]   # row
    pts[:n, 5] = uv[:, 0]   # col

    if image is None:
        img = np.zeros((*cfg.image_size, 3), dtype=np.float32)
    else:
        img = np.asarray(image, dtype=np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = cfg.image_size
        img = img[:h, :w]
        if img.shape[:2] != (h, w):
            padded = np.zeros((h, w, 3), dtype=np.float32)
            padded[:img.shape[0], :img.shape[1]] = img
            img = padded

    boxes = np.zeros((cfg.max_boxes, 7), dtype=np.float32)
    mask = np.zeros((cfg.max_boxes,), dtype=bool)
    if gt_boxes is not None and len(gt_boxes) > 0:
        g = min(len(gt_boxes), cfg.max_boxes)
        boxes[:g] = gt_boxes[:g]
        mask[:g] = True

    return FrameArrays(points=pts, num_points=np.int32(n), image=img,
                       gt_boxes=boxes, gt_mask=mask)


def collate(frames: Sequence[FrameArrays]) -> FrameArrays:
    """Stack frames into batched arrays (leading batch axis)."""
    return FrameArrays(
        points=np.stack([f.points for f in frames]),
        num_points=np.asarray([f.num_points for f in frames], np.int32),
        image=np.stack([f.image for f in frames]),
        gt_boxes=np.stack([f.gt_boxes for f in frames]),
        gt_mask=np.stack([f.gt_mask for f in frames]),
    )
