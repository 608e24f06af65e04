"""Online GT-paste augmentation on the host (port of
``mvxnet_makise_tpu/data/augment.py``, numpy).

Fills each scene up to ``fill_to`` objects per class by pasting database
samples that pass three gates:

  1. ground height: a 704x800 max-z grid of the scene; the candidate's
     box bottom must not sit more than 0.1 m below the local ground;
  2. image occlusion: the 2D intersection-over-first against every scene
     box stays <= a threshold drawn once per scene from {0.1, 0.3, 0.5};
  3. BEV overlap: rotated BEV IoU against the scene boxes <= 0.05
     (``geometry/boxes_np``).

A pasted object keeps its source frame's calibration for the image
projection, and its masked pixels are alpha-composited into the scene
image.  The draws from the augmenter's ``np.random.Generator`` (candidate
samples, then the IoF threshold) come in the JAX package's order, so one
``SeedSequence`` pastes the same objects in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.geometry.boxes_np import (
    bev_corners,
    iou_bev_corners,
)
from mvxnet_makise_tpu_torch.geometry.calib import Calib, lidar_to_image

IOF_THRESHOLDS = (0.1, 0.3, 0.5)
GROUND_GRID = (704, 800)
GROUND_CELL = 0.1


def ground_height_grid(points: np.ndarray,
                       velo_range: Sequence[float],
                       grid_shape: Tuple[int, int] = GROUND_GRID
                       ) -> np.ndarray:
    """Max-z per BEV cell; empty cells get z_min - 1."""
    lo = np.asarray(velo_range[:2], np.float32)
    size = np.asarray([
        (velo_range[3] - velo_range[0]) / grid_shape[0],
        (velo_range[4] - velo_range[1]) / grid_shape[1]], np.float32)
    loc = ((points[:, :2] - lo) / size).astype(np.int64)
    ok = (loc[:, 0] >= 0) & (loc[:, 0] < grid_shape[0]) & \
         (loc[:, 1] >= 0) & (loc[:, 1] < grid_shape[1])
    loc = loc[ok]
    zmax = np.full(grid_shape, velo_range[2] - 1.0, np.float32)
    np.maximum.at(zmax, (loc[:, 0], loc[:, 1]), points[ok, 2])
    return zmax


class SceneAugmenter:
    """Per-scene paste augmentation.  Not thread-safe (it draws from one
    ``np.random.Generator``): give each frame its own."""

    def __init__(self, cfg: Config, gt_db: Dict[str, List[dict]],
                 rng: Optional[np.random.Generator] = None,
                 candidates_per_slot: int = 30):
        self.cfg = cfg
        self.gt_db = gt_db
        self.rng = rng or np.random.default_rng()
        self.candidates = candidates_per_slot
        self.fail_count = {t: 0 for t in IOF_THRESHOLDS}

    def _locate(self, zmax, scene_bevs, scene_b2d, samples, iof_thr):
        """Pick one DB sample passing all gates, or (None, None)."""
        n = min(self.candidates, len(samples))
        chosen = self.rng.choice(len(samples), size=n, replace=False)
        vr = self.cfg.velo_range
        if len(scene_b2d):
            areas = (scene_b2d[:, 2] - scene_b2d[:, 0]) * \
                    (scene_b2d[:, 3] - scene_b2d[:, 1])
        for ci in chosen:
            gt = samples[ci]
            box3d = gt["bbox3d"]
            gx = int((box3d[0] - vr[0]) / GROUND_CELL)
            gy = int((box3d[1] - vr[1]) / GROUND_CELL)
            if not (0 <= gx < GROUND_GRID[0] and 0 <= gy < GROUND_GRID[1]):
                continue
            if zmax[gx, gy] > box3d[2] + 0.1:
                continue  # would float above / clip into structure

            gt_bev = bev_corners(box3d[None])[0]
            if len(scene_bevs) == 0:
                return gt, gt_bev

            b2d = gt["bbox2d"]
            lt = np.maximum(scene_b2d[:, :2], b2d[:2])
            rb = np.minimum(scene_b2d[:, 2:], b2d[2:])
            wh = np.clip(rb - lt, 0, None)
            iof = wh[:, 0] * wh[:, 1] / np.maximum(areas, 1e-9)
            if iof.max() > iof_thr:
                continue

            ious = iou_bev_corners(gt_bev[None], np.asarray(scene_bevs))
            if ious.max() > 0.05:
                continue
            return gt, gt_bev
        self.fail_count[iof_thr] += 1
        return None, None

    def augment_class(self, points, image, scene_b2d, scene_b3d,
                      scene_bevs, cls: str, fill_to: int):
        """Fill the scene with ``cls`` samples up to ``fill_to`` objects.

        Returns (pasted [(velo, calib)], image, boxes3d, bevs, bbox2d);
        pasted clouds keep their own calib for projection."""
        if scene_b2d is None or len(scene_b2d) == 0:
            scene_b2d = np.zeros((0, 4), np.float32)
            scene_b3d = np.zeros((0, 7), np.float32)
            scene_bevs = np.zeros((0, 4, 2), np.float32)
        samples = self.gt_db.get(cls, [])
        need = fill_to - len(scene_b3d)
        if need <= 0 or not samples:
            return [], image, scene_b3d, scene_bevs, scene_b2d

        zmax = ground_height_grid(points, self.cfg.velo_range)
        iof_thr = float(self.rng.choice(IOF_THRESHOLDS))
        # image may be None in LiDAR-only training: skip pixel pasting
        image = image.copy() if image is not None else None
        pasted = []
        for _ in range(need):
            gt, gt_bev = self._locate(zmax, scene_bevs, scene_b2d,
                                      samples, iof_thr)
            if gt is None:
                continue
            pasted.append((gt["velo"], gt["calib"]))
            scene_bevs = np.concatenate(
                [scene_bevs, gt_bev[None]], axis=0)
            scene_b2d = np.concatenate(
                [scene_b2d, gt["bbox2d"][None]], axis=0)
            scene_b3d = np.concatenate(
                [scene_b3d, gt["bbox3d"][None]], axis=0)

            if image is None:
                continue
            # composite the masked patch
            mb = gt["maskbbox"]
            mask = gt["mask"].astype(np.uint8)
            patch = gt["image"]
            roi = image[mb[1]:mb[3] + 1, mb[0]:mb[2] + 1]
            h = min(roi.shape[0], patch.shape[0], mask.shape[0])
            w = min(roi.shape[1], patch.shape[1], mask.shape[1])
            if h <= 0 or w <= 0:
                continue
            m = mask[:h, :w, None].astype(roi.dtype)
            image[mb[1]:mb[1] + h, mb[0]:mb[0] + w] = \
                roi[:h, :w] * (1 - m) + patch[:h, :w] * m
        return pasted, image, scene_b3d, scene_bevs, scene_b2d

    def __call__(self, points, image, boxes2d, boxes3d,
                 classes: Sequence[str], fill_to: Sequence[int]):
        """Full per-frame augmentation.

        Args:
          points: (N, 4) scene cloud; image: (H, W, 3); boxes2d/boxes3d:
            per-class dicts of scene GT (may be missing keys).
        Returns (pasted list of (velo, calib), image, boxes3d dict,
          bevs dict).
        """
        pasted_all = []
        out_boxes, out_bevs = {}, {}
        for cls, lim in zip(classes, fill_to):
            b3d = boxes3d.get(cls) if boxes3d else None
            b2d = boxes2d.get(cls) if boxes2d else None
            bevs = bev_corners(b3d) if b3d is not None and len(b3d) \
                else np.zeros((0, 4, 2), np.float32)
            pasted, image, b3, bv, _ = self.augment_class(
                points, image, b2d, b3d, bevs, cls, lim)
            pasted_all.extend(pasted)
            out_boxes[cls] = b3
            out_bevs[cls] = bv
        return pasted_all, image, out_boxes, out_bevs


def assemble_augmented_cloud(points: np.ndarray, calib: Calib,
                             pasted: Sequence[Tuple[np.ndarray, Calib]]
                             ) -> np.ndarray:
    """Project the scene and every pasted cloud (each with its own calib)
    and concatenate into the 6-channel layout [x y z refl row col]."""
    chunks = []
    uv = lidar_to_image(points, calib, keep_all=True)
    chunks.append(np.concatenate(
        [points[:, :4], uv[:, 1:2], uv[:, 0:1]], axis=1))
    for velo, pc in pasted:
        uv = lidar_to_image(velo, pc, keep_all=True)
        chunks.append(np.concatenate(
            [velo[:, :4], uv[:, 1:2], uv[:, 0:1]], axis=1))
    return np.concatenate(chunks, axis=0).astype(np.float32)
