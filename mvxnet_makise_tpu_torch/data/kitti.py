"""KITTI dataset access: labels, calib, velodyne, images, splits (port of
``mvxnet_makise_tpu/data/kitti.py``, numpy).

Reads the (cropped) velodyne ``.bin``, the image cut to the configured
size, and ``label_2`` filtered to the target classes, converts camera
labels to LiDAR boxes, range-filters them, and keeps the whole split in
RAM.  Images are read by the port's own PNG decoder
(``data/image_io.read_png``) in BGR order, as the JAX package reads them
with ``cv2.imread``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.image_io import read_png
from mvxnet_makise_tpu_torch.geometry.boxes import boxes_cam_to_lidar
from mvxnet_makise_tpu_torch.geometry.calib import Calib, read_calib


@dataclass
class KittiPaths:
    root: str
    velodyne: str
    velodyne_cropped: str
    label: str
    calib: str
    image: str
    train_split: str
    val_split: str

    @classmethod
    def from_root(cls, root: str) -> "KittiPaths":
        t = os.path.join(root, "training")
        return cls(
            root=root,
            velodyne=os.path.join(t, "velodyne"),
            velodyne_cropped=os.path.join(t, "velodyne_croped"),
            label=os.path.join(t, "label_2"),
            calib=os.path.join(t, "calib"),
            image=os.path.join(t, "image_2"),
            train_split=os.path.join(root, "ImageSets", "train.txt"),
            val_split=os.path.join(root, "ImageSets", "val.txt"),
        )


def read_split(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line for line in f.read().splitlines() if line.strip()]


def read_labels(path: str) -> Dict[str, np.ndarray]:
    """Parse a label_2 .txt.  Returns columns as arrays, rows unfiltered."""
    rows = []
    if os.path.exists(path):
        with open(path, "r") as f:
            for line in f.read().splitlines():
                parts = line.split()
                if len(parts) >= 15:
                    rows.append(parts[:15])
    if not rows:
        return {"type": np.zeros((0,), dtype=object),
                "bbox2d": np.zeros((0, 4), np.float32),
                "cam_box": np.zeros((0, 7), np.float32),
                "truncated": np.zeros((0,), np.float32),
                "occluded": np.zeros((0,), np.float32)}
    arr = np.asarray(rows, dtype=object)
    types = arr[:, 0].astype(str)
    nums = arr[:, 1:].astype(np.float32)
    return {
        "type": types,
        "truncated": nums[:, 0],
        "occluded": nums[:, 1],
        "bbox2d": nums[:, 3:7],                       # l, t, r, b
        "cam_box": nums[:, 7:14],                     # h w l x y z ry
    }


@dataclass
class KittiFrame:
    """One frame on the host.  ``bbox2d`` and ``difficulty`` may be left
    empty for frames trained without the paste augmentation (synthetic
    frames); the evaluator bins a box without a difficulty as
    moderate."""
    frame_id: str
    points: np.ndarray                 # (N, 4) cropped cloud
    image: Optional[np.ndarray]        # (H, W, 3) float32 [0, 1] BGR, or None
    calib: Calib
    boxes: Dict[str, np.ndarray]       # class -> (G, 7) lidar boxes
    bbox2d: Dict[str, np.ndarray] = field(default_factory=dict)
    difficulty: Dict[str, np.ndarray] = field(default_factory=dict)


def _difficulty(bbox2d, truncated, occluded) -> np.ndarray:
    """KITTI easy/moderate/hard bins (evaluator convention):
    by 2D box height, occlusion and truncation."""
    height = bbox2d[:, 3] - bbox2d[:, 1]
    diff = np.full(len(bbox2d), -1, np.int32)
    hard = (height >= 25) & (occluded <= 2) & (truncated <= 0.5)
    mod = (height >= 25) & (occluded <= 1) & (truncated <= 0.3)
    easy = (height >= 40) & (occluded <= 0) & (truncated <= 0.15)
    diff[hard] = 2
    diff[mod] = 1
    diff[easy] = 0
    return diff


def load_frame(paths: KittiPaths, frame_id: str, cfg: Config,
               use_cropped: bool = True,
               load_image: bool = True) -> KittiFrame:
    """Load one frame.  Points come from velodyne_croped when present
    (``tools.cropdata``'s output), else the raw scan."""
    velo_dir = paths.velodyne_cropped if use_cropped and os.path.isdir(
        paths.velodyne_cropped) else paths.velodyne
    velo_path = os.path.join(velo_dir, frame_id + ".bin")
    points = np.fromfile(velo_path, dtype=np.float32).reshape(-1, 4)

    calib = read_calib(os.path.join(paths.calib, frame_id + ".txt"))

    image = None
    if load_image:
        img = read_png(os.path.join(paths.image, frame_id + ".png"))
        if img is not None:
            h, w = cfg.image_size
            # the reference feeds BGR uint8 / 255 (no channel swap)
            image = img[:h, :w].astype(np.float32) / 255.0

    labels = read_labels(os.path.join(paths.label, frame_id + ".txt"))
    c2v = np.linalg.inv(np.asarray(calib.velo_to_cam))
    boxes, bbox2d, diffs = {}, {}, {}
    lo = np.asarray(cfg.velo_range[:3], np.float32)
    hi = np.asarray(cfg.velo_range[3:6], np.float32)
    for cls in cfg.target_classes:
        sel = labels["type"] == cls
        cam = labels["cam_box"][sel]
        b2d = labels["bbox2d"][sel]
        trunc = labels["truncated"][sel]
        occ = labels["occluded"][sel]
        if len(cam) == 0:
            boxes[cls] = np.zeros((0, 7), np.float32)
            bbox2d[cls] = np.zeros((0, 4), np.float32)
            diffs[cls] = np.zeros((0,), np.int32)
            continue
        lidar = np.asarray(boxes_cam_to_lidar(cam, c2v), np.float32)
        in_range = np.all(
            (lidar[:, :3] >= lo) & (lidar[:, :3] < hi), axis=1)
        boxes[cls] = lidar[in_range]
        bbox2d[cls] = b2d[in_range]
        diffs[cls] = _difficulty(b2d, trunc, occ)[in_range]

    return KittiFrame(frame_id=frame_id, points=points, image=image,
                      calib=calib, boxes=boxes, bbox2d=bbox2d,
                      difficulty=diffs)


def load_dataset(root: str, split: str, cfg: Config,
                 load_images: bool = True,
                 limit: Optional[int] = None) -> List[KittiFrame]:
    """Load a whole split ("train" or "val") into RAM."""
    paths = KittiPaths.from_root(root)
    split_path = paths.train_split if split == "train" else paths.val_split
    ids = read_split(split_path)
    if limit:
        ids = ids[:limit]
    return [load_frame(paths, fid, cfg, load_image=load_images)
            for fid in ids]
