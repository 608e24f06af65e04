"""Synthetic KITTI-like frames (port of ``data/synthetic.py``, numpy).

A ground plane, a handful of car-sized boxes with surface points, a toy
but geometrically consistent calibration, and a random image.  Given the
same ``np.random.Generator`` state, :func:`synthetic_frame` and
:func:`synthetic_frame_multiclass` return the same frame as the JAX
package's functions of the same names.  :func:`write_kitti_tree` writes
such frames as a KITTI training tree on disk.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.image_io import write_png
from mvxnet_makise_tpu_torch.data.native import crop_project_numpy
from mvxnet_makise_tpu_torch.geometry.boxes import (
    boxes3d_to_corners3d,
    boxes_lidar_to_cam,
)
from mvxnet_makise_tpu_torch.geometry.calib import Calib, lidar_to_image


def toy_calib(image_size=(370, 1224)) -> Calib:
    """KITTI-like calibration: camera at the LiDAR origin looking +x,
    principal point at the image centre, focal length scaled with the
    image width so the horizontal FOV stays about 80 degrees at any
    image size."""
    h, w = image_size
    f = 720.0 * (w / 1224.0)
    v2c = np.array([[0, -1, 0, 0],
                    [0, 0, -1, 0],
                    [1, 0, 0, 0],
                    [0, 0, 0, 1]], dtype=np.float32)
    p2 = np.array([[f, 0, w / 2, 0],
                   [0, f, h / 2, 0],
                   [0, 0, 1, 0],
                   [0, 0, 0, 1]], dtype=np.float32)
    r0 = np.eye(4, dtype=np.float32)
    return Calib(velo_to_cam=v2c, P2=p2, R0=r0)


def _ground_points(rng: np.random.Generator, cfg: Config,
                   n_ground: int) -> np.ndarray:
    """Ground-plane points inside the frustum, denser near the sensor."""
    x0, y0, z0, x1, y1, z1 = cfg.velo_range
    gx = x0 + (x1 - x0) * rng.power(2.0, n_ground)
    gy = rng.uniform(-0.9, 0.9, n_ground) * gx * 0.8
    gy = np.clip(gy, y0 + 0.01, y1 - 0.01)
    gz = rng.normal(-1.7, 0.05, n_ground)
    return np.stack([gx, gy, gz], axis=1)


def _box_surface_points(rng: np.random.Generator, b: np.ndarray,
                        n: int) -> np.ndarray:
    """Sample n points on the surface of box (x y z l w h r)."""
    local = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # push to the nearest surface
    face = rng.integers(0, 3, n)
    sign = rng.choice([-0.5, 0.5], n)
    local[np.arange(n), face] = sign
    local *= b[3:6]
    c, s = np.cos(b[6]), np.sin(b[6])
    # the reference rotation convention (row @ [[c,-s],[s,c]])
    rx = local[:, 0] * c + local[:, 1] * s
    ry = -local[:, 0] * s + local[:, 1] * c
    return np.stack([rx + b[0], ry + b[1],
                     local[:, 2] + b[2] + b[5] / 2], axis=1)


def _random_boxes(rng: np.random.Generator, cfg: Config, n: int,
                  size, yaw_range=(-np.pi, np.pi)) -> np.ndarray:
    """n ground-standing boxes of roughly the given (l, w, h) inside the
    camera frustum and cfg.velo_range."""
    x0, y0, z0, x1, y1, z1 = cfg.velo_range
    boxes = np.zeros((n, 7), dtype=np.float32)
    boxes[:, 0] = rng.uniform(6, x1 * 0.9, n)
    boxes[:, 1] = rng.uniform(-0.5, 0.5, n) * boxes[:, 0] * 0.8
    boxes[:, 1] = np.clip(boxes[:, 1], y0 * 0.9, y1 * 0.9)
    boxes[:, 2] = rng.uniform(-1.8, -1.4, n)
    boxes[:, 3:6] = np.asarray(size) * \
        rng.uniform(0.9, 1.15, (n, 3)).astype(np.float32)
    boxes[:, 6] = rng.uniform(yaw_range[0], yaw_range[1], n)
    return boxes


def synthetic_frame_multiclass(rng: np.random.Generator,
                               cfg: Config,
                               counts=None,
                               num_points: int = 18000,
                               yaw_range=(-np.pi, np.pi)):
    """Multi-class synthetic frame for cfg.target_classes: returns
    (points (N, 4), calib, image, {class: (G_c, 7) boxes}).

    Default object counts: 6 per class whose anchor is longer than 3 m,
    4 per other class, with at least 40 surface points per object."""
    calib = toy_calib(cfg.image_size)
    if counts is None:
        counts = {c: (6 if s[0] > 3.0 else 4)
                  for c, s in zip(cfg.target_classes, cfg.anchor_sizes)}

    boxes_by_class = {}
    all_pts = []
    n_objects = sum(counts.values())
    n_box_pts = int(num_points * 0.35)
    for cls, size in zip(cfg.target_classes, cfg.anchor_sizes):
        n = counts.get(cls, 0)
        boxes = _random_boxes(rng, cfg, n, size, yaw_range)
        boxes_by_class[cls] = boxes
        per_box = max(n_box_pts // max(n_objects, 1), 40)
        for b in boxes:
            all_pts.append(_box_surface_points(rng, b, per_box))

    ground = _ground_points(rng, cfg, num_points - n_box_pts)
    cloud = np.concatenate([ground] + all_pts, axis=0)

    x0, y0, z0, x1, y1, z1 = cfg.velo_range
    lo = np.asarray([x0, y0, z0])
    hi = np.asarray([x1, y1, z1])
    keep = np.all((cloud >= lo) & (cloud < hi - 1e-4), axis=1)
    cloud = cloud[keep]
    refl = rng.uniform(0, 1, (len(cloud), 1)).astype(np.float32)
    points = np.concatenate([cloud.astype(np.float32), refl], axis=1)
    points = crop_project_numpy(
        points, calib, cfg.velo_range, cfg.image_size)[:, :4]
    image = rng.uniform(0, 1, (*cfg.image_size, 3)).astype(np.float32)
    return points, calib, image, boxes_by_class


def synthetic_frame(rng: np.random.Generator,
                    cfg: Config,
                    num_cars: int = 8,
                    num_points: int = 18000,
                    yaw_range=(-np.pi, np.pi),
                    ) -> Tuple[np.ndarray, Calib, np.ndarray, np.ndarray]:
    """Returns (points (N, 4), calib, image (H, W, 3) f32, gt_boxes (G, 7)).

    Points land inside the frustum of the toy camera and inside
    cfg.velo_range, like a cropped KITTI frame."""
    x0, y0, z0, x1, y1, z1 = cfg.velo_range
    calib = toy_calib(cfg.image_size)

    boxes = np.zeros((num_cars, 7), dtype=np.float32)
    boxes[:, 0] = rng.uniform(6, x1 * 0.9, num_cars)
    # |y| < ~0.8 x keeps boxes in the frustum
    boxes[:, 1] = rng.uniform(-0.5, 0.5, num_cars) * boxes[:, 0] * 0.8
    boxes[:, 1] = np.clip(boxes[:, 1], y0 * 0.9, y1 * 0.9)
    boxes[:, 2] = rng.uniform(-1.8, -1.4, num_cars)      # ground height
    boxes[:, 3:6] = np.asarray(cfg.car_size) * \
        rng.uniform(0.9, 1.15, (num_cars, 3)).astype(np.float32)
    boxes[:, 6] = rng.uniform(yaw_range[0], yaw_range[1], num_cars)

    n_box_pts = int(num_points * 0.35)
    n_ground = num_points - n_box_pts

    ground = _ground_points(rng, cfg, n_ground)
    per_box = n_box_pts // num_cars
    box_pts = [_box_surface_points(rng, b, per_box) for b in boxes]
    cloud = np.concatenate([ground] + box_pts, axis=0)

    lo = np.asarray([x0, y0, z0])
    hi = np.asarray([x1, y1, z1])
    keep = np.all((cloud >= lo) & (cloud < hi - 1e-4), axis=1)
    cloud = cloud[keep]

    refl = rng.uniform(0, 1, (len(cloud), 1)).astype(np.float32)
    points = np.concatenate([cloud.astype(np.float32), refl], axis=1)

    # frustum-crop like the offline crop tool's output
    points = crop_project_numpy(
        points, calib, cfg.velo_range, cfg.image_size)[:, :4]

    image = rng.uniform(0, 1, (*cfg.image_size, 3)).astype(np.float32)
    return points, calib, image, boxes


def _calib_lines(calib: Calib) -> str:
    zeros = " ".join(["0"] * 12)

    def row(m, n):
        return " ".join(str(x) for x in np.asarray(m)[:n].ravel())
    return (f"P0: {zeros}\nP1: {zeros}\nP2: {row(calib.P2, 3)}\n"
            f"P3: {zeros}\nR0_rect: {row(np.asarray(calib.R0)[:3, :3], 3)}"
            f"\nTr_velo_to_cam: {row(calib.velo_to_cam, 3)}\n"
            f"Tr_imu_to_velo: {zeros}\n")


def write_kitti_tree(root: str, cfg: Config, rng: np.random.Generator,
                     n_train: int, n_val: int, num_cars: int = 8,
                     num_points: int = 18000,
                     extra_points: int = 500) -> List[str]:
    """Write ``n_train + n_val`` synthetic frames as a KITTI training tree
    under ``root`` (``training/{velodyne,label_2,calib,image_2}`` and
    ``ImageSets/{train,val}.txt``, the first ``n_train`` ids in train.txt);
    returns the frame ids.

    Each scan is a :func:`synthetic_frame` plus ``extra_points`` points
    behind the sensor (out of range: ``tools.cropdata`` removes them).
    Each label holds the frame's cars, with the 2D box of their projected
    corners clipped to the image, and one ``DontCare`` line; the image is
    an 8-bit PNG."""
    t = os.path.join(root, "training")
    dirs = {k: os.path.join(t, k) for k in
            ("velodyne", "label_2", "calib", "image_2")}
    for d in (*dirs.values(), os.path.join(root, "ImageSets")):
        os.makedirs(d, exist_ok=True)
    h, w = cfg.image_size
    ids = []
    for i in range(n_train + n_val):
        fid = f"{i:06d}"
        ids.append(fid)
        pts, calib, image, boxes = synthetic_frame(
            rng, cfg, num_cars=num_cars, num_points=num_points)
        extra = rng.uniform(-1, 1, (extra_points, 4)).astype(np.float32)
        extra[:, 0] -= 20
        np.concatenate([pts, extra]).astype(np.float32).tofile(
            os.path.join(dirs["velodyne"], fid + ".bin"))
        with open(os.path.join(dirs["calib"], fid + ".txt"), "w") as f:
            f.write(_calib_lines(calib))
        cam = boxes_lidar_to_cam(boxes, calib.velo_to_cam)
        corners = boxes3d_to_corners3d(torch.from_numpy(boxes)).numpy()
        with open(os.path.join(dirs["label_2"], fid + ".txt"), "w") as f:
            for b, c in zip(cam, corners):
                uv = lidar_to_image(c, calib)
                l, tp = np.clip(uv.min(0), 0, [w - 1, h - 1])
                r, bt = np.clip(uv.max(0), 0, [w - 1, h - 1])
                f.write(f"Car 0.00 0 0.00 {l:.2f} {tp:.2f} {r:.2f} "
                        f"{bt:.2f} " + " ".join(f"{x:.4f}" for x in b)
                        + "\n")
            f.write("DontCare -1 -1 -10 0 0 50 50 -1 -1 -1 -1000 -1000 "
                    "-1000 -10\n")
        write_png(os.path.join(dirs["image_2"], fid + ".png"),
                  (image * 255).astype(np.uint8))
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids[:n_train]) + "\n")
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write("\n".join(ids[n_train:]) + "\n")
    return ids
