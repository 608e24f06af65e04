"""Synthetic KITTI-like frames (port of ``data/synthetic.py``, numpy).

A ground plane, a handful of car-sized boxes with surface points, a toy
but geometrically consistent calibration, and a random image.  Given the
same ``np.random.Generator`` state, :func:`synthetic_frame` returns the
same frame as the JAX package's function of the same name.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data.native import crop_project_numpy
from mvxnet_makise_tpu_torch.geometry.calib import Calib


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
