"""KITTI calibration matrices and the LiDAR->image projection chain, in
numpy (the port's copy of ``mvxnet_makise_tpu/geometry/calib.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Calib(NamedTuple):
    """4x4 homogeneous calibration matrices (float32)."""
    velo_to_cam: np.ndarray   # 'Tr_velo_to_cam' padded to 4x4
    P2: np.ndarray            # camera-2 projection padded to 4x4
    R0: np.ndarray            # rectifying rotation embedded in 4x4

    @property
    def proj(self) -> np.ndarray:
        """Combined LiDAR->image homogeneous projection (P2 @ R0 @ Tr)."""
        return self.P2 @ self.R0 @ self.velo_to_cam

    def to_numpy(self) -> "Calib":
        return Calib(*(np.asarray(m) for m in self))


def read_calib(path: str) -> Calib:
    """Parse a KITTI calib .txt into 4x4 matrices: Tr and P2 get a
    [0,0,0,1] row, R0_rect is embedded into the top-left 3x3 of a 4x4
    with [3,3] = 1."""
    mats = {}
    with open(path, "r") as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            key, _, vals = line.partition(" ")
            key = key.rstrip(":")
            mats[key] = np.array(vals.split(), dtype=np.float32)

    v2c = np.concatenate(
        [mats["Tr_velo_to_cam"].reshape(3, 4),
         [[0, 0, 0, 1]]], axis=0).astype(np.float32)
    p2 = np.concatenate(
        [mats["P2"].reshape(3, 4), [[0, 0, 0, 1]]], axis=0).astype(np.float32)
    r0 = np.zeros((4, 4), dtype=np.float32)
    r0[:3, :3] = mats["R0_rect"].reshape(3, 3)
    r0[3, 3] = 1.0
    return Calib(velo_to_cam=v2c, P2=p2, R0=r0)


def _homogeneous(points: np.ndarray) -> np.ndarray:
    ones = np.ones_like(points[:, :1])
    return np.concatenate([points[:, :3], ones], axis=1)


def lidar_to_cam_rect(points: np.ndarray, calib: Calib) -> np.ndarray:
    """(N, 3+) LiDAR points -> (N, 3) rectified-camera-frame points."""
    p = _homogeneous(points)
    out = (calib.R0 @ calib.velo_to_cam @ p.T).T
    return out[:, :3]


def lidar_to_image(points: np.ndarray, calib: Calib,
                   keep_all: bool = True) -> np.ndarray:
    """Project (N, 3+) LiDAR points to image pixels, returned as (N, 2)
    (u, v) = (width coord, height coord).  ``keep_all=False`` drops points
    behind the camera."""
    p = _homogeneous(points)
    cam = (calib.R0 @ calib.velo_to_cam @ p.T)
    if not keep_all:
        cam = cam[:, cam[2] > 0]
    img = calib.P2 @ cam
    depth = img[2]
    uv = img[:2] / np.where(np.abs(depth) < 1e-9, 1e-9, depth)
    return uv.T


def lidar_depths(points: np.ndarray, calib: Calib) -> np.ndarray:
    """Camera-frame depth of each LiDAR point (for frustum masks)."""
    return lidar_to_cam_rect(points, calib)[:, 2]


def rect_to_lidar(points: np.ndarray, calib: Calib) -> np.ndarray:
    """Inverse chain: (N, 3) P2-frame points back to LiDAR."""
    inv = np.linalg.inv
    p = _homogeneous(points)
    out = (inv(calib.velo_to_cam) @ inv(calib.R0) @ inv(calib.P2) @ p.T).T
    return out[:, :3]
