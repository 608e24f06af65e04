"""The benchmark's one traffic generator: LiDAR scans, camera images and
ground-truth cars, made with numpy from a seed.

A frozen copy of the geometry of ``data/synthetic.py`` (the toy KITTI
camera: at the LiDAR origin, looking along +x, about 80 degrees wide),
widened into full 360-degree scans: ground returns all round the sensor,
walls beside the road, cars in front and behind, and returns beyond the
range.  Every parameter comes from a traffic file
(``perfbench/traffic/<mix>.json``): the number of points in the camera's
view and range and the number outside it, the cars, the images.

Which points lie in the camera's view is decided here, in float64, with a
margin: no point of a scan lies within ``edge_margin_px`` of the image's
border or within ``edge_margin_m`` of the range's far walls.  The program's
host feed decides the same question in float32 (with or without fused
multiply-adds, as its compiler chose), so a point on the border itself
would be in one side's frame and out of the other's.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the toy camera of data/synthetic.toy_calib at a 370 x 1224 image
IMAGE_HW = (370, 1224)


@dataclasses.dataclass(frozen=True)
class Camera:
    """KITTI-like calibration as three 4x4 float32 matrices."""
    velo_to_cam: np.ndarray
    P2: np.ndarray
    R0: np.ndarray

    @property
    def rect(self) -> np.ndarray:
        return (self.R0.astype(np.float64) @ self.velo_to_cam).astype(
            np.float32)

    @property
    def proj(self) -> np.ndarray:
        return (self.P2.astype(np.float64) @ self.R0
                @ self.velo_to_cam).astype(np.float32)


def toy_camera(image_hw: Sequence[int] = IMAGE_HW) -> Camera:
    h, w = image_hw
    f = 720.0 * (w / 1224.0)
    v2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                    [0, 0, 0, 1]], dtype=np.float32)
    p2 = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                   [0, 0, 0, 1]], dtype=np.float32)
    return Camera(velo_to_cam=v2c, P2=p2, R0=np.eye(4, dtype=np.float32))


def project(points: np.ndarray, cam: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """(N, >=3) -> (depth (N,), uv (N, 2)) in float64: camera depth and
    image (col, row) of each point."""
    hom = np.concatenate([points[:, :3].astype(np.float64),
                          np.ones((len(points), 1))], axis=1)
    depth = (hom @ cam.rect.astype(np.float64).T)[:, 2]
    img = hom @ cam.proj.astype(np.float64).T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = img[:, :2] / img[:, 2:3]
    return depth, uv


def in_view(points: np.ndarray, cam: Camera, velo_range, image_hw,
            margin_px: float = 0.0, margin_m: float = 0.0) -> np.ndarray:
    """True where a point lies in the range crop and the camera's view,
    ``margin_px`` inside the image's border and ``margin_m`` inside the
    range's walls (the host feed's half-open semantics, with the
    ``imsize - 1e-3`` bound)."""
    lo = np.asarray(velo_range[:3], np.float64) + margin_m
    hi = np.asarray(velo_range[3:6], np.float64) - margin_m
    xyz = points[:, :3].astype(np.float64)
    ok = np.all((xyz >= lo) & (xyz < hi), axis=1)
    depth, uv = project(points, cam)
    h, w = image_hw
    ok &= depth > margin_m
    ok &= (uv[:, 0] >= margin_px) & (uv[:, 0] < w - 1e-3 - margin_px)
    ok &= (uv[:, 1] >= margin_px) & (uv[:, 1] < h - 1e-3 - margin_px)
    return ok


def out_of_view(points: np.ndarray, cam: Camera, velo_range, image_hw,
                margin_px: float, margin_m: float) -> np.ndarray:
    """True where a point is out of the range crop (compared exactly, as
    the host feed compares float32 coordinates), or behind the camera, or
    off the image, by more than the margins (so that float32 rounding
    cannot bring it in)."""
    lo = np.asarray(velo_range[:3], np.float64)
    hi = np.asarray(velo_range[3:6], np.float64)
    xyz = points[:, :3].astype(np.float64)
    out_range = np.any((xyz < lo) | (xyz >= hi), axis=1)
    depth, uv = project(points, cam)
    h, w = image_hw
    off_image = (depth > margin_m) & (
        (uv[:, 0] < -margin_px) | (uv[:, 0] > w + margin_px)
        | (uv[:, 1] < -margin_px) | (uv[:, 1] > h + margin_px))
    return out_range | (depth < -margin_m) | off_image


def car_boxes(rng: np.random.Generator, n: int, car_size, x_lo: float,
              x_hi: float, spread: float) -> np.ndarray:
    """n ground-standing car boxes (x y z l w h r), centres at x in
    [x_lo, x_hi) and |y| < spread * |x|."""
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = rng.uniform(x_lo, x_hi, n)
    boxes[:, 1] = rng.uniform(-spread, spread, n) * np.abs(boxes[:, 0])
    boxes[:, 2] = rng.uniform(-1.8, -1.4, n)
    boxes[:, 3:6] = np.asarray(car_size, np.float32) * rng.uniform(
        0.9, 1.15, (n, 3)).astype(np.float32)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def box_surface(rng: np.random.Generator, boxes: np.ndarray,
                n: int) -> np.ndarray:
    """n points on the surfaces of ``boxes`` (spread evenly over them)."""
    if len(boxes) == 0 or n <= 0:
        return np.zeros((0, 3))
    b = boxes[rng.integers(0, len(boxes), n)].astype(np.float64)
    local = rng.uniform(-0.5, 0.5, (n, 3))
    face = rng.integers(0, 3, n)
    local[np.arange(n), face] = rng.choice([-0.5, 0.5], n)
    local *= b[:, 3:6]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    rx = local[:, 0] * c + local[:, 1] * s
    ry = -local[:, 0] * s + local[:, 1] * c
    return np.stack([rx + b[:, 0], ry + b[:, 1],
                     local[:, 2] + b[:, 2] + b[:, 5] / 2], axis=1)


def ground(rng: np.random.Generator, n: int, r_lo: float, r_hi: float,
           az_lo: float, az_hi: float) -> np.ndarray:
    """n ground returns at ranges [r_lo, r_hi) (denser near the sensor:
    the density of a spinning LiDAR's rings falls as 1/range) and
    azimuths [az_lo, az_hi) radians."""
    r = r_lo * (r_hi / r_lo) ** rng.uniform(0, 1, n)
    az = rng.uniform(az_lo, az_hi, n)
    return np.stack([r * np.cos(az), r * np.sin(az),
                     rng.normal(-1.7, 0.05, n)], axis=1)


def walls(rng: np.random.Generator, n: int, x_lo: float, x_hi: float,
          sides: Sequence[float]) -> np.ndarray:
    """n returns off building fronts along the road at |y| in ``sides``."""
    y = rng.choice(np.asarray(sides, np.float64), n)
    return np.stack([rng.uniform(x_lo, x_hi, n),
                     y + rng.normal(0, 0.1, n),
                     rng.uniform(-1.7, 2.5, n)], axis=1)


@dataclasses.dataclass(frozen=True)
class Frame:
    """One frame of traffic: a raw scan, the camera, the image, the cars
    in the camera's view (the training targets)."""
    scan: np.ndarray          # (N, 4) float32 x y z reflectance
    camera: Camera
    image: Optional[np.ndarray]   # (H, W, 3) float32 in [0, 1]
    boxes: np.ndarray         # (G, 7) float32 cars in view


def _take_in_view(rng, want: int, make, cam, velo_range, image_hw, mpx,
                  mm) -> np.ndarray:
    """``want`` points drawn by ``make(n)`` that lie in view by the
    margins (drawn in rounds until there are enough)."""
    got: List[np.ndarray] = [np.zeros((0, 3), np.float32)]
    have = 0
    while have < want:
        cand = make(max(2 * (want - have), 64)).astype(np.float32)
        cand = cand[in_view(cand, cam, velo_range, image_hw, mpx, mm)]
        got.append(cand)
        have += len(cand)
    return np.concatenate(got)[:want]


def _take_out_of_view(rng, want: int, make, cam, velo_range, image_hw,
                      mpx, mm) -> np.ndarray:
    got: List[np.ndarray] = [np.zeros((0, 3), np.float32)]
    have = 0
    while have < want:
        cand = make(max(2 * (want - have), 64)).astype(np.float32)
        cand = cand[out_of_view(cand, cam, velo_range, image_hw, mpx, mm)]
        got.append(cand)
        have += len(cand)
    return np.concatenate(got)[:want]


def make_frame(rng: np.random.Generator, mix: Dict, velo_range,
               image_hw, car_size) -> Frame:
    """One frame of the mix ``mix`` (a traffic file's parameters)."""
    cam = toy_camera(image_hw)
    mpx, mm = mix["edge_margin_px"], mix["edge_margin_m"]
    n_view = int(rng.integers(mix["view_points"][0],
                              mix["view_points"][1] + 1))
    n_out = int(rng.integers(mix["out_of_view_points"][0],
                             mix["out_of_view_points"][1] + 1))
    x_hi = velo_range[3]
    cars = car_boxes(rng, mix["cars_in_view"], car_size, 6.0, 0.9 * x_hi,
                     0.4)
    cars = cars[in_view(cars[:, :3] + np.float32([0, 0, 0.8]), cam,
                        velo_range, image_hw, 1.0, 0.5)]
    half_fov = np.arctan2(image_hw[1] / 2, cam.P2[0, 0])
    n_car = int(n_view * mix["car_share"])
    n_wall = int(n_view * mix["wall_share"])
    parts = [
        _take_in_view(rng, n_car, lambda n: box_surface(rng, cars, n), cam,
                      velo_range, image_hw, mpx, mm),
        _take_in_view(rng, n_wall, lambda n: walls(
            rng, n, 8.0, x_hi, (-12.0, -9.0, 9.0, 14.0)), cam, velo_range,
            image_hw, mpx, mm),
        _take_in_view(rng, n_view - n_car - n_wall, lambda n: ground(
            rng, n, 6.0, 1.1 * x_hi, -half_fov, half_fov), cam, velo_range,
            image_hw, mpx, mm),
    ]
    behind = car_boxes(rng, mix["cars_out_of_view"], car_size, -40.0, -5.0,
                       0.6)
    n_out_cars = n_out // 10 if len(behind) else 0
    parts += [
        _take_out_of_view(rng, n_out_cars, lambda n: box_surface(
            rng, behind, n), cam, velo_range, image_hw, mpx, mm),
        _take_out_of_view(rng, n_out - n_out_cars, lambda n: np.concatenate(
            [ground(rng, n - n // 4, 2.0, 120.0, -np.pi, np.pi),
             walls(rng, n // 4, -60.0, 120.0, (-12.0, -9.0, 9.0, 14.0))]),
            cam, velo_range, image_hw, mpx, mm),
    ]
    xyz = np.concatenate(parts).astype(np.float32)
    # a spinning sensor's sweep: returns in azimuth order
    xyz = xyz[np.argsort(np.arctan2(xyz[:, 1], xyz[:, 0]), kind="stable")]
    refl = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    scan = np.ascontiguousarray(np.concatenate([xyz, refl], axis=1))
    image = None
    if mix["images"]:
        image = rng.random((*image_hw, 3), dtype=np.float32)
    return Frame(scan=scan, camera=cam, image=image, boxes=cars)


def make_pool(seed: int, mix: Dict, velo_range, image_hw,
              car_size) -> List[Frame]:
    """The mix's pool of frames for ``seed``: the same seed gives the same
    frames.  Every seed draws the same number of frames and each frame's
    point counts from the same ranges.  Each frame has a generator of its
    own, spawned from the seed, so the frames are made on a few threads
    (numpy releases the interpreter in its large operations)."""
    root = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    rngs = [np.random.default_rng(s) for s in root.spawn(mix["pool"])]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda r: make_frame(r, mix, velo_range,
                                                image_hw, car_size), rngs))


def view_cloud(frame: Frame, velo_range, image_hw) -> np.ndarray:
    """The frame's points in the range and the camera's view, in scan
    order, as (K, 6) float32 [x y z refl row col] (row and col computed
    in float64, rounded once)."""
    keep = in_view(frame.scan, frame.camera, velo_range, image_hw)
    pts = frame.scan[keep]
    _, uv = project(pts, frame.camera)
    return np.concatenate([pts, uv[:, 1:2], uv[:, 0:1]],
                          axis=1).astype(np.float32)


def train_arrays(frame: Frame, velo_range, image_hw, max_points: int,
                 max_boxes: int, rng: np.random.Generator):
    """The training feed of one frame: (points (P, 6), num_points,
    image, gt_boxes (G, 7), gt_mask (G,), gt_classes (G,), perm (P,)),
    the cloud in scan order and ``perm`` the shuffle the step applies."""
    cloud = view_cloud(frame, velo_range, image_hw)
    n = min(len(cloud), max_points)
    pts = np.zeros((max_points, 6), np.float32)
    pts[:n] = cloud[:n]
    g = min(len(frame.boxes), max_boxes)
    gt = np.zeros((max_boxes, 7), np.float32)
    gt[:g] = frame.boxes[:g]
    mask = np.zeros((max_boxes,), bool)
    mask[:g] = True
    perm = rng.permutation(max_points).astype(np.int64)
    return (pts, np.int32(n), frame.image, gt, mask,
            np.zeros((max_boxes,), np.int32), perm)
