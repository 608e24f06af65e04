"""Host-side (numpy) box geometry for the data pipeline: the port's copy
of ``mvxnet_makise_tpu/geometry/boxes_np.py``.

The augmentation and the GT-database build run on host threads and
never touch the device.  The clipping is Sutherland-Hodgman with the
reference's corner convention, so the paste augmentation's BEV-overlap
gate makes the JAX package's decisions.
"""

from __future__ import annotations

import numpy as np

_BASE = np.array([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]],
                 dtype=np.float32)


def bev_corners(boxes: np.ndarray) -> np.ndarray:
    """(..., 7) xyzlwhr -> (..., 4, 2) CCW quads (reference rotation
    convention, Calc.py:15-37)."""
    boxes = np.asarray(boxes, dtype=np.float32)
    c, s = np.cos(boxes[..., 6]), np.sin(boxes[..., 6])
    px = _BASE[:, 0] * boxes[..., 3:4]
    py = _BASE[:, 1] * boxes[..., 4:5]
    rx = px * c[..., None] + py * s[..., None]
    ry = -px * s[..., None] + py * c[..., None]
    return np.stack([rx + boxes[..., 0:1], ry + boxes[..., 1:2]], axis=-1)


def _clip(poly: np.ndarray, a, b) -> np.ndarray:
    """Clip polygon (list of vertices) by half-plane left of a->b."""
    out = []
    n = len(poly)
    if n == 0:
        return poly
    d = (b[0] - a[0]) * (poly[:, 1] - a[1]) - \
        (b[1] - a[1]) * (poly[:, 0] - a[0])
    for i in range(n):
        j = (i + 1) % n
        if d[i] >= 0:
            out.append(poly[i])
            if d[j] < 0:
                t = d[i] / (d[i] - d[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif d[j] >= 0:
            t = d[i] / (d[i] - d[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out, dtype=np.float32).reshape(-1, 2)


def polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return float(0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def quad_intersection_area(q1: np.ndarray, q2: np.ndarray) -> float:
    poly = q1
    for k in range(4):
        poly = _clip(poly, q2[k], q2[(k + 1) % 4])
        if len(poly) == 0:
            return 0.0
    return abs(polygon_area(poly))


def iou_bev(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise rotated BEV IoU (N, 7) x (M, 7) -> (N, M)."""
    q1 = bev_corners(boxes1)
    q2 = bev_corners(boxes2)
    a1 = boxes1[:, 3] * boxes1[:, 4]
    a2 = boxes2[:, 3] * boxes2[:, 4]
    out = np.zeros((len(boxes1), len(boxes2)), dtype=np.float32)
    for i in range(len(boxes1)):
        for j in range(len(boxes2)):
            inter = quad_intersection_area(q1[i], q2[j])
            out[i, j] = inter / max(a1[i] + a2[j] - inter, 1e-12)
    return out


def iou_bev_corners(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Pairwise IoU from corner quads (N,4,2) x (M,4,2)."""
    out = np.zeros((len(q1), len(q2)), dtype=np.float32)
    a1 = [abs(polygon_area(q)) for q in q1]
    a2 = [abs(polygon_area(q)) for q in q2]
    for i in range(len(q1)):
        for j in range(len(q2)):
            inter = quad_intersection_area(q1[i], q2[j])
            out[i, j] = inter / max(a1[i] + a2[j] - inter, 1e-12)
    return out


def points_in_box3d(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Mask of points inside a rotated 3D box (z = bottom).

    Replaces the reference's Open3D OrientedBoundingBox point crop
    (create_gtdatabase.py:210-215) with three dot products.
    """
    c, s = np.cos(box[6]), np.sin(box[6])
    dx = points[:, 0] - box[0]
    dy = points[:, 1] - box[1]
    # inverse of the corner rotation (row @ [[c,-s],[s,c]])
    lx = dx * c - dy * s
    ly = dx * s + dy * c
    lz = points[:, 2] - box[2]
    return (np.abs(lx) <= box[3] / 2 + 1e-6) & \
           (np.abs(ly) <= box[4] / 2 + 1e-6) & \
           (lz >= -1e-6) & (lz <= box[5] + 1e-6)


def intersection_2d(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Pairwise xyxy intersection areas (N, 4) x (M, 4) -> (N, M)
    (reference modules/utils/Bbox.py)."""
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    return wh[..., 0] * wh[..., 1]
