"""Box geometry on tensors: BEV corners, rotated BEV IoU, delta decoding.

Port of the parts of ``mvxnet_makise_tpu/geometry/boxes.py`` the
inference tail uses.  Box convention: ``(x, y, z, l, w, h, r)`` in LiDAR
coordinates, ``z`` = box bottom, ``r`` = yaw; corners follow the
reference's row-vector rotation ``[[c, -s], [s, c]]``.
"""

from __future__ import annotations

import torch

# Base BEV square in (l, w) units, counter-clockwise winding.
_BASE_CORNERS = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def boxes3d_to_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) xyzlwhr -> (..., 4, 2) BEV corner quads (CCW)."""
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    base = torch.tensor(_BASE_CORNERS, dtype=boxes.dtype,
                        device=boxes.device)
    px = base[:, 0] * boxes[..., 3:4]                              # (..., 4)
    py = base[:, 1] * boxes[..., 4:5]
    rx = px * c[..., None] + py * s[..., None]
    ry = -px * s[..., None] + py * c[..., None]
    return torch.stack([rx + boxes[..., 0:1], ry + boxes[..., 1:2]], dim=-1)


def _clipped_edges(qa: torch.Tensor, qb: torch.Tensor, lim: float):
    """Clip each (CCW) edge of qa to the part inside qb, as parameter
    intervals.  ``lim`` sets the inside rule (signed distance >= -lim).
    Returns (cross_sum, closure): the sum of cross(A, B) over kept
    sub-segments and the sum of (B - A)."""
    p0 = qa                                   # (..., 4, 2) edge starts
    d = torch.roll(qa, -1, dims=-2) - p0

    b0 = qb[..., None, :, :]                  # (..., 1, 4, 2) clip edges
    e = torch.roll(qb, -1, dims=-2)[..., None, :, :] - b0

    rel0 = p0[..., :, None, :] - b0           # (..., 4 edges, 4 planes, 2)
    da = e[..., 0] * rel0[..., 1] - e[..., 1] * rel0[..., 0]
    reld = d[..., :, None, :]
    db = da + e[..., 0] * reld[..., 1] - e[..., 1] * reld[..., 0]

    denom = da - db
    t_cross = da / torch.where(denom.abs() < 1e-12,
                               torch.full_like(denom, 1e-12), denom)
    in_a = da >= -lim
    in_b = db >= -lim
    zero, one = torch.zeros_like(da), torch.ones_like(da)
    lo = torch.where(in_a, zero, torch.where(in_b, t_cross, one))
    hi = torch.where(in_b, one, torch.where(in_a, t_cross, zero))
    t0 = lo.amax(dim=-1)                      # (..., 4)
    t1 = hi.amin(dim=-1)
    keep = t1 > t0

    a_pt = p0 + t0[..., None] * d
    b_pt = p0 + t1[..., None] * d
    cross = a_pt[..., 0] * b_pt[..., 1] - a_pt[..., 1] * b_pt[..., 0]
    cross_sum = torch.where(keep, cross, torch.zeros_like(cross)).sum(-1)
    seg = torch.where(keep[..., None], b_pt - a_pt,
                      torch.zeros_like(b_pt))
    return cross_sum, seg.sum(-2)


def quad_intersection_area(q1: torch.Tensor,
                           q2: torch.Tensor) -> torch.Tensor:
    """Batched intersection area of CCW quads (..., 4, 2) -> (...,).

    By Green's theorem, 2*area = sum of cross(A, B) over the boundary's
    directed segments in any order, and those segments are the parts of
    q1's edges inside q2 plus the parts of q2's edges inside q1.
    Coincident boundary pieces count once (q1 pass inclusive, q2 pass
    strict); an open boundary (zero-area contact) forces the area to 0.
    """
    q1, q2 = torch.broadcast_tensors(q1, q2)
    lim = 1e-6
    s1, c1 = _clipped_edges(q1, q2, lim)
    s2, c2 = _clipped_edges(q2, q1, -lim)
    defect = (c1 + c2).abs().sum(-1)
    area = torch.clamp(0.5 * (s1 + s2), min=0.0)
    return torch.where(defect < 1e-3, area, torch.zeros_like(area))


def rotated_iou_bev(boxes1: torch.Tensor,
                    boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU.  boxes1 (N, 7), boxes2 (M, 7) -> (N, M)."""
    q1 = boxes3d_to_bev_corners(boxes1)
    q2 = boxes3d_to_bev_corners(boxes2)
    a1 = boxes1[:, 3] * boxes1[:, 4]
    a2 = boxes2[:, 3] * boxes2[:, 4]
    inter = quad_intersection_area(q1[:, None], q2[None, :])
    union = a1[:, None] + a2[None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of the training encoder: xy scaled by the anchor BEV
    diagonal, z by anchor height, log size ratios, additive yaw."""
    d = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    xy = deltas[..., 0:2] * d[..., None] + anchors[..., 0:2]
    z = deltas[..., 2:3] * anchors[..., 5:6] + anchors[..., 2:3]
    lwh = torch.exp(deltas[..., 3:6]) * anchors[..., 3:6]
    r = deltas[..., 6:7] + anchors[..., 6:7]
    return torch.cat([xy, z, lwh, r], dim=-1)
