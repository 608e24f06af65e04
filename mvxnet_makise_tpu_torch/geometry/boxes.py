"""Box geometry on tensors: corners, rotated BEV and 3D IoU, delta
coding, camera <-> LiDAR label conversion.

Port of ``mvxnet_makise_tpu/geometry/boxes.py``.  Box convention:
``(x, y, z, l, w, h, r)`` in LiDAR coordinates, ``z`` = box bottom, ``r`` =
yaw; corners follow the reference's row-vector rotation
``[[c, -s], [s, c]]``.  The label conversions and the 2D intersection take
numpy arrays or tensors and return the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

from mvxnet_makise_tpu_torch.utils.profiling import sync_point

# Base BEV square in (l, w) units, counter-clockwise winding.
_BASE_CORNERS = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def boxes3d_to_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) xyzlwhr -> (..., 4, 2) BEV corner quads (CCW)."""
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    with sync_point():   # a copy from pageable host memory
        base = torch.tensor(_BASE_CORNERS, dtype=boxes.dtype,
                            device=boxes.device)
    px = base[:, 0] * boxes[..., 3:4]                              # (..., 4)
    py = base[:, 1] * boxes[..., 4:5]
    rx = px * c[..., None] + py * s[..., None]
    ry = -px * s[..., None] + py * c[..., None]
    return torch.stack([rx + boxes[..., 0:1], ry + boxes[..., 1:2]], dim=-1)


def boxes3d_to_corners3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3) 3D corners; top 4 (z + h) then bottom 4."""
    bev = boxes3d_to_bev_corners(boxes)
    z = boxes[..., 2:3].expand(bev.shape[:-1])[..., None]
    h = boxes[..., 5:6].expand(bev.shape[:-1])[..., None]
    return torch.cat([torch.cat([bev, z + h], dim=-1),
                      torch.cat([bev, z], dim=-1)], dim=-2)


def polygon_area(verts: torch.Tensor, count) -> torch.Tensor:
    """Shoelace area of CCW polygons in fixed (..., V, 2) buffers with
    ``count`` valid vertices (an int or a (...,) tensor); slots >= count
    count as vertex 0 (duplicates contribute zero)."""
    V = verts.shape[-2]
    idx = torch.arange(V, device=verts.device)
    valid = idx < torch.as_tensor(count, device=verts.device)[..., None]
    verts = torch.where(valid[..., None], verts, verts[..., :1, :])
    nxt = torch.roll(verts, -1, dims=-2)
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    return 0.5 * cross.sum(-1)


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
    """Pairwise rotated BEV IoU.  boxes1 (..., N, 7), boxes2 (..., M, 7)
    -> (..., N, M), the leading dimensions broadcast."""
    q1 = boxes3d_to_bev_corners(boxes1)
    q2 = boxes3d_to_bev_corners(boxes2)
    a1 = boxes1[..., 3] * boxes1[..., 4]
    a2 = boxes2[..., 3] * boxes2[..., 4]
    inter = quad_intersection_area(q1[..., :, None, :, :],
                                   q2[..., None, :, :, :])
    union = a1[..., :, None] + a2[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def corners_iou_bev(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU from corner quads directly: (N,4,2),(M,4,2)->(N,M)."""
    a1, a2 = polygon_area(q1, 4), polygon_area(q2, 4)
    inter = quad_intersection_area(q1[:, None], q2[None, :])
    union = a1[:, None] + a2[None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def rotated_iou_3d(boxes1: torch.Tensor,
                   boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU: rotated BEV intersection x vertical overlap.
    boxes1 (N, 7), boxes2 (M, 7) with z = box bottom -> (N, M)."""
    q1 = boxes3d_to_bev_corners(boxes1)
    q2 = boxes3d_to_bev_corners(boxes2)
    inter_bev = quad_intersection_area(q1[:, None], q2[None, :])
    zlo = torch.maximum(boxes1[:, None, 2], boxes2[None, :, 2])
    zhi = torch.minimum(boxes1[:, None, 2] + boxes1[:, None, 5],
                        boxes2[None, :, 2] + boxes2[None, :, 5])
    inter = inter_bev * torch.clamp(zhi - zlo, min=0.0)
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    union = v1[:, None] + v2[None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Delta-encode GT boxes against anchors (both (..., 7) xyzlwhr): xy
    normalized by the anchor BEV diagonal, z by anchor height, log size
    ratios, additive yaw delta."""
    d = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    t_xy = (gt[..., 0:2] - anchors[..., 0:2]) / d[..., None]
    t_z = (gt[..., 2:3] - anchors[..., 2:3]) / anchors[..., 5:6]
    t_lwh = torch.log(torch.clamp(gt[..., 3:6], min=1e-6)
                      / torch.clamp(anchors[..., 3:6], min=1e-6))
    t_r = gt[..., 6:7] - anchors[..., 6:7]
    return torch.cat([t_xy, t_z, t_lwh, t_r], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`: xy scaled by the anchor BEV
    diagonal, z by anchor height, log size ratios, additive yaw."""
    d = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    xy = deltas[..., 0:2] * d[..., None] + anchors[..., 0:2]
    z = deltas[..., 2:3] * anchors[..., 5:6] + anchors[..., 2:3]
    lwh = torch.exp(deltas[..., 3:6]) * anchors[..., 3:6]
    r = deltas[..., 6:7] + anchors[..., 6:7]
    return torch.cat([xy, z, lwh, r], dim=-1)


def _transform_xyz(xyz: "np.ndarray | torch.Tensor", matrix):
    """(N, 3) points through a 4x4 homogeneous ``matrix`` (numpy), in the
    points' own kind and dtype."""
    if isinstance(xyz, torch.Tensor):
        m = torch.as_tensor(np.asarray(matrix), dtype=xyz.dtype,
                            device=xyz.device)
        xyz1 = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    else:
        m = matrix
        xyz1 = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=1)
    return (m @ xyz1.T).T[:, :3]


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate(parts, axis=1)


def boxes_cam_to_lidar(cam_boxes, cam_to_velo):
    """KITTI label boxes (N, 7) 'h w l x y z ry' (camera frame) -> (N, 7)
    'x y z l w h r' in the LiDAR frame: position through
    inv(Tr_velo_to_cam) (the rectification is not undone, as in the
    reference), dims h,w,l -> l,w,h, yaw r = ry - pi/2.  Numpy or
    tensor in, the same kind out."""
    xyz = _transform_xyz(cam_boxes[:, 3:6], cam_to_velo)
    return _cat([xyz, cam_boxes[:, [2, 1, 0]],
                 cam_boxes[:, 6:7] - 0.5 * np.pi])


def boxes_lidar_to_cam(lidar_boxes, velo_to_cam):
    """Inverse of :func:`boxes_cam_to_lidar`: (N,7) xyzlwhr -> hwlxyzr."""
    xyz = _transform_xyz(lidar_boxes[:, 0:3], velo_to_cam)
    return _cat([lidar_boxes[:, [5, 4, 3]], xyz,
                 lidar_boxes[:, 6:7] + 0.5 * np.pi])


def aligned_bbox_intersection(b1, b2):
    """Pairwise intersection area of xyxy boxes: (N,4),(M,4)->(N,M);
    numpy or tensors."""
    if isinstance(b1, torch.Tensor):
        lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
        rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
        wh = torch.clamp(rb - lt, min=0)
    else:
        lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
        rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
    return wh[..., 0] * wh[..., 1]
