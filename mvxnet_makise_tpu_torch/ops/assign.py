"""Anchor grid and the assignment-window bound, in numpy.

Copies of ``create_anchors`` and ``min_assign_window`` from
``mvxnet_makise_tpu/ops/assign.py``; the target assignment itself comes
with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _lens_area(r1: float, r2: float, d: np.ndarray) -> np.ndarray:
    """Intersection area of two circles (radii r1, r2, centre distance d)."""
    d = np.asarray(d, dtype=np.float64)
    full = np.pi * min(r1, r2) ** 2
    if r1 > r2:
        r1, r2 = r2, r1
    out = np.where(d >= r1 + r2, 0.0, full)
    mid = (d > r2 - r1) & (d < r1 + r2)
    dm = np.where(mid, d, (r1 + r2) / 2)  # dummy to keep arccos in range
    a1 = np.clip((dm**2 + r1**2 - r2**2) / (2 * dm * r1), -1, 1)
    a2 = np.clip((dm**2 + r2**2 - r1**2) / (2 * dm * r2), -1, 1)
    lens = (r1**2 * np.arccos(a1) + r2**2 * np.arccos(a2)
            - 0.5 * np.sqrt(np.maximum(
                (-dm + r1 + r2) * (dm + r1 - r2)
                * (dm - r1 + r2) * (dm + r1 + r2), 0.0)))
    return np.where(mid, lens, out)


def min_assign_window(grid_hw: Sequence[int],
                      velo_range: Sequence[float],
                      box_size: Sequence[float],
                      neg_threshold: float,
                      max_gt_scale: float = 3.0) -> int:
    """Minimum window half-width (in cells) that provably covers every
    anchor able to reach ``IoU >= neg_threshold`` with any GT box.

    Boxes lie inside their circumscribed circles, so box-intersection <=
    circle-lens area, while IoU >= t forces intersection >= t/(1+t) *
    (A_gt + A_anchor).  The largest centre distance satisfying both —
    maximised over GT footprint scales up to ``max_gt_scale``x the anchor
    footprint — converts to cells (plus half a cell for the GT's rounding
    to its centre cell).
    """
    H, W = grid_hw
    ls = (velo_range[3] - velo_range[0]) / H
    ws = (velo_range[4] - velo_range[1]) / W
    cell = min(ls, ws)
    l_a, w_a = float(box_size[0]), float(box_size[1])
    r_a = 0.5 * np.hypot(l_a, w_a)
    area_a = l_a * w_a
    t = float(neg_threshold)

    d_max = 0.0
    for s in np.linspace(0.05, max_gt_scale, 120):
        r_g, area_g = s * r_a, s * s * area_a
        need = t / (1.0 + t) * (area_g + area_a)
        if _lens_area(r_a, r_g, np.array(0.0)) < need:
            continue  # this GT scale can never reach IoU >= t
        lo, hi = 0.0, r_a + r_g
        for _ in range(60):
            mid = (lo + hi) / 2
            if _lens_area(r_a, r_g, np.array(mid)) >= need:
                lo = mid
            else:
                hi = mid
        d_max = max(d_max, lo)
    return int(np.ceil(d_max / cell + 0.5))


def create_anchors(grid_hw: Sequence[int],
                   velo_range: Sequence[float],
                   box_size: Sequence[float],
                   anchor_z: float = -1.0,
                   yaws: Sequence[float] = (0.0, np.pi / 2)) -> np.ndarray:
    """Anchor grid (H, W, A, 7) xyzlwhr: centres at cell midpoints of an
    (H, W) grid over the BEV range, z = -1 (box bottom), yaws 0 and pi/2.
    ``box_size`` may be a list of sizes (multi-class): the slot axis is
    then ordered [cls0_yaw0, cls0_yaw90, cls1_yaw0, ...]."""
    H, W = grid_hw
    sizes = np.asarray(box_size, dtype=np.float32)
    if sizes.ndim == 1:
        sizes = sizes[None]
    x0, y0, _, x1, y1, _ = velo_range
    ls, ws = (x1 - x0) / H, (y1 - y0) / W
    xs = x0 + ls / 2 + ls * np.arange(H, dtype=np.float32)
    ys = y0 + ws / 2 + ws * np.arange(W, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    A = len(sizes) * len(yaws)
    anchors = np.zeros((H, W, A, 7), dtype=np.float32)
    anchors[..., 0] = gx[..., None]
    anchors[..., 1] = gy[..., None]
    anchors[..., 2] = anchor_z
    for c, size in enumerate(sizes):
        sl = slice(c * len(yaws), (c + 1) * len(yaws))
        anchors[..., sl, 3:6] = size
        anchors[..., sl, 6] = np.asarray(yaws, dtype=np.float32)
    return anchors
