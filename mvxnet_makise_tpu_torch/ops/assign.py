"""Anchor grid, the assignment-window bound, and dense target assignment.

Port of ``mvxnet_makise_tpu/ops/assign.py``: numpy copies of
``create_anchors`` and ``min_assign_window``, and
:func:`assign_anchor_targets` on tensors.  Each GT evaluates a fixed window
of anchor cells around its centre cell in one batched rotated-IoU pass,
then a scatter-max writes the dense positive / ignore / match maps (a max,
so the result does not depend on the order of the writes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mvxnet_makise_tpu_torch.geometry.boxes import (
    boxes3d_to_bev_corners,
    quad_intersection_area,
)
from mvxnet_makise_tpu_torch.utils.profiling import sync_point


class AnchorTargets(NamedTuple):
    pos: torch.Tensor       # (H, W, A) bool — IoU >= pos_thr with some GT
    ignore: torch.Tensor    # (H, W, A) bool — IoU >= neg_thr (superset)
    gt_index: torch.Tensor  # (H, W, A) int32 — matched GT (-1 where not pos)


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

    The bisection takes ~0.2 s of host time, and every frame of every
    train step checks its window (JAX checks it once, while tracing), so
    the result is kept per footprint and grid.
    """
    return _min_assign_window(
        tuple(int(g) for g in grid_hw), tuple(float(v) for v in velo_range),
        tuple(float(b) for b in box_size), float(neg_threshold),
        float(max_gt_scale))


@functools.lru_cache(maxsize=64)
def _min_assign_window(grid_hw, velo_range, box_size, neg_threshold,
                       max_gt_scale) -> int:
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


def assign_anchor_targets(gt_boxes: torch.Tensor,
                          gt_mask: torch.Tensor,
                          *,
                          grid_hw: Sequence[int],
                          velo_range: Sequence[float],
                          box_size: Sequence[float],
                          neg_threshold,
                          pos_threshold,
                          window: int = 12,
                          anchor_z: float = -1.0,
                          yaws: Sequence[float] = (0.0, np.pi / 2),
                          gt_classes: Optional[torch.Tensor] = None,
                          best_anchor_fallback: bool = False,
                          ) -> AnchorTargets:
    """Dense windowed anchor<->GT assignment for one frame.

    Single-class when ``box_size`` is one (l, w, h) triple.  Multi-class
    when it is a list of per-class sizes: each class's GTs (``gt_classes``
    (G,) int) compete only for that class's anchor slots, and the slot axis
    is len(sizes) * len(yaws) in :func:`create_anchors` order.
    ``neg/pos_threshold`` may be scalars or per-class sequences.

    Args:
      gt_boxes: (G, 7) xyzlwhr, padded; gt_mask: (G,) bool.
      window: half-width in cells of the IoU window around each GT centre
        cell; refused when it cannot cover every anchor that reaches
        IoU >= neg_threshold (:func:`min_assign_window`).
    """
    sizes = np.asarray(box_size, dtype=np.float32)
    if sizes.ndim == 2:  # multi-class
        n_cls = len(sizes)
        negs = (np.broadcast_to(neg_threshold, (n_cls,))
                if np.ndim(neg_threshold) == 0 else np.asarray(neg_threshold))
        poss = (np.broadcast_to(pos_threshold, (n_cls,))
                if np.ndim(pos_threshold) == 0 else np.asarray(pos_threshold))
        parts = []
        for c in range(n_cls):
            cmask = gt_mask if gt_classes is None else (
                gt_mask & (gt_classes == c))
            parts.append(_assign_one_class(
                gt_boxes, cmask, grid_hw=grid_hw, velo_range=velo_range,
                box_size=tuple(sizes[c]), neg_threshold=float(negs[c]),
                pos_threshold=float(poss[c]), window=window,
                anchor_z=anchor_z, yaws=yaws,
                best_anchor_fallback=best_anchor_fallback))
        return AnchorTargets(*(torch.cat(field, dim=-1)
                               for field in zip(*parts)))
    return _assign_one_class(
        gt_boxes, gt_mask, grid_hw=grid_hw, velo_range=velo_range,
        box_size=box_size, neg_threshold=neg_threshold,
        pos_threshold=pos_threshold, window=window, anchor_z=anchor_z,
        yaws=yaws, best_anchor_fallback=best_anchor_fallback)


def _scatter_max(idx: torch.Tensor, values: torch.Tensor, init: int,
                 size: int) -> torch.Tensor:
    """Max of ``values`` per flat index over a buffer of ``size`` + 1
    (the last entry is the drop bucket), returned without it."""
    buf = torch.full((size + 1,), init, dtype=values.dtype,
                     device=values.device)
    buf.scatter_reduce_(0, idx.reshape(-1), values.reshape(-1), "amax",
                        include_self=True)
    return buf[:-1]


def _assign_one_class(gt_boxes: torch.Tensor,
                      gt_mask: torch.Tensor,
                      *,
                      grid_hw: Sequence[int],
                      velo_range: Sequence[float],
                      box_size: Sequence[float],
                      neg_threshold: float,
                      pos_threshold: float,
                      window: int,
                      anchor_z: float,
                      yaws: Sequence[float],
                      best_anchor_fallback: bool = False,
                      ) -> AnchorTargets:
    """Windowed IoU pass for one anchor footprint (see caller)."""
    required = min_assign_window(grid_hw, velo_range, box_size,
                                 neg_threshold)
    if window < required:
        raise ValueError(
            f"assign_window={window} under-covers: anchors up to "
            f"{required} cells from a GT centre cell can still reach "
            f"IoU >= {neg_threshold} for footprint {tuple(box_size[:2])} "
            f"on this grid. Use window >= {required}.")
    H, W = grid_hw
    A = len(yaws)
    G = gt_boxes.shape[0]
    dev, dtype = gt_boxes.device, gt_boxes.dtype
    x0, y0 = velo_range[0], velo_range[1]
    ls = (velo_range[3] - x0) / H
    ws = (velo_range[4] - y0) / W
    K = 2 * window + 1

    # GT centre cell
    nl = torch.floor((gt_boxes[:, 0] - x0 - ls / 2) / ls + 0.5).to(
        torch.int32)
    nw = torch.floor((gt_boxes[:, 1] - y0 - ws / 2) / ws + 0.5).to(
        torch.int32)

    offs = torch.arange(-window, window + 1, dtype=torch.int32, device=dev)
    ci = (nl[:, None, None] + offs[None, :, None]).expand(G, K, K)
    cj = (nw[:, None, None] + offs[None, None, :]).expand(G, K, K)
    in_grid = (ci >= 0) & (ci < H) & (cj >= 0) & (cj < W)

    ax = x0 + ls / 2 + ci.to(dtype) * ls                    # (G, K, K)
    ay = y0 + ws / 2 + cj.to(dtype) * ws
    # copies from pageable host memory: each waits for the card
    with sync_point():
        yaw = torch.tensor(yaws, dtype=dtype, device=dev)
    with sync_point():
        size = torch.tensor(tuple(box_size), dtype=dtype, device=dev)
    shape = (G, K, K, A)
    anchor_boxes = torch.cat([
        ax[..., None, None].expand(*shape, 1),
        ay[..., None, None].expand(*shape, 1),
        torch.full((*shape, 1), anchor_z, dtype=dtype, device=dev),
        size.expand(*shape, 3),
        yaw[:, None].expand(*shape, 1),
    ], dim=-1)                                              # (G,K,K,A,7)

    gt_quads = boxes3d_to_bev_corners(gt_boxes)             # (G, 4, 2)
    anchor_quads = boxes3d_to_bev_corners(anchor_boxes)     # (G,K,K,A,4,2)
    inter = quad_intersection_area(gt_quads[:, None, None, None],
                                   anchor_quads)            # (G, K, K, A)

    gt_area = gt_boxes[:, 3] * gt_boxes[:, 4]
    anchor_area = float(box_size[0]) * float(box_size[1])
    union = gt_area[:, None, None, None] + anchor_area - inter
    iou = inter / torch.clamp(union, min=1e-12)

    valid = in_grid[..., None] & gt_mask[:, None, None, None]
    q_pos = valid & (iou >= pos_threshold)
    q_ign = valid & (iou >= neg_threshold)

    a_ids = torch.arange(A, device=dev)
    flat_idx = (ci[..., None] * W + cj[..., None]) * A + a_ids
    dump = H * W * A
    safe_idx = torch.where(in_grid[..., None], flat_idx,
                           torch.full_like(flat_idx, dump)).long()

    def scatter_max(values, init):
        return _scatter_max(safe_idx, values, init, dump).reshape(H, W, A)

    pos = scatter_max(q_pos.to(torch.int32), 0) > 0
    ignore = scatter_max(q_ign.to(torch.int32), 0) > 0
    # the highest qualifying GT index wins (the reference's last writer)
    g_ids = torch.arange(G, dtype=torch.int32, device=dev)
    gids = torch.where(q_pos, g_ids[:, None, None, None],
                       torch.full_like(g_ids[:, None, None, None], -1))
    gt_index = scatter_max(gids, -1)

    if best_anchor_fallback:
        # each valid GT's highest-IoU anchor becomes positive (and leaves
        # the negative pool) regardless of threshold
        iou_flat = torch.where(valid, iou,
                               torch.full_like(iou, -1.0)).reshape(G, -1)
        best = torch.argmax(iou_flat, dim=1)                  # (G,)
        best_iou = torch.gather(iou_flat, 1, best[:, None])[:, 0]
        ok = gt_mask & (best_iou > 0.0)
        bidx = torch.gather(safe_idx.reshape(G, -1), 1, best[:, None])[:, 0]
        bsafe = torch.where(ok, bidx, torch.full_like(bidx, dump))
        fb = _scatter_max(bsafe, torch.ones_like(g_ids), 0,
                          dump).reshape(H, W, A) > 0
        fb_gid = _scatter_max(
            bsafe, torch.where(ok, g_ids, torch.full_like(g_ids, -1)), -1,
            dump).reshape(H, W, A)
        pos = pos | fb
        ignore = ignore | fb
        gt_index = torch.maximum(gt_index, fb_gid)
    return AnchorTargets(pos=pos, ignore=ignore, gt_index=gt_index)
