"""Bytes and operations of one call of a hand-written kernel, frozen from
the formulas the port's bring-up used (each input byte read once, each
output byte written once, the work these inputs need), and the least time
the chip needs for them."""

from __future__ import annotations

from typing import Dict, Sequence

from perfbench.accounting import PEAKS


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The larger of bytes over HBM bandwidth and operations over the
    float32 (non-tensor-core) rate: these kernels add and multiply on
    CUDA cores."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_ops / PEAKS["f32_flop_per_s"])


def k1(frames: Sequence[Dict[str, int]], cfg: Dict, elem: int) -> float:
    """Least seconds of K1 (the column merge with bias, ReLU and the
    statistics) on one batch: the taps of live columns read, the column
    index and bounds read, the bias read, the output grid written, the
    per-frame statistics written; one add per present tap, five per
    output cell."""
    nx, ny, nz = cfg["voxel_shape"]
    B, V = len(frames), cfg["max_voxels"]
    R = 64 * ((nz + 2 - 3) // 2 + 1)
    live = sum(f["live_columns"] for f in frames)
    cells = B * nx * ny * R
    n_bytes = (live * 9 * R * elem + B * V * 4 + B * (nx + 1) * 4 + R * 4
               + cells * elem + B * 2 * R * 4)
    return bound_s(n_bytes, live * 9 * R + 5 * cells)


def k1_backward(frames: Sequence[Dict[str, int]], cfg: Dict,
                elem: int) -> float:
    """Least seconds of K1's backward on one batch: the output and its
    cotangent read, the statistics' cotangent, column index and bounds
    read, the taps' cotangent and the bias's gradient written; six
    operations per output cell."""
    nx, ny, nz = cfg["voxel_shape"]
    B, V = len(frames), cfg["max_voxels"]
    R = 64 * ((nz + 2 - 3) // 2 + 1)
    cells = B * nx * ny * R
    n_bytes = (2 * cells * elem + B * 2 * R * 4 + B * V * 4
               + B * (nx + 1) * 4 + B * V * 9 * R * elem + R * 4)
    return bound_s(n_bytes, 6 * cells)


def k2(frames: Sequence[Dict[str, int]], cfg: Dict, elem: int) -> float:
    """Least seconds of K2 (the FPN gather) on one batch: every output row
    written, the points and mask read, each distinct feature cell a kept
    point's taps touch read once; seven operations per gathered value."""
    B, P = len(frames), cfg["max_points"]
    ctot = 3 * 256
    touched = sum(f["k2_touched_cells"] for f in frames) * 256 * elem
    n_bytes = B * P * ctot * elem + B * P * 2 * 4 + B * P + touched
    kept = sum(f["kept_points"] for f in frames)
    return bound_s(n_bytes, kept * ctot * 7)
