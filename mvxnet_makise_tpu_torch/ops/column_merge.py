"""K1: the fused column merge — CUDA kernel, plain version, column bounds.

Port of ``merge_taps_fused`` (``mvxnet_makise_tpu/ops/pallas_column_merge
.py``), forward only: CML conv1's 9 spatial taps per active BEV column are
summed into the dense output with the conv's bias, ReLU and the per-row
standardize statistics fused in.  :func:`merge_taps_fused` launches the
CUDA kernel (``csrc/column_merge.cu``) for CUDA tensors and runs
:func:`merge_taps_fused_plain` for CPU tensors; the plain version follows
the JAX spec ``_merge_fused_reference``.  The backward comes with the
training slice.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from mvxnet_makise_tpu_torch.ops.cuda_build import (
    CudaKernel,
    ptr,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
KERNEL = CudaKernel("column_merge", "column_merge.cu",
                    {"merge_fused_f32": _ARGS, "merge_fused_bf16": _ARGS})
_LAUNCHERS = {torch.float32: "merge_fused_f32",
              torch.bfloat16: "merge_fused_bf16"}
# the kernel keeps 3 x (ny + 2) int32 slot ids in shared memory
_MAX_SHARED = 48 * 1024


def column_bounds(col_xy: torch.Tensor, col_mask: torch.Tensor,
                  nx: int) -> torch.Tensor:
    """Per-cx start offsets into the sorted column list.

    col_xy: (B, V, 2) int32 (cx, cy) sorted by (cx, cy), -1 padding;
    returns (B, nx+1) int32 with bounds[b, i] = first slot with cx >= i
    and bounds[b, nx] = number of active columns."""
    cx = torch.where(col_mask, col_xy[..., 0],
                     torch.full_like(col_xy[..., 0], nx))
    edges = torch.arange(nx + 1, dtype=cx.dtype, device=cx.device)
    edges = edges.expand(cx.shape[0], nx + 1).contiguous()
    return torch.searchsorted(cx.contiguous(), edges,
                              right=False).to(torch.int32)


def merge_taps_fused_plain(y: torch.Tensor, col_cy: torch.Tensor,
                           bounds: torch.Tensor, bias_packed: torch.Tensor,
                           grid_shape: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: 9 scatter-adds, then bias, ReLU and the
    per-row sums, accumulated in at least float32.  Same outputs as the
    kernel (see :func:`merge_taps_fused`)."""
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    acc = torch.promote_types(y.dtype, torch.float32)
    dev = y.device
    col_ids = torch.arange(V, dtype=bounds.dtype, device=dev)
    cx = torch.searchsorted(bounds.contiguous(),
                            col_ids.expand(B, V).contiguous(),
                            right=True) - 1
    live = col_ids[None, :] < bounds[:, nx:nx + 1]
    cy = col_cy.to(cx.dtype)
    dump = nx * ny
    out = torch.zeros((B, dump + 1, R), dtype=acc, device=dev)
    for kh in range(3):
        ox = cx + 1 - kh
        for kw in range(3):
            oy = cy + 1 - kw
            ok = live & (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
            idx = torch.where(ok, ox * ny + oy, torch.full_like(ox, dump))
            out.scatter_add_(1, idx[..., None].expand(B, V, R).long(),
                             y[:, :, kh * 3 + kw, :].to(acc))
    merged = out[:, :dump].reshape(B, nx, ny, R).to(y.dtype)
    emitted = torch.clamp(merged.to(acc) + bias_packed.to(acc), min=0.0)
    stats = torch.stack([emitted.sum(dim=2),
                         (emitted * emitted).sum(dim=2)], dim=2)
    return emitted.to(y.dtype), stats


def merge_taps_fused(y: torch.Tensor, col_cy: torch.Tensor,
                     bounds: torch.Tensor, bias_packed: torch.Tensor,
                     grid_shape: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tap merge with the dense-conv epilogue fused in.

    Args:
      y: (B, V, 9, R) per-column per-tap rows (tap t = kh*3+kw), columns
        sorted by (cx, cy); float32 or bfloat16 on the card.
      col_cy: (B, V) int32 — cy of each column slot.
      bounds: (B, nx+1) int32 — :func:`column_bounds`.
      bias_packed: (R,) float32 — the conv bias tiled to the d-major lanes.
      grid_shape: (nx, ny, nz).

    Returns:
      out: (B, nx, ny, R) = relu(merge(y) + bias), y.dtype;
      stats: (B, nx, 2, R) float32 — per output row [sum, sum_sq] of out
        over ny.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if y.device.type == "cpu":
        return merge_taps_fused_plain(y, col_cy, bounds, bias_packed,
                                      grid_shape)
    if y.device.type != "cuda":
        raise ValueError(f"merge_taps_fused: unsupported device {y.device}")
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    if y.dim() != 4 or y.shape[2] != 9:
        raise ValueError(f"y must be (B, V, 9, R), got {tuple(y.shape)}")
    B, V, _, R = y.shape
    if y.dtype not in _LAUNCHERS:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    expect = {"col_cy": (col_cy, (B, V), torch.int32),
              "bounds": (bounds, (B, nx + 1), torch.int32),
              "bias_packed": (bias_packed, (R,), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {y.device}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if 3 * (ny + 2) * 4 > _MAX_SHARED:
        raise ValueError(f"ny={ny} exceeds the kernel's shared-memory map")

    out = torch.empty((B, nx, ny, R), dtype=y.dtype, device=y.device)
    stats = torch.empty((B, nx, 2, R), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out, stats
    KERNEL.launch(_LAUNCHERS[y.dtype], ptr(y), ptr(col_cy), ptr(bounds),
                  ptr(bias_packed), ptr(out), ptr(stats), B, V, nx, ny, R,
                  stream_handle(y.device))
    return out, stats
