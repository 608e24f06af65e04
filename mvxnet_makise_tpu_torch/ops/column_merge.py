"""K1 and K3: the column merge — CUDA kernels, plain versions, gradients.

Port of ``merge_taps_fused`` (K1) and ``merge_taps`` (K3) from
``mvxnet_makise_tpu/ops/pallas_column_merge.py``, with their custom VJPs:
CML conv1's 9 spatial taps per active BEV column are summed into the dense
output; K1 fuses the conv's bias, ReLU and the per-row standardize
statistics in.  For CUDA tensors the wrappers launch the kernels of
``csrc/column_merge.cu`` inside ``torch.autograd.Function``s whose
backwards are kernels too; for CPU tensors they run the plain versions
(:func:`merge_taps_fused_plain`, :func:`merge_taps_plain`), whose gradients
are autograd through the same PyTorch ops.  The plain versions follow the
JAX specs ``_merge_fused_reference`` and ``merge_taps_reference``;
``merge_taps_fused_plain(..., accumulate=torch.float32)`` rounds once, as
the Pallas kernel and the CUDA kernel do in bfloat16.  K1's backward runs
as a first pass (:func:`merge_fused_pre`: pre and dbias) and K3's
backward gather of pre.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mvxnet_makise_tpu_torch.ops.cuda_build import (
    CudaKernel,
    CudaLibrary,
    ptr,
    stream_handle,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUSED = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_TAPS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_FUSED_BWD = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIBRARY = CudaLibrary("column_merge.cu", {
    **{f"{fn}_{suffix}": args for suffix in _DTYPES.values()
       for fn, args in (("merge_fused", _FUSED), ("merge_taps", _TAPS),
                        ("merge_fused_bwd", _FUSED_BWD),
                        ("merge_taps_bwd", _TAPS))},
    "merge_launch_facts": (_I, _I, _I, _I, _P),
    "merge_fused_bwd_facts": (_I, _I, _I, _P)})
KERNEL = CudaKernel("column_merge", LIBRARY)          # K1 forward
BWD_KERNEL = CudaKernel("column_merge_bwd", LIBRARY)  # K1 bwd: pre, dbias
TAPS_KERNEL = CudaKernel("merge_taps", LIBRARY)       # K3 forward
TAPS_BWD_KERNEL = CudaKernel("merge_taps_bwd", LIBRARY)  # K3 backward (dy)
KERNELS = (KERNEL, BWD_KERNEL, TAPS_KERNEL, TAPS_BWD_KERNEL)
# shared memory one block may take on the card (227 KB); the forward keeps
# a tile's slot map there, and K1 its row-statistics partials
_MAX_SHARED = 232448


def launch_facts(y: torch.Tensor, ny: int, fused: bool) -> Tuple[int, int]:
    """(shared bytes per block, oy tiles per row) of the forward kernel's
    launch for y's dtype and lane count; K1 takes a scratch of (B, nx,
    tiles, 2, R) float32 partial row statistics."""
    facts = (ctypes.c_int * 2)()
    LIBRARY.library().merge_launch_facts(int(fused), y.element_size(), ny,
                                         y.shape[-1], facts)
    return facts[0], facts[1]


def backward_launch_facts(out: torch.Tensor, ny: int) -> Tuple[int, int]:
    """(shared bytes per block, segments per row) of K1 backward's first
    pass for out's dtype and lane count; it takes a scratch of (B, nx,
    segments, R) float32 dbias partials."""
    facts = (ctypes.c_int * 2)()
    LIBRARY.library().merge_fused_bwd_facts(out.element_size(), ny,
                                            out.shape[-1], facts)
    return facts[0], facts[1]


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


# ----------------------------------------------------------- plain versions


def _merge_sum(y: torch.Tensor, col_cy: torch.Tensor, bounds: torch.Tensor,
               grid_shape: Sequence[int]) -> torch.Tensor:
    """K3's sum, unrounded: 9 scatter-adds in tap order, accumulated in at
    least float32 and returned in that type."""
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
    return out[:, :dump].reshape(B, nx, ny, R)


def merge_taps_plain(y: torch.Tensor, col_cy: torch.Tensor,
                     bounds: torch.Tensor, grid_shape: Sequence[int]
                     ) -> torch.Tensor:
    """Plain PyTorch version of K3: 9 scatter-adds, accumulated in at
    least float32, returned in y.dtype.  Same contract as
    :func:`merge_taps`; differentiable by autograd."""
    return _merge_sum(y, col_cy, bounds, grid_shape).to(y.dtype)


def merge_taps_fused_plain(y: torch.Tensor, col_cy: torch.Tensor,
                           bounds: torch.Tensor, bias_packed: torch.Tensor,
                           grid_shape: Sequence[int], *,
                           accumulate: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: :func:`merge_taps_plain`, then bias,
    ReLU and the per-row sums, accumulated in at least float32.  Same
    outputs as the kernel (see :func:`merge_taps_fused`).  Its gradient is
    autograd's: ReLU passes the cotangent only where the output is > 0, as
    ``_merge_fused_bwd`` does, so the bias gradient sums over every cell.

    By default the merged sum is rounded to y.dtype before the bias is
    added, as JAX's XLA reference (``_merge_fused_reference``) does.
    ``accumulate=torch.float32`` keeps it in float32 and rounds once, after
    the bias and the ReLU, as the Pallas kernel and the CUDA kernel do (a
    reference for bfloat16; the same result for float32)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    merged = (_merge_sum(y, col_cy, bounds, grid_shape).to(accumulate)
              if accumulate is not None
              else merge_taps_plain(y, col_cy, bounds, grid_shape))
    emitted = torch.relu(merged.to(acc) + bias_packed.to(acc))
    stats = torch.stack([emitted.sum(dim=2),
                         (emitted * emitted).sum(dim=2)], dim=2)
    return emitted.to(y.dtype), stats


# ----------------------------------------------------------- kernels


def _check(y: torch.Tensor, col_cy: torch.Tensor, bounds: torch.Tensor,
           grid_shape: Sequence[int], name: str, fused: bool) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    if y.dim() != 4 or y.shape[2] != 9:
        raise ValueError(f"y must be (B, V, 9, R), got {tuple(y.shape)}")
    B, V = y.shape[:2]
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    for arg, t, shape in (("col_cy", col_cy, (B, V)),
                          ("bounds", bounds, (B, nx + 1))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{arg} must be {shape} torch.int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != y.device or not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous on {y.device}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    need, _ = launch_facts(y, ny, fused)
    if need > _MAX_SHARED:
        raise ValueError(f"ny={ny}, R={y.shape[-1]}: the kernel would need "
                         f"{need} bytes of shared memory per block")


def _fn(stem: str, dtype: torch.dtype) -> str:
    return f"{stem}_{_DTYPES[dtype]}"


def merge_taps_backward(g: torch.Tensor, col_cy: torch.Tensor,
                        bounds: torch.Tensor, V: int,
                        grid_shape: Sequence[int]) -> torch.Tensor:
    """K3's backward on the card (``_merge_taps_bwd``), the windowed
    gather: g (B, nx, ny, R) -> dy (B, V, 9, R) in g.dtype."""
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    B, R = g.shape[0], g.shape[-1]
    g = g.contiguous()
    dy = torch.empty((B, V, 9, R), dtype=g.dtype, device=g.device)
    if dy.numel():
        TAPS_BWD_KERNEL.launch(_fn("merge_taps_bwd", g.dtype), ptr(g),
                               ptr(col_cy), ptr(bounds), ptr(dy), B, V, nx,
                               ny, R, stream_handle(g.device),
                               device=g.device)
    return dy


class _MergeTaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, col_cy, bounds, grid_shape):
        nx, ny = int(grid_shape[0]), int(grid_shape[1])
        B, V, _, R = y.shape
        out = torch.empty((B, nx, ny, R), dtype=y.dtype, device=y.device)
        if out.numel():
            TAPS_KERNEL.launch(_fn("merge_taps", y.dtype), ptr(y),
                               ptr(col_cy), ptr(bounds), ptr(out), B, V, nx,
                               ny, R, stream_handle(y.device),
                               device=y.device)
        ctx.save_for_backward(col_cy, bounds)
        ctx.grid_shape, ctx.V = grid_shape, V
        return out

    @staticmethod
    def backward(ctx, g):
        col_cy, bounds = ctx.saved_tensors
        dy = merge_taps_backward(g, col_cy, bounds, ctx.V, ctx.grid_shape)
        return dy, None, None, None


class _MergeTapsFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, col_cy, bounds, bias_packed, grid_shape):
        nx, ny = int(grid_shape[0]), int(grid_shape[1])
        B, V, _, R = y.shape
        out = torch.empty((B, nx, ny, R), dtype=y.dtype, device=y.device)
        stats = torch.empty((B, nx, 2, R), dtype=torch.float32,
                            device=y.device)
        if out.numel():
            # each oy tile's row statistics, summed by the kernel's second
            # pass
            _, tiles = launch_facts(y, ny, fused=True)
            partial = torch.empty((B, nx, tiles, 2, R), dtype=torch.float32,
                                  device=y.device)
            KERNEL.launch(_fn("merge_fused", y.dtype), ptr(y), ptr(col_cy),
                          ptr(bounds), ptr(bias_packed), ptr(out),
                          ptr(stats), ptr(partial), B, V, nx, ny, R,
                          stream_handle(y.device), device=y.device)
        ctx.save_for_backward(out, col_cy, bounds)
        ctx.grid_shape, ctx.V = grid_shape, V
        return out, stats

    @staticmethod
    def backward(ctx, g_out, g_stats):
        out, col_cy, bounds = ctx.saved_tensors
        dy, dbias = merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                              bounds, ctx.V, ctx.grid_shape)
        return dy, None, None, dbias, None


def merge_fused_pre(out: torch.Tensor, g_out: torch.Tensor,
                    g_stats: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 backward's first pass on the card: the pre-ReLU cotangent
    ``pre = (g_out + g_sum + 2 out g_sq) * [out > 0]`` (the stats
    cotangents rounded to out.dtype, one rounding of pre) and the bias
    gradient, its sum over every cell.  out, g_out: (B, nx, ny, R);
    g_stats: (B, nx, 2, R) float32.  Returns (pre in out.dtype, dbias (R,)
    float32)."""
    B, nx, ny, R = out.shape
    if g_out.shape != out.shape or tuple(g_stats.shape) != (B, nx, 2, R):
        raise ValueError("out, g_out must be (B, nx, ny, R) and g_stats "
                         "(B, nx, 2, R)")
    out = out.contiguous()
    g_out = g_out.to(out.dtype).contiguous()
    g_stats = g_stats.to(torch.float32).contiguous()
    pre = torch.empty_like(out)
    dbias = torch.empty((R,), dtype=torch.float32, device=out.device)
    if not out.numel():
        return pre, dbias.zero_()
    # each (row, segment) block's dbias partial, summed by the second pass
    need, segments = backward_launch_facts(out, ny)
    if need > _MAX_SHARED:
        raise ValueError(f"R={R}: K1's backward would need {need} bytes of "
                         f"shared memory per block")
    partial = torch.empty((B, nx, segments, R), dtype=torch.float32,
                          device=out.device)
    BWD_KERNEL.launch(_fn("merge_fused_bwd", out.dtype), ptr(out),
                      ptr(g_out), ptr(g_stats), ptr(pre), ptr(partial),
                      ptr(dbias), B, nx, ny, R, stream_handle(out.device),
                      device=out.device)
    return pre, dbias


def merge_taps_fused_backward(out: torch.Tensor, g_out: torch.Tensor,
                              g_stats: torch.Tensor, col_cy: torch.Tensor,
                              bounds: torch.Tensor, V: int,
                              grid_shape: Sequence[int]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's backward on the card (``_merge_fused_bwd``): the first pass
    (:func:`merge_fused_pre`), then K3's backward gather of pre.  out,
    g_out: (B, nx, ny, R); g_stats: (B, nx, 2, R) float32.  Returns (dy
    (B, V, 9, R) in out.dtype, dbias (R,) float32)."""
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    if tuple(out.shape[1:3]) != (nx, ny):
        raise ValueError(f"out must be (B, {nx}, {ny}, R), got "
                         f"{tuple(out.shape)}")
    pre, dbias = merge_fused_pre(out, g_out, g_stats)
    return merge_taps_backward(pre, col_cy, bounds, V, grid_shape), dbias


# ----------------------------------------------------------- public API


def merge_taps(y: torch.Tensor, col_cy: torch.Tensor, bounds: torch.Tensor,
               grid_shape: Sequence[int]) -> torch.Tensor:
    """Differentiable tap merge (K3).

    Args:
      y: (B, V, 9, R) per-column per-tap rows (tap t = kh*3+kw), columns
        sorted by (cx, cy); float32 or bfloat16 on the card.
      col_cy: (B, V) int32 — cy of each column slot.
      bounds: (B, nx+1) int32 — :func:`column_bounds`.
      grid_shape: (nx, ny, nz).

    Returns (B, nx, ny, R) dense merged output in y.dtype.  Its gradient
    is the windowed gather of ``_merge_taps_bwd``.  CPU tensors run the
    plain version; CUDA tensors launch the kernels or raise.
    """
    if y.device.type == "cpu":
        return merge_taps_plain(y, col_cy, bounds, grid_shape)
    _check(y, col_cy, bounds, grid_shape, "merge_taps", fused=False)
    return _MergeTaps.apply(y, col_cy, bounds, tuple(grid_shape))


def merge_taps_fused(y: torch.Tensor, col_cy: torch.Tensor,
                     bounds: torch.Tensor, bias_packed: torch.Tensor,
                     grid_shape: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tap merge with the dense-conv epilogue fused in (K1).

    Args are those of :func:`merge_taps` plus ``bias_packed`` (R,) — the
    conv bias tiled to the d-major lanes, float32 on the card.

    Returns:
      out: (B, nx, ny, R) = relu(merge(y) + bias), y.dtype;
      stats: (B, nx, 2, R) float32 — per output row [sum, sum_sq] of out
        over ny.

    Differentiable in ``y`` and ``bias_packed`` (``_merge_fused_bwd``).
    CPU tensors run the plain version; CUDA tensors launch the kernels or
    raise.
    """
    if y.device.type == "cpu":
        return merge_taps_fused_plain(y, col_cy, bounds, bias_packed,
                                      grid_shape)
    _check(y, col_cy, bounds, grid_shape, "merge_taps_fused", fused=True)
    R = y.shape[-1]
    if (tuple(bias_packed.shape) != (R,)
            or bias_packed.dtype != torch.float32):
        raise ValueError(f"bias_packed must be {(R,)} torch.float32, got "
                         f"{tuple(bias_packed.shape)} {bias_packed.dtype}")
    if bias_packed.device != y.device or not bias_packed.is_contiguous():
        raise ValueError(f"bias_packed must be contiguous on {y.device}")
    return _MergeTapsFused.apply(y, col_cy, bounds, bias_packed,
                                 tuple(grid_shape))
