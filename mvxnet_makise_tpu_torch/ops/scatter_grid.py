"""K4: the dense voxel scatter — CUDA kernel, its backward, plain version.

Port of ``pallas_scatter_to_grid`` (``mvxnet_makise_tpu/ops/
pallas_scatter.py``) and its custom VJP (``_pallas_scatter_diff`` in
``mvxnet_makise_tpu/models/voxelnet.py``): V voxel rows at unique cells
become the dense channels-last (nz, nx, ny, C) grid of the dense-3D CML
(``cml_mode="dense3d", scatter_backend="pallas"``).  For CUDA tensors
:func:`scatter_to_grid` launches the kernels of ``csrc/scatter_grid.cu``
inside a ``torch.autograd.Function``; for CPU tensors it runs the plain
version, ``ops/scatter.scatter_voxels_to_grid``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mvxnet_makise_tpu_torch.ops.cuda_build import (
    CudaKernel,
    CudaLibrary,
    ptr,
    stream_handle,
)
from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("scatter_grid.cu", {
    "scatter_grid": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "scatter_grid_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)})
KERNEL = CudaKernel("scatter_grid", LIBRARY)
BWD_KERNEL = CudaKernel("scatter_grid_bwd", LIBRARY)
KERNELS = (KERNEL, BWD_KERNEL)
_MAX_CELLS = 2 ** 31 - 1   # cell ids are int32 in the kernels


def _row_bytes(features: torch.Tensor) -> int:
    row_bytes = features.shape[-1] * features.element_size()
    if row_bytes % 16:
        raise ValueError(f"scatter_to_grid copies 16-byte words: a row of "
                         f"{row_bytes} bytes is not a multiple of 16")
    return row_bytes


class _ScatterToGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, coords, mask, grid_shape):
        nx, ny, nz = grid_shape
        B, V, C = features.shape
        grid = torch.empty((B, nz, nx, ny, C), dtype=features.dtype,
                           device=features.device)
        if grid.numel():
            KERNEL.launch("scatter_grid", ptr(features), ptr(coords),
                          ptr(mask), ptr(grid), B, V, nx, ny, nz,
                          _row_bytes(features),
                          stream_handle(features.device),
                          device=features.device)
        ctx.save_for_backward(coords, mask)
        ctx.grid_shape = grid_shape
        return grid

    @staticmethod
    def backward(ctx, g):
        coords, mask = ctx.saved_tensors
        return (scatter_to_grid_backward(g, coords, mask, ctx.grid_shape),
                None, None, None)


def scatter_to_grid_backward(g: torch.Tensor, coords: torch.Tensor,
                             mask: torch.Tensor, grid_shape: Sequence[int]
                             ) -> torch.Tensor:
    """K4's backward on the card: the masked row gather.  g: (B, nz, nx,
    ny, C); returns (B, V, C) in g.dtype."""
    nx, ny, nz = grid_shape
    B, V = mask.shape
    C = g.shape[-1]
    g = g.contiguous()
    d = torch.empty((B, V, C), dtype=g.dtype, device=g.device)
    if d.numel():
        BWD_KERNEL.launch("scatter_grid_bwd", ptr(g), ptr(coords), ptr(mask),
                          ptr(d), B, V, nx, ny, nz, _row_bytes(d),
                          stream_handle(g.device), device=g.device)
    return d


def scatter_to_grid(features: torch.Tensor, coords: torch.Tensor,
                    mask: torch.Tensor,
                    grid_shape: Sequence[int]) -> torch.Tensor:
    """K4: scatter voxel rows into the dense channels-last grid.

    Args:
      features: (B, V, C) float32 or bfloat16 on the card, rows of a
        multiple of 16 bytes.
      coords: (B, V, 3) int32 (ix, iy, iz); mask: (B, V) bool.  Valid
        cells must be unique per frame (the voxelizer's are); rows may
        come in any order.
      grid_shape: (nx, ny, nz).

    Returns (B, nz, nx, ny, C), zeros where no valid row lands.
    Differentiable in ``features``.  CPU tensors run the plain version;
    CUDA tensors launch the kernels or raise.
    """
    if features.device.type == "cpu":
        return scatter_voxels_to_grid(features, coords, mask, grid_shape)
    if features.device.type != "cuda":
        raise ValueError(f"scatter_to_grid: unsupported device "
                         f"{features.device}")
    if features.dim() != 3 or features.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"features must be (B, V, C) float32 or bfloat16, "
                         f"got {tuple(features.shape)} {features.dtype}")
    B, V, _ = features.shape
    for name, t, shape, dtype in (("coords", coords, (B, V, 3), torch.int32),
                                  ("mask", mask, (B, V), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != features.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on "
                             f"{features.device}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous")
    nx, ny, nz = (int(g) for g in grid_shape)
    if nx * ny * nz > _MAX_CELLS:
        raise ValueError(f"grid {grid_shape} has too many cells for int32")
    return _ScatterToGrid.apply(features, coords, mask, (nx, ny, nz))
