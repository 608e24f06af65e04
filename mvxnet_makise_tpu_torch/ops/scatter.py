"""Sparse voxel features -> dense channels-last grid: the plain version.

Port of ``scatter_voxels_to_grid`` (``mvxnet_makise_tpu/ops/scatter.py``),
batched over a leading frame axis.  It is the dense-3D CML's scatter for
``scatter_backend`` "auto" and "xla", and the plain version of K4
(``ops/scatter_grid.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def scatter_voxels_to_grid(features: torch.Tensor, coords: torch.Tensor,
                           mask: torch.Tensor,
                           grid_shape: Sequence[int]) -> torch.Tensor:
    """Scatter per-voxel features into a dense channels-last grid.

    Args:
      features: (B, V, C) per-voxel features.
      coords: (B, V, 3) int voxel coords (ix, iy, iz); -1 padding.
      mask: (B, V) bool validity; valid cells are unique per frame.
      grid_shape: (nx, ny, nz).

    Returns (B, nz, nx, ny, C): depth-major, channels-last.  Empty cells
    are 0; masked rows drop (they all land in one extra row that is cut
    off).  Differentiable in ``features``: a masked row gather.
    """
    nx, ny, nz = grid_shape
    B, V, C = features.shape
    n_cells = nx * ny * nz
    flat = coords[..., 2] * (nx * ny) + coords[..., 0] * ny + coords[..., 1]
    flat = torch.where(mask, flat, torch.full_like(flat, n_cells)).long()
    grid = features.new_zeros((B, n_cells + 1, C))
    grid.scatter_(1, flat[..., None].expand(B, V, C), features)
    return grid[:, :n_cells].reshape(B, nz, nx, ny, C)
