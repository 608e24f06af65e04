"""Column-compacted CML conv1: pack active BEV columns, one tap matmul.

Port of ``compact_columns(assume_sorted=True)`` and the depth-im2col tap
matmul of ``mvxnet_makise_tpu/ops/column_conv.py``.  A LiDAR frame fills
a few thousand of the grid's BEV columns, and conv1's depth taps stay
inside a column, so all 27 taps for all output depths of all active
columns become one ``(V*d_out, 3*Cin) @ (3*Cin, 9*Cout)`` matmul.  The
spatial merge of its rows into the dense output is K1
(``ops/column_merge.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def compact_columns(vfeat: torch.Tensor, coords: torch.Tensor,
                    vmask: torch.Tensor, grid_shape: Sequence[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack voxel rows into dense per-BEV-column z-stacks.

    Valid rows must be ascending in the linear cell id with invalid rows
    trailing — the order ``ops/voxelize.voxelize`` emits — so no sort is
    needed (the JAX function's ``assume_sorted=True``).

    Args:
      vfeat: (B, V, Cin); coords: (B, V, 3) int32 (ix, iy, iz), -1 on
        dead rows; vmask: (B, V) bool.

    Returns:
      cols: (B, V, nz, Cin) — column c's z-stack in cols[:, c], absent
        cells zero; col_xy: (B, V, 2) int32 (cx, cy) per column slot, -1
        padding; col_mask: (B, V) bool.
    """
    nx, ny, nz = grid_shape
    B, V, Cin = vfeat.shape
    dev = vfeat.device
    ix, iy, iz = coords[..., 0], coords[..., 1], coords[..., 2]
    col_lin = torch.where(vmask, ix * ny + iy,
                          torch.full_like(ix, nx * ny))

    prev = torch.cat([torch.full_like(col_lin[:, :1], -1),
                      col_lin[:, :-1]], dim=1)
    new_col = vmask & (col_lin != prev)
    col_id = torch.cumsum(new_col.to(torch.int32), dim=1,
                          dtype=torch.int32) - 1

    flat = torch.where(vmask, col_id * nz + iz,
                       torch.full_like(col_id, V * nz)).long()
    cols = torch.zeros((B, V * nz + 1, Cin), dtype=vfeat.dtype, device=dev)
    cols.scatter_(1, flat[..., None].expand(B, V, Cin), vfeat)
    cols = cols[:, :V * nz].reshape(B, V, nz, Cin)

    src = torch.where(new_col, col_id, torch.full_like(col_id, V)).long()
    col_ix = torch.full((B, V + 1), -1, dtype=torch.int32, device=dev)
    col_iy = torch.full((B, V + 1), -1, dtype=torch.int32, device=dev)
    col_ix.scatter_(1, src, ix.to(torch.int32))
    col_iy.scatter_(1, src, iy.to(torch.int32))
    n_cols = new_col.sum(dim=1)
    col_mask = torch.arange(V, device=dev)[None, :] < n_cols[:, None]
    col_xy = torch.stack([col_ix[:, :V], col_iy[:, :V]], dim=-1)
    return cols, col_xy, col_mask


def fold_conv1_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Cout, Cin, kd, kh, kw) -> (3*Cin, 9*Cout) with
    kd-major rows and (kh, kw)-major columns."""
    cout, cin, kd, kh, kw = weight.shape
    k = weight.permute(2, 1, 3, 4, 0)            # (kd, Cin, kh, kw, Cout)
    return k.reshape(kd * cin, kh * kw * cout)


def column_taps(cols: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Depth-im2col + one matmul: conv1 (depth stride 2, padding 1) over
    compacted columns.

    cols: (B, V, nz, Cin); weight: (Cout, Cin, 3, 3, 3).
    Returns (B, V, 9, d_out*Cout): per column and spatial tap t = kh*3+kw,
    the contributions to every output depth, d-major lanes — the layout
    the merge kernel takes."""
    B, V, nz, Cin = cols.shape
    d_out = (nz + 2 - 3) // 2 + 1
    cout = weight.shape[0]
    xp = torch.nn.functional.pad(cols, (0, 0, 1, 1))
    span = 2 * (d_out - 1) + 1
    taps = torch.cat([xp[:, :, kd:kd + span:2, :] for kd in range(3)],
                     dim=-1)                      # (B, V, d_out, 3*Cin)
    y = taps.reshape(B * V * d_out, 3 * Cin) @ fold_conv1_kernel(weight)
    y = y.reshape(B, V, d_out, 9, cout).transpose(2, 3)
    return y.reshape(B, V, 9, d_out * cout)
