"""Fixed-capacity voxelization on tensors, point-major outputs only.

Port of the ``slot_features=False`` path of
``mvxnet_makise_tpu/ops/voxelize.py``: stably sort points by linear voxel
id, give each voxel a dense slot and each point a rank within its voxel,
keep the first ``T`` points per voxel.  The outputs are the voxel-sorted
point list the point-major model consumes; the (V, T, 9) slot tensor is
never built.  Batched over a leading frame axis; no shuffle (serving is
deterministic).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class VoxelGrid(NamedTuple):
    """Static-capacity voxelized frames (leading batch axis B)."""
    coords: torch.Tensor          # (B, V, 3) int32 — (ix, iy, iz); -1 pad
    counts: torch.Tensor          # (B, V) int32 — points kept per voxel
    num_voxels: torch.Tensor      # (B,) int32
    mask: torch.Tensor            # (B, V) bool — slot holds a real voxel
    num_kept: torch.Tensor        # (B,) int32 — total points kept
    sorted_points: torch.Tensor   # (B, P, C_in) voxel-sorted points
    sorted_seg: torch.Tensor      # (B, P) int32 voxel slot; V = dropped
    sorted_kept: torch.Tensor     # (B, P) bool
    sorted_to_orig: torch.Tensor  # (B, P) int32 input row of each entry


def voxelize(points: torch.Tensor,
             num_valid: torch.Tensor,
             *,
             velo_range: Sequence[float],
             voxel_size: Sequence[float],
             grid_shape: Sequence[int],
             max_voxels: int,
             samples_per_voxel: int) -> VoxelGrid:
    """points: (B, P, C) ``[x, y, z, refl, img_row, img_col]`` rows, rows
    at index >= ``num_valid`` (B,) being padding."""
    B, P, _ = points.shape
    dev = points.device
    T, V = samples_per_voxel, max_voxels
    nx, ny, nz = grid_shape
    n_cells = nx * ny * nz

    pos = torch.arange(P, device=dev, dtype=torch.int32)
    was_valid = pos[None, :] < num_valid.to(dev)[:, None]

    lo = torch.tensor(velo_range[:3], dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    ijk = torch.floor((points[..., :3] - lo) / vs).to(torch.int32)
    hi = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    in_bounds = ((ijk >= 0) & (ijk < hi)).all(dim=-1)
    valid = was_valid & in_bounds

    linear = ijk[..., 0] * (ny * nz) + ijk[..., 1] * nz + ijk[..., 2]
    linear = torch.where(valid, linear, torch.full_like(linear, n_cells))

    linear_s, order = torch.sort(linear, dim=1, stable=True)
    points_s = torch.gather(
        points, 1, order[..., None].expand(-1, -1, points.shape[-1]))
    valid_s = torch.gather(valid, 1, order)

    new_seg = torch.cat([valid_s[:, :1],
                         linear_s[:, 1:] != linear_s[:, :-1]], dim=1)
    new_seg = new_seg & valid_s
    seg_id = torch.cumsum(new_seg.to(torch.int32), dim=1,
                          dtype=torch.int32) - 1
    # index of the first point of each point's segment
    seg_start = torch.cummax(
        torch.where(new_seg, pos, torch.full_like(pos, -1)), dim=1).values
    rank = pos - seg_start

    keep = valid_s & (rank < T) & (seg_id >= 0) & (seg_id < V)
    dump = torch.full_like(seg_id, V)

    counts = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, torch.where(keep, seg_id, dump).long(),
                        torch.ones_like(seg_id))
    counts = counts[:, :V]

    # the first point of each voxel writes its cell id; every other row
    # lands in the dropped dump column
    coord_src = new_seg & (seg_id < V) & (seg_id >= 0)
    coord_buf = torch.full((B, V + 1), -1, dtype=torch.int32, device=dev)
    coord_buf.scatter_(1, torch.where(coord_src, seg_id, dump).long(),
                       linear_s)
    coord_buf = coord_buf[:, :V]
    coords = torch.stack([coord_buf // (ny * nz),
                          (coord_buf // nz) % ny,
                          coord_buf % nz], dim=-1)
    coords = torch.where((coord_buf >= 0)[..., None], coords,
                         torch.full_like(coords, -1))

    num_voxels = torch.clamp(new_seg.sum(dim=1), max=V).to(torch.int32)
    vmask = torch.arange(V, device=dev)[None, :] < num_voxels[:, None]

    return VoxelGrid(coords=coords, counts=counts, num_voxels=num_voxels,
                     mask=vmask,
                     num_kept=keep.sum(dim=1).to(torch.int32),
                     sorted_points=points_s,
                     sorted_seg=torch.where(keep, seg_id, dump),
                     sorted_kept=keep,
                     sorted_to_orig=order.to(torch.int32))
