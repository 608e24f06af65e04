"""Fixed-capacity voxelization on tensors, point-major outputs only.

Port of the ``slot_features=False`` path of
``mvxnet_makise_tpu/ops/voxelize.py``: stably sort points by linear voxel
id, give each voxel a dense slot and each point a rank within its voxel,
keep the first ``T`` points per voxel.  The outputs are the voxel-sorted
point list the point-major model consumes; the (V, T, 9) slot tensor is
never built.  Batched over a leading frame axis.  Training shuffles each
cloud first (the JAX ``shuffle_key``) through an explicit permutation
that the caller draws; serving passes none and stays deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from mvxnet_makise_tpu_torch.device import device_constant


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


def crop_to_range_mask(points: torch.Tensor,
                       velo_range: Sequence[float]) -> torch.Tensor:
    """Axis-aligned range filter as a mask: ``low <= xyz < high``."""
    lo = torch.tensor(velo_range[:3], dtype=points.dtype,
                      device=points.device)
    hi = torch.tensor(velo_range[3:6], dtype=points.dtype,
                      device=points.device)
    xyz = points[..., :3]
    return ((xyz >= lo) & (xyz < hi)).all(dim=-1)


def frustum_mask(points: torch.Tensor, proj: torch.Tensor,
                 rect: torch.Tensor,
                 image_size: Sequence[int]) -> torch.Tensor:
    """Camera-FOV filter as a mask: positive depth and a projection inside
    the image, with the ``imsize - 1e-3`` boundary epsilon.  proj: the
    combined (4, 4) LiDAR->image matrix; rect: (4, 4) R0 @ Tr; image_size:
    (h, w)."""
    p = torch.cat([points[..., :3], torch.ones_like(points[..., :1])],
                  dim=-1)
    depth_ok = (p @ rect.T)[..., 2] > 0
    img = p @ proj.T
    z = img[..., 2]
    uv = img[..., :2] / torch.where(z.abs() < 1e-9,
                                    torch.full_like(z, 1e-9), z)[..., None]
    h, w = image_size
    lim = torch.tensor([w - 1e-3, h - 1e-3], dtype=points.dtype,
                       device=points.device)
    return depth_ok & ((uv >= 0) & (uv < lim)).all(dim=-1)


def voxelize(points: torch.Tensor,
             num_valid: torch.Tensor,
             *,
             velo_range: Sequence[float],
             voxel_size: Sequence[float],
             grid_shape: Sequence[int],
             max_voxels: int,
             samples_per_voxel: int,
             perm: Optional[torch.Tensor] = None) -> VoxelGrid:
    """points: (B, P, C) ``[x, y, z, refl, img_row, img_col]`` rows, rows
    at index >= ``num_valid`` (B,) being padding.  ``perm``: optional
    (B, P) permutation of each frame's rows, applied first; validity
    travels with it, so per-voxel sampling keeps the first T points in
    permuted order."""
    B, P, _ = points.shape
    dev = points.device
    T, V = samples_per_voxel, max_voxels
    nx, ny, nz = grid_shape
    n_cells = nx * ny * nz

    pos = torch.arange(P, device=dev, dtype=torch.int32)
    if perm is not None:
        perm = perm.to(device=dev, dtype=torch.long)
        points = torch.gather(points, 1,
                              perm[..., None].expand(-1, -1, points.shape[-1]))
        was_valid = perm < num_valid.to(dev)[:, None]
    else:
        was_valid = pos[None, :] < num_valid.to(dev)[:, None]

    lo = device_constant(velo_range[:3], points.dtype, dev)
    vs = device_constant(voxel_size, points.dtype, dev)
    ijk = torch.floor((points[..., :3] - lo) / vs).to(torch.int32)
    hi = device_constant(grid_shape, torch.int32, dev)
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
                     sorted_to_orig=(order if perm is None else
                                     torch.gather(perm, 1, order)
                                     ).to(torch.int32))
