"""Per-frame facts the accounting needs, worked out by the benchmark from
its own inputs with the reference's voxelizer: kept points, voxels, live
BEV columns, CML conv1's occupied (output cell, tap) pairs, and the
distinct feature cells K2's bilinear taps read."""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import model as R


def conv1_pairs(coords: torch.Tensor, grid_shape) -> int:
    """(output cell, tap) pairs of a 3x3x3 conv (depth stride 2, padding
    1) whose input cell is one of ``coords`` (V, 3)."""
    nx, ny, nz = grid_shape
    d_out = (nz + 2 - 3) // 2 + 1
    iz = coords[:, 2]
    # output depth d reads input depths 2d-1, 2d, 2d+1
    d = torch.arange(d_out, device=coords.device)
    depth = ((iz[:, None] >= 2 * d - 1) & (iz[:, None] <= 2 * d + 1)).sum(1)
    ix, iy = coords[:, 0], coords[:, 1]
    span_x = (torch.clamp(ix + 1, max=nx - 1) - torch.clamp(ix - 1, min=0)
              + 1)
    span_y = (torch.clamp(iy + 1, max=ny - 1) - torch.clamp(iy - 1, min=0)
              + 1)
    return int((depth * span_x * span_y).sum())


def touched_cells(rc: torch.Tensor, image_hw, level_hw) -> int:
    """Distinct cells of one (Hf, Wf) feature level that the bilinear taps
    of the points ``rc`` (N, 2) read."""
    Hf, Wf = level_hw
    r = torch.clamp(rc[:, 0] / (image_hw[0] / Hf) - R.NORM_EPS, 0, Hf - 1)
    c = torch.clamp(rc[:, 1] / (image_hw[1] / Wf) - R.NORM_EPS, 0, Wf - 1)
    r0, c0 = torch.floor(r).long(), torch.floor(c).long()
    r1, c1 = (r0 + 1).clamp(max=Hf - 1), (c0 + 1).clamp(max=Wf - 1)
    cells = torch.cat([r0 * Wf + c0, r1 * Wf + c0, r0 * Wf + c1,
                       r1 * Wf + c1])
    return int(torch.unique(cells).numel())


def stats(points: torch.Tensor, n: int, cfg: Dict,
          with_images: bool) -> Dict[str, int]:
    """The facts of one padded cloud (the first ``n`` rows real, in the
    order the program voxelizes them)."""
    vox = R.voxelize(points, n, cfg["velo_range"], cfg["voxel_shape"],
                     cfg["max_voxels"], cfg["samples_per_voxel"])
    cols = vox.coords[:, 0] * cfg["voxel_shape"][1] + vox.coords[:, 1]
    out = {"kept_points": int(vox.filled.sum()),
           "voxels": int(len(vox.coords)),
           "live_columns": int(torch.unique(cols).numel()),
           "conv1_pairs": conv1_pairs(vox.coords, cfg["voxel_shape"])}
    if with_images:
        from perfbench.accounting.flops import padded_image

        hp, wp = padded_image(cfg["image_size"],
                              cfg.get("image_min_side", 800.0))
        image_hw = R.sample_image_hw(cfg["image_size"],
                                     cfg.get("image_min_side", 800.0))
        rc = vox.slots[vox.filled][:, 4:6]
        out["k2_touched_cells"] = sum(
            touched_cells(rc, image_hw, (hp // s, wp // s))
            for s in (4, 8, 16))
    return out
