"""Point-major VoxelNet branch: the VFE stack over real points only.

Port of ``mvxnet_makise_tpu/models/voxelnet_pm.py`` with ``cml_mode``
"column" (the default; "banded" builds it too, ``voxelnet.make_cml``) or
"dense3d" (``scatter_backend`` "pallas" runs K4).  It is also the port of
JAX's slot-major ``VoxelNetBranch``, which computes the same function on
the same parameter tree over the (V, T, C) slot tensor.  Pointwise layers
run over the voxel-sorted point list, per-voxel max-pooling is a segment
max (``scatter_reduce`` amax), and the empty sample slots of each voxel —
all holding the same row — enter the statistics and the max in closed
form with multiplicity ``T - count_v``
(``blocks.DenseReluNormVirtualWeighted``).  ``remat`` recomputes the CML
in the backward pass instead of keeping its activations (``nn.remat`` in
JAX, ``torch.utils.checkpoint`` here).  The forward's spans
(``utils/profiling``): ``mvx.model.vfe``, ``mvx.model.cml``,
``mvx.model.rpn``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvxnet_makise_tpu_torch.models.blocks import (
    DenseReluNormVirtualWeighted,
)
from mvxnet_makise_tpu_torch.models.voxelnet import (
    REFERENCE_RPN_TRUNK,
    RPN,
    make_cml,
)
from mvxnet_makise_tpu_torch.utils.profiling import span

_NEG = -1e30


def _segment_max(values: torch.Tensor, seg: torch.Tensor,
                 kept: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-voxel max over kept points.  values (B, P, C); seg (B, P) with
    ``num_segments`` as the drop bucket.  Returns (B, V, C); empty
    segments hold -inf."""
    B, P, C = values.shape
    masked = torch.where(kept[..., None], values,
                         torch.full_like(values, _NEG))
    out = torch.full((B, num_segments + 1, C), float("-inf"),
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(1, seg.long()[..., None].expand(B, P, C), masked,
                        reduce="amax", include_self=True)
    return out[:, :num_segments]


def _take_per_point(per_voxel: torch.Tensor,
                    seg: torch.Tensor) -> torch.Tensor:
    """Row seg[b, p] of per_voxel (B, V, C) for each point; dropped points
    (seg == V) get zeros."""
    B, V, C = per_voxel.shape
    padded = torch.cat([per_voxel, per_voxel.new_zeros(B, 1, C)], dim=1)
    idx = torch.clamp(seg.long(), max=V)[..., None].expand(-1, -1, C)
    return torch.gather(padded, 1, idx)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 kept: torch.Tensor, counts: torch.Tensor,
                 samples_per_voxel: int) -> torch.Tensor:
    """Per-voxel sum over kept points, (B, P, C) -> (B, V, C).

    The kept points of a voxel are contiguous in voxel-sorted order (the
    first ``counts`` of its run), so each sum reads one window of at most
    ``samples_per_voxel`` rows in a fixed order.  A scatter-add would sum
    with atomics on the card, in an order that changes from run to run,
    and the detections of an untrained model change with it."""
    B, P, C = values.shape
    V = counts.shape[1]
    dev = values.device
    pos = torch.arange(P, device=dev).expand(B, P)
    start = torch.full((B, V + 1), P, dtype=torch.long, device=dev)
    start.scatter_reduce_(1, seg.long(), torch.where(kept, pos, P),
                          reduce="amin")
    t = torch.arange(samples_per_voxel, device=dev)
    take = t < counts[..., None]                             # (B, V, T)
    idx = torch.where(take, start[:, :V, None] + t, 0).reshape(B, -1, 1)
    rows = torch.gather(values, 1, idx.expand(-1, -1, C))
    rows = rows.reshape(B, V, samples_per_voxel, C)
    return torch.where(take[..., None], rows, 0).sum(dim=2)


def point_lidar_features(sorted_points: torch.Tensor,
                         sorted_seg: torch.Tensor,
                         sorted_kept: torch.Tensor,
                         counts: torch.Tensor,
                         samples_per_voxel: int) -> torch.Tensor:
    """Per-point 7-channel LiDAR features in voxel-sorted order:
    [x, y, z, dx, dy, dz, refl] with offsets from each voxel's centroid
    over its kept points.  sorted_points (B, P, 6); seg/kept (B, P);
    counts (B, V), each at most ``samples_per_voxel``."""
    xyz = sorted_points[..., :3]
    sums = segment_sum(xyz, sorted_seg, sorted_kept, counts,
                        samples_per_voxel)
    centroid = sums / torch.clamp(counts, min=1)[..., None].to(xyz.dtype)
    offs = xyz - _take_per_point(centroid, sorted_seg)
    return torch.cat([xyz, offs, sorted_points[..., 3:4]], dim=-1)


def _voxel_max(h, hz, seg, kept, nv, vmask):
    """Per-voxel max of the point rows and, where a voxel has empty
    slots, its constant row; dead voxels 0."""
    V = nv.shape[1]
    segmax = _segment_max(h, seg, kept, V)
    vmax = torch.where((nv > 0)[..., None], torch.maximum(segmax, hz),
                       segmax)
    return torch.where(vmask[..., None] & (vmax > _NEG / 2), vmax,
                       torch.zeros_like(vmax))


class PointVFE(nn.Module):
    """VFE layer in point-major form."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.fcn = DenseReluNormVirtualWeighted(in_features, features, eps)

    def forward(self, x, kept, seg, z, nv, vmask):
        """x: (B, P, C); kept/seg: (B, P); z: (B, V, C) empty-slot rows;
        nv: (B, V) empty-slot multiplicities; vmask: (B, V).
        Returns (x', z') with 2*features channels."""
        h, hz = self.fcn(x, kept, z, nv, vmask)
        vmax = _voxel_max(h, hz, seg, kept, nv, vmask)
        return (torch.cat([h, _take_per_point(vmax, seg)], dim=-1),
                torch.cat([hz, vmax], dim=-1))


class PointSVFE(nn.Module):
    """Stacked point-major VFE: C_in -> 16(+16) -> 64(+64) = 128."""

    def __init__(self, in_features: int, eps: float = 1e-6):
        super().__init__()
        self.vfe1 = PointVFE(in_features, 16, eps)
        self.vfe2 = PointVFE(32, 64, eps)

    def forward(self, x, kept, seg, z, nv, vmask):
        x, z = self.vfe1(x, kept, seg, z, nv, vmask)
        return self.vfe2(x, kept, seg, z, nv, vmask)


def voxel_features(svfe: PointSVFE, fcn: DenseReluNormVirtualWeighted,
                   samples_per_voxel: int, points, kept, seg, counts,
                   vmask, z0=None) -> torch.Tensor:
    """Per-voxel 128-channel features (B, V, 128) of the VFE stack
    ``svfe`` and the dense layer ``fcn``, max-pooled over each voxel's
    ``samples_per_voxel`` slots; dead voxels 0.  z0: (B, V, C_in)
    empty-slot input rows (None = zeros)."""
    T = samples_per_voxel
    nv = torch.clamp(T - counts, 0, T).to(points.dtype) * vmask
    z = z0 if z0 is not None else points.new_zeros(
        (*counts.shape, points.shape[-1]))
    x, z = svfe(points, kept, seg, z, nv, vmask)
    h, hz = fcn(x, kept, z, nv, vmask)
    return _voxel_max(h, hz, seg, kept, nv, vmask)


class VoxelNetBranchPM(nn.Module):
    """Point-major LiDAR branch: VFE stack, per-voxel pooling, CML
    (``cml_mode``, ``voxelnet.make_cml``), RPN."""

    def __init__(self, in_features: int = 23,
                 grid_shape: Sequence[int] = (352, 400, 10),
                 anchors_per_loc: int = 2, box_dim: int = 7,
                 eps: float = 1e-6, samples_per_voxel: int = 35,
                 rpn_trunk: Tuple = REFERENCE_RPN_TRUNK,
                 cml_mode: str = "column", scatter_backend: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.samples_per_voxel = samples_per_voxel
        self.remat = remat
        self.svfe = PointSVFE(in_features, eps)
        self.fcn = DenseReluNormVirtualWeighted(128, 128, eps)
        self.cml = make_cml(cml_mode, 128, grid_shape, eps, scatter_backend)
        self.rpn = RPN(64 * 2, anchors_per_loc, box_dim, eps, rpn_trunk)
        self._cml_tensors = [n for n, _ in self.cml.named_parameters()]

    def voxel_features(self, points, kept, seg, counts, vmask, z0=None):
        """Per-voxel 128-channel features (B, V, 128), dead voxels 0."""
        return voxel_features(self.svfe, self.fcn, self.samples_per_voxel,
                              points, kept, seg, counts, vmask, z0)

    def run_cml(self, vfeat: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor) -> torch.Tensor:
        """The CML; under ``remat`` with gradients on, checkpointed: its
        activations are recomputed in the backward pass.  The recompute
        runs with the tensors the CML holds now, read here: under
        ``torch.func.functional_call`` those are the tensors handed to the
        call, which has put the module's own back by the time the backward
        runs."""
        if not (self.remat and torch.is_grad_enabled()):
            return self.cml(vfeat, coords, vmask)
        tensors = {n: functools.reduce(getattr, n.split("."), self.cml)
                   for n in self._cml_tensors}
        return checkpoint(
            lambda *args: torch.func.functional_call(self.cml, tensors,
                                                     args),
            vfeat, coords, vmask, use_reentrant=False)

    def forward(self, points: torch.Tensor, kept: torch.Tensor,
                seg: torch.Tensor, counts: torch.Tensor,
                coords: torch.Tensor, vmask: torch.Tensor,
                z0=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """points: (B, P, C_in) voxel-sorted per-point features; kept/seg:
        (B, P); counts: (B, V); coords: (B, V, 3); vmask: (B, V); z0:
        (B, V, C_in) empty-slot input rows (None = zeros)."""
        with span("mvx.model.vfe"):
            vfeat = self.voxel_features(points, kept, seg, counts, vmask,
                                        z0)
        with span("mvx.model.cml"):
            y = self.run_cml(vfeat, coords, vmask)  # (B, C, D, nx, ny)
        B, C, D, H, W = y.shape
        # (C, D) flattening order into channels, as the reference
        # reshapes NCDHW -> N, C*D, H, W
        with span("mvx.model.rpn"):
            return self.rpn(y.reshape(B, C * D, H, W))
