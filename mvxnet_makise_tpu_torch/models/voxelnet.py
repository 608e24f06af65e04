"""LiDAR-branch middle layers (column CML) and the RPN head.

Port of ``ColumnConv1ReluNorm``, ``MiddleConvLayersColumn`` and ``RPN``
from ``mvxnet_makise_tpu/models/voxelnet.py``.  conv1 runs over the
compacted active columns (one tap matmul, then K1 merges the taps with
bias, ReLU and the statistics fused in); conv2, conv3 and the RPN are
plain ``F.conv3d`` / ``nn.Conv2d`` / ``nn.ConvTranspose2d``, as they were
XLA convolutions in JAX.  Convolutions run channels-first (B, C, D, H, W)
with H = nx and W = ny; the RPN returns channels-last maps like JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvxnet_makise_tpu_torch.models.blocks import (
    ConvReluNorm,
    DeconvReluNorm,
    standardize,
)
from mvxnet_makise_tpu_torch.ops.column_conv import (
    column_taps,
    compact_columns,
)
from mvxnet_makise_tpu_torch.ops.column_merge import (
    column_bounds,
    merge_taps_fused,
)

# reference RPN shape: stage channels, extra convs per stage, deconv width
REFERENCE_RPN_TRUNK = ((128, 128, 256), (3, 5, 5), 256)


class Conv3dParams(nn.Module):
    """Holder of a 3x3x3 conv's weight (Cout, Cin, 3, 3, 3) and bias —
    the parameters of the reference's ``cml.conv{i}.conv``, whatever form
    computes with them."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))


class MergeInputs(NamedTuple):
    """The arguments K1 receives on the model path."""
    y: torch.Tensor            # (B, V, 9, d_out*Cout)
    col_cy: torch.Tensor       # (B, V) int32
    bounds: torch.Tensor       # (B, nx+1) int32
    bias_packed: torch.Tensor  # (d_out*Cout,) float32


class ColumnConv1ReluNorm(nn.Module):
    """CML conv1 (3x3x3, depth stride 2, padding 1) -> ReLU -> standardize,
    over compacted BEV columns.  Returns depth-minor (B, nx, ny, d_out,
    Cout), normalized with per-sample statistics that K1 emits alongside
    its output, so the output is never re-read for them."""

    def __init__(self, in_features: int, features: int,
                 grid_shape: Sequence[int], eps: float = 1e-6):
        super().__init__()
        self.conv = Conv3dParams(in_features, features)
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.eps = eps

    @property
    def d_out(self) -> int:
        return (self.grid_shape[2] + 2 - 3) // 2 + 1

    def merge_inputs(self, vfeat: torch.Tensor, coords: torch.Tensor,
                     vmask: torch.Tensor) -> MergeInputs:
        nx = self.grid_shape[0]
        cols, col_xy, col_mask = compact_columns(vfeat, coords, vmask,
                                                 self.grid_shape)
        y = column_taps(cols, self.conv.weight.to(vfeat.dtype))
        # the bias lands on every cell, active or not, tiled to the
        # d-major lanes
        bias_packed = self.conv.bias.float().repeat(self.d_out)
        return MergeInputs(y.contiguous(), col_xy[..., 1].contiguous(),
                           column_bounds(col_xy, col_mask, nx),
                           bias_packed.contiguous())

    def forward(self, vfeat: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor) -> torch.Tensor:
        nx, ny, _ = self.grid_shape
        d_out, cout = self.d_out, self.conv.weight.shape[0]
        out, stats = merge_taps_fused(*self.merge_inputs(vfeat, coords,
                                                         vmask),
                                      self.grid_shape)
        B = out.shape[0]
        s = stats.sum(dim=1).reshape(B, 2, d_out, cout).sum(dim=2)
        n = nx * ny * d_out
        mean = s[:, 0] / n                                    # (B, Cout)
        var = s[:, 1] / n - mean * mean
        x = out.reshape(B, nx, ny, d_out, cout)
        inv = torch.rsqrt(var + self.eps)
        return ((x.to(mean.dtype) - mean[:, None, None, None])
                * inv[:, None, None, None]).to(x.dtype)


class Conv3dReluNorm(nn.Module):
    """3x3x3 conv -> ReLU -> standardize over (D, H, W) per sample."""

    def __init__(self, in_features: int, features: int,
                 stride: Tuple[int, int, int],
                 padding: Tuple[int, int, int], eps: float = 1e-6):
        super().__init__()
        self.conv = Conv3dParams(in_features, features)
        self.stride, self.padding, self.eps = stride, padding, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x, self.conv.weight, self.conv.bias, self.stride,
                     self.padding)
        return standardize(torch.relu(y), self.eps, dims=(2, 3, 4))


class MiddleConvLayersColumn(nn.Module):
    """CML: column conv1 (depth 10 -> 5), conv2 (5 -> 3), conv3 (3 -> 2).
    Takes per-voxel features and returns (B, C, D, nx, ny)."""

    def __init__(self, in_features: int = 128,
                 grid_shape: Sequence[int] = (352, 400, 10),
                 eps: float = 1e-6):
        super().__init__()
        self.conv1 = ColumnConv1ReluNorm(in_features, 64, grid_shape, eps)
        self.conv2 = Conv3dReluNorm(64, 64, (1, 1, 1), (0, 1, 1), eps)
        self.conv3 = Conv3dReluNorm(64, 64, (2, 1, 1), (1, 1, 1), eps)

    def forward(self, vfeat: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor) -> torch.Tensor:
        x = self.conv1(vfeat, coords, vmask)        # (B, nx, ny, D, C)
        x = x.permute(0, 4, 3, 1, 2).contiguous()   # (B, C, D, nx, ny)
        return self.conv3(self.conv2(x))


class RPN(nn.Module):
    """Region proposal network: 3 stride-2 conv stages, 3 deconvs back to
    full resolution, concatenated, then 1x1 score/box heads.  Input
    (B, C, H, W); returns (score (B, H/2, W/2, A) after the sigmoid,
    reg (B, H/2, W/2, A*7)) channels-last."""

    def __init__(self, in_features: int = 128, anchors_per_loc: int = 2,
                 box_dim: int = 7, eps: float = 1e-6,
                 trunk: Tuple = REFERENCE_RPN_TRUNK):
        super().__init__()
        (ch1, ch2, ch3), (e1, e2, e3), dch = trunk

        def block(cin, ch, n_extra):
            layers = [ConvReluNorm(cin, ch, 3, 2, 1, eps)]
            layers += [ConvReluNorm(ch, ch, 3, 1, 1, eps)
                       for _ in range(n_extra)]
            return nn.Sequential(*layers)

        self.blk1 = block(in_features, ch1, e1)
        self.blk2 = block(ch1, ch2, e2)
        self.blk3 = block(ch2, ch3, e3)
        self.deconv1 = DeconvReluNorm(ch1, dch, 3, 1, 1, eps)
        self.deconv2 = DeconvReluNorm(ch2, dch, 2, 2, 0, eps)
        self.deconv3 = DeconvReluNorm(ch3, dch, 4, 4, 0, eps)
        self.cls = nn.Conv2d(3 * dch, anchors_per_loc, 1)
        self.reg = nn.Conv2d(3 * dch, anchors_per_loc * box_dim, 1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Samples run one at a time, which computes the same function
        (every norm is per sample): at the default grid, cuDNN's
        heuristics pick an FFT algorithm for blk1's batched 128-channel
        3x3 convolutions that is several times slower than batch-1 calls
        (PERF.md)."""
        maps = [self.forward_one(x[i:i + 1]) for i in range(x.shape[0])]
        return (torch.cat([m[0] for m in maps]),
                torch.cat([m[1] for m in maps]))

    def forward_one(self, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x1 = self.blk1(x)
        x2 = self.blk2(x1)
        x3 = self.blk3(x2)
        feat = torch.cat([self.deconv1(x1), self.deconv2(x2),
                          self.deconv3(x3)], dim=1)
        score = torch.sigmoid(self.cls(feat))
        reg = self.reg(feat)
        return score.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)
