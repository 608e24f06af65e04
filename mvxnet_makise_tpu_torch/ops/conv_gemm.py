"""Stride-1 convolutions as im2col and one batched GEMM, in every pass.

The training step's RPN runs its stride-1 3x3 convolutions, the
transposed one included, through :func:`conv2d_gemm` and
:func:`conv_transpose2d_gemm` (``models/voxelnet.RPN``).  cuDNN's
heuristics send those shapes, at the grid's 176x200 in float32 without
TF32, to FFT algorithms in either layout, NCHW or NHWC: the transposed
convolution's data gradient alone ran as ~33,000 launches of cuBLAS
gemv and complex GEMM a batch (PERF.md).  Here each pass is an explicit
product over ``F.unfold`` columns, so no heuristic picks the algorithm:

- forward: ``y = W (Cout, Cin*k*k) @ unfold(x)``, per sample in one
  batched GEMM;
- data gradient: the same product with the kernel transposed and
  flipped over the cotangent's columns (a stride-1 convolution's
  adjoint is a stride-1 convolution, padded ``k - 1 - p``);
- weight gradient: ``dy @ unfold(x)^T``, summed over the batch.

The function is ``F.conv2d``'s; only the order of the float sums
differs.  Tensors are (B, C, H, W).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _flipped(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> (Cin, Cout, kh, kw), turned half a circle:
    the kernel of a stride-1 convolution's adjoint."""
    return weight.transpose(0, 1).flip(2, 3)


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          padding: Tuple[int, int]) -> torch.Tensor:
    B, _, H, W = x.shape
    cout, _, kh, kw = weight.shape
    ho, wo = H + 2 * padding[0] - kh + 1, W + 2 * padding[1] - kw + 1
    cols = F.unfold(x, (kh, kw), padding=padding)       # (B, Cin*kh*kw, S)
    w = weight.reshape(1, cout, -1).expand(B, -1, -1)
    y = torch.bmm(w, cols)                                # (B, Cout, S)
    if bias is not None:
        y += bias[:, None]
    return y.view(B, cout, ho, wo)


class _Conv2dGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        return _conv(x, weight, bias, padding)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        kh, kw = weight.shape[2:]
        ph, pw = ctx.padding
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _conv(gy, _flipped(weight), None, (kh - 1 - ph, kw - 1 - pw))
        if ctx.needs_input_grad[1]:
            cols = F.unfold(x, (kh, kw), padding=(ph, pw))
            gw = torch.bmm(gy.flatten(2), cols.transpose(1, 2)).sum(0)
            gw = gw.view(weight.shape)
        if ctx.needs_input_grad[2]:
            gb = gy.sum(dim=(0, 2, 3))
        return gx, gw, gb, None


def conv2d_gemm(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], padding: Tuple[int, int]
                ) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride=1, padding=padding)``."""
    return _Conv2dGemm.apply(x, weight, bias, tuple(padding))


def conv_transpose2d_gemm(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          padding: Tuple[int, int]) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, bias, stride=1, padding=padding)``
    (weight (Cin, Cout, kh, kw)): the convolution with the flipped kernel,
    padded ``k - 1 - p``."""
    kh, kw = weight.shape[2:]
    return conv2d_gemm(x, _flipped(weight), bias,
                       (kh - 1 - padding[0], kw - 1 - padding[1]))
