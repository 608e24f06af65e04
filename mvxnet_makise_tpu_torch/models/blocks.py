"""Layer library: stateless standardization and the linear/conv blocks.

Port of ``mvxnet_makise_tpu/models/blocks.py``.  The reference's blocks
are Linear/Conv -> ReLU -> BatchNorm(affine=False,
track_running_stats=False): a stateless per-batch standardization, the
same at train and eval time, with the norm *after* the ReLU.

Statistics scope.  Under ``norm_scope="sample"`` (the default) the JAX
package runs the model once per sample (``train/state.per_sample_apply``),
so every norm sees one sample.  Here the batch axis stays and every
reduction keeps it: statistics are per sample, and the kernels see whole
batches.  Under ``norm_scope="batch"`` JAX applies the model to the whole
batch, and every norm reduces over the batch axis too.  The port's norm
modules carry that choice as the attribute ``batch_stats``, which
:func:`set_norm_scope` sets on a whole model when it is built
(``models/mvxnet.build_model``); each reduction reads it.  JAX measured
batch-wide statistics stalling convergence on diverse scenes
(``mvxnet_makise_tpu/train/state.py``, ``per_sample_apply``): the scope is
there for A/B runs, and "sample" is the reference's function.  Tensors
follow PyTorch's layouts: (B, rows, C) for pointwise blocks, (B, C, H, W)
for convolutions.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mvxnet_makise_tpu_torch.ops.conv_gemm import (
    conv2d_gemm,
    conv_transpose2d_gemm,
)
from mvxnet_makise_tpu_torch.utils.profiling import sync_point


def set_norm_scope(model: nn.Module, scope: str,
                   group: Optional[Any] = None) -> nn.Module:
    """Set every norm of ``model`` to per-sample (``scope="sample"``) or
    batch-wide (``"batch"``) statistics; returns the model.  ``group``: the
    data ranks' process group of a mesh, over which batch-wide statistics
    are pooled (None: this process's batch is the whole batch).  Sample
    scope needs no communication and ignores it."""
    if scope not in ("sample", "batch"):
        raise ValueError(f"unknown norm_scope {scope!r}")
    for m in model.modules():
        if hasattr(m, "batch_stats"):
            m.batch_stats = scope == "batch"
            m.stats_group = group if scope == "batch" else None
    return model


def pooled(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over ``group``'s ranks, in one all-reduce in at
    least float32 (differentiable), and returned in its own dtype; as
    they are when ``group`` is None."""
    if group is None:
        return list(tensors)
    from mvxnet_makise_tpu_torch.parallel.tensor import all_reduce_sum

    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = all_reduce_sum(torch.cat([t.to(dtype).reshape(-1)
                                     for t in tensors]), group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def standardize(x: torch.Tensor, eps: float = 1e-6,
                dims: Sequence[int] = (2, 3),
                batch: bool = False, group: Optional[Any] = None
                ) -> torch.Tensor:
    """Zero-mean unit-variance over ``dims`` (biased variance, eps inside
    the square root) — torch BatchNorm(affine=False,
    track_running_stats=False) with per-sample statistics, or with
    ``batch`` over the batch axis too (and with ``group`` over the batch
    axis of every data rank)."""
    dims = (0, *dims) if batch else tuple(dims)
    if batch and group is not None:
        # summed in at least float32 and rounded once, as ``mean`` does
        acc = torch.promote_types(x.dtype, torch.float32)
        with sync_point():   # a copy from pageable host memory
            n = torch.tensor(float(np.prod([x.shape[d] for d in dims])),
                             dtype=acc, device=x.device)
        s, n = pooled([x.sum(dim=dims, keepdim=True, dtype=acc), n], group)
        mean = (s / n).to(x.dtype)
        (ss,) = pooled([torch.square(x - mean).sum(dim=dims, keepdim=True,
                                                   dtype=acc)], group)
        var = (ss / n).to(x.dtype)
    else:
        mean = x.mean(dim=dims, keepdim=True)
        var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))


def masked_standardize(x: torch.Tensor, mask: torch.Tensor,
                       eps: float = 1e-6, batch: bool = False,
                       group: Optional[Any] = None) -> torch.Tensor:
    """Per-sample (with ``batch``, batch-wide; with ``group`` too, over
    every data rank's batch), per-channel standardization over the rows of
    x (B, ..., C) where ``mask`` (B, ...) is true; masked-out rows get the
    same affine map and contribute nothing to the statistics."""
    m = mask[..., None].to(x.dtype)
    dims = tuple(range(0 if batch else 1, x.dim() - 1))
    group = group if batch else None
    msum, xsum = pooled([m.sum(dim=dims, keepdim=True),
                         (x * m).sum(dim=dims, keepdim=True)], group)
    denom = torch.clamp(msum, min=1.0)
    mean = xsum / denom
    (ssum,) = pooled([(torch.square(x - mean) * m).sum(dim=dims,
                                                       keepdim=True)],
                     group)
    var = ssum / denom
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))


class DenseReluNorm(nn.Module):
    """Linear -> ReLU -> (masked) standardize over the rows of each
    sample."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.eps = eps
        self.batch_stats = False
        self.stats_group = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.relu(self.fc(x))
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool,
                              device=x.device)
        return masked_standardize(x, mask, self.eps, self.batch_stats,
                                  self.stats_group)


def _moments(n_tot, sum_h, sum_h2, eps, batch: bool, group=None):
    """(mean, 1/std) from per-sample (B, C) row counts and first and
    second sums; with ``batch`` the sums are pooled over the batch into
    (1, C), and with ``group`` over every data rank's batch."""
    if batch:
        n_tot, sum_h, sum_h2 = pooled([t.sum(dim=0, keepdim=True)
                                       for t in (n_tot, sum_h, sum_h2)],
                                      group)
    mean = sum_h / n_tot
    var = torch.clamp(sum_h2 / n_tot - torch.square(mean), min=0.0)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    return mean, inv


class DenseReluNormVirtual(nn.Module):
    """Linear -> ReLU -> standardize over real rows plus ``n_virtual``
    copies of one constant row per sample (the image-fusion MLP's empty
    sample slots, accounted for in closed form)."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.eps = eps
        self.batch_stats = False
        self.stats_group = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
                n_virtual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, P, C); mask: (B, P); z: (B, C) virtual row per sample;
        n_virtual: (B,) counts.  Returns (x', z')."""
        h = torch.relu(self.fc(x))
        hz = torch.relu(self.fc(z))
        m = mask[..., None].to(h.dtype)
        nv = n_virtual.to(h.dtype)[:, None]
        n_tot = m.sum(dim=1) + nv
        mean, inv = _moments(
            n_tot, (h * m).sum(dim=1) + nv * hz,
            (torch.square(h) * m).sum(dim=1) + nv * torch.square(hz),
            self.eps, self.batch_stats, self.stats_group)
        return (h - mean[:, None]) * inv[:, None], (hz - mean) * inv


class DenseReluNormVirtualWeighted(nn.Module):
    """Linear -> ReLU -> standardize over real rows plus weighted
    per-group constant rows: group (voxel) g of a sample adds ``w_g``
    copies of its own row ``z_g`` to the statistics — the point-major VFE
    stack's empty sample slots."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.eps = eps
        self.batch_stats = False
        self.stats_group = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
                w: torch.Tensor, zmask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, P, C); mask: (B, P); z: (B, V, C); w: (B, V)
        multiplicities; zmask: (B, V).  Returns (x', z')."""
        h = torch.relu(self.fc(x))
        hz = torch.relu(self.fc(z))
        m = mask[..., None].to(h.dtype)
        wv = (w * zmask).to(h.dtype)[..., None]
        n_tot = m.sum(dim=1) + wv.sum(dim=1)
        mean, inv = _moments(
            n_tot,
            (h * m).sum(dim=1) + (hz * wv).sum(dim=1),
            (torch.square(h) * m).sum(dim=1)
            + (torch.square(hz) * wv).sum(dim=1), self.eps,
            self.batch_stats, self.stats_group)
        mean, inv = mean[:, None], inv[:, None]
        return (h - mean) * inv, (hz - mean) * inv


def conv2d(m: nn.Module, x: torch.Tensor, gemm: bool = False
           ) -> torch.Tensor:
    """``m(x)`` for an ``nn.Conv2d`` or ``nn.ConvTranspose2d``.  With
    ``gemm`` a stride-1 one runs as im2col and a GEMM in every pass
    (``ops/conv_gemm``), where cuDNN's heuristics pick FFT; a strided one,
    which they keep off FFT while ``cudnn.deterministic`` is off (PERF.md),
    stays with cuDNN, as does a model-axis slice of a layer
    (``parallel.tensor.ColumnParallel``)."""
    if not (gemm and isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
            and m.stride == (1, 1) and m.dilation == (1, 1)
            and m.groups == 1):
        return m(x)
    if isinstance(m, nn.ConvTranspose2d):
        return conv_transpose2d_gemm(x, m.weight, m.bias, m.padding)
    return conv2d_gemm(x, m.weight, m.bias, m.padding)


class ConvReluNorm(nn.Module):
    """Conv2d -> ReLU -> standardize (per sample, over H and W); ``gemm``
    as :func:`conv2d`."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, padding: int, eps: float = 1e-6):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride,
                              padding)
        self.eps = eps
        self.batch_stats = False
        self.stats_group = None

    def forward(self, x: torch.Tensor, gemm: bool = False) -> torch.Tensor:
        return standardize(torch.relu(conv2d(self.conv, x, gemm)), self.eps,
                           batch=self.batch_stats, group=self.stats_group)


class DeconvReluNorm(nn.Module):
    """ConvTranspose2d -> ReLU -> standardize (per sample); ``gemm`` as
    :func:`conv2d`."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, padding: int, eps: float = 1e-6):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_features, features, kernel,
                                         stride, padding)
        self.eps = eps
        self.batch_stats = False
        self.stats_group = None

    def forward(self, x: torch.Tensor, gemm: bool = False) -> torch.Tensor:
        return standardize(torch.relu(conv2d(self.deconv, x, gemm)),
                           self.eps, batch=self.batch_stats,
                           group=self.stats_group)
