"""Layer library: stateless standardization and the linear/conv blocks.

Port of ``mvxnet_makise_tpu/models/blocks.py``.  The reference's blocks
are Linear/Conv -> ReLU -> BatchNorm(affine=False,
track_running_stats=False): a stateless per-batch standardization, the
same at train and eval time, with the norm *after* the ReLU.

Per-sample statistics.  The JAX package runs the model once per sample
(``norm_scope="sample"``, ``train/state.per_sample_apply``), so every norm
sees one sample.  Here the batch axis stays and every reduction keeps
it: statistics are per sample by construction, and the kernels see whole
batches.  Tensors follow PyTorch's layouts: (B, rows, C) for pointwise
blocks, (B, C, H, W) for convolutions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def standardize(x: torch.Tensor, eps: float = 1e-6,
                dims: Sequence[int] = (2, 3)) -> torch.Tensor:
    """Zero-mean unit-variance over ``dims`` (biased variance, eps inside
    the square root) — torch BatchNorm(affine=False,
    track_running_stats=False) with per-sample statistics."""
    dims = tuple(dims)
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))


def masked_standardize(x: torch.Tensor, mask: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Per-sample, per-channel standardization over the rows of x
    (B, ..., C) where ``mask`` (B, ...) is true; masked-out rows get the
    same affine map and contribute nothing to the statistics."""
    m = mask[..., None].to(x.dtype)
    dims = tuple(range(1, x.dim() - 1))
    denom = torch.clamp(m.sum(dim=dims, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=dims, keepdim=True) / denom
    var = (torch.square(x - mean) * m).sum(dim=dims, keepdim=True) / denom
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))


class DenseReluNorm(nn.Module):
    """Linear -> ReLU -> (masked) standardize over the rows of each
    sample."""

    def __init__(self, in_features: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.eps = eps

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.relu(self.fc(x))
        if mask is None:
            mask = torch.ones(x.shape[:-1], dtype=torch.bool,
                              device=x.device)
        return masked_standardize(x, mask, self.eps)


def _moments(n_tot, sum_h, sum_h2, eps):
    """(mean, 1/std) from row counts and first and second sums."""
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
            self.eps)
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
            + (torch.square(hz) * wv).sum(dim=1), self.eps)
        mean, inv = mean[:, None], inv[:, None]
        return (h - mean) * inv, (hz - mean) * inv


class ConvReluNorm(nn.Module):
    """Conv2d -> ReLU -> standardize (per sample, over H and W)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, padding: int, eps: float = 1e-6):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride,
                              padding)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return standardize(torch.relu(self.conv(x)), self.eps)


class DeconvReluNorm(nn.Module):
    """ConvTranspose2d -> ReLU -> standardize (per sample)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, padding: int, eps: float = 1e-6):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_features, features, kernel,
                                         stride, padding)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return standardize(torch.relu(self.deconv(x)), self.eps)
