"""K2: the FPN bilinear gather — CUDA kernel and plain version.

Port of the function ``bilinear_gather_fpn_batch`` computes
(``mvxnet_makise_tpu/ops/gather.py``), whose Pallas twin is
``fpn_gather_banded`` (``ops/pallas_gather.py``): for every point, each
FPN level is bilinearly interpolated at the point's image projection and
the levels are concatenated.  :func:`fpn_gather` launches the CUDA kernel
(``csrc/fpn_gather.cu``) for CUDA tensors and runs
:func:`fpn_gather_plain` for CPU tensors.  No backward: the pyramid is
frozen and detached on the model path.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mvxnet_makise_tpu_torch.ops.cuda_build import (
    CudaKernel,
    ptr,
    stream_handle,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LEVEL = (_P, _I, _I, _I, _F, _F)
KERNEL = CudaKernel(
    "fpn_gather", "fpn_gather.cu",
    {"fpn_gather_f32": (*(_LEVEL * 3), _P, _P, _P, _I, _I, _F, _I, _P)})


def _bilerp(f00, f10, f01, f11, fr, fc, swapped: bool):
    if swapped:
        # the reference's weights (featureMaping, imhead/Pipe.py:72-75)
        return (f00 * fr * fc + f10 * (1 - fr) * fc
                + f01 * fr * (1 - fc) + f11 * (1 - fr) * (1 - fc))
    return (f00 * (1 - fr) * (1 - fc) + f10 * fr * (1 - fc)
            + f01 * (1 - fr) * fc + f11 * fr * fc)


def fpn_gather_plain(features: Sequence[torch.Tensor],
                     points_rc: torch.Tensor, valid: torch.Tensor,
                     image_size: Sequence[float], *, eps: float = 1e-6,
                     swapped_weights: bool = False) -> torch.Tensor:
    """Plain PyTorch version: four tap gathers per level."""
    im_h, im_w = image_size
    B, P = valid.shape
    dev = points_rc.device
    bidx = torch.arange(B, device=dev)[:, None]
    outs = []
    for feat in features:
        _, Hf, Wf, C = feat.shape
        # cell sizes as tensors on the device: PyTorch multiplies by the
        # reciprocal of a Python scalar on the card, the kernel divides
        ry, rx = (torch.tensor(v, dtype=points_rc.dtype, device=dev)
                  for v in (im_h / Hf, im_w / Wf))
        r = torch.clamp(points_rc[..., 0] / ry - eps, 0.0, Hf - 1.0)
        c = torch.clamp(points_rc[..., 1] / rx - eps, 0.0, Wf - 1.0)
        r0 = torch.floor(r).long()
        c0 = torch.floor(c).long()
        fr = (r - r0.to(r.dtype)).to(feat.dtype)[..., None]
        fc = (c - c0.to(c.dtype)).to(feat.dtype)[..., None]
        r1 = torch.clamp(r0 + 1, max=Hf - 1)
        c1 = torch.clamp(c0 + 1, max=Wf - 1)
        tab = feat.reshape(B, Hf * Wf, C)
        taps = [tab[bidx, idx] for idx in (r0 * Wf + c0, r1 * Wf + c0,
                                           r0 * Wf + c1, r1 * Wf + c1)]
        outs.append(_bilerp(*taps, fr, fc, swapped_weights))
    g = torch.cat(outs, dim=-1)
    return torch.where(valid[..., None], g, torch.zeros_like(g))


def fpn_gather(features: Sequence[torch.Tensor], points_rc: torch.Tensor,
               valid: torch.Tensor, image_size: Sequence[float], *,
               eps: float = 1e-6,
               swapped_weights: bool = False) -> torch.Tensor:
    """Bilinear FPN gather in point order.

    Args:
      features: 3 levels, each (B, Hf, Wf, C) channels-last.
      points_rc: (B, P, 2) (row, col) in original-image pixels.
      valid: (B, P) bool.
      image_size: (h, w) mapping original pixels to feature cells
        (``models/image_head.gather_image_size``).

    Returns (B, P, sum C); invalid points 0.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.  The kernel takes
    float32 levels whose channel counts are multiples of 4.
    """
    if points_rc.device.type == "cpu":
        return fpn_gather_plain(features, points_rc, valid, image_size,
                                eps=eps, swapped_weights=swapped_weights)
    dev = points_rc.device
    if dev.type != "cuda":
        raise ValueError(f"fpn_gather: unsupported device {dev}")
    if len(features) != 3:
        raise ValueError(f"the kernel takes 3 levels, got {len(features)}")
    if points_rc.dim() != 3 or points_rc.shape[-1] != 2:
        raise ValueError(f"points_rc must be (B, P, 2), got "
                         f"{tuple(points_rc.shape)}")
    B, P, _ = points_rc.shape
    if points_rc.dtype != torch.float32 or not points_rc.is_contiguous():
        raise ValueError("points_rc must be contiguous float32")
    if (tuple(valid.shape) != (B, P) or valid.dtype != torch.bool
            or valid.device != dev or not valid.is_contiguous()):
        raise ValueError(f"valid must be contiguous bool (B, P) on {dev}")
    im_h, im_w = image_size
    level_args = []
    for f in features:
        if (f.dim() != 4 or f.shape[0] != B or f.dtype != torch.float32
                or f.device != dev or not f.is_contiguous()
                or f.shape[-1] % 4 or f.data_ptr() % 16):
            raise ValueError(
                "each level must be a contiguous, 16-byte aligned float32 "
                f"(B, Hf, Wf, C) tensor on {dev} with C % 4 == 0, got "
                f"{tuple(f.shape)} {f.dtype}")
        _, Hf, Wf, C = f.shape
        level_args += [ptr(f), Hf, Wf, C, im_h / Hf, im_w / Wf]
    ctot = sum(f.shape[-1] for f in features)
    out = torch.empty((B, P, ctot), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    KERNEL.launch("fpn_gather_f32", *level_args, ptr(points_rc), ptr(valid),
                  ptr(out), B, P, eps, int(bool(swapped_weights)),
                  stream_handle(dev))
    return out
