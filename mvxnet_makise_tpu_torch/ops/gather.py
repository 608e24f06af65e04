"""K2: the FPN bilinear gather — CUDA kernel and plain version.

Port of the function ``bilinear_gather_fpn_batch`` computes
(``mvxnet_makise_tpu/ops/gather.py``), whose Pallas twin is
``fpn_gather_banded`` (``ops/pallas_gather.py``): for every point, each
FPN level is bilinearly interpolated at the point's image projection and
the levels are concatenated.  :func:`fpn_gather` launches the CUDA kernel
(``csrc/fpn_gather.cu``, float32 or bfloat16 levels) for CUDA tensors and
runs :func:`fpn_gather_plain` for CPU tensors.

Its backward is JAX's custom VJP ``_bwd`` (``ops/pallas_gather.py``), an
XLA scatter-add there and plain PyTorch here on both devices
(:func:`fpn_gather_backward`): each valid point's four tap weights times
its cotangent are added into the level grids, in at least float32, and
the sums cast to the levels' dtype.  Like JAX's, it differentiates the
levels only (``points_rc`` and ``valid`` get no gradient).  No model path
runs it: the pyramid is frozen and detached.  :func:`fpn_gather_plain`
keeps plain autograd, which also differentiates into ``points_rc``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from mvxnet_makise_tpu_torch.ops.cuda_build import (
    CudaKernel,
    CudaLibrary,
    ptr,
    stream_handle,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LEVEL = (_P, _I, _I, _I, _F, _F)
_ARGS = (*(_LEVEL * 3), _P, _P, _P, _I, _I, _F, _I, _P)
# level dtype -> (kernel entry point, channels per 16-byte vector)
_DTYPES = {torch.float32: ("fpn_gather_f32", 4),
           torch.bfloat16: ("fpn_gather_bf16", 8)}
KERNEL = CudaKernel("fpn_gather", CudaLibrary(
    "fpn_gather.cu", {fn: _ARGS for fn, _ in _DTYPES.values()}))


class CallCount:
    """A count of calls of a plain PyTorch function, kept like a
    :class:`CudaKernel`'s ``launches`` so a run can show its path went
    through it."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


# calls of fpn_gather's backward (plain PyTorch: no kernel of its own)
BACKWARD = CallCount("fpn_gather_bwd")


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
                     swapped_weights: bool = False,
                     accumulate: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version: four tap gathers per level, the offsets
    rounded to the feature dtype, weighted and summed in ``accumulate``
    (default the feature dtype, as JAX's gather does; float32 is the
    bfloat16 kernel's formula) and returned in the feature dtype."""
    B, P = valid.shape
    bidx = torch.arange(B, device=points_rc.device)[:, None]
    outs = []
    for feat in features:
        _, Hf, Wf, C = feat.shape
        cells, fr, fc = _taps(points_rc, Hf, Wf, image_size, eps)
        acc = accumulate or feat.dtype
        fr, fc = (f.to(feat.dtype).to(acc)[..., None] for f in (fr, fc))
        tab = feat.reshape(B, Hf * Wf, C)
        taps = [tab[bidx, idx].to(acc) for idx in cells]
        outs.append(_bilerp(*taps, fr, fc, swapped_weights).to(feat.dtype))
    g = torch.cat(outs, dim=-1)
    return torch.where(valid[..., None], g, torch.zeros_like(g))


def _taps(points_rc, Hf: int, Wf: int, image_size, eps: float):
    """One level's four flat tap cells (B, P) in ``_bilerp``'s order and
    the fractional offsets (fr, fc), in the points' dtype (JAX's
    ``_taps``)."""
    im_h, im_w = image_size
    dev = points_rc.device
    # cell sizes as tensors on the device: PyTorch multiplies by the
    # reciprocal of a Python scalar on the card, the kernel divides
    ry, rx = (torch.tensor(v, dtype=points_rc.dtype, device=dev)
              for v in (im_h / Hf, im_w / Wf))
    r = torch.clamp(points_rc[..., 0] / ry - eps, 0.0, Hf - 1.0)
    c = torch.clamp(points_rc[..., 1] / rx - eps, 0.0, Wf - 1.0)
    r0, c0 = torch.floor(r).long(), torch.floor(c).long()
    r1 = torch.clamp(r0 + 1, max=Hf - 1)
    c1 = torch.clamp(c0 + 1, max=Wf - 1)
    cells = (r0 * Wf + c0, r1 * Wf + c0, r0 * Wf + c1, r1 * Wf + c1)
    return cells, r - r0.to(r.dtype), c - c0.to(c.dtype)


def fpn_gather_backward(grad: torch.Tensor, points_rc: torch.Tensor,
                        valid: torch.Tensor,
                        level_shapes: Sequence[Sequence[int]],
                        level_dtypes: Sequence[torch.dtype],
                        image_size: Sequence[float], *, eps: float = 1e-6,
                        swapped_weights: bool = False
                        ) -> List[torch.Tensor]:
    """The levels' gradients of :func:`fpn_gather` for the cotangent
    ``grad`` (B, P, sum C): JAX's transpose.  Per level, every valid
    point's four tap weights times its cotangent row are added
    (``index_add_``) into a (B * Hf * Wf, C) buffer of at least float32,
    which is cast to the level's dtype."""
    B, P = valid.shape
    dev = grad.device
    base = torch.arange(B, device=dev)[:, None]
    grads, off = [], 0
    for (_, Hf, Wf, C), dtype in zip(level_shapes, level_dtypes):
        acc = torch.promote_types(torch.promote_types(dtype, torch.float32),
                                  points_rc.dtype)
        g = grad[..., off:off + C].to(acc)
        off += C
        cells, fr, fc = _taps(points_rc, Hf, Wf, image_size, eps)
        if swapped_weights:
            weights = (fr * fc, (1 - fr) * fc, fr * (1 - fc),
                       (1 - fr) * (1 - fc))
        else:
            weights = ((1 - fr) * (1 - fc), fr * (1 - fc), (1 - fr) * fc,
                       fr * fc)
        ok = valid.to(acc)
        buf = torch.zeros((B * Hf * Wf, C), dtype=acc, device=dev)
        for cell, w in zip(cells, weights):
            buf.index_add_(0, (base * (Hf * Wf) + cell).reshape(-1),
                           ((w.to(acc) * ok)[..., None] * g)
                           .reshape(B * P, C))
        grads.append(buf.reshape(B, Hf, Wf, C).to(dtype))
    return grads


class _FpnGather(torch.autograd.Function):
    """:func:`fpn_gather` with JAX's VJP: the levels differentiate
    through :func:`fpn_gather_backward`, ``points_rc`` and ``valid`` not
    at all."""

    @staticmethod
    def forward(ctx, points_rc, valid, image_size, eps, swapped, *features):
        ctx.save_for_backward(points_rc, valid)
        ctx.geometry = (image_size, eps, swapped,
                        [tuple(f.shape) for f in features],
                        [f.dtype for f in features])
        return _fpn_gather_forward(features, points_rc, valid, image_size,
                                   eps, swapped)

    @staticmethod
    def backward(ctx, grad):
        points_rc, valid = ctx.saved_tensors
        image_size, eps, swapped, shapes, dtypes = ctx.geometry
        BACKWARD.launches += 1
        grads = fpn_gather_backward(grad, points_rc, valid, shapes, dtypes,
                                    image_size, eps=eps,
                                    swapped_weights=swapped)
        return (None, None, None, None, None, *grads)


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

    Returns (B, P, sum C) in the levels' dtype; invalid points 0.  CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise.  The kernel takes float32 levels whose channel counts are
    multiples of 4, or bfloat16 levels (the offsets rounded to bfloat16,
    the taps summed in float32, the sum rounded once) whose channel counts
    are multiples of 8, all three of one dtype.  Levels that require grad
    get JAX's gradient (:func:`fpn_gather_backward`) on either device;
    ``points_rc`` and ``valid`` never get one.
    """
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _FpnGather.apply(points_rc, valid, tuple(image_size), eps,
                                swapped_weights, *features)
    with torch.no_grad():       # nor points_rc, on either device
        return _fpn_gather_forward(features, points_rc, valid, image_size,
                                   eps, swapped_weights)


def _fpn_gather_forward(features, points_rc, valid, image_size, eps,
                        swapped_weights) -> torch.Tensor:
    """The forward of :func:`fpn_gather`: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
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
    dtype = features[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"the levels must be float32 or bfloat16, got "
                        f"{dtype}")
    fn, per_vector = _DTYPES[dtype]
    im_h, im_w = image_size
    level_args = []
    for f in features:
        if (f.dim() != 4 or f.shape[0] != B or f.dtype != dtype
                or f.device != dev or not f.is_contiguous()
                or f.shape[-1] % per_vector or f.data_ptr() % 16):
            raise ValueError(
                f"each level must be a contiguous, 16-byte aligned {dtype} "
                f"(B, Hf, Wf, C) tensor on {dev} with C % {per_vector} == 0, "
                f"got {tuple(f.shape)} {f.dtype}")
        _, Hf, Wf, C = f.shape
        level_args += [ptr(f), Hf, Wf, C, im_h / Hf, im_w / Wf]
    ctot = sum(f.shape[-1] for f in features)
    out = torch.empty((B, P, ctot), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    KERNEL.launch(fn, *level_args, ptr(points_rc), ptr(valid), ptr(out), B,
                  P, eps, int(bool(swapped_weights)), stream_handle(dev),
                  device=dev)
    return out
