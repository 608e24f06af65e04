"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch

from mvxnet_makise_tpu_torch.utils.profiling import sync_point

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Raises when CUDA is asked for and absent, so a missing
    card never turns into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the "
            "host with the kernels' plain PyTorch versions")
    return dev


def use_full_f32() -> None:
    """Run float32 matmuls and convolutions in full float32.

    The JAX package computes in float32 by default (``use_bf16=False``).
    PyTorch on the card would run cuDNN convolutions in TF32 (about three
    decimal digits) unless told otherwise, so both switches are set off
    explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def use_deterministic_convolutions() -> None:
    """Let cuDNN pick only algorithms that sum in a fixed order.

    The RPN's transposed convolutions run as cuDNN's backward-data
    convolution, whose fastest algorithms add with atomics.  The stateless
    norms of an untrained model amplify such last-bit differences until
    detections change between two runs on the same frames."""
    torch.backends.cudnn.deterministic = True


def parameter_dtype(module: torch.nn.Module,
                    default: Optional[torch.dtype] = torch.float32
                    ) -> torch.dtype:
    """Floating dtype of a module's parameters (its compute dtype)."""
    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype
    return default


def device_constant(values: Sequence, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    values, dtype and device and then shared: callers must not write to
    it.  Made on the card it is a copy from pageable host memory, which
    waits for the card and which a CUDA graph cannot capture."""
    return _constant(tuple(values), dtype, torch.device(device))


@functools.lru_cache(maxsize=64)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    with sync_point():
        return torch.tensor(values, dtype=dtype, device=device)
