"""Process-group initialization and the world-wide mesh.

Port of ``mvxnet_makise_tpu/parallel/distributed.py``.  JAX reads
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``
and calls ``jax.distributed.initialize``; here the launcher is
``torchrun``, which sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, and the call is
``torch.distributed.init_process_group``: NCCL on the CUDA cards (one
rank per card, the card picked by ``LOCAL_RANK``), gloo on the CPU.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mvxnet_makise_tpu_torch.device import DeviceLike, resolve_device
from mvxnet_makise_tpu_torch.parallel.mesh import make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, *,
                           device: DeviceLike = None,
                           timeout: Optional[timedelta] = None) -> bool:
    """Initialize the default process group when the environment or the
    arguments describe a multi-process run; returns True when running
    distributed.  A single-process run (no ``WORLD_SIZE`` in the
    environment, no arguments) returns False and initializes nothing, so
    callers can call it unconditionally.

    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); ``world_size`` and ``rank`` to ``WORLD_SIZE`` and
    ``RANK``.  ``backend`` defaults to NCCL for ``device`` on the CUDA
    card (the default) and gloo for ``device="cpu"``; NCCL sets this
    process's card from ``LOCAL_RANK`` and raises without a card (it
    never falls back to gloo)."""
    env = os.environ
    if init_method is None and world_size is None \
            and "WORLD_SIZE" not in env:
        return False
    if dist.is_initialized():
        return True
    if world_size is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("world_size not given and WORLD_SIZE not set")
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        if "RANK" not in env:
            raise ValueError("rank not given and RANK not set")
        rank = int(env["RANK"])
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return True


def global_mesh(model_axis: int = 1,
                devices: Optional[Sequence[int]] = None):
    """A ('data', 'model') mesh over every rank of the world (or the
    ranks ``devices``): ``model_axis`` consecutive ranks per model group,
    which ``torchrun`` places on one host's cards; the data axis spans
    the rest."""
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("global_mesh needs an initialized process "
                               "group (initialize_distributed)")
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model axis "
                         f"{model_axis}")
    return make_mesh((n // model_axis, model_axis), devices)


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs: rank
    0, or the only process of an uninitialized run."""
    return not dist.is_initialized() or dist.get_rank() == 0
