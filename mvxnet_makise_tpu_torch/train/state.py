"""Train state: the frozen image extractor, AdamW and its schedule, and the
bfloat16 compute policy.

Port of ``mvxnet_makise_tpu/train/state.py``.  The reference trains with
AdamW over the parameters that require gradients; the frozen Faster R-CNN
extractor is left out.  Here the extractor's parameters are left out of the
optimizer entirely: torch's AdamW would still decay a parameter whose
gradient is a zero tensor, while optax's ``set_to_zero`` leaves it as it
is.  AdamW's defaults are optax's (``weight_decay=1e-4``, betas (0.9,
0.999), ``eps=cfg.eps``), not torch's (``weight_decay=1e-2``).

Under ``use_bf16`` the module keeps its float32 parameters (the masters,
which AdamW updates and checkpoints hold) and the forward runs on bfloat16
copies of them (:func:`cast_for_compute`, ``train/step.forward``), as JAX
casts the parameter tree for each step: every op then runs in the dtype of
its operands, as under JAX, and gradients flow back through the casts into
the masters.  ``torch.autocast`` would compute another function (it keeps
norms, reductions and losses in float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from mvxnet_makise_tpu_torch.config import Config

# optax.adamw's default
WEIGHT_DECAY = 1e-4


def is_frozen(name: str) -> bool:
    """True for parameters of the frozen image feature extractor."""
    return "extractor" in name.split(".")


def trainable_parameters(model: nn.Module) -> List[nn.Parameter]:
    return [p for n, p in model.named_parameters() if not is_frozen(n)]


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Learning rate at a step count (the count before the update, as
    optax evaluates it).  "constant" is the reference's flat rate;
    "cosine" is ``optax.warmup_cosine_decay_schedule`` from lr/25 up to lr
    over ``lr_warmup_steps``, then down to lr/20 by ``lr_decay_steps``."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    init, peak, end = lr / 25, lr, lr / 20
    warmup = cfg.lr_warmup_steps
    decay = max(cfg.lr_decay_steps, warmup + 1) - warmup
    alpha = end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - count / warmup
            return (init - peak) * frac + peak
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over every parameter but the extractor's, with optax's
    defaults; its rate is set from :func:`lr_schedule` before each
    update."""
    return torch.optim.AdamW(trainable_parameters(model),
                             lr=lr_schedule(cfg)(0), betas=(0.9, 0.999),
                             eps=cfg.eps, weight_decay=WEIGHT_DECAY)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of updates applied."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    @classmethod
    def create(cls, cfg: Config, model: nn.Module) -> "TrainState":
        for name, p in model.named_parameters():
            if is_frozen(name):
                p.requires_grad_(False)
        return cls(model, make_optimizer(cfg, model), lr_schedule(cfg))

    def apply_gradients(self) -> None:
        """One AdamW update from the gradients in ``.grad``, at the rate
        of the current step count."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def cast_for_compute(model: nn.Module, use_bf16: bool,
                     with_images: bool = True
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """The tensors the forward runs with (JAX's ``cast_for_compute``), for
    ``torch.func.functional_call``: None (the module's own) unless
    ``use_bf16``; then every floating parameter and buffer rounded to
    bfloat16, differentiable back into the float32 masters.

    They come in the dtype JAX's promotion gives the forward: bfloat16 for
    the fused model, whose images are cast; float32 for the LiDAR-only
    branch (``with_images=False``), whose point features stay float32 and
    promote the bfloat16 parameters, so it computes in float32 with
    bfloat16-rounded weights."""
    if not use_bf16:
        return None
    dtype = torch.bfloat16 if with_images else torch.float32
    tensors = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
    return {name: t.to(torch.bfloat16).to(dtype) if t.is_floating_point()
            else t for name, t in tensors.items()}
