"""Per-epoch checkpoints with ``torch.save``.

Port of ``mvxnet_makise_tpu/train/checkpoint.py``: one file
``<checkpoint_dir>/epoch{n}`` per epoch holds the model's and the
optimizer's state dicts, the step count and the epoch, and ``-r n``
resumes from it.  A checkpoint is written under a temporary name and
renamed into place, so a run killed mid-save never leaves a partial
``epoch{n}``.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import torch

from mvxnet_makise_tpu_torch.train.state import TrainState


def _path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, f"epoch{epoch}"))


def save_checkpoint(checkpoint_dir: str, epoch: int,
                    state: TrainState) -> str:
    """Save (model, optimizer, step, epoch) for ``epoch``.  Returns the
    path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = _path(checkpoint_dir, epoch)
    fd, tmp = tempfile.mkstemp(prefix=f".epoch{epoch}-",
                               dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "step": state.step, "epoch": epoch}, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def _load(checkpoint_dir: str, epoch: int) -> dict:
    # tensors load to the CPU first: load_state_dict moves them onto the
    # parameters' device
    return torch.load(_path(checkpoint_dir, epoch), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(checkpoint_dir: str, epoch: int,
                       state: TrainState) -> TrainState:
    """Load epoch ``epoch``'s checkpoint into ``state`` (in place) and
    return it.  ``load_state_dict`` moves the model's and AdamW's moments
    onto the parameters' device and keeps AdamW's step counters on the
    CPU, where a fresh run keeps them."""
    saved = _load(checkpoint_dir, epoch)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def restore_model(checkpoint_dir: str, epoch: int,
                  model: torch.nn.Module) -> torch.nn.Module:
    """Load epoch ``epoch``'s model weights into ``model`` (in place; no
    optimizer) and return it."""
    model.load_state_dict(_load(checkpoint_dir, epoch)["model"], strict=True)
    return model


def _epochs(checkpoint_dir: str) -> List[int]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return [int(name[5:]) for name in os.listdir(checkpoint_dir)
            if name.startswith("epoch") and name[5:].isdigit()]


def prune_checkpoints(checkpoint_dir: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` epoch checkpoints."""
    if keep_last <= 0:
        return
    for e in sorted(_epochs(checkpoint_dir))[:-keep_last]:
        print(f"prune_checkpoints: deleting {checkpoint_dir}/epoch{e} "
              f"(keep_last={keep_last})")
        os.unlink(_path(checkpoint_dir, e))


def latest_epoch(checkpoint_dir: str) -> Optional[int]:
    """Highest epoch number present, or None."""
    epochs = _epochs(checkpoint_dir)
    return max(epochs) if epochs else None
