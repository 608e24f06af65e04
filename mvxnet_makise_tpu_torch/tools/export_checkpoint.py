"""Export one of the port's checkpoints as a reference-layout PyTorch
state dict file, so a model trained here loads into the PyTorch reference
(``MVXNet().load_state_dict(torch.load(out.pkl))``): the reverse of
``--image-weights`` and ``models.import_reference``.

Port of ``mvxnet_makise_tpu/tools/export_checkpoint.py``.  The export is
host work on the checkpoint's tensors: no model is built and no device is
used.  Whether the checkpoint holds the fused or the LiDAR-only detector
is read from its keys; ``--lidar-only`` is accepted for the JAX tool's
command line and changes nothing.

Usage: python -m mvxnet_makise_tpu_torch.tools.export_checkpoint
           [-r EPOCH] [--lidar-only] [-o out.pkl] [--checkpoint-dir DIR]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.export_checkpoint")
    p.add_argument("-r", "--epoch", type=int, default=None,
                   help="epoch to export (default: the latest)")
    p.add_argument("-o", "--output", default="exported_reference.pkl")
    p.add_argument("--lidar-only", action="store_true",
                   help="accepted for the JAX tool's command line; the "
                        "detector kind is read from the checkpoint")
    p.add_argument("--checkpoint-dir", default="./checkpoints")
    args = p.parse_args(argv)

    import torch

    from mvxnet_makise_tpu_torch.models.import_reference import (
        export_reference_checkpoint,
    )
    from mvxnet_makise_tpu_torch.train import checkpoint as ckpt

    epoch = args.epoch or ckpt.latest_epoch(args.checkpoint_dir)
    if not epoch:
        p.error(f"no checkpoint found in {args.checkpoint_dir}")
    state = ckpt.model_state(args.checkpoint_dir, epoch)
    fused = any(k.startswith("head.") for k in state)
    sd = export_reference_checkpoint(state, with_images=fused)
    torch.save(sd, args.output)
    print(f"exported epoch {epoch} ({'fused' if fused else 'LiDAR-only'}) "
          f"-> {args.output} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
