"""Training CLI of the port:

    python -m mvxnet_makise_tpu_torch.tools.train --synthetic N [-n EPOCHS]
        [-r RESUME] [--config FILE] [--batch-size B] [--keep-last K]
        [--max-seconds S] [--device cuda|cpu]

Port of ``mvxnet_makise_tpu/tools/train.py`` on synthetic frames
(``data/synthetic.py``).  Training on a KITTI tree (``dataroot``) needs the
host-data slice and is refused.  Runs on the CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.train")
    p.add_argument("dataroot", nargs="?", default=None)
    p.add_argument("-n", "--numepochs", type=int, default=10)
    p.add_argument("-r", "--resume", type=int, default=0)
    p.add_argument("--config", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic frames (no dataset needed)")
    p.add_argument("--keep-last", type=int, default=None, metavar="N",
                   help="prune all but the newest N epoch checkpoints "
                        "after each save (default: keep all)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop cleanly after the last full epoch once "
                        "this wall-clock budget is spent")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.dataroot:
        p.error("training on a dataset root needs the host-data slice "
                "(ROADMAP item 9); use --synthetic N")
    if args.synthetic <= 0:
        p.error("give --synthetic N (N > 0)")

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
    from mvxnet_makise_tpu_torch.train.loop import Frame, train

    overrides = {"num_epochs": args.numepochs}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.keep_last is not None:
        overrides["checkpoint_keep_last"] = args.keep_last
    cfg = load_config(args.config, **overrides)
    if cfg.target_classes != ("Car",):
        p.error("synthetic frames hold cars only: target_classes must be "
                "('Car',)")

    rng = np.random.default_rng(cfg.seed)
    frames = []
    for i in range(args.synthetic):
        pts, calib, image, boxes = synthetic_frame(rng, cfg)
        frames.append(Frame(frame_id=f"synth{i:06d}", points=pts,
                            image=image, calib=calib, boxes={"Car": boxes}))
    train(cfg, frames, resume_epoch=args.resume,
          time_budget_s=args.max_seconds, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
