"""Training CLI of the port:

    python -m mvxnet_makise_tpu_torch.tools.train <dataroot> [-n EPOCHS]
        [-r RESUME] [--config FILE] [--batch-size B] [--limit N]
        [--no-augment] [--eval-every N] [--eval-limit N] [--keep-last K]
        [--max-seconds S] [--bf16] [--lidar-only] [--device cuda|cpu]
    python -m mvxnet_makise_tpu_torch.tools.train --synthetic N [...]

Port of ``mvxnet_makise_tpu/tools/train.py``.  From a KITTI tree it trains
on the train split, with the GT-paste augmentation when
``training/gtdatabase`` exists (``tools.create_gtdatabase``) unless
``--no-augment``, and with ``--eval-every N`` prints the val split's AP
every N epochs.  ``--synthetic N`` trains on N synthetic frames instead
(held-out synthetic frames for ``--eval-every``).  ``--bf16`` computes in
bfloat16 (``use_bf16``, as a config may also say); ``--lidar-only`` trains
the VoxelNet branch without the image head, from frames loaded without
their images.  Runs on the CUDA card unless ``--device cpu``.  The JAX
CLI's ``--image-weights`` is not in the port yet (ROADMAP queue 1) and is
refused.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--no-augment", action="store_true",
                   help="train without the GT-paste augmentation")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic frames (no dataset needed)")
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of dataset frames loaded")
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="print the val split's AP every N epochs (0: off)")
    p.add_argument("--eval-limit", type=int, default=None)
    p.add_argument("--keep-last", type=int, default=None, metavar="N",
                   help="prune all but the newest N epoch checkpoints "
                        "after each save (default: keep all)")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop cleanly after the last full epoch once "
                        "this wall-clock budget is spent")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bfloat16 (use_bf16)")
    p.add_argument("--lidar-only", action="store_true",
                   help="train the VoxelNet branch without the image head")
    p.add_argument("--image-weights", default=None,
                   help="not in the port yet: refused")
    args = p.parse_args(argv)
    if args.image_weights:
        p.error("--image-weights (torchvision's extractor weights) is not "
                "in the port yet (ROADMAP queue 1, item 9: "
                "--image-weights)")

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.train.loop import train

    overrides = {"num_epochs": args.numepochs}
    if args.dataroot:
        overrides["data_root"] = args.dataroot
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.keep_last is not None:
        overrides["checkpoint_keep_last"] = args.keep_last
    if args.bf16:
        overrides["use_bf16"] = True
    cfg = load_config(args.config, **overrides)
    with_images = not args.lidar_only

    gt_db, eval_frames = None, None
    if args.synthetic > 0:
        from mvxnet_makise_tpu_torch.data.synthetic import (
            synthetic_frame,
            synthetic_frame_multiclass,
        )

        rng = np.random.default_rng(cfg.seed)

        def make(i):
            if len(cfg.target_classes) > 1:
                pts, calib, image, by_cls = synthetic_frame_multiclass(
                    rng, cfg)
            else:
                pts, calib, image, boxes = synthetic_frame(rng, cfg)
                by_cls = {cfg.target_classes[0]: boxes}
            return KittiFrame(frame_id=f"synth{i:06d}", points=pts,
                              image=image, calib=calib, boxes=by_cls)

        frames = [make(i) for i in range(args.synthetic)]
        if args.eval_every:
            # held-out synthetic frames: the same generator, fresh draws
            n_eval = args.eval_limit or max(args.synthetic // 4, 2)
            eval_frames = [make(args.synthetic + i) for i in range(n_eval)]
    else:
        if not args.dataroot or not os.path.isdir(args.dataroot):
            p.error("dataroot missing (or use --synthetic N)")
        from mvxnet_makise_tpu_torch.data.kitti import load_dataset

        frames = load_dataset(cfg.data_root, "train", cfg,
                              load_images=with_images, limit=args.limit)
        if args.eval_every:
            eval_frames = load_dataset(cfg.data_root, "val", cfg,
                                       load_images=with_images,
                                       limit=args.eval_limit)
        if not args.no_augment:
            from mvxnet_makise_tpu_torch.data.gt_database import (
                load_database,
            )

            if os.path.isdir(os.path.join(cfg.data_root, "training",
                                          "gtdatabase")):
                gt_db = load_database(cfg.data_root, cfg.target_classes)
            else:
                print("no gtdatabase found: training without the paste "
                      "augmentation (build one with "
                      "tools.create_gtdatabase)")

    train(cfg, frames, gt_db=gt_db, resume_epoch=args.resume,
          eval_frames=eval_frames, eval_every=max(args.eval_every, 1),
          time_budget_s=args.max_seconds, device=args.device,
          with_images=with_images)
    return 0


if __name__ == "__main__":
    sys.exit(main())
