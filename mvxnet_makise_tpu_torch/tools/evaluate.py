"""Evaluation CLI: checkpoint -> 3D AP (Car at IoU 0.7) on the val split.

    python -m mvxnet_makise_tpu_torch.tools.evaluate <dataroot> [-r EPOCH]
        [--config FILE] [--limit N] [--synthetic N] [--score-threshold T]
        [--lidar-only] [--device cuda|cpu]

Port of ``mvxnet_makise_tpu/tools/evaluate.py``: restores epoch ``-r``'s
model from ``cfg.checkpoint_dir`` (the latest epoch there by default;
random weights from seed 0 without a checkpoint) and prints one line per
class and difficulty bucket (``eval/runner.run_eval``).  ``--lidar-only``
evaluates the LiDAR-only detector on frames loaded without their images.
Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.evaluate")
    p.add_argument("dataroot", nargs="?", default=None)
    p.add_argument("-r", "--epoch", type=int, default=None,
                   help="checkpoint epoch (default: the latest)")
    p.add_argument("--config", default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="evaluate on N synthetic frames instead")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--score-threshold", type=float, default=0.05,
                   help="decode threshold for AP (low: AP needs the "
                        "whole score ranking; 0.3 is a serving choice)")
    p.add_argument("--lidar-only", action="store_true",
                   help="the LiDAR-only detector")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    with_images = not args.lidar_only

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame, load_dataset
    from mvxnet_makise_tpu_torch.eval.runner import run_eval
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.train import checkpoint as ckpt

    overrides = {"data_root": args.dataroot} if args.dataroot else {}
    cfg = load_config(args.config, **overrides)
    epoch = args.epoch
    if epoch is None:
        epoch = ckpt.latest_epoch(cfg.checkpoint_dir)
    model = build_model(cfg, seed=None if epoch else 0, device=args.device,
                        with_images=with_images)
    if epoch:
        ckpt.restore_model(cfg.checkpoint_dir, epoch, model)
        print(f"restored epoch {epoch}")

    if args.synthetic:
        from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

        rng = np.random.default_rng(1)
        frames = []
        for i in range(args.synthetic):
            pts, calib, image, boxes = synthetic_frame(rng, cfg)
            frames.append(KittiFrame(frame_id=f"synth{i:06d}", points=pts,
                                     image=image, calib=calib,
                                     boxes={"Car": boxes}))
    else:
        frames = load_dataset(cfg.data_root, "val", cfg,
                              load_images=with_images, limit=args.limit)

    res = run_eval(cfg, frames, model, score_threshold=args.score_threshold,
                   with_images=with_images)
    for cname, buckets in res.items():
        for bname, r in buckets.items():
            print(f"{cname} {bname}: AP={r['ap']:.4f} "
                  f"P={r['precision']:.4f} R={r['recall']:.4f} "
                  f"gt={r['num_gt']} det={r['num_det']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
