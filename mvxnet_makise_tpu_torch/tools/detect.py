"""Batch-inference CLI: KITTI frames in, KITTI result files out.

    python -m mvxnet_makise_tpu_torch.tools.detect <dataroot> -o OUTDIR
        [-r EPOCH] [--config FILE] [--split val] [--batch 8] [--limit N]
        [--score-threshold 0.3] [--image-min-side S] [--lidar-only]
        [--device cuda|cpu]

Port of ``mvxnet_makise_tpu/tools/detect.py``: restores a checkpoint into
``serve.Detector`` (the latest epoch by default), streams a split through
it in batches, and writes one file per frame, one line per detection in
the format the KITTI devkit reads (:func:`kitti_result_line`).
``--lidar-only`` serves the LiDAR-only detector from frames loaded without
their images.  Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from mvxnet_makise_tpu_torch.geometry.boxes import (
    boxes3d_to_corners3d,
    boxes_lidar_to_cam,
)
from mvxnet_makise_tpu_torch.geometry.calib import Calib, lidar_to_image


def kitti_result_line(cname: str, box: np.ndarray, score: float,
                      calib: Calib) -> str:
    """One KITTI result record for a LiDAR box (x y z l w h r): type,
    truncation 0, occlusion 0, alpha 0, the 2D box of the projected 3D
    corners, h w l, the camera-frame position, ry, and the score."""
    box = np.asarray(box)
    h, w, l, cx, cy, cz, ry = boxes_lidar_to_cam(
        box[None], np.asarray(calib.velo_to_cam))[0]
    corners = boxes3d_to_corners3d(torch.from_numpy(box)).numpy()
    uv = lidar_to_image(corners, calib)
    left, top = uv.min(axis=0)
    right, bottom = uv.max(axis=0)
    return (f"{cname} 0.0 0 0.0 {left:.2f} {top:.2f} {right:.2f} "
            f"{bottom:.2f} {h:.2f} {w:.2f} {l:.2f} "
            f"{cx:.2f} {cy:.2f} {cz:.2f} {ry:.2f} {float(score):.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.detect")
    p.add_argument("dataroot")
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("-r", "--epoch", type=int, default=None,
                   help="checkpoint epoch (default: the latest)")
    p.add_argument("--config", default=None)
    p.add_argument("--split", default="val",
                   choices=["train", "val", "trainval", "test"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--image-min-side", type=float, default=None,
                   help="detection-transform resolution (default: the "
                        "config's)")
    p.add_argument("--lidar-only", action="store_true",
                   help="the LiDAR-only detector")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    with_images = not args.lidar_only

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.kitti import load_dataset
    from mvxnet_makise_tpu_torch.serve import Detector

    cfg = load_config(args.config, data_root=args.dataroot)
    if args.image_min_side is not None:
        cfg = cfg.replace(image_min_side=args.image_min_side)
    frames = load_dataset(cfg.data_root, args.split, cfg,
                          load_images=with_images, limit=args.limit)
    if not frames:
        p.error(f"no frames for split '{args.split}' under {cfg.data_root}")

    det = Detector.create(cfg, checkpoint_epoch=args.epoch,
                          device=args.device, with_images=with_images,
                          score_threshold=args.score_threshold)
    try:
        det.warm((args.batch,))
        os.makedirs(args.outdir, exist_ok=True)
        n_done = 0
        for i in range(0, len(frames), args.batch):
            chunk = frames[i:i + args.batch]
            results = det.detect_frames(
                [(f.points, f.calib, f.image) for f in chunk])
            for frame, r in zip(chunk, results):
                lines = [kitti_result_line(cfg.target_classes[int(ci)], box,
                                           score, frame.calib) + "\n"
                         for box, score, ci in zip(r.boxes, r.scores,
                                                   r.classes)]
                with open(os.path.join(args.outdir,
                                       f"{frame.frame_id}.txt"), "w") as fh:
                    fh.writelines(lines)
                n_done += 1
            print(f"{n_done}/{len(frames)} frames", flush=True)
    finally:
        det.close()
    print(f"wrote {n_done} result files to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
