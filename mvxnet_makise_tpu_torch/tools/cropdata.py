"""Offline frustum-crop tool: ``training/velodyne`` -> ``velodyne_croped``.

    python -m mvxnet_makise_tpu_torch.tools.cropdata <dataroot> [mode]
        [workers] [--config FILE] [--device cuda|cpu]

Port of ``mvxnet_makise_tpu/tools/cropdata.py``: for every KITTI frame,
range-crop then camera-frustum-crop the raw scan and write the result, so
training epochs skip the work.  Modes:

  native : the C++ crop of the host feed (``data/native.crop_project``)
  numpy  : the numpy version of the same crop
  torch  : the range and frustum masks (``ops/voxelize``) on ``--device``

Boundary semantics are the same in every mode: half-open range bounds and
the ``imsize - 1e-3`` frustum epsilon.  Like every tool of the port it
runs on the CUDA card unless ``--device cpu``, and raises without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import sys
import time

import numpy as np
import torch

from mvxnet_makise_tpu_torch.config import Config, load_config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.data.kitti import KittiPaths
from mvxnet_makise_tpu_torch.device import resolve_device
from mvxnet_makise_tpu_torch.geometry.calib import read_calib
from mvxnet_makise_tpu_torch.ops.voxelize import (
    crop_to_range_mask,
    frustum_mask,
)

MODES = ("native", "numpy", "torch")


def crop_frame(points: np.ndarray, calib, cfg: Config, mode: str,
               device: torch.device = torch.device("cpu")) -> np.ndarray:
    """The cropped (K, 4) cloud (without the projection columns)."""
    if mode == "native":
        return native.crop_project(points, calib, cfg.velo_range,
                                   cfg.image_size)[:, :4]
    if mode == "numpy":
        return native.crop_project_numpy(points, calib, cfg.velo_range,
                                         cfg.image_size)[:, :4]
    if mode == "torch":
        pts = torch.from_numpy(np.ascontiguousarray(points)).to(device)
        rect = torch.from_numpy(calib.R0 @ calib.velo_to_cam).to(device)
        proj = torch.from_numpy(calib.P2).to(device) @ rect
        keep = crop_to_range_mask(pts, cfg.velo_range) & frustum_mask(
            pts, proj, rect, cfg.image_size)
        return pts[keep][:, :4].cpu().numpy()
    raise ValueError(f"unknown mode {mode!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.cropdata")
    p.add_argument("dataroot")
    p.add_argument("mode", nargs="?", default="native", choices=MODES)
    p.add_argument("workers", nargs="?", type=int,
                   default=os.cpu_count() or 4)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, data_root=args.dataroot)
    paths = KittiPaths.from_root(args.dataroot)
    os.makedirs(paths.velodyne_cropped, exist_ok=True)

    ids = sorted(os.path.splitext(f)[0]
                 for f in os.listdir(paths.velodyne) if f.endswith(".bin"))

    def one(fid):
        pts = np.fromfile(os.path.join(paths.velodyne, fid + ".bin"),
                          dtype=np.float32).reshape(-1, 4)
        calib = read_calib(os.path.join(paths.calib, fid + ".txt"))
        out = crop_frame(pts, calib, cfg, args.mode, device)
        out.astype(np.float32).tofile(
            os.path.join(paths.velodyne_cropped, fid + ".bin"))

    # the torch mode feeds one device from one thread; the host modes
    # release the GIL in I/O and C++
    workers = 1 if args.mode == "torch" else max(args.workers, 1)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for done, _ in enumerate(pool.map(one, ids), start=1):
            if done % 500 == 0 or done == len(ids):
                rate = done / (time.perf_counter() - t0)
                print(f"\r{done}/{len(ids)} ({rate:.1f} frames/s)", end="",
                      flush=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
