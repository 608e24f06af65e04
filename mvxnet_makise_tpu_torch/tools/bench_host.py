"""Host-pipeline micro-benchmarks (CPU): the C++ feed against numpy.

Port of ``mvxnet_makise_tpu/tools/bench_host.py`` on the port's
``data/native.py``.  Measures the per-frame host work of every training
and serving step: the fused range + frustum crop and projection
(``crop_project``; with the shuffle and the padding, ``assemble_frame``)
in the C++ library (``csrc/pointcloud.cpp``) and in numpy, then the
serving batch's assemble (``native.assemble_batch``), serial against
thread-pooled as ``serve.Detector`` runs it, optionally beside ``--busy``
CPU-burner threads that stand for a contended host.  Runs on the host
only; each record is one JSON line with the JAX tool's names, its times
unrounded, in ms of the host's clock.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_host [--iters N]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the records' names (the JAX tool's)
BENCHES = ("crop_project_native", "assemble_frame_native",
           "crop_project_numpy", "assemble_batch")


def _timeit(fn, iters: int) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls after one warm call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--points", type=int, default=120000,
                   help="raw scan size (KITTI full scans are ~120k)")
    p.add_argument("--batch", type=int, default=8,
                   help="also bench the batch-N serve-time assemble, "
                        "serial vs thread-pooled (0 = skip)")
    p.add_argument("--busy", type=int, default=0,
                   help="spawn N CPU-burner threads during the batch "
                        "bench to emulate a contended host")
    args = p.parse_args(argv)

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.data import native
    from mvxnet_makise_tpu_torch.data.synthetic import toy_calib

    cfg = Config()
    rng = np.random.default_rng(0)
    pts = np.zeros((args.points, 4), np.float32)
    pts[:, 0] = rng.uniform(-10, 80, args.points)
    pts[:, 1] = rng.uniform(-50, 50, args.points)
    pts[:, 2] = rng.uniform(-4, 2, args.points)
    pts[:, 3] = rng.uniform(0, 1, args.points)
    calib = toy_calib(cfg.image_size)

    def emit(name, dt):
        print(json.dumps({"bench": name, "ms": dt * 1e3,
                          "Mpts_per_s": args.points / dt / 1e6}),
              flush=True)

    if native.available():
        emit("crop_project_native", _timeit(lambda: native.crop_project(
            pts, calib, cfg.velo_range, cfg.image_size), args.iters))
        emit("assemble_frame_native", _timeit(
            lambda: native.assemble_frame(
                pts, calib, cfg.velo_range, cfg.image_size,
                cfg.max_points, seed=0), args.iters))
    emit("crop_project_numpy", _timeit(lambda: native.crop_project_numpy(
        pts, calib, cfg.velo_range, cfg.image_size), args.iters))

    if args.batch:
        _bench_batch_assemble(args, cfg, calib, pts)
    return 0


def _bench_batch_assemble(args, cfg, calib, pts) -> None:
    """The batch-N serving host feed, serial against a thread pool of
    min(8, cores) workers (``serve.Detector.assemble``'s); ``--busy``
    CPU-burner threads run beside it."""
    from mvxnet_makise_tpu_torch.data import native

    rng = np.random.default_rng(1)
    image = rng.uniform(0, 255, (*cfg.image_size, 3)).astype(np.float32)
    frames = [(pts, calib, image) for _ in range(args.batch)]

    stop = threading.Event()

    def burn():
        x = np.random.default_rng(2).random((512, 512))
        while not stop.is_set():
            x = x @ x * 1e-3

    burners = [threading.Thread(target=burn, daemon=True)
               for _ in range(args.busy)]
    for b in burners:
        b.start()
    try:
        serial = _timeit(lambda: native.assemble_batch(
            frames, cfg.velo_range, cfg.image_size, cfg.max_points,
            args.batch), args.iters)
        with ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1)) as pool:
            pooled = _timeit(lambda: native.assemble_batch(
                frames, cfg.velo_range, cfg.image_size, cfg.max_points,
                args.batch, pool=pool), args.iters)
    finally:
        stop.set()
        for b in burners:
            b.join()
    print(json.dumps({
        "bench": "assemble_batch",
        "batch": args.batch,
        "busy_threads": args.busy,
        "serial_ms": serial * 1e3,
        "pooled_ms": pooled * 1e3,
        "speedup": serial / pooled}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
