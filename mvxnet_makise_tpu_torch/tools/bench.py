"""Throughput benchmark of the port on the card: prints ONE JSON line.

Port of the repository's ``bench.py``.  Modes (``--lidar-only`` combines
with each):

- default, end-to-end detection: ``serve.Detector.stream_batches`` over
  synthetic KITTI-shaped frames, the host assemble (C++ crop + project +
  pad), the upload to the card, voxelize, forward, decode, rotated NMS
  and the read-back of the detections all inside the timed loop; the
  line also carries ``raw_forward_fps``, ``host_feed_ms_per_batch`` and
  ``serve_loop_ms_per_batch``;
- ``--raw-only``: upload, voxelize and forward of one assembled batch;
- ``--train``: ``train.loop.make_full_train_step`` on one batch (upload,
  voxelize, assign, forward, loss, backward, AdamW).

``value`` is frames per second of the mode's timed loop: batch x iters
over the host clock around the loop, which ends in a synchronize.  Every
mode starts each iteration from host arrays, so ``upload_excluded`` is
false.  The configuration is ``Config(use_bf16=True, batch_size=8)``: the
reference's model (``image_min_side`` 800, the reference RPN trunk) in
bfloat16; ``--image-min-side``, ``--rpn`` and ``--batch`` change it, and
``--config FILE`` runs a configuration as written (e.g.
``configs/serving_economy.yaml``; the flags still override it), and
``--norm-scope batch`` pools the norms' statistics over the batch.  The line
names the card and its power limit.  There is no ``vs_baseline``: the
port has no target rate.

The measurement runs in a supervised child (``utils/watchdog``): each
stage has its own time budget, a measured raw rate is kept as a partial,
a failed child is retried once, and the parent prints one line and exits
nonzero unless the child finished.  ``--gather-backend`` and
``--fusion-stats`` are refused: they pick JAX layouts of the one function
the port computes.

Run: python -m mvxnet_makise_tpu_torch.tools.bench [--batch N] [--iters N]
         [--warmup N] [--lidar-only] [--raw-only] [--train]
         [--config FILE] [--image-min-side S] [--rpn NAME]
         [--norm-scope sample|batch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from mvxnet_makise_tpu_torch.utils.watchdog import (
    PartialWriter,
    StageWatchdog,
    supervise,
)

# per-stage budgets (s) of the child's watchdog
BUDGETS = {"setup": 600, "raw_warmup": 600, "raw_measure": 300,
           "train_warmup": 600, "train_measure": 600, "serve_setup": 300,
           "serve_warmup": 400, "serve_measure": 300}
_MODE_STAGES = {"train": ("setup", "train_warmup", "train_measure"),
                "raw": ("setup", "raw_warmup", "raw_measure"),
                "e2e": ("setup", "raw_warmup", "raw_measure", "serve_setup",
                        "serve_warmup", "serve_measure")}
# why the JAX layout flags are refused
_ONE_FUNCTION = ("JAX's gather backends and fusion-statistics formulations "
                 "are layouts of one function, which the port computes "
                 "with K2 and one fusion MLP")


def _metric_name(args) -> str:
    if args.train:
        return ("kitti_train_frames_per_sec_per_chip"
                + ("_lidar_only" if args.lidar_only else ""))
    if args.raw_only:
        return ("kitti_frames_per_sec_per_chip_raw_forward"
                + ("_lidar_only" if args.lidar_only else ""))
    return ("kitti_frames_per_sec_per_chip_e2e_detection"
            + ("_lidar_only" if args.lidar_only else ""))


def _mode(args) -> str:
    return "train" if args.train else "raw" if args.raw_only else "e2e"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.bench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 8, or the --config's)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--lidar-only", action="store_true")
    ap.add_argument("--raw-only", action="store_true",
                    help="time upload + voxelize + forward only")
    ap.add_argument("--train", action="store_true",
                    help="time the full training step instead")
    ap.add_argument("--config", default=None,
                    help="a configuration file, run as written")
    ap.add_argument("--max-points", type=int, default=0,
                    help="override Config.max_points (0: keep)")
    ap.add_argument("--image-min-side", type=float, default=None,
                    help="Config.image_min_side (default: the Config's, "
                         "800, the reference's transform)")
    ap.add_argument("--rpn", default=None,
                    help="RPN trunk of tools/probe.RPN_VARIANTS (default: "
                         "the Config's, the reference trunk)")
    ap.add_argument("--norm-scope", default="",
                    choices=["", "sample", "batch"],
                    help="override Config.norm_scope (statistics per "
                         "sample or over the batch)")
    ap.add_argument("--gather-backend", default="",
                    help="refused: the port has one FPN gather (K2)")
    ap.add_argument("--fusion-stats", default="",
                    help="refused: the port has one fusion-MLP "
                         "statistics formulation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--max-seconds", type=int, default=None,
                    help="cap per supervised attempt (default: the sum of "
                         "the mode's stage budgets plus 60 s)")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.gather_backend:
        ap.error(f"--gather-backend selects nothing in the port: "
                 f"{_ONE_FUNCTION}")
    if args.fusion_stats:
        ap.error(f"--fusion-stats selects nothing in the port: "
                 f"{_ONE_FUNCTION}")
    if args.train and args.raw_only:
        ap.error("--train and --raw-only are two modes: pick one")
    return args


def bench_config(args):
    """The configuration the bench runs: ``--config`` as written, else
    ``Config(use_bf16=True, batch_size=8)``, with the flags' overrides."""
    from mvxnet_makise_tpu_torch.config import Config, load_config
    from mvxnet_makise_tpu_torch.tools.probe import rpn_fields

    over = {}
    if args.batch:
        over["batch_size"] = args.batch
    if args.max_points:
        over["max_points"] = args.max_points
    if args.image_min_side is not None:
        over["image_min_side"] = args.image_min_side
    if args.rpn is not None:
        over.update(rpn_fields(args.rpn))
    if args.norm_scope:
        over["norm_scope"] = args.norm_scope
    if args.config:
        if not os.path.exists(args.config):
            raise FileNotFoundError(f"no configuration file {args.config}")
        return load_config(args.config, **over)
    return Config(**{"use_bf16": True, "batch_size": 8, **over})


def card(device) -> dict:
    """The device's name and, on the card, its power limit as nvidia-smi
    prints them."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = out.stdout.strip()
    return {"device": torch.cuda.get_device_name(index),
            "power_limit": line.split(",")[-1].strip() if line else None,
            "nvidia_smi": line}


def _frames(cfg, n: int, seed: int):
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

    rng = np.random.default_rng(seed)
    return [synthetic_frame(rng, cfg) for _ in range(n)]


def child(args) -> int:
    metric = _metric_name(args)
    partials = PartialWriter(os.environ.get("BENCH_PARTIALS"))
    wd = StageWatchdog(BUDGETS, metric=metric)
    wd.enter("setup")

    import torch

    from mvxnet_makise_tpu_torch.data.pipeline import (
        collate,
        preprocess_frame,
    )
    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.serve import Detector
    from mvxnet_makise_tpu_torch.tools.probe import rpn_name
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    device = resolve_device(args.device)
    cfg = bench_config(args)
    B = cfg.batch_size
    with_images = not args.lidar_only
    fb = collate([preprocess_frame(*f, cfg)
                  for f in _frames(cfg, B, 0)])
    host = {"points": fb.points, "num_points": fb.num_points,
            "images": fb.image}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def upload(name):
        return torch.from_numpy(host[name]).to(device)

    common = {"unit": "frames/s", "batch": B, "iters": args.iters,
              "warmup": args.warmup, "use_bf16": cfg.use_bf16,
              "image_min_side": cfg.image_min_side,
              "rpn": rpn_name(cfg.rpn_trunk), "config": args.config,
              "norm_scope": cfg.norm_scope,
              "upload_excluded": False, **card(device)}

    if args.train:
        if device.type == "cuda":
            use_full_f32()
        anchors = torch.from_numpy(create_anchors(
            cfg.feature_map_shape, cfg.velo_range,
            cfg.anchor_sizes)).to(device)
        _, state = build_model_and_state(cfg, device=device, seed=0,
                                         with_images=with_images)
        step = make_full_train_step(cfg, anchors, with_images)
        gt = {"gt_boxes": fb.gt_boxes, "gt_mask": fb.gt_mask,
              "gt_classes": np.zeros(fb.gt_mask.shape, np.int32)}
        host.update(gt)
        perm = torch.stack([torch.randperm(
            cfg.max_points, generator=torch.Generator().manual_seed(i))
            for i in range(B)]).to(device)

        def train_step():
            return step(state, *(upload(n) for n in (
                "points", "num_points", "images", "gt_boxes", "gt_mask",
                "gt_classes")), perm)

        wd.enter("train_warmup")
        for _ in range(args.warmup):
            train_step()
        sync()
        wd.enter("train_measure")
        t0 = time.perf_counter()
        for _ in range(args.iters):
            m = train_step()
        sync()
        dt = time.perf_counter() - t0
        wd.cancel()
        loss = float(m["total_loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite training loss {loss}")
        print(json.dumps({"metric": metric, "value": B * args.iters / dt,
                          "ms_per_step": dt / args.iters * 1e3,
                          "last_loss": loss, **common}), flush=True)
        return 0

    det = Detector.create(cfg, checkpoint_epoch=0, seed=0,
                          device=device, with_images=with_images)
    try:
        def raw():
            score, _ = det.maps(*(upload(n) for n in (
                "points", "num_points", "images")))
            return score

        wd.enter("raw_warmup")
        for _ in range(args.warmup):
            raw()
        sync()
        wd.enter("raw_measure")
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = raw()
        checksum = float(out.float().sum())
        dt = time.perf_counter() - t0
        if not np.isfinite(checksum):
            raise RuntimeError("non-finite raw forward output")
        raw_fps = B * args.iters / dt
        raw_record = {
            "metric": ("kitti_frames_per_sec_per_chip_raw_forward"
                       + ("_lidar_only" if args.lidar_only else "")),
            "value": raw_fps, **common}
        # kept as a partial: a later stall degrades the line to this
        partials.emit(raw_record)
        if args.raw_only:
            wd.cancel()
            print(json.dumps(raw_record), flush=True)
            return 0

        wd.enter("serve_setup")
        raw_frames = [f[:3] for f in _frames(cfg, B, 1)]
        det.assemble(raw_frames)            # builds the host library
        host_reps = max(args.iters // 4, 1)
        t0 = time.perf_counter()
        for _ in range(host_reps):
            det.assemble(raw_frames)
        host_dt = (time.perf_counter() - t0) / host_reps

        def batches(n):
            # the host assemble runs inside the loop, as in production
            for _ in range(n):
                yield (*det.assemble(raw_frames), B)

        wd.enter("serve_warmup")
        for _ in det.stream_batches(batches(max(args.warmup, 2)), B):
            pass
        sync()
        wd.enter("serve_measure")
        t0 = time.perf_counter()
        n_frames = 0
        for last in det.stream_batches(batches(args.iters), B):
            n_frames += 1
        sync()
        dt = time.perf_counter() - t0
        wd.cancel()
    finally:
        det.close()
    if n_frames != B * args.iters:
        raise RuntimeError(f"stream_batches yielded {n_frames} of "
                           f"{B * args.iters} frames")
    # scores are sigmoid-bounded; an untrained box head may overflow
    if not np.isfinite(last.scores).all():
        raise RuntimeError("non-finite detection scores")
    print(json.dumps({
        "metric": metric, "value": B * args.iters / dt,
        "raw_forward_fps": raw_fps,
        "host_feed_ms_per_batch": host_dt * 1e3,
        "serve_loop_ms_per_batch": dt / args.iters * 1e3,
        "pipelined_serve_loop": True, **common}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.child:
        return child(args)
    timeout = args.max_seconds or (
        sum(BUDGETS[s] for s in _MODE_STAGES[_mode(args)]) + 60)
    cmd = [sys.executable, "-m", "mvxnet_makise_tpu_torch.tools.bench",
           *argv, "--child"]
    # the child imports the package from wherever this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)
    rec = supervise(cmd, metric=_metric_name(args), attempt_timeout=timeout,
                    retries=1)
    print(json.dumps(rec), flush=True)
    ok = (rec.get("value", 0.0) > 0.0 and "error" not in rec
          and not rec.get("partial"))
    return 0 if ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
