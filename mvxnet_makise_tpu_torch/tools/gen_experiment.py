"""Synthetic generalization experiment: train on a frame pool, track
held-out AP.

Port of ``mvxnet_makise_tpu/tools/gen_experiment.py``.  Without KITTI
data, this is the training recipe's protocol on the package's own
synthetic world: train on a fixed pool of fresh-draw frames and evaluate
AP on frames the model has never seen, every ``--eval-every`` steps.  It
answers one question: does the recipe generalize (held-out AP > 0)?

The frame pool and the val frames are the JAX tool's, array for array
(the same generators: seed 1 for the pool and the batch draws, 10 000
for val).  The step's voxelizer shuffle is a permutation per frame from
one ``torch.Generator`` seeded with 0, as ``train.loop`` draws it.

``--record FILE`` appends one JSON line per eval, with the JAX tool's
keys; ``backend`` is "cuda" or "cpu" and ``device`` the card's name,
``elapsed_s`` this run's wall-clock seconds since training began (after
a synchronize), ``steps_per_s`` the training steps per second of
training time (evals excluded).  ``best`` keeps ``per_class_max`` (the
best AP@0.5 each class reached, with its step) whenever a new best AP
rebuilds it.  ``GEN_PROTOCOL.jsonl`` holds the JAX package's TPU runs
and is never written.

Usage (on the card; ``--device cpu`` at reduced --steps):
    python -m mvxnet_makise_tpu_torch.tools.gen_experiment \\
        --world 32 --pool 128 --batch-size 4 --steps 8000 \\
        --eval-every 1000 --record runs.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

from mvxnet_makise_tpu_torch.tools.probe import RPN_VARIANTS, rpn_fields

PROTOCOL_FILE = "GEN_PROTOCOL.jsonl"


def make_config(loss_mode: str, lr: float, batch_size: int,
                world: int = 64, classes: int = 1,
                image_min_side: Optional[float] = None,
                rpn: Optional[str] = None):
    """The protocol's small-world Config: a 12.8 x 16 m scene on a
    ``world`` x ``world`` x 10 grid, 64x96 images, 2048 points and voxels,
    best-anchor fallback.  ``image_min_side`` is the toy image's transform
    min side (KITTI's ms maps to toy 64 * ms / 734.6: at 64x96 the min
    side binds where KITTI's 1333 max-side cap does); ``rpn`` names a
    trunk of ``tools/probe.RPN_VARIANTS``."""
    from mvxnet_makise_tpu_torch.config import Config

    target = ("Car", "Pedestrian", "Cyclist")[:classes] \
        if classes > 1 else ("Car",)
    extra = {}
    if image_min_side is not None:
        extra["image_min_side"] = image_min_side
    if rpn is not None:
        extra.update(rpn_fields(rpn))
    # world=64 is a KITTI-like anchor stride (0.4 x 0.5 m); world=32
    # halves the grid and leans on the best-anchor fallback
    return Config(
        velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
        voxel_shape=(world, world, 10),
        image_size=(64, 96),
        max_points=2048, max_voxels=2048, max_boxes=8,
        samples_per_voxel=8, assign_window=max(6, world // 5),
        assign_best_anchor_fallback=True,
        batch_size=batch_size, learning_rate=lr, num_epochs=1,
        cls_loss_mode=loss_mode,
        target_classes=target,
        fusion_mode="pm", **extra)


def make_frame(i: int, gen: np.random.Generator, cfg):
    """Frame ``i`` of the protocol's synthetic world, drawn from ``gen``:
    3 cars (or 2 per class longer than 3 m and 1 per other class), 2000
    points, yaw within +-30 degrees."""
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.data.synthetic import (
        synthetic_frame,
        synthetic_frame_multiclass,
    )

    yaw = (-np.pi / 6, np.pi / 6)
    if len(cfg.target_classes) > 1:
        counts = {c: (2 if s[0] > 3.0 else 1)
                  for c, s in zip(cfg.target_classes, cfg.anchor_sizes)}
        pts, calib, image, boxes = synthetic_frame_multiclass(
            gen, cfg, counts=counts, num_points=2000, yaw_range=yaw)
    else:
        pts, calib, image, car = synthetic_frame(
            gen, cfg, num_cars=3, num_points=2000, yaw_range=yaw)
        boxes = {"Car": car}
    return KittiFrame(
        frame_id=f"s{i:05d}", points=pts, image=image, calib=calib,
        boxes=boxes,
        bbox2d={c: np.zeros((len(b), 4), np.float32)
                for c, b in boxes.items()},
        difficulty={c: np.ones(len(b), np.int32)
                    for c, b in boxes.items()})


def make_pool(cfg, pool_size: int, rng: np.random.Generator):
    """The training pool: ``pool_size`` frames drawn from ``rng``, each
    through ``train.loop.preprocess_train_frame`` (no augmentation,
    shuffled by ``rng``)."""
    from mvxnet_makise_tpu_torch.train.loop import preprocess_train_frame

    return [preprocess_train_frame(make_frame(i, rng, cfg), cfg, None, rng)
            for i in range(pool_size)]


def make_val(cfg, n_val: int):
    """The held-out frames: ``n_val`` frames from ``default_rng(10000)``."""
    vrng = np.random.default_rng(10_000)
    return [make_frame(10_000 + i, vrng, cfg) for i in range(n_val)]


def _flush(history: List[dict], pending: List[dict]) -> None:
    """Move queued step metrics to ``history`` as floats, one read-back."""
    import torch

    if not pending:
        return
    keys = list(pending[0])
    values = torch.stack([torch.stack([m[k].detach().double().cpu()
                                       for k in keys]) for m in pending])
    history.extend(dict(zip(keys, row)) for row in values.tolist())
    pending.clear()


def run(steps: int, pool_size: int, eval_every: int, loss_mode: str,
        lr: float, batch_size: int, n_val: int = 32,
        log_every: int = 1000, ap_floor: Optional[float] = None,
        world: int = 64, classes: int = 1,
        with_images: bool = False,
        image_min_side: Optional[float] = None,
        rpn: Optional[str] = None,
        record: Optional[str] = None,
        device=None, eval_batch: int = 4) -> dict:
    """Train ``steps`` steps on a ``pool_size``-frame pool on ``device``
    (default: the CUDA card); report held-out AP every ``eval_every``
    steps and at the end.  Returns the last eval, ``{iou_thr: {"ap",
    "recall"}, "per_class": {iou_thr: {class: {"ap", "recall"}}}}``, with
    ``"best"`` (the eval of the best AP@0.5 and ``per_class_max``),
    ``"history"`` (every step's metrics as floats) and ``"steps_per_s"``.

    ``with_images`` trains the fused model with a random-init frozen
    extractor: it measures the pipeline, not ImageNet features.
    ``record`` appends one JSON line per eval (``final`` on the last)."""
    import torch

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32
    from mvxnet_makise_tpu_torch.eval.runner import run_eval
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        use_full_f32()
    cfg = make_config(loss_mode, lr, batch_size, world, classes,
                      image_min_side, rpn)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(dev)
    _, state = build_model_and_state(cfg, device=dev,
                                     with_images=with_images)
    step = make_full_train_step(cfg, anchors, with_images)
    shuffle = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    B = cfg.batch_size

    print(f"building pool ({pool_size} frames)...", flush=True)
    pool = make_pool(cfg, pool_size, rng)

    def stacked(name):
        return torch.from_numpy(np.stack(
            [np.asarray(getattr(f, name)) for f in pool])).to(dev)

    arrays = [stacked(n) for n in ("points", "num_points", "image",
                                   "gt_boxes", "gt_mask", "gt_classes")]
    val = make_val(cfg, n_val)
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    eval_s = 0.0
    history: List[dict] = []
    pending: List[dict] = []
    last: dict = {}
    best: dict = {}
    per_class_max: dict = {}
    for it in range(steps):
        idx = torch.from_numpy(rng.integers(0, pool_size, B)).to(dev)
        perm = torch.stack([torch.randperm(cfg.max_points, generator=shuffle)
                            for _ in range(B)]).to(dev)
        pending.append(step(state, *(a[idx] for a in arrays), perm))
        if (it + 1) % log_every == 0:
            _flush(history, pending)
            m = {k: float(np.mean([h[k] for h in history[-200:]]))
                 for k in history[-1]}
            print(f"step {it + 1}: cls {m['cls_loss']:.4f} "
                  f"reg {m['reg_loss']:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if (it + 1) % eval_every == 0 or it + 1 == steps:
            _flush(history, pending)
            sync()
            t_eval = time.perf_counter()
            last = {}
            for thr in (0.7, 0.5):
                res = run_eval(cfg, val, state.model,
                               batch_size=eval_batch, iou_threshold=thr,
                               with_images=with_images)
                r = res["Car"]["all"]
                last[thr] = {"ap": float(r["ap"]),
                             "recall": float(r["recall"])}
                for cname in cfg.target_classes:
                    rc = res[cname]["all"]
                    last.setdefault("per_class", {}).setdefault(
                        thr, {})[cname] = {"ap": float(rc["ap"]),
                                           "recall": float(rc["recall"])}
                    print(f"  step {it + 1} VAL {cname} AP@{thr}: "
                          f"ap={rc['ap']:.4f} recall={rc['recall']:.3f}",
                          flush=True)
            eval_s += time.perf_counter() - t_eval
            for cname, r in last.get("per_class", {}).get(0.5, {}).items():
                if r["ap"] > per_class_max.get(cname, {}).get("ap", -1.0):
                    per_class_max[cname] = dict(r, step=it + 1)
            if not best or last[0.5]["ap"] >= best["ap50"]:
                best = {"ap50": last[0.5]["ap"],
                        "recall50": last[0.5]["recall"],
                        "ap70": last[0.7]["ap"], "step": it + 1,
                        "per_class": last.get("per_class", {}).get(0.5, {})}
            # set after any rebuild: a new best keeps the per-class maxima
            best["per_class_max"] = dict(per_class_max)
            elapsed = time.perf_counter() - t0
            steps_per_s = (it + 1) / (elapsed - eval_s)
            stop = ap_floor is not None and last[0.5]["ap"] >= ap_floor
            if record:
                # one line per eval: a run cut short still leaves its
                # trajectory
                _append_record(record, it + 1 == steps or stop, it,
                               pool_size, batch_size, world, classes,
                               loss_mode, with_images, image_min_side, rpn,
                               elapsed, steps_per_s,
                               "cuda" if cuda else "cpu", name, last, best)
            if stop:
                print(f"ap floor {ap_floor} reached, stopping", flush=True)
                break
    _flush(history, pending)
    sync()
    last["best"] = best
    last["history"] = history
    last["steps_per_s"] = len(history) / (time.perf_counter() - t0 - eval_s)
    return last


def _append_record(record, final, it, pool_size, batch_size, world,
                   classes, loss_mode, with_images, image_min_side, rpn,
                   elapsed, steps_per_s, backend, device, last, best):
    with open(record, "a") as f:
        f.write(json.dumps({
            "protocol": "gen_experiment", "final": bool(final),
            "steps": it + 1, "pool": pool_size, "batch": batch_size,
            "world": world, "classes": classes, "loss": loss_mode,
            "with_images": with_images,
            "image_min_side": image_min_side, "rpn": rpn,
            "elapsed_s": elapsed, "steps_per_s": steps_per_s,
            "backend": backend, "device": device,
            "ap50": last[0.5]["ap"], "recall50": last[0.5]["recall"],
            "ap70": last[0.7]["ap"],
            "per_class": last.get("per_class", {}).get(0.5, {}),
            "best": best,
        }) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.gen_experiment",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30_000)
    p.add_argument("--pool", type=int, default=512)
    p.add_argument("--eval-every", type=int, default=5_000)
    p.add_argument("--loss", default="reference",
                   choices=("reference", "focal"))
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--ap-floor", type=float, default=None,
                   help="stop early once val AP@0.5 reaches this")
    p.add_argument("--world", type=int, default=64,
                   help="BEV grid size (64 = KITTI-like stride; 32 = "
                        "half the grid)")
    p.add_argument("--classes", type=int, default=1, choices=(1, 2, 3),
                   help="1 = Car only; 3 = Car/Pedestrian/Cyclist")
    p.add_argument("--with-images", action="store_true",
                   help="train the fused model (random-init frozen "
                        "extractor) instead of the LiDAR-only one")
    p.add_argument("--image-min-side", type=float, default=None,
                   help="toy-world transform min side (KITTI ms maps to "
                        "toy 64*ms/734.6; see make_config)")
    p.add_argument("--rpn", default=None, choices=tuple(RPN_VARIANTS),
                   help="RPN trunk variant (tools/probe.RPN_VARIANTS)")
    p.add_argument("--record", default=None,
                   help="append one JSON line per eval to this file")
    p.add_argument("--eval-batch", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.record and os.path.basename(args.record) == PROTOCOL_FILE:
        p.error(f"{PROTOCOL_FILE} holds the JAX package's runs: record "
                f"to another file")
    run(args.steps, args.pool, args.eval_every, args.loss, args.lr,
        args.batch_size, ap_floor=args.ap_floor, world=args.world, classes=args.classes,
        with_images=args.with_images, image_min_side=args.image_min_side,
        rpn=args.rpn, record=args.record, device=args.device,
        eval_batch=args.eval_batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
