#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mvxnet_makise_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``build``: compiles every CUDA kernel of the serving path from
   ``mvxnet_makise_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together) and reports seconds, the command and ``ptxas`` register use.
2. ``kernel``: one phase per kernel.  Its inputs are taken from the
   forward of synthetic frames at the full default ``Config``; the kernel's
   wrapper is held against its plain PyTorch version on the same inputs
   (tolerance stated per kernel) and timed with CUDA events beside the
   plain version, a one-call PyTorch yardstick and the card's bound for the
   same work.
3. ``detector``: the port's ``serve.Detector`` at the full default
   ``Config`` (random weights from a seed) serves synthetic frames through
   ``detect_frames`` and ``detect_stream``, fed by the C++ host feed (the
   run fails if it cannot be built).  Every kernel's launch count is set
   to 0 just before and read just after; a kernel the path never launched
   fails the run.
4. ``profile``: where one batch's time goes, device ms per module and
   per kernel, and the device's idle share.
5. ``reference``: at a small configuration, the card's model maps are
   held against the same weights run in float64 on the CPU, where every
   kernel runs its plain PyTorch version.

Then a ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits nonzero before
that line.  Without a CUDA device the script exits nonzero and prints no
result.  JAX is never imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# tolerances of the kernel-vs-plain comparisons, relative to the largest
# magnitude of the plain result (max(1, max|plain|)):
#   K1 sums the same <= 9 taps in the same order as the plain version, so
#   its output differs only where the compiler contracts the bias add; the
#   per-row statistics add 400 cells in another order.
#   K2 rounds its four weighted taps in another order than the plain
#   version and divides where PyTorch multiplies by a reciprocal.
TOL = {"column_merge": {"out": 1e-6, "stats": 1e-5},
       "fpn_gather": {"out": 1e-5}}
# the card's model maps may sit this many times further from a float64
# reference than the CPU's float32 maps do (phase_reference)
REF_FACTOR = 10.0
# the main path's run: FRAMES synthetic frames served in batches of BATCH
FRAMES = 8
BATCH = 4


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events around the whole run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple:
    """(max abs error, max abs error / max(1, max|want|))."""
    err = float((got.double() - want.double()).abs().max()) \
        if want.numel() else 0.0
    scale = max(1.0, float(want.double().abs().max()) if want.numel()
                else 0.0)
    return err, err / scale


def make_frames(cfg, n: int, seed: int, **kw):
    """``n`` synthetic (points, calib, image) frames from ``seed``."""
    import numpy as np

    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

    rng = np.random.default_rng(seed)
    return [synthetic_frame(rng, cfg, **kw)[:3] for _ in range(n)]


# ------------------------------------------------------------- inputs


def kernel_inputs(det, frames):
    """The arguments the serving path hands K1 and K2 for ``frames``:
    the same modules, stopped at each kernel's call."""
    import torch

    from mvxnet_makise_tpu_torch.models.image_head import gather_image_size
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    cfg, model = det.cfg, det.model
    pts, nums, imgs = det.assemble(frames)
    with torch.no_grad():
        b = frames_to_batch(torch.as_tensor(pts).to(det.device),
                            torch.as_tensor(nums).to(det.device),
                            torch.as_tensor(imgs).to(det.device), cfg)
        gather_args = (model.head.pyramid(b.images),
                       b.sorted_points[..., 4:6].contiguous(),
                       b.sorted_kept.contiguous(),
                       gather_image_size(cfg.image_size, cfg.image_min_side))
        x, z0 = model.fused_inputs(b.sorted_points, b.sorted_kept,
                                   b.sorted_seg, b.counts, b.vmask,
                                   b.images)
        bb = model.backbone
        vfeat = bb.voxel_features(x, b.sorted_kept, b.sorted_seg, b.counts,
                                  b.vmask, z0)
        merge_args = tuple(bb.cml.conv1.merge_inputs(vfeat, b.coords,
                                                     b.vmask))
    return merge_args, gather_args


# ------------------------------------------------------------- K1


def merge_index_add(y, col_cy, bounds, grid_shape):
    """Yardstick for K1: the destination row of every (column, tap) row,
    for one ``index_add_`` that sums the taps into the dense grid (no
    bias, ReLU or statistics).  Returns (dest, out buffer)."""
    import torch

    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    col = torch.arange(V, device=y.device, dtype=bounds.dtype)
    cx = torch.searchsorted(bounds, col.expand(B, V).contiguous(),
                            right=True) - 1
    live = col[None] < bounds[:, nx:nx + 1]
    t = torch.arange(9, device=y.device)
    ox = cx[..., None] + 1 - t // 3
    oy = col_cy[..., None] + 1 - t % 3
    ok = live[..., None] & (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
    cell = ox * ny + oy + (torch.arange(B, device=y.device)
                           * (nx * ny))[:, None, None]
    dest = torch.where(ok, cell, torch.full_like(cell, B * nx * ny))
    out = torch.zeros((B * nx * ny + 1, R), dtype=y.dtype, device=y.device)
    return dest.reshape(-1), out


def phase_column_merge(merge_args, grid_shape):
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, bias = merge_args
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    launches0 = cm.KERNEL.launches
    out, stats = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    check(cm.KERNEL.launches == launches0 + 1, "K1 wrapper did not launch")
    want_out, want_stats = cm.merge_taps_fused_plain(y, col_cy, bounds,
                                                     bias, grid_shape)
    torch.cuda.synchronize()
    err_out, rel_out = rel_err(out, want_out)
    err_stats, rel_stats = rel_err(stats, want_stats)
    tol = TOL["column_merge"]
    ok = rel_out <= tol["out"] and rel_stats <= tol["stats"]

    ms = time_ms(lambda: cm.merge_taps_fused(y, col_cy, bounds, bias,
                                             grid_shape))
    plain_ms = time_ms(lambda: cm.merge_taps_fused_plain(
        y, col_cy, bounds, bias, grid_shape), iters=5)
    dest, buf = merge_index_add(y, col_cy, bounds, grid_shape)
    rows = y.reshape(-1, R)
    library_ms = time_ms(lambda: buf.index_add_(0, dest, rows))

    es = y.element_size()
    live = int(bounds[:, nx].sum())
    cells = B * nx * ny * R
    n_bytes = (live * 9 * R * es + col_cy.numel() * 4 + bounds.numel() * 4
               + R * 4 + cells * es + stats.numel() * 4)
    # one add per present tap; per output: bias add, ReLU, two sums and
    # one square
    n_ops = live * 9 * R + 5 * cells
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S) * 1e3
    rec = {"phase": "kernel", "name": "column_merge", "ok": ok,
           "shapes": {"y": list(y.shape), "dtype": str(y.dtype),
                      "out": list(out.shape), "live_columns": live},
           "max_abs_err": err_out, "max_abs_err_stats": err_stats,
           "rel_err": rel_out, "rel_err_stats": rel_stats,
           "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_call": "Tensor.index_add_",
           "bytes": n_bytes, "ops": n_ops, "bound_ms": bound_ms,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_FLOP_PER_S else "operations")}
    emit(rec)
    check(ok, f"K1 disagrees with its plain version: {rel_out}, "
              f"{rel_stats}")
    return rec


# ------------------------------------------------------------- K2


def gather_geometry(features, points_rc, image_size, eps):
    """Per level: the (r0, c0, r1, c1, fr, fc) the gather uses."""
    import torch

    im_h, im_w = image_size
    out = []
    for f in features:
        _, Hf, Wf, _ = f.shape
        r = torch.clamp(points_rc[..., 0] / (im_h / Hf) - eps, 0, Hf - 1)
        c = torch.clamp(points_rc[..., 1] / (im_w / Wf) - eps, 0, Wf - 1)
        r0, c0 = torch.floor(r).long(), torch.floor(c).long()
        out.append((r, c, r0, c0, torch.clamp(r0 + 1, max=Hf - 1),
                    torch.clamp(c0 + 1, max=Wf - 1)))
    return out


def grid_sample_levels(features, points_rc, image_size, eps):
    """Yardstick for K2: one ``F.grid_sample`` per level (textbook
    bilinear, border clamp, align_corners so cell centres sit on integer
    coordinates) on the same channels-last levels."""
    import torch
    import torch.nn.functional as F

    grids = []
    for f, (r, c, *_rest) in zip(features,
                                gather_geometry(features, points_rc,
                                                image_size, eps)):
        _, Hf, Wf, _ = f.shape
        g = torch.stack([2 * c / max(Wf - 1, 1) - 1,
                         2 * r / max(Hf - 1, 1) - 1], dim=-1)
        grids.append(g[:, None].contiguous())

    def run():
        return [F.grid_sample(f.permute(0, 3, 1, 2), g, mode="bilinear",
                              padding_mode="border", align_corners=True)
                for f, g in zip(features, grids)]
    return run


def phase_fpn_gather(gather_args, eps, swapped):
    import torch

    from mvxnet_makise_tpu_torch.ops import gather as ga

    feats, rc, valid, gsize = gather_args
    launches0 = ga.KERNEL.launches
    got = ga.fpn_gather(feats, rc, valid, gsize, eps=eps,
                        swapped_weights=swapped)
    check(ga.KERNEL.launches == launches0 + 1, "K2 wrapper did not launch")
    want = ga.fpn_gather_plain(feats, rc, valid, gsize, eps=eps,
                               swapped_weights=swapped)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    tol = TOL["fpn_gather"]
    ok = rel <= tol["out"]

    ms = time_ms(lambda: ga.fpn_gather(feats, rc, valid, gsize, eps=eps,
                                       swapped_weights=swapped))
    plain_ms = time_ms(lambda: ga.fpn_gather_plain(
        feats, rc, valid, gsize, eps=eps, swapped_weights=swapped), iters=5)
    library_ms = time_ms(grid_sample_levels(feats, rc, gsize, eps))

    # bytes this run's data needs: every output row written once, the
    # points and masks read once, and each distinct feature cell that a
    # valid point touches read once
    B, P = valid.shape
    ctot = sum(f.shape[-1] for f in feats)
    touched = 0
    for f, (_, _, r0, c0, r1, c1) in zip(
            feats, gather_geometry(feats, rc, gsize, eps)):
        _, Hf, Wf, C = f.shape
        base = torch.arange(B, device=rc.device)[:, None] * (Hf * Wf)
        cells = torch.stack([base + r0 * Wf + c0, base + r1 * Wf + c0,
                             base + r0 * Wf + c1, base + r1 * Wf + c1],
                            -1)[valid]
        touched += int(torch.unique(cells).numel()) * C * 4
    n_valid = int(valid.sum())
    n_bytes = B * P * ctot * 4 + rc.numel() * 4 + valid.numel() + touched
    n_ops = n_valid * ctot * 7          # 4 multiplies, 3 adds per value
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S) * 1e3
    rec = {"phase": "kernel", "name": "fpn_gather", "ok": ok,
           "shapes": {"levels": [list(f.shape) for f in feats],
                      "points": list(rc.shape), "valid_points": n_valid,
                      "out": list(got.shape)},
           "swapped_weights": swapped,
           "max_abs_err": err, "rel_err": rel, "tolerance": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "F.grid_sample, one call per level",
           "bytes": n_bytes, "touched_feature_bytes": touched, "ops": n_ops,
           "bound_ms": bound_ms,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_FLOP_PER_S else "operations")}
    emit(rec)
    check(ok, f"K2 disagrees with its plain version: {rel}")
    return rec


# ------------------------------------------------------------- Detector


def check_detections(dets, cfg) -> list:
    """Shapes, finiteness, score range and class indices; returns the
    number of detections per frame."""
    import numpy as np

    counts = []
    for d in dets:
        k = len(d.scores)
        check(d.boxes.shape == (k, 7) and d.classes.shape == (k,),
              "detections of the wrong shape")
        check(bool(np.isfinite(d.boxes).all()), "non-finite boxes")
        check(bool(((d.scores > 0) & (d.scores <= 1)).all()),
              "scores outside (0, 1]")
        check(k == 0 or int(d.classes.max()) < cfg.num_classes,
              "class index out of range")
        counts.append(k)
    return counts


def same_detections(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x.boxes, y.boxes) and np.array_equal(x.scores, y.scores)
        and np.array_equal(x.classes, y.classes) for x, y in zip(a, b))


def phase_detector(det, frames, batch_size, kernels):
    """The main path: detect_frames on one batch, then detect_stream
    over all frames, with every kernel's count set to 0 just before."""
    import torch

    cfg = det.cfg
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    first = det.detect_frames(frames[:batch_size])
    t1 = time.perf_counter()
    streamed = list(det.detect_stream(frames, batch_size=batch_size))
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in kernels}

    check(len(streamed) == len(frames), "detect_stream lost frames")
    check(same_detections(first, streamed[:batch_size]),
          "detect_stream differs from detect_frames on the same frames")
    counts = check_detections(streamed, cfg)
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    det.detect_frames(frames[:batch_size])
    t4 = time.perf_counter()
    rec = {"phase": "detector", "ok": True,
           "config": "default Config (full width, reference RPN trunk, "
                     "image_min_side 800, float32)",
           "feed": "C++ (csrc/pointcloud.cpp)",
           "frames": len(frames), "batch_size": batch_size,
           "detections_per_frame": counts,
           "detect_frames_ms_per_frame_first": (t1 - t0) * 1e3 / batch_size,
           "detect_frames_ms_per_frame": (t4 - t3) * 1e3 / batch_size,
           "detect_stream_ms_per_frame": (t2 - t1) * 1e3 / len(frames),
           "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
           "launches": launches,
           "launches_per_frame": {n: c / (batch_size + len(frames))
                                  for n, c in launches.items()}}
    emit(rec)
    missing = [n for n, c in launches.items() if c == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    return rec


# modules of the serving path timed by phase_profile, in forward order
STAGES = ("head", "head.extractor.backbone", "head.fusion", "backbone.svfe",
          "backbone.fcn",
          "backbone.cml.conv1", "backbone.cml.conv2", "backbone.cml.conv3",
          "backbone.rpn")


def stage_times(det, arrays, iters: int = 3) -> dict:
    """Device ms per call of each module in STAGES, of the whole model,
    and of one ``run_batch`` (voxelize, model, decode), CUDA events
    around each module's forward (hooks; the model is not changed)."""
    import torch

    events = {}

    def pre(name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])
        return hook

    def post(name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
        return hook

    mods = dict(det.model.named_modules())
    handles = []
    for name in ("model",) + STAGES:
        m = det.model if name == "model" else mods[name]
        handles += [m.register_forward_pre_hook(pre(name)),
                    m.register_forward_hook(post(name))]
    det.run_batch(*arrays)                     # warm
    torch.cuda.synchronize()
    events.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        det.run_batch(*arrays)
    end.record()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    out = {name: sum(s.elapsed_time(e) for s, e in evs) / iters
           for name, evs in events.items()}
    out["run_batch"] = start.elapsed_time(end) / iters
    return out


def phase_profile(det, frames, batch_size):
    """Where one batch's time goes: device ms per module (CUDA events),
    then device time by kernel name and the device's idle share over
    one ``detect_frames`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arrays = det.assemble(frames[:batch_size])
    stages = stage_times(det, arrays)
    det.detect_frames(frames[:batch_size])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect_frames(frames[:batch_size])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    emit({"phase": "profile", "batch_size": batch_size,
          "stage_device_ms": stages,
          "detect_frames_wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
          "kernel_launches": sum(v[1] for v in kernels.values()),
          "top": [{"kernel": k[:100], "device_ms": v[0], "calls": v[1]}
                  for k, v in top[:15]]})


def model_maps(det, arrays):
    """The model's (score, reg) maps on the CPU for one assembled batch,
    computed in the detector's own device and dtype."""
    import torch

    from mvxnet_makise_tpu_torch.train.step import (
        frames_to_batch,
        model_inputs,
    )

    pts, nums, imgs = (torch.as_tensor(a).to(det.device) for a in arrays)
    with torch.no_grad():
        b = frames_to_batch(pts.to(det.dtype), nums, imgs.to(det.dtype),
                            det.cfg)
        return [m.cpu().double() for m in det.model(*model_inputs(b))]


def phase_reference(device):
    """Small configuration: the card's float32 maps against a float64 run
    of the same weights on the CPU, beside the CPU's own float32 run.

    An untrained model amplifies float32 rounding (its stateless norms
    divide near-constant channels by their tiny spread), so its float32
    maps sit ~1e-3 from float64 on any device.  The card passes when it is
    within REF_FACTOR times the CPU's float32 distance; a wrong kernel or
    layout moves the maps by the size of the values themselves."""
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.serve import Detector

    cfg = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                 voxel_shape=(32, 40, 10), image_size=(64, 96),
                 max_points=1024, max_voxels=256, samples_per_voxel=8,
                 assign_window=6, image_min_side=0)
    gpu = Detector.create(cfg, seed=1, device=device)
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu32 = Detector.create(cfg, state_dict=weights, device="cpu")
    ref = build_model(cfg, seed=None, device="cpu")
    ref.load_state_dict(weights)
    cpu64 = Detector(cfg, ref.double())
    frames = make_frames(cfg, 2, seed=1, num_cars=2, num_points=1200)
    arrays = cpu32.assemble(frames)
    want = model_maps(cpu64, arrays)
    errs = {}
    for name, det in (("card", gpu), ("cpu_float32", cpu32)):
        errs[name] = {m: rel_err(g, w)[1] for m, g, w in
                      zip(("score", "reg"), model_maps(det, arrays), want)}
    counts = check_detections(gpu.detect_batch(*arrays), cfg)
    for d in (gpu, cpu32, cpu64):
        d.close()
    ok = all(errs["card"][m] <= max(REF_FACTOR * errs["cpu_float32"][m],
                                    1e-6) for m in ("score", "reg"))
    emit({"phase": "reference", "ok": ok, "config": "voxel_shape "
          "(32, 40, 10), image 64x96, native scale",
          "rel_err_vs_cpu_float64": errs, "factor": REF_FACTOR,
          "detections_card": counts})
    check(ok, f"card maps too far from the float64 reference: {errs}")


# ------------------------------------------------------------- main


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.data import native
    from mvxnet_makise_tpu_torch.ops import column_merge, cuda_build, gather
    from mvxnet_makise_tpu_torch.serve import Detector

    device = torch.device("cuda", 0)
    kernels = [column_merge.KERNEL, gather.KERNEL]
    t0 = time.perf_counter()
    info = cuda_build.build_all(kernels)
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0, "kernels": info})
    # the numpy fallback shuffles points in another order, which changes
    # detections: every number below is the C++ feed's
    check(native.available(), "the C++ host feed (csrc/pointcloud.cpp) "
          "did not build")

    cfg = Config()
    det = Detector.create(cfg, seed=0, device=device)
    try:
        t0 = time.perf_counter()
        det.warm((BATCH,))
        emit({"phase": "warm", "seconds": time.perf_counter() - t0})
        frames = make_frames(cfg, FRAMES, seed=0)
        merge_args, gather_args = kernel_inputs(det, frames[:BATCH])
        k1 = phase_column_merge(merge_args, cfg.voxel_shape)
        k2 = phase_fpn_gather(gather_args, cfg.eps,
                              cfg.compat_swapped_bilerp)
        del merge_args, gather_args
        torch.cuda.empty_cache()
        drive = phase_detector(det, frames, BATCH, kernels)
        phase_profile(det, frames, BATCH)
    finally:
        det.close()
    phase_reference(device)

    sources = {"column_merge": (
        "mvxnet_makise_tpu_torch/csrc/column_merge.cu",
        "mvxnet_makise_tpu/ops/pallas_column_merge.py:469"),
        "fpn_gather": ("mvxnet_makise_tpu_torch/csrc/fpn_gather.cu",
                       "mvxnet_makise_tpu/ops/pallas_gather.py:162")}
    emit({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": sources[r["name"]][0], "replaces": sources[r["name"]][1],
         "launches": drive["launches"][r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in (k1, k2)]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
