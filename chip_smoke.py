#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mvxnet_makise_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``build``: compiles every CUDA kernel of the port from
   ``mvxnet_makise_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together) and reports seconds, the command and ``ptxas`` register use.
2. ``kernel``: one phase per kernel, forward and backward.  Inputs come
   from the forward of synthetic frames at the full default ``Config``
   (and, for K4, the dense-3D CML's voxel rows); each kernel's wrapper is
   held against its plain PyTorch version (for a backward: autograd
   through the plain version) on the same inputs, with the tolerance
   stated, and timed beside the plain version, a one-call PyTorch
   yardstick and the card's bound for the same work (CUDA events around
   back-to-back calls that a spin kernel let the host queue ahead).  Each
   record gives the launch configuration of the kernel's last call: grid,
   block, shared bytes and the registers ptxas gave each kernel (as
   ``-Xptxas -v`` reports them, read back with ``cudaFuncGetAttributes``).
3. ``detector``: the port's ``serve.Detector`` at the full default
   ``Config`` (random weights from a seed) serves synthetic frames through
   ``detect_frames`` and ``detect_stream``, fed by the C++ host feed (the
   run fails if it cannot be built).  The serving kernels' launch counts
   are set to 0 just before and read just after; a kernel the path never
   launched fails the run.
4. ``profile``: where one batch's time goes, device ms per module and
   per kernel, and the device's idle share.
5. ``reference``: at a small configuration, the card's model maps are
   held against the same weights run in float64 on the CPU, where every
   kernel runs its plain PyTorch version.
6. ``train``: ``train.loop.train`` at the full default ``Config``, batch
   4, on 8 synthetic frames, with the training kernels' counts set to 0
   just before and read just after; then a checkpoint round trip, the
   frozen extractor, the first step's gradients (every trainable
   parameter finite and nonzero), 15 steps on one fixed batch (the loss
   must fall), ms per step, peak memory, and the per-module forward and
   backward split of one step.
7. ``train_dense3d``: the same with ``cml_mode="dense3d",
   scatter_backend="pallas"`` at batch 2 on 4 frames (K4 forward and
   backward on the path).
8. ``train_reference``: at the small configuration, one step's loss and
   gradients on the card held to 10x the CPU float32 distance from a
   float64 CPU step, in both CML modes.
9. ``kitti``: the dataset path through the port's tools at the full
   default ``Config``, batch 4, in a temporary directory: a synthetic KITTI
   tree of 12 frames (8 train, 4 val; PNG images), ``tools.cropdata`` in
   its native and torch modes (the crops must match),
   ``tools.create_gtdatabase``, ``tools.train`` for one epoch with the
   GT-paste augmentation and the val AP (the training kernels' counts set
   to 0 just before and read just after; each must have launched), the
   same epoch without the augmentation, ``tools.evaluate`` (its AP must
   equal the loop's on the same weights), and ``tools.detect`` (one
   parseable KITTI result file per val frame).  Records the PNG decode ms,
   host prep ms per frame with and without the augmentation, the step and
   eval ms from the loop's phase timer, the AP and the database size.

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
#   K1 sums the same <= 9 taps in the same order as the plain version and
#   then adds the bias, so its output equals the plain version's (0 in
#   float32); the per-row statistics add 400 cells in another order.
#   K2 rounds its four weighted taps in another order than the plain
#   version and divides where PyTorch multiplies by a reciprocal.
#   K1's backward forms the pre-ReLU cotangent with its three adds in
#   another order than autograd (dy), and sums the bias gradient over the
#   563k cells of a batch in another order (dbias).
#   K3 is K1's kernel without the epilogue: the same adds in the same
#   order.  K3's backward, K4 and K4's backward copy values: exact.
TOL = {"column_merge": {"out": 1e-6, "stats": 1e-5},
       "column_merge_bwd": {"dy": 1e-5, "dbias": 1e-4},
       "merge_taps": {"out": 1e-6},
       "merge_taps_bwd": {"dy": 0.0},
       "scatter_grid": {"grid": 0.0},
       "scatter_grid_bwd": {"d": 0.0},
       "fpn_gather": {"out": 1e-5}}
# the card's model maps and one train step's gradients may sit this many
# times further from a float64 reference than the CPU's float32 ones do
# (phase_reference, phase_train_reference); a gradient's distance needs
# not be below GRAD_FLOOR, a fifth of the ~5 % most parameters' float32
# gradients sit from float64
REF_FACTOR = 10.0
GRAD_FLOOR = 1e-2
# cycles of the spin kernel time_ms queues first (~0.1 s at the H100's
# clock): longer than the host takes to queue the timed calls
SPIN_CYCLES = 2 * 10**8
# the main path's run: FRAMES synthetic frames served in batches of BATCH
FRAMES = 8
BATCH = 4
# training: FRAMES frames in batches of BATCH for one epoch, then
# FIXED_STEPS steps on one fixed batch; the dense-3D CML at DENSE_BATCH
FIXED_STEPS = 15
DENSE_BATCH = 2
# the kitti phase: a tree of KITTI_TRAIN + KITTI_VAL synthetic frames, the
# tools run with these config fields (and a checkpoint directory of their
# own) on the card
KITTI_TRAIN, KITTI_VAL = 8, 4
KITTI_CFG = {"batch_size": BATCH}
KITTI_DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events around the whole run.  A spin kernel holds the card while
    the host queues every call, so the calls run back to back on the
    device and the events do not count the host's time between calls,
    which would dominate a call whose kernels take tens of
    microseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library=None, plain_iters: int = 3) -> dict:
    """ms of the kernel's call, of the plain version and of the one-call
    yardstick (None without one)."""
    return {"ms": time_ms(kernel),
            "plain_ms": time_ms(plain, iters=plain_iters, warmup=1),
            "library_ms": time_ms(library) if library else None}


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
    """The arguments the serving path hands K1 and K2 for ``frames``, the
    same modules stopped at each kernel's call, and the voxel rows the
    dense-3D CML hands K4."""
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
    return merge_args, gather_args, (vfeat, b.coords, b.vmask)


# ------------------------------------------------------------- K1


def merge_dest(col_cy, bounds, grid_shape):
    """The flat output cell of every (frame, column, tap) row, B*nx*ny
    where the tap falls out of the grid or the column is dead."""
    import torch

    nx, ny = grid_shape[0], grid_shape[1]
    B, V = col_cy.shape
    col = torch.arange(V, device=col_cy.device, dtype=bounds.dtype)
    cx = torch.searchsorted(bounds, col.expand(B, V).contiguous(),
                            right=True) - 1
    live = col[None] < bounds[:, nx:nx + 1]
    t = torch.arange(9, device=col_cy.device)
    ox = cx[..., None] + 1 - t // 3
    oy = col_cy[..., None] + 1 - t % 3
    ok = live[..., None] & (ox >= 0) & (ox < nx) & (oy >= 0) & (oy < ny)
    cell = ox * ny + oy + (torch.arange(B, device=col_cy.device)
                           * (nx * ny))[:, None, None]
    return torch.where(ok, cell, torch.full_like(cell, B * nx * ny))


def merge_index_add(y, col_cy, bounds, grid_shape):
    """Yardstick for K1 and K3: the destination row of every (column, tap)
    row, for one ``index_add_`` that sums the taps into the dense grid (no
    bias, ReLU or statistics).  Returns (dest, out buffer)."""
    import torch

    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    dest = merge_dest(col_cy, bounds, grid_shape)
    out = torch.zeros((B * nx * ny + 1, R), dtype=y.dtype, device=y.device)
    return dest.reshape(-1), out


def launch_config(*kernels) -> dict:
    """Per wrapper, the launch configuration of each kernel its last call
    launched (grid, block, shared bytes, registers)."""
    return {k.name: k.last_launch for k in kernels}


def bound_of(n_bytes: float, n_ops: float) -> tuple:
    """(bound ms, what bounds it) for moving n_bytes and doing n_ops
    float32 operations at the card's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def phase_column_merge(merge_args, grid_shape):
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, bias = merge_args
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    launches0 = cm.KERNEL.launches
    out, stats = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    check(cm.KERNEL.launches == launches0 + 1, "K1 wrapper did not launch")
    # the row statistics are summed across threads and blocks in a fixed
    # order: a second call gives the same bits
    out2, stats2 = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    want_out, want_stats = cm.merge_taps_fused_plain(y, col_cy, bounds,
                                                     bias, grid_shape)
    torch.cuda.synchronize()
    same_twice = torch.equal(out, out2) and torch.equal(stats, stats2)
    del out2, stats2
    err_out, rel_out = rel_err(out, want_out)
    err_stats, rel_stats = rel_err(stats, want_stats)
    tol = TOL["column_merge"]
    ok = rel_out <= tol["out"] and rel_stats <= tol["stats"] and same_twice

    dest, buf = merge_index_add(y, col_cy, bounds, grid_shape)
    rows = y.reshape(-1, R)
    times = timings(
        lambda: cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape),
        lambda: cm.merge_taps_fused_plain(y, col_cy, bounds, bias,
                                          grid_shape),
        lambda: buf.index_add_(0, dest, rows))

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
           "launch": launch_config(cm.KERNEL),
           "max_abs_err": err_out, "max_abs_err_stats": err_stats,
           "rel_err": rel_out, "rel_err_stats": rel_stats,
           "bit_identical_twice": same_twice,
           "tolerance": tol, **times, "library_call": "Tensor.index_add_",
           "bytes": n_bytes, "ops": n_ops, "bound_ms": bound_ms,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_FLOP_PER_S else "operations")}
    emit(rec)
    check(ok, f"K1 disagrees with its plain version or is not "
              f"deterministic: {rel_out}, {rel_stats}, {same_twice}")
    return rec


def phase_column_merge_bwd(merge_args, grid_shape):
    """K1's backward: the pre/dbias kernel pair, then K3's backward
    gather of pre, against autograd through K1's plain version on the
    same out, g_out and g_stats."""
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, bias = merge_args
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    gen = torch.Generator(device=y.device).manual_seed(0)
    out, stats = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    g_out = torch.randn(out.shape, generator=gen, device=y.device)
    g_stats = torch.randn(stats.shape, generator=gen, device=y.device) * 0.1
    before = (cm.BWD_KERNEL.launches, cm.TAPS_BWD_KERNEL.launches)
    dy, dbias = cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                             bounds, V, grid_shape)
    check((cm.BWD_KERNEL.launches, cm.TAPS_BWD_KERNEL.launches)
          == (before[0] + 1, before[1] + 1),
          "K1's backward wrapper did not launch its kernels")
    dy2, dbias2 = cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                               bounds, V, grid_shape)
    yp = y.detach().requires_grad_()
    bp = bias.detach().requires_grad_()
    want_out, want_stats = cm.merge_taps_fused_plain(yp, col_cy, bounds, bp,
                                                     grid_shape)
    outs, ins, grads = (want_out, want_stats), (yp, bp), (g_out, g_stats)
    want_dy, want_dbias = torch.autograd.grad(outs, ins, grads,
                                              retain_graph=True)
    torch.cuda.synchronize()
    same_twice = torch.equal(dy, dy2) and torch.equal(dbias, dbias2)
    err_dy, rel_dy = rel_err(dy, want_dy)
    err_db, rel_db = rel_err(dbias, want_dbias)
    tol = TOL["column_merge_bwd"]
    ok = rel_dy <= tol["dy"] and rel_db <= tol["dbias"] and same_twice

    times = timings(
        lambda: cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                             bounds, V, grid_shape),
        lambda: torch.autograd.grad(outs, ins, grads, retain_graph=True))
    del outs, ins, grads, want_out, want_stats, want_dy, want_dbias

    es = y.element_size()
    cells = B * nx * ny * R
    # out and g_out read once, g_stats read once, dy and dbias written
    n_bytes = (2 * cells * es + g_stats.numel() * 4 + col_cy.numel() * 4
               + bounds.numel() * 4 + B * V * 9 * R * es + R * 4)
    # per cell: two adds, two multiplies, the ReLU test, the dbias add
    n_ops = 6 * cells
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    rec = {"phase": "kernel", "name": "column_merge_bwd", "ok": ok,
           "shapes": {"out": list(out.shape), "dy": list(dy.shape),
                      "dtype": str(out.dtype)},
           "launch": launch_config(cm.BWD_KERNEL, cm.TAPS_BWD_KERNEL),
           "max_abs_err": err_dy, "max_abs_err_dbias": err_db,
           "rel_err": rel_dy, "rel_err_dbias": rel_db,
           "bit_identical_twice": same_twice, "tolerance": tol, **times,
           "library_call": None, "bytes": n_bytes, "ops": n_ops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    check(ok, f"K1's backward disagrees with autograd of its plain version "
              f"or is not deterministic: {rel_dy}, {rel_db}, {same_twice}")
    return rec


def phase_merge_taps(merge_args, grid_shape):
    """K3 forward (K1's kernel without its epilogue) and backward (the
    windowed gather), each against its plain version."""
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, _ = merge_args
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    es = y.element_size()
    launches0 = cm.TAPS_KERNEL.launches
    out = cm.merge_taps(y, col_cy, bounds, grid_shape)
    check(cm.TAPS_KERNEL.launches == launches0 + 1,
          "K3 wrapper did not launch")
    want = cm.merge_taps_plain(y, col_cy, bounds, grid_shape)
    torch.cuda.synchronize()
    err, rel = rel_err(out, want)
    tol = TOL["merge_taps"]
    dest, buf = merge_index_add(y, col_cy, bounds, grid_shape)
    rows = y.reshape(-1, R)
    times = timings(
        lambda: cm.merge_taps(y, col_cy, bounds, grid_shape),
        lambda: cm.merge_taps_plain(y, col_cy, bounds, grid_shape),
        lambda: buf.index_add_(0, dest, rows))
    del buf, want
    live = int(bounds[:, nx].sum())
    n_bytes = (live * 9 * R * es + col_cy.numel() * 4 + bounds.numel() * 4
               + B * nx * ny * R * es)
    n_ops = live * 9 * R
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    fwd = {"phase": "kernel", "name": "merge_taps", "ok": rel <= tol["out"],
           "shapes": {"y": list(y.shape), "out": list(out.shape),
                      "live_columns": live},
           "launch": launch_config(cm.TAPS_KERNEL),
           "max_abs_err": err, "rel_err": rel, "tolerance": tol, **times,
           "library_call": "Tensor.index_add_", "bytes": n_bytes,
           "ops": n_ops, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(fwd)
    check(fwd["ok"], f"K3 disagrees with its plain version: {rel}")

    g = torch.randn(out.shape, device=y.device,
                    generator=torch.Generator(device=y.device).manual_seed(1))
    yq = y.detach().requires_grad_()
    o = cm.merge_taps(yq, col_cy, bounds, grid_shape)
    launches0 = cm.TAPS_BWD_KERNEL.launches
    (dy,) = torch.autograd.grad(o, yq, g, retain_graph=True)
    check(cm.TAPS_BWD_KERNEL.launches == launches0 + 1,
          "K3's backward did not launch")
    yp = y.detach().requires_grad_()
    wp = cm.merge_taps_plain(yp, col_cy, bounds, grid_shape)
    (want_dy,) = torch.autograd.grad(wp, yp, g, retain_graph=True)
    torch.cuda.synchronize()
    err, rel = rel_err(dy, want_dy)
    tol = TOL["merge_taps_bwd"]
    # yardstick: one index_select of the cotangent rows, with a zero row
    # for the taps that fall out of the grid
    gpad = torch.cat([g.reshape(-1, R), g.new_zeros(1, R)])
    times = timings(
        lambda: cm.merge_taps_backward(g, col_cy, bounds, V, grid_shape),
        lambda: torch.autograd.grad(wp, yp, g, retain_graph=True),
        lambda: torch.index_select(gpad, 0, dest))
    del wp, want_dy, gpad
    touched = int(torch.unique(dest[dest < B * nx * ny]).numel())
    n_bytes = (B * V * 9 * R * es + touched * R * es + col_cy.numel() * 4
               + bounds.numel() * 4)
    bound_ms, bound_by = bound_of(n_bytes, 0)
    bwd = {"phase": "kernel", "name": "merge_taps_bwd",
           "ok": rel <= tol["dy"],
           "shapes": {"g": list(g.shape), "dy": list(dy.shape),
                      "touched_cells": touched},
           "launch": launch_config(cm.TAPS_BWD_KERNEL),
           "max_abs_err": err, "rel_err": rel, "tolerance": tol, **times,
           "library_call": "torch.index_select (zero-padded cotangent)",
           "bytes": n_bytes, "ops": 0, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(bwd)
    check(bwd["ok"], f"K3's backward disagrees with its plain version: "
                     f"{rel}")
    return fwd, bwd


# ------------------------------------------------------------- K4


def phase_scatter_grid(scatter_args, grid_shape):
    """K4 forward and backward against the plain scatter and its
    autograd, on the voxel rows of the smoke's frames."""
    import torch

    from mvxnet_makise_tpu_torch.ops import scatter_grid as sg
    from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid

    vfeat, coords, vmask = scatter_args
    nx, ny, nz = grid_shape
    B, V, C = vfeat.shape
    n_cells = nx * ny * nz
    es = vfeat.element_size()
    n_valid = int(vmask.sum())
    launches0 = sg.KERNEL.launches
    got = sg.scatter_to_grid(vfeat, coords, vmask, grid_shape)
    check(sg.KERNEL.launches == launches0 + 1, "K4 wrapper did not launch")
    want = scatter_voxels_to_grid(vfeat, coords, vmask, grid_shape)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    del want
    cell = coords[..., 2] * (nx * ny) + coords[..., 0] * ny + coords[..., 1]
    frame = torch.arange(B, device=vfeat.device)[:, None]
    flat = (frame * (n_cells + 1)
            + torch.where(vmask, cell, n_cells)).reshape(-1)
    rows = vfeat.reshape(-1, C)
    times = timings(
        lambda: sg.scatter_to_grid(vfeat, coords, vmask, grid_shape),
        lambda: scatter_voxels_to_grid(vfeat, coords, vmask, grid_shape),
        lambda: torch.zeros((B * (n_cells + 1), C), dtype=vfeat.dtype,
                            device=vfeat.device).index_copy_(0, flat, rows))
    n_bytes = (B * n_cells * C * es + n_valid * C * es + coords.numel() * 4
               + vmask.numel())
    bound_ms, bound_by = bound_of(n_bytes, 0)
    fwd = {"phase": "kernel", "name": "scatter_grid",
           "ok": rel <= TOL["scatter_grid"]["grid"],
           "shapes": {"features": list(vfeat.shape),
                      "grid": list(got.shape), "valid_rows": n_valid},
           "launch": launch_config(sg.KERNEL),
           "max_abs_err": err, "rel_err": rel,
           "tolerance": TOL["scatter_grid"], **times,
           "library_call": "torch.zeros(...).index_copy_",
           "bytes": n_bytes, "ops": 0, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(fwd)
    check(fwd["ok"], f"K4 disagrees with its plain version: {rel}")
    del got

    g = torch.randn((B, nz, nx, ny, C), device=vfeat.device,
                    generator=torch.Generator(
                        device=vfeat.device).manual_seed(2))
    fq = vfeat.detach().requires_grad_()
    gq = sg.scatter_to_grid(fq, coords, vmask, grid_shape)
    launches0 = sg.BWD_KERNEL.launches
    (d,) = torch.autograd.grad(gq, fq, g, retain_graph=True)
    check(sg.BWD_KERNEL.launches == launches0 + 1,
          "K4's backward did not launch")
    fp = vfeat.detach().requires_grad_()
    wp = scatter_voxels_to_grid(fp, coords, vmask, grid_shape)
    (want_d,) = torch.autograd.grad(wp, fp, g, retain_graph=True)
    torch.cuda.synchronize()
    err, rel = rel_err(d, want_d)
    # yardstick: one index_select of the rows' cells (masked rows read
    # cell 0 instead of being zeroed)
    idx = (frame * n_cells + torch.where(vmask, cell, 0)).reshape(-1)
    g_rows = g.reshape(-1, C)
    times = timings(
        lambda: sg.scatter_to_grid_backward(g, coords, vmask, grid_shape),
        lambda: torch.autograd.grad(wp, fp, g, retain_graph=True),
        lambda: torch.index_select(g_rows, 0, idx))
    del wp, want_d, gq
    n_bytes = (n_valid * C * es + coords.numel() * 4 + vmask.numel()
               + B * V * C * es)
    bound_ms, bound_by = bound_of(n_bytes, 0)
    bwd = {"phase": "kernel", "name": "scatter_grid_bwd",
           "ok": rel <= TOL["scatter_grid_bwd"]["d"],
           "shapes": {"g": list(g.shape), "d_features": list(d.shape)},
           "launch": launch_config(sg.BWD_KERNEL),
           "max_abs_err": err, "rel_err": rel,
           "tolerance": TOL["scatter_grid_bwd"], **times,
           "library_call": "torch.index_select (masked rows not zeroed)",
           "bytes": n_bytes, "ops": 0, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(bwd)
    check(bwd["ok"], f"K4's backward disagrees with its plain version: "
                     f"{rel}")
    return fwd, bwd


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

    times = timings(
        lambda: ga.fpn_gather(feats, rc, valid, gsize, eps=eps,
                              swapped_weights=swapped),
        lambda: ga.fpn_gather_plain(feats, rc, valid, gsize, eps=eps,
                                    swapped_weights=swapped),
        grid_sample_levels(feats, rc, gsize, eps))

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
           "launch": launch_config(ga.KERNEL),
           "max_abs_err": err, "rel_err": rel, "tolerance": tol, **times,
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
    gpu = Detector.create(cfg, checkpoint_epoch=0, seed=1, device=device)
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


# ------------------------------------------------------------- training


def make_train_frames(cfg, n: int, seed: int, **kw):
    """``n`` synthetic training frames (with their GT cars) from
    ``seed``."""
    import numpy as np

    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        pts, calib, image, boxes = synthetic_frame(rng, cfg, **kw)
        frames.append(KittiFrame(f"synth{i:06d}", pts, image, calib,
                                 {"Car": boxes}))
    return frames


def bad_gradients(model) -> list:
    """Trainable parameters whose gradient is missing, non-finite or all
    zero."""
    import torch

    from mvxnet_makise_tpu_torch.train.state import is_frozen

    return [n for n, p in model.named_parameters() if not is_frozen(n)
            and (p.grad is None or not bool(torch.isfinite(p.grad).all())
                 or not bool(p.grad.any()))]


def fixed_batch(cfg, frames, device, seed: int = 0):
    """One batch of ``frames`` (arguments of the full train step after the
    state) with a fixed voxelizer shuffle."""
    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.train.loop import (
        collate,
        preprocess_train_frame,
    )

    arrays = [preprocess_train_frame(f, cfg, None,
                                     np.random.default_rng(i))
              for i, f in enumerate(frames)]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=gen)
                        for _ in frames]).to(device)
    return (*collate(arrays, device), perm)


# modules of the training path timed by step_split
TRAIN_STAGES = ("head.fusion", "backbone.svfe", "backbone.fcn",
                "backbone.cml.conv1", "backbone.cml.conv2",
                "backbone.cml.conv3", "backbone.rpn")


def step_split(model, run_step) -> dict:
    """Device ms of one train step, per module forward and backward.

    Forward: CUDA events around each module's forward (module hooks).
    Backward: from the first gradient reaching the module's outputs to the
    last gradient leaving it (its inputs that need one, and its
    parameters), events recorded by tensor and parameter hooks.  The model
    is not changed; every hook is removed afterwards."""
    import torch

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    mods = dict(model.named_modules())
    recs = {name: {"f": [], "b0": [], "b1": []} for name in
            ("model",) + TRAIN_STAGES}
    handles = []

    def pre(rec):
        def hook(module, args):
            rec["f"].append([event(), None])
            for a in args:
                if torch.is_tensor(a) and a.requires_grad:
                    a.register_hook(lambda g: rec["b1"].append(event()))
        return hook

    def post(rec):
        def hook(module, args, out):
            rec["f"][-1][1] = event()
            for o in out if isinstance(out, tuple) else (out,):
                if torch.is_tensor(o) and o.requires_grad:
                    o.register_hook(lambda g: rec["b0"].append(event()))
        return hook

    for name, rec in recs.items():
        m = model if name == "model" else mods[name]
        handles += [m.register_forward_pre_hook(pre(rec)),
                    m.register_forward_hook(post(rec))]
        if name != "model":
            for p in m.parameters():
                if p.requires_grad:
                    handles.append(p.register_post_accumulate_grad_hook(
                        lambda p, rec=rec: rec["b1"].append(event())))
    torch.cuda.synchronize()
    start = event()
    run_step()
    end = event()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    out = {"step_ms": start.elapsed_time(end)}
    for name, rec in recs.items():
        fwd = sum(a.elapsed_time(b) for a, b in rec["f"])
        bwd = (max(start.elapsed_time(e) for e in rec["b1"])
               - min(start.elapsed_time(e) for e in rec["b0"])
               if rec["b0"] and rec["b1"] else None)
        out[name] = {"fwd_ms": fwd, "bwd_ms": bwd}
    return out


def profile_step(run_step) -> dict:
    """Kernel-busy ms, the device's idle share and the top kernels over
    one train step (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
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
    return {"step_wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_launches": sum(v[1] for v in kernels.values()),
            "top": [{"kernel": k[:100], "device_ms": v[0], "calls": v[1]}
                    for k, v in top[:15]]}


def timed_steps(step, state, batch, n: int):
    """Run ``n`` steps on one batch; returns (losses, host ms per step,
    each ending in a synchronize)."""
    import torch

    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["total_loss"]))
    return losses, times


def run_train(cfg, frames, device, kernels) -> tuple:
    """The training path through its entry point, ``train.loop.train``,
    for one epoch, with every kernel's count set to 0 just before and read
    just after.  Returns (state, launches, seconds)."""
    import torch

    from mvxnet_makise_tpu_torch.train.loop import train

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    state = train(cfg, frames, num_epochs=1, device=device, seed=0,
                  log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return state, {k.name: k.launches for k in kernels}, seconds


def phase_train(device, kernels):
    """The default Config's training path at batch 4 (see the module
    docstring)."""
    import tempfile

    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    cfg = Config(batch_size=BATCH, checkpoint_dir=ckpt_dir)
    frames = make_train_frames(cfg, FRAMES, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state, launches, seconds = run_train(cfg, frames, device, kernels)
    peak_epoch = torch.cuda.max_memory_allocated() / 2**20
    check(state.step == FRAMES // BATCH, f"train took {state.step} steps")
    needed = ("column_merge", "column_merge_bwd", "merge_taps_bwd",
              "fpn_gather")
    missing = [n for n in needed if launches[n] == 0]

    # the checkpoint restores bit-identically
    _, other = build_model_and_state(cfg, device=device, seed=1)
    ckpt.restore_checkpoint(ckpt_dir, 1, other)
    restored = other.step == state.step and all(
        torch.equal(v, w) for v, w in zip(state.model.state_dict().values(),
                                          other.model.state_dict().values()))
    a = state.optimizer.state_dict()["state"]
    b = other.optimizer.state_dict()["state"]
    restored = restored and a.keys() == b.keys() and all(
        torch.equal(a[i][k].cpu(), b[i][k].cpu()) for i in a for k in a[i])
    # the frozen extractor: bit-identical to a fresh model from the seed
    fresh = build_model(cfg, seed=0, device=device)
    ext = dict(fresh.head.extractor.state_dict())
    extractor_unchanged = all(
        torch.equal(v, ext[k])
        for k, v in state.model.head.extractor.state_dict().items())
    del other, fresh, ext, state
    torch.cuda.empty_cache()

    # FIXED_STEPS steps on one fixed batch from a fresh state
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(device)
    step = make_full_train_step(cfg, anchors)
    model, st = build_model_and_state(cfg, device=device, seed=0)
    batch = fixed_batch(cfg, frames[:BATCH], device)
    torch.cuda.reset_peak_memory_stats()
    first_losses, _ = timed_steps(step, st, batch, 1)
    bad = bad_gradients(model)
    losses, times = timed_steps(step, st, batch, FIXED_STEPS - 1)
    losses = first_losses + losses
    peak_step = torch.cuda.max_memory_allocated() / 2**20
    split = step_split(model, lambda: step(st, *batch))
    prof = profile_step(lambda: step(st, *batch))
    # the same steps with cuDNN choosing its algorithms by timing them
    # (the first step times them), recorded beside the default's
    torch.backends.cudnn.benchmark = True
    timed_steps(step, st, batch, 1)
    _, bench_times = timed_steps(step, st, batch, 3)
    bench_split = step_split(model, lambda: step(st, *batch))
    bench_prof = profile_step(lambda: step(st, *batch))
    bench_prof.pop("top")
    torch.backends.cudnn.benchmark = False
    del model, st
    torch.cuda.empty_cache()

    # two fresh states, one step each on the same batch: recorded, not
    # gated (PyTorch's index backward ops add with atomics)
    states = [build_model_and_state(cfg, device=device, seed=0)[1]
              for _ in range(2)]
    for s_ in states:
        step(s_, *batch)
    steps_bit_identical = all(
        torch.equal(p, q) for p, q in zip(states[0].model.parameters(),
                                          states[1].model.parameters()))
    del states
    torch.cuda.empty_cache()

    ok = (not missing and restored and extractor_unchanged and not bad
          and np.isfinite(losses).all() and losses[-1] < losses[0])
    rec = {"phase": "train", "ok": bool(ok),
           "config": "default Config (full width), batch 4, float32, "
                     "cudnn.deterministic off",
           "frames": FRAMES, "batch_size": BATCH,
           "train_seconds": seconds, "train_steps": FRAMES // BATCH,
           "launches": launches, "missing_kernels": missing,
           "checkpoint_restores_bit_identically": restored,
           "extractor_unchanged": extractor_unchanged,
           "params_without_gradient": bad,
           "fixed_batch_losses": losses,
           "ms_per_step": float(np.median(times)),
           "ms_per_step_all": times,
           "peak_device_mib_epoch": peak_epoch,
           "peak_device_mib_step": peak_step,
           "two_steps_bit_identical": steps_bit_identical,
           "split_device_ms": split, "profile": prof,
           "cudnn_benchmark": {"ms_per_step": float(np.median(bench_times)),
                               "ms_per_step_all": bench_times,
                               "split_device_ms": bench_split,
                               "profile": bench_prof}}
    emit(rec)
    check(ok, "train phase failed: see its record")
    return rec


def phase_train_dense3d(device, kernels):
    """cml_mode="dense3d", scatter_backend="pallas" at full width, batch
    DENSE_BATCH: K4 forward and backward on the training path."""
    import tempfile

    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train.loop import make_full_train_step

    cfg = Config(batch_size=DENSE_BATCH, cml_mode="dense3d",
                 scatter_backend="pallas",
                 checkpoint_dir=tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    frames = make_train_frames(cfg, 2 * DENSE_BATCH, seed=1)
    torch.cuda.reset_peak_memory_stats()
    state, launches, seconds = run_train(cfg, frames, device, kernels)
    needed = ("scatter_grid", "scatter_grid_bwd", "fpn_gather")
    missing = [n for n in needed if launches[n] == 0]
    bad = bad_gradients(state.model)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(device)
    step = make_full_train_step(cfg, anchors)
    batch = fixed_batch(cfg, frames[:DENSE_BATCH], device)
    losses, times = timed_steps(step, state, batch, 3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    split = step_split(state.model, lambda: step(state, *batch))
    del state
    torch.cuda.empty_cache()
    ok = (not missing and not bad and launches["column_merge"] == 0
          and np.isfinite(losses).all())
    rec = {"phase": "train_dense3d", "ok": bool(ok),
           "config": "default Config with cml_mode dense3d, "
                     "scatter_backend pallas, batch 2, float32",
           "train_seconds": seconds, "launches": launches,
           "missing_kernels": missing, "params_without_gradient": bad,
           "losses": losses, "ms_per_step": float(np.median(times[1:])),
           "ms_per_step_all": times, "peak_device_mib": peak,
           "split_device_ms": split}
    emit(rec)
    check(ok, "train_dense3d phase failed: see its record")
    return rec


def phase_train_reference(device):
    """Small configuration, both CML modes: one train step's loss and
    gradients on the card against a float64 CPU step of the same weights
    and batch, beside the CPU's own float32 step.

    An untrained model's float32 gradients sit ~5 % (in norm) from
    float64 on the CPU for most parameters (its stateless norms divide
    near-constant channels by their tiny spread); a few sit far closer on
    the CPU only because its float32 and float64 runs sum in the same
    order.  So each trainable parameter's gradient on the card may sit
    REF_FACTOR times as far from float64 as the CPU's float32 gradient
    does, with a floor of GRAD_FLOOR, and the loss likewise (floor 1e-6);
    a wrong kernel moves a gradient by its own size."""
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train.loop import make_full_train_step
    from mvxnet_makise_tpu_torch.train.state import TrainState

    out = {}
    for mode in ("column", "dense3d"):
        cfg = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                     voxel_shape=(32, 40, 10), image_size=(64, 96),
                     max_points=1024, max_voxels=256, max_boxes=4,
                     samples_per_voxel=8, assign_window=6, image_min_side=0,
                     batch_size=2, cml_mode=mode,
                     scatter_backend="pallas" if mode == "dense3d"
                     else "auto")
        # axis-aligned cars reach the positive IoU: the regression head
        # gets a gradient too
        frames = make_train_frames(cfg, 2, seed=2, num_cars=3,
                                   num_points=1200, yaw_range=(0.0, 0.0))
        batch = fixed_batch(cfg, frames, "cpu", seed=3)
        anchors = torch.from_numpy(create_anchors(
            cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes))
        weights = build_model(cfg, seed=3, device="cpu").state_dict()
        runs = {}
        for name, dev, dtype in (("card", device, torch.float32),
                                 ("cpu_float32", "cpu", torch.float32),
                                 ("cpu_float64", "cpu", torch.float64)):
            model = build_model(cfg, seed=None, device=dev)
            model.load_state_dict(weights)
            model = model.to(dtype).train()
            st = TrainState.create(cfg, model)
            args = [t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
                    for t in batch]
            m = make_full_train_step(cfg, anchors.to(dev, dtype))(st, *args)
            runs[name] = (float(m["total_loss"]), float(m["num_pos"]),
                          {n: p.grad.detach().double().cpu()
                           for n, p in model.named_parameters()
                           if p.grad is not None})
        loss64, _, g64 = runs["cpu_float64"]

        def dist(name):
            loss, _, g = runs[name]
            return (abs(loss - loss64) / abs(loss64),
                    {k: float((g[k] - g64[k]).norm())
                     / max(float(g64[k].norm()), 1e-30) for k in g64})
        card_loss, card = dist("card")
        cpu_loss, cpu = dist("cpu_float32")
        ratio = {k: card[k] / max(cpu[k], 1e-30) for k in g64}
        worst = max(ratio, key=ratio.get)
        ok = (runs["card"][2].keys() == g64.keys()
              and card_loss <= max(REF_FACTOR * cpu_loss, 1e-6)
              and all(card[k] <= max(REF_FACTOR * cpu[k], GRAD_FLOOR)
                      for k in g64))
        out[mode] = {"ok": ok, "num_pos": runs["cpu_float64"][1],
                     "loss_rel_err": {"card": card_loss,
                                      "cpu_float32": cpu_loss},
                     "grad_norm_rel_err_max": {"card": max(card.values()),
                                               "cpu_float32":
                                               max(cpu.values())},
                     "worst_param": worst, "worst_ratio": ratio[worst],
                     "worst_errs": [card[worst], cpu[worst]]}
    rec = {"phase": "train_reference",
           "ok": all(v["ok"] for v in out.values()),
           "config": "voxel_shape (32, 40, 10), image 64x96, batch 2",
           "factor": REF_FACTOR, "modes": out}
    emit(rec)
    check(rec["ok"], f"card training step too far from float64: {out}")


# ------------------------------------------------------------- kitti


def write_paeth_png(path, bgr) -> None:
    """``bgr`` as an RGB PNG whose rows all use the Paeth filter (the
    slowest to decode: each pixel waits for its left neighbour), written
    with numpy and zlib."""
    import struct
    import zlib

    import numpy as np

    x = bgr[..., ::-1].astype(np.int16)
    h, w, _ = x.shape
    a = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]       # left
    b = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]          # up
    c = np.pad(b, ((0, 0), (1, 0), (0, 0)))[:, :-1]       # up-left
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 255).astype(np.uint8).reshape(h, -1)],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def decode_ms(paths) -> float:
    """Mean host ms of ``data.image_io.read_png`` over ``paths``."""
    from mvxnet_makise_tpu_torch.data.image_io import read_png

    t0 = time.perf_counter()
    for p in paths:
        check(read_png(p) is not None, f"{p} did not decode")
    return (time.perf_counter() - t0) * 1e3 / len(paths)


def phase_timer(log: str) -> dict:
    """{phase: (seconds, ms per call)} from the loop's last epoch line."""
    import re

    line = [ln for ln in log.splitlines() if " done | " in ln][-1]
    return {m[0]: (float(m[1]), float(m[2])) for m in
            re.findall(r"(\w+): ([\d.]+)s \(([\d.]+) ms/it\)", line)}


def run_tool(main, args) -> str:
    """A tool's ``main(args)`` in this process (the kernels' launch counts
    are this process's); returns its standard output."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(args)
    check(rc == 0, f"{main.__module__} {args} returned {rc}")
    return out.getvalue()


def phase_kitti(kernels):
    """The dataset path through the tools (module docstring, phase 9)."""
    import glob
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.data.image_io import read_png
    from mvxnet_makise_tpu_torch.data.synthetic import write_kitti_tree
    from mvxnet_makise_tpu_torch.eval import runner
    from mvxnet_makise_tpu_torch.tools import (
        create_gtdatabase,
        cropdata,
        detect,
        evaluate,
    )
    from mvxnet_makise_tpu_torch.tools import train as train_cli

    work = tempfile.mkdtemp(prefix="chip_smoke_kitti-")
    root = os.path.join(work, "kitti")
    configs = {}
    for name in ("augment", "plain"):
        configs[name] = os.path.join(work, f"{name}.yaml")
        with open(configs[name], "w") as f:
            for k, v in dict(KITTI_CFG, checkpoint_dir=os.path.join(
                    work, f"ckpt_{name}")).items():
                f.write(f"{k}: {list(v) if isinstance(v, tuple) else v}\n")
    cfg_path = configs["augment"]
    cfg = Config(**KITTI_CFG)
    dev = ["--device", KITTI_DEVICE]
    t0 = time.perf_counter()
    ids = write_kitti_tree(root, cfg, np.random.default_rng(0), KITTI_TRAIN,
                           KITTI_VAL)
    write_s = time.perf_counter() - t0

    pngs = sorted(glob.glob(os.path.join(root, "training", "image_2",
                                         "*.png")))
    paeth = os.path.join(work, "paeth.png")
    write_paeth_png(paeth, read_png(pngs[0]))
    check(np.array_equal(read_png(paeth), read_png(pngs[0])),
          "the Paeth-filtered PNG decodes to another image")
    png_ms = {"unfiltered": decode_ms(pngs), "paeth": decode_ms([paeth] * 3)}

    crops = {}
    velo_dir = os.path.join(root, "training", "velodyne_croped")
    for mode in ("native", "torch"):
        run_tool(cropdata.main, [root, mode, "--config", cfg_path, *dev])
        crops[mode] = [np.fromfile(os.path.join(velo_dir, f"{i}.bin"),
                                   np.float32) for i in ids]
    crops_match = all(np.array_equal(a, b) for a, b in
                      zip(crops["native"], crops["torch"]))
    points_kept = [len(c) // 4 for c in crops["torch"]]
    check(crops_match, "cropdata's native and torch modes disagree")

    run_tool(create_gtdatabase.main,
             [root, "--classes", "Car", "--config", cfg_path, *dev])
    with open(os.path.join(root, "training", "gtdatabase", "gtinfo.pkl"),
              "rb") as f:
        db_samples = len(pickle.load(f)["Car"])
    check(db_samples > 0, "the GT database is empty")

    # every AP the tools compute, in order: the loop's, then evaluate's
    evals = []
    run_eval = runner.run_eval

    def recorded(*args, **kw):
        evals.append(run_eval(*args, **kw))
        return evals[-1]
    runner.run_eval = recorded
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        log = run_tool(train_cli.main, [root, "-n", "1", "--batch-size",
                                        str(BATCH), "--eval-every", "1",
                                        "--config", cfg_path, *dev])
        train_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        run_tool(evaluate.main, [root, "-r", "1", "--config", cfg_path, *dev])
    finally:
        runner.run_eval = run_eval
    plain_log = run_tool(train_cli.main, [root, "-n", "1", "--batch-size",
                                          str(BATCH), "--no-augment",
                                          "--config", configs["plain"], *dev])
    ckpt_written = os.path.exists(os.path.join(work, "ckpt_augment",
                                               "epoch1"))
    val_lines = [ln for ln in log.splitlines() if " val Car: AP=" in ln]

    out_dir = os.path.join(work, "results")
    run_tool(detect.main, [root, "-o", out_dir, "-r", "1", "--batch",
                           str(BATCH), "--config", cfg_path, *dev])
    lines_ok, n_lines = True, 0
    for fid in ids[KITTI_TRAIN:]:
        path = os.path.join(out_dir, f"{fid}.txt")
        if not os.path.exists(path):
            lines_ok = False
            continue
        with open(path) as f:
            for ln in f.read().splitlines():
                parts = ln.split()
                n_lines += 1
                lines_ok &= (len(parts) == 16 and parts[0] == "Car"
                             and bool(np.isfinite(np.asarray(
                                 parts[1:], np.float64)).all()))

    timer, plain_timer = phase_timer(log), phase_timer(plain_log)
    needed = ("column_merge", "column_merge_bwd", "merge_taps_bwd",
              "fpn_gather")
    missing = [n for n in needed if launches[n] == 0]
    same_ap = len(evals) == 2 and evals[0] == evals[1]
    ok = (not missing and ckpt_written and len(val_lines) == 1 and same_ap
          and lines_ok and crops_match)
    rec = {"phase": "kitti", "ok": bool(ok),
           "config": f"default Config {KITTI_CFG}, float32; a synthetic "
                     f"KITTI tree of {KITTI_TRAIN} train + {KITTI_VAL} val "
                     f"frames, {cfg.image_size[0]}x{cfg.image_size[1]} PNG "
                     f"images",
           "tree_write_s": write_s, "png_decode_ms": png_ms,
           "crops_match": crops_match, "points_kept": points_kept,
           "gt_database_samples": db_samples,
           "train_seconds": train_s, "launches": launches,
           "missing_kernels": missing, "checkpoint_written": ckpt_written,
           "val_line": val_lines,
           "host_prep_ms_per_frame": {
               "augmented": timer["host_prep"][1],
               "plain": plain_timer["host_prep"][1]},
           "host_wait_ms_per_step": {
               "augmented": timer["host_wait"][1],
               "plain": plain_timer["host_wait"][1]},
           "device_step_ms": {"augmented": timer["device_step"][1],
                              "plain": plain_timer["device_step"][1]},
           "eval_ms_per_frame": timer["eval"][0] * 1e3 / KITTI_VAL,
           "loop_phases": timer,
           "ap": evals[0] if evals else None,
           "evaluate_equals_loop": same_ap,
           "detect_files": len(os.listdir(out_dir)),
           "detect_lines": n_lines, "detect_lines_parse": bool(lines_ok)}
    emit(rec)
    check(ok, "kitti phase failed: see its record")
    shutil.rmtree(work)            # the tree and two epochs of checkpoints
    return rec


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
    from mvxnet_makise_tpu_torch.ops import (
        column_merge,
        cuda_build,
        gather,
        scatter_grid,
    )
    from mvxnet_makise_tpu_torch.serve import Detector

    device = torch.device("cuda", 0)
    serving = [column_merge.KERNEL, gather.KERNEL]
    kernels = [*column_merge.KERNELS, gather.KERNEL, *scatter_grid.KERNELS]
    t0 = time.perf_counter()
    info = cuda_build.build_all(kernels)
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0, "kernels": info})
    # the numpy fallback shuffles points in another order, which changes
    # detections: every number below is the C++ feed's
    check(native.available(), "the C++ host feed (csrc/pointcloud.cpp) "
          "did not build")

    cfg = Config()
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=device)
    try:
        t0 = time.perf_counter()
        det.warm((BATCH,))
        emit({"phase": "warm", "seconds": time.perf_counter() - t0})
        frames = make_frames(cfg, FRAMES, seed=0)
        merge_args, gather_args, scatter_args = kernel_inputs(
            det, frames[:BATCH])
        recs = [phase_column_merge(merge_args, cfg.voxel_shape),
                phase_column_merge_bwd(merge_args, cfg.voxel_shape),
                *phase_merge_taps(merge_args, cfg.voxel_shape),
                phase_fpn_gather(gather_args, cfg.eps,
                                 cfg.compat_swapped_bilerp),
                *phase_scatter_grid(scatter_args, cfg.voxel_shape)]
        del merge_args, gather_args, scatter_args
        torch.cuda.empty_cache()
        drive = phase_detector(det, frames, BATCH, serving)
        phase_profile(det, frames, BATCH)
    finally:
        det.close()
    del det
    torch.cuda.empty_cache()
    phase_reference(device)
    # training runs as tools.train runs it, under PyTorch's default cuDNN
    # choice: the detector set cudnn.deterministic process-wide
    torch.backends.cudnn.deterministic = False
    trained = phase_train(device, kernels)
    dense = phase_train_dense3d(device, kernels)
    phase_train_reference(device)
    kitti = phase_kitti(kernels)

    cm, pm = ("mvxnet_makise_tpu_torch/csrc/column_merge.cu",
              "mvxnet_makise_tpu/ops/pallas_column_merge.py")
    sg = "mvxnet_makise_tpu_torch/csrc/scatter_grid.cu"
    # name: (source, TPU kernel replaced, run whose launches count)
    table = {
        "column_merge": (cm, f"{pm}:469", "serve", drive),
        "column_merge_bwd": (cm, f"{pm}:494", "train", trained),
        "merge_taps": (cm, f"{pm}:202", None, None),
        "merge_taps_bwd": (cm, f"{pm}:229", "train", trained),
        "fpn_gather": ("mvxnet_makise_tpu_torch/csrc/fpn_gather.cu",
                       "mvxnet_makise_tpu/ops/pallas_gather.py:162",
                       "serve", drive),
        "scatter_grid": (sg, "mvxnet_makise_tpu/ops/pallas_scatter.py:80",
                         "train_dense3d", dense),
        "scatter_grid_bwd": (sg, "mvxnet_makise_tpu/models/voxelnet.py:268",
                             "train_dense3d", dense)}
    line = []
    for r in recs:
        source, replaces, path, run = table[r["name"]]
        line.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": run["launches"][r["name"]] if run else 0,
            "path": path or "none: K3 runs on no model path; its phase "
                            "launches it",
            "kitti_launches": kitti["launches"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": line})
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
