#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mvxnet_makise_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``build``: compiles every CUDA kernel of the port from
   ``mvxnet_makise_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together) and reports seconds, the command and ``ptxas`` register use.
2. ``kernel``: one phase per kernel, forward and backward.  Inputs are
   caught inside the Detector's forward of synthetic frames at the full
   default ``Config`` (and, for K4, the CML's voxel rows); each kernel's
   wrapper is held against its plain PyTorch version (for a backward:
   autograd through the plain version) on the same inputs, with the tolerance
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

10. ``reference_bf16`` (after ``reference``): the small configuration
    under ``use_bf16``, the card's bfloat16 maps held to 2x the CPU's own
    bfloat16 distance from a float64 run (floor 1e-2); the LiDAR-only
    model's maps float32.
11. ``full_fusion``: ``configs/full_fusion.yaml`` as written (bfloat16,
    remat, batch 4, 32768 points) on the ``kitti`` tree: ``tools.train``
    for one epoch with the paste augmentation and the val AP (kernel
    counts set to 0 just before; K1 launches twice per step under remat),
    ``tools.evaluate`` (the loop's AP) and ``tools.detect``; then
    FIXED_STEPS steps on one fixed batch (the loss falls, every float32
    master gets a finite nonzero gradient, the extractor stays
    bit-unchanged), the step split and profile, one step without remat
    (its peak memory above remat's), and ``detect_stream`` from the
    checkpoint (bfloat16 maps).
12. ``lidar_only``: ``configs/lidar_only.yaml`` with ``--lidar-only``
    through the three tools and ``detect_stream``: float32 maps, K1 and
    its backward on the path, K2 not.
13. ``shipped_configs``: ``configs/serving_economy.yaml`` serves 16
    frames through ``detect_stream`` at its batch 8;
    ``configs/multiclass.yaml`` takes two train steps.
14. ``weights``: a seeded model exported to the reference's layout and
    imported back (fused and LiDAR-only): the state dicts and the
    detections on the card bit-identical; ``tools.train`` for one epoch
    on the kitti tree with ``--image-weights`` (a seed-1 extractor in
    torchvision's layout): the trained extractor bit-equal to the
    imported weights, K1, K1's backward and K2 launched;
    ``Detector.set_params`` from seed-0 to seed-1 weights, in float32 and
    under ``configs/full_fusion.yaml``: maps and detections equal to a
    fresh Detector's on the seed-1 weights (and the maps changed);
    ``tools.export_checkpoint`` of that epoch reads back through
    ``import_reference_checkpoint`` bit-identically.
15. ``gen_experiment``: ``tools.gen_experiment.run`` at world 32, pool
    128, batch 4, LiDAR-only, the reference trunk and loss, GEN_STEPS
    steps (about two minutes of the card) with an eval halfway and at
    the end: the mean loss of the last 10 % of steps below the first
    10 %'s, two well-formed record lines with ``best.per_class_max``, K1
    and its backward launched; AP@0.5 and 0.7, recall and steps/s are
    recorded, not gated (single-seed AP at this size is noisy).
16. ``bench``: ``python -m mvxnet_makise_tpu_torch.tools.bench`` as a
    subprocess in its default mode (end-to-end detection),
    ``--raw-only``, ``--train``, ``--lidar-only`` and ``--config
    configs/serving_economy.yaml``, at BENCH_ITERS iterations: each exits
    0 with a last line whose ``value`` is positive; with ``--rpn
    no-such-trunk`` it must exit nonzero.

The kernel phases run each kernel in float32 and, for K1, K1's backward,
K3, K3's backward and K2, again in bfloat16 (``*_bf16`` records) on the
arguments ``configs/full_fusion.yaml``'s Detector hands them (batch 4,
32768 points), caught inside its forward on the bfloat16 copies it
computes with; K2 in bfloat16 is also held to the float32 sum of its own
formula, one bfloat16 step per value.  K1's records take a seeded nonzero
bias and hold the output bit-equal to the float32 sum rounded once
(``merge_reference``); K1's backward records also time its first pass
(pre and dbias) and K3's gather of pre apart, each beside its own bound.
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
#   In bfloat16: K1 adds the bias to its float32 tap sum and rounds once,
#   as the Pallas kernel does; it is held to the plain version's
#   accumulate=float32 option, which does the same (the default rounds the
#   sum before the bias, as JAX's XLA reference does): the output exactly,
#   the row statistics as float32 sums in another order (1e-5).  Both K1
#   records take a bias drawn from a seeded generator (the model's is zero
#   at initialization, which would hide a tap added twice or in another
#   order under the ReLU's constant).  K1's backward is held to
#   _merge_fused_bwd's formula on the kernel's own output (a cell near 0
#   may flip the ReLU between kernel and plain version): dy may round one
#   bfloat16 step apart (measured 0), dbias is a float32 sum in another
#   order (measured 1.4e-7; 1e-5 as a float32 sum of this size).  K3 sums
#   the same taps in the same order as the plain version and rounds once:
#   exact, like its backward.  K2 sums in float32 and rounds once where
#   the plain version rounds each of its 11 products and sums (2^-5 of the
#   largest level value); against the float32 sum of its own formula
#   (fpn_gather_plain(accumulate=float32)) it must sit within one
#   bfloat16 step of each value, plus 2^-20 of the largest level value
#   for float32 summation order (K2_BF16_SLACK).
TOL = {"column_merge": {"out": 1e-6, "stats": 1e-5},
       "column_merge_bwd": {"dy": 1e-5, "dbias": 1e-4},
       "merge_taps": {"out": 1e-6},
       "merge_taps_bwd": {"dy": 0.0},
       "scatter_grid": {"grid": 0.0},
       "scatter_grid_bwd": {"d": 0.0},
       "fpn_gather": {"out": 1e-5},
       "column_merge_bf16": {"out": 0.0, "stats": 1e-5},
       "column_merge_bwd_bf16": {"dy": 2 ** -8, "dbias": 1e-5},
       "merge_taps_bf16": {"out": 0.0},
       "merge_taps_bwd_bf16": {"dy": 0.0},
       "fpn_gather_bf16": {"out": 2 ** -5, "bf16_steps_vs_float32_sum": 1}}
K2_BF16_SLACK = 2 ** -20
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
# fields appended to every shipped configuration the smoke runs (none on
# the card: the configurations run as written; a CPU rehearsal cuts them
# to a tiny grid here)
CONFIG_OVERRIDES = {}
# the gen_experiment phase: GEN_STEPS steps on a GEN_POOL-frame pool
GEN_STEPS = 1200
GEN_POOL = 128
# the bench phase: timed iterations per run, the supervisor's cap per
# attempt (s), and arguments appended to every run (none on the card)
BENCH_ITERS = 3
BENCH_ATTEMPT_S = 300
BENCH_ARGS = []
BENCH_RUNS = {"e2e": [], "raw_only": ["--raw-only"], "train": ["--train"],
              "lidar_only": ["--lidar-only"],
              "serving_economy": ["--config",
                                  "configs/serving_economy.yaml"]}


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
    """The arguments the serving path hands K1 and K2 for ``frames``, and
    the voxel rows the dense-3D CML hands K4 (CML conv1's inputs), caught
    inside ``det.maps``: forward pre-hooks on conv1 and the image head
    compute each kernel's arguments from the module's own inputs, so under
    ``use_bf16`` they come from the bfloat16 copies the path computes
    with."""
    import torch

    from mvxnet_makise_tpu_torch.models.image_head import gather_image_size

    caught = {}

    def at_conv1(conv1, args):
        caught["merge"] = tuple(conv1.merge_inputs(*args))
        caught["scatter"] = tuple(args)

    def at_head(head, args):
        images, points_rc, point_mask = args[:3]
        caught["gather"] = (head.pyramid(images), points_rc.contiguous(),
                            point_mask.contiguous(),
                            gather_image_size(head.image_size,
                                              head.image_min_side))

    model = det.model
    hooks = [model.backbone.cml.conv1.register_forward_pre_hook(at_conv1),
             model.head.register_forward_pre_hook(at_head)]
    try:
        with torch.no_grad():
            det.maps(*det.assemble(frames))
    finally:
        for h in hooks:
            h.remove()
    return caught["merge"], caught["gather"], caught["scatter"]


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


def seeded_bias(y, seed: int = 2):
    """A nonzero float32 bias for K1's lanes, from a seeded generator (the
    model's conv1 bias is zero at initialization)."""
    import torch

    gen = torch.Generator(device=y.device).manual_seed(seed)
    return torch.randn(y.shape[-1], generator=gen, device=y.device) * 0.1


def merge_reference(y, col_cy, bounds, bias, grid_shape):
    """K1's plain version as the kernel computes it: in bfloat16 the float32
    tap sum plus the bias, rounded once (``accumulate=torch.float32``); in
    float32 the default, the same function."""
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    acc = torch.float32 if y.dtype == torch.bfloat16 else None
    return cm.merge_taps_fused_plain(y, col_cy, bounds, bias, grid_shape,
                                     accumulate=acc)


def phase_column_merge(merge_args, grid_shape, name="column_merge"):
    """K1 on the path's y, col_cy and bounds with a seeded nonzero bias,
    against ``merge_reference``; the same bits twice."""
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, _ = merge_args
    bias = seeded_bias(y)
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    launches0 = cm.KERNEL.launches
    out, stats = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    check(cm.KERNEL.launches == launches0 + 1, "K1 wrapper did not launch")
    launch = launch_config(cm.KERNEL)
    # the row statistics are summed across threads and blocks in a fixed
    # order: a second call gives the same bits
    out2, stats2 = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    want_out, want_stats = merge_reference(y, col_cy, bounds, bias,
                                           grid_shape)
    torch.cuda.synchronize()
    same_twice = torch.equal(out, out2) and torch.equal(stats, stats2)
    del out2, stats2
    err_out, rel_out = rel_err(out, want_out)
    err_stats, rel_stats = rel_err(stats, want_stats)
    del want_out, want_stats
    tol = TOL[name]
    ok = rel_out <= tol["out"] and rel_stats <= tol["stats"] and same_twice

    dest, buf = merge_index_add(y, col_cy, bounds, grid_shape)
    rows = y.reshape(-1, R)
    times = timings(
        lambda: cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape),
        lambda: merge_reference(y, col_cy, bounds, bias, grid_shape),
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
    rec = {"phase": "kernel", "name": name, "ok": ok,
           "shapes": {"y": list(y.shape), "dtype": str(y.dtype),
                      "out": list(out.shape), "live_columns": live},
           "launch": launch, "bias": "seeded nonzero (seeded_bias)",
           "reference": "merge_taps_fused_plain(accumulate=float32)"
           if y.dtype == torch.bfloat16 else "merge_taps_fused_plain",
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


def phase_column_merge_bwd(merge_args, grid_shape, name="column_merge_bwd"):
    """K1's backward: the first pass (pre and dbias kernels), then K3's
    backward gather of pre, against autograd through K1's plain version
    on the same out, g_out and g_stats (float32), or, in bfloat16, against
    ``_merge_fused_bwd``'s formula on the kernel's own output with dy by
    autograd through the plain merge (TOL).  The pair and each of its two
    parts are timed, each beside its own bound; the first pass must give
    the same bits twice."""
    import torch

    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    y, col_cy, bounds, bias = merge_args
    nx, ny = grid_shape[0], grid_shape[1]
    B, V, _, R = y.shape
    gen = torch.Generator(device=y.device).manual_seed(0)
    out, stats = cm.merge_taps_fused(y, col_cy, bounds, bias, grid_shape)
    g_out = torch.randn(out.shape, generator=gen, device=y.device
                        ).to(y.dtype)
    g_stats = torch.randn(stats.shape, generator=gen, device=y.device) * 0.1
    before = (cm.BWD_KERNEL.launches, cm.TAPS_BWD_KERNEL.launches)
    dy, dbias = cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                             bounds, V, grid_shape)
    check((cm.BWD_KERNEL.launches, cm.TAPS_BWD_KERNEL.launches)
          == (before[0] + 1, before[1] + 1),
          "K1's backward wrapper did not launch its kernels")
    launch = launch_config(cm.BWD_KERNEL, cm.TAPS_BWD_KERNEL)
    dy2, dbias2 = cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                               bounds, V, grid_shape)
    pre, pre_dbias = cm.merge_fused_pre(out, g_out, g_stats)
    pre2, pre_dbias2 = cm.merge_fused_pre(out, g_out, g_stats)
    yp = y.detach().requires_grad_()
    bp = bias.detach().requires_grad_()
    if y.dtype == torch.float32:
        want_out, want_stats = cm.merge_taps_fused_plain(yp, col_cy, bounds,
                                                         bp, grid_shape)
        outs, ins, grads = (want_out, want_stats), (yp, bp), (g_out,
                                                              g_stats)
    else:
        o = out.float()
        want_pre = ((g_out.float()
                     + g_stats[:, :, 0, None].to(y.dtype).float()
                     + 2 * o * g_stats[:, :, 1, None].to(y.dtype).float())
                    * (o > 0)).to(y.dtype)
        want_out = cm.merge_taps_plain(yp, col_cy, bounds, grid_shape)
        want_stats = want_pre.float().sum((0, 1, 2))
        outs, ins, grads = (want_out,), (yp,), (want_pre,)
    want = torch.autograd.grad(outs, ins, grads, retain_graph=True)
    want_dy = want[0]
    want_dbias = want[1] if y.dtype == torch.float32 else want_stats
    torch.cuda.synchronize()
    same_twice = torch.equal(dy, dy2) and torch.equal(dbias, dbias2)
    pre_same_twice = (torch.equal(pre, pre2)
                      and torch.equal(pre_dbias, pre_dbias2)
                      and torch.equal(pre_dbias, dbias))
    del dy2, dbias2, pre2, pre_dbias2
    err_dy, rel_dy = rel_err(dy, want_dy)
    err_db, rel_db = rel_err(dbias, want_dbias)
    tol = TOL[name]
    ok = (rel_dy <= tol["dy"] and rel_db <= tol["dbias"] and same_twice
          and pre_same_twice)

    times = timings(
        lambda: cm.merge_taps_fused_backward(out, g_out, g_stats, col_cy,
                                             bounds, V, grid_shape),
        lambda: torch.autograd.grad(outs, ins, grads, retain_graph=True))
    del outs, ins, grads, want, want_out, want_stats, want_dy, want_dbias
    first_ms = time_ms(lambda: cm.merge_fused_pre(out, g_out, g_stats))
    gather_ms = time_ms(lambda: cm.merge_taps_backward(pre, col_cy, bounds,
                                                       V, grid_shape))

    es = y.element_size()
    cells = B * nx * ny * R
    # out and g_out read once, g_stats read once, dy and dbias written
    n_bytes = (2 * cells * es + g_stats.numel() * 4 + col_cy.numel() * 4
               + bounds.numel() * 4 + B * V * 9 * R * es + R * 4)
    # per cell: two adds, two multiplies, the ReLU test, the dbias add
    n_ops = 6 * cells
    bound_ms, bound_by = bound_of(n_bytes, n_ops)
    # the first pass alone: out and g_out read, g_stats read, pre and its
    # dbias partials written, dbias written
    _, segments = cm.backward_launch_facts(out, ny)
    first_bytes = (3 * cells * es + g_stats.numel() * 4
                   + B * nx * segments * R * 4 + R * 4)
    first_bound = bound_of(first_bytes, n_ops)
    # the gather alone (K3's backward on pre): dy written, the cells live
    # columns touch read
    dest = merge_dest(col_cy, bounds, grid_shape).reshape(-1)
    touched = int(torch.unique(dest[dest < B * nx * ny]).numel())
    gather_bytes = (B * V * 9 * R * es + touched * R * es
                    + col_cy.numel() * 4 + bounds.numel() * 4)
    gather_bound = bound_of(gather_bytes, 0)
    rec = {"phase": "kernel", "name": name, "ok": ok,
           "shapes": {"out": list(out.shape), "dy": list(dy.shape),
                      "dtype": str(out.dtype)},
           "launch": launch,
           "max_abs_err": err_dy, "max_abs_err_dbias": err_db,
           "rel_err": rel_dy, "rel_err_dbias": rel_db,
           "bit_identical_twice": same_twice, "tolerance": tol, **times,
           "library_call": None, "bytes": n_bytes, "ops": n_ops,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "first_pass": {"ms": first_ms, "bytes": first_bytes,
                          "bound_ms": first_bound[0],
                          "bound_by": first_bound[1],
                          "segments_per_row": segments,
                          "bit_identical_twice": pre_same_twice},
           "gather": {"ms": gather_ms, "bytes": gather_bytes,
                      "bound_ms": gather_bound[0],
                      "bound_by": gather_bound[1],
                      "touched_cells": touched}}
    emit(rec)
    check(ok, f"K1's backward disagrees with autograd of its plain version "
              f"or is not deterministic: {rel_dy}, {rel_db}, {same_twice}, "
              f"{pre_same_twice}")
    return rec


def phase_merge_taps(merge_args, grid_shape, suffix=""):
    """K3 forward (K1's kernel without its epilogue) and backward (the
    windowed gather), each against its plain version; ``suffix`` names
    the dtype's records ("_bf16")."""
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
    tol = TOL["merge_taps" + suffix]
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
    fwd = {"phase": "kernel", "name": "merge_taps" + suffix,
           "ok": rel <= tol["out"],
           "shapes": {"y": list(y.shape), "out": list(out.shape),
                      "live_columns": live},
           "launch": launch_config(cm.TAPS_KERNEL),
           "max_abs_err": err, "rel_err": rel, "tolerance": tol, **times,
           "library_call": "Tensor.index_add_", "bytes": n_bytes,
           "ops": n_ops, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(fwd)
    check(fwd["ok"], f"K3 disagrees with its plain version: {rel}")

    g = torch.randn(out.shape, device=y.device,
                    generator=torch.Generator(device=y.device).manual_seed(1)
                    ).to(y.dtype)
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
    tol = TOL["merge_taps_bwd" + suffix]
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
    bwd = {"phase": "kernel", "name": "merge_taps_bwd" + suffix,
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
        grids.append(g[:, None].to(f.dtype).contiguous())

    def run():
        return [F.grid_sample(f.permute(0, 3, 1, 2), g, mode="bilinear",
                              padding_mode="border", align_corners=True)
                for f, g in zip(features, grids)]
    return run


def bf16_steps(got, want, slack: float) -> float:
    """Largest |got - want| beyond ``slack``, in bfloat16 steps (units in
    the last place) at max(|got|, |want|) of each value."""
    import torch

    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), e - 8)
    return float(((g - w).abs() - slack).clamp(min=0).div(step).max())


def phase_fpn_gather(gather_args, eps, swapped, name="fpn_gather"):
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
    tol = TOL[name]
    steps = None
    if got.dtype == torch.bfloat16:
        # relative to the largest level value (TOL)
        scale = max(float(f.float().abs().max()) for f in feats)
        rel = err / scale
        emulated = ga.fpn_gather_plain(feats, rc, valid, gsize, eps=eps,
                                       swapped_weights=swapped,
                                       accumulate=torch.float32)
        steps = bf16_steps(got, emulated, K2_BF16_SLACK * scale)
        del emulated
    ok = rel <= tol["out"] and (
        steps is None or steps <= tol["bf16_steps_vs_float32_sum"])

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
    es = feats[0].element_size()
    touched = 0
    for f, (_, _, r0, c0, r1, c1) in zip(
            feats, gather_geometry(feats, rc, gsize, eps)):
        _, Hf, Wf, C = f.shape
        base = torch.arange(B, device=rc.device)[:, None] * (Hf * Wf)
        cells = torch.stack([base + r0 * Wf + c0, base + r1 * Wf + c0,
                             base + r0 * Wf + c1, base + r1 * Wf + c1],
                            -1)[valid]
        touched += int(torch.unique(cells).numel()) * C * es
    n_valid = int(valid.sum())
    n_bytes = B * P * ctot * es + rc.numel() * 4 + valid.numel() + touched
    n_ops = n_valid * ctot * 7          # 4 multiplies, 3 adds per value
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S) * 1e3
    rec = {"phase": "kernel", "name": name, "ok": ok,
           "shapes": {"levels": [list(f.shape) for f in feats],
                      "points": list(rc.shape), "valid_points": n_valid,
                      "out": list(got.shape)},
           "swapped_weights": swapped,
           "launch": launch_config(ga.KERNEL),
           "max_abs_err": err, "rel_err": rel,
           "bf16_steps_vs_float32_sum": steps, "tolerance": tol, **times,
           "library_call": "F.grid_sample, one call per level",
           "bytes": n_bytes, "touched_feature_bytes": touched, "ops": n_ops,
           "bound_ms": bound_ms,
           "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                        >= n_ops / F32_FLOP_PER_S else "operations")}
    emit(rec)
    check(ok, f"K2 ({name}) disagrees with its plain version: {rel}, "
              f"{steps} bfloat16 steps from its float32 sum")
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

    with torch.no_grad():
        return [m.cpu().double() for m in det.maps(*arrays)]


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
        # under remat the backward's recompute of the CML stops once it
        # has what the backward needs: a module whose recomputed forward
        # was cut short has no end event, and that part is not counted
        fwd = sum(a.elapsed_time(b) for a, b in rec["f"] if b is not None)
        bwd = (max(start.elapsed_time(e) for e in rec["b1"])
               - min(start.elapsed_time(e) for e in rec["b0"])
               if rec["b0"] and rec["b1"] else None)
        out[name] = {"fwd_ms": fwd, "bwd_ms": bwd}
    return out


def profile_step(run_step) -> dict:
    """Kernel-busy ms, the device's idle share and the top kernels over
    one train step (torch.profiler); and where the host's time goes: the
    operators with the most self CPU time."""
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
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return {"step_wall_ms": wall_ms, "kernel_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_launches": sum(v[1] for v in kernels.values()),
            "top": [{"kernel": k[:100], "device_ms": v[0], "calls": v[1]}
                    for k, v in top[:15]],
            "host_top": [{"op": e.key[:80],
                          "self_cpu_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host[:10]]}


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


class RecordedEvals(list):
    """Within ``with``: every AP dict ``eval.runner.run_eval`` returns (the
    training loop's, then ``tools.evaluate``'s), in order."""

    def __enter__(self):
        from mvxnet_makise_tpu_torch.eval import runner

        self._run_eval = run_eval = runner.run_eval

        def recorded(*args, **kw):
            self.append(run_eval(*args, **kw))
            return self[-1]
        runner.run_eval = recorded
        return self

    def __exit__(self, *exc):
        from mvxnet_makise_tpu_torch.eval import runner

        runner.run_eval = self._run_eval
        return False


def parse_results(out_dir, fids, classes=("Car",)) -> tuple:
    """(every result file there and parseable, number of lines):
    ``tools.detect``'s KITTI lines for ``fids``."""
    import numpy as np

    ok, n_lines = True, 0
    for fid in fids:
        path = os.path.join(out_dir, f"{fid}.txt")
        if not os.path.exists(path):
            ok = False
            continue
        with open(path) as f:
            for ln in f.read().splitlines():
                parts = ln.split()
                n_lines += 1
                ok &= (len(parts) == 16 and parts[0] in classes
                       and bool(np.isfinite(np.asarray(
                           parts[1:], np.float64)).all()))
    return bool(ok), n_lines


def phase_kitti(kernels):
    """The dataset path through the tools (module docstring, phase 9).
    Returns (record, the working directory, the tree's root, the frame
    ids); the caller removes the directory."""
    import glob
    import pickle
    import tempfile

    import numpy as np

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.data.image_io import read_png
    from mvxnet_makise_tpu_torch.data.synthetic import write_kitti_tree
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
    with RecordedEvals() as evals:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        log = run_tool(train_cli.main, [root, "-n", "1", "--batch-size",
                                        str(BATCH), "--eval-every", "1",
                                        "--config", cfg_path, *dev])
        train_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        run_tool(evaluate.main, [root, "-r", "1", "--config", cfg_path, *dev])
    plain_log = run_tool(train_cli.main, [root, "-n", "1", "--batch-size",
                                          str(BATCH), "--no-augment",
                                          "--config", configs["plain"], *dev])
    ckpt_written = os.path.exists(os.path.join(work, "ckpt_augment",
                                               "epoch1"))
    val_lines = [ln for ln in log.splitlines() if " val Car: AP=" in ln]

    out_dir = os.path.join(work, "results")
    run_tool(detect.main, [root, "-o", out_dir, "-r", "1", "--batch",
                           str(BATCH), "--config", cfg_path, *dev])
    lines_ok, n_lines = parse_results(out_dir, ids[KITTI_TRAIN:])

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
    return rec, work, root, ids


# ------------------------------------------------------------- shipped configs


def config_yaml(work, name, **extra) -> str:
    """``configs/<name>.yaml`` as written, with CONFIG_OVERRIDES and
    ``extra`` fields appended (a checkpoint directory of the phase's own),
    copied into ``work``."""
    with open(os.path.join(ROOT, "configs", name + ".yaml")) as f:
        text = f.read()
    path = os.path.join(work, name + ".yaml")
    fields = {**CONFIG_OVERRIDES, **extra}
    with open(path, "w") as f:
        f.write(text + "\n" + "".join(
            f"{k}: {list(v) if isinstance(v, tuple) else v}\n"
            for k, v in fields.items()))
    return path


def serve_stream(det, frames, batch_size, kernels) -> dict:
    """``detect_stream`` over ``frames`` after a warm batch, with every
    kernel's count set to 0 just before: ms per frame, detections per
    frame, launches, peak device memory."""
    import torch

    det.warm((batch_size,))
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streamed = list(det.detect_stream(frames, batch_size=batch_size))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    check(len(streamed) == len(frames), "detect_stream lost frames")
    return {"detect_stream_ms_per_frame": ms, "frames": len(frames),
            "batch_size": batch_size,
            "detections_per_frame": check_detections(streamed, det.cfg),
            "launches": {k.name: k.launches for k in kernels},
            "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}


def tools_chain(root, val_ids, cfg_path, kernels, extra=()) -> dict:
    """``tools.train`` for one epoch with the val AP (the GT-paste
    augmentation: the tree has its database), ``tools.evaluate`` and
    ``tools.detect`` on the card, with ``extra`` options; the kernels'
    counts are set to 0 just before the training and read just after."""
    import torch

    from mvxnet_makise_tpu_torch.tools import detect, evaluate
    from mvxnet_makise_tpu_torch.tools import train as train_cli

    dev = ["--config", cfg_path, "--device", KITTI_DEVICE, *extra]
    # training runs under PyTorch's default cuDNN choice, as tools.train
    # runs it alone (a Detector sets cudnn.deterministic process-wide)
    torch.backends.cudnn.deterministic = False
    with RecordedEvals() as evals:
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        log = run_tool(train_cli.main, [root, "-n", "1", "--eval-every",
                                        "1", *dev])
        train_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 2**20
        run_tool(evaluate.main, [root, "-r", "1", *dev])
    out_dir = os.path.splitext(cfg_path)[0] + "_results"
    run_tool(detect.main, [root, "-o", out_dir, "-r", "1", *dev])
    lines_ok, n_lines = parse_results(out_dir, val_ids)
    return {"train_seconds": train_s, "launches": launches,
            "peak_device_mib_epoch": peak,
            "val_line": [ln for ln in log.splitlines()
                         if " val Car: AP=" in ln],
            "loop_phases": phase_timer(log),
            "ap": evals[0] if evals else None,
            "evaluate_equals_loop": len(evals) == 2 and evals[0] == evals[1],
            "detect_lines": n_lines, "detect_lines_parse": lines_ok}


def phase_full_fusion(device, kernels, work, root, val_ids):
    """``configs/full_fusion.yaml`` as written (bfloat16, remat, batch 4,
    32768 points): the tools on the kitti tree, FIXED_STEPS steps on one
    fixed batch, one step without remat, ``detect_stream``."""
    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.ops import column_merge
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.serve import Detector
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    path = config_yaml(work, "full_fusion",
                       checkpoint_dir=os.path.join(work, "ckpt_ff"))
    cfg = load_config(path)
    check(cfg.use_bf16 and cfg.remat and cfg.batch_size == 4
          and cfg.max_points == 32768, f"full_fusion.yaml reads {cfg}")
    chain = tools_chain(root, val_ids, path, kernels)
    needed = ("column_merge", "column_merge_bwd", "merge_taps_bwd",
              "fpn_gather")
    missing = [n for n in needed if chain["launches"][n] == 0]
    steps = KITTI_TRAIN // cfg.batch_size
    # remat: K1 runs again when the backward recomputes the CML; one
    # more launch per eval batch
    k1_expected = 2 * steps + -(-KITTI_VAL // min(cfg.batch_size, 4))

    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(device)
    frames = make_train_frames(cfg, cfg.batch_size, seed=3)
    batch = fixed_batch(cfg, frames, device)
    step = make_full_train_step(cfg, anchors)
    model, st = build_model_and_state(cfg, device=device, seed=0)
    extractor = {k: v.clone()
                 for k, v in model.head.extractor.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    first, _ = timed_steps(step, st, batch, 1)
    bad = bad_gradients(model)
    masters_f32 = all(p.dtype == torch.float32 and (
        p.grad is None or p.grad.dtype == torch.float32)
        for p in model.parameters())
    column_merge.KERNEL.launches = 0
    losses, times = timed_steps(step, st, batch, FIXED_STEPS - 1)
    k1_per_step = column_merge.KERNEL.launches / (FIXED_STEPS - 1)
    losses = first + losses
    peak_remat = torch.cuda.max_memory_allocated() / 2**20
    extractor_unchanged = all(
        torch.equal(v, extractor[k])
        for k, v in model.head.extractor.state_dict().items())
    split = step_split(model, lambda: step(st, *batch))
    prof = profile_step(lambda: step(st, *batch))
    del model, st, extractor
    torch.cuda.empty_cache()
    plain = cfg.replace(remat=False)
    _, st = build_model_and_state(plain, device=device, seed=0)
    torch.cuda.reset_peak_memory_stats()
    column_merge.KERNEL.launches = 0
    _, plain_times = timed_steps(make_full_train_step(plain, anchors), st,
                                 batch, 1)
    k1_plain = column_merge.KERNEL.launches
    peak_plain = torch.cuda.max_memory_allocated() / 2**20
    del st
    torch.cuda.empty_cache()

    det = Detector.create(cfg, checkpoint_epoch=1, device=device)
    served = make_frames(cfg, FRAMES, seed=4)
    with torch.no_grad():
        maps = det.maps(*det.assemble(served[:1]))
    serve = serve_stream(det, served, cfg.batch_size, kernels)
    # the kernels cuDNN picks for the bfloat16 convolutions under
    # cudnn.deterministic (the Detector's setting), by name
    serve["profile"] = profile_step(
        lambda: det.detect_frames(served[:cfg.batch_size]))
    det.close()
    del det
    torch.cuda.empty_cache()

    ok = (not missing and chain["evaluate_equals_loop"]
          and len(chain["val_line"]) == 1 and chain["detect_lines_parse"]
          and chain["launches"]["column_merge"] == k1_expected
          and not bad and masters_f32 and extractor_unchanged
          and np.isfinite(losses).all() and losses[-1] < losses[0]
          and k1_per_step == 2 and k1_plain == 1
          and peak_remat < peak_plain
          and maps[0].dtype == maps[1].dtype == torch.bfloat16
          and serve["launches"]["column_merge"] > 0
          and serve["launches"]["fpn_gather"] > 0)
    rec = {"phase": "full_fusion", "ok": bool(ok),
           "config": "configs/full_fusion.yaml as written (bfloat16, "
                     "remat, batch 4, 32768 points) on the kitti tree",
           **chain, "missing_kernels": missing,
           "k1_launches_expected": k1_expected,
           "params_without_gradient": bad,
           "masters_and_gradients_float32": masters_f32,
           "extractor_unchanged": extractor_unchanged,
           "fixed_batch_losses": losses,
           "ms_per_step": float(np.median(times)), "ms_per_step_all": times,
           "k1_launches_per_step": {"remat": k1_per_step,
                                    "no_remat": k1_plain},
           "peak_device_mib_step": {"remat": peak_remat,
                                    "no_remat": peak_plain},
           "ms_per_step_no_remat": plain_times[0],
           "split_device_ms": split, "profile": prof,
           "map_dtypes": [str(m.dtype) for m in maps],
           "serve": serve}
    emit(rec)
    check(ok, "full_fusion phase failed: see its record")
    return rec


def phase_lidar_only(device, kernels, work, root, val_ids):
    """``configs/lidar_only.yaml`` with ``--lidar-only`` through the tools,
    then ``detect_stream``: float32 maps (JAX promotes the bfloat16
    parameters against the float32 point features), K1 and its backward
    on the path, K2 not."""
    import torch

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.serve import Detector

    path = config_yaml(work, "lidar_only",
                       checkpoint_dir=os.path.join(work, "ckpt_lidar"))
    cfg = load_config(path)
    check(cfg.use_bf16, "lidar_only.yaml does not set use_bf16")
    chain = tools_chain(root, val_ids, path, kernels, ["--lidar-only"])
    needed = ("column_merge", "column_merge_bwd", "merge_taps_bwd")
    missing = [n for n in needed if chain["launches"][n] == 0]
    det = Detector.create(cfg, checkpoint_epoch=1, device=device,
                          with_images=False)
    frames = make_frames(cfg, FRAMES, seed=6)
    with torch.no_grad():
        maps = det.maps(*det.assemble(frames[:1]))
    serve = serve_stream(det, frames, cfg.batch_size, kernels)
    det.close()
    del det
    torch.cuda.empty_cache()
    ok = (not missing and chain["launches"]["fpn_gather"] == 0
          and chain["evaluate_equals_loop"] and len(chain["val_line"]) == 1
          and chain["detect_lines_parse"]
          and maps[0].dtype == maps[1].dtype == torch.float32
          and serve["launches"]["column_merge"] > 0)
    rec = {"phase": "lidar_only", "ok": bool(ok),
           "config": "configs/lidar_only.yaml as written (bfloat16 "
                     "parameters, float32 compute) with --lidar-only",
           **chain, "missing_kernels": missing,
           "map_dtypes": [str(m.dtype) for m in maps], "serve": serve}
    emit(rec)
    check(ok, "lidar_only phase failed: see its record")
    return rec


def phase_shipped_configs(device, kernels, work):
    """``configs/serving_economy.yaml`` (half RPN trunk, image_min_side
    400, batch 8): one ``detect_stream`` of 2 * its batch;
    ``configs/multiclass.yaml``: two train steps on multi-class frames."""
    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.data.synthetic import (
        synthetic_frame_multiclass,
    )
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.serve import Detector
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    econ = load_config(config_yaml(work, "serving_economy"))
    det = Detector.create(econ, checkpoint_epoch=0, seed=0, device=device)
    serve = serve_stream(det, make_frames(econ, 2 * econ.batch_size,
                                          seed=7),
                         econ.batch_size, kernels)
    det.close()
    del det
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    multi = load_config(config_yaml(
        work, "multiclass", checkpoint_dir=os.path.join(work, "ckpt_mc")))
    rng = np.random.default_rng(8)
    frames = []
    for i in range(multi.batch_size):
        pts, calib, image, boxes = synthetic_frame_multiclass(rng, multi)
        frames.append(KittiFrame(f"mc{i}", pts, image, calib, boxes))
    anchors = torch.from_numpy(create_anchors(
        multi.feature_map_shape, multi.velo_range,
        multi.anchor_sizes)).to(device)
    model, st = build_model_and_state(multi, device=device, seed=0)
    batch = fixed_batch(multi, frames, device)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = timed_steps(make_full_train_step(multi, anchors), st,
                                batch, 2)
    launches = {k.name: k.launches for k in kernels}
    bad = bad_gradients(model)
    peak = torch.cuda.max_memory_allocated() / 2**20
    del model, st
    torch.cuda.empty_cache()
    ok = (serve["launches"]["column_merge"] > 0
          and serve["launches"]["fpn_gather"] > 0
          and np.isfinite(losses).all() and not bad
          and launches["column_merge"] == 4
          and launches["column_merge_bwd"] == 2)
    rec = {"phase": "shipped_configs", "ok": bool(ok),
           "serving_economy": {"config": "configs/serving_economy.yaml as "
                                         "written (bfloat16)", **serve},
           "multiclass": {"config": "configs/multiclass.yaml as written "
                                    "(bfloat16, remat, 3 classes)",
                          "losses": losses, "ms_per_step_all": times,
                          "launches": launches,
                          "params_without_gradient": bad,
                          "peak_device_mib": peak}}
    emit(rec)
    check(ok, "shipped_configs phase failed: see its record")
    return rec


# ------------------------------------------------------------- weights


def same_state(a, b) -> bool:
    """Two state dicts with the same keys and bit-identical tensors."""
    import torch

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu())
        for k in a)


def same_maps(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_weights(device, kernels, work, root):
    """Weights to and from the reference layout (module docstring, phase
    14): the export/import round trip, ``tools.train --image-weights``,
    ``Detector.set_params`` and ``tools.export_checkpoint``."""
    import torch

    from mvxnet_makise_tpu_torch.config import Config, load_config
    from mvxnet_makise_tpu_torch.models.import_reference import (
        export_reference_checkpoint,
        import_reference_checkpoint,
    )
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.models.resnet_fpn import (
        load_torchvision_fpn_weights,
    )
    from mvxnet_makise_tpu_torch.serve import Detector
    from mvxnet_makise_tpu_torch.tools import export_checkpoint
    from mvxnet_makise_tpu_torch.tools import train as train_cli
    from mvxnet_makise_tpu_torch.train import checkpoint as ckpt

    cfg = Config(**KITTI_CFG)
    frames = make_frames(cfg, BATCH, seed=9)
    round_trip = {}
    for name, with_images in (("fused", True), ("lidar_only", False)):
        det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=device,
                              with_images=with_images)
        mine = {k: v.cpu() for k, v in det.model.state_dict().items()}
        ref = export_reference_checkpoint(mine, with_images)
        back = import_reference_checkpoint(ref, with_images)
        again = Detector.create(cfg, state_dict=back, device=device,
                                with_images=with_images)
        got, want = again.detect_frames(frames), det.detect_frames(frames)
        round_trip[name] = {
            "reference_tensors": len(ref),
            "state_dict_equal": same_state(mine, back),
            "detections_equal": same_detections(got, want),
            "detections_per_frame": check_detections(got, cfg)}
        det.close()
        again.close()
        del det, again

    # --image-weights: the extractor of a seed-1 model, exported in
    # torchvision's layout (``backbone.body...``, ``backbone.fpn...``)
    ref1 = export_reference_checkpoint(
        build_model(cfg, seed=1, device="cpu").state_dict())
    tv = {k.removeprefix("head.extractor."): v for k, v in ref1.items()
          if k.startswith("head.extractor.backbone.")}
    pth = os.path.join(work, "image_weights.pth")
    torch.save(tv, pth)
    ckpt_dir = os.path.join(work, "ckpt_weights")
    cfg_path = os.path.join(work, "weights.yaml")
    with open(cfg_path, "w") as f:
        for k, v in dict(KITTI_CFG, checkpoint_dir=ckpt_dir).items():
            f.write(f"{k}: {list(v) if isinstance(v, tuple) else v}\n")
    torch.backends.cudnn.deterministic = False
    for k in kernels:
        k.launches = 0
    run_tool(train_cli.main, [root, "-n", "1", "--no-augment", "--config",
                              cfg_path, "--device", KITTI_DEVICE,
                              "--image-weights", pth])
    launches = {k.name: k.launches for k in kernels}
    trained = ckpt.model_state(ckpt_dir, 1)
    imported = {"head.extractor.backbone." + k: v for k, v in
                load_torchvision_fpn_weights(tv, strict=True).items()}
    extractor_equal = same_state(
        {k: v for k, v in trained.items() if k.startswith("head.extractor.")},
        imported)
    needed = ("column_merge", "column_merge_bwd", "fpn_gather")
    missing = [n for n in needed if launches[n] == 0]

    # set_params: seed 0 -> seed 1, against a fresh detector on seed 1
    swaps = {}
    ff = load_config(config_yaml(work, "full_fusion",
                                 checkpoint_dir=os.path.join(work, "swap")))
    for name, c in (("float32", cfg), ("full_fusion", ff)):
        w1 = build_model(c, seed=1, device="cpu").state_dict()
        fr = make_frames(c, c.batch_size, seed=10)
        det = Detector.create(c, checkpoint_epoch=0, seed=0, device=device)
        arrays = det.assemble(fr)
        before = det.maps(*arrays)
        det.set_params(w1)
        after_maps, after = det.maps(*arrays), det.detect_frames(fr)
        fresh = Detector.create(c, state_dict=w1, device=device)
        want_maps, want = fresh.maps(*arrays), fresh.detect_frames(fr)
        swaps[name] = {"maps_equal_fresh": same_maps(after_maps, want_maps),
                       "maps_changed": not same_maps(before, after_maps),
                       "detections_equal_fresh": same_detections(after,
                                                                 want),
                       "map_dtype": str(after_maps[0].dtype),
                       "detections_per_frame": check_detections(after, c)}
        det.close()
        fresh.close()
        del det, fresh

    out = os.path.join(work, "exported_reference.pkl")
    log = run_tool(export_checkpoint.main, ["-r", "1", "-o", out,
                                            "--checkpoint-dir", ckpt_dir])
    reread = import_reference_checkpoint(torch.load(out, weights_only=True))
    export_equal = same_state(reread, trained)
    torch.cuda.empty_cache()

    ok = (all(r["state_dict_equal"] and r["detections_equal"]
              for r in round_trip.values())
          and extractor_equal and not missing and export_equal
          and all(s["maps_equal_fresh"] and s["maps_changed"]
                  and s["detections_equal_fresh"] for s in swaps.values())
          and swaps["full_fusion"]["map_dtype"] == "torch.bfloat16")
    rec = {"phase": "weights", "ok": bool(ok),
           "config": f"default Config {KITTI_CFG} (float32) and "
                     f"configs/full_fusion.yaml as written",
           "round_trip": round_trip,
           "image_weights": {"extractor_equal_imported": extractor_equal,
                             "launches": launches,
                             "missing_kernels": missing},
           "set_params": swaps,
           "export_checkpoint": {"log": log.strip(),
                                 "reimported_equal": export_equal}}
    emit(rec)
    check(ok, "weights phase failed: see its record")
    return rec


# ------------------------------------------------------------- gen_experiment

# the keys of a gen_experiment record line (the JAX tool's)
GEN_RECORD_KEYS = ("protocol", "final", "steps", "pool", "batch", "world",
                   "classes", "loss", "with_images", "image_min_side", "rpn",
                   "elapsed_s", "backend", "ap50", "recall50", "ap70",
                   "per_class", "best")


def phase_gen_experiment(device, kernels, work):
    """The synthetic protocol (module docstring, phase 15):
    ``tools.gen_experiment.run`` at world 32, pool GEN_POOL, batch 4,
    LiDAR-only, reference trunk and loss, GEN_STEPS steps, an eval halfway
    and at the end."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.tools import gen_experiment

    record = os.path.join(work, "gen_experiment.jsonl")
    half = GEN_STEPS // 2
    # training runs under PyTorch's default cuDNN choice, as the tool runs
    # alone (a Detector sets cudnn.deterministic process-wide)
    torch.backends.cudnn.deterministic = False
    for k in kernels:
        k.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        last = gen_experiment.run(
            GEN_STEPS, GEN_POOL, half, "reference", 1e-3, 4, n_val=32,
            log_every=half, world=32, rpn="reference", record=record,
            device=device)
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    losses = [h["total_loss"] for h in last["history"]]
    n = max(len(losses) // 10, 1)
    first, final = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    with open(record) as f:
        lines = [json.loads(ln) for ln in f]
    well_formed = (
        len(lines) == 2 and [ln["steps"] for ln in lines] == [half, GEN_STEPS]
        and [ln["final"] for ln in lines] == [False, True]
        and all(set(GEN_RECORD_KEYS) <= set(ln)
                and "per_class_max" in ln["best"]
                and ln["backend"] == torch.device(device).type
                for ln in lines))
    missing = [n for n in ("column_merge", "column_merge_bwd")
               if launches[n] == 0]
    ok = (len(losses) == GEN_STEPS and bool(np.isfinite(losses).all())
          and final < first and well_formed and not missing)
    rec = {"phase": "gen_experiment", "ok": bool(ok),
           "config": f"tools.gen_experiment: world 32, pool {GEN_POOL}, "
                     f"batch 4, LiDAR-only, reference RPN trunk and loss, "
                     f"{GEN_STEPS} steps, 32 val frames",
           "seconds": seconds, "steps_per_s": last["steps_per_s"],
           "loss_first_10pct": first, "loss_last_10pct": final,
           "evals": [{k: ln[k] for k in ("steps", "ap50", "ap70",
                                         "recall50", "elapsed_s",
                                         "steps_per_s")} for ln in lines],
           "best": last["best"], "records_well_formed": well_formed,
           "launches": launches, "missing_kernels": missing,
           "log": [ln for ln in log.getvalue().splitlines()
                   if ln.startswith(("step", "  step"))]}
    emit(rec)
    check(ok, "gen_experiment phase failed: see its record")
    return rec


# ------------------------------------------------------------- bench


def phase_bench():
    """``tools.bench`` as a user runs it (module docstring, phase 16): one
    subprocess per mode, each exiting 0 with a last line whose value is
    positive, and one with an unknown trunk that must exit nonzero."""
    import torch

    torch.cuda.empty_cache()
    base = [sys.executable, "-m", "mvxnet_makise_tpu_torch.tools.bench",
            "--iters", str(BENCH_ITERS), "--warmup", "1",
            "--max-seconds", str(BENCH_ATTEMPT_S), *BENCH_ARGS]
    lines, ok = {}, True
    for name, extra in BENCH_RUNS.items():
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=ROOT, capture_output=True,
                              text=True, timeout=3 * BENCH_ATTEMPT_S)
        out = proc.stdout.strip().splitlines()
        try:
            line = json.loads(out[-1]) if out else None
        except json.JSONDecodeError:
            line = None
        good = (proc.returncode == 0 and line is not None
                and line.get("value", 0) > 0)
        ok &= good
        lines[name] = {"rc": proc.returncode, "seconds":
                       time.perf_counter() - t0, "line": line,
                       **({} if good else {"stderr": proc.stderr[-2000:]})}
    bad = subprocess.run(base + ["--rpn", "no-such-trunk"], cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=3 * BENCH_ATTEMPT_S)
    refused = bad.returncode != 0
    rec = {"phase": "bench", "ok": bool(ok and refused),
           "command": " ".join(base[1:]), "runs": lines,
           "unknown_trunk_rc": bad.returncode}
    emit(rec)
    check(ok and refused, "bench phase failed: see its record")
    return rec


def phase_reference_bf16(device):
    """The small configuration under use_bf16: the card's bfloat16 maps
    at most 2x as far from a float64 CPU run of the same weights as the
    CPU's own bfloat16 maps (floor 1e-2 of the largest value; the
    untrained model in bfloat16 is near chaos, see
    tests/test_torch_bf16.py); the LiDAR-only model's maps float32."""
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.serve import Detector

    cfg = Config(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                 voxel_shape=(32, 40, 10), image_size=(64, 96),
                 max_points=1024, max_voxels=256, samples_per_voxel=8,
                 assign_window=6, image_min_side=0, use_bf16=True)
    gpu = Detector.create(cfg, checkpoint_epoch=0, seed=1, device=device)
    weights = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    cpu16 = Detector.create(cfg, state_dict=weights, device="cpu")
    ref = build_model(cfg, seed=None, device="cpu")
    ref.load_state_dict(weights)
    cpu64 = Detector(cfg.replace(use_bf16=False), ref.double())
    frames = make_frames(cfg, 2, seed=1, num_cars=2, num_points=1200)
    arrays = cpu16.assemble(frames)
    want = model_maps(cpu64, arrays)
    errs, dtypes = {}, {}
    for name, det in (("card", gpu), ("cpu_bfloat16", cpu16)):
        with torch.no_grad():
            maps = det.maps(*arrays)
        dtypes[name] = [str(m.dtype) for m in maps]
        errs[name] = {m: rel_err(g.cpu().double(), w)[1]
                      for m, g, w in zip(("score", "reg"), maps, want)}
    lidar = Detector.create(cfg, checkpoint_epoch=0, seed=1, device=device,
                            with_images=False)
    with torch.no_grad():
        lidar_dtypes = [str(m.dtype) for m in lidar.maps(*arrays)]
    for d in (gpu, cpu16, cpu64, lidar):
        d.close()
    ok = (all(errs["card"][m] <= max(2 * errs["cpu_bfloat16"][m], 1e-2)
              for m in ("score", "reg"))
          and dtypes["card"] == ["torch.bfloat16"] * 2
          and lidar_dtypes == ["torch.float32"] * 2)
    emit({"phase": "reference_bf16", "ok": ok,
          "config": "voxel_shape (32, 40, 10), image 64x96, native scale, "
                    "use_bf16", "rel_err_vs_cpu_float64": errs,
          "factor": 2.0, "floor": 1e-2, "map_dtypes": dtypes,
          "lidar_only_map_dtypes": lidar_dtypes})
    check(ok, f"card bfloat16 maps too far from the float64 reference: "
              f"{errs}")


def full_fusion_kernel_inputs(device):
    """The arguments ``configs/full_fusion.yaml``'s Detector (random
    weights, seed 0) hands K1 and K2 on frames of that config (batch 4,
    32768 points), caught inside its forward on the bfloat16 copies it
    computes with (``kernel_inputs``).  Returns (cfg, merge_args,
    gather_args, eps, swapped bilinear weights)."""
    import tempfile

    import torch

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.serve import Detector

    with tempfile.TemporaryDirectory() as work:
        cfg = load_config(config_yaml(work, "full_fusion"))
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=device)
    try:
        merge_args, gather_args, _ = kernel_inputs(
            det, make_frames(cfg, cfg.batch_size, seed=0))
        head = det.model.head
        check(merge_args[0].dtype == gather_args[0][0].dtype
              == torch.bfloat16, "full_fusion.yaml's kernel arguments are "
              "not bfloat16")
        return cfg, merge_args, gather_args, head.eps, head.swapped_bilerp
    finally:
        det.close()


def phase_kernels_bf16(device) -> list:
    """K1, K1's backward, K3, K3's backward and K2 in bfloat16, on the
    arguments the bfloat16 path hands them (``full_fusion_kernel_inputs``)."""
    cfg, merge_args, gather_args, eps, swapped = \
        full_fusion_kernel_inputs(device)
    emit({"phase": "kernel_inputs_bf16",
          "config": "configs/full_fusion.yaml as written, random "
                    "weights (seed 0), batch 4 synthetic frames",
          "y": list(merge_args[0].shape),
          "points": list(gather_args[1].shape)})
    return [phase_column_merge(merge_args, cfg.voxel_shape,
                               "column_merge_bf16"),
            phase_column_merge_bwd(merge_args, cfg.voxel_shape,
                                   "column_merge_bwd_bf16"),
            *phase_merge_taps(merge_args, cfg.voxel_shape, "_bf16"),
            phase_fpn_gather(gather_args, eps, swapped, "fpn_gather_bf16")]


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
    import shutil

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
        recs += phase_kernels_bf16(device)
        torch.cuda.empty_cache()
        drive = phase_detector(det, frames, BATCH, serving)
        phase_profile(det, frames, BATCH)
    finally:
        det.close()
    del det
    torch.cuda.empty_cache()
    phase_reference(device)
    phase_reference_bf16(device)
    # training runs as tools.train runs it, under PyTorch's default cuDNN
    # choice: the detector set cudnn.deterministic process-wide
    torch.backends.cudnn.deterministic = False
    trained = phase_train(device, kernels)
    dense = phase_train_dense3d(device, kernels)
    phase_train_reference(device)
    kitti, work, root, ids = phase_kitti(kernels)
    try:
        val_ids = ids[KITTI_TRAIN:]
        fused = phase_full_fusion(device, kernels, work, root, val_ids)
        lidar = phase_lidar_only(device, kernels, work, root, val_ids)
        phase_shipped_configs(device, kernels, work)
        phase_weights(device, kernels, work, root)
        phase_gen_experiment(device, kernels, work)
    finally:
        shutil.rmtree(work)    # the tree and every phase's checkpoints
    phase_bench()

    cm, pm = ("mvxnet_makise_tpu_torch/csrc/column_merge.cu",
              "mvxnet_makise_tpu/ops/pallas_column_merge.py")
    sg = "mvxnet_makise_tpu_torch/csrc/scatter_grid.cu"
    ga = "mvxnet_makise_tpu_torch/csrc/fpn_gather.cu"
    # name: (source, TPU kernel replaced, run whose launches count); the
    # bfloat16 variants' main path is full_fusion's tools.train
    table = {
        "column_merge": (cm, f"{pm}:469", "serve", drive),
        "column_merge_bwd": (cm, f"{pm}:494", "train", trained),
        "merge_taps": (cm, f"{pm}:202", None, None),
        "merge_taps_bwd": (cm, f"{pm}:229", "train", trained),
        "fpn_gather": (ga, "mvxnet_makise_tpu/ops/pallas_gather.py:162",
                       "serve", drive),
        "column_merge_bf16": (cm, f"{pm}:469", "full_fusion", fused),
        "column_merge_bwd_bf16": (cm, f"{pm}:494", "full_fusion", fused),
        "merge_taps_bf16": (cm, f"{pm}:202", None, None),
        "merge_taps_bwd_bf16": (cm, f"{pm}:229", "full_fusion", fused),
        "fpn_gather_bf16": (ga, "mvxnet_makise_tpu/ops/pallas_gather.py:162",
                            "full_fusion", fused),
        "scatter_grid": (sg, "mvxnet_makise_tpu/ops/pallas_scatter.py:80",
                         "train_dense3d", dense),
        "scatter_grid_bwd": (sg, "mvxnet_makise_tpu/models/voxelnet.py:268",
                             "train_dense3d", dense)}
    line = []
    for r in recs:
        source, replaces, path, run = table[r["name"]]
        # launch counts are the wrapper's, whatever the dtype: the kitti
        # and lidar_only paths compute in float32
        wrapper = r["name"].removesuffix("_bf16")
        f32 = wrapper == r["name"]
        line.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": run["launches"][wrapper] if run else 0,
            "path": path or "none: K3 runs on no model path; its phase "
                            "launches it",
            "kitti_launches": kitti["launches"][wrapper] if f32 else None,
            "lidar_only_launches": (lidar["launches"][wrapper] if f32
                                    else None),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"first_pass_ms": r["first_pass"]["ms"],
                "first_pass_bound_ms": r["first_pass"]["bound_ms"],
                "gather_ms": r["gather"]["ms"],
                "gather_bound_ms": r["gather"]["bound_ms"]}
               if "first_pass" in r else {})})
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
