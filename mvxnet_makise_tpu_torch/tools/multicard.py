"""Every rank of a ('data', 'model') mesh held against one card.

The port's counterpart of ``__graft_entry__.dryrun_multichip``, which
builds a mesh, runs one fused train step of a tiny configuration on it
and checks that the loss is finite.  This tool starts one rank per card
(``torch.distributed.run``, NCCL) and every rank runs
:func:`rank_checks`: each check is a function of this module, and rank 0
prints one JSON line per check with every rank's record.

The checks of the four-card run (:data:`CARD_PLAN`; the default
``Config`` at full width, float32, seed-0 weights):

* ``init``: NCCL, each rank on the card ``LOCAL_RANK`` names;
* ``meshes``: ``make_mesh`` at (W, 1), (W/2, 2) and (1, W): coordinates,
  a collective over each axis's group, ``shard_batch``'s rows,
  ``shard_params``' column-parallel twins and the batch-scope norms'
  ``stats_group``;
* ``collectives``: ``parallel/tensor.py``'s three autograd collectives in
  float32 and bfloat16 over every group (integer values: exact), and the
  batch-scope statistics of ``models/blocks.py`` pooled over the data
  ranks against the whole batch in one process, forward and backward;
* ``serve_data``: ``Detector(mesh=make_mesh((W, 1)))`` serves ``frames``
  frames in batches of ``batch`` through ``detect_frames`` and
  ``detect_stream``; each rank's maps are bit-equal to a meshless
  Detector's on the same card and the same rows (so at (4, 1) each frame
  alone), the gathered detections equal those meshless runs frame by
  frame, and the distance to a meshless run of the whole batch is held to
  the float32 tolerance below;
* ``serve_model``: the (W/2, 2) mesh, whose model axis cuts the layers of
  256 or more output channels (the ResNet's and the RPN's): maps against
  the meshless run of the same rows, to the float32 tolerance;
* ``float64_tiny``: the smoke's small configuration in float64 on the
  card at (W/2, 2) against one rank, to 1e-10: the LiDAR-only model with
  the dense CML (its maps and one step's loss, metrics and gradients)
  and the fused model's image pyramid; K1 and K2 take float32 and
  bfloat16 only, so the fused model cannot run in float64 on the card;
* ``steps``: one ``make_train_step(mesh=...)`` step at (W, 1) in sample
  and batch norm scope and at (W/2, 2) in sample scope, on one global
  batch of 4 frames, against the one-card step on the whole batch: the
  loss, the metrics and every master gradient (a column slice against
  the slice of the whole) to the float32 tolerance, and each parameter
  after the AdamW update to :func:`update_bound`;
* ``nonfinite``: a NaN loss on data rank 1 skips the update on every
  rank;
* ``bf16``: ``configs/full_fusion.yaml`` as written (bfloat16, remat) at
  (W, 1): three steps finite, the first loss within the bfloat16
  tolerance of the one-card step on the same global batch;
* ``jax_case``: ``dryrun_multichip``'s tiny configuration and data (its
  own copy here), one fused step at (W/2, 2), a finite loss;
* ``kernels``: each rank's K1, K1 backward (K3's backward inside it) and
  K2 launch counts over its serving and its step, and one K1 and one K2
  call on its card held against their plain versions;
* ``cost``: in turns (one card, mesh, mesh, one card), medians of
  ``rounds``: ms per frame served at (W, 1) against one card, ms per step
  at (W, 1) with ``batch`` frames per rank against one card at ``batch``
  (weak scaling) and at (W/2, 2) with ``batch`` frames per data rank; a
  ``torch.profiler`` window over one (W, 1) step: NCCL device ms, the
  float32 masters' gradient bytes all-reduced, the device's idle share.

Tolerances.  Float32: ``REF_FACTOR`` (``chip_smoke.py``'s factor) times
the card's own distance between the one-card run and the same run with
its images moved one ulp (:func:`nudge`), floor ``FLOOR``: the untrained
model amplifies last-bit differences (its stateless norms divide
near-constant channels by their tiny spread), and a mesh rounds its sums
in another order than one card; a wrong collective or slice moves the
result by the size of the values.  Float64: ``F64_TOL``.  bfloat16: twice
the distance under a one-ulp bfloat16 nudge, floor ``BF16_FLOOR``
(``chip_smoke.py``'s bfloat16 factor and floor).  Distances are
:func:`rel` (largest absolute difference over max(1, largest value)).

``chip_smoke.py`` runs :data:`WORLD1_PLAN` at world 1 on its one card;
``--device cpu`` runs :data:`CPU_PLAN` (gloo, the tests' tiny float64
configuration).  Imports nothing of JAX.

Run:
    python3 -m mvxnet_makise_tpu_torch.tools.multicard --cards 4 \\
        [--out FILE]
    python3 -m mvxnet_makise_tpu_torch.tools.multicard --cards 2 \\
        --device cpu

With fewer cards than ``--cards`` it starts nothing and exits non-zero.
Rank 0's last line is ``{"ok": ..., "world": W, "checks": {name: ok}}``;
the command exits 0 only when every check passed on every rank.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mvxnet_makise_tpu_torch.config import Config

MODULE = "mvxnet_makise_tpu_torch.tools.multicard"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FULL_FUSION = os.path.join(REPO, "configs", "full_fusion.yaml")

# float32: REF_FACTOR times the card's own distance under a one-ulp
# nudge, floor FLOOR; float64 F64_TOL; bfloat16 BF16_FACTOR times its
# nudge distance, floor BF16_FLOOR
REF_FACTOR = 10.0
FLOOR = 1e-6
F64_TOL = 1e-10
BF16_FACTOR = 2.0
BF16_FLOOR = 1e-2
# float32 gradients of the untrained model are near chaos (a one-ulp
# nudge of the images moves them ~10 % in norm): they are held to twice
# their nudge spread, as the smoke holds bfloat16 maps; a step computed
# in the mesh's shapes differs only by the order of the data ranks' sum
CHAOS_FACTOR = 2.0
SUM_TOL = 1e-6
# kernel against plain version (chip_smoke.py's TOL): K1's output sums
# the same taps in the same order, its row statistics in another order;
# K2 rounds its four weighted taps in another order
KERNEL_TOL = {"column_merge": {"out": 1e-6, "stats": 1e-5},
              "fpn_gather": {"out": 1e-5}}
# the smoke's small configuration (grid 32x40x10, 64x96 images)
TINY = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
            voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
            max_voxels=256, max_boxes=4, samples_per_voxel=8,
            assign_window=6, image_min_side=0)
# __graft_entry__._tiny_config
JAX_TINY = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
                voxel_shape=(16, 16, 10), image_size=(64, 96),
                max_points=256, max_voxels=32, max_boxes=4,
                samples_per_voxel=4, assign_window=4)
# seconds a collective may wait for the other ranks
COLLECTIVE_S = 300


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one run checks: ``fields`` over the default ``Config``, the
    model's ``dtype``, ``frames`` served in batches of ``batch`` (also the
    frames per rank of the timed steps), the ``checks`` in order, the
    global batch of the checked steps and the norm scopes of their (W, 1)
    mesh, and ``rounds`` timed turns per side in ``cost``."""
    fields: dict
    dtype: torch.dtype
    frames: int
    batch: int
    checks: Tuple[str, ...]
    step_frames: int = 4
    scopes: Tuple[str, ...] = ("sample",)
    rounds: int = 0


CARD_PLAN = Plan({}, torch.float32, 16, 4,
                 ("init", "meshes", "collectives", "serve_data",
                  "serve_model", "float64_tiny", "steps", "nonfinite",
                  "bf16", "jax_case", "kernels", "cost"),
                 scopes=("sample", "batch"), rounds=10)
WORLD1_PLAN = Plan({}, torch.float32, 8, 4,
                   ("init", "serve_data", "steps", "kernels", "cost"),
                   rounds=2)
CPU_PLAN = Plan(TINY, torch.float64, 2, 2, ("init", "serve_data", "steps"),
                step_frames=2)


# ------------------------------------------------------------- helpers


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over max(1, largest |want|)."""
    if want.numel() == 0:
        return 0.0
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.bfloat16: torch.int16}


def nudge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and moved one ulp of it away from zero,
    in the finer of the two dtypes: an input the model's arithmetic can
    barely tell apart from ``x``."""
    y = x.to(dtype).contiguous()
    return (y.view(_BITS[dtype]) + 1).view(dtype).to(
        torch.promote_types(x.dtype, dtype))


def same_detections(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.boxes, y.boxes) and np.array_equal(x.scores, y.scores)
        and np.array_equal(x.classes, y.classes) for x, y in zip(a, b))


def make_frames(cfg: Config, n: int, seed: int):
    """``n`` synthetic (points, calib, image, boxes) frames from
    ``seed``."""
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

    rng = np.random.default_rng(seed)
    return [synthetic_frame(rng, cfg, num_points=min(18000, cfg.max_points))
            for _ in range(n)]


def train_batch(cfg: Config, n: int, seed: int, device, dtype):
    """One training ``Batch`` of ``n`` synthetic frames with their cars
    (fixed voxelizer shuffle), points and images in ``dtype``."""
    from mvxnet_makise_tpu_torch.data.kitti import KittiFrame
    from mvxnet_makise_tpu_torch.train.loop import (
        collate,
        preprocess_train_frame,
    )
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    arrays = [preprocess_train_frame(
        KittiFrame(f"synth{i:06d}", pts, image, calib, {"Car": boxes}),
        cfg, None, np.random.default_rng(i))
        for i, (pts, calib, image, boxes) in enumerate(
            make_frames(cfg, n, seed))]
    pts, nums, imgs, gts, gms, gcs = collate(arrays, device)
    gen = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=gen)
                        for _ in range(n)]).to(device)
    return frames_to_batch(pts.to(dtype), nums, imgs.to(dtype), cfg,
                           gt_boxes=gts.to(dtype), gt_mask=gms,
                           gt_classes=gcs, perm=perm)


def take(batch, n: int):
    """The first ``n`` rows of every field of a ``Batch``."""
    return type(batch)(*(None if f is None else f[:n] for f in batch))


def anchors_for(cfg: Config, device, dtype) -> torch.Tensor:
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors

    return torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(
            device, dtype)


def compute_dtype(cfg: Config, dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if cfg.use_bf16 else dtype


def twin_slices(model) -> Dict[str, Tuple[int, int, int]]:
    """Per parameter of a column-parallel twin: (dimension cut, this
    rank's start, width)."""
    from mvxnet_makise_tpu_torch.parallel.tensor import ColumnParallel

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ColumnParallel):
            out[f"{name}.weight"] = (m.OUT_DIM[m.kind], m.rank * m.width,
                                     m.width)
            out[f"{name}.bias"] = (0, m.rank * m.width, m.width)
    return out


def update_bound(p_got, p_want, g_got, g_want, lr: float, eps: float):
    """Whether ``p_got`` and ``p_want``, one AdamW update from the same
    parameters with gradients ``g_got`` and ``g_want``, are as close as
    the update allows: its first step moves an entry by lr * g / (|g| +
    eps), whose slope in g is at most lr / eps and whose range is under
    lr, so two entries may sit lr * min(2, |dg| / eps) apart, plus the
    rounding of the update (4 ulps of the entry and of lr).  Returns
    (holds, largest distance, largest distance over its bound)."""
    ulp = float(torch.finfo(p_want.dtype).eps)
    p_got, p_want = p_got.double(), p_want.double()
    dg = (g_got.double() - g_want.double()).abs()
    bound = lr * torch.clamp(dg / eps, max=2.0) + 4 * ulp * (
        p_want.abs() + lr)
    d = (p_got - p_want).abs()
    if d.numel() == 0:
        return True, 0.0, 0.0
    return bool((d <= bound).all()), float(d.max()), float(
        (d / bound).max())


def nccl_evidence(prof) -> dict:
    """Events of a ``torch.profiler`` window that name NCCL: device
    kernels and host-side collective calls."""
    from torch.autograd import DeviceType

    kernels, calls = set(), set()
    for e in prof.events():
        if "nccl" not in e.name.lower():
            continue
        (kernels if e.device_type == DeviceType.CUDA else calls).add(
            e.name[:80])
    return {"device_kernels": sorted(kernels), "host_calls": sorted(calls)}


def _union_ms(spans) -> float:
    """ms covered by a list of (start, end) microsecond intervals."""
    total, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e3


def device_window(prof, wall_ms: float) -> dict:
    """Device time of a profiler window: ms covered by kernels (NCCL's
    included), by the other kernels alone, the NCCL kernels' own ms (which
    include their wait for the other ranks) and the idle share of
    ``wall_ms``.  User annotations on the device timeline (the
    ``nccl:all_reduce`` range around NCCL's kernel) are not kernels."""
    from torch.autograd import DeviceType

    spans, compute, nccl_ms = [], [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        span = (e.time_range.start, e.time_range.end)
        spans.append(span)
        if "nccl" in e.name.lower():
            nccl_ms += e.time_range.elapsed_us() / 1e3
        else:
            compute.append(span)
    busy_ms = _union_ms(spans)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "compute_busy_ms": _union_ms(compute),
            "nccl_device_ms": nccl_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms)
            if wall_ms else None}


def gpu_lines() -> List[str]:
    """``nvidia-smi``'s name and power limit of every card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]
    return out.stdout.strip().splitlines() if out.returncode == 0 \
        else [f"nvidia-smi failed: {out.stderr.strip()}"]


# ------------------------------------------------------------- context


class Context:
    """One rank's state over a run: the plan, its card, the meshes made
    so far (each shape once: every rank makes the same groups in the same
    order), the seeded model every check copies, and the kernels' launch
    counts of its serving and its step."""

    def __init__(self, plan: Plan, device):
        from mvxnet_makise_tpu_torch.ops import (
            column_merge,
            gather,
            scatter_grid,
        )

        self.plan = plan
        self.device = torch.device(device)
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.cfg = Config(**plan.fields)
        self.kernels = [*column_merge.KERNELS, gather.KERNEL,
                        *scatter_grid.KERNELS]
        self.launches: Dict[str, Dict[str, int]] = {}
        self._meshes: Dict[Tuple[int, int], object] = {}
        self._bases: Dict[str, torch.nn.Module] = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mesh(self, shape: Tuple[int, int]):
        from mvxnet_makise_tpu_torch.parallel import make_mesh

        if shape not in self._meshes:
            self._meshes[shape] = make_mesh(shape)
        return self._meshes[shape]

    def model_shape(self) -> Optional[Tuple[int, int]]:
        """(W/2, 2) for an even world of 4 or more, else None."""
        w = self.world
        return (w // 2, 2) if w >= 4 and w % 2 == 0 else None

    def shapes(self) -> List[Tuple[int, int]]:
        """(W, 1), and with a model shape that and (1, W)."""
        m = self.model_shape()
        return [(self.world, 1)] + ([m, (1, self.world)] if m else [])

    def model(self, cfg: Optional[Config] = None):
        """A fresh copy of the seed-0 model of ``cfg`` (default: the
        plan's) in the plan's dtype, in eval mode."""
        from mvxnet_makise_tpu_torch.models.blocks import set_norm_scope
        from mvxnet_makise_tpu_torch.models.mvxnet import build_model

        cfg = cfg or self.cfg
        # the norm scope and the batch size leave the weights as they are
        key = repr(dataclasses.replace(cfg, norm_scope="sample",
                                       batch_size=1))
        if key not in self._bases:
            self._bases[key] = build_model(cfg, seed=0,
                                           device=self.device).to(
                                               self.plan.dtype)
        return set_norm_scope(copy.deepcopy(self._bases[key]),
                              cfg.norm_scope)

    def detector(self, mesh=None):
        from mvxnet_makise_tpu_torch.serve import Detector

        return Detector(self.cfg, self.model(), mesh=mesh)

    def zero(self) -> None:
        for k in self.kernels:
            k.launches = 0

    def counts(self) -> Dict[str, int]:
        return {k.name: k.launches for k in self.kernels}

    def tolerance(self, nudged: float, dtype: Optional[torch.dtype] = None
                  ) -> float:
        dtype = dtype or self.plan.dtype
        if dtype == torch.float64:
            return F64_TOL
        if dtype == torch.bfloat16:
            return max(BF16_FACTOR * nudged, BF16_FLOOR)
        return max(REF_FACTOR * nudged, FLOOR)

    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def maps_of(det, points, nums, images) -> List[torch.Tensor]:
    with torch.no_grad():
        return [m.detach().clone() for m in det.maps(points, nums, images)]


# ------------------------------------------------------------- checks


def check_init(ctx: Context) -> dict:
    """NCCL on the card ``LOCAL_RANK`` names (gloo on the CPU)."""
    from mvxnet_makise_tpu_torch.parallel.distributed import is_primary

    backend = dist.get_backend()
    local = int(os.environ.get("LOCAL_RANK", ctx.rank))
    rec = {"backend": backend, "world": ctx.world, "rank": ctx.rank,
           "local_rank": local, "primary": is_primary()}
    ok = rec["primary"] == (ctx.rank == 0)
    if ctx.cuda:
        rec["current_card"] = torch.cuda.current_device()
        rec["card"] = torch.cuda.get_device_name(ctx.device)
        ok = ok and backend == "nccl" and rec["current_card"] == local \
            and ctx.device.index in (None, local)
    else:
        ok = ok and backend == "gloo"
    return {"ok": ok, **rec}


def check_meshes(ctx: Context) -> dict:
    """Each mesh shape: coordinates, a sum over each axis's group,
    ``shard_batch``'s rows, ``shard_params``' twins and stats group."""
    from torch import nn

    from mvxnet_makise_tpu_torch.models.blocks import DenseReluNorm
    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.parallel.mesh import axis_index, axis_size
    from mvxnet_makise_tpu_torch.parallel.tensor import ColumnParallel

    out, ok = {}, True
    for shape in ctx.shapes():
        mesh = ctx.mesh(shape)
        D, M = shape
        d, m = axis_index(mesh, "data"), axis_index(mesh, "model")
        sums = {}
        for axis in ("data", "model"):
            t = torch.tensor([float(ctx.rank)], device=ctx.device)
            dist.all_reduce(t, group=mesh.get_group(axis))
            sums[axis] = float(t)
        want = {"data": float(sum(i * M + m for i in range(D))),
                "model": float(sum(d * M + j for j in range(M)))}
        rows = shard_batch(torch.arange(2 * D), mesh).tolist()
        toy = nn.Sequential(nn.Linear(8, 256), DenseReluNorm(256, 16))
        toy[1].batch_stats = True
        shard_params(toy, mesh)
        twin = isinstance(toy[0], ColumnParallel)
        pooled = toy[1].stats_group is not None
        good = (ctx.rank == d * M + m and sums == want
                and axis_size(mesh, "data") == D
                and axis_size(mesh, "model") == M
                and rows == [2 * d, 2 * d + 1] and twin == (M > 1)
                and pooled == (D > 1))
        out[f"{D}x{M}"] = {"ok": good, "coords": [d, m], "sums": sums,
                           "rows": rows, "twin": twin, "pooled": pooled}
        ok = ok and good
    return {"ok": ok, "meshes": out}


def check_collectives(ctx: Context) -> dict:
    """The autograd collectives over every group of every mesh in float32
    and bfloat16 (integer values: exact), then the batch-scope statistics
    pooled over each mesh's data ranks against the whole batch."""
    from mvxnet_makise_tpu_torch.models.blocks import (
        masked_standardize,
        standardize,
    )
    from mvxnet_makise_tpu_torch.parallel import shard_batch
    from mvxnet_makise_tpu_torch.parallel.tensor import (
        all_reduce_sum,
        copy_to_model,
        gather_channels,
    )

    dev, failed = ctx.device, []
    for shape in ctx.shapes():
        mesh = ctx.mesh(shape)
        for axis in ("data", "model"):
            group = mesh.get_group(axis)
            members = dist.get_process_group_ranks(group)
            if len(members) < 2:
                continue
            pos = members.index(ctx.rank)
            total = float(sum(r + 1 for r in members))
            for dtype in (torch.float32, torch.bfloat16):
                name = f"{shape[0]}x{shape[1]} {axis} {dtype}"
                x = torch.full((3, 4), ctx.rank + 1.0, dtype=dtype,
                               device=dev, requires_grad=True)
                y = all_reduce_sum(x, group)
                (y * (ctx.rank + 1.0)).sum().backward()
                if not (bool((y == total).all())
                        and bool((x.grad == total).all())):
                    failed.append(f"all_reduce_sum {name}")
                x.grad = None
                y = copy_to_model(x, group)
                (y * (ctx.rank + 1.0)).sum().backward()
                if not (torch.equal(y, x)
                        and bool((x.grad == total).all())):
                    failed.append(f"copy_to_model {name}")
                x = torch.full((2, 3), ctx.rank + 1.0, dtype=dtype,
                               device=dev, requires_grad=True)
                y = gather_channels(x, 1, group)
                want = torch.cat([torch.full((2, 3), r + 1.0, dtype=dtype,
                                             device=dev) for r in members],
                                 dim=1)
                cot = torch.arange(y.numel(), dtype=dtype,
                                   device=dev).reshape(y.shape)
                (y * cot).sum().backward()
                if not (torch.equal(y, want) and torch.equal(
                        x.grad, cot[:, 3 * pos:3 * pos + 3])):
                    failed.append(f"gather_channels {name}")
    norms = {}
    for shape in ctx.shapes():
        D = shape[0]
        if D < 2:
            continue
        mesh = ctx.mesh(shape)
        group = mesh.get_group("data")
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2 * D, 5, 6, 7, generator=gen).to(dev)
        w = torch.randn(2 * D, 5, 6, 7, generator=gen).to(dev)
        mask = (torch.rand(2 * D, 5, generator=gen) < 0.7).to(dev)
        errs = {}
        for name, fn in (
                ("standardize",
                 lambda t, m, g: standardize(t, dims=(2, 3), batch=True,
                                             group=g)),
                ("masked_standardize",
                 lambda t, m, g: masked_standardize(
                     t.flatten(2), m, batch=True, group=g))):
            xs = x.clone().requires_grad_(True)
            whole = fn(xs, mask, None)
            (whole * w.reshape(whole.shape)).sum().backward()
            xl = shard_batch(x, mesh).clone().requires_grad_(True)
            local = fn(xl, shard_batch(mask, mesh), group)
            (local * shard_batch(w, mesh).reshape(local.shape)).sum() \
                .backward()
            errs[name] = [rel(local, shard_batch(whole, mesh)),
                          rel(xl.grad, shard_batch(xs.grad, mesh))]
        norms[f"{shape[0]}x{shape[1]}"] = errs
        # float32 sums over the batch in another order
        if max(max(v) for v in errs.values()) > 1e-5:
            failed.append(f"pooled statistics {shape}")
    return {"ok": not failed, "failed": failed,
            "pooled_norms_rel_err": norms, "norm_tolerance": 1e-5}


def _serve(ctx: Context, det, frames) -> Tuple[list, list]:
    """``detect_frames`` of each batch and ``detect_stream`` of all."""
    b = ctx.plan.batch
    got = []
    for i in range(0, len(frames), b):
        got += det.detect_frames(frames[i:i + b])
    streamed = list(det.detect_stream(frames, batch_size=b))
    return got, streamed


def check_serve_data(ctx: Context) -> dict:
    """The data-axis mesh Detector against meshless runs of the same rows
    and of the whole batch (module docstring)."""
    from mvxnet_makise_tpu_torch.parallel import shard_batch

    mesh = ctx.mesh((ctx.world, 1))
    frames = [f[:3] for f in make_frames(ctx.cfg, ctx.plan.frames, 0)]
    b = ctx.plan.batch
    plain = ctx.detector()
    det = ctx.detector(mesh=mesh)
    try:
        bit_equal, whole_err, nudged_err, mine = True, 0.0, 0.0, []
        for i in range(0, len(frames), b):
            arrays = det.assemble(frames[i:i + b])
            local = det._local(*arrays)
            got = maps_of(det, *local)
            bit_equal &= all(torch.equal(g, w) for g, w in
                             zip(got, maps_of(plain, *local)))
            whole = maps_of(plain, *arrays)
            rows = shard_batch(whole, mesh)
            whole_err = max([whole_err] + [rel(g, w) for g, w in
                                           zip(got, rows)])
            if ctx.plan.dtype != torch.float64:
                pts, nums, imgs = arrays
                moved = maps_of(plain, pts, nums, nudge(
                    torch.as_tensor(imgs), compute_dtype(ctx.cfg,
                                                         ctx.plan.dtype)))
                nudged_err = max([nudged_err] + [rel(m, w) for m, w in
                                                 zip(moved, whole)])
            mine.append(plain.detect_batch(*local))
        ctx.zero()
        got, streamed = _serve(ctx, det, frames)
        ctx.sync()
        ctx.launches["serve"] = ctx.counts()
    finally:
        det.close()
        plain.close()
    want = [d for batch in zip(*ctx.gather(mine)) for part in batch
            for d in part]
    tol = ctx.tolerance(nudged_err)
    same = same_detections(got, want)
    same_stream = same_detections(streamed, want)
    return {"ok": bit_equal and same and same_stream and whole_err <= tol
            and len(got) == len(frames),
            "mesh": [ctx.world, 1], "frames": len(frames), "batch": b,
            "maps_bit_equal_meshless_same_rows": bit_equal,
            "detections_equal_meshless_same_rows": same,
            "stream_equal_meshless_same_rows": same_stream,
            "maps_vs_meshless_whole_batch": whole_err,
            "nudged_vs_meshless_whole_batch": nudged_err, "tolerance": tol,
            "detections_per_frame": [len(d.scores) for d in got],
            "launches": ctx.launches["serve"]}


def check_serve_model(ctx: Context) -> dict:
    """The (W/2, 2) mesh Detector against the meshless run of the same
    rows."""
    shape = ctx.model_shape()
    mesh = ctx.mesh(shape)
    frames = [f[:3] for f in make_frames(ctx.cfg, ctx.plan.frames, 0)]
    b = ctx.plan.batch
    plain = ctx.detector()
    det = ctx.detector(mesh=mesh)
    try:
        err, nudged_err = 0.0, 0.0
        for i in range(0, len(frames), b):
            pts, nums, imgs = det._local(*det.assemble(frames[i:i + b]))
            got = maps_of(det, pts, nums, imgs)
            want = maps_of(plain, pts, nums, imgs)
            moved = maps_of(plain, pts, nums, nudge(
                torch.as_tensor(imgs), compute_dtype(ctx.cfg,
                                                     ctx.plan.dtype)))
            err = max([err] + [rel(g, w) for g, w in zip(got, want)])
            nudged_err = max([nudged_err] + [rel(m, w) for m, w in
                                             zip(moved, want)])
        got, streamed = _serve(ctx, det, frames)
    finally:
        det.close()
        plain.close()
    tol = ctx.tolerance(nudged_err)
    return {"ok": err <= tol and same_detections(got, streamed)
            and len(got) == len(frames),
            "mesh": list(shape), "maps_vs_meshless_same_rows": err,
            "nudged_vs_meshless_same_rows": nudged_err, "tolerance": tol,
            "stream_equal_frames": same_detections(got, streamed),
            "detections_per_frame": [len(d.scores) for d in got]}


def _grads(model) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _params(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def one_step(ctx: Context, cfg: Config, model, batch, anchors, mesh=None,
             with_images: bool = True, count: bool = False):
    """One train step of a copy of ``model`` (on ``mesh`` when given, on
    this rank's rows): (metrics, gradients, parameters after, the state,
    the model)."""
    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import make_train_step

    model = copy.deepcopy(model).train()
    if mesh is not None:
        shard_params(model, mesh)
        batch = shard_batch(batch, mesh)
    state = TrainState.create(cfg, model)
    step = make_train_step(cfg, anchors, with_images, mesh=mesh)
    if count:
        ctx.zero()
    m = step(state, batch)
    ctx.sync()
    if count:
        ctx.launches["train"] = ctx.counts()
    return ({k: float(v.detach()) for k, v in m.items()}, _grads(model),
            _params(model), state, model)


def compare_steps(ref, got, twins, lr: Optional[float] = None,
                  eps: float = 0.0) -> dict:
    """Distances of a step ``got`` from ``ref`` (each as :func:`one_step`
    returns it, ``ref``'s parameters may be None): the loss and metrics
    (largest relative difference), the gradients (a twin's against the
    slice of the whole): each parameter's :func:`rel` and the relative
    norm of all of them together, and with ``lr`` the AdamW bound on the
    parameters after (:func:`update_bound`)."""
    (m_ref, g_ref, p_ref), (m_got, g_got, p_got) = ref[:3], got[:3]

    def cut(name, t):
        if name not in twins:
            return t
        dim, start, width = twins[name]
        return t.narrow(dim, start, width)

    metrics = max(abs(m_got[k] - m_ref[k]) / max(1.0, abs(m_ref[k]))
                  for k in m_ref)
    grads, worst, diff2, norm2 = 0.0, None, 0.0, 0.0
    for n, g in g_ref.items():
        if n not in g_got:
            grads, worst = float("inf"), n
            continue
        want = cut(n, g).double().cpu()
        d = g_got[n].double().cpu() - want
        diff2 += float((d * d).sum())
        norm2 += float((want * want).sum())
        e = rel(g_got[n], want)
        if e >= grads:
            grads, worst = e, n
    out = {"metrics": metrics, "grads": grads, "worst_grad": worst,
           "grads_rel_norm": (diff2 / norm2) ** 0.5 if norm2 else 0.0,
           "same_keys": g_got.keys() == g_ref.keys()
           and m_got.keys() == m_ref.keys()}
    if lr is not None:
        holds, dist_max, ratio = True, 0.0, 0.0
        for n, p in p_ref.items():
            if n in g_ref:
                h, d, r = update_bound(p_got[n], cut(n, p), g_got[n],
                                       cut(n, g_ref[n]), lr, eps)
            else:
                h = torch.equal(p_got[n], cut(n, p))
                d = r = 0.0 if h else float("inf")
            holds &= h
            dist_max, ratio = max(dist_max, d), max(ratio, r)
        out.update(params_within_update_bound=holds,
                   params_max_abs=dist_max, params_over_bound=ratio)
    return out


def shard_mean(ctx: Context, cfg: Config, model, batch, anchors,
               shards: int):
    """The data-parallel step computed on this card alone: one step of a
    fresh copy per contiguous shard of ``batch``, the metrics and the
    gradients averaged (the parameters after are not formed)."""
    n = batch.points.shape[0] // shards
    runs = [one_step(ctx, cfg, model, type(batch)(*(
        None if f is None else f[i * n:(i + 1) * n] for f in batch)),
        anchors) for i in range(shards)]
    metrics = {k: sum(r[0][k] for r in runs) / shards for k in runs[0][0]}
    grads = {k: sum(r[1][k] for r in runs) / shards for k in runs[0][1]}
    return metrics, grads, None


def check_steps(ctx: Context) -> dict:
    """The mesh steps against one card (module docstring): against the
    step on the whole batch, to the float32 tolerance of another rounding
    (its spread under a one-ulp nudge of the images); in sample scope also
    against the same step computed shard by shard on this card and
    averaged, which at model axis 1 runs the mesh's shapes: to
    ``SUM_TOL``, the data ranks' mean summed in another order (0 on one
    rank)."""
    cfg = ctx.cfg.replace(batch_size=ctx.plan.step_frames)
    dtype = ctx.plan.dtype
    f64 = dtype == torch.float64
    batch = train_batch(cfg, cfg.batch_size, 3, ctx.device, dtype)
    anchors = anchors_for(cfg, ctx.device, dtype)
    cases = [(f"{ctx.world}x1 {s}", (ctx.world, 1), s)
             for s in ctx.plan.scopes]
    if ctx.model_shape():
        cases.append(("{}x{} sample".format(*ctx.model_shape()),
                      ctx.model_shape(), "sample"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, ok = {}, True
    try:
        for name, shape, scope in cases:
            c = cfg.replace(norm_scope=scope)
            base = ctx.model(c)
            ref = one_step(ctx, c, base, batch, anchors)
            # float64 is held to F64_TOL: no spread to measure
            moved = ref if f64 else one_step(
                ctx, c, base, batch._replace(images=nudge(
                    batch.images, compute_dtype(c, dtype))), anchors)
            got = one_step(ctx, c, base, batch, anchors,
                           mesh=ctx.mesh(shape), count="train"
                           not in ctx.launches)
            twins = twin_slices(got[4])
            lr, eps = ref[3].schedule(0), c.eps
            spread = compare_steps(ref, moved, {})
            whole = compare_steps(ref, got, twins, lr, eps)
            tol = {"metrics": F64_TOL if f64 else max(
                       REF_FACTOR * spread["metrics"], FLOOR),
                   "grads_rel_norm": F64_TOL if f64 else max(
                       CHAOS_FACTOR * spread["grads_rel_norm"], FLOOR)}
            good = (whole["same_keys"] and got[3].step == 1
                    and whole["params_within_update_bound"]
                    and whole["metrics"] <= tol["metrics"]
                    and whole["grads_rel_norm"] <= tol["grads_rel_norm"]
                    and (not f64 or whole["grads"] <= F64_TOL))
            rec = {"loss": got[0]["total_loss"],
                   "loss_one_card": ref[0]["total_loss"],
                   "vs_one_card_whole_batch": whole,
                   "nudged_one_card": spread, "tolerance": tol, "lr": lr,
                   "adam_eps": eps}
            if scope == "sample":
                emu = shard_mean(ctx, c, base, batch, anchors, shape[0])
                same = compare_steps(emu, got, twins)
                exact = shape[1] == 1
                sum_tol = F64_TOL if f64 else (
                    0.0 if shape[0] == 1 else SUM_TOL)
                rec.update(vs_one_card_by_shard=same,
                           by_shard_runs_mesh_shapes=exact,
                           by_shard_tolerance=sum_tol if exact
                           else tol["grads_rel_norm"])
                if exact:
                    good = good and same["metrics"] <= sum_tol \
                        and same["grads"] <= sum_tol
                else:
                    good = good and same["grads_rel_norm"] <= \
                        tol["grads_rel_norm"]
            out[name] = {"ok": good, **rec}
            ok = ok and good
            del base, ref, moved, got
            if ctx.cuda:
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
    return {"ok": ok, "global_batch": ctx.plan.step_frames, "steps": out,
            "launches": ctx.launches.get("train")}


def check_nonfinite(ctx: Context) -> dict:
    """A NaN loss on one data rank (its RPN scores made NaN) skips the
    update on every rank."""
    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.parallel.mesh import axis_index
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import make_train_step

    mesh = ctx.mesh((ctx.world, 1))
    cfg = ctx.cfg.replace(batch_size=ctx.plan.step_frames)
    batch = train_batch(cfg, cfg.batch_size, 3, ctx.device, ctx.plan.dtype)
    model = ctx.model(cfg).train()
    bad = min(1, ctx.world - 1)
    if axis_index(mesh, "data") == bad:
        model.backbone.rpn.register_forward_hook(
            lambda mod, args, maps: (maps[0] * float("nan"), maps[1]))
    before = _params(model)
    state = TrainState.create(cfg, shard_params(model, mesh))
    m = make_train_step(cfg, anchors_for(cfg, ctx.device, ctx.plan.dtype),
                        mesh=mesh)(state, shard_batch(batch, mesh))
    unchanged = all(torch.equal(p, before[n])
                    for n, p in _params(model).items())
    skipped = int(m["skipped_nonfinite"])
    return {"ok": skipped == 1 and state.step == 0 and unchanged,
            "nan_on_data_rank": bad, "skipped": skipped,
            "step": state.step, "params_unchanged": unchanged,
            "loss": float(m["total_loss"])}


def check_bf16(ctx: Context) -> dict:
    """``configs/full_fusion.yaml`` as written at (W, 1): three mesh steps
    finite, the first loss against the one-card step on the same global
    batch."""
    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import make_train_step

    cfg = load_config(FULL_FUSION)
    n = cfg.batch_size
    batch = train_batch(cfg, n, 3, ctx.device, torch.float32)
    anchors = anchors_for(cfg, ctx.device, torch.float32)
    base = build_model(cfg, seed=0, device=ctx.device)
    loss_ref = one_step(ctx, cfg, base, batch, anchors)[0]["total_loss"]
    loss_moved = one_step(ctx, cfg, base, batch._replace(
        images=nudge(batch.images, torch.bfloat16)), anchors)[0][
            "total_loss"]
    mesh = ctx.mesh((ctx.world, 1))
    state = TrainState.create(cfg, shard_params(base.train(), mesh))
    step = make_train_step(cfg, anchors, mesh=mesh)
    local = shard_batch(batch, mesh)
    losses, skipped = [], []
    for _ in range(3):
        m = step(state, local)
        losses.append(float(m["total_loss"]))
        skipped.append(int(m["skipped_nonfinite"]))
    scale = max(1.0, abs(loss_ref))
    err = abs(losses[0] - loss_ref) / scale
    nudged = abs(loss_moved - loss_ref) / scale
    tol = ctx.tolerance(nudged, torch.bfloat16)
    return {"ok": bool(np.isfinite(losses).all()) and not any(skipped)
            and err <= tol and state.step == 3,
            "config": "configs/full_fusion.yaml", "use_bf16": cfg.use_bf16,
            "remat": cfg.remat, "global_batch": n, "losses": losses,
            "loss_one_card": loss_ref, "first_loss_rel_err": err,
            "nudged_rel_err": nudged, "tolerance": tol}


def jax_case_batch(cfg: Config, device):
    """``dryrun_multichip``'s data: one frame per data rank, half the
    points live, four boxes each (``__graft_entry__.py``)."""
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    B = cfg.batch_size
    rng = np.random.default_rng(0)
    P = cfg.max_points
    pts = np.zeros((B, P, 6), np.float32)
    n = P // 2
    pts[:, :n, 0] = rng.uniform(0.5, 12.0, (B, n))
    pts[:, :n, 1] = rng.uniform(-7.5, 7.5, (B, n))
    pts[:, :n, 2] = rng.uniform(-2.5, 0.5, (B, n))
    pts[:, :n, 3] = rng.uniform(0, 1, (B, n))
    pts[:, :n, 4] = rng.uniform(0, cfg.image_size[0] - 1, (B, n))
    pts[:, :n, 5] = rng.uniform(0, cfg.image_size[1] - 1, (B, n))
    images = rng.uniform(0, 1, (B, *cfg.image_size, 3)).astype(np.float32)
    gt = np.zeros((B, cfg.max_boxes, 7), dtype=np.float32)
    gt[..., 0] = rng.uniform(3, 10, (B, cfg.max_boxes))
    gt[..., 1] = rng.uniform(-4, 4, (B, cfg.max_boxes))
    gt[..., 2] = -1.6
    gt[..., 3:6] = cfg.car_size
    gt_mask = np.ones((B, cfg.max_boxes), dtype=bool)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return frames_to_batch(
        t(pts), torch.full((B,), n, dtype=torch.int32, device=device),
        t(images), cfg, gt_boxes=t(gt), gt_mask=t(gt_mask),
        gt_classes=torch.zeros((B, cfg.max_boxes), dtype=torch.int32,
                               device=device))


def check_jax_case(ctx: Context) -> dict:
    """JAX's dry run: its tiny configuration and data, one fused step on
    the (W/2, 2) mesh, a finite loss."""
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model

    shape = ctx.model_shape()
    cfg = Config(**JAX_TINY, batch_size=shape[0])
    batch = jax_case_batch(cfg, ctx.device)
    model = build_model(cfg, seed=0, device=ctx.device)
    metrics = one_step(ctx, cfg, model, batch,
                       anchors_for(cfg, ctx.device, torch.float32),
                       mesh=ctx.mesh(shape))[0]
    loss = metrics["total_loss"]
    return {"ok": bool(np.isfinite(loss)) and not metrics["skipped_nonfinite"],
            "mesh": dict(zip(("data", "model"), shape)), "loss": loss}


def check_float64_tiny(ctx: Context) -> dict:
    """The small configuration in float64 on this rank's card, on the
    (W/2, 2) mesh against one rank: the LiDAR-only dense-CML model's maps
    and one step, and the fused model's image pyramid."""
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.serve import Detector

    dev, f64 = ctx.device, torch.float64
    shape = ctx.model_shape()
    mesh = ctx.mesh(shape)
    cfg = Config(**TINY, cml_mode="dense3d",
                 batch_size=ctx.plan.step_frames)
    base = build_model(cfg, seed=1, device=dev, with_images=False).to(f64)
    frames = [f[:3] for f in make_frames(cfg, cfg.batch_size, 1)]
    plain = Detector(cfg, copy.deepcopy(base).eval(), with_images=False)
    det = Detector(cfg, copy.deepcopy(base).eval(), with_images=False,
                   mesh=mesh)
    local = det._local(*det.assemble(frames))
    maps = max(rel(g, w) for g, w in zip(maps_of(det, *local),
                                         maps_of(plain, *local)))
    batch = train_batch(cfg, cfg.batch_size, 3, dev, f64)
    anchors = anchors_for(cfg, dev, f64)
    ref = one_step(ctx, cfg, base, batch, anchors, with_images=False)
    got = one_step(ctx, cfg, base, batch, anchors, mesh=mesh,
                   with_images=False)
    step = compare_steps(ref, got, twin_slices(got[4]), ref[3].schedule(0),
                         cfg.eps)
    fused = build_model(Config(**TINY), seed=1, device=dev).to(f64).eval()
    images = shard_batch(batch.images, mesh)
    with torch.no_grad():
        want = fused.head.pyramid(images)
        got_p = shard_params(copy.deepcopy(fused), mesh).head.pyramid(images)
    pyramid = max(rel(g, w) for g, w in zip(got_p, want))
    twins = len(twin_slices(got[4]))
    worst = max(maps, step["metrics"], step["grads"], pyramid)
    return {"ok": worst <= F64_TOL and twins > 0
            and step["params_within_update_bound"],
            "mesh": list(shape), "tolerance": F64_TOL,
            "config": "small configuration (grid 32x40x10, 64x96 images), "
                      "float64; LiDAR-only dense CML maps and step, fused "
                      "image pyramid",
            "maps": maps, "metrics": step["metrics"],
            "grads": step["grads"], "worst_grad": step["worst_grad"],
            "pyramid": pyramid, "lidar_twins": twins,
            "params_within_update_bound":
                step["params_within_update_bound"]}


def kernel_inputs(det, points, nums, images):
    """The arguments the serving path hands K1 and K2 for one batch,
    caught by forward pre-hooks inside ``det.maps``."""
    from mvxnet_makise_tpu_torch.models.image_head import gather_image_size

    caught = {}

    def at_conv1(conv1, args):
        caught["merge"] = tuple(conv1.merge_inputs(*args))

    def at_head(head, args):
        imgs, points_rc, point_mask = args[:3]
        caught["gather"] = (head.pyramid(imgs), points_rc.contiguous(),
                            point_mask.contiguous(),
                            gather_image_size(head.image_size,
                                              head.image_min_side))
        caught["gather_opts"] = (head.eps, head.swapped_bilerp)

    model = det.model
    hooks = [model.backbone.cml.conv1.register_forward_pre_hook(at_conv1),
             model.head.register_forward_pre_hook(at_head)]
    try:
        maps_of(det, points, nums, images)
    finally:
        for h in hooks:
            h.remove()
    return caught["merge"], caught["gather"], caught["gather_opts"]


def check_kernels(ctx: Context) -> dict:
    """Launch counts of this rank's serving and step, and one K1 and one
    K2 call on its card against their plain versions, on the arguments
    the (W, 1) mesh hands this rank's first frame."""
    from mvxnet_makise_tpu_torch.ops import column_merge, gather

    mesh = ctx.mesh((ctx.world, 1))
    frames = [f[:3] for f in make_frames(ctx.cfg, ctx.plan.batch, 0)]
    det = ctx.detector(mesh=mesh)
    try:
        merge, (feats, rc, valid, size), (eps, swapped) = kernel_inputs(
            det, *det._local(*det.assemble(frames)))
    finally:
        det.close()
    y, col_cy, bounds, bias = merge
    grid = ctx.cfg.voxel_shape
    # a nonzero bias: the model's is zero at initialization
    gen = torch.Generator(device=y.device).manual_seed(2)
    bias = torch.randn(bias.shape, generator=gen, device=y.device) * 0.1
    ctx.zero()
    out, stats = column_merge.merge_taps_fused(y, col_cy, bounds, bias, grid)
    got = gather.fpn_gather(feats, rc, valid, size, eps=eps,
                            swapped_weights=swapped)
    ctx.sync()
    held = ctx.counts()
    want_out, want_stats = column_merge.merge_taps_fused_plain(
        y, col_cy, bounds, bias, grid)
    want = gather.fpn_gather_plain(feats, rc, valid, size, eps=eps,
                                   swapped_weights=swapped)
    errs = {"column_merge": {"out": rel(out, want_out),
                             "stats": rel(stats, want_stats)},
            "fpn_gather": {"out": rel(got, want)}}
    within = all(errs[k][f] <= KERNEL_TOL[k][f] for k in errs
                 for f in errs[k])
    serve, train = ctx.launches.get("serve", {}), ctx.launches.get(
        "train", {})
    needed = {"serve": ("column_merge", "fpn_gather"),
              "train": ("column_merge", "column_merge_bwd",
                        "merge_taps_bwd", "fpn_gather")}
    missing = [f"{path} {n}" for path, names in needed.items()
               for n in names
               if ctx.launches.get(path, {}).get(n, 0) == 0] \
        if ctx.cuda else []
    launched = (held["column_merge"] == 1 and held["fpn_gather"] == 1) \
        if ctx.cuda else True
    return {"ok": within and not missing and launched,
            "card": str(y.device), "rel_err": errs, "tolerance": KERNEL_TOL,
            "held_launches": {k: held[k] for k in ("column_merge",
                                                   "fpn_gather")},
            "serve_launches": serve, "train_launches": train,
            "missing": missing}


def _median(v: Sequence[float]) -> float:
    return float(np.median(v))


def in_turns(ctx: Context, one: Callable[[], float],
             mesh: Callable[[], float]) -> Dict[str, list]:
    """``rounds`` turns of each, one card, mesh, mesh, one card: the one
    card runs on rank 0 while the others wait."""
    turns = {"one_card": [], "mesh": []}
    order = ["one_card", "mesh", "mesh", "one_card"] * (
        (ctx.plan.rounds + 1) // 2)
    for name in order:
        if name == "mesh":
            turns[name].append(mesh())
        elif ctx.rank == 0:
            turns[name].append(one())
        dist.barrier()
    return turns


def check_cost(ctx: Context) -> dict:
    """ms per frame and per step in turns, and a profiler window over one
    (W, 1) step (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from mvxnet_makise_tpu_torch.parallel import shard_batch, shard_params
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import make_train_step

    b, W = ctx.plan.batch, ctx.world
    frames = [f[:3] for f in make_frames(ctx.cfg, ctx.plan.frames, 0)]
    plain = ctx.detector()
    det = ctx.detector(mesh=ctx.mesh((W, 1)))

    def serve_ms(d):
        ctx.sync()
        t0 = time.perf_counter()
        for i in range(0, len(frames), b):
            d.detect_frames(frames[i:i + b])
        ctx.sync()
        return (time.perf_counter() - t0) * 1e3 / len(frames)

    try:
        det.warm((b,))
        plain.warm((b,))
        serve = in_turns(ctx, lambda: serve_ms(plain), lambda: serve_ms(det))
    finally:
        det.close()
        plain.close()
    del det, plain
    if ctx.cuda:
        torch.cuda.empty_cache()

    cfg = ctx.cfg.replace(batch_size=b)
    batch = train_batch(cfg, W * b, 3, ctx.device, ctx.plan.dtype)
    anchors = anchors_for(cfg, ctx.device, ctx.plan.dtype)

    def stepper(shape):
        model = ctx.model(cfg).train()
        local = take(batch, b) if shape is None else shard_batch(
            take(batch, shape[0] * b), ctx.mesh(shape))
        if shape is not None:
            shard_params(model, ctx.mesh(shape))
        state = TrainState.create(cfg, model)
        step = make_train_step(
            cfg, anchors, mesh=None if shape is None else ctx.mesh(shape))
        step(state, local)         # warm

        def run():
            ctx.sync()
            t0 = time.perf_counter()
            step(state, local)
            ctx.sync()
            return (time.perf_counter() - t0) * 1e3
        return run, model

    mesh_run, model = stepper((W, 1))
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters() if p.requires_grad)
    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if ctx.cuda else [])) as prof:
        wall = mesh_run()
    window = device_window(prof, wall)
    nccl = nccl_evidence(prof)
    one_run = stepper(None)[0] if ctx.rank == 0 else None
    step = in_turns(ctx, one_run, mesh_run)
    del mesh_run, one_run, model
    if ctx.cuda:
        torch.cuda.empty_cache()
    model_step = None
    if ctx.model_shape():
        run = stepper(ctx.model_shape())[0]
        model_step = [run() for _ in range(ctx.plan.rounds)]
        del run
    rec = {"serve_ms_per_frame": {k: _median(v) for k, v in serve.items()
                                  if v},
           "serve_ms_per_frame_turns": serve,
           "step_ms": {k: _median(v) for k, v in step.items() if v},
           "step_ms_turns": step,
           "step_frames": {"one_card": b, "mesh_per_rank": b,
                           "mesh_global": W * b},
           "profiled_step": window, "nccl": nccl,
           "all_reduced_gradient_bytes": grad_bytes}
    if model_step is not None:
        rec["model_axis_step_ms"] = _median(model_step)
        rec["model_axis_step_ms_all"] = model_step
        rec["model_axis_mesh"] = list(ctx.model_shape())
        rec["model_axis_global_frames"] = ctx.model_shape()[0] * b
    rec["ok"] = bool(nccl["device_kernels"] or nccl["host_calls"]) \
        and all(np.isfinite(v).all() for v in serve.values() if v)
    return rec


CHECKS: Dict[str, Callable[[Context], dict]] = {
    "init": check_init, "meshes": check_meshes,
    "collectives": check_collectives, "serve_data": check_serve_data,
    "serve_model": check_serve_model, "float64_tiny": check_float64_tiny,
    "steps": check_steps, "nonfinite": check_nonfinite, "bf16": check_bf16,
    "jax_case": check_jax_case, "kernels": check_kernels,
    "cost": check_cost}


def rank_checks(plan: Plan, device, emit: bool = True) -> Dict[str, dict]:
    """Run ``plan``'s checks on this rank of the initialized world (every
    rank calls it).  Returns, per check, ``{"ok": every rank's ok,
    "ranks": each rank's record}``, the same on every rank; rank 0 prints
    each as one JSON line when ``emit``.  A check that raises ends the
    run."""
    ctx = Context(plan, device)
    results = {}
    for name in plan.checks:
        t0 = time.perf_counter()
        rec = CHECKS[name](ctx)
        rec["seconds"] = time.perf_counter() - t0
        ranks = ctx.gather(rec)
        results[name] = {"check": name,
                         "ok": all(r["ok"] for r in ranks), "ranks": ranks}
        if emit and ctx.rank == 0:
            print(json.dumps(results[name]), flush=True)
    return results


# ------------------------------------------------------------- command


def worker(args) -> int:
    from mvxnet_makise_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    cpu = args.device == "cpu"
    initialize_distributed(device=args.device,
                           timeout=timedelta(seconds=COLLECTIVE_S))
    try:
        device = "cpu" if cpu else torch.device(
            "cuda", torch.cuda.current_device())
        results = rank_checks(CPU_PLAN if cpu else CARD_PLAN, device)
        ok = all(r["ok"] for r in results.values())
        if dist.get_rank() == 0:
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
            for line in ([] if cpu else gpu_lines()):
                print(line, flush=True)
            print(json.dumps({
                "ok": ok, "world": dist.get_world_size(),
                "backend": dist.get_backend(),
                "checks": {k: v["ok"] for k, v in results.items()}}),
                flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m " + MODULE, description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4,
                    help="ranks to start, one per card (default 4)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: gloo ranks at a tiny float64 configuration")
    ap.add_argument("--out", default=None,
                    help="also write every rank's records to this JSON file")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker(args)
    if args.cards < 1:
        raise SystemExit(f"multicard: --cards {args.cards} < 1")
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.cards:
            raise SystemExit(f"multicard: {args.cards} cards asked, {have} "
                             "found; nothing was run")
        from mvxnet_makise_tpu_torch.ops import (
            column_merge,
            cuda_build,
            gather,
            scatter_grid,
        )

        # one build before the ranks start, which then load it
        cuda_build.build_all([*column_merge.KERNELS, gather.KERNEL,
                              *scatter_grid.KERNELS])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={args.cards}", "-m", MODULE, "--worker",
           "--device", args.device]
    if args.out:
        cmd += ["--out", os.path.abspath(args.out)]
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
