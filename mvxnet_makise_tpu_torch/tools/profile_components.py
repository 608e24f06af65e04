"""Per-stage time of the inference pipeline, each stage run alone.

Port of ``mvxnet_makise_tpu/tools/profile_components.py``.  Each stage of
the point-major detector (``MVXNetPM``) runs on its own, on inputs made
once, after a warm-up: the voxelizer, the frozen ResNet50-FPN, the whole
image head, K2 (``fpn_gather``: JAX's ``fpn_gather_raw4`` and
``..._fused`` are two XLA formulations of this one function), the fusion
MLP (the masked statistics, the port's one formulation), the LiDAR
branch with the image features zeroed, and the whole model.  Under
``use_bf16`` (the default configuration's here, as in JAX's tool) the
stages run on the bfloat16 copies of the parameters the model computes
with.  ``--fusion-mode point`` builds "point", which the port computes as
``MVXNetPM`` (``models/mvxnet.build_model``).

On the card each stage is timed with CUDA events around ``--iters``
back-to-back calls, ending in ``synchronize()``; with ``--device cpu``
(the tests' tiny run) with the host clock.  One JSON record per stage:
``stage``, ``jax`` (the same name), ``ms_per_batch``, ``ms_per_frame``,
``device`` (the card's name, or "cpu"), ``first_call_s`` (the warm-up
call, kernel builds included), and, where the stage runs PyTorch's
matrix products or convolutions, ``gflop_per_batch``, ``gflop_per_frame``
and ``tflops`` from ``torch.utils.flop_counter.FlopCounterMode`` (JAX's
tool reads XLA's cost analysis; the count leaves out the hand-written
kernels).  Its
records (:class:`Row`, :func:`time_row`), arguments (:func:`tool_parser`)
and inputs (:func:`synthetic_batch`) serve ``tools.profile_train`` and
the sub-stage tools ``tools.bench_*`` too.

Usage: python -m mvxnet_makise_tpu_torch.tools.profile_components
           [--batch N] [--iters N] [--fusion-mode pm|point]
           [--cml-mode dense3d|banded|column] [--config FILE]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import (
    Any,
    Callable,
    Iterable,
    List,
    Mapping,
    NamedTuple,
    Tuple,
    Union,
)

# the stage records, in order
STAGES = ("voxelize", "resnet_fpn", "image_head_total", "fpn_gather",
          "fusion_mlp_masked", "voxelnet_branch", "full_model")


def device_name(device) -> str:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def flop_count(fn: Callable) -> float:
    """FLOPs of one call of ``fn`` as PyTorch's flop counter sees them
    (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def time_call(fn: Callable, device, iters: int) -> Tuple[float, float]:
    """(ms per call, seconds of the warm-up call) of ``fn``: a warm-up
    call, then ``iters`` back-to-back calls timed with CUDA events on the
    card (ending in ``synchronize()``), with the host clock on the CPU."""
    import torch

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    first = time.perf_counter() - t0
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, first
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters, first


class Row(NamedTuple):
    """One timed row of a measurement tool: its name, the JAX tool's
    label or labels it stands for, the call it times, the fields its
    record adds, and per-second rates: ``rates["GBps"] = x`` reports
    x / seconds per call.  A row that calls a kernel's wrapper itself
    makes ``fn`` a ``functools.partial`` of it, so that a check can hand
    the same inputs to the kernel's plain version."""
    name: str
    jax: Union[str, Tuple[str, ...]]
    fn: Callable
    fields: Mapping[str, Any] = {}
    rates: Mapping[str, float] = {}
    flops: bool = True


def time_row(row: Row, device, iters: int, key: str = "stage",
             batch: int = 0) -> dict:
    """The record of ``row``: :func:`time_call`, then the GFLOP that
    ``FlopCounterMode`` counts, in the caller's grad mode; per frame too
    where ``batch`` is given.  On the card the allocator's cache is
    emptied after it, as the row's outputs are gone."""
    import torch

    ms, first = time_call(row.fn, device, iters)
    gf = flop_count(row.fn) / 1e9 if row.flops else 0.0
    rec = {key: row.name, "jax": row.jax, "ms_per_batch": ms,
           **({"ms_per_frame": ms / batch} if batch else {}),
           "device": device_name(device), "first_call_s": first,
           **row.fields,
           **{k: v * 1e3 / ms for k, v in row.rates.items()}}
    if gf:
        rec["gflop_per_batch"] = gf
        if batch:
            rec["gflop_per_frame"] = gf / batch
        rec["tflops"] = gf / ms
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def print_rows(rows: Iterable[Row], device, iters: int,
               key: str = "stage", batch: int = 0) -> List[dict]:
    """Time each row in turn (:func:`time_row`) without autograd, so what
    a generator of rows computes between its rows keeps no graph either,
    and print its record as one JSON line; returns the records."""
    import torch

    recs = []
    with torch.no_grad():
        for row in rows:
            recs.append(time_row(row, device, iters, key, batch))
            print(json.dumps(recs[-1]), flush=True)
    return recs


def kernel_route(device) -> str:
    """What a kernel's wrapper runs on ``device``: the CUDA kernel on the
    card, its plain PyTorch version on the CPU."""
    return "cuda" if device.type == "cuda" else "plain"


def synthetic_batch(cfg, device, with_boxes: bool = False):
    """``cfg.batch_size`` synthetic frames (seed 0) as padded tensors on
    ``device``: points, num_points, images (and gt boxes and mask)."""
    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.data.pipeline import (
        collate,
        preprocess_frame,
    )
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame

    rng = np.random.default_rng(0)
    fb = collate([preprocess_frame(*synthetic_frame(rng, cfg), cfg)
                  for _ in range(cfg.batch_size)])
    names = ("points", "num_points", "image") + (
        ("gt_boxes", "gt_mask") if with_boxes else ())
    return tuple(torch.from_numpy(getattr(fb, n)).to(device) for n in names)


def make_config(args, **fields):
    """``--config`` as written (default: ``Config(use_bf16=True)``), with
    ``fields`` over it."""
    from mvxnet_makise_tpu_torch.config import Config, load_config

    if args.config:
        return load_config(args.config, **fields)
    return Config(use_bf16=True, **fields)


def tool_parser(iters: int) -> argparse.ArgumentParser:
    """The arguments every measurement tool takes: ``--batch`` (8),
    ``--iters``, ``--config`` and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=iters)
    p.add_argument("--config", default=None,
                   help="a configuration file (default: Config(use_bf16="
                        "True)); the flags override it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    p = tool_parser(iters=8)
    p.add_argument("--fusion-mode", default="pm", choices=["pm", "point"])
    p.add_argument("--cml-mode", default=None,
                   choices=["dense3d", "banded", "column"],
                   help="override the CML first-layer formulation "
                        "(default: the configuration's)")
    args = p.parse_args(argv)
    B = args.batch

    import torch

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32
    from mvxnet_makise_tpu_torch.models.image_head import gather_image_size
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.models.voxelnet_pm import (
        point_lidar_features,
    )
    from mvxnet_makise_tpu_torch.ops.gather import fpn_gather
    from mvxnet_makise_tpu_torch.train.state import cast_for_compute
    from mvxnet_makise_tpu_torch.train.step import (
        cast_batch_for_compute,
        forward,
        frames_to_batch,
    )

    device = resolve_device(args.device)
    use_full_f32()
    fields = dict(batch_size=B, fusion_mode=args.fusion_mode)
    if args.cml_mode:
        fields["cml_mode"] = args.cml_mode
    cfg = make_config(args, **fields)
    points, nums, images = synthetic_batch(cfg, device)

    def stage(name, fn, flops=True):
        print_rows([Row(name, name, fn, flops=flops)], device, args.iters,
                   batch=B)

    stage("voxelize", lambda: frames_to_batch(points, nums, images, cfg)
          .coords, flops=False)

    batch = frames_to_batch(points, nums, images, cfg)
    model = build_model(cfg, seed=0, device=device)
    tensors = cast_for_compute(model, cfg.use_bf16)
    cbatch = cast_batch_for_compute(batch, cfg.use_bf16)
    # the modules on the copies the forward computes with
    cmodel = (copy.deepcopy(model).to(torch.bfloat16) if cfg.use_bf16
              else model)
    head = cmodel.head
    cimg = cbatch.images
    kept = batch.sorted_kept
    rc = batch.sorted_points[..., 4:6].contiguous()
    T = cfg.samples_per_voxel
    nv = batch.vmask.sum(dim=1) * T - kept.sum(dim=1)

    stage("resnet_fpn", lambda: head.pyramid(cimg)[0])
    stage("image_head_total", lambda: head(cimg, rc, kept, nv)[0])

    with torch.no_grad():
        pyr = head.pyramid(cimg)
    gsize = gather_image_size(head.image_size, head.image_min_side)
    stage("fpn_gather", lambda: fpn_gather(
        pyr, rc, kept.contiguous(), gsize, eps=head.eps,
        swapped_weights=head.swapped_bilerp), flops=False)
    with torch.no_grad():
        g = fpn_gather(pyr, rc, kept.contiguous(), gsize, eps=head.eps,
                       swapped_weights=head.swapped_bilerp)
    stage("fusion_mlp_masked", lambda: head.fusion(g, kept, nv)[0])

    # the LiDAR branch in the point-major dataflow, image features zeroed
    cdt = cimg.dtype
    pf7 = point_lidar_features(batch.sorted_points, batch.sorted_seg, kept,
                               batch.counts, T)
    x23 = torch.cat([pf7.to(cdt), pf7.new_zeros((*pf7.shape[:2], 16),
                                                dtype=cdt)], dim=-1)
    z0 = torch.zeros((B, cfg.max_voxels, 23), dtype=cdt, device=device)
    stage("voxelnet_branch", lambda: cmodel.backbone(
        x23, kept, batch.sorted_seg, batch.counts, batch.coords,
        batch.vmask, z0)[0])

    stage("full_model", lambda: forward(model, batch, cfg, True,
                                        tensors)[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
