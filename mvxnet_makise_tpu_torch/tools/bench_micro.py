"""Micro-probes of the column CML's conv1 and of its epilogue passes.

Port of ``mvxnet_makise_tpu/tools/bench_micro.py``: where the column
conv1's time goes, stage by stage, and what a standardize pass and the
d-minor -> (C, D) relayout cost at the CML's shapes.  On ``--batch``
synthetic frames (seed 0) voxelized at ``Config(use_bf16=True)`` (or
``--config``), with random bfloat16 voxel features of 128 channels
(float32 when the configuration is) and conv1's weights as JAX's tool
draws them (:func:`inputs`), rows in order (``STAGES``):

* ``compact_columns`` (JAX ``:77``): ``ops/column_conv.compact_columns``;
* ``taps matmul (folded)`` (``:82``): ``column_conv.column_taps``, the
  folded kernel (``fold_conv1_kernel``) times the depth im2col;
* ``merge (+bias/relu/stats)`` (``:100``): K1,
  ``ops/column_merge.merge_taps_fused`` on ``column_bounds``;
* ``standardize (batch scope) 320ch`` and ``standardize (sample scope)
  320ch`` (``:104-105``): ``models/blocks.standardize`` of K1's output;
* ``(C,D)-fold relayout (transpose+reshape)`` (``:108``);
* ``voxelize (pm)`` (``:115``, "batch 8"): ``ops/voxelize.voxelize``.

None of these reads a count back to the host (``"syncs": false``): the
compaction keeps its static capacity of V columns.  Times and records as
in ``tools.bench_kernels`` (``stage`` for its ``kernel``), with ``route``
on K1's row and ``gflop_per_batch`` where PyTorch counts matrix products.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_micro
           [--batch N] [--iters N] [--config FILE] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Iterator

from mvxnet_makise_tpu_torch.tools.profile_components import (
    Row,
    kernel_route,
    make_config,
    print_rows,
    synthetic_batch,
    tool_parser,
)

STAGES = ("compact_columns", "taps matmul (folded)",
          "merge (+bias/relu/stats)", "standardize (batch scope) 320ch",
          "standardize (sample scope) 320ch",
          "(C,D)-fold relayout (transpose+reshape)", "voxelize (pm)")
CONV1_FEATURES = 64


def inputs(cfg, device):
    """What :func:`rows` takes at ``cfg``: conv1
    (``models/voxelnet.ColumnConv1ReluNorm``, 128 -> 64 channels) with
    JAX's weights for this tool (normal with std 0.05, zero bias),
    ``cfg.batch_size`` synthetic frames (points, num_points, images) and
    random voxel features of 128 channels in the compute dtype, zero on
    dead voxels; the draws from seed 0."""
    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.models.voxelnet import ColumnConv1ReluNorm
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    frames = synthetic_batch(cfg, device)
    vmask = frames_to_batch(*frames, cfg).vmask
    rng = np.random.default_rng(0)
    vfeat = (torch.as_tensor(rng.standard_normal(
        (cfg.batch_size, cfg.max_voxels, 128)), dtype=dtype).to(device)
        * vmask[..., None])
    conv1 = ColumnConv1ReluNorm(128, CONV1_FEATURES, cfg.voxel_shape)
    with torch.no_grad():
        conv1.conv.weight.copy_(torch.as_tensor(
            rng.standard_normal(tuple(conv1.conv.weight.shape)) * 0.05))
    return conv1.to(device), frames, vfeat


def rows(cfg, conv1, frames, vfeat) -> Iterator[Row]:
    """The rows of :data:`STAGES`: conv1's sub-stages, as
    ``ColumnConv1ReluNorm`` composes them, with its weight and bias on
    ``vfeat`` (B, V, 128) at the voxels of ``frames`` (points,
    num_points, images on the device; :func:`inputs`)."""
    import functools

    import torch

    from mvxnet_makise_tpu_torch.models.blocks import standardize
    from mvxnet_makise_tpu_torch.ops.column_conv import (
        column_taps,
        compact_columns,
    )
    from mvxnet_makise_tpu_torch.ops.column_merge import (
        column_bounds,
        merge_taps_fused,
    )
    from mvxnet_makise_tpu_torch.ops.voxelize import voxelize
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    dtype = vfeat.dtype
    name = str(dtype).removeprefix("torch.")
    B, V, grid = cfg.batch_size, cfg.max_voxels, tuple(cfg.voxel_shape)
    nx, ny, nz = grid
    points, nums, _ = frames
    batch = frames_to_batch(*frames, cfg)
    coords, vmask = batch.coords, batch.vmask
    weight = conv1.conv.weight.to(dtype)
    d_out = conv1.d_out
    # the bias on every output depth, in the merge's accumulation dtype
    bias = conv1.conv.bias.to(torch.promote_types(
        dtype, torch.float32)).repeat(d_out).contiguous()
    fields = {"dtype": name, "syncs": False}

    yield Row("compact_columns", "compact_columns",
              lambda: compact_columns(vfeat, coords, vmask, grid), fields)
    cols, col_xy, col_mask = compact_columns(vfeat, coords, vmask, grid)
    yield Row("taps matmul (folded)", "taps matmul (folded)",
              lambda: column_taps(cols, weight), fields)
    y = column_taps(cols, weight).contiguous()
    del cols
    cy = col_xy[..., 1].contiguous()
    bounds = column_bounds(col_xy, col_mask, nx)
    yield Row("merge (+bias/relu/stats)", "pallas merge (+bias/relu/stats)",
              functools.partial(merge_taps_fused, y, cy, bounds, bias, grid),
              {**fields, "route": kernel_route(vfeat.device)})
    out, _ = merge_taps_fused(y, cy, bounds, bias, grid)
    del y

    x = out.reshape(B, nx, ny, d_out * CONV1_FEATURES)
    yield Row("standardize (batch scope) 320ch",
              "standardize (batch scope) 320ch",
              lambda: standardize(x, dims=(1, 2), batch=True), fields)
    yield Row("standardize (sample scope) 320ch",
              "standardize (sample scope) 320ch",
              lambda: standardize(x, dims=(1, 2)), fields)
    x5 = x.reshape(B, nx, ny, d_out, CONV1_FEATURES)
    yield Row("(C,D)-fold relayout (transpose+reshape)",
              "(C,D)-fold relayout (transpose+reshape)",
              lambda: x5.transpose(3, 4).reshape(B, nx, ny, -1), fields)
    del out, x, x5

    yield Row("voxelize (pm)", "voxelize (pm, batch 8)", lambda: voxelize(
        points, nums, velo_range=cfg.velo_range, voxel_size=cfg.voxel_size,
        grid_shape=grid, max_voxels=V,
        samples_per_voxel=cfg.samples_per_voxel).sorted_points,
        {**fields, "dtype": "float32"})


def main(argv=None) -> int:
    args = tool_parser(iters=10).parse_args(argv)

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32

    device = resolve_device(args.device)
    use_full_f32()
    cfg = make_config(args, batch_size=args.batch)
    print_rows(rows(cfg, *inputs(cfg, device)), device, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
