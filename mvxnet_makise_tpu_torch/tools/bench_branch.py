"""Sub-stage time of the LiDAR branch (``VoxelNetBranchPM``), in the model.

Port of ``mvxnet_makise_tpu/tools/bench_branch.py``: the branch split
into its sub-stages in both CML forms, so CML decisions stay measured.
The model is the LiDAR-only branch on the 7 LiDAR channels
(``build_model(cfg, with_images=False)``, JAX's
``build_model_and_state(cfg, with_images=False)``) at
``Config(use_bf16=True)`` (or ``--config``), seed-0 weights, on
``--batch`` synthetic frames.  As in JAX's tool (``:57-59``) the point
features and the weights are cast to the compute dtype, bfloat16 under
``use_bf16``, so the branch computes in bfloat16 here (the LiDAR-only
*training* path computes in float32 instead, ``train/state``); the
records' ``dtype`` says which ran.  Rows, in order (``STAGES``):

* ``svfe->vfeat`` (JAX ``:114``): ``models/voxelnet_pm.voxel_features``
  (JAX's ``SVFEOnly``, ``:74-90``, is the same composition);
* ``scatter only`` (``:120``): ``models/voxelnet.scatter_to_dense`` with
  backend "auto" (the plain scatter, as JAX resolves "auto" to XLA's);
* ``dense conv1(+relu+norm) only`` (``:132``): the dense CML's conv1 on
  the dense grid;
* ``column conv1(+relu+norm) only`` (``:134-137``, JAX's ``[im2col]``
  and ``[folded]``: the port has the folded form only):
  ``ColumnConv1ReluNorm``, which runs K1;
* ``full cml dense (from dense grid)`` (``:142``);
* ``conv2 d-minor only`` and ``conv3 d-minor only`` (``:156``, ``:162``):
  the column CML's conv2 on conv1's depth-minor output (with the
  relayout to channels-first that the column CML does before it) and
  conv3 on conv2's;
* ``rpn only`` (``:170``): the RPN on the (C, D)-folded CML output, run
  sample by sample as the model runs it;
* ``full cml column (from vfeat)`` (``:173``);
* ``full branch dense3d`` and ``full branch column`` (``:179``,
  ``:183``): the whole branch in each CML form, on one set of weights.

No row reads a count back to the host (``"syncs": false`` on K1's rows).
Times and records as in ``tools.bench_micro``.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_branch
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

STAGES = ("svfe->vfeat", "scatter only", "dense conv1(+relu+norm) only",
          "column conv1(+relu+norm) only",
          "full cml dense (from dense grid)", "conv2 d-minor only",
          "conv3 d-minor only", "rpn only", "full cml column (from vfeat)",
          "full branch dense3d", "full branch column")


def rows(cfg, model, batch) -> Iterator[Row]:
    """The rows of :data:`STAGES`: ``model`` is the column-CML LiDAR-only
    branch in the dtype it computes in, ``batch`` the voxelized frames
    (``train/step.frames_to_batch``) on its device."""
    import copy

    import torch

    from mvxnet_makise_tpu_torch.device import parameter_dtype
    from mvxnet_makise_tpu_torch.models.blocks import set_norm_scope
    from mvxnet_makise_tpu_torch.models.voxelnet import (
        make_cml,
        scatter_to_dense,
    )
    from mvxnet_makise_tpu_torch.train.step import lidar_inputs

    dtype = parameter_dtype(model)
    device = batch.coords.device
    B, V = batch.vmask.shape
    T, grid = cfg.samples_per_voxel, tuple(cfg.voxel_shape)
    pf7, kept, seg, counts, coords, vmask = lidar_inputs(batch, T)
    z0 = torch.zeros((B, V, pf7.shape[-1]), dtype=dtype, device=device)
    inputs = (pf7.to(dtype), kept, seg, counts, coords, vmask, z0)
    fields = {"dtype": str(dtype).removeprefix("torch.")}
    k1 = {**fields, "route": kernel_route(device), "syncs": False}
    cml = model.cml
    # the dense CML on the column CML's parameters and norm scope
    dense_model = copy.deepcopy(model)
    dense_model.cml = set_norm_scope(make_cml(
        "dense3d", cml.conv1.conv.weight.shape[1], grid, cml.conv1.eps,
        "auto"), cfg.norm_scope)
    dense_model.cml.load_state_dict(cml.state_dict())
    dense_model.to(device=device, dtype=dtype)
    dense_cml = dense_model.cml

    yield Row("svfe->vfeat", "svfe->vfeat", lambda: model.voxel_features(
        *inputs[:4], vmask, z0), fields)
    vfeat = model.voxel_features(*inputs[:4], vmask, z0)
    yield Row("scatter only", "scatter only", lambda: scatter_to_dense(
        vfeat, coords, vmask, grid, "auto"), fields)
    # (B, nz, nx, ny, C) read as (B, C, D, H, W), as MiddleConvLayers does
    xg = scatter_to_dense(vfeat, coords, vmask, grid,
                          "auto").permute(0, 4, 1, 2, 3)
    yield Row("dense conv1(+relu+norm) only", "dense conv1(+relu+norm) only",
              lambda: dense_cml.conv1(xg), fields)
    yield Row("column conv1(+relu+norm) only",
              ("column conv1(+relu+norm) only [im2col]",
               "column conv1(+relu+norm) only [folded]"),
              lambda: cml.conv1(vfeat, coords, vmask), k1)
    yield Row("full cml dense (from dense grid)",
              "full cml dense (from dense grid)",
              lambda: dense_cml.conv3(dense_cml.conv2(dense_cml.conv1(xg))),
              fields)
    del xg

    x1 = cml.conv1(vfeat, coords, vmask)          # (B, nx, ny, D, C)
    yield Row("conv2 d-minor only", "conv2 d-minor only",
              lambda: cml.conv2(x1.permute(0, 4, 3, 1, 2).contiguous()),
              fields)
    x2 = cml.conv2(x1.permute(0, 4, 3, 1, 2).contiguous())
    del x1
    yield Row("conv3 d-minor only", "conv3 d-minor only",
              lambda: cml.conv3(x2), fields)
    x3 = cml.conv3(x2)
    del x2
    _, C, D, H, W = x3.shape
    xr = x3.reshape(B, C * D, H, W)
    del x3
    yield Row("rpn only", "rpn only", lambda: model.rpn(xr)[0], fields)
    del xr

    yield Row("full cml column (from vfeat)", "full cml column (from vfeat)",
              lambda: cml(vfeat, coords, vmask), k1)
    del vfeat
    yield Row("full branch dense3d", "full branch dense3d",
              lambda: dense_model(*inputs)[0], fields)
    del dense_model, dense_cml
    yield Row("full branch column", "full branch column",
              lambda: model(*inputs)[0], k1)


def main(argv=None) -> int:
    args = tool_parser(iters=10).parse_args(argv)

    import dataclasses
    import torch

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    device = resolve_device(args.device)
    use_full_f32()
    cfg = make_config(args, batch_size=args.batch)
    model = build_model(dataclasses.replace(cfg, cml_mode="column"), seed=0,
                        device=device, with_images=False)
    if cfg.use_bf16:
        model = model.to(torch.bfloat16)
    batch = frames_to_batch(*synthetic_batch(cfg, device), cfg)
    print_rows(rows(cfg, model, batch), device, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
