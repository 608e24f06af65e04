"""Per-stage time of the training step.

Port of ``mvxnet_makise_tpu/tools/profile_train.py``, the training
companion of ``tools.profile_components``: the step split the way the
reference kept forward, loss and backward counters, then K1 and its
backward alone at the default grid with a KITTI-like count of active
columns.  Stages, each on inputs made once, after a warm-up:

* ``voxelize_assign``: ``frames_to_batch`` (with the training shuffle)
  and the anchor targets;
* ``loss_value``: forward and loss, no gradient;
* ``loss_grad``: forward, loss and backward;
* ``full_step``: the production step, voxelize and assign included
  (``train/step.make_train_step``: gradients and the AdamW update);
* ``merge_fwd`` and ``merge_fwd_plus_bwd``: K1 (``merge_taps_fused``) on
  bfloat16 taps of ``--active-cols`` sorted active columns per frame,
  and K1 with its backward (K1's first pass and K3's backward gather).

Then JAX's note line.  The configuration is ``Config(use_bf16=True)``
(``--config`` FILE instead); times as in ``tools.profile_components``
(CUDA events on the card, the host clock with ``--device cpu``).

Usage: python -m mvxnet_makise_tpu_torch.tools.profile_train
           [--batch N] [--iters N] [--active-cols N] [--config FILE]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from mvxnet_makise_tpu_torch.tools.profile_components import (
    Row,
    make_config,
    synthetic_batch,
    time_row,
)

STAGES = ("voxelize_assign", "loss_value", "loss_grad", "full_step",
          "merge_fwd", "merge_fwd_plus_bwd")
NOTE = {"note": "merge_bwd ms = fwd_plus_bwd - fwd"}


def merge_probe_inputs(cfg, batch: int, active_cols: int, device):
    """K1's arguments at ``cfg``'s grid: bfloat16 taps (B, V, 9, 64 * 5)
    of ``active_cols`` sorted random active columns per frame (seeded),
    the dead slots past them, and a zero bias."""
    import numpy as np
    import torch

    V = cfg.max_voxels
    nx, ny, nz = cfg.voxel_shape
    R = 64 * (nz // 2)
    nact = min(active_cols, V, nx * ny)
    rj = np.random.default_rng(1)
    cys, bnds = [], []
    for _ in range(batch):
        lin = np.sort(rj.choice(nx * ny, size=nact, replace=False))
        cx = np.full(V, nx, np.int32)
        cy = np.zeros(V, np.int32)
        cx[:nact] = lin // ny
        cy[:nact] = lin % ny
        cys.append(cy)
        bnds.append(np.searchsorted(cx, np.arange(nx + 1), side="left"))
    col_cy = torch.from_numpy(np.stack(cys)).to(device)
    bounds = torch.from_numpy(np.stack(bnds).astype(np.int32)).to(device)
    y = torch.from_numpy(rj.standard_normal((batch, V, 9, R))
                         .astype(np.float32)).to(device, torch.bfloat16)
    bias = torch.zeros((R,), dtype=torch.float32, device=device)
    return y, col_cy, bounds, bias


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--active-cols", type=int, default=10_500,
                   help="active BEV columns per frame for the isolated "
                        "merge probe (KITTI-shaped: 10.5k)")
    p.add_argument("--config", default=None,
                   help="a configuration file (default: Config(use_bf16="
                        "True)); --batch overrides it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    B = args.batch

    import torch

    from mvxnet_makise_tpu_torch.device import resolve_device
    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.ops.column_merge import merge_taps_fused
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import (
        _assign_batch,
        compute_loss,
        frames_to_batch,
        make_train_step,
    )

    device = resolve_device(args.device)
    cfg = make_config(args, batch_size=B)
    points, nums, images, gts, gms = synthetic_batch(cfg, device,
                                                     with_boxes=True)
    gcs = torch.zeros(gms.shape, dtype=torch.int32, device=device)
    gen = torch.Generator().manual_seed(0)
    perm = torch.stack([torch.randperm(cfg.max_points, generator=gen)
                        for _ in range(B)]).to(device)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(device)
    model = build_model(cfg, seed=0, device=device).train()
    state = TrainState.create(cfg, model)

    def make_batch():
        return frames_to_batch(points, nums, images, cfg, gt_boxes=gts,
                               gt_mask=gms, gt_classes=gcs, perm=perm)

    def stage(name, fn, flops=True):
        print(json.dumps(time_row(Row(name, name, fn, flops=flops), device,
                                  args.iters, batch=B)), flush=True)

    stage("voxelize_assign", lambda: _assign_batch(make_batch(), cfg),
          flops=False)

    batch = make_batch()
    targets = _assign_batch(batch, cfg)

    def loss_value():
        with torch.no_grad():
            return compute_loss(model, batch, targets, anchors, cfg)[0]

    def loss_grad():
        state.optimizer.zero_grad(set_to_none=True)
        loss = compute_loss(model, batch, targets, anchors, cfg)[0]
        loss.backward()
        return loss

    stage("loss_value", loss_value)
    stage("loss_grad", loss_grad)
    step = make_train_step(cfg, anchors)
    stage("full_step", lambda: step(state, make_batch()))

    # K1 alone, and K1 with its backward, at the configuration's grid
    y, col_cy, bounds, bias = merge_probe_inputs(cfg, B, args.active_cols,
                                                 device)
    with torch.no_grad():
        stage("merge_fwd", lambda: merge_taps_fused(
            y, col_cy, bounds, bias, cfg.voxel_shape)[0], flops=False)
    yg = y.detach().requires_grad_(True)

    def fwd_plus_bwd():
        out = merge_taps_fused(yg, col_cy, bounds, bias,
                               cfg.voxel_shape)[0]
        return torch.autograd.grad(out, yg, torch.ones_like(out))[0]

    stage("merge_fwd_plus_bwd", fwd_plus_bwd, flops=False)
    print(json.dumps(NOTE), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
