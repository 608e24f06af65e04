"""Measurement probes (subcommands) on the card.

Port of ``mvxnet_makise_tpu/tools/probe.py``:

  occupancy   BEV column occupancy and its 3x3 dilation per CML/RPN stage
              on KITTI-shaped synthetic frames: the input to any
              sparse or compacted formulation.
  tablecost   gather cost against source-table row count (ns/row, GB/s)
              with ``index_select`` on the card.
  rpn         time the RPN stage across the trunk shapes of
              :data:`RPN_VARIANTS` (``Config.rpn_channels`` /
              ``rpn_extra`` / ``rpn_deconv_channels``), in bfloat16, and
              count its GFLOP per frame from the convolution shapes.

``tools.gen_experiment`` and ``tools.bench`` take their ``--rpn`` trunks
from :data:`RPN_VARIANTS`.  Times are CUDA events around back-to-back
calls after a warm-up, on the card only.

Run:  python -m mvxnet_makise_tpu_torch.tools.probe <occupancy|tablecost|rpn>
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np

# trunk variants for the cheaper-RPN sweep: name -> (channels, extra,
# deconv_ch).  "reference" is the reference's trunk, the only one whose
# weights interchange with a reference checkpoint.
RPN_VARIANTS = {
    "reference": ((128, 128, 256), (3, 5, 5), 256),
    "extra333": ((128, 128, 256), (3, 3, 3), 256),
    "narrow96": ((96, 96, 192), (3, 5, 5), 192),
    "half": ((64, 64, 128), (3, 5, 5), 128),
    "half-extra333": ((64, 64, 128), (3, 3, 3), 128),
}


def rpn_fields(name: str) -> dict:
    """The Config fields of trunk ``name``; a ValueError names the known
    trunks."""
    if name not in RPN_VARIANTS:
        raise ValueError(f"unknown RPN trunk {name!r}: one of "
                         f"{sorted(RPN_VARIANTS)}")
    ch, ex, dc = RPN_VARIANTS[name]
    return dict(rpn_channels=ch, rpn_extra=ex, rpn_deconv_channels=dc)


def rpn_name(trunk: Tuple) -> str:
    """The name of a ``Config.rpn_trunk`` in :data:`RPN_VARIANTS`, or
    "custom"."""
    for name, t in RPN_VARIANTS.items():
        if tuple(trunk) == t:
            return name
    return "custom"


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` on the card: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
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


def _kitti_batch(B: int, device):
    import torch

    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.data.pipeline import (
        collate,
        preprocess_frame,
    )
    from mvxnet_makise_tpu_torch.data.synthetic import synthetic_frame
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    cfg = Config(use_bf16=True, batch_size=B)
    rng = np.random.default_rng(0)
    frames = [preprocess_frame(*synthetic_frame(rng, cfg), cfg)
              for _ in range(B)]
    fb = collate(frames)
    batch = frames_to_batch(torch.from_numpy(fb.points).to(device),
                            torch.from_numpy(fb.num_points).to(device),
                            torch.from_numpy(fb.image).to(device), cfg)
    return cfg, batch


def cmd_occupancy(args, device):
    cfg, batch = _kitti_batch(args.frames, device)
    nx, ny, _ = cfg.voxel_shape
    coords = batch.coords.cpu().numpy()
    vmask = batch.vmask.cpu().numpy()

    def dilate(occ):
        p = np.pad(occ, 1)
        out = np.zeros_like(occ)
        for dx in range(3):
            for dy in range(3):
                out |= p[dx:dx + occ.shape[0], dy:dy + occ.shape[1]]
        return out

    def downsample2(occ):
        h, w = occ.shape
        return occ[:h - h % 2, :w - w % 2].reshape(
            h // 2, 2, w // 2, 2).any(axis=(1, 3))

    print(f"== BEV column occupancy (B={args.frames}, KITTI-shaped) ==")
    rows = []
    for b in range(args.frames):
        occ = np.zeros((nx, ny), bool)
        c = coords[b][vmask[b]]
        occ[c[:, 0], c[:, 1]] = True
        stages = [("A0 active cols", occ)]
        for name in ("A1 after conv1", "A2 after conv2", "A3 after conv3"):
            occ = dilate(occ)
            stages.append((name, occ))
        # RPN footprint: each stride-2 block is one down conv and its
        # extras, all 3x3, at successively coarser grids
        rocc = occ
        for i, n_extra in enumerate(cfg.rpn_extra):
            rocc = downsample2(dilate(rocc))
            for _ in range(n_extra):
                rocc = dilate(rocc)
            stages.append((f"RPN blk{i + 1} ({rocc.shape[0]}x"
                           f"{rocc.shape[1]})", rocc))
        rows.append([(n, o.sum(), o.size) for n, o in stages])
    for i in range(len(rows[0])):
        name, _, tot = rows[0][i]
        m = np.mean([r[i][1] for r in rows])
        print(f"  {name:26s} {m:8.0f}  = {100 * m / tot:5.1f}% of {tot}")


def cmd_tablecost(args, device):
    import torch

    print(f"== gather vs table size ({torch.cuda.get_device_name(device)}) "
          f"==")
    n_idx = args.frames * 24576
    gen = torch.Generator(device=device).manual_seed(0)
    for rows in (2184, 8736, 34944, 139776):
        for width in (512, 1024):
            tab = torch.randn((rows, width), generator=gen, device=device,
                              dtype=torch.bfloat16)
            idx = torch.randint(0, rows, (n_idx,), generator=gen,
                                device=device)
            ms = _cuda_ms(lambda: torch.index_select(tab, 0, idx),
                          args.iters)
            dt = ms / 1e3
            print(f"  gather {n_idx} rows from ({rows:6d},{width}) "
                  f"{ms:8.3f} ms")
            print(f"    -> {dt / n_idx * 1e9:6.2f} ns/row, "
                  f"{n_idx * width * 2 / dt / 1e9:6.1f} GB/s")


def conv_flops(model, x) -> int:
    """Multiply-add FLOPs (2 per MAC) of every ``Conv2d`` and
    ``ConvTranspose2d`` in ``model`` on input ``x``, from the shapes one
    forward sees; the norms and activations are not counted."""
    import torch
    from torch import nn

    total = [0]

    def count(m, inp, out):
        # the weight holds one multiply-add per (input channel, output
        # channel, tap): a convolution does them at every output pixel, a
        # transposed one at every input pixel
        px = inp[0] if isinstance(m, nn.ConvTranspose2d) else out
        total[0] += 2 * px.shape[0] * px.shape[2] * px.shape[3] \
            * m.weight.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def cmd_rpn(args, device):
    import torch

    from mvxnet_makise_tpu_torch.models.voxelnet import RPN

    B = args.frames
    # the CML's output as the RPN takes it: 64 channels x depth 2 on the
    # 352x400 grid (models/voxelnet_pm.VoxelNetBranchPM)
    H, W, C = 352, 400, 128
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((B, C, H, W), generator=gen, device=device,
                    dtype=torch.bfloat16)
    print(f"== RPN trunk variants (B={B}, input {C}x{H}x{W}, bfloat16, "
          f"{torch.cuda.get_device_name(device)}) ==")
    base = None
    for name, trunk in RPN_VARIANTS.items():
        model = RPN(C, trunk=trunk).to(device, torch.bfloat16).eval()
        n_params = sum(p.numel() for p in model.parameters())
        flops = conv_flops(model, x[:1])
        with torch.no_grad():
            ms = _cuda_ms(lambda: model(x), args.iters)
        gf = flops / 1e9
        print(f"  {name:14s} ch={trunk[0]} extra={trunk[1]} dc={trunk[2]} "
              f"({n_params / 1e6:.1f}M par) {ms:8.2f} ms")
        print(f"    -> {gf:6.1f} GFLOP/frame, "
              f"{flops * B / (ms / 1e3) / 1e12:5.1f} TFLOP/s"
              + (f", {base / ms:.2f}x vs reference" if base else ""))
        if base is None:
            base = ms
        del model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.probe",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=("occupancy", "tablecost", "rpn"))
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default); occupancy also runs on cpu")
    args = p.parse_args(argv)

    from mvxnet_makise_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.cmd != "occupancy" and device.type != "cuda":
        p.error(f"{args.cmd} times the card: it needs --device cuda")
    {"occupancy": cmd_occupancy, "tablecost": cmd_tablecost,
     "rpn": cmd_rpn}[args.cmd](args, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
