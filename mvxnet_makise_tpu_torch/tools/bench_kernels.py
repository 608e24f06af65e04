"""Kernel micro-benchmarks: the dense-grid scatter, the voxelizer and the
FPN gather, each alone on synthetic inputs.

Port of ``mvxnet_makise_tpu/tools/bench_kernels.py``, with its shapes per
frame and ``--batch`` frames per call (the port's ops take a leading
frame axis).  Rows, in order (``BENCHES``):

* ``scatter_xla`` (JAX ``:72``): the plain scatter,
  ``ops/scatter.scatter_voxels_to_grid``, of V = ``max_voxels`` rows of
  128 channels into the default grid, 80 % of them live, at cells drawn
  without replacement;
* ``scatter_pallas`` (``:78``): K4, ``ops/scatter_grid.scatter_to_grid``,
  on the same rows.  JAX's ``try``/``except`` around its Pallas path is
  not carried over: a failure of the kernel fails the tool;
* ``voxelize`` (``:93``): ``ops/voxelize.voxelize`` of ``max_points``
  random points per frame, all valid;
* ``fpn_gather`` (``:110``): K2, ``ops/gather.fpn_gather``, of three
  256-channel levels at the pyramid's strides 4, 8 and 16 (104x336,
  52x168 and 26x84 at the default image size and min side, JAX's
  constants) at ``max_voxels`` x ``samples_per_voxel`` points, half of
  them valid.

The configuration is ``Config()`` (``--config`` FILE instead), the scatter
and gather tensors in ``--dtype`` (bfloat16, as JAX's default).  Times as
in ``tools.profile_components``: CUDA events on the card, the host clock
with ``--device cpu``, where the kernels' rows run their plain versions.
One JSON record per row: ``kernel``, ``jax``, ``ms_per_batch``,
``device``, ``first_call_s``, ``dtype``, JAX's ``GBps`` (the grid's
bytes) or ``Mpts_per_s``, and ``route`` ("cuda" or "plain") on the
kernels' rows.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_kernels
           [--batch N] [--iters N] [--dtype bfloat16|float32]
           [--config FILE] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Iterator

from mvxnet_makise_tpu_torch.tools.profile_components import (
    Row,
    kernel_route,
    print_rows,
    tool_parser,
)

# the rows, in order (JAX's benchmark names)
BENCHES = ("scatter_xla", "scatter_pallas", "voxelize", "fpn_gather")
# the scatter's channels (JAX's ``C = 128``)
CHANNELS = 128
LIVE_SHARE = 0.8


def rows(cfg, device, dtype, batch: int) -> Iterator[Row]:
    """The rows of :data:`BENCHES` on inputs drawn from seed 0."""
    import functools

    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.models.image_head import (
        gather_image_size,
        transform_output_shape,
    )
    from mvxnet_makise_tpu_torch.ops.gather import fpn_gather
    from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid
    from mvxnet_makise_tpu_torch.ops.scatter_grid import scatter_to_grid
    from mvxnet_makise_tpu_torch.ops.voxelize import voxelize

    rng = np.random.default_rng(0)
    B, V, C = batch, cfg.max_voxels, CHANNELS
    nx, ny, nz = grid = tuple(cfg.voxel_shape)
    n_cells = nx * ny * nz
    name = str(dtype).removeprefix("torch.")
    route = {"route": kernel_route(device), "dtype": name}

    def put(a, dt=None):
        return torch.as_tensor(a, dtype=dt).to(device)

    feats = put(rng.normal(size=(B, V, C)), dtype)
    flat = np.stack([rng.choice(n_cells, V, replace=False)
                     for _ in range(B)])
    coords = put(np.stack([flat // (ny * nz), (flat // nz) % ny, flat % nz],
                          axis=-1), torch.int32)
    mask = put(np.tile(np.arange(V) < int(V * LIVE_SHARE), (B, 1)))
    grid_gb = {"GBps": B * n_cells * C * feats.element_size() / 1e9}
    args = (feats, coords, mask, grid)
    yield Row("scatter_xla", "scatter_xla",
              functools.partial(scatter_voxels_to_grid, *args),
              {"dtype": name}, grid_gb, flops=False)
    yield Row("scatter_pallas", "scatter_pallas",
              functools.partial(scatter_to_grid, *args), route, grid_gb,
              flops=False)
    del feats, coords, mask, args

    P = cfg.max_points
    pts = rng.normal(size=(B, P, 6))
    pts[..., 0] = np.abs(pts[..., 0]) * 10
    pts = put(pts, torch.float32)
    nums = put(np.full(B, P), torch.int32)
    yield Row("voxelize", "voxelize", lambda: voxelize(
        pts, nums, velo_range=cfg.velo_range, voxel_size=cfg.voxel_size,
        grid_shape=grid, max_voxels=V,
        samples_per_voxel=cfg.samples_per_voxel).sorted_points,
        {"dtype": "float32"}, {"Mpts_per_s": B * P / 1e6}, flops=False)
    del pts, nums

    _, (ph, pw) = transform_output_shape(cfg.image_size, cfg.image_min_side)
    levels = [put(rng.normal(size=(B, ph // s, pw // s, 256)), dtype)
              for s in (4, 8, 16)]
    T = cfg.samples_per_voxel
    rc = put(rng.uniform(0, 300, (B, V * T, 2)), torch.float32)
    valid = put(rng.random((B, V * T)) < 0.5)
    size = gather_image_size(cfg.image_size, cfg.image_min_side)
    yield Row("fpn_gather", "fpn_gather",
              functools.partial(fpn_gather, levels, rc, valid, size), route,
              {"Mpts_per_s": B * V * T / 1e6}, flops=False)


def main(argv=None) -> int:
    p = tool_parser(iters=20)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    import torch

    from mvxnet_makise_tpu_torch.config import Config, load_config
    from mvxnet_makise_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = (load_config(args.config) if args.config else Config())
    print_rows(rows(cfg, device, getattr(torch, args.dtype), args.batch),
               device, args.iters, key="kernel")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
