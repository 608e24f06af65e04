#!/usr/bin/env python3
"""Time the port's column-merge kernels (K1, K3, K3's backward and K1's
backward) and its dense voxel scatter (K4) against other builds of
``csrc/column_merge.cu`` and ``csrc/scatter_grid.cu``, in turns, on one
CUDA card.

    python3 kernel_ab.py OTHER_CSRC [OTHER_CSRC ...]

Each ``OTHER_CSRC`` is a directory holding another ``column_merge.cu``,
another ``scatter_grid.cu`` or both, and any header they include: for
instance a parent commit's ``mvxnet_makise_tpu_torch/csrc``, unpacked with
``git archive`` into a directory that ``.gitignore`` lists, or a copy with
other block sizes.  Each source is compared with the directories that
hold it; a directory with only ``scatter_grid.cu`` (and the header) runs
the K4 suites alone.

Column merge.  Two suites, each on the arguments ``chip_smoke.py`` hands
the kernels:
float32 on the full default ``Config`` (batch 4), bfloat16 on
``configs/full_fusion.yaml``'s Detector (batch 4, 32768 points,
``chip_smoke.full_fusion_kernel_inputs``).  K1 takes a seeded nonzero bias
(``chip_smoke.seeded_bias``).  Every build is first held against the plain
versions: K1's output exactly against ``chip_smoke.merge_reference`` (in
bfloat16 the float32 sum rounded once) and its row statistics within
``chip_smoke.TOL``; K3 and K3's backward exactly; K1's backward (the first
pass, pre and dbias, then K3's gather of pre) to ``_merge_fused_bwd``'s
formula on K1's output within ``chip_smoke.TOL``.  Then against this
build: K1's output and K1 backward's dy bit-identical, dbias within 1e-5
of the largest value; and against itself: K1 and K1 backward's first pass
the same bits twice.  Then every kernel is timed in the order others,
this, this, others reversed (CUDA events, ``chip_smoke.time_ms``): with
one other build, other, this, this, other.  ``column_merge_bwd`` is the
pair, ``column_merge_bwd_first`` its first pass alone.  A build without
``merge_launch_facts`` takes K1's entry point without the partials
buffer; one without ``merge_fused_bwd_facts`` takes one dbias partial row
per output row.  Prints one JSON line per build and suite with its errors,
launch records (grid, block, registers, blocks per SM) and ptxas report,
one per kernel and suite with every build's times and the one-call PyTorch
yardstick's (``chip_smoke.py`` gives the bounds), then one line of
``configs/full_fusion.yaml``'s ``detect_stream`` ms per frame with each
build's library swapped into one Detector in turns (``serve_suite``).

Dense voxel scatter.  Two suites: float32 on the voxel rows the default
``Config``'s CML hands K4 (batch 4, ``chip_smoke.kernel_inputs``) and
bfloat16 at ``tools.bench_kernels``' shapes (batch 8,
``chip_smoke.bench_scatter_inputs``).  Each build's forward entry point
is called as its wrapper calls it (:class:`K4Build`; a build whose entry
point takes sorted rows gets the sort and the chunk bounds its wrapper
computed, inside the timed call).  Every build's grid, written over NaN,
must equal the plain scatter's and this build's bit for bit, twice.
Then one call of each build under torch.profiler (its device operations,
their ms, the build's own kernels apart and any sort), and, in turns, the
whole call, the entry point alone on prepared arguments, and once each
the plain scatter, ``zeros`` + ``index_copy_`` and ``torch.zeros`` of the
grid.  Then the ``train_dense3d`` step of
``chip_smoke.py`` (``cml_mode="dense3d"``, ``scatter_backend="pallas"``,
float32, batch 2) with each build's forward swapped into the model in
turns (``dense3d_step_suite``): host ms per step.

Last, the card's name and power limit.  Exits nonzero without a card or
when a build disagrees.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("column_merge", "merge_taps", "merge_taps_bwd",
           "column_merge_bwd", "column_merge_bwd_first")


def build_others(dirs, source: str = "column_merge.cu") -> dict:
    """One library of ``source`` per directory, one nvcc each, all started
    together; returns {directory: (library, ptxas report)}."""
    from mvxnet_makise_tpu_torch.ops.cuda_build import (
        BUILD_DIR,
        NVCC_FLAGS,
        nvcc_path,
    )

    os.makedirs(os.path.join(BUILD_DIR, "ab"), exist_ok=True)
    name = os.path.splitext(source)[0]
    procs = {}
    for i, d in enumerate(dirs):
        out = os.path.join(BUILD_DIR, "ab", f"lib{name}_{i}.so")
        procs[d] = out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(d, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for d, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {d}:\n{log}")
        libs[d] = ctypes.CDLL(out), log
    return libs


def facts(lib, name: str, *args) -> int:
    """facts[1] of a build's launch-facts entry point, 1 without one."""
    if not hasattr(lib, name):
        return 1
    out = (ctypes.c_int * 2)()
    getattr(lib, name)(*args, out)
    return out[1]


def entry_points(lib: ctypes.CDLL, bufs: dict, shapes: tuple, suffix: str,
                 stream) -> dict:
    """The calls of one build on one suite's buffers, by kernel name."""
    from mvxnet_makise_tpu_torch.ops.cuda_build import ptr

    P, I = ctypes.c_void_p, ctypes.c_int
    with_partial = hasattr(lib, "merge_launch_facts")
    fused = getattr(lib, f"merge_fused_{suffix}")
    fused.argtypes = [P] * (7 if with_partial else 6) + [I] * 5 + [P]
    taps = getattr(lib, f"merge_taps_{suffix}")
    taps_bwd = getattr(lib, f"merge_taps_bwd_{suffix}")
    first = getattr(lib, f"merge_fused_bwd_{suffix}")
    taps.argtypes = taps_bwd.argtypes = [P] * 4 + [I] * 5 + [P]
    first.argtypes = [P] * 6 + [I] * 4 + [P]
    b = {k: ptr(v) for k, v in bufs.items()}
    B, V, nx, ny, R = shapes

    def call(fn, *args):
        def run():
            code = fn(*args, stream)
            if code:
                raise RuntimeError(
                    f"{fn.__name__} failed with CUDA error {code}")
        return run

    first_pass = call(first, b["k1_out"], b["g_out"], b["g_stats"],
                      b["pre"], b["partial_bwd"], b["dbias"], B, nx, ny, R)
    gather = call(taps_bwd, b["pre"], b["col_cy"], b["bounds"], b["dy_k1"],
                  B, V, nx, ny, R)

    def pair():
        first_pass()
        gather()
    return {"column_merge": call(
                fused, b["y"], b["col_cy"], b["bounds"], b["bias"],
                b["out"], b["stats"],
                *([b["partial"]] if with_partial else []), *shapes),
            "merge_taps": call(taps, b["y"], b["col_cy"], b["bounds"],
                               b["out"], *shapes),
            "merge_taps_bwd": call(taps_bwd, b["g"], b["col_cy"],
                                   b["bounds"], b["dy"], *shapes),
            "column_merge_bwd": pair,
            "column_merge_bwd_first": first_pass}


def suite(name: str, merge_args, grid, libs: dict, others: dict,
          other_dirs, stream) -> bool:
    """Check, then time, every build on one suite's arguments; True when
    every build agrees."""
    import torch

    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.ops import column_merge as cm
    from mvxnet_makise_tpu_torch.ops.cuda_build import read_launches

    y, col_cy, bounds, _ = merge_args
    dev = y.device
    dtype = y.dtype
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    tol_bwd = cs.TOL["column_merge_bwd" + ("_bf16" if suffix == "bf16"
                                           else "")]
    tol_k1 = cs.TOL["column_merge" + ("_bf16" if suffix == "bf16" else "")]
    nx, ny = grid[0], grid[1]
    B, V, _, R = y.shape
    es = y.element_size()
    bias = cs.seeded_bias(y)
    # scratch for the build that needs most
    tiles = max(facts(lib, "merge_launch_facts", 1, es, ny, R)
                for lib in libs.values())
    segments = max(facts(lib, "merge_fused_bwd_facts", es, ny, R)
                   for lib in libs.values())
    gen = torch.Generator(device=dev).manual_seed(0)
    want_out, want_stats = cs.merge_reference(y, col_cy, bounds, bias, grid)
    g_out = torch.randn(want_out.shape, generator=gen, device=dev).to(dtype)
    g_stats = torch.randn(want_stats.shape, generator=gen, device=dev) * 0.1
    bufs = {"y": y, "col_cy": col_cy, "bounds": bounds, "bias": bias,
            "out": torch.empty((B, nx, ny, R), dtype=dtype, device=dev),
            "stats": torch.empty((B, nx, 2, R), device=dev),
            "partial": torch.empty((B, nx, tiles, 2, R), device=dev),
            "g": torch.randn((B, nx, ny, R), device=dev, generator=torch
                             .Generator(device=dev).manual_seed(1)
                             ).to(dtype),
            "dy": torch.empty_like(y),
            "k1_out": want_out, "g_out": g_out, "g_stats": g_stats,
            "pre": torch.empty_like(want_out),
            "partial_bwd": torch.empty((B, nx, segments, R), device=dev),
            "dbias": torch.empty((R,), device=dev),
            "dy_k1": torch.empty_like(y)}
    shapes = (B, V, nx, ny, R)
    calls = {n: entry_points(lib, bufs, shapes, suffix, stream)
             for n, lib in libs.items()}

    want_merged = cm.merge_taps_plain(y, col_cy, bounds, grid)
    yp = y.detach().requires_grad_()
    merged_p = cm.merge_taps_plain(yp, col_cy, bounds, grid)
    (want_dy,) = torch.autograd.grad(merged_p, yp, bufs["g"],
                                     retain_graph=True)
    o = want_out.float()
    want_pre = ((g_out.float() + g_stats[:, :, 0, None].to(dtype).float()
                 + 2 * o * g_stats[:, :, 1, None].to(dtype).float())
                * (o > 0)).to(dtype)
    (want_dy_k1,) = torch.autograd.grad(merged_p, yp, want_pre)
    want_dbias = want_pre.float().sum((0, 1, 2))
    del o, want_pre, merged_p, yp

    def launch_record(n):
        lib = libs[n]
        return read_launches(lib) if hasattr(lib, "last_launches") else None

    checks, results = {}, {}
    for n, c in calls.items():
        launch = {}
        c["column_merge"]()
        launch["column_merge"] = launch_record(n)
        out, stats = bufs["out"].clone(), bufs["stats"].clone()
        c["column_merge"]()
        torch.cuda.synchronize()
        k1_twice = (torch.equal(out, bufs["out"])
                    and torch.equal(stats, bufs["stats"]))
        err_out = cs.rel_err(out, want_out)[0]
        err_stats = cs.rel_err(stats, want_stats)[1]
        c["merge_taps"]()
        launch["merge_taps"] = launch_record(n)
        torch.cuda.synchronize()
        err_merged = cs.rel_err(bufs["out"], want_merged)[0]
        c["merge_taps_bwd"]()
        launch["merge_taps_bwd"] = launch_record(n)
        torch.cuda.synchronize()
        err_dy = cs.rel_err(bufs["dy"], want_dy)[0]
        c["column_merge_bwd_first"]()
        launch["column_merge_bwd"] = launch_record(n)
        pre, dbias = bufs["pre"].clone(), bufs["dbias"].clone()
        c["column_merge_bwd"]()
        torch.cuda.synchronize()
        first_twice = (torch.equal(pre, bufs["pre"])
                       and torch.equal(dbias, bufs["dbias"]))
        dy_k1 = bufs["dy_k1"].clone()
        results[n] = (out, dy_k1, dbias)
        checks[n] = {
            "column_merge": err_out, "column_merge_stats_rel": err_stats,
            "column_merge_same_twice": k1_twice,
            "merge_taps": err_merged, "merge_taps_bwd": err_dy,
            "column_merge_bwd_dy_rel": cs.rel_err(dy_k1, want_dy_k1)[1],
            "column_merge_bwd_dbias_rel": cs.rel_err(dbias, want_dbias)[1],
            "column_merge_bwd_first_same_twice": first_twice}
        del pre, stats
        ptxas = [ln.strip() for ln in (others[n][1] if n in others else
                                       cm.LIBRARY.build_log).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(json.dumps({"suite": name, "build": n, "errors": checks[n],
                          "launch": launch, "ptxas": ptxas}), flush=True)
    this_out, this_dy, this_dbias = results["this"]
    for n, (out, dy_k1, dbias) in results.items():
        checks[n]["column_merge_equals_this"] = torch.equal(out, this_out)
        checks[n]["column_merge_bwd_dy_equals_this"] = torch.equal(
            dy_k1, this_dy)
        checks[n]["column_merge_bwd_dbias_vs_this"] = cs.rel_err(
            dbias, this_dbias)[1]
    print(json.dumps({"suite": name, "builds_vs_this": {
        n: {k: v for k, v in e.items() if "this" in k}
        for n, e in checks.items()}}), flush=True)
    del results, this_out, this_dy, this_dbias
    bad = [n for n, e in checks.items()
           if e["column_merge"] or e["merge_taps"] or e["merge_taps_bwd"]
           or e["column_merge_stats_rel"] > tol_k1["stats"]
           or not e["column_merge_same_twice"]
           or e["column_merge_bwd_dy_rel"] > tol_bwd["dy"]
           or e["column_merge_bwd_dbias_rel"] > tol_bwd["dbias"]
           or not e["column_merge_bwd_first_same_twice"]
           or not e["column_merge_equals_this"]
           or not e["column_merge_bwd_dy_equals_this"]
           or e["column_merge_bwd_dbias_vs_this"] > 1e-5]
    if bad:
        print(f"kernel_ab: {name}: builds disagree: {bad}", file=sys.stderr)
        return False
    del want_out, want_stats, want_merged, want_dy, want_dy_k1, want_dbias

    dest, acc = cs.merge_index_add(y, col_cy, bounds, grid)
    rows = y.reshape(-1, R)
    gpad = torch.cat([bufs["g"].reshape(-1, R), bufs["g"].new_zeros(1, R)])
    index_add = ("Tensor.index_add_", lambda: acc.index_add_(0, dest, rows))
    library = {"column_merge": index_add, "merge_taps": index_add,
               "merge_taps_bwd": ("torch.index_select (zero-padded "
                                  "cotangent)",
                                  lambda: torch.index_select(gpad, 0, dest)),
               "column_merge_bwd": (None, None),
               "column_merge_bwd_first": (None, None)}
    order = list(other_dirs) + ["this", "this"] + list(other_dirs)[::-1]
    for kernel in KERNELS:
        times = {n: [] for n in libs}
        for n in order:
            times[n].append(cs.time_ms(calls[n][kernel]))
        lib_call, lib_fn = library[kernel]
        print(json.dumps({
            "suite": name, "kernel": kernel, "ms": times, "order": order,
            "mean_ms": {n: sum(t) / len(t) for n, t in times.items()},
            "library_call": lib_call,
            "library_ms": cs.time_ms(lib_fn) if lib_fn else None}),
            flush=True)
    return True


def serve_suite(libs: dict, other_dirs, device, rounds: int = 4,
                runs: int = 3) -> None:
    """``configs/full_fusion.yaml``'s ``detect_stream`` (8 frames, batch 4,
    random weights) with each build's column-merge library swapped into one
    Detector, in turns (others then this, reversed every other round),
    ``runs`` streams per turn: ms per frame.  Host-bound serving moves with
    the host between calls; one process and one Detector leave the build as
    the only difference.  Builds without ``merge_launch_facts`` are left
    out (the wrapper needs it)."""
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.ops import column_merge as cm
    from mvxnet_makise_tpu_torch.serve import Detector

    usable = [n for n in list(other_dirs) + ["this"]
              if hasattr(libs[n], "merge_launch_facts")]
    with tempfile.TemporaryDirectory() as work:
        cfg = load_config(cs.config_yaml(work, "full_fusion"))
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=device)
    frames = cs.make_frames(cfg, cs.FRAMES, seed=4)
    ms = {n: [] for n in usable}
    try:
        for r in range(rounds):
            for n in usable if r % 2 == 0 else usable[::-1]:
                cm.LIBRARY._lib = libs[n]
                for _ in range(runs):
                    ms[n].append(cs.serve_stream(
                        det, frames, cfg.batch_size,
                        [])["detect_stream_ms_per_frame"])
    finally:
        cm.LIBRARY._lib = libs["this"]
        det.close()
    print(json.dumps({"suite": "full_fusion detect_stream",
                      "ms_per_frame": ms,
                      "median": {n: float(np.median(v))
                                 for n, v in ms.items()}}), flush=True)


class K4Build:
    """One build's K4 forward entry point, called as that build's wrapper
    calls it.  A build whose ``scatter_grid`` takes sorted rows (the
    ``sorted_cell`` form) gets what its wrapper computed first: the
    cells sorted per frame (masked rows keyed past every cell) and the
    first sorted row of each chunk of ``SORTED_CHUNK`` cells."""

    SORTED_CHUNK = 256

    def __init__(self, lib, source: str, stream):
        P, I = ctypes.c_void_p, ctypes.c_int
        with open(source) as f:
            self.sorted_rows = "sorted_cell" in f.read()
        lib.scatter_grid.argtypes = ([P] * 5 + [I] * 5 + [P]
                                     if self.sorted_rows
                                     else [P] * 4 + [I] * 6 + [P])
        lib.scatter_grid.restype = ctypes.c_int
        self.lib, self.stream = lib, stream

    def prepare(self, coords, mask, grid_shape):
        """The sorted form's (order, sorted cells, chunk starts), else
        None."""
        import torch

        if not self.sorted_rows:
            return None
        nx, ny, nz = grid_shape
        B = mask.shape[0]
        cell = coords[..., 2] * (nx * ny) + coords[..., 0] * ny \
            + coords[..., 1]
        cell = torch.where(mask, cell, torch.full_like(cell, 2 ** 31 - 1))
        sorted_cell, order = torch.sort(cell.to(torch.int32), dim=1)
        n_chunks = -(-nx * ny * nz // self.SORTED_CHUNK)
        edges = torch.arange(0, (n_chunks + 1) * self.SORTED_CHUNK,
                             self.SORTED_CHUNK, dtype=torch.int32,
                             device=coords.device)
        starts = torch.searchsorted(
            sorted_cell, edges.expand(B, n_chunks + 1).contiguous()
        ).to(torch.int32)
        return order.to(torch.int32), sorted_cell, starts

    def launch(self, features, coords, mask, grid, grid_shape, prepared):
        from mvxnet_makise_tpu_torch.ops.cuda_build import ptr

        nx, ny, nz = grid_shape
        B, V, C = features.shape
        row_bytes = C * features.element_size()
        if self.sorted_rows:
            order, sorted_cell, starts = prepared
            code = self.lib.scatter_grid(
                ptr(features), ptr(order), ptr(sorted_cell), ptr(starts),
                ptr(grid), B, V, nx * ny * nz, self.SORTED_CHUNK, row_bytes,
                self.stream)
        else:
            code = self.lib.scatter_grid(
                ptr(features), ptr(coords), ptr(mask), ptr(grid), B, V, nx,
                ny, nz, row_bytes, self.stream)
        if code:
            raise RuntimeError(f"scatter_grid failed with CUDA error {code}")

    def __call__(self, features, coords, mask, grid_shape, grid=None):
        import torch

        nx, ny, nz = grid_shape
        prepared = self.prepare(coords, mask, grid_shape)
        if grid is None:
            grid = torch.empty(
                (features.shape[0], nz, nx, ny, features.shape[-1]),
                dtype=features.dtype, device=features.device)
        self.launch(features, coords, mask, grid, grid_shape, prepared)
        return grid


def scatter_suite(name: str, scatter_args, grid_shape, builds: dict,
                  other_dirs) -> bool:
    """Check, then time, every K4 build on one suite's arguments; True
    when every build's grid is the plain scatter's, bit for bit."""
    import torch

    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.ops.scatter import scatter_voxels_to_grid

    feats, coords, mask = scatter_args
    nx, ny, nz = grid_shape
    B, V, C = feats.shape
    n_cells = nx * ny * nz
    shape = (B, nz, nx, ny, C)
    want = scatter_voxels_to_grid(feats, coords, mask, grid_shape)
    checks, this_grid = {}, None
    for n in ["this"] + list(other_dirs):
        grids = []
        for _ in range(2):
            grid = torch.full(shape, float("nan"), dtype=feats.dtype,
                              device=feats.device)
            builds[n](feats, coords, mask, grid_shape, grid)
            grids.append(grid)
        torch.cuda.synchronize()
        if n == "this":
            this_grid = grids[0]
        checks[n] = {"equals_plain": bool(torch.equal(grids[0], want)),
                     "same_twice": bool(torch.equal(grids[0], grids[1])),
                     "equals_this": bool(torch.equal(grids[0], this_grid)),
                     "sorted_rows": builds[n].sorted_rows}
        del grids
    del want, this_grid
    torch.cuda.empty_cache()
    print(json.dumps({"suite": name, "kernel": "scatter_grid",
                      "features": list(feats.shape),
                      "dtype": str(feats.dtype), "valid_rows": int(
                          mask.sum()), "builds": checks}), flush=True)
    if not all(c["equals_plain"] and c["same_twice"] and c["equals_this"]
               for c in checks.values()):
        print(f"kernel_ab: {name}: K4 builds disagree: {checks}",
              file=sys.stderr)
        return False

    # one call of each build under torch.profiler: its device operations
    windows = {}
    for n, b in builds.items():
        ops = cs.device_ops(lambda: b(feats, coords, mask, grid_shape))
        kernel = [o["ms"] for o in ops if "scatter" in o["name"]]
        windows[n] = {"device_ops": len(ops),
                      "device_ms": sum(o["ms"] for o in ops),
                      "scatter_kernels_ms": kernel,
                      "other_ms": sum(o["ms"] for o in ops)
                      - sum(kernel),
                      "sorts": sum("sort" in o["name"].lower()
                                   for o in ops),
                      "ops": ops}
    print(json.dumps({"suite": name, "kernel": "scatter_grid",
                      "profiler_window": windows}), flush=True)

    fixed = {n: (b.prepare(coords, mask, grid_shape),
                 torch.empty(shape, dtype=feats.dtype, device=feats.device))
             for n, b in builds.items()}

    def alone(n):
        prepared, grid = fixed[n]
        return lambda: builds[n].launch(feats, coords, mask, grid,
                                        grid_shape, prepared)

    order = list(other_dirs) + ["this", "this"] + list(other_dirs)[::-1]
    ms = {n: [] for n in builds}
    kernel_ms = {n: [] for n in builds}
    for n in order:
        ms[n].append(cs.time_ms(
            lambda: builds[n](feats, coords, mask, grid_shape)))
        kernel_ms[n].append(cs.time_ms(alone(n)))
    del fixed
    torch.cuda.empty_cache()
    cell = coords[..., 2] * (nx * ny) + coords[..., 0] * ny + coords[..., 1]
    frame = torch.arange(B, device=feats.device)[:, None]
    flat = (frame * (n_cells + 1)
            + torch.where(mask, cell, n_cells)).reshape(-1)
    rows = feats.reshape(-1, C)
    print(json.dumps({
        "suite": name, "kernel": "scatter_grid", "order": order,
        "ms": ms, "mean_ms": {n: sum(t) / len(t) for n, t in ms.items()},
        "kernel_ms": kernel_ms,
        "kernel_mean_ms": {n: sum(t) / len(t)
                           for n, t in kernel_ms.items()},
        "plain_ms": cs.time_ms(lambda: scatter_voxels_to_grid(
            feats, coords, mask, grid_shape), iters=3, warmup=1),
        "library_call": "torch.zeros(...).index_copy_",
        "library_ms": cs.time_ms(lambda: torch.zeros(
            (B * (n_cells + 1), C), dtype=feats.dtype,
            device=feats.device).index_copy_(0, flat, rows)),
        "zero_fill_ms": cs.time_ms(lambda: torch.zeros(
            shape, dtype=feats.dtype, device=feats.device)),
        "bound_ms": cs.bound_of(B * n_cells * C * feats.element_size()
                                + int(mask.sum()) * C
                                * feats.element_size()
                                + coords.numel() * 4 + mask.numel(),
                                0)[0]}), flush=True)
    return True


def swapped_scatter(build):
    """``ops/scatter_grid.scatter_to_grid`` with ``build``'s forward: an
    autograd Function whose backward is this build's (the same kernel in
    every build)."""
    import torch

    from mvxnet_makise_tpu_torch.ops import scatter_grid as sg

    class Swapped(torch.autograd.Function):
        @staticmethod
        def forward(ctx, features, coords, mask, grid_shape):
            ctx.save_for_backward(coords, mask)
            ctx.grid_shape = grid_shape
            return build(features, coords, mask, grid_shape)

        @staticmethod
        def backward(ctx, g):
            coords, mask = ctx.saved_tensors
            return (sg.scatter_to_grid_backward(g, coords, mask,
                                                ctx.grid_shape),
                    None, None, None)

    return lambda f, c, m, gs: Swapped.apply(f, c, m, tuple(gs))


def dense3d_step_suite(builds: dict, other_dirs, device, rounds: int = 4,
                       steps: int = 3) -> None:
    """``chip_smoke.py``'s ``train_dense3d`` step (``cml_mode="dense3d"``,
    ``scatter_backend="pallas"``, float32, batch ``DENSE_BATCH``, seed-0
    weights, one fixed batch) with each build's K4 forward swapped into the
    model, in turns (others then this, reversed every other round),
    ``steps`` steps per turn: host ms per step, each ending in a
    synchronize."""
    import tempfile

    import numpy as np
    import torch

    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.models import voxelnet
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.train.loop import (
        build_model_and_state,
        make_full_train_step,
    )

    cfg = Config(batch_size=cs.DENSE_BATCH, cml_mode="dense3d",
                 scatter_backend="pallas",
                 checkpoint_dir=tempfile.mkdtemp(prefix="kernel_ab_"))
    _, state = build_model_and_state(cfg, device=device, seed=0)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(device)
    step = make_full_train_step(cfg, anchors)
    batch = cs.fixed_batch(cfg, cs.make_train_frames(cfg, cfg.batch_size,
                                                     seed=1), device)
    names = list(other_dirs) + ["this"]
    swapped = {n: swapped_scatter(builds[n]) for n in names}
    original = voxelnet.scatter_to_grid
    ms = {n: [] for n in names}
    try:
        cs.timed_steps(step, state, batch, 2)      # warm-up
        for r in range(rounds):
            for n in names if r % 2 == 0 else names[::-1]:
                voxelnet.scatter_to_grid = swapped[n]
                ms[n] += cs.timed_steps(step, state, batch, steps)[1]
    finally:
        voxelnet.scatter_to_grid = original
    print(json.dumps({"suite": "train_dense3d step", "batch": cfg.batch_size,
                      "ms_per_step": ms,
                      "median": {n: float(np.median(v))
                                 for n, v in ms.items()}}), flush=True)


def main(other_dirs) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.ops import scatter_grid as sg
    from mvxnet_makise_tpu_torch.ops.cuda_build import stream_handle
    from mvxnet_makise_tpu_torch.serve import Detector

    merge_dirs, scatter_dirs = (
        [d for d in other_dirs if os.path.exists(os.path.join(d, source))]
        for source in ("column_merge.cu", "scatter_grid.cu"))
    if not merge_dirs and not scatter_dirs:
        print("kernel_ab: no column_merge.cu or scatter_grid.cu in "
              f"{other_dirs}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    stream = stream_handle(dev)
    cfg = Config()
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=dev)
    frames = cs.make_frames(cfg, cs.FRAMES, seed=0)[:cs.BATCH]
    merge_args, _, scatter_args = cs.kernel_inputs(det, frames)
    det.close()
    del det, frames
    torch.cuda.empty_cache()
    ok = True
    if merge_dirs:
        ok = merge_suites(merge_args, cfg, merge_dirs, dev, stream)
    del merge_args
    torch.cuda.empty_cache()
    if scatter_dirs:
        others = build_others(scatter_dirs, "scatter_grid.cu")
        builds = {d: K4Build(lib, os.path.join(d, "scatter_grid.cu"), stream)
                  for d, (lib, _) in others.items()}
        builds["this"] = K4Build(sg.LIBRARY.library(), sg.LIBRARY.source,
                                 stream)
        print(json.dumps({"kernel": "scatter_grid", "ptxas": {
            n: [ln.strip() for ln in (others[n][1] if n in others
                                      else sg.LIBRARY.build_log).splitlines()
                if "registers" in ln or "spill" in ln]
            for n in builds}}), flush=True)
        ok = scatter_suite("float32", scatter_args, cfg.voxel_shape, builds,
                           scatter_dirs) and ok
        del scatter_args
        torch.cuda.empty_cache()
        bench_args, bench_grid = cs.bench_scatter_inputs(dev)
        ok = scatter_suite("bfloat16 bench_kernels", bench_args, bench_grid,
                           builds, scatter_dirs) and ok
        del bench_args
        torch.cuda.empty_cache()
        if ok:
            dense3d_step_suite(builds, scatter_dirs, dev)
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


def merge_suites(merge_args, cfg, other_dirs, dev, stream) -> bool:
    """The column merge's float32 and bfloat16 suites and, when every
    build agrees, the serving suite."""
    import torch

    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.ops import column_merge as cm

    others = build_others(other_dirs)
    libs = {d: lib for d, (lib, _) in others.items()}
    libs["this"] = cm.LIBRARY.library()
    for lib in libs.values():
        # the wrapper's signatures, for the serving suite
        for fn, argtypes in cm.LIBRARY.functions.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
        lib.kernel_error_string.restype = ctypes.c_char_p
    ok = suite("float32", merge_args, cfg.voxel_shape, libs, others,
               other_dirs, stream)
    torch.cuda.empty_cache()
    cfg16, merge16, _, _, _ = cs.full_fusion_kernel_inputs(dev)
    torch.cuda.empty_cache()
    ok = suite("bfloat16", merge16, cfg16.voxel_shape, libs, others,
               other_dirs, stream) and ok
    del merge16
    torch.cuda.empty_cache()
    if ok:
        serve_suite(libs, other_dirs, dev)
    return ok


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
