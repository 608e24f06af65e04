#!/usr/bin/env python3
"""Time the port's column-merge kernels (K1, K3, K3's backward and K1's
backward) against other builds of ``csrc/column_merge.cu``, in turns, on
one CUDA card.

    python3 kernel_ab.py OTHER_CSRC [OTHER_CSRC ...]

Each ``OTHER_CSRC`` is a directory holding another ``column_merge.cu``
and any header it includes: for instance a parent commit's
``mvxnet_makise_tpu_torch/csrc``, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, or a copy with other block sizes.

Two suites, each on the arguments ``chip_smoke.py`` hands the kernels:
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
build's library swapped into one Detector in turns (``serve_suite``), then
the card's name and power limit.  Exits nonzero without a card or when a
build disagrees.
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


def build_others(dirs) -> dict:
    """One library per directory, one nvcc each, all started together;
    returns {directory: (library, ptxas report)}."""
    from mvxnet_makise_tpu_torch.ops.cuda_build import (
        BUILD_DIR,
        NVCC_FLAGS,
        nvcc_path,
    )

    os.makedirs(os.path.join(BUILD_DIR, "ab"), exist_ok=True)
    procs = {}
    for i, d in enumerate(dirs):
        out = os.path.join(BUILD_DIR, "ab", f"libcolumn_merge_{i}.so")
        procs[d] = out, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", out,
             os.path.join(d, "column_merge.cu")],
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


def main(other_dirs) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.ops import column_merge as cm
    from mvxnet_makise_tpu_torch.ops.cuda_build import stream_handle
    from mvxnet_makise_tpu_torch.serve import Detector

    others = build_others(other_dirs)
    libs = {d: lib for d, (lib, _) in others.items()}
    libs["this"] = cm.LIBRARY.library()
    for lib in libs.values():
        # the wrapper's signatures, for the serving suite
        for fn, argtypes in cm.LIBRARY.functions.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
        lib.kernel_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda", 0)
    stream = stream_handle(dev)
    cfg = Config()
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=dev)
    frames = cs.make_frames(cfg, cs.FRAMES, seed=0)[:cs.BATCH]
    merge_args, _, _ = cs.kernel_inputs(det, frames)
    det.close()
    del det, frames
    torch.cuda.empty_cache()
    ok = suite("float32", merge_args, cfg.voxel_shape, libs, others,
               other_dirs, stream)
    del merge_args
    torch.cuda.empty_cache()
    cfg16, merge_args, _, _, _ = cs.full_fusion_kernel_inputs(dev)
    torch.cuda.empty_cache()
    ok = suite("bfloat16", merge_args, cfg16.voxel_shape, libs, others,
               other_dirs, stream) and ok
    del merge_args
    torch.cuda.empty_cache()
    if ok:
        serve_suite(libs, other_dirs, dev)
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
