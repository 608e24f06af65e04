#!/usr/bin/env python3
"""Time the port's column-merge kernels (K1, K3 and K3's backward) against
other builds of ``csrc/column_merge.cu``, in turns, on one CUDA card.

    python3 kernel_ab.py OTHER_CSRC [OTHER_CSRC ...]

Each ``OTHER_CSRC`` is a directory holding another ``column_merge.cu``
and any header it includes: for instance a parent commit's
``mvxnet_makise_tpu_torch/csrc``, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, or a copy with other block sizes.
Every build gets the inputs that ``chip_smoke.py`` hands K1 and K3 (full
default ``Config``, batch 4).  Each is first held against the plain
versions (K1's and K3's outputs and K3's backward exact, K1's row
statistics within ``chip_smoke.TOL``, K1 the same bits twice), then
timed in the order others, this, this, others reversed (CUDA events,
``chip_smoke.time_ms``): with one other build, other, this, this, other.
A build without ``merge_launch_facts`` takes K1's entry point without the
partials buffer.  Prints one JSON line per build with its errors and
registers, one per kernel with every build's times and the one-call
PyTorch yardstick's (``chip_smoke.py`` gives the bounds), then the card's
name and power limit.  Exits nonzero without a card or when a build
disagrees with the plain versions.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


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


def entry_points(lib: ctypes.CDLL, bufs: dict, shapes: tuple,
                 stream) -> dict:
    """K1, K3 and K3-backward calls of one build on float32 buffers."""
    from mvxnet_makise_tpu_torch.ops.cuda_build import ptr

    P, I = ctypes.c_void_p, ctypes.c_int
    with_partial = hasattr(lib, "merge_launch_facts")
    lib.merge_fused_f32.argtypes = \
        [P] * (7 if with_partial else 6) + [I] * 5 + [P]
    lib.merge_taps_f32.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.merge_taps_bwd_f32.argtypes = [P] * 4 + [I] * 5 + [P]
    b = {k: ptr(v) for k, v in bufs.items()}
    fused = [b["y"], b["col_cy"], b["bounds"], b["bias"], b["out"],
             b["stats"]] + ([b["partial"]] if with_partial else [])

    def call(fn, *args):
        def run():
            code = fn(*args, *shapes, stream)
            if code:
                raise RuntimeError(
                    f"{fn.__name__} failed with CUDA error {code}")
        return run
    return {"column_merge": call(lib.merge_fused_f32, *fused),
            "merge_taps": call(lib.merge_taps_f32, b["y"], b["col_cy"],
                               b["bounds"], b["out"]),
            "merge_taps_bwd": call(lib.merge_taps_bwd_f32, b["g"],
                                   b["col_cy"], b["bounds"], b["dy"])}


def main(other_dirs) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mvxnet_makise_tpu_torch.config import Config
    from mvxnet_makise_tpu_torch.ops import column_merge as cm
    from mvxnet_makise_tpu_torch.ops.cuda_build import (
        read_launches,
        stream_handle,
    )
    from mvxnet_makise_tpu_torch.serve import Detector

    others = build_others(other_dirs)
    libs = {d: lib for d, (lib, _) in others.items()}
    libs["this"] = cm.LIBRARY.library()
    dev = torch.device("cuda", 0)
    cfg = Config()
    det = Detector.create(cfg, checkpoint_epoch=0, seed=0, device=dev)
    frames = cs.make_frames(cfg, cs.FRAMES, seed=0)[:cs.BATCH]
    (y, col_cy, bounds, bias), _, _ = cs.kernel_inputs(det, frames)
    det.close()
    del det
    torch.cuda.empty_cache()
    grid = cfg.voxel_shape
    nx, ny = grid[0], grid[1]
    B, V, _, R = y.shape
    # K1's partials buffer, for the build that splits rows into most tiles
    facts = (ctypes.c_int * 2)()
    tiles = 1
    for lib in libs.values():
        if hasattr(lib, "merge_launch_facts"):
            lib.merge_launch_facts(1, y.element_size(), ny, R, facts)
            tiles = max(tiles, facts[1])
    bufs = {"y": y, "col_cy": col_cy, "bounds": bounds, "bias": bias,
            "out": torch.empty((B, nx, ny, R), device=dev),
            "stats": torch.empty((B, nx, 2, R), device=dev),
            "partial": torch.empty((B, nx, tiles, 2, R), device=dev),
            "g": torch.randn((B, nx, ny, R), device=dev, generator=torch
                             .Generator(device=dev).manual_seed(1)),
            "dy": torch.empty_like(y)}
    stream = stream_handle(dev)
    calls = {n: entry_points(lib, bufs, (B, V, nx, ny, R), stream)
             for n, lib in libs.items()}

    want_out, want_stats = cm.merge_taps_fused_plain(y, col_cy, bounds,
                                                     bias, grid)
    want_merged = cm.merge_taps_plain(y, col_cy, bounds, grid)
    yp = y.detach().requires_grad_()
    (want_dy,) = torch.autograd.grad(
        cm.merge_taps_plain(yp, col_cy, bounds, grid), yp, bufs["g"])

    def launch_record(n):
        lib = libs[n]
        return read_launches(lib) if hasattr(lib, "last_launches") else None

    checks = {}
    for n, c in calls.items():
        c["column_merge"]()
        launch = {"column_merge": launch_record(n)}
        out, stats = bufs["out"].clone(), bufs["stats"].clone()
        c["column_merge"]()
        torch.cuda.synchronize()
        same = torch.equal(out, bufs["out"]) and torch.equal(
            stats, bufs["stats"])
        err_out, err_stats = (cs.rel_err(out, want_out)[0],
                              cs.rel_err(stats, want_stats)[1])
        c["merge_taps"]()
        launch["merge_taps"] = launch_record(n)
        c["merge_taps_bwd"]()
        launch["merge_taps_bwd"] = launch_record(n)
        torch.cuda.synchronize()
        err_merged = cs.rel_err(bufs["out"], want_merged)[0]
        err_dy = cs.rel_err(bufs["dy"], want_dy)[0]
        checks[n] = {"column_merge": err_out, "column_merge_stats_rel":
                     err_stats, "column_merge_same_twice": same,
                     "merge_taps": err_merged, "merge_taps_bwd": err_dy}
        ptxas = [ln.strip() for ln in (others[n][1] if n in others else
                                       cm.LIBRARY.build_log).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(json.dumps({"build": n, "errors": checks[n],
                          "launch": launch,
                          "ptxas": ptxas}), flush=True)
    del want_out, want_stats, want_merged, want_dy, yp, out, stats
    torch.cuda.empty_cache()
    bad = [n for n, e in checks.items()
           if e["column_merge"] or e["merge_taps"] or e["merge_taps_bwd"]
           or e["column_merge_stats_rel"] > cs.TOL["column_merge"]["stats"]
           or not e["column_merge_same_twice"]]
    if bad:
        print(f"kernel_ab: builds disagree with the plain versions: {bad}",
              file=sys.stderr)
        return 1

    dest, acc = cs.merge_index_add(y, col_cy, bounds, grid)
    rows = y.reshape(-1, R)
    gpad = torch.cat([bufs["g"].reshape(-1, R), bufs["g"].new_zeros(1, R)])
    library = {"column_merge": ("Tensor.index_add_",
                                lambda: acc.index_add_(0, dest, rows)),
               "merge_taps": ("Tensor.index_add_",
                              lambda: acc.index_add_(0, dest, rows)),
               "merge_taps_bwd": ("torch.index_select (zero-padded "
                                  "cotangent)",
                                  lambda: torch.index_select(gpad, 0, dest))}
    order = list(other_dirs) + ["this", "this"] + list(other_dirs)[::-1]
    for name in ("column_merge", "merge_taps", "merge_taps_bwd"):
        times = {n: [] for n in libs}
        for n in order:
            times[n].append(cs.time_ms(calls[n][name]))
        lib_call, lib_fn = library[name]
        print(json.dumps({
            "kernel": name, "ms": times, "order": order,
            "library_call": lib_call, "library_ms": cs.time_ms(lib_fn)}),
            flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
