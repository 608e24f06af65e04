"""The ``train_dp`` loop: data-parallel training over the cards of one
host, one process per card, each running the program's
``train.step.make_train_step(mesh=make_mesh((W, 1)))`` on its own rows
of a global batch (NCCL on the cards, gloo for a CPU rehearsal).

The run's own process is rank 0; it starts ranks 1..W-1 (``spawn``),
waits for each to end, and prints the result.  Every rank makes the same
weights and pool from the seed (the weights are then broadcast from rank
0, so every rank starts bit-equal), drives the same set-up steps, and
times the window between two barriers; the steps end where any rank's
clock has passed the window (an all-reduce of the votes).  The traced
run reduces each rank's profiler window, and rank 0 gathers the ranks'
readings, their program numbers and their peak memory.  After the window
every rank frees its state, and rank 0 alone runs the reference over the
global batches of the checked steps.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import socket
import time
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from perfbench import generate, loops, trace
from perfbench.reference import compare
from perfbench.reference import model as R
from perfbench.reference import train as ref_train

NCCL = "nccl"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_dp(name: str, seed: int, seconds: float, traced: bool,
           device: str, overrides: Optional[Dict], world: int, t0: float):
    """One run of a ``train_dp`` cell over ``world`` processes: (result
    pieces, numbers) on rank 0; ``t0``: when this process started (its
    set-up is counted from there)."""
    port = free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, name, seed, seconds, traced,
                               device, overrides, None))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = rank_main(0, world, port, name, seed, seconds, traced, device,
                        overrides, t0)
    finally:
        for p in procs:
            p.join(timeout=900)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return out


def fault(overrides: Optional[Dict]):
    """A fault planted for a reading or a test, named "module:function"
    under ``patch``: a context manager entered around the run (in every
    rank of a data-parallel one)."""
    spec = (overrides or {}).get("patch")
    if not spec:
        return contextlib.nullcontext()
    mod, fn = spec.split(":")
    return getattr(importlib.import_module(mod), fn)()


def rank_main(rank: int, world: int, port: int, name: str, seed: int,
              seconds: float, traced: bool, device: str,
              overrides: Optional[Dict], t0: Optional[float]):
    from perfbench import run

    t0 = run._T0 if t0 is None else t0
    # the ranks share the host's cores, as torchrun's do
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    dist.init_process_group(NCCL if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=600))
    try:
        with fault(overrides):
            return _rank(run, rank, world, name, seed, seconds, traced, dev,
                         overrides, t0)
    finally:
        dist.destroy_process_group()


def _rank(run, rank, world, name, seed, seconds, traced, dev, overrides,
          t0):
    from mvxnet_makise_tpu_torch.ops.assign import create_anchors
    from mvxnet_makise_tpu_torch.parallel import make_mesh, shard_params
    from mvxnet_makise_tpu_torch.train.state import TrainState
    from mvxnet_makise_tpu_torch.train.step import (
        frames_to_batch,
        make_train_step,
    )

    cell = run.load_cell(name, overrides)
    mix = cell.traffic
    cfg = run.port_config(cell)
    with_images = cell.config["with_images"]
    params = R.make_params(R.param_spec(with_images), seed, dev)
    for t in params.values():
        dist.broadcast(t, 0)
    pool = generate.make_pool(seed, mix, cfg.velo_range, cfg.image_size,
                              cfg.car_size)
    arrays = run.train_pool(cell, cfg, pool, seed)
    if dev.type == "cuda":
        from mvxnet_makise_tpu_torch.device import use_full_f32

        use_full_f32()
    mesh = make_mesh((world, 1))
    model = shard_params(run.build_program(cfg, params, with_images, dev),
                         mesh)
    state = TrainState.create(cfg, model)
    anchors = torch.from_numpy(create_anchors(
        cfg.feature_map_shape, cfg.velo_range, cfg.anchor_sizes)).to(dev)
    step_fn = make_train_step(cfg, anchors, with_images, mesh=mesh)
    B = mix["batch"]

    def batches(i):
        pts, num, img, gt, mask, cls, perm = run.batch_of(
            arrays, i * world + rank, B, dev)
        return (frames_to_batch(pts, num, img, cfg, gt_boxes=gt,
                                gt_mask=mask, gt_classes=cls, perm=perm),)

    def step(batch):
        return step_fn(state, batch)

    def agree(flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    n_check = mix["check_steps"]
    program = run.check_steps(step, batches, n_check, state, model, params)
    run.sync(dev)
    dist.barrier()
    setup_s = time.perf_counter() - t0
    reading = None
    if traced:
        with run.profiler(dev) as prof:
            res = loops.train_loop(step, batches, count=mix["traced_steps"],
                                   start=n_check, agree=agree)
        reading = rank_reading(trace.reduce(prof), res["steps"])
    else:
        res = loops.train_loop(step, batches, seconds=seconds,
                               start=n_check, agree=agree)
    dist.barrier()
    res["t1"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mine = {"program": program, "peak": peak,
            "reading": reading, "setup_s": setup_s}
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    del state, model, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    res["batches"] = list(range(n_check, n_check + res["steps"]))
    return finish(run, cell, cfg, params, arrays, res, gathered, world,
                  traced, dev)


def rank_reading(events: Dict, steps: int) -> Dict:
    """One rank's traced window: its length, device-busy seconds with and
    without the NCCL kernels, NCCL seconds a step, and the breakdown."""
    spans = events["spans"].get(loops.STEP, [])
    lo = min(s for s, _ in spans)
    hi = max(e for _, e in spans)
    dev_iv = [(s, e) for _, s, e in events["device"]]
    work = [(s, e) for n, s, e in events["device"]
            if NCCL not in n.lower()]
    nccl = sum(e - s for n, s, e in events["kernels"]
               if NCCL in n.lower())
    return {"window_s": hi - lo,
            "busy_s": trace.covered(trace.union(dev_iv), lo, hi),
            "work_s": trace.covered(trace.union(work), lo, hi),
            "nccl_s_per_step": nccl / max(steps, 1),
            "steps": steps,
            "kernels": len(events["kernels"]),
            "breakdown": trace.breakdown(events, lo, hi)}


def finish(run, cell, cfg, params, arrays, res, gathered, world, traced,
           dev):
    """Rank 0: the result pieces from every rank's readings, and the
    reference's comparison with every rank's program numbers."""
    from perfbench.accounting import flops, peak_flop_per_s
    from perfbench.accounting import frames as frame_facts

    mix = cell.traffic
    B = mix["batch"]
    rc = run.ref_config(cfg)
    out = {"setup_s": max(g["setup_s"] for g in gathered),
           "memory_peak_bytes": max(g["peak"] for g in gathered),
           "window": res}
    if traced:
        readings = [g["reading"] for g in gathered]
        idxs = [(i * world * B + j) % len(arrays)
                for i in res["batches"] for j in range(world * B)]
        total = 0.0
        for idx in idxs:
            pts, num, _, _, _, _, perm = arrays[idx]
            p = torch.from_numpy(pts).to(dev)[torch.from_numpy(perm).to(dev)]
            real = torch.from_numpy(perm).to(dev) < int(num)
            p = torch.cat([p[real], p[~real]])
            total += flops.train(frame_facts.stats(p, int(num), rc,
                                                   cell.config["with_images"]),
                                 rc, cell.config["with_images"])
        out["dp_context"] = {
            "ranks": readings, "window_s": readings[0]["window_s"],
            "busy_s": float(np.mean([r["busy_s"] for r in readings])),
            "flops": total, "steps": res["steps"], "world": world,
            "peak_flop_per_s": world * peak_flop_per_s(
                run.compute_dtype(cell)),
            "breakdown": readings[0]["breakdown"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = run.ref_batches(arrays, mix["check_steps"], world * B, dev)
    ref_losses, ref_grad, ref_change = ref_train.train_steps(params, batches,
                                                             rc)
    ref_grad, ref_change = compare.norms(ref_grad), compare.norms(ref_change)
    numbers: Dict = {}
    for r, g in enumerate(gathered):
        losses, grad_norms, change = g["program"]
        n = compare.train_numbers(losses, ref_losses, grad_norms, ref_grad,
                                  change, ref_change)
        for k, v in n.items():
            if isinstance(v, float):
                numbers[k] = max(numbers.get(k, 0.0), v)
            elif r == 0:
                numbers[k] = v
    return out, numbers
