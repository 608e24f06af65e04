"""The loops a traffic file names (its ``loop`` key), each driving one
entry of the program:

- ``serve_closed``: ``Detector.detect_stream`` over the pool, cycled, at
  the mix's batch; the next batch is asked for when the last is back.
- ``serve_open``: one scan due every ``1 / rate_hz`` seconds, each through
  ``Detector.detect_frames([scan])``, timed from when it was due.
- ``train``: ``train.loop.make_full_train_step`` on the next batch of the
  pool each step (upload, voxelize, assign, forward, loss, backward,
  AdamW).

Each loop runs either for ``seconds`` (the measured window) or for
``count`` units (frames or steps: warm-up and the traced window), wraps
every unit in a ``perfbench.*`` profiler range, and returns what it
served.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

FRAME = "perfbench.frame"
BATCH = "perfbench.batch"
STEP = "perfbench.step"


def serve_closed(det, frames: List, batch: int, *, seconds: float = 0.0,
                 count: int = 0, start: int = 0) -> Dict:
    """Frames (scan, calib, image) of ``frames`` from index ``start``,
    cycled, through ``detect_stream``.  Stops at the end of the first
    batch that ends after ``seconds``, or after ``count`` frames."""
    n = len(frames)

    def stream():
        i = start
        while True:
            yield frames[i % n]
            i += 1

    served = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    rng = torch.profiler.record_function(BATCH)
    rng.__enter__()
    gen = det.detect_stream(stream(), batch_size=batch)
    try:
        for k, d in enumerate(gen):
            served.append(((start + k) % n, d))
            if (k + 1) % batch:
                continue
            rng.__exit__(None, None, None)
            t1 = time.perf_counter()
            if (count and k + 1 >= count) or (not count and t1 >= deadline):
                break
            rng = torch.profiler.record_function(BATCH)
            rng.__enter__()
    finally:
        # the feed thread may be assembling one more batch: it is waited
        # for here, after the window's clock stopped at the last batch
        gen.close()
    return {"served": served, "t0": t0, "t1": t1, "attempted": len(served),
            "failed": 0}


def serve_open(det, frames: List, rate_hz: float, *, seconds: float = 0.0,
               count: int = 0, start: int = 0) -> Dict:
    """One frame due every 1 / rate_hz seconds from now, served through
    ``detect_frames([frame])`` as soon as the one before is back; each
    frame's latency runs from when it was due to when its detections are
    on the host."""
    n = len(frames)
    period = 1.0 / rate_hz
    due_count = count or int(round(seconds * rate_hz))
    served, latency, late = [], [], []
    failed = 0
    t0 = time.perf_counter() + period
    for k in range(due_count):
        due = t0 + k * period
        now = time.perf_counter()
        if now < due:
            if due - now > 2e-3:
                time.sleep(due - now - 2e-3)
            while time.perf_counter() < due:
                pass
            # how late the generator sent a frame that found the server
            # idle
            late.append(time.perf_counter() - due)
        idx = (start + k) % n
        with torch.profiler.record_function(FRAME):
            try:
                dets = det.detect_frames([frames[idx]])
            except Exception:
                # an open loop keeps its schedule: the frame counts as
                # attempted and failed, and the run goes on
                traceback.print_exc()
                failed += 1
                continue
        latency.append(time.perf_counter() - due)
        served.append((idx, dets[0]))
    return {"served": served, "latency": latency, "late": late,
            "t0": t0, "t1": time.perf_counter(), "attempted": due_count,
            "failed": failed}


def train_loop(step: Callable, batches: Callable[[int], tuple], *,
               seconds: float = 0.0, count: int = 0, start: int = 0,
               after_step: Optional[Callable[[int, Dict], None]] = None,
               agree: Callable[[bool], bool] = bool) -> Dict:
    """``step(*batches(i))`` for i from ``start``: for ``count`` steps, or
    until the first step that ends after ``seconds``; ``agree`` turns this
    process's "time is up" into the verdict every process of a
    data-parallel run shares, so that all run the same steps."""
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i, skipped = start, 0
    while True:
        with torch.profiler.record_function(STEP):
            metrics = step(*batches(i))
        skipped += int(metrics["skipped_nonfinite"])
        if after_step is not None:
            after_step(i, metrics)
        i += 1
        if count and i - start >= count:
            break
        if not count and agree(time.perf_counter() >= deadline):
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"steps": i - start, "t0": t0, "t1": time.perf_counter(),
            "attempted": i - start, "failed": skipped}


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, int(np.ceil(q / 100.0 * len(v))) - 1)])
