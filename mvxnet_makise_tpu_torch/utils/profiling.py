"""Profiler integration.

Port of ``mvxnet_makise_tpu/utils/profiling.py``, over ``torch.profiler``
where JAX's wraps ``jax.profiler``: the enclosed work is traced, CPU
activity always and the card's kernels when CUDA is available, and a
Chrome trace (``chrome://tracing`` or Perfetto) is written into the log
directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace_context(logdir: str = "mvxnet_trace", enabled: bool = True
                  ) -> Iterator[None]:
    """``with trace_context('trace'):`` profiles the enclosed work and
    writes ``trace-<pid>-<ns>.json`` into ``logdir``; ``enabled=False``
    traces nothing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
