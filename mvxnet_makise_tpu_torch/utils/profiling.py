"""Profiler integration and the port's spans.

Port of ``mvxnet_makise_tpu/utils/profiling.py``, over ``torch.profiler``
where JAX's wraps ``jax.profiler``: :func:`trace_context` traces the
enclosed work, CPU activity always and the card's kernels when CUDA is
available, and writes a Chrome trace (``chrome://tracing`` or Perfetto)
into the log directory.

The port's spans mark its layer boundaries (serving loop, model,
training step, parallel; names ``mvx.*``).  :func:`span` ``(name)`` is a
profiler range, ``record_function(name)``, on the threads the profiler
traces, so the trace, its idle gaps and the kernels launched inside
carry the name; anywhere else, and always while no profiler runs, it is
one shared no-op object.  :func:`sync_point` is the span :data:`SYNC`
around one device-to-host synchronisation.  Spans never synchronise the
device: device time reaches a span only through the profiler, by the
launches made inside it.  The profiler is the only switch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _torch_profiler

# span name of every device-to-host synchronisation
SYNC = "mvx.sync"


@contextlib.contextmanager
def trace_context(logdir: str = "mvxnet_trace", enabled: bool = True
                  ) -> Iterator[None]:
    """``with trace_context('trace'):`` profiles the enclosed work and
    writes ``trace-<pid>-<ns>.json`` into ``logdir``; ``enabled=False``
    traces nothing."""
    if not enabled:
        yield
        return
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


# whether the profiler traces the calling thread
_enabled_here = torch._C._autograd._profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager around one piece of work named ``name``
    (``mvx.<layer>.<what>``)."""
    # torch.profiler sets the module's flag while it runs, on any thread;
    # a thread it does not trace gets the no-op too
    if _torch_profiler._is_profiler_enabled and _enabled_here():
        return _torch_profiler.record_function(name)
    return _NO_SPAN


def sync_point():
    """The span :data:`SYNC` around one operation that makes the host wait
    for the card (a copy to the host, a value read, a copy from pageable
    host memory)."""
    return span(SYNC)
