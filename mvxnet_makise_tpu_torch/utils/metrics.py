"""Training observability: loss statistics and phase timing.

The port's copy of ``mvxnet_makise_tpu/utils/metrics.py``: running
average and maximum of each loss with non-finite values excluded but
counted (the reference's logging every 50 iterations), and wall-clock
totals per named phase of the loop.  Each phase is also the span
``mvx.loop.<phase>`` (``utils/profiling``), so the loop's phases land in
the same profiler trace as the rest of the port.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Dict

from mvxnet_makise_tpu_torch.utils.profiling import span


class LossTracker:
    """Running avg/max with NaN filtering: non-finite values are excluded
    from the statistics but counted."""

    def __init__(self):
        self.sum: Dict[str, float] = defaultdict(float)
        self.max: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.nan_count: Dict[str, int] = defaultdict(int)
        self.total_seen = 0

    def update(self, metrics: Dict[str, float]):
        self.total_seen += 1
        for k, v in metrics.items():
            v = float(v)
            if math.isnan(v) or math.isinf(v):
                self.nan_count[k] += 1
                continue
            self.sum[k] += v
            self.max[k] = max(self.max[k], v)
            self.count[k] += 1

    def average(self, key: str) -> float:
        c = self.count[key]
        return self.sum[key] / c if c else float("nan")

    def maximum(self, key: str) -> float:
        return self.max[key] if self.count[key] else float("nan")

    def summary(self) -> Dict[str, float]:
        out = {}
        for k in self.sum:
            out[f"avg_{k}"] = self.average(k)
            out[f"max_{k}"] = self.maximum(k)
        for k, v in self.nan_count.items():
            out[f"nan_{k}"] = v
        return out

    def reset(self):
        self.__init__()


class PhaseTimer:
    """Accumulating wall-clock timers per named phase.

    Usage: ``with timer.phase("device_step"): ...``.  Callers put a
    ``torch.cuda.synchronize()`` at phase edges where device work must be
    attributed to the phase that queued it.  Threads may time phases
    concurrently (the totals are updated under a lock).
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name
            self.span = span("mvx.loop." + name)

        def __enter__(self):
            self.span.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            with self.timer._lock:
                self.timer.totals[self.name] += dt
                self.timer.counts[self.name] += 1
            self.span.__exit__(*exc)
            return False

    def phase(self, name: str) -> "_Ctx":
        return self._Ctx(self, name)

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] for k in sorted(self.totals)}

    def report(self) -> str:
        parts = []
        for k in sorted(self.totals):
            c = max(self.counts[k], 1)
            parts.append(f"{k}: {self.totals[k]:.3f}s "
                         f"({self.totals[k] / c * 1e3:.3f} ms/it)")
        return " | ".join(parts)
