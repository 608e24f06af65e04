"""Reduction of a ``torch.profiler`` window to what the per-layer readers
and the result's ``breakdown`` read: device intervals, their union, the
benchmark's own spans, the idle gaps and what the host was doing in
them."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Merged, sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def reduce(prof) -> Dict:
    """The profiler's events, in seconds on one clock: ``device`` (name,
    start, end) of every kernel, copy and fill; ``kernels`` the kernels
    alone; ``spans`` the benchmark's ``perfbench.*`` ranges by name;
    ``host`` (name, start, end) of the host's operators."""
    device, host = [], []
    spans: Dict[str, List[Interval]] = defaultdict(list)
    for ev in prof.events():
        start = ev.time_range.start * 1e-6
        end = ev.time_range.end * 1e-6
        if ev.name.startswith("perfbench."):
            # the benchmark's own ranges; the profiler also draws each on
            # the device's timeline, where it is no device work
            if ev.device_type.name != "CUDA":
                spans[ev.name].append((start, end))
        elif ev.device_type.name == "CUDA":
            # ranges the profiler draws on the device's timeline (a
            # collective's ``nccl:all_reduce``, say) are no device work
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, start, end))
        else:
            host.append((ev.name, start, end))
    kernels = [d for d in device
               if not d[0].startswith(("Memcpy", "Memset"))]
    return {"device": device, "kernels": kernels, "spans": dict(spans),
            "host": host}


def breakdown(events: Dict, lo: float, hi: float, top: int = 10) -> Dict:
    """The device operations that took most time in [lo, hi], and the
    longest gaps between device work there, each named by the innermost
    host operator running at the gap's middle, else by the benchmark's
    range around it (Python between operators), else as a wait between
    the benchmark's calls (the paced gaps of an open loop)."""
    per_name: Dict[str, float] = defaultdict(float)
    for name, s, e in events["device"]:
        per_name[name] += max(0.0, min(e, hi) - max(s, lo))
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    merged = union([(s, e) for _, s, e in events["device"]])
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, min(s, hi)))
        prev = max(prev, e)
    if prev < hi:
        gaps.append((prev, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = events["host"]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        best, best_start = None, -1.0
        for name, s, e in host:
            if s <= mid <= e and s > best_start:
                best, best_start = name, s
        if best is None:
            best = "between the benchmark's calls"
            for name, ranges in events["spans"].items():
                if any(s <= mid <= e for s, e in ranges):
                    best = f"{name}: between host operators"
        named.append([best, g1 - g0])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
