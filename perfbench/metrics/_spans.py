"""Shared arithmetic of the readers of the program's own spans.

The program opens a profiler range named after each of its spans
(``mvx.<layer>.<what>``, ``mvxnet_makise_tpu_torch/utils/profiling.py``)
on the threads the profiler traces, so the traced window's host events
hold them beside the runtime calls that launch the device's work.  Each
kernel, copy and fill is linked to its launching runtime call by order,
counted from the window's end: the last kernel to start on the card
belongs to the last kernel launch, and likewise for copies and fills.  The
profiler misses the device records of the window's first few
operations (on the H100, up to ten in its first ~10 ms) but keeps their
launches, so counting from the start would shift every pair; the order
needs no clock shared by host and card, whose times can sit a
millisecond apart.  Held against the profiler's correlation ids on an
H100, in eight traced windows of the serving, sensor and training cells,
every span's device ms and launch count per unit agreed to 1e-4 ms; in
training, whose library calls fan kernels out over side streams, ~15 %
of the device time sits in swapped pairs, which leave every span's
totals as they are.  A device
operation counts for a span when its launch lies inside one of the
span's ranges: work launched from autograd's thread during
``backward()`` counts for the span open on the thread that called it.
Every reader returns None where the window holds none of the spans it
reads.
"""

from bisect import bisect_right

KINDS = ("kernel", "memcpy", "memset")


def _launch_kind(name):
    if not name.startswith("cu"):
        return None
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def _op_kind(name):
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def launched(ctx):
    """(launch time, kind, start, end) of every device operation of the
    window that has a launch to link to; computed once per context."""
    cached = ctx.get("_launched")
    if cached is not None:
        return cached
    calls = {k: [] for k in KINDS}
    for name, s, _ in ctx["events"]["host"]:
        kind = _launch_kind(name)
        if kind is not None:
            calls[kind].append(s)
    ops = {k: [] for k in KINDS}
    for name, s, e in ctx["events"]["device"]:
        ops[_op_kind(name)].append((s, e))
    out = []
    for kind in KINDS:
        launches, work = sorted(calls[kind]), sorted(ops[kind])
        n = min(len(launches), len(work))
        for t, (s, e) in zip(launches[len(launches) - n:],
                             work[len(work) - n:]):
            out.append((t, kind, s, e))
    ctx["_launched"] = out
    return out


def ranges(ctx, name):
    """The host ranges of the span ``name``, sorted."""
    return sorted((s, e) for n, s, e in ctx["events"]["host"] if n == name)


class Within:
    """Membership of times in a sorted list of ranges."""

    def __init__(self, spans):
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def __contains__(self, t):
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def device_s(ctx, name, kinds=KINDS):
    """Device seconds and count of the operations (of ``kinds``) launched
    inside the span ``name``; None where the span is not in the window."""
    spans = ranges(ctx, name)
    if not spans:
        return None
    inside = Within(spans)
    total, n = 0.0, 0
    for t, kind, s, e in launched(ctx):
        if kind in kinds and t in inside:
            total += e - s
            n += 1
    return total, n


def units(ctx, name):
    """How many ranges of the span ``name`` the window holds (its serving
    batches, training steps)."""
    return len(ranges(ctx, name))


def device_ms_per(ctx, name, unit):
    """Device milliseconds launched inside ``name`` per range of
    ``unit``."""
    got, n = device_s(ctx, name), units(ctx, unit)
    if got is None or n == 0:
        return None
    return got[0] * 1e3 / n


def host_ms_per(ctx, name, unit):
    """Host milliseconds inside the ranges of ``name`` per range of
    ``unit``."""
    spans, n = ranges(ctx, name), units(ctx, unit)
    if not spans or n == 0:
        return None
    return sum(e - s for s, e in spans) * 1e3 / n
