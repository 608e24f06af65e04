"""Shared arithmetic of the per-layer readers (each reader is
``<metric>.py`` beside this file, with ``read(ctx)``)."""

from perfbench import trace


def idle_pct(ctx):
    """Share of the traced window in which nothing ran on the device."""
    if ctx["window_s"] <= 0 or not ctx["events"]["device"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def kernel_seconds(ctx, names):
    """Device seconds of the kernels whose names contain one of
    ``names``, and how many ran."""
    total, n = 0.0, 0
    for name, s, e in ctx["events"]["kernels"]:
        if any(k in name for k in names):
            total += e - s
            n += 1
    return total, n


def roofline_pct(ctx, names, bound_key):
    """The least time the accounting gives the kernels' calls, over the
    time they took; None where none ran."""
    took, n = kernel_seconds(ctx, names)
    if n == 0 or took <= 0 or ctx[bound_key] <= 0:
        return None
    return 100.0 * ctx[bound_key] / took


def mfu_pct(ctx):
    """The accounting's FLOPs over the window's length times the peak of
    the precision the configuration computes in (989 TFLOP/s in
    bfloat16, 67 in float32 with TF32 off)."""
    if ctx["window_s"] <= 0 or ctx["flops"] <= 0:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak_flop_per_s"])


def union_within(ctx, spans):
    """Device-busy seconds inside the spans, and the spans' length."""
    busy = sum(trace.covered(ctx["merged"], s, e) for s, e in spans)
    return busy, sum(e - s for s, e in spans)
