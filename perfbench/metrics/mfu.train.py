"""Whole-step share of the chip's peak while training: forward and
backward FLOPs of the traced steps' frames (recomputation not counted)
over the window's length times the peak of the configuration's
precision."""
from perfbench.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
