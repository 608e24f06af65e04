"""Whole-step share of the chip's peak while serving: the reference
model's forward FLOPs for the traced window's frames (accounting) over
the window's length times the peak of the configuration's precision."""
from perfbench.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
