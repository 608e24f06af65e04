"""Whole-step share of the four cards' peak in data-parallel training:
the global batch's forward and backward FLOPs over the traced steps
(recomputation not counted) over the window's length times the cards'
float32 peak."""
from perfbench.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
