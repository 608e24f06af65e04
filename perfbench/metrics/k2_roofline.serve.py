"""K2 (the FPN gather, ``fpn_gather_kernel``): the least time of its calls
by the frozen byte formula over its device time."""
from perfbench.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("fpn_gather_kernel",), "k2_bound_s")
