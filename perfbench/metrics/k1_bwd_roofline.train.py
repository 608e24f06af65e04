"""K1's backward (first pass, bias gradient, tap gather): the least time
of its calls by the frozen byte formula over its device time."""
from perfbench.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("merge_fused_pre_kernel",
                              "merge_fused_dbias_kernel",
                              "merge_taps_bwd_kernel"), "k1_bwd_bound_s")
