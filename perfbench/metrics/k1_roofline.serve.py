"""K1 (column merge, ``merge_kernel`` and its statistics pass): the least
time of its calls by the frozen byte formula over its device time."""
from perfbench.metrics._common import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("merge_kernel", "merge_stats_kernel"),
                        "k1_bound_s")
