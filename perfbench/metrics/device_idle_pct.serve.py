"""Share of the traced window in which no kernel, copy or fill ran on the
card (the union of their intervals, so overlapping streams count once)."""
from perfbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
