"""Replays of the program's CUDA graph of the forward per sensor frame:
its ``mvx.serve.graph`` ranges per frame served in the traced window
(1.0 where every frame replays it; none where the program has no such
span)."""
from perfbench.metrics._spans import units


def read(ctx):
    n = units(ctx, "mvx.serve.graph")
    if not n or not ctx["frames"]:
        return None
    return n / ctx["frames"]
