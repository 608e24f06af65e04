"""Device-to-host synchronisations a sensor frame makes: the program's
``mvx.sync`` ranges per frame served in the traced window."""
from perfbench.metrics._spans import units


def read(ctx):
    n = units(ctx, "mvx.sync")
    if not n or not ctx["frames"]:
        return None
    return n / ctx["frames"]
