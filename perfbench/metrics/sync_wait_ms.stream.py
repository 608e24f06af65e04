"""Host milliseconds a sensor frame spends in the program's
device-to-host synchronisations (``mvx.sync``: uploads from pageable
memory, constants made on the card, NMS's fixpoint checks, the read-back
of the detections)."""
from perfbench.metrics._spans import ranges


def read(ctx):
    spans = ranges(ctx, "mvx.sync")
    if not spans or not ctx["frames"]:
        return None
    return sum(e - s for s, e in spans) * 1e3 / ctx["frames"]
