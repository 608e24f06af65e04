"""Share of the frames' service time (from a frame's call to its
detections on the host, summed over the traced frames) in which nothing
ran on the card; the paced waits between frames are left out."""
from perfbench.loops import FRAME
from perfbench.metrics._common import union_within


def read(ctx):
    spans = ctx["events"]["spans"].get(FRAME, [])
    busy, total = union_within(ctx, spans)
    if total <= 0 or not ctx["events"]["device"]:
        return None
    return 100.0 * (1.0 - busy / total)
