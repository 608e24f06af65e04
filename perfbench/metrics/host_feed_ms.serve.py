"""Host milliseconds of ``Detector.assemble`` (crop, projection, shuffle,
padding) per batch of the cell's own scans, timed by the benchmark before
the traced window: the mean over its batches."""


def read(ctx):
    ms = ctx["host_feed_ms"]
    return sum(ms) / len(ms) if ms else None
