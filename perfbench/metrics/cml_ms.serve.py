"""Device milliseconds a serving batch of the kernels, copies and fills
launched inside ``mvx.model.cml``: the CML (K1's column merge)."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.model.cml", "mvx.serve.batch")
