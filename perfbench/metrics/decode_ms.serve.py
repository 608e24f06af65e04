"""Device milliseconds a serving batch of the kernels, copies and fills
launched inside ``mvx.serve.decode``: decode and the rotated NMS."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.serve.decode", "mvx.serve.batch")
