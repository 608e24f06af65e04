"""Device milliseconds a training step of the kernels, copies and fills
launched inside ``mvx.train.backward``: ``backward()``, remat's
recompute of the CML included."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.train.backward", "mvx.train.step")
