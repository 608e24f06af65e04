"""Device milliseconds a serving batch of the kernels, copies and fills
launched inside ``mvx.model.rpn``: the RPN."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.model.rpn", "mvx.serve.batch")
