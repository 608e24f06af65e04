"""Device milliseconds a training step of the kernels, copies and fills
launched inside ``mvx.train.forward``: the model's forward."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.train.forward", "mvx.train.step")
