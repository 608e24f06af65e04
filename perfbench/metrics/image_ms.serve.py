"""Device milliseconds a serving batch of the kernels, copies and fills
launched inside ``mvx.model.image``: the image branch (ResNet50-FPN, K2,
the fusion MLP)."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.model.image", "mvx.serve.batch")
