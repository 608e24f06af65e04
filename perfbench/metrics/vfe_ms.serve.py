"""Device milliseconds a serving batch of the kernels, copies and fills
launched inside ``mvx.model.vfe``: the per-point features and the VFE stack."""
from perfbench.metrics._spans import device_ms_per


def read(ctx):
    return device_ms_per(ctx, "mvx.model.vfe", "mvx.serve.batch")
