"""Kernels a training step launched inside ``mvx.train.backward``
(autograd's thread included)."""
from perfbench.metrics._spans import device_s, units


def read(ctx):
    got, steps = device_s(ctx, "mvx.train.backward", ("kernel",)), \
        units(ctx, "mvx.train.step")
    if got is None or not steps:
        return None
    return got[1] / steps
