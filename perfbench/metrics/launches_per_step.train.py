"""Kernels launched on the card per training step in the traced window."""


def read(ctx):
    if not ctx["steps"] or not ctx["events"]["kernels"]:
        return None
    return len(ctx["events"]["kernels"]) / ctx["steps"]
