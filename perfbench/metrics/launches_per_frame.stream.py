"""Kernels launched on the card per frame served in the traced window."""


def read(ctx):
    if not ctx["frames"] or not ctx["events"]["kernels"]:
        return None
    return len(ctx["events"]["kernels"]) / ctx["frames"]
