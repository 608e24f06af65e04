"""NCCL device milliseconds a step, the largest over the ranks: the
gradient all-reduce's transfer plus the wait for the slowest rank."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r["steps"] and r["kernels"]]
    if not ranks:
        return None
    return max(r["nccl_s_per_step"] for r in ranks) * 1e3
