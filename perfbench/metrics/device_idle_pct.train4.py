"""Share of each rank's traced window in which no kernel, copy or fill
other than NCCL's ran (NCCL's ranges, mostly waiting for the slowest
rank, counted apart in ``allreduce_ms.train4``); the largest over the
ranks."""


def read(ctx):
    ranks = [r for r in ctx["ranks"] if r["window_s"] > 0 and r["busy_s"] > 0]
    if not ranks:
        return None
    return max(100.0 * (1.0 - r["work_s"] / r["window_s"]) for r in ranks)
