"""Share of the traced window of frames in which NCCL's kernels run on a
rank's card (the exchanges between graph segments and each rank's wait
there for the row's slowest shard), as a mean over the ranks.  The
profiler counts these kernels as busy, so the idle shares do not see the
wait."""

from benchmark.readers import kernel_seconds


def read(data):
    vals = []
    for r in data["ranks"]:
        if not r or r["window_s"] <= 0:
            return None
        vals.append(100.0 * kernel_seconds(r, ("nccl",)) / r["window_s"])
    if len(vals) < 2 or not any(vals):
        return None
    return sum(vals) / len(vals)
