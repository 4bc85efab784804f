"""Share of the traced window of frames in which no operation ran on a
rank's card (``torch.profiler``'s kernels, copies and sets, their
union), as a mean over the ranks.  NCCL's kernels count as busy, the
wait inside them too (``exchange_pct.tp`` reads them)."""

from benchmark.readers import idle_pct


def read(data):
    vals = [idle_pct(r) for r in data["ranks"]]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)
