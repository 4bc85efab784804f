"""Share of the traced window of frames in which no operation ran on the
card (``torch.profiler``'s kernels, copies and sets, their union)."""

from benchmark.readers import idle_pct


def read(data):
    vals = [idle_pct(r) for r in data["ranks"]]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals)
