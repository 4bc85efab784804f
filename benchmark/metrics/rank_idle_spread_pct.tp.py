"""The largest minus the smallest of the ranks' device idle shares over
the traced window of frames: the wait of the lighter shards for the
heaviest at each exchange."""

from benchmark.readers import idle_pct


def read(data):
    vals = [idle_pct(r) for r in data["ranks"]]
    if len(vals) < 2 or None in vals:
        return None
    return max(vals) - min(vals)
