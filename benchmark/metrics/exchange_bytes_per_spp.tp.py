"""Bytes rank 0 handed to collectives per sample over the traced window
(``ptx_torch.parallel.dist.STATS.bytes``, untimed): the exchanges between
the graph segments, the live counts and any gather of the carry."""


def read(data):
    r = data["ranks"][0]
    if not r or not r["units"] or not r.get("exchange_bytes"):
        return None
    return r["exchange_bytes"] / r["units"]
