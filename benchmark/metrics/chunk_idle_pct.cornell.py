"""Share of the traced window of optimisation steps in which the card
idles inside a pixel chunk's forward and backward (the ``ptx.chunk``
spans, rank 0): between the first and the last device operation a chunk
launched, the host's glue between its graph replays and kernels."""

from benchmark.spans import PREFIX, _spans


def read(data):
    r = data["ranks"][0]
    chunk = _spans(r).get(PREFIX + "chunk")
    if not chunk or not chunk["count"]:
        return None
    return 100.0 * chunk["idle_in_s"] / r["window_s"]
