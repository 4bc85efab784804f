"""The intersection kernels' share of their roofline: 100 x the least
time the card could take for a sample's closest and shadow queries over
the time they took (``intersect_ms_per_spp.fwd``).  The least time is the
larger of the operations over the card's float32 peak and the bytes over
its memory bandwidth, both frozen in ``benchmark/data/intersect_counts.json``
(made by ``benchmark/make_intersect_counts.py`` from the reference's own
BVH walk), so it reads the same work whatever implements the sweep."""

import json
import os

from benchmark import common
from benchmark.readers import peaks


def bound_ms_per_spp(device: str):
    """The least milliseconds of a sample's intersection work on
    ``device``, or None without its peaks."""
    peak = peaks(device)
    if peak is None:
        return None
    with open(os.path.join(common.BENCH, "data", "intersect_counts.json")) as f:
        counts = json.load(f)
    return 1e3 * max(counts["flops_per_spp"] / peak["float32_flops"],
                     counts["bytes_per_spp"] / peak["bytes_per_s"])


def read(data):
    ms = common.load_module("metrics", "intersect_ms_per_spp.fwd").read(data)
    bound = bound_ms_per_spp(data["device"])
    if ms is None or bound is None:
        return None
    return 100.0 * bound / ms
