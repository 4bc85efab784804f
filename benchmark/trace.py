"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a
fixed number of units (samples or optimisation steps), its Chrome trace
read back into one summary per rank that the per-layer metrics read.

The window is a ``bench.window`` annotation between two device
synchronizations; ``busy_s`` is the union of the device operations
(kernels, copies, sets) inside it; an idle gap between two of them is
named after the innermost host operation running where it begins.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
# Idle gaps named one by one, longest first; the rest are summed.
NAMED_GAPS = 2000


@contextlib.contextmanager
def profiled(device):
    """``torch.profiler`` on the host and, on a CUDA device, the device;
    yields the profiler, whose trace :func:`summarize` reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, units: int) -> dict:
    """One rank's summary of its traced window: ``busy_s``, ``window_s``
    (the annotation's length), ``units``, ``kernels`` (name -> [count,
    seconds] of device operations of category kernel), ``device_ops``
    (name -> seconds, every device operation) and ``gaps`` (host
    operation -> idle seconds at the gaps it began)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(float)
    for e in events:
        cat = e.get("cat")
        if "dur" not in e or cat is None:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            ops[e["name"]] += (t - s) * 1e-6
            if cat == "kernel":
                k = kernels[e["name"]]
                k[0] += 1
                k[1] += (t - s) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e["name"]))
    busy = _union(dev)
    gaps = []
    cursor = w0
    for s, t in busy:
        if s > cursor:
            gaps.append((s - cursor, cursor))
        cursor = max(cursor, t)
    if w1 > cursor:
        gaps.append((w1 - cursor, cursor))
    host.sort()
    starts = [h[0] for h in host]
    named = defaultdict(float)
    gaps.sort(reverse=True)
    for length, at in gaps[:NAMED_GAPS]:
        label = "no host operation"
        i = bisect.bisect_right(starts, at) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] > at:
                label = host[j][2]
                break
        named[label] += length * 1e-6
    rest = sum(g[0] for g in gaps[NAMED_GAPS:])
    if rest:
        named[f"shorter gaps than the {NAMED_GAPS} longest"] += rest * 1e-6
    return dict(busy_s=sum(t - s for s, t in busy) * 1e-6,
                window_s=(w1 - w0) * 1e-6, units=units,
                kernels={k: v for k, v in kernels.items()},
                device_ops=dict(ops), gaps=dict(named))


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    operations at which the device idled longest, as the result line's
    ``breakdown``."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(summary["device_ops"]),
            "idle_gaps": top(summary["gaps"])}
