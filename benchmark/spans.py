"""The program's spans in a traced window, and what the per-layer metrics
of the spans and counters compute from them.

``ptx_torch`` marks its steps with ``ptx_torch.utils.span`` while a
profiler records: ``ptx.sample`` (a turn of the sample loop),
``ptx.launch`` (a launch of the device loop or pass, a forward or a
backward of the device scan), ``ptx.replay`` (one CUDA graph replay) and
``ptx.exchange`` (one collective).  Each is a ``user_annotation`` of the
Chrome trace on the kernels' clock.  A device operation belongs to every
span open on its launching thread when its runtime call (a kernel launch,
a copy, a graph launch, NCCL's launches) was made: matched by the
``correlation`` the profiler gives both.  A trace of a program without
spans (an older tree) gives an empty summary, and every function below
then returns None.

:func:`summarize` reads the trace that ``trace.summarize`` reads, with the
window's bounds and its idle gaps, into the ``spans`` of a rank's summary.
The loops add ``counters``: the window's change of
``DeviceLoop.counters()`` (``lanes_live``, ``lanes_stepped``,
``iterations``, ``sorts``).  :func:`live_lane_pct`,
:func:`graph_gap_pct`, :func:`exchange_wait_pct` and
:func:`exchange_idle_pct` take a reader's ``data`` (``ranks``: each rank's
summary) and return a number or None.
"""

from __future__ import annotations

from collections import defaultdict

from benchmark.trace import DEVICE_CATS, _union

PREFIX = "ptx."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _overlap(a, b) -> float:
    """The length of the overlap of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _thread(e):
    return (e.get("pid"), e.get("tid"))


def summarize(events, w0: float, w1: float, gaps) -> dict:
    """The spans of one rank's traced window ``[w0, w1]`` (microseconds of
    the trace's clock): ``events``, the Chrome trace's ``traceEvents``;
    ``gaps``, the window's device idle gaps as ``(length, start)`` pairs
    in microseconds, in any order.  Returns, for each ``ptx.*`` span name,
    ``count`` (instances that begin in the window), ``host_s`` (their host
    time in the window), ``device_s`` (the union of their device
    operations in the window), ``idle_in_s`` (device idle inside the union
    of their device extents, each from the start of the first operation
    launched inside an instance to the end of the last) and ``idle_at_s``
    (the gaps that begin while the span is the innermost ``ptx.*`` span
    open on the host); ``idle_outside_s``, the gaps that begin outside
    every ``ptx.*`` span; and ``exchanges``, the device seconds of each
    ``ptx.exchange`` that begins in the window, in the order they began.
    Seconds throughout."""
    spans = []  # (start, end, name, thread)
    launches = {}  # correlation -> (host time, thread) of the runtime call
    ops = []  # (start, end, correlation), clipped to the window
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((s, t, e["name"], _thread(e)))
        elif cat in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (s, _thread(e))
        elif cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            corr = e.get("args", {}).get("correlation")
            if t > s and corr is not None:
                ops.append((s, t, corr))
    if not spans:
        return {}
    spans.sort()

    # The spans open on each thread at each runtime call: a sweep over the
    # spans' bounds and the calls, in time order, with a stack per thread.
    marks = []
    for i, (s, t, _, th) in enumerate(spans):
        marks.append((s, 1, i, th))
        marks.append((t, 0 if t > s else 3, i, th))
    for corr, (s, th) in launches.items():
        marks.append((s, 2, corr, th))
    marks.sort(key=lambda m: (m[0], m[1]))
    stacks = defaultdict(list)
    opened = {}  # correlation -> the span instances open at its call
    for _, kind, x, th in marks:
        if kind == 1:
            stacks[th].append(x)
        elif kind != 2:
            stacks[th].remove(x)
        elif stacks[th]:
            opened[x] = tuple(stacks[th])

    per_instance = defaultdict(list)  # instance -> its device operations
    for s, t, corr in ops:
        for i in opened.get(corr, ()):
            per_instance[i].append((s, t))

    idle = _union((at, at + length) for length, at in gaps)
    names = sorted({sp[2] for sp in spans})
    out = {n: dict(count=0, host_s=0.0, device_s=0.0, idle_in_s=0.0,
                   idle_at_s=0.0) for n in names}
    dev = defaultdict(list)
    extents = defaultdict(list)
    exchanges = []
    for i, (s, t, name, _) in enumerate(spans):
        o = out[name]
        if w0 <= s < w1:
            o["count"] += 1
        o["host_s"] += max(0.0, min(t, w1) - max(s, w0)) * 1e-6
        mine = per_instance.get(i, [])
        dev[name] += mine
        if mine:
            extents[name].append((min(a for a, _ in mine),
                                  max(b for _, b in mine)))
        if name == PREFIX + "exchange" and w0 <= s < w1:
            exchanges.append(sum(b - a for a, b in _union(mine)) * 1e-6)
    for name in names:
        out[name]["device_s"] = sum(b - a for a, b in _union(dev[name])) * 1e-6
        out[name]["idle_in_s"] = _overlap(_union(extents[name]), idle) * 1e-6

    # The innermost span open on the host where each gap begins: the open
    # instance that began last, over every thread.
    outside = 0.0
    active = []  # instances begun and not yet ended, by start
    k = 0
    for at, length in sorted((at, length) for length, at in gaps):
        while k < len(spans) and spans[k][0] <= at:
            active.append(k)
            k += 1
        active = [i for i in active if spans[i][1] > at]
        if active:
            out[spans[active[-1]][2]]["idle_at_s"] += length * 1e-6
        else:
            outside += length * 1e-6
    summary = dict(out)
    summary["idle_outside_s"] = outside
    summary["exchanges"] = exchanges
    return summary


def _spans(r):
    """A rank's spans, or nothing where its trace holds no device time (a
    CPU run)."""
    if not r or r.get("busy_s", 0) <= 0 or r.get("window_s", 0) <= 0:
        return {}
    return r.get("spans") or {}


def live_lane_pct(data):
    """100 x ``lanes_live`` / ``lanes_stepped`` of rank 0's device loop
    over the window: the share of the lanes its chunk steps ran that were
    alive."""
    c = (data["ranks"][0] or {}).get("counters") or {}
    if not c.get("lanes_stepped"):
        return None
    return 100.0 * c["lanes_live"] / c["lanes_stepped"]


def graph_gap_pct(data):
    """100 x the device idle inside rank 0's graph replays (between the
    nodes of one graph) / the window."""
    r = data["ranks"][0]
    replay = _spans(r).get(PREFIX + "replay")
    if not replay or not replay["count"]:
        return None
    return 100.0 * replay["idle_in_s"] / r["window_s"]


def exchange_wait_pct(data):
    """The mean over ranks of 100 x the sum over the window's exchanges of
    a rank's device seconds in the n-th exchange less the least of any
    rank's in it, / the rank's window: the wait for the slowest rank at
    each exchange.  Every rank runs the same exchanges in the same order;
    None where the ranks' counts differ."""
    ranks = data["ranks"]
    ex = [_spans(r).get("exchanges") for r in ranks]
    if len(ranks) < 2 or not all(ex) or len({len(x) for x in ex}) > 1:
        return None
    least = [min(col) for col in zip(*ex)]
    vals = [100.0 * sum(a - m for a, m in zip(mine, least)) / r["window_s"]
            for r, mine in zip(ranks, ex)]
    return sum(vals) / len(vals)


def exchange_idle_pct(data):
    """The mean over ranks of 100 x the device idle in the gaps that begin
    while the rank's host is inside an exchange / the window."""
    ranks = data["ranks"]
    vals = []
    for r in ranks:
        ex = _spans(r).get(PREFIX + "exchange")
        if not ex or not ex["count"]:
            return None
        vals.append(100.0 * ex["idle_at_s"] / r["window_s"])
    if len(vals) < 2:
        return None
    return sum(vals) / len(vals)
