"""``benchmark/spans.py`` on a Chrome trace made up for the test: which
span a device operation and an idle gap belong to, the idle inside a
span's device extent, the exchanges' cross-rank wait, and the summary that
``trace.summarize`` already gives, the same with and without the
program's spans."""

import json

import pytest

from benchmark import spans, trace

MAIN = dict(pid=1, tid=1)
DEVICE = dict(pid=0, tid=7)


def _x(cat, name, ts, dur, where=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args, **where)


def _call(name, ts, corr):
    return _x("cuda_runtime", name, ts, 2, correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, DEVICE, correlation=corr)


# A window of 1000 us: a sample holding one launch (two graph replays and
# an exchange), a kernel launched in the sample outside the launch, and
# one launched outside every span; a host operation runs where the gap at
# 560 us begins.
PROGRAM = [
    _x("user_annotation", "ptx.sample", 10, 890),
    _x("user_annotation", "ptx.launch", 20, 380),
    _x("user_annotation", "ptx.replay", 30, 10),
    _x("user_annotation", "ptx.replay", 50, 10),
    _x("user_annotation", "ptx.exchange", 100, 20),
]
HOST = [
    _x("user_annotation", trace.WINDOW, 0, 1000),
    _call("cudaGraphLaunch", 35, 1),
    _call("cudaGraphLaunch", 55, 2),
    _x("cpu_op", "nccl:all_reduce", 104, 10),
    _call("cudaLaunchKernel", 110, 3),
    _call("cudaLaunchKernel", 500, 4),
    _x("cpu_op", "aten::copy_", 550, 30),
    _call("cudaLaunchKernel", 950, 5),
]
DEVICE_OPS = [
    _kernel("sweep", 100, 50, 1), _kernel("shade", 160, 40, 1),
    _kernel("sweep", 200, 60, 2),
    _kernel("ncclDevKernel_AllReduce", 270, 30, 3),
    _kernel("fold", 520, 40, 4),
    _kernel("late", 960, 30, 5),
]
# The window's idle gaps, (length, start) in us: [0, 100), [150, 160),
# [260, 270), [300, 520), [560, 960), [990, 1000).
GAPS = [(100, 0), (10, 150), (10, 260), (220, 300), (400, 560), (10, 990)]


def test_spans_attribute_device_work_and_idle():
    got = spans.summarize(PROGRAM + HOST + DEVICE_OPS, 0.0, 1000.0, GAPS)
    us = pytest.approx
    replay, launch = got["ptx.replay"], got["ptx.launch"]
    sample, exchange = got["ptx.sample"], got["ptx.exchange"]
    assert [replay["count"], launch["count"], sample["count"],
            exchange["count"]] == [2, 1, 1, 1]
    assert replay["host_s"] == us(20e-6) and sample["host_s"] == us(890e-6)
    # Device work: a replay's graph kernels share its launch's correlation.
    assert replay["device_s"] == us(150e-6)
    assert exchange["device_s"] == us(30e-6)
    assert launch["device_s"] == us(180e-6)
    assert sample["device_s"] == us(220e-6)
    # Idle inside the extents: the replays' [100, 260] holds the gap
    # between two nodes of the first graph; the launch's [100, 300] also
    # the gap before the exchange's kernel; the sample's [100, 560] too
    # the wait for the fold.
    assert replay["idle_in_s"] == us(10e-6)
    assert launch["idle_in_s"] == us(20e-6)
    assert sample["idle_in_s"] == us(240e-6)
    # Idle at: the innermost span open on the host where a gap begins.
    assert launch["idle_at_s"] == us(240e-6)  # at 150, 260 and 300
    assert sample["idle_at_s"] == us(400e-6)  # at 560
    assert replay["idle_at_s"] == exchange["idle_at_s"] == 0.0
    assert got["idle_outside_s"] == us(110e-6)  # at 0 and at 990
    assert got["exchanges"] == [us(30e-6)]
    total = sum(v["idle_at_s"] for k, v in got.items()
                if k.startswith("ptx.")) + got["idle_outside_s"]
    assert total == us(sum(g[0] for g in GAPS) * 1e-6)


def test_spans_of_another_thread_and_of_no_thread():
    """A span holds the work its own thread launched: a call of another
    thread at the same time is not in it; a program without spans gives an
    empty summary."""
    other = dict(pid=1, tid=2)
    events = PROGRAM + HOST + DEVICE_OPS + [
        _x("cuda_runtime", "cudaLaunchKernel", 36, 2, other, correlation=9),
        _kernel("elsewhere", 400, 10, 9),
    ]
    got = spans.summarize(events, 0.0, 1000.0, GAPS)
    assert got["ptx.replay"]["device_s"] == pytest.approx(150e-6)
    assert spans.summarize(HOST + DEVICE_OPS, 0.0, 1000.0, GAPS) == {}


class _Profile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_trace_summary_is_the_same_with_the_programs_spans():
    """``trace.summarize`` gives the same busy and window seconds, kernels,
    device operations and idle seconds with the spans in the trace; a gap
    that begins where a host operation runs keeps its name, and one that
    began under no host operation now names the program's innermost
    span."""
    plain = trace.summarize(_Profile(HOST + DEVICE_OPS), 4)
    marked = trace.summarize(_Profile(PROGRAM + HOST + DEVICE_OPS), 4)
    for key in ("busy_s", "window_s", "units", "kernels", "device_ops"):
        assert marked[key] == plain[key], key
    assert sum(marked["gaps"].values()) == pytest.approx(
        sum(plain["gaps"].values()))
    assert marked["gaps"]["aten::copy_"] == plain["gaps"]["aten::copy_"]
    assert "ptx.launch" in marked["gaps"] and "ptx.launch" not in plain["gaps"]


def _rank(window_s=1.0, exchanges=(), idle_at=0.0, replay_idle=0.0,
          counters=None):
    r = dict(units=4, busy_s=0.8, window_s=window_s, kernels={},
             device_ops={}, gaps={},
             spans={"ptx.exchange": dict(count=len(exchanges), host_s=0.0,
                                         device_s=sum(exchanges),
                                         idle_in_s=0.0, idle_at_s=idle_at),
                    "ptx.replay": dict(count=3, host_s=0.0, device_s=0.5,
                                       idle_in_s=replay_idle, idle_at_s=0.0),
                    "idle_outside_s": 0.0, "exchanges": list(exchanges)})
    if counters is not None:
        r["counters"] = counters
    return r


def test_span_and_counter_readings():
    data = dict(ranks=[_rank(counters=dict(lanes_live=300, lanes_stepped=400,
                                           iterations=10, sorts=8),
                             replay_idle=0.05)])
    assert spans.live_lane_pct(data) == pytest.approx(75.0)
    assert spans.graph_gap_pct(data) == pytest.approx(5.0)
    # Nothing to read: no counters, no spans (a program without them), a
    # window without replays.
    bare = dict(units=4, busy_s=0.8, window_s=1.0)
    for fn in (spans.live_lane_pct, spans.graph_gap_pct,
               spans.exchange_wait_pct, spans.exchange_idle_pct):
        assert fn(dict(ranks=[bare, bare])) is None
    assert spans.live_lane_pct(dict(ranks=[_rank(counters=dict(
        lanes_live=0, lanes_stepped=0))])) is None
    # A CPU run's trace holds no device time.
    cpu = [dict(_rank(exchanges=(0.0, 0.0)), busy_s=0.0) for _ in range(2)]
    for fn in (spans.graph_gap_pct, spans.exchange_wait_pct,
               spans.exchange_idle_pct):
        assert fn(dict(ranks=cpu)) is None


def test_exchange_wait_takes_the_least_rank_of_each_exchange():
    # Exchange n's least device time over the ranks is its transfer; the
    # rest of each rank's is its wait for the slowest rank.
    ranks = [_rank(exchanges=(0.10, 0.02, 0.05), idle_at=0.01),
             _rank(exchanges=(0.01, 0.06, 0.05), idle_at=0.03),
             _rank(window_s=2.0, exchanges=(0.03, 0.02, 0.25), idle_at=0.02)]
    data = dict(ranks=ranks)
    want = [100 * (0.09 + 0.0 + 0.0) / 1.0, 100 * (0.0 + 0.04 + 0.0) / 1.0,
            100 * (0.02 + 0.0 + 0.20) / 2.0]
    assert spans.exchange_wait_pct(data) == pytest.approx(sum(want) / 3)
    assert spans.exchange_idle_pct(data) == pytest.approx(
        (1.0 + 3.0 + 1.0) / 3)
    # Ranks that ran different exchanges cannot be compared; one rank has
    # nothing to wait for.
    ranks[2] = _rank(exchanges=(0.03, 0.02))
    assert spans.exchange_wait_pct(data) is None
    assert spans.exchange_wait_pct(dict(ranks=ranks[:1])) is None
    assert spans.exchange_idle_pct(dict(ranks=ranks[:1])) is None
