"""Cells of the benchmark cut to a size the CPU runs in seconds, and a
run of one, in this process or (for several ranks) in one process per
rank, with a fault planted in each rank first."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import multiprocessing
import time

from benchmark import common, run

SCENE = "arch:2000"


def cell(name: str, layout=None) -> dict:
    """The cell ``name`` cut to the CPU; ``layout`` replaces its
    configuration's ranks (a configuration that differs in that key
    alone)."""
    c = copy.deepcopy(common.cell(name))
    c["config"]["scene"] = SCENE
    if layout is not None:
        c["config"]["layout"] = layout
    t = c["traffic"]
    if t["kind"] == "frame":
        # A rank's slice of the pixels has to fill the device pass's lanes
        # (a multiple of 128), as a slice of the timed frame does.
        wide = layout is not None and (layout["comm"] == "ring"
                                       or layout["dp"] > 1)
        t["job"] = {"width": 32 if wide else 16, "height": 16, "samples": 3,
                    "bounces": 4}
        t["warmup_samples"] = 1
        t["trace_samples"] = 2
        t["check"]["pixels"] = 64
    else:
        t["job"] = {"width": 16, "height": 16, "samples": 2, "bounces": 3}
        t["trace_steps"] = 2
    return c


def _args(name, seed, seconds, trace, rank=0, port=0):
    return run.parse(["--workload", name, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace), "--device", "cpu",
                      "--rank", str(rank), "--port", str(port)])


def run_cell(name: str, seed: int = 3_000_000_019, seconds: float = 0.5,
             trace: int = 0, fault=None, layout=None):
    """``(exit code, result line or None)`` of one run of the tiny cell on
    the CPU; ``fault(monkeypatch-like setter)`` plants a fault first."""
    c = cell(name, layout)
    world = c["workload"]["chips"]
    if world == 1:
        out = io.StringIO()
        with _planted(fault), contextlib.redirect_stdout(out):
            code = run.run(_args(name, seed, seconds, trace), c)
        return code, _line(out.getvalue())
    ctx = multiprocessing.get_context("spawn")
    port = run._free_port()
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(name, seed, seconds, trace, r,
                                              port, c, fault, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.time() + 600
    while len(got) < world and time.time() < deadline:
        r, code, text = q.get(timeout=600)
        got[r] = (code, text)
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    code = max(abs(v[0]) for v in got.values()) if len(got) == world else 1
    return code, _line(got.get(0, (1, ""))[1])


def _rank(name, seed, seconds, trace, rank, port, c, fault, q):
    code, text = 1, ""
    try:
        with _planted(fault):
            line = run._run_rank(_args(name, seed, seconds, trace, rank, port),
                                 c, c["workload"]["chips"], port, time.time())
        code, text = 0, json.dumps(line) if line is not None else ""
    finally:
        q.put((rank, code, text))


@contextlib.contextmanager
def _planted(fault):
    undo = []

    def setattr_(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        if fault is not None:
            fault(setattr_)
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)


def _line(text: str):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None
