#!/usr/bin/env python3
"""One run of one benchmark cell of ``ptx_torch``:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the traffic's ``kind`` names its loop in
``benchmark/kinds/``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each read
by ``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, every compared number with its limit
(also the last lines of standard error).

Exits non-zero, printing no result, without enough CUDA devices for the
cell, or when the process holds the JAX package or JAX once the window
has closed.  A cell of several chips runs one rank per card: this process
is rank 0, starts the others and prints; ranks talk over NCCL, and over a
host (gloo) group for the window's close.
"""

from __future__ import annotations

import time

T_PROC = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common, trace  # noqa: E402

RANK_TIMEOUT = 300


class Refused(Exception):
    """A rank's process holds a module of ``common.FORBIDDEN`` once the
    window has closed: the run prints no result."""


@dataclasses.dataclass
class Ctx:
    """What a loop (``benchmark/kinds/<kind>.py``) is given: the cell's
    files, the run's arguments, this rank's place and device, and the
    rank-aware helpers it calls."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    rank: int
    world: int
    device: Any
    t_proc: float
    group: Any = None  # the host group of a multi-rank run

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist

        x = torch.tensor([int(flag)])
        dist.broadcast(x, 0, group=self.group)
        return bool(x.item())

    def gather(self, obj):
        """Every rank's ``obj`` on rank 0 (a list in rank order), None on
        the others."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        """Release the program's device memory before the reference runs."""
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def log(self, msg: str):
        print(f"[bench rank {self.rank}] {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank's place in a multi-rank run (set by rank 0 for the others).
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--cell", default=None, help=argparse.SUPPRESS)
    # The CPU rehearsal of the benchmark's tests (plain versions, gloo).
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = (json.loads(args.cell) if args.cell is not None
            else common.cell(args.workload))
    chips = cell["workload"]["chips"]
    common.set_cache_dirs()
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    return run(args, cell)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(args, cell: dict, world: int):
    port = _free_port()
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port),
               "--device", args.device, "--cell", json.dumps(cell)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, cwd=ROOT))
    return port, procs


def _stop_ranks(procs) -> list:
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=RANK_TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def run(args, cell: dict) -> int:
    """A run after the look for a chip: rank 0 prints the result line,
    once every other rank has ended."""
    world = cell["workload"]["chips"]
    procs = []
    port = args.port
    if world > 1 and args.rank == 0:
        port, procs = _start_ranks(args, cell, world)
    try:
        line = _run_rank(args, cell, world, port, T_PROC)
    except Refused as e:
        print(e, file=sys.stderr)
        return 3
    finally:
        codes = _stop_ranks(procs)
    if any(codes):
        print(f"ranks exited with {codes}", file=sys.stderr)
        return 1
    if line is None:
        return 0
    print(f"[bench rank 0] run: {time.time() - T_PROC:.1f} s since the "
          "process began", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def _run_rank(args, cell, world, port, t_proc) -> Optional[dict]:
    """This rank's part of a run; rank 0's result line (None on the
    others); raises :class:`Refused` on rank 0 where any rank's process
    holds a module of ``common.FORBIDDEN`` once the window has closed."""
    import torch

    group = None
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if world > 1:
        import torch.distributed as dist

        from ptx_torch.parallel import multihost

        multihost.initialize(coordinator_address=f"localhost:{port}",
                             num_processes=world, process_id=args.rank,
                             device=device)
        group = dist.new_group(backend="gloo")
    ctx = Ctx(workload=args.workload, config=cell["config"],
              traffic=cell["traffic"], seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), rank=args.rank, world=world,
              device=device, t_proc=t_proc, group=group)
    if device.type == "cuda":
        ctx.log(f"card: {common.card_power(args.rank)}")
    kind = common.load_module("kinds", cell["traffic"]["kind"])
    try:
        out = kind.run(ctx)
        ranks = ctx.gather({"summary": out.get("summary"),
                            "memory_peak_bytes": out["memory_peak_bytes"],
                            "forbidden": common.forbidden_modules()})
    finally:
        if world > 1:
            from ptx_torch.parallel import multihost

            multihost.shutdown()
    if args.rank != 0:
        return None
    line = result(ctx, cell, out, ranks)
    held = {r: sorted(set(got["forbidden"]) | set(
        common.forbidden_modules() if r == 0 else ()))
        for r, got in enumerate(ranks)}
    held = {r: names for r, names in held.items() if names}
    if held:
        raise Refused("; ".join(f"rank {r} holds {names} once its window "
                                "has closed" for r, names in held.items()))
    return line


def result(ctx: Ctx, cell: dict, out: dict, ranks: list) -> dict:
    """The result line from rank 0's loop output and every rank's
    summary."""
    metrics = {}
    if ctx.trace:
        data = dict(ranks=[r["summary"] for r in ranks], cell=ctx.workload,
                    device=_kind(ctx))
        for m in cell["per_layer"]:
            value = common.load_module("metrics", m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": _kind(ctx), "count": ctx.world,
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    line = {"correct": all(c["ok"] for c in out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace:
        summaries = [r["summary"] for r in ranks]
        device["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
        device["window_s"] = sum(s["window_s"] for s in summaries) / len(summaries)
        line["breakdown"] = trace.breakdown(summaries[0])
    line["checks"] = common.checks_line(out["checks"])
    return line


def _kind(ctx) -> str:
    import torch

    if ctx.device.type == "cuda":
        return torch.cuda.get_device_name(ctx.device)
    return "cpu"


if __name__ == "__main__":
    sys.exit(main())
