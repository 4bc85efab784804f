#!/usr/bin/env python3
"""The port of several checkouts on one H100, in turns: the tile plan, the
planned and small sweeps and the sample loop of each.

    python3 ab_trees.py NAME=DIR [NAME=DIR ...] [--rounds 1]
                        [--sweeps-only | --loop-only] [--out FILE]

Each DIR is a checkout of this repository: an earlier commit unpacked with
``git archive``, or a copy with an edited source (for example another
``CLUSTER`` in ``ptx_torch/csrc/tile_sweep.cu``).  A round runs one process
per checkout in the order given, then one per checkout backward (A B B A
for two).  A process puts DIR's ``ptx_torch`` first on ``sys.path``, builds
its kernels in DIR and, on ``arch:300000``:

* checks its plan (``_plan_tiles``) against ``sort_plan(_exact_gate(...))``
  and its closest, stats and any sweeps against DIR's plain version bit
  for bit (order, count, near; t, tri, visited, hit) on the ray sets of
  ``chip_smoke.py`` (32,768 and 8,192 camera and scattered rays, 8,192
  late-bounce rays whose last third of blocks is all-dead, and the 30,720
  camera rays of a 640x480 frame's launch), then times each by CUDA events
  over back-to-back calls (median of 3), beside the bound
  (``bench.sweep_work``: the plain version's visits and searched rays; the
  plan's slab tests), and the host time of one wrapper call (launch only,
  no synchronize); the plan also by ``torch.profiler``: its device kernels
  per call and their device time;
* on ``synthetic:2000`` (4 tiles), 32,768, 30,720 (a 640x480 frame's
  launch) and 8,192 camera and scattered rays: the small sweeps' lanes that
  differ from ``_small_sweep`` (t, tri, hit; reported, not raised, so an
  earlier tree's count shows), timed as the sweeps are;
  (``--loop-only`` skips the two items above);
* unless ``--sweeps-only``: runs the sample loop (``render.
  progressive_render`` over ``render.make_sample_fn``; 256x256, 4 spp, 4
  bounces, the default fused shader) on the tile traversal and on the bvh
  path in turns after a whole loop of each (paths/s of each turn), then
  one loop of each under ``chip_smoke.replay_split`` (the share of the
  wall in graph replays, and the idle time at launch edges and between
  iterations) and one profiled sample of each (device kernels, device busy
  ms, wall ms).

The card's ``nvidia-smi`` name and power limit head the output; the last
line is one JSON object with every process's numbers (also ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE = "arch:300000"
SMALL_SCENE = "synthetic:2000"
KERNELS = ("closest", "closest_stats", "any")
SMALL_KERNELS = ("closest_small", "any_small")
# The sample loop's cells (the smoke cell's config with these fields) and
# the order of their timed turns.
LOOP_CELLS = (("tile", {}), ("bvh", {"intersector": "bvh"}))
LOOP_TURNS = ("tile", "bvh", "bvh", "tile", "tile", "bvh")


def _smoke():
    """``chip_smoke.py`` beside this script, as a module (its ray sets,
    bounds and profiler); it imports whichever ``ptx_torch`` is first on
    ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def device_ms(fn, device, launches: int = 10, reps: int = 3) -> float:
    """Median over ``reps`` of the device ms per launch of ``fn`` over
    ``launches`` back-to-back calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return _median(times)


def host_us(fn, device, calls: int = 50) -> float:
    """Host microseconds per call of ``fn`` when nothing waits for the
    device (the wrapper's checks, allocation and launch)."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return t / calls * 1e6


def ray_sets(S, fs, static, device, big: int, chunk: int, frame: int):
    return [
        (f"camera {big}", *S.camera_rays(fs, 256, 256, big, device)),
        (f"scattered {big}", *S.scattered_rays(static, big, 7, device)),
        (f"camera {chunk}", *S.camera_rays(fs, 256, 256, chunk, device)),
        (f"scattered {chunk}", *S.scattered_rays(static, chunk, 7, device)),
        (f"late bounce {chunk}", *S.scattered_rays(static, chunk, 9, device,
                                                   live=S.LATE_LIVE)),
        (f"frame camera {frame}", *S.camera_rays(fs, *S.FRAME, frame, device)),
    ]


def small_sets(S, fs, static, device, big: int, chunk: int, frame: int):
    return [
        (f"camera {big}", *S.camera_rays(fs, 256, 256, big, device)),
        (f"scattered {big}", *S.scattered_rays(static, big, 8, device)),
        (f"frame camera {frame}", *S.camera_rays(fs, *S.FRAME, frame, device)),
        (f"frame scattered {frame}", *S.scattered_rays(static, frame, 8, device)),
        (f"camera {chunk}", *S.camera_rays(fs, 256, 256, chunk, device)),
        (f"scattered {chunk}", *S.scattered_rays(static, chunk, 8, device)),
    ]


def small_report(S, fs, sets, device, timed: bool = True) -> dict:
    """Per ray set on a scene of <= 4 tiles: the small sweeps' lanes that
    differ from ``_small_sweep`` (t, tri; hit), the bound and (``timed``)
    device ms per launch and host us per call."""
    from ptx_torch.kernels import intersect_cuda as K

    tiles = fs.ptiles
    out = {}
    for label, orig, dirn in sets:
        rays, _ = K._pack_rays(orig, dirn)
        calls = {"closest_small": lambda: K.closest_small(rays, tiles),
                 "any_small": lambda: K.any_small(rays, tiles)}
        want = K._small_sweep(rays, tiles, False)
        diffs = [int(S.lane_diffs(a, b).sum())
                 for a, b in zip(calls["closest_small"](), want)]
        diffs.append(int((calls["any_small"]() != K._small_sweep(rays, tiles, True))
                         .sum()))
        work = S.small_work(rays, tiles)
        row = {"rays": rays.shape[0], "differing_lanes": diffs, "kernels": {}}
        for name in SMALL_KERNELS:
            b_ms, b_by = S.bound(*work[name])
            k = {"bound_ms": b_ms, "bound_by": b_by}
            if timed:
                k["ms"] = device_ms(calls[name], device)
                k["host_us"] = host_us(calls[name], device)
            row["kernels"][name] = k
        out[label] = row
    return out


def plan_diffs(S, rays, boxes, plan) -> list:
    """Blocks where the plan differs from ``sort_plan(_exact_gate(...))``:
    [order, count, near]."""
    from ptx_torch.kernels import intersect_cuda as K

    want = K.sort_plan(*K._exact_gate(rays, boxes))
    return [int(S.lane_diffs(a, b).sum()) for a, b in zip(plan, want)]


def plan_row(S, rays, boxes, plan, device, timed: bool) -> dict:
    """The plan's bound and (``timed``) the ms per ``_plan_tiles`` call by
    CUDA events, its host us, and its device kernels and device us per
    call (``torch.profiler``, the median of 3 profiles of 20 calls)."""
    from ptx_torch.kernels import intersect_cuda as K

    b_ms, b_by = S.bound(*S.plan_work(rays, boxes, plan))
    row = {"bound_ms": b_ms, "bound_by": b_by}
    if timed:
        def call():
            return K._plan_tiles(rays, boxes)

        n, us = sorted((len(ev), sum(t for _, t in ev))
                       for ev in (S.device_events(call, 20) for _ in range(3)))[1]
        row.update(ms=device_ms(call, device), host_us=host_us(call, device),
                   device_kernels=n / 20, device_us=us / 20)
    return row


def sweep_report(S, fs, sets, device, timed: bool = True) -> dict:
    """Per ray set: the plan's counts and, for the plan and each planned
    sweep, its bound and (``timed``) device ms per call and host us per
    call (the plan also its profiled device kernels and device us per
    call).  Raises where the plan or a kernel differs from the plain
    version."""
    from ptx_torch import bench
    from ptx_torch.kernels import intersect_cuda as K

    tiles = fs.ptiles
    out = {}
    for label, orig, dirn in sets:
        rays, _ = K._pack_rays(orig, dirn)
        plan = K._plan_tiles(rays, fs.pboxes)
        p_diffs = plan_diffs(S, rays, fs.pboxes, plan)
        if any(p_diffs):
            raise AssertionError(f"{label}: the plan differs from sort_plan(_exact_gate)"
                                 f" on blocks (order, count, near) {p_diffs}")
        want_c = K._sweep(*plan, rays, tiles, False, stats=True)
        want_a, a_visited, searched = K._sweep(*plan, rays, tiles, True, stats=True)
        calls = {"closest": lambda: K.closest_sweep(*plan, rays, tiles),
                 "closest_stats": lambda: K.closest_sweep_stats(*plan, rays, tiles),
                 "any": lambda: K.any_sweep(*plan, rays, tiles)}
        diffs = [int(S.lane_diffs(a, b).sum())
                 for a, b in zip(calls["closest_stats"](), want_c)]
        diffs += [int(S.lane_diffs(a, b).sum())
                  for a, b in zip(calls["closest"](), want_c)]
        diffs.append(int((calls["any"]() != want_a).sum()))
        if any(diffs):
            raise AssertionError(f"{label}: differs from the plain version (t, tri, "
                                 f"visited of the stats sweep, t, tri, hit) {diffs}")
        work = {"closest": bench.sweep_work(plan, want_c[2], bench.SWEEP_RAY_BYTES),
                "any": bench.sweep_work(plan, a_visited, 32 + 4, searched)}
        work["closest_stats"] = work["closest"]
        count = plan[1]
        row = {"blocks": int(count.shape[0]),
               "all_dead_blocks": int((count == 0).sum()),
               "planned": int(count.sum()), "visited": int(want_c[2].sum()),
               "longest_walk": int(want_c[2].max()),
               "searched": int(searched.sum()), "kernels": {}}
        row["plan"] = plan_row(S, rays, fs.pboxes, plan, device, timed)
        for name in KERNELS:
            b_ms, b_by = S.bound(*work[name])
            k = {"bound_ms": b_ms, "bound_by": b_by}
            if timed:
                k["ms"] = device_ms(calls[name], device)
                k["host_us"] = host_us(calls[name], device)
            row["kernels"][name] = k
        out[label] = row
    return out


def loop_report(S, fs_np, static_np, cfg, device, turns=LOOP_TURNS):
    """The sample loop of each cell of LOOP_CELLS (a whole loop of each
    first, to capture its graphs) in ``turns``: paths/s per turn; then per
    cell one loop under ``chip_smoke.replay_split`` (the busy share of the
    wall in graph replays, the idle time at launch edges and between
    iterations) and one profiled sample of the production loop (device
    kernels, device busy ms, wall ms)."""
    import torch

    from ptx_torch import render as R

    paths = cfg.width * cfg.height * cfg.samples
    cells = {}
    for name, fields in LOOP_CELLS:
        c = dataclasses.replace(cfg, **fields)
        fs, static = R.ensure_accel(fs_np, static_np, c, device=device)
        cells[name] = (c, fs, static, R.make_sample_fn(static, c, device))

    def run(name, samples=None):
        c, fs, static, fn = cells[name]
        if samples is not None:
            c = dataclasses.replace(c, samples=samples)
        return R.progressive_render(fs, static, c, fn, None, 1, device)

    for name in cells:
        run(name)
    loop = []
    for name in turns:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run(name)
        torch.cuda.synchronize(device)
        loop.append({"cell": name,
                     "paths_per_s": paths / (time.perf_counter() - t0)})
    splits = {name: S.replay_split(lambda name=name: run(name))
              for name in cells}
    profiles = {}
    for name in cells:
        n_dev, busy, wall_ms, top = S.profile_sample(
            lambda fs, s, name=name: run(name, samples=1), cells[name][1])
        profiles[name] = {"device_kernels": n_dev, "busy_ms": busy,
                          "wall_ms": wall_ms,
                          "top": [[k[:80], ms, n] for k, (ms, n) in top[:3]]}
    return {"loop": loop, "split": splits, "profile": profiles}


def worker(root: str, sweeps_only: bool, loop_only: bool = False) -> dict:
    root = os.path.abspath(root)
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, root)]
    import torch

    import ptx_torch
    from ptx_torch import render as R
    from ptx_torch.kernels import _build

    if not os.path.abspath(ptx_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ptx_torch came from {ptx_torch.__file__}, not {root}")
    S = _smoke()
    dev = torch.device("cuda")
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "_kernel" in ln or "registers" in ln or "spill" in ln]
    cfg = R.RenderConfig(width=256, height=256, samples=4, bounces=4)
    fs_np, static_np = R.load_scene(SCENE)
    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    rec = {"root": root, "ptxas": ptxas}
    if not loop_only:
        sizes = (S.LAUNCH_RAYS, S.CHUNK_RAYS, S.FRAME_RAYS)
        sets = ray_sets(S, fs, static, dev, *sizes)
        fs_s, static_s = R.ensure_accel(*R.load_scene(SMALL_SCENE), cfg, device=dev)
        rec["sweeps"] = sweep_report(S, fs, sets, dev)
        rec["small"] = small_report(
            S, fs_s, small_sets(S, fs_s, static_s, dev, *sizes), dev)
    if not sweeps_only:
        rec.update(loop_report(S, fs_np, static_np, cfg, dev))
    return rec


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def summary(name, runs) -> list:
    """Lines of one checkout's medians over its processes."""
    lines = [f"{name}: {len(runs)} processes"]
    for label, row in runs[0].get("sweeps", {}).items():
        lines.append(f"  {label}: {row['blocks']} blocks ({row['all_dead_blocks']} "
                     f"all-dead), visited {row['visited']} of {row['planned']} "
                     f"planned, longest walk {row['longest_walk']}")
        p = [r["sweeps"][label]["plan"] for r in runs]
        ms, us = _median([x["ms"] for x in p]), _median([x["host_us"] for x in p])
        b = row["plan"]["bound_ms"]
        lines.append(f"    {'plan':14s} {ms:.4f} ms (bound {b:.4f}, "
                     f"{100 * b / ms:.0f} %), host {us:.1f} us per call; "
                     f"{_median([x['device_kernels'] for x in p]):.0f} device "
                     f"kernels, {_median([x['device_us'] for x in p]):.1f} device "
                     f"us per call")
        for k in KERNELS:
            ms = _median([r["sweeps"][label]["kernels"][k]["ms"] for r in runs])
            us = _median([r["sweeps"][label]["kernels"][k]["host_us"] for r in runs])
            b = row["kernels"][k]["bound_ms"]
            lines.append(f"    {k:14s} {ms:.4f} ms (bound {b:.4f}, "
                         f"{100 * b / ms:.0f} %), host {us:.1f} us per call")
    for label, row in runs[0].get("small", {}).items():
        lines.append(f"  {SMALL_SCENE} {label}: differing lanes (t, tri, hit) "
                     + ", ".join(str(r["small"][label]["differing_lanes"])
                                 for r in runs))
        for k in SMALL_KERNELS:
            ms = _median([r["small"][label]["kernels"][k]["ms"] for r in runs])
            us = _median([r["small"][label]["kernels"][k]["host_us"] for r in runs])
            b = row["kernels"][k]["bound_ms"]
            lines.append(f"    {k:14s} {ms:.4f} ms (bound {b:.4f}, "
                         f"{100 * b / ms:.0f} %), host {us:.1f} us per call")
    for r in runs:
        if "loop" in r:
            lines.append("  sample loop paths/s: " + ", ".join(
                f"{p['cell']} {p['paths_per_s']:,.0f}" for p in r["loop"]))
            for cell, split in r["split"].items():
                lines.append(f"  {cell} loop: {_smoke().split_line(split)}")
            lines.append("  profiled sample: " + "; ".join(
                f"{s} {p['device_kernels']} kernels, busy {p['busy_ms']:.1f} of "
                f"{p['wall_ms']:.1f} ms" for s, p in r["profile"].items()))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sweeps-only", action="store_true")
    ap.add_argument("--loop-only", action="store_true")
    ap.add_argument("--out", help="also write the JSON record here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sweeps_only and args.loop_only:
        ap.error("--sweeps-only and --loop-only exclude each other")
    if args.worker:
        print(json.dumps(worker(args.worker, args.sweeps_only, args.loop_only)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: ab_trees.py needs the card", file=sys.stderr)
        return 1
    if not args.trees:
        ap.error("name at least one checkout as NAME=DIR")
    trees = [spec.split("=", 1) for spec in args.trees]
    smi = _smi()
    print(smi, flush=True)
    runs = {name: [] for name, _ in trees}
    order = (trees + trees[::-1]) * args.rounds
    for name, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
        if args.sweeps_only:
            cmd.append("--sweeps-only")
        if args.loop_only:
            cmd.append("--loop-only")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            print(f"{name} ({root}) failed:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}",
                  flush=True)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["seconds"] = time.perf_counter() - t0
        runs[name].append(rec)
        print(f"{name}: process {len(runs[name])} done in {rec['seconds']:.0f} s",
              flush=True)
    for name, _ in trees:
        for line in summary(name, runs[name]):
            print(line, flush=True)
    print(smi, flush=True)
    line = json.dumps({"card": smi, "order": [n for n, _ in order], "runs": runs})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
