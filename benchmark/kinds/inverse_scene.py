"""Inverse-rendering steps on a scene that brings its own materials, in a
closed loop, as ``kinds/inverse.py`` runs them (the value and gradient of
the image loss by ``make_batch_value_and_grad_fn``, made once, then Adam,
the box constraints and the loss read back), with three differences:

* the reference is the module that the configuration names under
  ``reference`` (``benchmark/<reference>.py``, with ``load(spec, device)``
  as ``benchmark/reference.py`` has it), which builds the scene from its
  own table;
* the target is the program's own render of the scene as published: one
  progressive render without gradient (``render.render``) at seed + 1, so
  its noise is not the steps' own; the steps then recover the materials
  from the traffic's initial values;
* the reference runs in blocks of pixels (:data:`BLOCK`), so a step of a
  large job fits beside the program's memory.

A traced run adds to its summary ``spans`` (``benchmark/spans.py`` over the
same trace) and ``counters`` (the window's change of
``ptx_torch.diff.inverse.STATS``); a program without them gives neither.
The CUDA graphs the device scan captured are counted across the window and
logged.

``correct``: as ``kinds/inverse.py`` judges it (``judge``), the first
steps' losses, first gradient and parameters' change against the
reference's, and every loss of the window finite.

:func:`control` gives the readings that bound the limits from above (the
reference in bfloat16, and on half of the pixels, each judged against the
whole float32 reference):

    python3 benchmark/kinds/inverse_scene.py --workload cornell.inverse \\
        --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common, spans, trace  # noqa: E402
from benchmark.kinds.frame import render_config  # noqa: E402
from benchmark.kinds.inverse import FIRST_STEPS, judge  # noqa: E402

# Pixels of one block of the reference's forward and backward.
BLOCK = 8192


def reference(ctx):
    """The configuration's reference module."""
    return importlib.import_module("benchmark." + ctx.config["reference"])


def prepare(ctx, cfg):
    """``(fs, static, target [P, 3], scene seconds)`` on ``ctx.device``:
    the scene and its acceleration structures for the traffic's fields,
    timed, and the target image."""
    import torch

    from ptx_torch import render as R

    fields = tuple(ctx.traffic["fields"])
    t0 = time.perf_counter()
    fs, static = R.load_scene(os.path.join(common.ROOT, ctx.config["scene"]),
                              quirks=cfg.quirks)
    fs, static = R.ensure_accel(fs, static, cfg, device=ctx.device,
                                param_fields=fields)
    load_s = time.perf_counter() - t0
    seed = (ctx.seed + 1) & 0xFFFFFFFF
    res = R.render(fs, static, dataclasses.replace(cfg, seed=seed),
                   device=ctx.device)
    target = torch.as_tensor(res.color.reshape(-1, 3), device=ctx.device)
    return fs, static, target, load_s


def _keep_events(prof) -> dict:
    """Makes the profiler's one export of its trace (a second raises) also
    keep the trace's events, under ``events`` of the dict returned."""
    kept = {}
    export = prof.export_chrome_trace

    def export_and_keep(path):
        export(path)
        with open(path) as f:
            kept["events"] = json.load(f)["traceEvents"]

    prof.export_chrome_trace = export_and_keep
    return kept


def _span_summary(events) -> dict:
    """``spans.summarize`` of the trace's window, with the window's idle
    gaps as ``trace.summarize`` finds them."""
    win = next(e for e in events if e.get("name") == trace.WINDOW
               and e.get("cat") == "user_annotation" and "dur" in e)
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    dev = []
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and "dur" in e:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                dev.append((s, t))
    gaps, cursor = [], w0
    for s, t in trace._union(dev):
        if s > cursor:
            gaps.append((s - cursor, cursor))
        cursor = max(cursor, t)
    if w1 > cursor:
        gaps.append((w1 - cursor, cursor))
    return spans.summarize(events, w0, w1, gaps)


def run(ctx) -> dict:
    import torch

    from ptx_torch.diff import inverse

    traffic = ctx.traffic
    fields = traffic["fields"]
    cfg = render_config(ctx.config, traffic, ctx.seed)
    n_pixels = cfg.width * cfg.height
    fs, static, target, load_s = prepare(ctx, cfg)
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=tuple(fields))
    init = {f: torch.full_like(getattr(fs, f), spec["init"])
            for f, spec in fields.items()}
    params = {f: v.clone().requires_grad_(True) for f, v in init.items()}
    opt = inverse.adam(params, traffic["lr"])
    beta1 = opt.param_groups[0]["betas"][0]

    def step():
        val, grads = vg(params, fs)
        for f, p in params.items():
            p.grad = grads[f]
        opt.step()
        with torch.no_grad():
            for f, p in params.items():
                p.copy_(torch.clamp(p, *fields[f]["clip"]))
        return float(val)

    losses, first_grad = [], None
    for i in range(FIRST_STEPS):
        losses.append(step())
        if i == 0:
            first_grad = {f: (opt.state[p]["exp_avg"] / (1.0 - beta1)).clone()
                          for f, p in params.items()}
    after = {f: p.detach().clone() for f, p in params.items()}
    ctx.sync()
    setup_s = time.time() - ctx.t_proc

    # Running totals of the program, where it has them.
    scan = getattr(vg, "integrator", None)
    captures = getattr(scan, "captures", None)
    stats = getattr(inverse, "STATS", None)
    stats0 = dataclasses.asdict(stats) if stats is not None else None

    times, window_losses = [], []
    units = traffic["trace_steps"] if ctx.trace else None
    deadline = time.perf_counter() + ctx.seconds

    def loop():
        while True:
            s0 = time.perf_counter()
            window_losses.append(step())
            end = time.perf_counter()
            times.append(end - s0)
            if (len(times) >= units if units is not None else end >= deadline):
                return

    summary = window_s = None
    if ctx.trace:
        with trace.profiled(ctx.device) as prof:
            ctx.sync()
            with torch.profiler.record_function(trace.WINDOW):
                loop()
                ctx.sync()
        kept = _keep_events(prof)
        summary = trace.summarize(prof, len(times))
        summary["scene_load_s"] = load_s
        summary["spans"] = _span_summary(kept.pop("events"))
        if stats is not None:
            summary["counters"] = {k: v - stats0[k] for k, v in
                                   dataclasses.asdict(stats).items()}
    else:
        ctx.sync()
        t_start = time.perf_counter()
        loop()
        ctx.sync()
        window_s = time.perf_counter() - t_start
    if captures is not None:
        ctx.log(f"graphs captured inside the window: "
                f"{scan.captures - captures}")
    peak = ctx.memory_peak()
    del vg, opt, params, fs, scan
    ctx.free()

    ctx.log(f"window: {len(times)} steps"
            + (f" in {window_s:.3f} s" if window_s is not None else ""))
    t_ref = time.perf_counter()
    ref_out = reference_steps(ctx, cfg, target, init, len(losses))
    ctx.log(f"losses {losses} against the reference's {ref_out[0]}")
    checks = judge(ctx, init, losses, first_grad, after, ref_out)
    ctx.log(f"the check took {time.perf_counter() - t_ref:.1f} s")
    checks.append(common.check(
        "nonfinite", float(sum(not np.isfinite(v) for v in window_losses)), 0))
    out = dict(attempted=len(times), failed=0, memory_peak_bytes=peak,
               summary=summary, checks=checks, e2e={"setup_s": setup_s})
    if window_s is not None:
        paths = n_pixels * cfg.samples
        out["e2e"]["grad_paths_per_s"] = common.rate(len(times), paths,
                                                     window_s)
        out["e2e"]["step_ms_p95"] = 1e3 * common.percentile(times, 95)
        out["window_s"] = window_s
    return out


def reference_steps(ctx, cfg, target, init, steps: int, dtype=None,
                    pixels=None):
    """The reference's ``steps`` first steps from ``init``, as
    ``kinds/inverse.py``'s ``reference_steps`` gives them (``(losses, first
    gradients, parameters after)``, Adam written out, the same box
    constraints), on the configuration's reference and in blocks of
    :data:`BLOCK` pixels, whose squared errors and gradients add up to the
    whole image's.  ``dtype``: the shading's precision; ``pixels``: the
    loss over the first ``pixels`` pixels only."""
    import torch

    from benchmark import reference as base

    traffic = ctx.traffic
    dev = ctx.device
    sc, bvh = reference(ctx).load(ctx.config["scene"], dev)
    n, s = pixels or cfg.width * cfg.height, cfg.samples
    p = {f: v.detach().clone() for f, v in init.items()}
    m = {f: torch.zeros_like(v) for f, v in p.items()}
    v2 = {f: torch.zeros_like(v) for f, v in p.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, traffic["lr"]
    losses, first = [], None
    for t in range(1, steps + 1):
        leaves = {f: x.clone().requires_grad_(True) for f, x in p.items()}
        loss = 0.0
        g = {f: torch.zeros_like(x) for f, x in p.items()}
        for lo in range(0, n, BLOCK):
            k = min(BLOCK, n - lo)
            pix = torch.arange(lo, lo + k, device=dev).repeat(s)
            smp = torch.arange(s, device=dev).repeat_interleave(k)
            c, _ = base.trace_paths(sc, bvh, ctx.config["semantics"],
                                    cfg.width, cfg.height, cfg.bounces,
                                    cfg.seed, pix, smp, params=leaves,
                                    dtype=dtype or torch.float32)
            mean = c.reshape(s, k, 3).sum(0) / s
            part = torch.sum((mean - target[lo:lo + k]) ** 2) / (n * 3)
            grads = torch.autograd.grad(part, list(leaves.values()))
            loss += float(part.detach())
            for f, x in zip(leaves, grads):
                g[f] += x
        losses.append(loss)
        if t == 1:
            first = {f: x.detach().clone() for f, x in g.items()}
        with torch.no_grad():
            for f in p:
                m[f] = b1 * m[f] + (1 - b1) * g[f]
                v2[f] = b2 * v2[f] + (1 - b2) * g[f] * g[f]
                step = lr * (m[f] / (1 - b1 ** t)) / (
                    torch.sqrt(v2[f] / (1 - b2 ** t)) + eps)
                p[f] = torch.clamp(p[f] - step, *traffic["fields"][f]["clip"])
    return losses, first, p


def control(ctx) -> dict:
    """The control's readings at the cell's own size, judged as a run
    judges the program: ``control`` (the reference's shading in bfloat16)
    and ``half_batch`` (the reference's steps on the first half of the
    pixels), each against the whole float32 reference, with ``correct``."""
    import gc

    import torch

    from benchmark.control import verdict

    cfg = render_config(ctx.config, ctx.traffic, ctx.seed)
    fs, _, target, _ = prepare(ctx, cfg)
    init = {f: torch.full_like(getattr(fs, f), spec["init"])
            for f, spec in ctx.traffic["fields"].items()}
    del fs
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    whole = reference_steps(ctx, cfg, target, init, FIRST_STEPS)
    out = {}
    low = reference_steps(ctx, cfg, target, init, FIRST_STEPS,
                          dtype=torch.bfloat16)
    out["control"] = verdict(judge(ctx, init, *low, whole))
    half = reference_steps(ctx, cfg, target, init, FIRST_STEPS,
                           pixels=cfg.width * cfg.height // 2)
    out["half_batch"] = verdict(judge(ctx, init, *half, whole))
    return out


def main(argv=None) -> int:
    import types

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = common.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = types.SimpleNamespace(config=cell["config"],
                                    traffic=cell["traffic"], seed=seed,
                                    device=torch.device(args.device),
                                    log=lambda msg: None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
