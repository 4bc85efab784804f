"""Inverse-rendering steps in a closed loop, as
``ptx_torch.diff.inverse.optimize`` runs them: the value and gradient of
the image loss (``make_batch_value_and_grad_fn``, made once), then Adam
(``inverse.adam``) and the box constraints, and the loss read back.

Set-up loads the scene and its acceleration structures, makes the target
image from the seed (no render) and the initial parameters from the
traffic file, builds the value-and-gradient function and the optimizer
once, and runs the first steps through the window's own step: they
capture the programs, and the reference follows them.  The window then
runs steps until one ends past ``--seconds``; every step counts and each
is timed alone (it ends in the loss read, a device sync).  A traced run
runs the traffic's ``trace_steps`` under the profiler instead.

``correct``: the first steps' losses, the first gradient as Adam holds it
(its first moment over ``1 - beta1``) and the parameters' change after
them, each leaf's norm against the reference's
(``benchmark/reference.py``, with its own Adam), and every loss of the
window finite.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from benchmark import common, trace
from benchmark.kinds.frame import render_config

FIRST_STEPS = 3


def run(ctx) -> dict:
    import torch

    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    traffic = ctx.traffic
    fields = traffic["fields"]
    cfg = render_config(ctx.config, traffic, ctx.seed)
    n_pixels = cfg.width * cfg.height
    dev = ctx.device
    t0 = time.perf_counter()
    fs, static = R.load_scene(ctx.config["scene"])
    fs, static = R.ensure_accel(fs, static, cfg, device=dev)
    load_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    target = torch.rand((n_pixels, 3), generator=gen, device=dev) \
        * traffic["target_scale"]
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
        with trace.profiled(dev) as prof:
            ctx.sync()
            with torch.profiler.record_function(trace.WINDOW):
                loop()
                ctx.sync()
        summary = trace.summarize(prof, len(times))
        summary["scene_load_s"] = load_s
    else:
        ctx.sync()
        t_start = time.perf_counter()
        loop()
        ctx.sync()
        window_s = time.perf_counter() - t_start
    peak = ctx.memory_peak()
    del vg, opt, params, fs
    ctx.free()

    ctx.log(f"window: {len(times)} steps"
            + (f" in {window_s:.3f} s" if window_s is not None else ""))
    t_ref = time.perf_counter()
    checks = compare(ctx, cfg, target, init, losses, first_grad, after)
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
    """The reference's ``steps`` first steps from ``init``: ``(losses,
    first gradients, parameters after)``, with Adam written out (optax's
    defaults, as the program's) and the same box constraints.  ``pixels``:
    the loss over the first ``pixels`` pixels only (a fault's reading)."""
    import torch

    from benchmark import reference as ref

    traffic = ctx.traffic
    dev = ctx.device
    sc, bvh = ref.load(ctx.config["scene"], dev)
    n, s = pixels or cfg.width * cfg.height, cfg.samples
    target = target[:n]
    pix = torch.arange(n, device=dev).repeat(s)
    smp = torch.arange(s, device=dev).repeat_interleave(n)
    p = {f: v.detach().clone() for f, v in init.items()}
    m = {f: torch.zeros_like(v) for f, v in p.items()}
    v2 = {f: torch.zeros_like(v) for f, v in p.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, traffic["lr"]
    losses, first = [], None
    for t in range(1, steps + 1):
        leaves = {f: x.clone().requires_grad_(True) for f, x in p.items()}
        c, _ = ref.trace_paths(sc, bvh, ctx.config["semantics"], cfg.width,
                               cfg.height, cfg.bounces, cfg.seed, pix, smp,
                               params=leaves,
                               dtype=dtype or torch.float32)
        mean = c.reshape(s, n, 3).sum(0) / s
        loss = torch.sum((mean - target) ** 2) / (n * 3)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(leaves, grads))
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


def gaps(init, losses, first_grad, after, ref_out) -> dict:
    """The three compared numbers of program readings against reference
    readings (see :func:`compare`)."""
    import torch

    r_losses, r_first, r_after = ref_out
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))

    def norm(x):
        return float(torch.linalg.vector_norm(x.double()))

    g_ref = {f: norm(x) for f, x in r_first.items()}
    med = statistics.median(g_ref.values())
    grad_gap = max(abs(norm(first_grad[f]) - g_ref[f]) / max(g_ref[f], med)
                   for f in g_ref)
    # Leaves whose gradient is nought to rounding move by round-off alone.
    moved = [f for f in g_ref if g_ref[f] >= 1e-3 * med]
    d_ref = {f: norm(r_after[f] - init[f]) for f in moved}
    med_d = statistics.median(d_ref.values())
    change_gap = max(abs(norm(after[f] - init[f]) - d_ref[f])
                     / max(d_ref[f], med_d) for f in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def compare(ctx, cfg, target, init, losses, first_grad, after) -> list:
    """The compared numbers: the largest relative gap of the first steps'
    losses; over the leaves, the largest gap of the first gradient's norm
    and of the norm of the parameters' change after the first steps, each
    relative to the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    ref_out = reference_steps(ctx, cfg, target, init, len(losses))
    ctx.log(f"losses {losses} against the reference's {ref_out[0]}")
    return judge(ctx, init, losses, first_grad, after, ref_out)


def judge(ctx, init, losses, first_grad, after, ref_out) -> list:
    """The compared numbers of readings put in the program's place
    against the reference's ``ref_out``, each beside its limit."""
    limits = ctx.traffic["check"]
    g = gaps(init, losses, first_grad, after, ref_out)
    return [common.check(k, v, limits[k]) for k, v in g.items()]
