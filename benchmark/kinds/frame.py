"""Frames in a closed loop: one client submitting the same render job
again as soon as the last one finished, through
``ptx_torch.render.progressive_render``.

Set-up loads the scene, builds its acceleration structures (on several
ranks: each rank's shard, ``parallel.dist.prepare_scene``), makes the
sample function once (``render.make_sample_fn``, or what
``parallel.dist.render_distributed`` composes on a rank) and renders the
traffic's warm-up samples, which capture every program the frames run.
The window then renders frames back to back; every sample completed in it
counts, and it closes at the first sample that ends past ``--seconds``
(on several ranks, rank 0's clock decides for all, over a host group).
A traced run renders the traffic's ``trace_samples`` under the profiler
instead.

``correct``: the carry of the frame the window closed in (the running
mean of radiance and alpha, which the device pass folds in place) and the
result of the last finished frame, at pixels drawn from the seed, against
the plain reference (``benchmark/reference.py``) over the same samples.
Each rank gives the checked pixels it holds (``parallel.dist.pixel_range``:
all of them in reduce mode, its slice in dp or ring mode); two ranks that
hold one pixel have to agree on it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark import common, trace


class WindowClosed(Exception):
    """Raised from the progress hook to end the frame the window closes
    in."""


def render_config(config: dict, traffic: dict, seed: int):
    from ptx_torch.config import Quirks, RenderConfig

    job = traffic["job"]
    return RenderConfig(width=job["width"], height=job["height"],
                        samples=job["samples"], bounces=job["bounces"],
                        seed=seed & 0xFFFFFFFF,
                        quirks=Quirks(**config["semantics"]),
                        **config["renderer"])


def setup(ctx, cfg):
    """``(fs, static, sample_fn, batch_fn, k, replicate, pixels, load_s)``
    of this rank."""
    from ptx_torch import render as R

    t0 = time.perf_counter()
    fs, static = R.load_scene(ctx.config["scene"])
    layout = ctx.config["layout"]
    if ctx.world == 1:
        fs, static = R.ensure_accel(fs, static, cfg, device=ctx.device)
        load_s = time.perf_counter() - t0
        k = R.resolve_samples_per_launch(cfg)
        fn = (R.make_batched_sample_fn(static, cfg, k, ctx.device) if k > 1
              else R.make_sample_fn(static, cfg, ctx.device))
        replicate = pixels = None
    else:
        from ptx_torch.parallel import dist as pdist
        from ptx_torch.parallel import mesh as pmesh
        from ptx_torch.parallel.multihost import replicator

        comm = layout["comm"]
        plan = pmesh.Plan(layout["dp"], layout["tp"], layout["tp"] > 1)
        mesh = pmesh.make_mesh(plan, ctx.device)
        fs, static = pdist.prepare_scene(fs, static, cfg, plan, mesh,
                                         ctx.device)
        load_s = time.perf_counter() - t0
        k = R.resolve_samples_per_launch(cfg, ways=pdist.ray_ways(plan, comm))
        fn = pdist.make_distributed_sample_fn(static, cfg, mesh, plan, comm,
                                              k=k, device=ctx.device)
        replicate = replicator(mesh, comm)
        pixels = pdist.pixel_range(mesh, comm, cfg.width * cfg.height)
    return (fs, static, fn if k == 1 else None, fn if k > 1 else None, k,
            replicate, pixels, load_s)


def run(ctx) -> dict:
    import torch

    from ptx_torch import render as R
    from ptx_torch.integrator.graphs import DevicePass
    from ptx_torch.parallel import dist as pdist

    traffic = ctx.traffic
    cfg = render_config(ctx.config, traffic, ctx.seed)
    n_pixels = cfg.width * cfg.height
    fs, static, sample_fn, batch_fn, k, replicate, pixels, load_s = setup(ctx, cfg)
    dpass = sample_fn if sample_fn is not None else batch_fn
    if not isinstance(dpass, DevicePass):
        raise RuntimeError(f"the frame's sample function is a "
                           f"{type(dpass).__name__}, not the device pass "
                           "whose carry the check reads")

    def frame(c, progress=None):
        return R.progressive_render(fs, static, c, sample_fn, batch_fn, k,
                                    ctx.device, progress=progress,
                                    replicate=replicate, pixels=pixels)

    frame(dataclasses.replace(cfg, samples=traffic["warmup_samples"]))
    ctx.sync()
    ctx.barrier()
    captures = dpass.loop.captures
    setup_s = time.time() - ctx.t_proc

    # The window: frames back to back until a sample ends past the close.
    done = [0, 0]  # samples completed in the window, of the current frame
    frames = []
    ends = []  # the host clock at the end of each sample of the window
    units = traffic["trace_samples"] if ctx.trace else None
    deadline = time.perf_counter() + ctx.seconds

    def progress(s, total):
        ends.append(time.perf_counter())
        done[0] += s - done[1]
        done[1] = s
        if units is not None:
            stop = done[0] >= units
        else:
            stop = ctx.decide(time.perf_counter() >= deadline)
        if stop:
            raise WindowClosed
        if s == total:
            done[1] = 0

    def loop():
        while True:
            try:
                res = frame(cfg, progress)
            except WindowClosed:
                return
            frames[:] = [res]

    bytes0 = pdist.STATS.bytes
    summary = None
    if ctx.trace:
        with trace.profiled(ctx.device) as prof:
            ctx.sync()
            with torch.profiler.record_function(trace.WINDOW):
                loop()
                ctx.sync()
        summary = trace.summarize(prof, done[0])
        summary["scene_load_s"] = load_s
        summary["exchange_bytes"] = pdist.STATS.bytes - bytes0
        window_s = None
    else:
        ctx.sync()
        t0 = time.perf_counter()
        loop()
        ctx.sync()
        window_s = time.perf_counter() - t0
        ctx.log("seconds a sample: " + sample_spread(t0, ends))
    if dpass.loop.captures != captures:
        ctx.log(f"{dpass.loop.captures - captures} graphs captured inside "
                "the window")
    peak = ctx.memory_peak()

    # What the window produced, at the pixels the check reads.
    rng = np.random.default_rng(ctx.seed)
    px = np.sort(rng.choice(n_pixels, traffic["check"]["pixels"],
                            replace=False))
    lo, hi = pixels if pixels is not None else (0, n_pixels)
    own = px[(px >= lo) & (px < hi)]
    local = torch.as_tensor(own - lo, device=ctx.device)
    carry = (own, dpass.carry[0][local].cpu().numpy(),
             dpass.carry[1][local].cpu().numpy(), done[1])
    last = None
    if frames:
        res = frames[-1]
        last = (res.color.reshape(-1, 3)[px], res.alpha.reshape(-1)[px])
    carries = ctx.gather(carry)
    s_now = done[1]
    s_max = cfg.samples if frames else s_now
    del fs, sample_fn, batch_fn, dpass, frames, replicate
    ctx.free()

    out = dict(attempted=done[0], failed=0, memory_peak_bytes=peak,
               summary=summary)
    ctx.log(f"window: {done[0]} samples"
            + (f" in {window_s:.3f} s" if window_s is not None else ""))
    # The reference, each rank taking its share of the pixels.
    t_ref = time.perf_counter()
    share = reference_means(ctx, cfg, px[ctx.rank::ctx.world], s_now, s_max)
    shares = ctx.gather(share)
    if ctx.rank != 0:
        return out
    ref_means = [np.empty((len(px),) + x.shape[1:], x.dtype)
                 for x in shares[0]]
    for r, part in enumerate(shares):
        for whole, x in zip(ref_means, part):
            whole[r::ctx.world] = x
    now, differ = assemble(px, carries)
    checks = compare(ctx, now, last, ref_means, s_max,
                     differ if ctx.world > 1 else None)
    ctx.log(f"the check took {time.perf_counter() - t_ref:.1f} s")
    out["checks"] = checks
    out["e2e"] = {"setup_s": setup_s}
    if window_s is not None:
        out["e2e"]["paths_per_s"] = common.rate(done[0], n_pixels, window_s)
        out["window_s"] = window_s
    return out


def reference_means(ctx, cfg, px, s_now: int, s_max: int):
    """The reference's running mean of color and alpha at pixels ``px``
    after ``s_now`` and after ``s_max`` samples (numpy)."""
    import torch

    from benchmark import reference as ref

    dev = ctx.device
    sc, bvh = ref.load(ctx.config["scene"], dev)
    pix = torch.as_tensor(px, device=dev)
    k = pix.shape[0]
    # Every sample of every pixel in one wavefront, sample-major.
    c, a = ref.trace_paths(
        sc, bvh, ctx.config["semantics"], cfg.width, cfg.height, cfg.bounces,
        cfg.seed, pix.repeat(s_max),
        torch.arange(s_max, device=dev).repeat_interleave(k))
    mean_c, mean_a = ref.fold_mean(c.reshape(s_max, k, 3),
                                   a.reshape(s_max, k))
    now = max(s_now, 1) - 1
    return tuple(x.cpu().numpy() for x in (mean_c[now], mean_a[now],
                                           mean_c[-1], mean_a[-1]))


def sample_spread(t0: float, ends) -> str:
    """The seconds of each sample of a window that began at ``t0``:
    median, 90th percentile, largest, and how many took over 1.5 times
    the median (a stall, where the rest run steadily)."""
    if not ends:
        return "none finished"
    sec = np.diff(np.concatenate([[t0], ends]))
    med = float(np.median(sec))
    return (f"median {med:.4f}, p90 {float(np.percentile(sec, 90)):.4f}, "
            f"max {float(sec.max()):.4f}, over 1.5x median "
            f"{int((sec > 1.5 * med).sum())} of {len(sec)}")


def assemble(px, carries):
    """``((color, alpha, samples), differ)``: the carry at the checked
    pixels ``px`` (sorted) from each rank's ``(pixels it holds, color,
    alpha, samples)``, a pixel's value from the first rank that holds it
    (NaN where none does), and how many values disagree: a pixel that a
    later rank holds with another value, or a rank at another sample."""
    k = len(px)
    c0 = carries[0][1]
    color = np.full((k, 3), np.nan, c0.dtype)
    alpha = np.full(k, np.nan, carries[0][2].dtype)
    seen = np.zeros(k, bool)
    s_now = carries[0][3]
    differ = sum(int(c[3] != s_now) for c in carries[1:])
    for own, c, a, _ in carries:
        at = np.searchsorted(px, own)
        new = ~seen[at]
        again = at[~new]
        differ += int(np.sum(np.any(color[again] != c[~new], -1)
                             | (alpha[again] != a[~new])))
        color[at[new]], alpha[at[new]] = c[new], a[new]
        seen[at] = True
    return (color, alpha, s_now), differ


def compare(ctx, now, last, ref_means, s_max, differ=None):
    """The compared numbers: ``now``, the carry (the mean of the samples
    of the frame the window closed in: color, alpha, samples), and
    ``last``, the last finished frame's color and alpha, at the checked
    pixels, against the reference's means; ``differ``, of several ranks,
    the values on which they disagree (:func:`assemble`)."""
    limits = ctx.traffic["check"]
    color, alpha, s_now = now
    pairs = []  # (program color, alpha, reference color, alpha)
    if s_now > 0:
        pairs.append((color, alpha, *ref_means[:2]))
    if last is not None:
        pairs.append((*last, *ref_means[2:]))
    gaps = np.concatenate([pixel_gaps(*p) for p in pairs]) if pairs else \
        np.full(1, np.inf)
    program = np.concatenate([np.concatenate([p[0].ravel(), p[1].ravel()])
                              for p in pairs]) if pairs else np.zeros(0)
    checks = [
        common.check("gap_median", float(np.median(gaps)),
                     limits["gap_median"]),
        common.check("off_share", float((gaps > limits["off_gap"]).mean()),
                     limits["off_share"]),
        common.check("nonfinite", float((~np.isfinite(program)).sum()), 0),
    ]
    if differ is not None:
        checks.append(common.check("ranks_differ", differ, 0))
    ctx.log(f"checked {len(ref_means[0])} pixels at {s_now} samples"
            + (f" and a finished frame of {s_max}" if last is not None
               else ""))
    return checks


def pixel_gaps(color, alpha, ref_color, ref_alpha) -> np.ndarray:
    """Per pixel the widest gap of its color channels and alpha, each
    relative to the reference's value where that is above 1."""
    c = np.abs(color - ref_color) / np.maximum(np.abs(ref_color), 1.0)
    a = np.abs(alpha - ref_alpha) / np.maximum(np.abs(ref_alpha), 1.0)
    g = np.maximum(c.max(-1), a)
    return np.where(np.isfinite(g), g, np.inf)
