#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ptx_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):
1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: nvcc builds ``ptx_torch/csrc/*.cu`` (timed); then the planned
   sweeps' branch-free reciprocal against ``__frcp_rn`` on all 2^32 float
   bit patterns (no difference where it keeps its own result);
3. each traversal kernel against its plain torch version, bit for bit, on
   the card: 32,768 camera rays and 32,768 seeded random rays from inside
   ``arch:300000`` (dead lanes parked, sorted as the wavefront is), then
   the main path's own sweep launch, the 8,192-ray chunk (64 blocks):
   camera rays, scattered rays, a late-bounce set whose last third of
   blocks is all-dead, and an adversarial set (origins inside many tile
   boxes, axis-aligned directions, blocks that enter no tile), and the
   camera rays of a 640x480 frame's 240-block launch; the plan
   (``_plan_tiles``, one kernel) against ``sort_plan(_exact_gate(...))``
   with its device kernels per call from the profiler; then
   ``synthetic:2000`` (4 tiles) at 32,768, 30,720 (the frame's launch) and
   8,192 rays: the planned
   sweeps on the identity plan, and the small sweeps against their plain
   version bit for bit (also on a copy whose tile 1 duplicates tile 0) and
   against the identity-plan sweeps (near-tie flips allowed); median times
   by CUDA events (the kernels' record keeps the scattered chunk's); then
   the device tile pack (``tiles.pack_tris``) against the attached host
   pack, bit for bit; then the first scene above FRUSTUM_PLAN_TILES
   (``synthetic:2200000``, 4,297 tiles; its load, host BVH build and pack
   timed): the device pack, and on 16,384 camera rays and an 8,192-ray
   scattered chunk the frustum plan's closest and any sweeps against their
   plain versions bit for bit and against the brute sweep (every tile in
   order; near-tie flips allowed);
4. the shadow-ray setup (``ptx_shadow_rays``: the sun sample, the shadow
   rays parked and packed) against its plain version on every lane and
   row, pad rows included, with compaction on and off, at 32,768, 8,192
   and 8,000 lanes, and its device kernels per call (1); the shade kernel
   against its plain version at 32,768 lanes, bit for bit on every lane of
   every output; both on the first bounce of the main path's wavefront and
   on seeded random inputs that reach every branch, the shade kernel under
   the three quirk sets, with and without a sun; the setup timed at 32,768
   and 8,192 lanes (the record keeps the chunk's);
5. the main path: ``ptx_torch.render.render`` on ``arch:300000`` at
   256x256, 4 spp, 4 bounces with the default config (shader "auto", the
   fused kernels, the device pass of phase 15), with every kernel's launch
   count (one shadow-ray setup per shade step); then the sample loop
   with shader "xla" and "auto" in turns (paths/s, device kernels per
   sample), and the two images against each other; then 64x64, 2 spp
   through the kernels against the plain brute-force intersector;
6. the small-scene path: ``synthetic:2000`` lit by the arch scene's sun at
   64x64, 2 spp, through the small sweeps, against the brute path;
7. the CLI writes a PNG;
8. the stats sweep (``ptx_closest_stats``) against its plain version, bit
   for bit on all three outputs, and its t and tri against
   ``ptx_closest``'s, with ``visited <= count`` on every block: the bench
   roofline's 131,072 camera rays on ``synthetic:262144`` and
   ``arch:262144`` and the 32,768 scattered rays on ``arch:300000`` (timed;
   its device time by CUDA events over back-to-back calls when the profiler
   holds no event of it);
9. the bench path: ``ptx_torch.bench.run_bench`` with the headline, the two
   tile-traversal rooflines and the brute roofline, its JSON on a line of
   its own, with every kernel's launch count.
10. the differentiable path (``ptx_torch.diff``) on ``arch:300000`` at the
   JAX bench's backward shape, 128x128, 4 spp, 4 bounces: 65,536 rays in
   two 32,768-ray chunks of ``make_batch_value_and_grad_fn``.  (a) Its
   route, the general scan (the CUDA plan and sweeps, the plain shade; on
   the card the device scan, held to the host scan in the same loss bit
   for bit and its gradients within ROUTE_REL_L2), against the fast path
   (the fused kernels' forward: plan, closest, any, shadow-ray setup and
   shade launch; the plain shade's backward at the
   recorded hits) for albedo, emission, roughness and sun energy: the
   images within the image tolerance, each gradient finite and within
   ROUTE_REL_L2 (pixels where a Monte Carlo decision flipped are left
   out), each route's forward time against its value and gradient; (b)
   ``tri_a`` through the general scan: finite, not all zero, and with
   ``split_geom_grad`` off equal up to summation order; at 32x32, 1 spp
   against the brute sweep (winner flips counted); (c) 3 Adam steps
   on albedo, emission and sun energy (the loss must fall) and 2 on
   ``tri_a``, loss and ms per step; (d) the two backward bench rows with
   their peak device memory.
11. the bvh path (``intersector="bvh"``): (a) the BVH walk's three entry
   points (``ptx_bvh_closest`` / ``ptx_bvh_any`` / ``ptx_bvh_visits``,
   ``csrc/bvh_traverse.cu``) against the plain walk
   (``ptx_torch.accel.traverse``) bit for bit on every output, the visit
   counts included, on ``arch:300000``: 32,768 camera rays, phase 3's
   32,768 scattered rays (parked lanes included) and the strided shadow
   rows of a fused step's first bounce; the closest winners against the
   tile traversal (hit masks on >= MIN_AGREE of rays, each winner flip a
   near tie); (b) each entry point timed, its bound from the set's own
   visit and triangle-test counts; (c) ``render`` at 256x256, 4 spp, 4
   bounces with ``intersector="bvh"``: the walk's, sun and shade kernels
   launched and no tile kernel, its image against the tile traversal's,
   its sample loop in turns with the tile traversal's (paths/s) and a
   profiled sample; (d) 2 samples with a checkpoint, then 4, bit-equal to
   the uninterrupted 4, the preview read back; (e) an env-lit glTF written
   to a temp dir, the fused against the plain shade; (f) the ``bvh-depth``
   view (its launches) and the CLI with ``--visualize bvh-depth``,
   ``--checkpoint``, ``--metrics`` and ``--profile``.
12. the multi-rank path (``ptx_torch.parallel``): the card's compute mode;
   (a) ``torch.distributed.run`` with one rank (NCCL) runs ``ptx_torch.cli
   render --distributed`` on the smoke cell, its PNG against the main
   path's image; (b) two gloo ranks sharing the card (this script with
   ``--rank-worker``, each with a timeout and its exit code checked) render
   the smoke cell as dp=2, tp=2 reduce and tp=2 ring through
   ``render_distributed``: each rank's launches of the plan, the sweeps,
   the shadow-ray setup and shade counted (> 0) and the plain versions
   counted (none), both ranks' images equal, each image against the main
   path's (dp bit-equal, asserted; tp's flips counted; each dp rank's
   sample function a device pass, asserted), then each layout's
   sample loop timed in the ranks (paths/s, the share of it in the
   collective helpers on a synchronized clock, bytes handed to them per
   sample: two ranks time-sharing one H100, not a scaling figure); (c) the
   textured quads at tp=2 with the texel pack sharded, bit-equal to the
   replicated pack and within 1e-5 of the single device; (d) each tp=2
   shard as its rank prepares it (its own tiles): the plan, closest and
   any sweeps against their plain versions bit for bit on the scattered
   chunk (timed, with its bounds), a first bounce's shadow rows and the
   camera chunk a ring hop brings; (e) the launch composition: a 640x480
   frame at 8 spp in 30,720- and 25,600-pixel launches, planned (every
   closest sweep against the walk of every tile in order on the same rays:
   each differing winner a tie of its truncated t, counted; the differing
   pixels counted) and with every tile walked in order (bit-equal); (f)
   in the two ranks of (b), each layout's distributed training step
   (``parallel.dist.make_distributed_train_step``: value, gradient and one
   Adam update of ``mat_albedo`` and ``mat_emissive``) on the smoke scene
   at 128x128, 4 spp, 4 bounces: each rank's plan and sweeps counted (> 0)
   and no plain version called, the two ranks' loss, gradients and
   parameters after the update bit-equal, the loss and gradients within
   1e-5 of the one-device ``make_batch_value_and_grad_fn`` (the pixels a
   near tie flipped left out on both sides: each side's own image is its
   target there), and per rank grad-paths/s (fastest of 3), peak device
   memory and the collective helpers' share of a step and its bytes.
13. the device loop (``ptx_torch.integrator.graphs.DeviceLoop``: CUDA
   graphs of the chunk step and the sort, the live count read one
   iteration late), the fused integrator's loop in phases 5-12 too:
   (a) ``torch.cuda.set_sync_debug_mode("error")`` around one eager
   8,192-lane chunk step of the tile traversal and of the bvh path, the
   sort of a 32,768-lane wavefront and the frustum plan on 4,200 tiles (each
   after one call that makes its constants); (b) renders of the smoke cell,
   a translucent cell (the columns at opacity 0.5), ``synthetic:2000`` lit
   by the sun and the bvh path, each through the device loop and through
   the host loop: every launch's radiance and alpha bit-equal, the PNG
   bytes equal; (c) per launch, the device loop's kernel launches (replays
   x their graphs' tallies) equal the host loop's plus one chunk step's
   for each all-dead chunk of the lag; (d) paths/s of the two loops in 3
   turns each (smoke cell and bvh), the device loop's busy share by CUDA
   events around each replay, and a profiled sample of each loop; (e)
   each loop's graphs, capture seconds, pool and buffer bytes; (f) one
   profiled sample of the host loop, its device time split by phase
   (plan, closest, any, shadow-ray setup, shade, sort, epilogue, material
   lookup, other).
14. the device scan (``ptx_torch.diff.graphs.DeviceScan``: CUDA graphs of
   each bounce step's forward and backward, the live count read one
   iteration late), the route of the loss functions on the card (phases
   10 and 12 (f) run it too) and ``inverse.make_diff_integrator``'s pick
   there, against the host scan (``make_integrator(differentiable=True)``)
   on the backward rows' scene and shape: (a)
   ``torch.cuda.set_sync_debug_mode("error")`` around one eager 32,768-lane
   step, forward and backward, for DIFF_FIELDS and ``tri_a``; (b) one
   value and gradient through each scan: the loss bit-equal, each gradient
   within ROUTE_REL_L2, for DIFF_FIELDS, ``tri_a`` (moved vertices, then
   the scene's: the tiles repacked per call read in place) and the
   translucent cell (passthrough steps, the lag's dead step); (c) one
   launch's value and gradient through each: the device scan's kernel
   launches (replays x their graphs' tallies) equal the host scan's plus
   one step's per all-dead step; (d) grad-paths/s of the two scans in 3
   turns each at 128x128 and at 256x256, 4 spp, for both sets; (e) the
   device scan's busy share by CUDA events around its replays, each scan's
   peak device memory, a profiled value and gradient of each at 128x128,
   and the device scan's graphs, capture seconds and pool bytes; (f)
   ``render_grad`` at 32x32 (DIFF_FIELDS; ``tri_a``, whose tiles are
   packed inside each step) and ``make_batch_loss_fn`` over two sample
   groups (the first group's forward run again before its backward)
   through both scans, loss bit-equal, gradients within ROUTE_REL_L2.
15. the device pass (``ptx_torch.integrator.graphs.DevicePass``: per
   launch one scalar copy, a prologue graph of the ids and camera rays, the
   device loop, an epilogue graph folding the launch into the carry in
   place), the route of ``render.render`` in phase 5, the CLI, the bench
   rows and phase 12's dp ranks (asserted there): (a) ``render.render``
   against the same render on the host loop with eager edges
   (``eager_render``), color and alpha bits and PNG bytes equal, with its
   device-pass calls and its kernels counted (each > 0), on the smoke cell
   (two launches per sample), the bvh path, the translucent cell,
   ``synthetic:2000`` lit by the sun at 128x128 x 5 spp (two samples per
   launch, the last batch ragged) and the claim blend at 128x128 x 3 spp
   (two per launch); a resume (2 samples, then 4) against the
   uninterrupted 4; (b) ``torch.cuda.set_sync_debug_mode("error")`` around
   a whole sample after warm-up (the lagged counts' event waits are no
   syncs), on the tile traversal, bvh and the batched cell; (c) a sample's
   kernel launches equal to the same device loop's with eager edges, its
   profiled device kernels, the loop's graphs, capture seconds and pool
   bytes; (d) paths/s through the pass and through the same loop with
   eager edges in 3 turns each, then one loop of each under
   ``replay_split`` (the busy share of the wall in graph replays, the idle
   time at launch edges and between iterations), on the tile traversal
   and bvh; (e) the device scan: a load graph per launch shape, the loss
   bit-equal and the gradients within ROUTE_REL_L2, grad-paths/s in 3
   turns against the host scan.
Every kernel's bound (the least time the card could take for the work of
the timed launch: its operations at the float32 peak or its bytes at the
HBM rate, whichever is larger) is computed from that launch's inputs.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_SCENE = "arch:300000"
SMALL_SCENE = "synthetic:2000"
LAUNCH_RAYS = 1 << 15
# The wavefront's chunk (integrator/wavefront.py CHUNK): the sweeps' launch
# on the main path, 64 blocks; and the live share of the late-bounce set,
# whose last third of blocks is all-dead.
CHUNK_RAYS = 1 << 13
LATE_LIVE = 2 / 3
# A 640x480 frame's launch (render.resolve_rays_per_batch): 30,720 rays, not
# a multiple of the chunk, so the wavefront steps them whole (240 blocks).
FRAME = (640, 480)
FRAME_RAYS = 30720
# Lanes of a shadow-ray setup check whose last 64 rows are padding.
PARTIAL_LANES = 8000
# The first scene above FRUSTUM_PLAN_TILES = 4096 tiles (4,297), and the
# frame of its camera rays (128 blocks).
BIG_SCENE = "synthetic:2200000"
BIG_FRAME = (128, 128)
# The small sweeps' agreement with the planned sweeps on the identity plan,
# whose exit rule may stop a block early (share of rays), and the relative
# t agreement where the closest winners differ (a near tie).  Every kernel
# equals its own plain version bit for bit.
MIN_AGREE = 0.9999
TIE_RTOL = 1e-4
# Image agreement of the kernel path with the brute-force path: the same
# tolerance as the CPU slice test against the JAX package.
COLOR_ATOL, MIN_PIXEL_SHARE = 1e-4, 0.99

REPLACES = {
    "exact_gate": ("ptx_torch/csrc/tile_plan.cu",
                   "ptx/kernels/intersect_pallas.py:329"),
    "closest": ("ptx_torch/csrc/tile_sweep.cu",
                "ptx/kernels/intersect_pallas.py:507"),
    "any": ("ptx_torch/csrc/tile_sweep.cu",
            "ptx/kernels/intersect_pallas.py:599"),
    "closest_small": ("ptx_torch/csrc/tile_sweep.cu",
                      "ptx/kernels/intersect_pallas.py:662"),
    "any_small": ("ptx_torch/csrc/tile_sweep.cu",
                  "ptx/kernels/intersect_pallas.py:678"),
    "sun": ("ptx_torch/csrc/shade.cu", "ptx/kernels/shade_pallas.py:172"),
    "shade": ("ptx_torch/csrc/shade.cu", "ptx/kernels/shade_pallas.py:239"),
    "closest_stats": ("ptx_torch/csrc/tile_sweep.cu",
                      "ptx/kernels/intersect_pallas.py:592"),
    "bvh_closest": ("ptx_torch/csrc/bvh_traverse.cu", "ptx/accel/traverse.py:25"),
    "bvh_any": ("ptx_torch/csrc/bvh_traverse.cu", "ptx/accel/traverse.py:25"),
    "bvh_visits": ("ptx_torch/csrc/bvh_traverse.cu", "ptx/accel/traverse.py:102"),
}
# The kernels each path must launch.
MAIN_PATH_KERNELS = ("exact_gate", "closest", "any", "sun", "shade")
SMALL_PATH_KERNELS = ("closest_small", "any_small", "sun", "shade")
BENCH_PATH_KERNELS = MAIN_PATH_KERNELS + ("closest_stats",)
BENCH_EXTRAS = ("pallas_intersect_roofline", "pallas_roofline_arch",
                "intersect_roofline")
STATS_SCENES = (("synthetic:262144", 1 << 17), ("arch:262144", 1 << 17))
# Each kernel's CUDA function in a profiler trace: (base name, its template
# arguments as demangled and as mangled, or None).
CUDA_FUNCTIONS = {
    "exact_gate": ("tile_plan_kernel", None),
    "closest": ("closest_sweep_kernel", ("<false>", "ILb0E")),
    "any": ("any_sweep_kernel", None),
    "closest_stats": ("closest_sweep_kernel", ("<true>", "ILb1E")),
    "closest_small": ("small_sweep_kernel", ("<false>", "ILb0E")),
    "any_small": ("small_sweep_kernel", ("<true>", "ILb1E")),
    "sun": ("shadow_rays_kernel", None),
    "shade": ("shade_kernel", ("<true>", "ILb1E")),
    "bvh_closest": ("bvh_walk_kernel", ("<0>", "ILi0E")),
    "bvh_any": ("bvh_walk_kernel", ("<1>", "ILi1E")),
    "bvh_visits": ("bvh_walk_kernel", ("<2>", "ILi2E")),
}
# Operations per unit of work, for the bounds (csrc comments): a ray-box
# slab test of tile_plan_kernel (per axis 2 subtractions, 2 multiplies,
# min, max and the running max and min; then the entry clamp, the
# comparison and the least entry); a lane of the sun and of the shade
# kernel (estimates from csrc/shade.cu: PCG4D draws, the cone sample and
# the origin; ~600 for the whole shading stage).  A Baldwin-Weber test is
# ptx_torch.bench.BW_FLOPS.
GATE_OPS = 28
SUN_OPS = 200
SHADE_OPS = 600


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed between two CUDA events (median of ``reps``), so no
    host time lies between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def device_events(fn, calls: int = 1):
    """``[(name, us)]`` of the device kernels of ``calls`` calls of ``fn``
    in a ``torch.profiler`` trace, after one call to warm up (the trace can
    miss an event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(name, fn, reps: int = 5, tries: int = 3):
    """Device time per launch of kernel ``name`` alone, without the host
    time of its wrapper: the mean over the launches a trace holds.  The
    trace can miss events, so one that holds none is taken again, up to
    ``tries`` times; None if none holds one."""
    base, marks = CUDA_FUNCTIONS[name]
    for _ in range(tries):
        us = [t for n, t in device_events(fn, reps)
              if base in n and (marks is None or any(m in n for m in marks))]
        if us:
            return sum(us) / 1e3 / len(us)
    return None


def kernels_per_call(name, call, calls: int = 10, tries: int = 3) -> float:
    """Device kernels per call of ``call`` in a profile of ``calls`` calls:
    every CUDA event counts.  The trace can miss events (never add one), so
    ``tries`` profiles are taken and the largest count of those that hold
    a kernel ``name`` is kept; raises if none holds one."""
    base = CUDA_FUNCTIONS[name][0]
    counts = []
    for _ in range(tries):
        names = [n for n, _ in device_events(call, calls)]
        if any(base in n for n in names):
            counts.append(len(names) / calls)
    if not counts:
        raise AssertionError(f"no {base} in {tries} profiles of {calls} calls")
    return max(counts)


def plan_kernels(tag, call) -> float:
    """Device kernels per plan call (:func:`kernels_per_call`); raises if a
    call ran more than two."""
    n_dev = kernels_per_call("exact_gate", call)
    if n_dev > 2:
        raise AssertionError(f"{tag}: the plan ran {n_dev:g} device kernels per call")
    return n_dev


def plan_work(rays, boxes, plan):
    """(operations, bytes) of a plan: its slab tests, and its inputs read
    and outputs written once."""
    nb, n_tiles = plan[0].shape
    return (nb * 128 * n_tiles * GATE_OPS,
            (rays.numel() + boxes.numel() + sum(t.numel() for t in plan)) * 4)


def small_work(rays, tiles):
    """(operations, bytes) of the closest and the any small sweep on these
    rays: every ray against every tile; the any sweep's rays still without
    a hit before each tile."""
    from ptx_torch.bench import BW_FLOPS, TILE_BYTES
    from ptx_torch.kernels import intersect_cuda as K

    n_rays, n_tiles = rays.shape[0], tiles.shape[0]
    nbytes = n_tiles * TILE_BYTES + n_rays * 32
    searched = sum(n_rays - int(K._small_sweep(rays, tiles[:k], True).sum())
                   if k else n_rays for k in range(n_tiles))
    return {"closest_small": (n_rays * n_tiles * K.TT * BW_FLOPS, nbytes + n_rays * 8),
            "any_small": (searched * K.TT * BW_FLOPS, nbytes + n_rays * 4)}


def bound(ops, nbytes):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    ``ops`` float32 operations and ``nbytes`` bytes, at its published
    peaks (``ptx_torch.bench.bound``)."""
    from ptx_torch import bench

    return bench.bound(ops, nbytes, bench.CARD_PEAKS["h100 80gb hbm3"])


def tensor_bytes(*objs, lanes):
    """Bytes of the per-lane tensors in ``objs`` (tensors, tuples, dicts):
    each ``[lanes, ...]`` tensor read or written once; broadcast views and
    scalars count nothing."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, dict):
            total += tensor_bytes(*o.values(), lanes=lanes)
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o, lanes=lanes)
        elif (torch.is_tensor(o) and o.dim() and o.shape[0] == lanes
              and o.stride(0) != 0):
            total += o.numel() * o.element_size()
    return total


def time_kernel(timing, name, tag, kernel_fn, plain_fn, reps, work):
    """CUDA-event medians of one call of the kernel's wrapper and of its
    plain version, the kernel's own device time, and the bound of the
    launch's ``work`` = (operations, bytes)."""
    ms, plain = median_ms(kernel_fn, reps), median_ms(plain_fn, reps)
    dev, dev_by = device_ms(name, kernel_fn, reps), "profiler"
    if dev is None:
        dev, dev_by = graph_ms(kernel_fn), "a CUDA graph of 20 calls"
    bound_ms, bound_by = bound(*work)
    timing[name] = dict(ms=ms, plain_ms=plain, device_ms=dev, device_by=dev_by,
                        bound_ms=bound_ms, bound_by=bound_by)
    log(f"{tag}: {name} kernel {ms:.4f} ms per call ({dev:.4f} ms on the device "
        f"alone, by {dev_by}), plain torch {plain:.3f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {work[0]:.4g} operations, {work[1]:.4g} bytes)")


def check_rcp(device):
    """The planned sweeps' branch-free reciprocal (``rcp_fast`` in
    ``csrc/tile_sweep.cu``) against ``__frcp_rn`` on every float bit
    pattern: it must differ nowhere it keeps its own result; where it sets
    its slow flag the sweeps take ``__frcp_rn``.  Returns (patterns that
    set the flag, those of them with exponent field 1..252, ms)."""
    import torch

    from ptx_torch.kernels import _build

    out = torch.zeros(3, dtype=torch.int64, device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _build.launch(_build.load().ptx_rcp_check, out.data_ptr())
    end.record()
    end.synchronize()
    bad, slow, slow_normal = out.tolist()
    log(f"rcp_fast vs __frcp_rn on all 2^32 floats: {bad} differ where it keeps "
        f"its result; {slow} set the slow flag ({slow_normal} of them with "
        f"exponent field 1..252); {start.elapsed_time(end):.2f} ms")
    if bad:
        raise AssertionError(f"rcp_fast differs from __frcp_rn on {bad} floats")
    return slow, slow_normal, start.elapsed_time(end)


def camera_rays(fs, width, height, n, device, first=0):
    """The main path's first launch: pixels first..first+n-1 of sample 0,
    in pixel order."""
    import torch

    from ptx_torch.scene.camera import generate_rays

    pix = torch.arange(first, first + n, dtype=torch.int32, device=device)
    orig, dirn = generate_rays(fs, pix, torch.zeros_like(pix), width, height)
    return orig.contiguous(), dirn


def scattered_rays(static, n, seed, device, live=0.75):
    """Second-bounce-like rays: seeded origins inside the scene box, random
    directions, a share ``1 - live`` of the lanes dead and parked, sorted
    dead-last by the wavefront's ray key (so the last blocks are all-dead,
    as in a late bounce)."""
    import numpy as np
    import torch

    from ptx_torch.kernels import sorting

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = torch.as_tensor(rng.random(n) < live, device=device)
    orig = torch.as_tensor(orig, dtype=torch.float32, device=device)
    dirn = torch.as_tensor(d, dtype=torch.float32, device=device)
    orig, dirn = sorting.park(orig, dirn, keep, static)
    key = sorting.ray_keys(orig, dirn, static.aabb_lo, static.aabb_hi)
    perm = torch.argsort(torch.where(keep, key, 1 << 30), stable=True)
    return orig[perm].contiguous(), dirn[perm].contiguous()


def adversarial_rays(fs, static, n, seed, device):
    """A set for the plan's ties and empty rows, three parts of whole
    blocks: origins at the scene box's centre (inside many tile boxes: ties
    at entry distance 0) with random directions; origins on the low corner
    of seeded tile boxes with axis-aligned directions (exact zeros: NaN
    slabs, ties at 0); origins far outside the scene pointing away from it
    (blocks that enter no tile)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    centre, extent = (lo + hi) / 2, float(np.abs(hi - lo).max())
    nb = n // 128
    a, b = nb * 3 // 8 * 128, nb * 5 // 8 * 128
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    orig = np.repeat(centre[None, :], n, 0)
    boxes = fs.pboxes.cpu().numpy()
    orig[a:b] = boxes[rng.integers(0, boxes.shape[0], b - a), 0:3]
    axis = rng.integers(0, 3, b - a)
    d[a:b] = 0.0
    d[np.arange(a, b), axis] = rng.choice([-1.0, 1.0], b - a)
    orig[b:] = centre + 10.0 * extent * d[b:]
    return (torch.as_tensor(orig, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


def compare_winners(tag, fs, orig, dirn, got, want):
    """Closest sweep results ``(t, tri)`` of two versions: hit masks equal,
    winners equal on >= MIN_AGREE of rays, and each differing winner a near
    tie (the exact Moller-Trumbore t of both agrees to TIE_RTOL).  Returns
    (share, flips, max |dt| where both agree)."""
    import torch

    from ptx_torch import geometry
    from ptx_torch.kernels.tiles import HIT_T

    (t_k, tri_k), (t_p, tri_p) = got, want
    hit_k, hit_p = t_k < HIT_T, t_p < HIT_T
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f"{tag}: closest hit mask differs")
    same = (tri_k == tri_p) | ~hit_k
    share = float(same.float().mean())
    flips = int((~same).sum())
    if flips:
        r = orig.shape[0]
        bad = (~same[:r]).nonzero()[:, 0]
        ta = [
            geometry.moller_trumbore(
                orig[bad], dirn[bad], fs.tri_a[tri[:r][bad].long()],
                fs.tri_e1[tri[:r][bad].long()], fs.tri_e2[tri[:r][bad].long()],
            )[0]
            for tri in (tri_k, tri_p)
        ]
        rel = float(((ta[0] - ta[1]).abs() / ta[1].abs().clamp(min=1e-30)).max())
        if rel > TIE_RTOL:
            raise AssertionError(f"{tag}: closest winner differs, rel t {rel}")
    if share < MIN_AGREE:
        raise AssertionError(f"{tag}: closest tri agrees on {share:.6f}")
    both = hit_k & hit_p & same
    err = float((t_k[both] - t_p[both]).abs().max()) if bool(both.any()) else 0.0
    return share, flips, err


def check_kernels(fs, static, ray_sets, label, timing, reps, plan_calls=True):
    """Kernel vs plain version on the card, bit for bit, for each (name,
    orig, dirn, timed): the gate, the closest sweep (t and tri) and the any
    sweep.  A timed set is timed; the record keeps the last one's times.
    With ``plan_calls`` each plan's device kernels per call are counted
    from profiles (:func:`plan_kernels`)."""
    import torch

    from ptx_torch import bench
    from ptx_torch.kernels import intersect_cuda as K

    tiles, boxes = fs.ptiles, fs.pboxes
    errs = {}
    for name, orig, dirn, timed in ray_sets:
        rays, _ = K._pack_rays(orig, dirn)
        tag = f"{label}/{name}"
        timed = timed and timing is not None
        if boxes.shape[0] > K.SMALL_TILES:
            plan = K._plan_tiles(rays, boxes)
            want = K.sort_plan(*K._exact_gate(rays, boxes))
            n_diff = [int(lane_diffs(a, b).sum()) for a, b in zip(plan, want)]
            if any(n_diff):
                raise AssertionError(f"{tag}: the plan differs from plain on blocks: "
                                     f"order {n_diff[0]}, count {n_diff[1]}, "
                                     f"near {n_diff[2]}")
            finite = torch.isfinite(want[2])
            errs["exact_gate"] = max(errs.get("exact_gate", 0.0), float(
                (plan[2] - want[2])[finite].abs().max()))
            calls = (f"; {plan_kernels(tag, lambda: K._plan_tiles(rays, boxes)):g} "
                     "device kernels per plan call" if plan_calls else "")
            log(f"{tag}: plan == sort_plan(_exact_gate) (order, count, near bit "
                f"for bit); {float(plan[1].float().mean()):.1f} tiles planned per "
                f"block, {int((plan[1] == 0).sum())} of {plan[1].shape[0]} blocks "
                f"all-dead, {int((plan[2][:, 0] == 0).sum())} entered at 0{calls}")
            if timed:
                time_kernel(timing, "exact_gate", tag,
                            lambda: K._plan_tiles(rays, boxes),
                            lambda: K.sort_plan(*K._exact_gate(rays, boxes)), reps,
                            plan_work(rays, boxes, plan))
        else:
            plan = K._plan(rays, boxes)

        got = K.closest_sweep(*plan, rays, tiles)
        want = K._sweep(*plan, rays, tiles, any_mode=False)
        n_diff = [int(lane_diffs(a, b).sum()) for a, b in zip(got, want)]
        if any(n_diff):
            raise AssertionError(f"{tag}: closest differs from plain: lanes t "
                                 f"{n_diff[0]}, tri {n_diff[1]}")
        errs["closest"] = max(errs.get("closest", 0.0),
                              float((got[0] - want[0]).abs().max()))
        a_k = K.any_sweep(*plan, rays, tiles)
        a_p = K._sweep(*plan, rays, tiles, any_mode=True)
        if not torch.equal(a_k, a_p):
            raise AssertionError(f"{tag}: any differs from plain on "
                                 f"{int((a_k != a_p).sum())} rays")
        errs["any"] = max(errs.get("any", 0.0), float((a_k - a_p).abs().max()))
        log(f"{tag}: closest == plain (t, tri bit for bit), "
            f"{float((got[0] < K.HIT_T).float().mean()):.3f} hit; any == plain, "
            f"{float(a_k.float().mean()):.3f} occluded")
        if timed:
            visited = K._sweep(*plan, rays, tiles, False, stats=True)[2]
            _, a_visited, searched = K._sweep(*plan, rays, tiles, True, stats=True)
            time_kernel(timing, "closest", tag,
                        lambda: K.closest_sweep(*plan, rays, tiles),
                        lambda: K._sweep(*plan, rays, tiles, False), reps,
                        bench.sweep_work(plan, visited, bench.SWEEP_RAY_BYTES))
            time_kernel(timing, "any", tag,
                        lambda: K.any_sweep(*plan, rays, tiles),
                        lambda: K._sweep(*plan, rays, tiles, True), reps,
                        bench.sweep_work(plan, a_visited, 32 + 4, searched))
    return errs


def check_small(fs, ray_sets, label, timing, reps):
    """The small sweeps (scenes of <= 4 tiles) on the card, for each (name,
    orig, dirn, timed): against their plain version bit for bit (t, tri,
    hit), on the scene and on a copy whose tile 1 duplicates tile 0 (every
    key of tile 1 ties with tile 0's: the earlier tile must win); and
    against the planned sweep kernels on the identity plan, whose exit rule
    may flip near ties.  A timed set is timed."""
    import torch

    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels.tiles import RB, _pack_rays, identity_plan

    tiles = fs.ptiles
    dup = tiles.clone()
    dup[1] = dup[0]
    errs = {"closest_small": 0.0, "any_small": 0.0}
    for name, orig, dirn, timed in ray_sets:
        rays, _ = _pack_rays(orig, dirn)
        for scene, tt in (("", tiles), (" (tile 1 = tile 0)", dup)):
            tag = f"{label}{scene}/{name}"
            got = K.closest_small(rays, tt)
            want = K._small_sweep(rays, tt, False)
            n_diff = [int(lane_diffs(a, b).sum()) for a, b in zip(got, want)]
            a_k, a_p = K.any_small(rays, tt), K._small_sweep(rays, tt, True)
            n_any = int((a_k != a_p).sum())
            log(f"{tag}: closest_small vs plain: differing lanes t {n_diff[0]}, "
                f"tri {n_diff[1]}; any_small vs plain: {n_any}; "
                f"{float((got[0] < K.HIT_T).float().mean()):.3f} hit, "
                f"{float(a_k.float().mean()):.3f} occluded")
            if any(n_diff) or n_any:
                raise AssertionError(f"{tag}: a small sweep differs from its plain "
                                     f"version")
            if tt is dup and bool(((got[1] // K.TT == 1) & (got[0] < K.HIT_T)).any()):
                raise AssertionError(f"{tag}: a winner lies in the duplicate tile")
        plan = identity_plan(rays.shape[0] // RB, tiles.shape[0], rays.device)
        share, flips, err = compare_winners(
            f"{label}/{name}", fs, orig, dirn, K.closest_small(rays, tiles),
            K.closest_sweep(*plan, rays, tiles))
        errs["closest_small"] = max(errs["closest_small"], err)
        a_k = K.any_small(rays, tiles)
        a_share = float((a_k == K.any_sweep(*plan, rays, tiles)).float().mean())
        if a_share < MIN_AGREE:
            raise AssertionError(f"{label}/{name}: any_small vs identity-plan sweep "
                                 f"agrees on {a_share:.6f}")
        log(f"{label}/{name}: vs the identity-plan sweeps: closest tri agrees on "
            f"{share:.6f} of rays ({flips} near-tie flips), any on {a_share:.6f}")
        if timed and timing is not None:
            work = small_work(rays, tiles)
            time_kernel(timing, "closest_small", f"{label}/{name}",
                        lambda: K.closest_small(rays, tiles),
                        lambda: K._small_sweep(rays, tiles, False), reps,
                        work["closest_small"])
            time_kernel(timing, "any_small", f"{label}/{name}",
                        lambda: K.any_small(rays, tiles),
                        lambda: K._small_sweep(rays, tiles, True), reps,
                        work["any_small"])
    return errs


def check_stats(label, fs, orig, dirn, timing, reps):
    """The stats sweep on the card against its plain version, bit for bit
    on all three outputs; its t and tri against the closest sweep kernel's;
    visited <= count on every block.  Returns max |t| error (0)."""
    import torch

    from ptx_torch import bench
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels.tiles import _pack_rays

    rays, _ = _pack_rays(orig, dirn)
    plan = K._plan_tiles(rays, fs.pboxes)
    tiles = fs.ptiles
    got = K.closest_sweep_stats(*plan, rays, tiles)
    want = K._sweep(*plan, rays, tiles, False, stats=True)
    n_diff = [int(lane_diffs(a, b).sum()) for a, b in zip(got, want)]
    log(f"{label}: closest_stats vs plain: differing values t {n_diff[0]}, "
        f"tri {n_diff[1]}, visited {n_diff[2]}")
    if any(n_diff):
        raise AssertionError(f"{label}: closest_stats differs from its plain version")
    t_c, tri_c = K.closest_sweep(*plan, rays, tiles)
    if lane_diffs(got[0], t_c).any() or not torch.equal(got[1], tri_c):
        raise AssertionError(f"{label}: closest_stats t / tri differ from ptx_closest's")
    visited, count = got[2], plan[1]
    if not bool((visited <= count).all()):
        raise AssertionError(f"{label}: a block visited more tiles than it planned")
    log(f"{label}: t, tri == ptx_closest's; {int(visited.sum())} tiles visited "
        f"of {int(count.sum())} planned ({float(visited.float().mean()):.2f} "
        f"per block, {int((visited < count).sum())} of {count.shape[0]} blocks "
        f"stopped early)")
    if timing is not None:
        time_kernel(timing, "closest_stats", label,
                    lambda: K.closest_sweep_stats(*plan, rays, tiles),
                    lambda: K._sweep(*plan, rays, tiles, False, stats=True), reps,
                    bench.sweep_work(plan, visited, bench.SWEEP_RAY_BYTES))
    return float((got[0] - want[0]).abs().max())


def check_pack(label, fs):
    """The device pack (``tiles.pack_tris`` on the scene's tensors on the
    card) against the host pack attached to the scene (``attach_tiles``,
    numpy), bit for bit on every tile and box.  Returns its ms by CUDA
    events (median of 3)."""
    from ptx_torch.kernels import tiles

    got = tiles.pack_tris(fs)
    n_diff = [int(lane_diffs(a, b).sum())
              for a, b in zip(got, (fs.ptiles, fs.pboxes))]
    ms = median_ms(lambda: tiles.pack_tris(fs), 3, warmup=0)
    log(f"{label}: pack_tris on the card vs attach_tiles: differing tiles "
        f"{n_diff[0]}, boxes {n_diff[1]} of {fs.ptiles.shape[0]}; {ms:.2f} ms")
    if any(n_diff):
        raise AssertionError(f"{label}: the device pack differs from attach_tiles")
    return ms


def check_above_frustum(cfg, device):
    """The first card check above FRUSTUM_PLAN_TILES: ``BIG_SCENE`` (load,
    host BVH build, pack timed), the device pack against the host one, and
    on camera rays of a small frame and a scattered chunk, the frustum plan
    with the closest and any sweep kernels against their plain versions
    bit for bit, then against the brute sweep (every tile in tile order,
    ``_small_sweep``): closest winners under the near-tie allowance
    (:func:`compare_winners`), any hit on >= MIN_AGREE of rays."""
    from ptx_torch import render as R
    from ptx_torch.accel import bvh, native
    from ptx_torch.kernels import intersect_cuda as K

    t0 = time.perf_counter()
    fs_np, static = R.load_scene(BIG_SCENE)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs_np, static = bvh.build_bvh(fs_np, static)
    t_bvh = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs, static = R.ensure_accel(fs_np, static, cfg, device=device)
    t_pack = time.perf_counter() - t0
    tiles = fs.ptiles
    log(f"{BIG_SCENE}: {static.n_tris} triangles, {tiles.shape[0]} tiles; load "
        f"{t_load:.1f} s, host BVH build "
        f"({'native' if native.available() else 'numpy'} builder) {t_bvh:.1f} s, "
        f"host pack + upload {t_pack:.1f} s")
    if tiles.shape[0] <= K.FRUSTUM_PLAN_TILES:
        raise AssertionError(f"{BIG_SCENE}: {tiles.shape[0]} tiles, not above "
                             f"{K.FRUSTUM_PLAN_TILES}")
    check_pack(BIG_SCENE, fs)
    for name, orig, dirn in (
            (f"camera {BIG_FRAME[0]}x{BIG_FRAME[1]}",
             *camera_rays(fs, *BIG_FRAME, BIG_FRAME[0] * BIG_FRAME[1], device)),
            ("scattered chunk", *scattered_rays(static, CHUNK_RAYS, 7, device))):
        tag = f"{BIG_SCENE}/{name}"
        rays, _ = K._pack_rays(orig, dirn)
        plan = K._plan_tiles(rays, fs.pboxes)
        got = K.closest_sweep(*plan, rays, tiles)
        want = K._sweep(*plan, rays, tiles, any_mode=False)
        n_diff = [int(lane_diffs(a, b).sum()) for a, b in zip(got, want)]
        a_k = K.any_sweep(*plan, rays, tiles)
        n_any = int((a_k != K._sweep(*plan, rays, tiles, any_mode=True)).sum())
        log(f"{tag}: frustum plan, {float(plan[1].float().mean()):.1f} tiles planned "
            f"per block; closest vs plain: differing lanes t {n_diff[0]}, tri "
            f"{n_diff[1]}; any vs plain: {n_any}")
        if any(n_diff) or n_any:
            raise AssertionError(f"{tag}: a sweep differs from its plain version")
        share, flips, _ = compare_winners(tag, fs, orig, dirn, got,
                                          K._small_sweep(rays, tiles, False))
        a_share = float((a_k == K._small_sweep(rays, tiles, True)).float().mean())
        log(f"{tag}: vs the brute sweep ({tiles.shape[0]} tiles in order): closest "
            f"tri agrees on {share:.6f} of rays ({flips} near-tie flips), "
            f"{float((got[0] < K.HIT_T).float().mean()):.3f} hit; any on "
            f"{a_share:.6f}, {float(a_k.float().mean()):.3f} occluded")
        if a_share < MIN_AGREE:
            raise AssertionError(f"{tag}: any hit agrees with brute on {a_share:.6f}")
        times = {k: median_ms(fn, 3) for k, fn in (
            ("plan", lambda: K._plan_tiles(rays, fs.pboxes)),
            ("closest", lambda: K.closest_sweep(*plan, rays, tiles)),
            ("any", lambda: K.any_sweep(*plan, rays, tiles)))}
        log(f"{tag}: ms per call by CUDA events: "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


def lane_diffs(a, b):
    """Lanes where two [R] or [R, 3] tensors differ in any bit."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    d = a != b
    return d.reshape(d.shape[0], -1).any(-1)


def first_bounce(fs, static, cfg, n, device):
    """The main path's first bounce on ``n`` camera rays: the wavefront, its
    closest hit, material, environment, the shadow-ray setup (sun sample,
    rays parked and packed) and the shadow rays traced (kernels
    throughout).  The last item is the shadow-ray setup's arguments."""
    import torch

    from ptx_torch.integrator.wavefront import _env_radiance, initial_state
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels import shade_cuda as S
    from ptx_torch.kernels import sorting
    from ptx_torch.scene import textures

    pix = torch.arange(n, dtype=torch.int32, device=device)
    state = initial_state(fs, cfg, pix, torch.zeros_like(pix))
    h = K.closest(fs, state.orig, state.dirn)
    mat = textures.material_lookup(fs, h.mat_id, h.uv, static)
    env = _env_radiance(fs, static, cfg, state.dirn)
    sun, energy = S.sun_constants(fs)
    sun_args = (cfg.seed, 0, state.pixel_ids, state.sample_ids, state.alive,
                h.hit, h.normal, h.position, sun, sorting.park_constants(static))
    d_sun, exists, rays = S.shadow_rays(*sun_args)
    shadow_hit = K.any_hit_rows(fs, rays, n)
    return state, h, mat, env, (d_sun, exists, shadow_hit), energy, sun_args


def lanes(args, n):
    """The shadow-ray setup's arguments cut to their first ``n`` lanes."""
    import torch

    return tuple(a[:n] if torch.is_tensor(a) else a for a in args)


def check_shade(fs, static, cfg, device, timing, reps):
    """The sun and shade kernels against their plain versions, bit for bit
    on every lane of every output: the main path's first bounce and seeded
    random inputs, three quirk sets, with and without a sun."""
    import torch

    from ptx_torch.kernels import shade_cuda as S

    errs = {"sun": 0.0, "shade": 0.0}
    state, h, mat, env, sun, energy, sun_args = first_bounce(
        fs, static, cfg, LAUNCH_RAYS, device)
    rnd = S.random_inputs(LAUNCH_RAYS, cfg.bounces, seed=11)
    r_state, r_h, r_mat, r_env, r_sun = S.inputs_from_arrays(rnd, device)
    r_energy = (6.0, 5.6, 5.0)
    r_sun_args = (cfg.seed, 2, r_state.pixel_ids, r_state.sample_ids,
                  r_state.alive, r_h.hit, r_h.normal, r_h.position,
                  *sun_args[-2:])

    def compare(tag, names, got, want, kernel):
        counts = {}
        for nm, a, b in zip(names, got, want):
            counts[nm] = int(lane_diffs(a, b).sum())
            if a.dtype == torch.float32:
                both = torch.isfinite(a) & torch.isfinite(b)
                errs[kernel] = max(errs[kernel],
                                   float((a[both] - b[both]).abs().max()))
        log(f"{tag}: differing lanes: "
            + ", ".join(f"{nm} {n}" for nm, n in counts.items()))
        if any(counts.values()):
            raise AssertionError(f"{tag}: the {kernel} kernel differs from its "
                                 f"plain version")

    # The shadow-ray setup on every lane of d_sun and exists and every row
    # of rays: compaction on (parked rows) and off, 32,768 and 8,192 lanes
    # and 8,000 (whose last 64 rows are padding).
    for tag, args in (("first bounce", sun_args), ("random", r_sun_args)):
        for compact in (True, False):
            a = args if compact else args[:-1] + (None,)
            for n in (LAUNCH_RAYS, CHUNK_RAYS, PARTIAL_LANES):
                got = S.shadow_rays(*lanes(a, n))
                if got[2].shape[0] != -(-n // 128) * 128:
                    raise AssertionError(f"sun/{tag}: {got[2].shape[0]} ray rows")
                compare(f"sun/{tag}/{'parked' if compact else 'not parked'}/{n}",
                        ("d_sun", "exists", "rays"), got,
                        S._shadow_rays(*lanes(a, n)), "sun")
    n_dev = kernels_per_call("sun", lambda: S.shadow_rays(*lanes(sun_args, CHUNK_RAYS)))
    log(f"sun: {n_dev:g} device kernels per shadow_rays call "
        f"(sample, park and pack)")
    if n_dev > 1:
        raise AssertionError(f"the shadow-ray setup ran {n_dev:g} device kernels")
    out_names = ("orig", "dirn", "radiance", "throughput", "alpha", "alive",
                 "bounce")
    quirk_sets = type(cfg.quirks)
    for qname, quirks in (("worker", quirk_sets()),
                          ("monolithic", quirk_sets.monolithic()),
                          ("physical", quirk_sets.physical())):
        cq = dataclasses.replace(cfg, quirks=quirks)
        for tag, it, ins in (("first bounce", 0, (state, h, mat, env, sun, energy)),
                             ("random", 2, (r_state, r_h, r_mat, r_env, r_sun, r_energy))):
            for has_sun in (True, False):
                st, hh, mm, ee, ss, en = ins
                args = (cq, it, st, hh, mm, ee) + ((ss, en) if has_sun else ())
                compare(f"shade/{tag}/{qname}/{'sun' if has_sun else 'no sun'}",
                        out_names, S.shade(*args)[:7], S._shade(*args)[:7], "shade")
    alive_out = S.shade(cfg, 0, state, h, mat, env, sun, energy).alive
    log(f"first bounce: {float(state.alive.float().mean()):.3f} alive in, "
        f"{float(alive_out.float().mean()):.3f} alive out, "
        f"{float(sun[1].float().mean()):.3f} sun up, "
        f"{float(sun[2].float().mean()):.3f} shadowed")
    if timing is not None:
        # The shadow-ray setup at 32,768 lanes, then at the main path's own
        # 8,192-lane chunk (the record keeps the chunk's times).
        for n in (LAUNCH_RAYS, CHUNK_RAYS):
            a = lanes(sun_args, n)
            time_kernel(timing, "sun", f"first bounce, {n} lanes",
                        lambda: S.shadow_rays(*a), lambda: S._shadow_rays(*a),
                        reps, (n * SUN_OPS, tensor_bytes(a, S.shadow_rays(*a),
                                                         lanes=n)))
            log(f"first bounce, {n} lanes: sun kernel "
                f"{graph_ms(lambda: S.shadow_rays(*a)):.4f} ms per call in a "
                f"CUDA graph of 20 calls (the launch gaps included)")
        tag = f"first bounce, {LAUNCH_RAYS} lanes"
        n = LAUNCH_RAYS
        shade_args = (cfg, 0, state, h, mat, env, sun, energy)
        time_kernel(timing, "shade", tag, lambda: S.shade(*shade_args),
                    lambda: S._shade(*shade_args), reps,
                    (n * SHADE_OPS, tensor_bytes(shade_args[2:], S.shade(*shade_args),
                                                 lanes=n)))
    return errs


def profile_sample(sample_fn, fs):
    """One profiled sample: (device events, device busy ms, wall ms, the
    device ms and count of the 8 costliest kernel names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sample_fn(fs, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample_fn(fs, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return len(spans), busy / 1e3, wall * 1e3, top


def image_agreement(a, b):
    d = abs(a.color - b.color).max(-1)
    return (
        float((d <= COLOR_ATOL).mean()),
        float((a.alpha == b.alpha).mean()),
        float((abs(a.image.astype(int) - b.image.astype(int)).max(-1) <= 1).mean()),
    )


def check_png(path, width, height):
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    if (w, h) != (width, height):
        raise AssertionError(f"{path} is {w}x{h}, expected {width}x{height}")


# The differentiable path (phase 10): the bench's backward scene and shape
# (ptx_torch.bench.BACKWARD_SCENE / BACKWARD_SHAPE); the vertex check
# against the brute sweep at a smaller frame; Adam steps.
DIFF_SMALL = dict(width=32, height=32, samples=1, bounces=4)
DIFF_FIELDS = ("mat_albedo", "mat_emissive", "mat_roughness", "sun_energy")
OPT_FIELDS = ("mat_albedo", "mat_emissive", "sun_energy")
OPT_STEPS, OPT_LR, VERTEX_STEPS, VERTEX_LR = 3, 0.01, 2, 1e-3
# Gradients of two routes through the same torch shade code (the general
# scan and the fast path; split_geom_grad on and off): they differ only in
# the order of the backward's atomic scatter-adds, so the bound is
# tests/test_torch_diff.py's for the two routes (rtol 1e-5).
ROUTE_REL_L2 = 1e-5
# The tile traversal against the brute sweep: at a near tie a winner may
# differ (counted on the camera rays only) and move a pixel's gradient to
# another triangle; the bound is tests/test_torch_inverse.py's for two
# implementations.
TRAVERSAL_REL_L2 = 1e-3
# The kernels the fast path's forward and the general scan must launch.
FAST_PATH_KERNELS = MAIN_PATH_KERNELS
SCAN_KERNELS = ("exact_gate", "closest", "any")


def chunk_value_and_grad(integrate, fs, params, target, cfg, chunk_px):
    """The objective of ``inverse.make_batch_value_and_grad_fn`` (the MSE
    of each pixel's mean over ``cfg.samples``, the samples in one launch,
    pixel chunks of ``chunk_px``) through ``integrate``: ``(loss, grads,
    the per-pixel mean radiance)``.  The parameters are the scene's own, so
    its attached tiles stay current."""
    import torch

    from ptx_torch.diff.inverse import inject_params

    dev, k = target.device, cfg.samples
    leaves = {f: v.detach().requires_grad_(True) for f, v in params.items()}
    tot, grads, image = 0.0, dict.fromkeys(leaves, 0.0), []
    smp = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(chunk_px)
    for c in range(cfg.width * cfg.height // chunk_px):
        pix = c * chunk_px + torch.arange(chunk_px, dtype=torch.int32, device=dev)
        radiance, _ = integrate(inject_params(fs, leaves, keep_tiles=True),
                                pix.repeat(k), smp)
        mean = radiance.reshape(k, chunk_px, 3).sum(0) / k
        v = torch.sum((mean - target[c * chunk_px:(c + 1) * chunk_px]) ** 2)
        g = torch.autograd.grad(v, list(leaves.values()))
        tot = tot + v.detach()
        grads = {f: grads[f] + gi for f, gi in zip(leaves, g)}
        image.append(mean.detach())
    denom = float(cfg.width * cfg.height * 3)
    return tot / denom, {f: g / denom for f, g in grads.items()}, torch.cat(image)


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def timed(fn, dev):
    """``(result, ms)`` of one call, the host clock around a synchronize."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def counted(fn, dev, kernels, tag):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; on the card, raises unless each of ``kernels`` launched."""
    from ptx_torch.kernels import _build

    _build.reset_launches()
    out, ms = timed(fn, dev)
    launches = dict(_build.LAUNCHES)
    log(f"{tag}: {ms:.1f} ms, launches {launches}")
    if dev.type == "cuda":
        for name in kernels:
            if launches[name] <= 0:
                raise AssertionError(f"{tag} never launched the {name} kernel")
    return out, ms, launches


def forward_ms(integrate, fs, cfg, chunk_px, dev) -> float:
    """ms of the integrator's forward alone (no autograd) over the frame's
    chunks, as the value and gradient launches them."""
    import torch

    k = cfg.samples
    smp = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(chunk_px)

    def run():
        with torch.no_grad():
            for c in range(cfg.width * cfg.height // chunk_px):
                pix = c * chunk_px + torch.arange(chunk_px, dtype=torch.int32,
                                                  device=dev)
                integrate(fs, pix.repeat(k), smp)

    return timed(run, dev)[1]


def check_diff(dev, scene=None, shape=None, small=DIFF_SMALL, smi=""):
    """Phase 10, the differentiable path on ``scene`` at ``shape`` (default:
    the bench's backward rows'): (a) the general scan (the CUDA sweeps,
    the plain shade), the route of ``make_batch_value_and_grad_fn``,
    against the fast path (fused kernels forward, plain-shade backward) for
    DIFF_FIELDS; (b) ``tri_a`` through the general scan with
    ``split_geom_grad`` and without, and at ``small`` against the brute
    sweep; (c) Adam steps; (d) the two backward bench rows on ``scene`` at
    ``shape`` with their peak memory.  Every failure raises."""
    import torch

    from ptx_torch import bench, geometry
    from ptx_torch import render as R
    from ptx_torch.diff import inverse
    from ptx_torch.diff.fast import make_fast_diff_integrator
    from ptx_torch.integrator.wavefront import make_integrator
    from ptx_torch.kernels import intersect_cuda
    from ptx_torch.kernels.intersect import brute_closest
    from ptx_torch.kernels.tiles import HIT_T, SMALL_TILES, _pack_rays
    from ptx_torch.scene.camera import generate_rays

    cuda = dev.type == "cuda"
    scene = scene or bench.BACKWARD_SCENE
    cfg = R.RenderConfig(intersector="pallas", **(shape or bench.BACKWARD_SHAPE))
    fs, static = R.ensure_accel(*R.load_scene(scene), cfg, device=dev)
    n_pixels, k = cfg.width * cfg.height, cfg.samples
    chunk_px = inverse._largest_divisor_leq(n_pixels, R.MAX_RAYS_PER_LAUNCH // k)
    target = torch.zeros((n_pixels, 3), device=dev)
    log(f"differentiable path: {scene} {cfg.width}x{cfg.height} {k} spp "
        f"{cfg.bounces} bounces, {n_pixels * k} rays in "
        f"{n_pixels // chunk_px} chunks of {chunk_px * k}")
    if R.resolve_shader(cfg) != "pallas":
        raise AssertionError("the fast path's forward would not take the kernels")

    # (a) The general scan (CUDA sweeps, plain shade), the route of
    # make_batch_value_and_grad_fn, against the fast path.
    params = {f: getattr(fs, f) for f in DIFF_FIELDS}
    vg = inverse.make_batch_value_and_grad_fn(static, cfg, target, k,
                                              param_fields=DIFF_FIELDS)
    vg(params, fs)  # warm-up
    (value, grads), _, launches = counted(lambda: vg(params, fs), dev,
                                          SCAN_KERNELS, "value and grad")
    if cuda and (launches["shade"] or launches["sun"]):
        raise AssertionError("the general scan launched the fused shade")
    closest, any_hit = R.get_backend(static, cfg, dev)
    fast = make_fast_diff_integrator(static, cfg, closest, any_hit)
    general = make_integrator(static, cfg, closest, any_hit, differentiable=True)
    routes = {}
    for name, integ, kernels in (("fast", fast, FAST_PATH_KERNELS),
                                 ("general", general, SCAN_KERNELS)):
        routes[name], ms, launches = counted(
            lambda: chunk_value_and_grad(integ, fs, params, target, cfg, chunk_px),
            dev, kernels, f"{name} route value and grad")
        if name == "fast" and cuda and launches["sun"] != launches["shade"]:
            raise AssertionError("the fast path ran the shadow-ray setup "
                                 f"{launches['sun']} times in "
                                 f"{launches['shade']} steps")
        if name == "general" and cuda and (launches["shade"] or launches["sun"]):
            raise AssertionError("the general scan launched the fused shade")
        fwd = forward_ms(integ, fs, cfg, chunk_px, dev)
        log(f"{name} route: the forward alone {fwd:.1f} of {ms:.1f} ms of the "
            f"value and grad, backward {100 * (1 - fwd / ms):.0f} % ({smi})")
    v_f, g_f, img_f = routes["fast"]
    v_g, g_g, img_g = routes["general"]
    if float(v_g) != float(value) or any(rel_l2(g_g[f], grads[f]) > ROUTE_REL_L2
                                         for f in DIFF_FIELDS):
        raise AssertionError("make_batch_value_and_grad_fn disagrees with the "
                             "general scan's own chunks")
    d = (img_f - img_g).abs().amax(-1)
    flipped = d > COLOR_ATOL
    share = 1.0 - float(flipped.float().mean())
    log(f"fast vs general primal: |dcolor|<={COLOR_ATOL} on {share:.5f} of "
        f"pixels, loss {float(v_f):.7g} vs {float(v_g):.7g}")
    if share < MIN_PIXEL_SHARE:
        raise AssertionError("the fast path's primal disagrees with the scan")
    if bool(flipped.any()):
        # Where a Monte Carlo decision flipped, each route's own radiance is
        # the target: no residual, no gradient from those pixels.
        _, g_f, _ = chunk_value_and_grad(
            fast, fs, params, torch.where(flipped[:, None], img_f, target), cfg,
            chunk_px)
        _, g_g, _ = chunk_value_and_grad(
            general, fs, params, torch.where(flipped[:, None], img_g, target),
            cfg, chunk_px)
    for f in DIFF_FIELDS:
        err = rel_l2(g_f[f], g_g[f])
        big = float(g_g[f].abs().max())
        log(f"  d loss / d {f}: fast vs general relative L2 {err:.3g} "
            f"({int(flipped.sum())} pixels left out), max |grad| {big:.4g}")
        if not (bool(torch.isfinite(g_f[f]).all())
                and bool(torch.isfinite(g_g[f]).all())):
            raise AssertionError(f"d loss / d {f} is not finite")
        if err > ROUTE_REL_L2 or big == 0.0:
            raise AssertionError(f"d loss / d {f}: fast vs general {err}")

    # (b) tri_a through the general scan, split_geom_grad and not.
    tri = {"tri_a": fs.tri_a}
    vg_t = inverse.make_batch_value_and_grad_fn(static, cfg, target, k,
                                                param_fields=("tri_a",))
    vg_t(tri, fs)  # warm-up
    (v_t, g_t), _, _ = counted(lambda: vg_t(tri, fs), dev, SCAN_KERNELS,
                               "vertex value and grad (split_geom_grad)")
    g_t = g_t["tri_a"]
    if not bool(torch.isfinite(g_t).all()) or float(g_t.abs().max()) == 0.0:
        raise AssertionError("d loss / d tri_a is not finite or all zero")
    unsplit = make_integrator(static, cfg, *intersect_cuda.make_backend(False),
                              differentiable=True)
    v_u, g_u, _ = chunk_value_and_grad(unsplit, fs, tri, target, cfg, chunk_px)
    err = rel_l2(g_u["tri_a"], g_t)
    log(f"  d loss / d tri_a: {int((g_t != 0).any(-1).sum())} of "
        f"{g_t.shape[0]} vertices moved, max |grad| {float(g_t.abs().max()):.4g}; "
        f"without split_geom_grad: loss {float(v_u):.7g} vs {float(v_t):.7g}, "
        f"relative L2 {err:.3g}")
    if float(v_u) != float(v_t) or err > ROUTE_REL_L2:
        raise AssertionError("split_geom_grad changed the vertex gradient")
    # At a smaller frame against the brute sweep: the winners of the camera
    # rays (only near ties may differ), the losses and the vertex gradients.
    out = {}
    for name in ("pallas", "brute"):
        c = R.RenderConfig(intersector=name, **small)
        t_s = torch.zeros((c.width * c.height, 3), device=dev)
        out[name] = timed(lambda: inverse.make_batch_value_and_grad_fn(
            static, c, t_s, c.samples, param_fields=("tri_a",))(tri, fs), dev)
    pix = torch.arange(small["width"] * small["height"], dtype=torch.int32,
                       device=dev)
    orig, dirn = generate_rays(fs, pix, torch.zeros_like(pix), small["width"],
                               small["height"])
    with torch.no_grad():
        rays, _ = _pack_rays(orig.contiguous(), dirn)
        if fs.ptiles.shape[0] <= SMALL_TILES:
            t_k, tri_k = intersect_cuda.closest_small(rays, fs.ptiles)
        else:
            t_k, tri_k = intersect_cuda.closest_sweep(
                *intersect_cuda._plan_tiles(rays, fs.pboxes), rays, fs.ptiles)
        _, tri_b, _, _, hit_b = brute_closest(fs, orig, dirn)
    r = pix.shape[0]
    hit_k, tri_k = t_k[:r] < HIT_T, tri_k[:r].long()
    flipped_rays = (hit_k & hit_b & (tri_k != tri_b.long())).nonzero()[:, 0]
    flips = int(flipped_rays.numel())
    if flips:
        o, dd = orig[flipped_rays], dirn[flipped_rays]
        t_two = [geometry.moller_trumbore(o, dd, fs.tri_a[w], fs.tri_e1[w],
                                          fs.tri_e2[w])[0]
                 for w in (tri_k[flipped_rays], tri_b[flipped_rays].long())]
        tie = float(((t_two[0] - t_two[1]).abs()
                     / t_two[1].abs().clamp(min=1e-30)).max())
        if tie > TIE_RTOL:
            raise AssertionError(f"a winner differs from the brute sweep's by "
                                 f"rel t {tie}, not a near tie")
    err = rel_l2(out["pallas"][0][1]["tri_a"], out["brute"][0][1]["tri_a"])
    log(f"  {small['width']}x{small['height']} {small['samples']} spp tri_a, "
        f"tile traversal vs brute: loss {float(out['pallas'][0][0]):.7g} vs "
        f"{float(out['brute'][0][0]):.7g}, gradient relative L2 {err:.3g} "
        f"({out['pallas'][1]:.0f} vs {out['brute'][1]:.0f} ms); camera rays: "
        f"{flips} winners differ (near ties), hit masks differ on "
        f"{int((hit_k != hit_b).sum())}")
    if err > TRAVERSAL_REL_L2:
        raise AssertionError(f"vertex gradient of the tile traversal vs brute {err}")

    # (c) Adam steps from the demo's initial guesses against the scene's own
    # image: the loss before each step, ms per step.
    sample_fn = R.make_sample_fn(static, cfg, dev)
    with torch.no_grad():
        image = sum(sample_fn(fs, s)[0] for s in range(k)) / k
    for fields, steps, lr in ((OPT_FIELDS, OPT_STEPS, OPT_LR),
                              (("tri_a",), VERTEX_STEPS, VERTEX_LR)):
        init = {f: inverse._DEMO_INITS[f][0](fs) for f in fields}
        clip = {f: inverse._DEMO_INITS[f][1] for f in fields
                if inverse._DEMO_INITS[f][1] is not None}
        marks = [time.perf_counter()]

        def progress(step, val):
            marks.append(time.perf_counter())
            log(f"  optimize {','.join(fields)} step {step}: loss {val:.7g} "
                f"({(marks[-1] - marks[-2]) * 1e3:.0f} ms)")

        _, history = inverse.optimize(fs, static, cfg, image, init, steps=steps,
                                      lr=lr, param_clip=clip, progress=progress)
        if not all(map(math.isfinite, history)):
            raise AssertionError(f"optimize {fields}: loss {history}")
        if fields == OPT_FIELDS and not min(history[1:]) < history[0]:
            raise AssertionError(f"optimize {fields} did not lower the loss: "
                                 f"{history}")

    # (d) The two backward bench rows, each with its peak device memory and
    # what earlier phases still held when it started.
    rows = bench.run_backward_benches(scene, cfg, dev, reps=3 if cuda else 1)
    for row in rows.values():
        log(f"backward row {json.dumps(row)} ({smi})")
    return rows


# The bvh path (phase 11): the BVH walk's three entry points, what the
# path must launch and must not, and the work counts of its bound.
BVH_KERNELS = ("bvh_closest", "bvh_any", "bvh_visits")
BVH_PATH_KERNELS = ("bvh_closest", "bvh_any", "sun", "shade")
TILE_KERNELS = ("exact_gate", "closest", "any", "closest_small", "any_small")
# Operations of csrc/bvh_traverse.cu per node visited (the slab test: per
# axis 2 subtractions, 2 multiplies, 2 NaN tests, min, max and the running
# max and min; the entry clamp and three comparisons) and per triangle
# tested (Moller-Trumbore: two cross products, three dot products, the
# reciprocal and its select, the origin offset, three scalings, nine tests
# and the comparison with the best).
SLAB_OPS = 34
MT_OPS = 58
# A glTF of the env-lit check: a floor and two upright quads under an open
# sky, no sun, camera looking down the floor.
ENV_QUADS = (
    ((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)),
    ((-1.5, 0, -1), (-0.5, 0, -1), (-0.5, 1.5, -1), (-1.5, 1.5, -1)),
    ((0.5, 0, -2), (1.5, 0, -1.5), (1.5, 2, -1.5), (0.5, 2, -2)),
)


def bvh_work(fs, n_rays, out_bytes, reads, steps, tests=None):
    """(operations, bytes) of a BVH walk of ``n_rays`` rays: ``steps``
    nodes visited and ``tests`` triangles tested (this run's counts); the
    rays read and ``out_bytes`` written once, and of each node and triangle
    array only the rows this run's walk read (``reads``, the plain walk's
    masks), each once."""
    ops = int(steps.sum()) * SLAB_OPS
    if tests is not None:
        ops += int(tests.sum()) * MT_OPS
    rows = sum(int(mask.sum()) * getattr(fs, nm)[0].numel()
               * getattr(fs, nm).element_size() for nm, mask in reads.items())
    return ops, n_rays * 24 + out_bytes + rows


def tile_winners(fs, orig, dirn):
    """The tile traversal's closest winner and final hit mask (the plan,
    the closest sweep and the epilogue's Moller-Trumbore acceptance)."""
    import torch

    from ptx_torch import geometry
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels.tiles import HIT_T

    r = orig.shape[0]
    rays, _ = K._pack_rays(orig, dirn)
    tiles, boxes = K._scene_tiles(fs)
    t_trunc, tri = K.closest_sweep(*K._plan_tiles(rays, boxes), rays, tiles)
    tri = torch.clamp(tri[:r], 0, fs.tri_a.shape[0] - 1).long()
    t_exact = geometry.moller_trumbore(orig, dirn, fs.tri_a[tri], fs.tri_e1[tri],
                                       fs.tri_e2[tri])[0]
    return tri, (t_trunc[:r] < HIT_T) & (t_exact < geometry.INF)


def check_bvh_walk(fs, static, ray_sets, timing, reps):
    """The three BVH entry points against the plain walk on every lane of
    every output, ``steps`` included; the closest winners against the tile
    traversal (near-tie flips allowed); each entry point timed on the set
    the record names, its bound from that set's own visit counts and rows
    read.  Returns the largest |difference| of each entry point over its
    outputs (t, beta, gamma; hit; steps) on all sets (0: bit for bit)."""
    import torch

    from ptx_torch import geometry
    from ptx_torch.accel import traverse
    from ptx_torch.kernels import traverse_cuda as W

    leaf = static.bvh_leaf_size
    errs = dict.fromkeys(BVH_KERNELS, 0.0)
    for tag, orig, dirn, timed in ray_sets:
        r = orig.shape[0]
        got = W.closest_walk(fs, orig, dirn, leaf)
        want = traverse.walk(fs, orig, dirn, leaf, counts=True)
        diffs = {nm: int(lane_diffs(a, b).sum()) for nm, a, b in
                 zip(("t", "tri", "beta", "gamma", "hit"), got, want[:5])}
        got_any = W.any_walk(fs, orig, dirn, leaf)
        want_any = traverse.walk(fs, orig, dirn, leaf, any_hit=True, counts=True)
        diffs["any hit"] = int((got_any != want_any[4]).sum())
        got_v = W.visits(fs, orig, dirn)
        want_v, reads_v = traverse.node_visits(fs, orig, dirn, counts=True)
        diffs["steps"] = int((got_v != want_v).sum())
        errs["bvh_closest"] = max([errs["bvh_closest"]] + [
            float(torch.where(a == b, 0.0, (a - b).abs()).max())
            for a, b in zip((got[0], got[2], got[3]), (want[0], want[2], want[3]))])
        errs["bvh_any"] = max(errs["bvh_any"], float(
            (got_any.int() - want_any[4].int()).abs().max()))
        errs["bvh_visits"] = max(errs["bvh_visits"], float(
            (got_v - want_v).abs().max()))
        log(f"bvh/{tag} ({r} rays): differing lanes: "
            + ", ".join(f"{nm} {n}" for nm, n in diffs.items())
            + f"; hits {float(got[4].float().mean()):.4f}, nodes visited "
            f"{float(want[5].float().mean()):.1f} (closest) / "
            f"{float(want_v.float().mean()):.1f} (whole walk, max "
            f"{int(want_v.max())}), triangles tested "
            f"{float(want[6].float().mean()):.1f}")
        if any(diffs.values()):
            raise AssertionError(f"bvh/{tag}: the CUDA walk differs from the "
                                 f"plain walk: {diffs}")
        # Winners against the tile traversal: hit masks equal on >=
        # MIN_AGREE of rays; where both hit, each differing winner a near
        # tie (triangles sharing an edge tie exactly, and the two
        # traversals test them in different orders).
        tri_k, hit_k = tile_winners(fs, orig, dirn)
        hit, tri = got[4], got[1].long()
        share = float((hit == hit_k).float().mean())
        flips = (tri != tri_k) & hit & hit_k
        rel = 0.0
        if bool(flips.any()):
            ta = [geometry.moller_trumbore(
                orig[flips], dirn[flips], fs.tri_a[w[flips]], fs.tri_e1[w[flips]],
                fs.tri_e2[w[flips]])[0] for w in (tri, tri_k)]
            rel = float(((ta[0] - ta[1]).abs() / ta[1].abs().clamp(min=1e-30)).max())
        log(f"bvh/{tag}: hit masks vs the tile traversal equal on {share:.6f}; "
            f"{int(flips.sum())} winner flips, largest rel t of a flip {rel:.2e}")
        if share < MIN_AGREE or rel > TIE_RTOL:
            raise AssertionError(f"bvh/{tag}: the walk's winners disagree with "
                                 "the tile traversal")
        if timed is None or timing is None:
            continue
        kind, args = timed
        if kind == "bvh_closest":
            work = bvh_work(fs, r, r * 17, want[7], want[5], want[6])
            fns = (lambda: W.closest_walk(fs, *args, leaf),
                   lambda: traverse.walk(fs, *args, leaf))
        elif kind == "bvh_any":
            work = bvh_work(fs, r, r, want_any[7], want_any[5], want_any[6])
            fns = (lambda: W.any_walk(fs, *args, leaf),
                   lambda: traverse.walk(fs, *args, leaf, any_hit=True))
        else:
            work = bvh_work(fs, r, r * 4, reads_v, want_v)
            fns = (lambda: W.visits(fs, *args), lambda: traverse.node_visits(fs, *args))
        time_kernel(timing, kind, f"bvh/{tag}", *fns, reps, work)
    return errs


def write_env_scene(tmp):
    """A glTF (``ENV_QUADS``, no sun) and an .hdr sky written into ``tmp``:
    (scene path, sky path)."""
    import numpy as np

    from ptx_torch.io.hdr import write_hdr

    pos = np.array(ENV_QUADS, np.float32).reshape(-1, 3)
    idx = np.concatenate([q * 4 + np.array([0, 1, 2, 0, 2, 3])
                          for q in range(len(ENV_QUADS))]).astype(np.uint16)
    blob = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0},
                  {"camera": 0, "translation": [0.0, 1.2, 3.5],
                   "rotation": [-0.0871557, 0.0, 0.0, 0.9961947]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.7, 0.6, 1.0], "roughnessFactor": 0.5,
            "metallicFactor": 0.2}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3", "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": 1, "componentType": 5123, "count": len(idx),
             "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
                        {"buffer": 0, "byteOffset": pos.nbytes,
                         "byteLength": idx.nbytes}],
        "buffers": [{"byteLength": len(blob), "uri": "env_scene.bin"}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.9, "znear": 0.01}}],
    }
    with open(os.path.join(tmp, "env_scene.bin"), "wb") as f:
        f.write(blob)
    path = os.path.join(tmp, "env_scene.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    rng = np.random.default_rng(13)
    sky = np.zeros((32, 64, 3), np.float32)
    sky[:16] = [0.5, 0.7, 1.3]
    sky[16:] = [0.08, 0.07, 0.06]
    sky *= 0.5 + rng.random((32, 64, 1), np.float32)
    sky_path = os.path.join(tmp, "sky.hdr")
    write_hdr(sky_path, sky)
    return path, sky_path


def check_bvh_path(fs, static, fs_np, static_np, cfg, dev, smi, scattered,
                   timing, errs):
    """Phase 11: (a, b) the BVH walk's kernels against the plain walk and
    timed; (c) the bvh path at full width, its launches, its image against
    the tile traversal's and its sample loop in turns with it; (d) a resume
    on the card; (e) an env-lit glTF, fused against plain shade; (f) the
    debug view and the CLI.  Returns the launches of each BVH entry point
    on its path."""
    import numpy as np
    import torch

    from ptx_torch import debug
    from ptx_torch import render as R
    from ptx_torch.accel import traverse
    from ptx_torch.integrator import accumulate
    from ptx_torch.io import checkpoint as ck
    from ptx_torch.io.hdr import read_hdr
    from ptx_torch.io.png import read_png
    from ptx_torch.kernels import _build
    from ptx_torch.kernels import shade_cuda as S
    from ptx_torch.kernels import traverse_cuda

    # (a), (b): camera rays, phase 3's scattered rays (parked lanes
    # included) and the strided shadow rows of a fused step's first bounce.
    cam = camera_rays(fs, 256, 256, LAUNCH_RAYS, dev)
    *_, sun_args = first_bounce(fs, static, cfg, LAUNCH_RAYS, dev)
    rows = S.shadow_rays(*sun_args)[2]
    shadow = (rows[:LAUNCH_RAYS, 0:3], rows[:LAUNCH_RAYS, 3:6])
    if shadow[0].is_contiguous():
        raise AssertionError("the shadow rows should be strided views")
    errs.update(check_bvh_walk(fs, static, [
        ("camera", *cam, ("bvh_visits", cam)),
        ("scattered", *scattered, ("bvh_closest", scattered)),
        ("shadow rows", *shadow, ("bvh_any", shadow)),
    ], timing, reps=5))
    torch.cuda.empty_cache()

    # (c) the bvh path: counts reset just before, read just after.
    cfg_b = dataclasses.replace(cfg, intersector="bvh")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_b = R.render(fs_np, static_np, cfg_b, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"bvh path launches: {launches}")
    for name in BVH_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the bvh path never launched the {name} kernel")
    for name in TILE_KERNELS:
        if launches[name]:
            raise AssertionError(f"the bvh path launched the {name} kernel")
    if not np.isfinite(res_b.color).all() or res_b.image[..., :3].max() == 0:
        raise AssertionError("bvh path image is black or not finite")
    paths = cfg.width * cfg.height * cfg.samples
    log(f"bvh path: {SLICE_SCENE} 256x256 4spp 4 bounces, render() {wall:.2f} s "
        f"= {paths / wall:,.0f} paths/s incl. BVH and upload ({smi})")
    accel = {"pallas": (fs, static),
             "bvh": R.ensure_accel(fs_np, static_np, cfg_b, device=dev)}
    images = {}
    for name in ("pallas", "bvh", "bvh", "pallas"):
        c = dataclasses.replace(cfg, intersector=name)
        fs_c, st_c = accel[name]
        sample_fn = R.make_sample_fn(st_c, c, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images[name] = R.progressive_render(fs_c, st_c, c, sample_fn, None, 1, dev)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        log(f"sample loop, intersector {name}: {steady:.3f} s = "
            f"{paths / steady:,.0f} paths/s ({smi})")
    n_dev, busy, wall_ms, top = profile_sample(
        R.make_sample_fn(accel["bvh"][1], cfg_b, dev), accel["bvh"][0])
    if n_dev:
        log(f"profiled sample, intersector bvh: {n_dev} device kernels, device "
            f"busy {busy:.1f} of {wall_ms:.1f} ms ({100 * busy / wall_ms:.0f} %) "
            f"({smi})")
        for name, (ms, n) in top:
            log(f"  {ms:9.3f} ms {n:6d}x {name[:90]}")
    else:
        log("profiled sample, intersector bvh: the profiler saw no device "
            "events; kernels per sample not measured")
    for attr in ("color", "alpha", "image"):
        if not np.array_equal(getattr(images["bvh"], attr), getattr(res_b, attr)):
            raise AssertionError(f"bvh: the sample loop's {attr} differs from "
                                 "render()'s")
    color_share, alpha_share, image_share = image_agreement(res_b, images["pallas"])
    log(f"bvh vs tile traversal, 256x256 4spp: |dcolor|<={COLOR_ATOL} on "
        f"{color_share:.4f}, alpha equal on {alpha_share:.4f}, uint8 within 1 "
        f"on {image_share:.4f}")
    if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
        raise AssertionError("the bvh path's image disagrees with the tile path's")

    with tempfile.TemporaryDirectory() as tmp:
        # (d) resume on the card: 2 samples with a checkpoint, then 4.
        path = os.path.join(tmp, "render.ckpt.npz")
        R.render(fs_np, static_np, dataclasses.replace(cfg_b, samples=2),
                 device=dev, checkpoint_path=path)
        loaded = ck.load(path)
        preview = read_png(path + ".preview.png")
        expect = accumulate.finalize(torch.as_tensor(loaded.color, device=dev),
                                     torch.as_tensor(loaded.alpha, device=dev))
        if loaded.samples_done != 2 or not np.array_equal(
                preview, expect.cpu().numpy().reshape(256, 256, 4)):
            raise AssertionError("the checkpoint's preview is not its finalize")
        resumed = R.render(fs_np, static_np, cfg_b, device=dev,
                           checkpoint_path=path)
        for attr in ("color", "alpha", "image"):
            if not np.array_equal(getattr(resumed, attr), getattr(res_b, attr)):
                raise AssertionError(f"resumed {attr} differs from the "
                                     "uninterrupted render")
        log("resume on the card: 2 samples + checkpoint + 2 more equal the "
            "uninterrupted 4 bit for bit; the preview equals finalize of the "
            "checkpoint")

        # (e) an env-lit glTF: the fused shade against the plain one.
        scene, sky = write_env_scene(tmp)
        fs_e, static_e = R.load_scene(scene, env_image=read_hdr(sky))
        if static_e.env_tex < 0:
            raise AssertionError("the env map did not reach the scene")
        env_cfg = R.RenderConfig(width=64, height=64, samples=2, bounces=3)
        out = {}
        for shader in ("pallas", "xla"):
            _build.reset_launches()
            out[shader] = R.render(fs_e, static_e,
                                   dataclasses.replace(env_cfg, shader=shader),
                                   device=dev)
            if shader == "pallas" and _build.LAUNCHES["shade"] <= 0:
                raise AssertionError("the env-lit render never ran the shade kernel")
        dark = R.render(*R.load_scene(scene), env_cfg, device=dev)
        color_share, alpha_share, image_share = image_agreement(out["pallas"],
                                                                out["xla"])
        log(f"env-lit glTF 64x64 2spp, fused vs plain shade: |dcolor|<="
            f"{COLOR_ATOL} on {color_share:.4f}, alpha equal on "
            f"{alpha_share:.4f}, uint8 within 1 on {image_share:.4f}; mean "
            f"color {out['pallas'].color.mean():.4f} (without the sky "
            f"{dark.color.mean():.4f})")
        if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
            raise AssertionError("env-lit: the fused shade disagrees with the plain one")
        if np.abs(out["pallas"].color - dark.color).max() < 0.1:
            raise AssertionError("env-lit: the sky does not light the image")

        # (f) the bvh-depth view (counts reset just before, read just
        # after), then the CLI.
        _build.reset_launches()
        view = debug.visualize(fs_np, static_np, cfg, "bvh-depth", dev)
        launches["bvh_visits"] = _build.LAUNCHES["bvh_visits"]
        if launches["bvh_visits"] <= 0 or view.shape != (256, 256, 4):
            raise AssertionError("the bvh-depth view did not run the visits kernel")
        # The view's one launch (all 65,536 primary rays) against the plain
        # walk at that shape, and the view against the heat of plain counts.
        prim = debug._primary_rays(accel["bvh"][0], cfg, dev)
        got_v = traverse_cuda.visits(accel["bvh"][0], *prim)
        want_v = traverse.node_visits(accel["bvh"][0], *prim)
        errs["bvh_visits"] = max(errs["bvh_visits"],
                                 float((got_v - want_v).abs().max()))
        plain_view = debug._heat(want_v.cpu().numpy()).reshape(256, 256, 4)
        log(f"bvh-depth view ({prim[0].shape[0]} rays in one launch): steps "
            f"differ on {int((got_v != want_v).sum())} lanes; the view equals "
            f"the heat of the plain counts: {np.array_equal(view, plain_view)}")
        if not torch.equal(got_v, want_v) or not np.array_equal(view, plain_view):
            raise AssertionError("bvh-depth: the visits kernel differs from the "
                                 "plain walk at the view's shape")
        cli = [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
               SLICE_SCENE, "--width", "128", "--height", "96", "--bounces", "4"]
        depth_png = os.path.join(tmp, "bvh_depth.png")
        subprocess.run(cli + ["--samples", "1", "--visualize", "bvh-depth",
                              "--out", depth_png],
                       cwd=ROOT, check=True, timeout=600)
        check_png(depth_png, 128, 96)
        out_png, prof = os.path.join(tmp, "cli.png"), os.path.join(tmp, "trace")
        run = subprocess.run(
            cli + ["--samples", "2", "--intersector", "bvh", "--checkpoint",
                   os.path.join(tmp, "cli.ckpt.npz"), "--metrics", "--profile",
                   prof, "--out", out_png],
            cwd=ROOT, check=True, timeout=600, capture_output=True, text=True)
        check_png(out_png, 128, 96)
        check_png(os.path.join(tmp, "cli.preview.png"), 128, 96)
        traces = [f for f in os.listdir(prof) if f.endswith(".trace.json")]
        with open(os.path.join(prof, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        if "trace:" not in run.stderr or not events:
            raise AssertionError("--metrics / --profile: no phase times or an "
                                 "empty trace")
        walks = sum("bvh_walk_kernel" in e.get("name", "") for e in events)
        log(f"cli: --visualize bvh-depth, --checkpoint, --metrics, --profile "
            f"ran; the trace holds {len(events)} events, {walks} of them walk "
            f"kernels")
    return launches


# The multi-rank path (phase 12): two ranks time-sharing the one card over
# gloo run three layouts of the smoke cell, then sharded textures.
DIST_LAYOUTS = (("dp2", 2, 1, "reduce"), ("tp2_reduce", 1, 2, "reduce"),
                ("tp2_ring", 1, 2, "ring"))
DIST_KERNELS = ("exact_gate", "closest", "any", "sun", "shade")
TEX_SHAPE = dict(width=64, height=64, samples=2, bounces=2)
TEX_KERNELS = ("closest_small", "shade")
DIST_TIMEOUT = 300
# What no rank may call on the card: the plain versions of every kernel of
# the path, and the device tile pack (each shard brings its own tiles).
PLAIN_VERSIONS = (("intersect_cuda", "_sweep"), ("intersect_cuda", "_small_sweep"),
                  ("intersect_cuda", "_exact_gate"), ("intersect_cuda", "sort_plan"),
                  ("intersect_cuda", "_frustum_gate"), ("intersect_cuda", "pack_tris"),
                  ("shade_cuda", "_shade"), ("shade_cuda", "_shadow_rays"))
SHARED = "two ranks time-sharing one H100 over gloo"
# The distributed training step (phase 12 (f), multirank_check.py
# --backward): phase 10's backward shape (bench.BACKWARD_SHAPE) on the
# smoke scene with the tile traversal, the parameters of ptx's shard_map
# training step, its Adam rate, and the seed of its target (uniform in
# [0, 1), not the scene's own image).
GRAD_SHAPE = dict(width=128, height=128, samples=4, bounces=4)
GRAD_FIELDS = ("mat_albedo", "mat_emissive")
GRAD_LR = 1e-2
GRAD_TARGET_SEED = 11
GRAD_REPS = 3
# The launch-composition check: a 640x480 frame traced in the single
# device's 30,720-pixel launches and in the 25,600-pixel launches of four
# ray-parallel ranks (ptx_torch.parallel.dist.launch_pixels).
COMPOSITION_LAUNCHES = (FRAME_RAYS, 25600)
COMPOSITION_SAMPLES = 8


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def count_plain_calls():
    """Wrap each of PLAIN_VERSIONS in its module with a counter; returns
    the counts by name (cleared by :func:`run_layout`)."""
    import importlib

    calls = {}
    for mod_name, name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"ptx_torch.kernels.{mod_name}")
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    return calls


def run_layout(fs, static, cfg, plan, comm, dev, timed=(True,), plain=None):
    """One layout on this rank, as phase 12's ranks and
    ``multirank_check.py`` run it: ``render_distributed`` with the launch
    counters and the plain-version counters ``plain``
    (:func:`count_plain_calls`) set to 0 just before and read just after;
    then, on the scene prepared again, the sample loop alone once per entry
    of ``timed``, each pass from a barrier and the collective helpers'
    clock on where the entry is True.  Returns a dict: the result, the
    launches, the plain calls, each pass's wall seconds, the samples per
    launch and the helpers' seconds, calls and bytes per sample in the last
    pass."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.kernels import _build
    from ptx_torch.parallel import dist as pdist
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import multihost

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = pmesh.make_mesh(plan, dev)
    _build.reset_launches()
    if plain is not None:
        plain.clear()
    res = pdist.render_distributed(fs, static, cfg, plan=plan, mesh=mesh,
                                   comm=comm, device=dev)
    sync()
    out = dict(result=res, launches=dict(_build.LAUNCHES),
               plain_calls=dict(plain or {}), walls=[])
    if not timed:
        return out
    fs_l, st_l = pdist.prepare_scene(fs, static, cfg, plan, mesh, dev)
    k = R.resolve_samples_per_launch(cfg, ways=pdist.ray_ways(plan, comm))
    fn = pdist.make_distributed_sample_fn(st_l, cfg, mesh, plan, comm, k=k,
                                          device=dev)
    rep = multihost.replicator(mesh, comm)
    pixels = pdist.pixel_range(mesh, comm, cfg.width * cfg.height)
    for clock in timed:
        rep.barrier()
        sync()
        pdist.STATS.reset(timed=clock)
        t0 = time.perf_counter()
        R.progressive_render(fs_l, st_l, cfg, fn if k == 1 else None,
                             fn if k > 1 else None, k, dev, replicate=rep,
                             pixels=pixels)
        sync()
        out["walls"].append(time.perf_counter() - t0)
    st = pdist.STATS
    out.update(k=k, collective_s=st.seconds, collective_calls=st.calls,
               bytes_per_sample=st.bytes / cfg.samples,
               route=type(fn).__name__)
    pdist.STATS.reset(timed=False)
    return out


def grad_config(shape):
    from ptx_torch.config import RenderConfig

    return RenderConfig(intersector="pallas", **shape)


def grad_target(cfg, dev):
    """The training step's target [W * H, 3] on ``dev``, from
    GRAD_TARGET_SEED."""
    import numpy as np
    import torch

    rng = np.random.default_rng(GRAD_TARGET_SEED)
    return torch.from_numpy(rng.uniform(
        0.0, 1.0, (cfg.width * cfg.height, 3)).astype(np.float32)).to(dev)


def grad_image(integrate, fs, cfg, first, count):
    """The per-pixel mean radiance over pixels ``first .. first + count -
    1`` through the differentiable ``integrate``, without autograd, in the
    launches of ``inverse.slice_value_and_grad_fn`` (all samples in one
    launch, pixel chunks of ``_largest_divisor_leq``), so its values are
    the forward's of the value and gradient bit for bit."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    k, dev = cfg.samples, fs.tri_a.device
    chunk = inverse._largest_divisor_leq(count, R.MAX_RAYS_PER_LAUNCH // k)
    smp = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(chunk)
    parts = []
    with torch.no_grad():
        for lo in range(first, first + count, chunk):
            pix = lo + torch.arange(chunk, dtype=torch.int32, device=dev)
            radiance, _ = integrate(fs, pix.repeat(k), smp)
            parts.append(radiance.reshape(k, chunk, 3).sum(0) / k)
    return torch.cat(parts)


def single_grad_image(fs, static, cfg, dev):
    """The one-device image of the training step's forward (the scan of
    ``make_batch_value_and_grad_fn`` on the same backend)."""
    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    integrate = inverse._resolve_diff_integrator(
        static, cfg, *R.get_backend(static, cfg, dev), GRAD_FIELDS, dev)
    return grad_image(integrate, fs, cfg, 0, cfg.width * cfg.height)


def flip_target(target, image, flips):
    """``target`` with each pixel of ``flips`` replaced by ``image``'s: a
    pixel whose Monte Carlo path flipped (a near tie decided otherwise)
    then adds no residual and no gradient on either side."""
    import torch

    return torch.where(flips[:, None], image, target)


def run_train_layout(fs, static, cfg, plan, comm, dev, target, single_image,
                     plain, reps=GRAD_REPS):
    """The distributed training step of one layout on this rank, as phase
    12's ranks and ``multirank_check.py --backward`` run it: the rank's
    image of the step's forward against ``single_image`` (the one-device
    one; the pixels off by more than COLOR_ATOL are flips, and each side's
    own image is its target there); then, with the launch counters and the
    plain-version counters set to 0 just before and read just after, one
    value and gradient (the checked one); ``reps`` more, each from a
    barrier (the fastest is the rate), with the peak device memory over
    them; last one ``make_distributed_train_step`` step from a barrier
    with the collective helpers' clock on.  Returns a dict of numpy
    arrays and numbers."""
    import torch
    import torch.distributed as tdist

    from ptx_torch.diff.graphs import DeviceScan
    from ptx_torch.kernels import _build
    from ptx_torch.parallel import dist as pdist
    from ptx_torch.parallel import mesh as pmesh

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed_call(fn):
        tdist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    mesh = pmesh.make_mesh(plan, dev)
    fs, static = pdist.prepare_scene(fs, static, cfg, plan, mesh, dev)
    start, stop = pdist.pixel_range(mesh, comm, cfg.width * cfg.height)
    integrate = pdist.diff_integrator(static, cfg, mesh, plan, comm,
                                      GRAD_FIELDS, dev)
    scan = "device" if isinstance(integrate, DeviceScan) else "host"
    if cuda and scan != ("host" if plan.scene_sharded else "device"):
        raise AssertionError(f"a {'tp' if plan.scene_sharded else 'dp'} rank "
                             f"took the {scan} scan")
    own = grad_image(integrate, fs, cfg, start, stop - start)
    flips = (own - single_image[start:stop]).abs().amax(-1) > COLOR_ATOL
    target = target.clone()
    target[start:stop] = flip_target(target[start:stop], own, flips)
    params = {f: getattr(fs, f) for f in GRAD_FIELDS}
    args = (static, cfg, mesh, plan, target, cfg.samples, comm, GRAD_FIELDS)
    vg = pdist.make_distributed_value_and_grad_fn(*args, device=dev)
    _build.reset_launches()
    plain.clear()
    loss, grads = vg(params, fs)
    sync()
    out = dict(launches=dict(_build.LAUNCHES), plain_calls=dict(plain),
               scan=scan, loss=float(loss),
               flips=(start + flips.nonzero()[:, 0]).tolist(),
               **{f"grad.{f}": g.cpu().numpy() for f, g in grads.items()})
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out["walls"] = [timed_call(lambda: vg(params, fs))[1] for _ in range(reps)]
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    step = pdist.make_distributed_train_step(*args, device=dev, lr=GRAD_LR)
    leaves, opt = step.init(params)
    pdist.STATS.reset(timed=True)
    _, out["step_s"] = timed_call(lambda: step(leaves, opt, fs))
    st = pdist.STATS
    out.update(collective_s=st.seconds, collective_calls=st.calls,
               bytes_per_step=st.bytes,
               **{f"param.{f}": p.detach().cpu().numpy()
                  for f, p in leaves.items()})
    pdist.STATS.reset(timed=False)
    return out


def rank_worker(port: int, rank: int, out: str, spec: dict) -> int:
    """One of two gloo ranks of phase 12 (``chip_smoke.py --rank-worker``):
    each layout of DIST_LAYOUTS through :func:`run_layout` (its launches
    and plain calls counted, then its sample loop timed with the collective
    helpers' clock on); each layout's training step through
    :func:`run_train_layout` (against the one-device image in
    ``grad_single.npy``); then the textured quads with the texel pack
    replicated and sharded.  Writes ``rank<r>.json``, each layout's image
    and each training step's gradients and parameters."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from ptx_torch import render as R
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import multihost
    from ptx_torch.scene.flatten import flatten
    from ptx_torch.scene.synthetic import make_textured_quads

    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device(spec["device"])
    plain = count_plain_calls()
    report = {}

    def save(name, run, **extra):
        res = run["result"]
        np.savez(os.path.join(out, f"{name}.rank{rank}.npz"), color=res.color,
                 alpha=res.alpha, image=res.image)
        report[name] = dict(launches=run["launches"],
                            plain_calls=run["plain_calls"], **extra)

    cfg = R.RenderConfig(**spec["shape"])
    fs, static = R.load_scene(spec["scene"])
    for name, dp, tp, comm in DIST_LAYOUTS:
        run = run_layout(fs, static, cfg, pmesh.Plan(dp, tp, tp > 1), comm,
                         dev, plain=plain)
        save(name, run, wall_s=run["walls"][0], collective_s=run["collective_s"],
             collective_calls=run["collective_calls"],
             bytes_per_sample=run["bytes_per_sample"], k=run["k"],
             route=run["route"])

    gcfg = grad_config(spec["grad_shape"])
    target = grad_target(gcfg, dev)
    single_image = torch.from_numpy(
        np.load(os.path.join(out, "grad_single.npy"))).to(dev)
    for name, dp, tp, comm in DIST_LAYOUTS:
        run = run_train_layout(fs, static, gcfg, pmesh.Plan(dp, tp, tp > 1),
                               comm, dev, target, single_image, plain)
        arrays = {k: run.pop(k) for k in list(run)
                  if k.startswith(("grad.", "param."))}
        np.savez(os.path.join(out, f"grad_{name}.rank{rank}.npz"), **arrays)
        report[f"grad_{name}"] = run

    tex_fs, tex_static = flatten(make_textured_quads(3))
    tex_cfg = R.RenderConfig(environment_factor=(0.0, 0.0, 0.0),
                             **spec["tex_shape"])
    for shard in (False, True):
        save(f"tex_{'sharded' if shard else 'replicated'}",
             run_layout(tex_fs, tex_static, tex_cfg,
                        pmesh.Plan(1, 2, True, shard), "reduce", dev,
                        timed=(), plain=plain))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    multihost.shutdown()
    return 0


def check_shards(fs, static, fs_np, static_np, cfg, dev, tp=2):
    """The traversal kernels at the shapes a scene-parallel rank gives
    them: each of the ``tp`` shards of the smoke cell as its rank prepares
    it (``prepare_scene``: ``build_shard_scene``, the rank's slice by
    ``mesh.shard_scene``, its own tiles by ``attach_tiles``), and on each
    the plan, the closest and the any sweep against their plain versions
    bit for bit (:func:`check_kernels`): the 8,192-ray scattered chunk
    (timed, with its bounds), the shadow rows of a first bounce's chunk of
    the whole scene (what every rank of a reduce row traces) and the
    camera chunk of the rank before it in the ring (the rays a ring hop
    brings).  The plan's kernels per call are phase 3's (the same code on
    the whole scene), not profiled again: late in the run the profiler can
    miss every event.  Returns each shard's times."""
    from ptx_torch.kernels import shade_cuda as S
    from ptx_torch.parallel import dist as pdist
    from ptx_torch.parallel import mesh as pmesh

    plan = pmesh.Plan(1, tp, True)
    scattered = scattered_rays(static, CHUNK_RAYS, 7, dev)
    *_, sun_args = first_bounce(fs, static, cfg, CHUNK_RAYS, dev)
    rows = S.shadow_rays(*sun_args)[2]
    shadow = (rows[:CHUNK_RAYS, 0:3], rows[:CHUNK_RAYS, 3:6])
    per_rank = cfg.width * cfg.height // tp
    times = []
    for r in range(tp):
        mesh = pmesh.Mesh(plan, rank=r, dp_index=0, tp_index=r, device=str(dev))
        fs_r, static_r = pdist.prepare_scene(fs_np, static_np, cfg, plan, mesh,
                                             dev)
        hop = camera_rays(fs, cfg.width, cfg.height, CHUNK_RAYS, dev,
                          first=(r - 1) % tp * per_rank)
        timing = {}
        check_kernels(fs_r, static_r, [
            ("scattered chunk", *scattered, True),
            ("shadow rows", *shadow, False),
            (f"camera chunk of rank {(r - 1) % tp}", *hop, False),
        ], f"{SLICE_SCENE} shard {r} of {tp} ({static_r.n_tris_padded} "
           f"triangles, {fs_r.ptiles.shape[0]} tiles)", timing, reps=3,
           plan_calls=False)
        times.append(timing)
        del fs_r
    return times


def host_render(fs_np, static_np, cfg, dev):
    """``render.render`` with the fused step on the host loop, where a check
    wrapped around a kernel's wrapper runs at every call (the device loop's
    graphs run it once, at capture).  Its images equal the device loop's
    bit for bit (phase 13)."""
    from ptx_torch import render as R

    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    host = loop_pair(fs, static, cfg, dev)[1]
    return loop_render(host, fs, static, cfg, dev)[0]


def check_composition(fs_np, static_np, dev):
    """Why a frame traced in other launches is not bit-equal.  The closest
    sweep keeps the least key, (truncated t, lane); of equal keys the
    earlier tile, and its exit rule skips a tile whose entry is not below
    the block's largest truncated t, though that tile may hold an equal
    truncated t with a lower lane; the gate plans a tile for a block when
    any of its rays enters the tile's box.  So near ties and hits that lie
    just outside their tile's box go by each 128-ray block's plan, that is
    by the rays that share the block, and other launches give other
    blocks.  A 640x480 frame at
    COMPOSITION_SAMPLES spp in each of COMPOSITION_LAUNCHES: (i) planned,
    every closest sweep of both renders also run on the same rays with
    every tile walked in index order (the identity plan: no block-dependent
    order, exit or gate), every ray whose result differs given a cause the
    plan explains (asserted) and counted by it; the pixels that differ
    between the two renders; (ii)
    both renders with every sweep walking every tile in order: bit-equal
    (asserted).  The renders take the host loop (:func:`host_render`).
    Returns (the counts by cause, pixels that differ planned)."""
    import numpy as np
    import torch

    from ptx_torch import render as R
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels.tiles import HIT_T, RB, TT, identity_plan

    def every_tile(rays, tiles):
        return identity_plan(rays.shape[0] // RB, tiles.shape[0], rays.device)

    sweep, plan_tiles = K.closest_sweep, K._plan_tiles
    boxes = []  # the scene's tile boxes, as the last plan saw them
    # Winners that differ from the walk of every tile (the hit mask
    # included), by cause: an equal truncated t (and of those, an equal
    # lane: equal keys); another near tie; a ray that alone (its own
    # 128-copy block) gets the walk's result, so its block decided; a ray
    # whose own gate leaves out the walk's winner's tile (the hit lies
    # outside the box its slab test sees), so a block-mate that enters the
    # box decides; none of these.  Of them, those whose hit mask differs;
    # the largest relative difference of the truncated t where both hit.
    moved = dict(equal_t=0, equal_key=0, near_tie=0, block=0, gate=0, other=0,
                 hit_differs=0, rel=0.0)

    def recording_plan(rays, tile_boxes):
        boxes[:] = [tile_boxes]
        return plan_tiles(rays, tile_boxes)

    def checked_sweep(order, count, near, rays, tiles):
        got = sweep(order, count, near, rays, tiles)
        ref = sweep(*every_tile(rays, tiles), rays, tiles)
        hit, hit_ref = got[0] < HIT_T, ref[0] < HIT_T
        idx = ((hit != hit_ref) | ((hit | hit_ref) & (
            lane_diffs(got[0], ref[0]) | (got[1] != ref[1])))).nonzero()[:, 0]
        if not idx.numel():
            return got
        t, t_ref, tri, tri_ref = (x[idx] for x in (got[0], ref[0], got[1], ref[1]))
        both = hit[idx] & hit_ref[idx]
        rel = torch.where(both, (t - t_ref).abs() / t_ref.abs(), torch.inf)
        equal_t = both & ~lane_diffs(t, t_ref)
        near_tie = ~equal_t & (rel <= TIE_RTOL)
        alone = rays[idx].repeat_interleave(RB, 0)
        a_plan = plan_tiles(alone, boxes[0])
        a_t, a_tri = (x[::RB] for x in sweep(*a_plan, alone, tiles))
        same_alone = ~lane_diffs(a_t, t_ref) & ((a_tri == tri_ref) | ~hit_ref[idx])
        block = ~(equal_t | near_tie) & same_alone
        planned = ((a_plan[0] == (tri_ref // TT)[:, None])
                   & (torch.arange(a_plan[0].shape[1], device=rays.device)[None, :]
                      < a_plan[1][:, None])).any(1)
        gate = ~(equal_t | near_tie | block) & hit_ref[idx] & ~planned
        for name, mask in (("equal_t", equal_t), ("near_tie", near_tie),
                           ("block", block), ("gate", gate),
                           ("other", ~(equal_t | near_tie | block | gate)),
                           ("hit_differs", ~both)):
            moved[name] += int(mask.sum())
        moved["equal_key"] += int((equal_t & (tri % TT == tri_ref % TT)).sum())
        if bool(both.any()):
            moved["rel"] = max(moved["rel"], float(rel[both].max()))
        return got

    cfg = R.RenderConfig(width=FRAME[0], height=FRAME[1],
                         samples=COMPOSITION_SAMPLES, bounces=4,
                         intersector="pallas")
    diffs = []
    for walk in ("planned", "every tile in order"):
        if walk == "planned":
            K.closest_sweep, K._plan_tiles = checked_sweep, recording_plan
        else:
            K._plan_tiles = lambda rays, boxes: identity_plan(
                rays.shape[0] // RB, boxes.shape[0], rays.device)
        try:
            a, b = (host_render(fs_np, static_np, dataclasses.replace(
                cfg, rays_per_batch=n), dev) for n in COMPOSITION_LAUNCHES)
        finally:
            K.closest_sweep, K._plan_tiles = sweep, plan_tiles
        d = np.abs(a.color - b.color).max(-1)
        diffs.append(int(((d > 0) | (a.alpha != b.alpha)).sum()))
        log(f"launch composition: {FRAME[0]}x{FRAME[1]} {cfg.samples} spp in "
            f"launches of {COMPOSITION_LAUNCHES[0]} and {COMPOSITION_LAUNCHES[1]} "
            f"pixels, {walk}: {diffs[-1]} pixels differ (largest |dcolor| "
            f"{float(d.max()):.3g})")
    log(f"launch composition: closest results of the two planned renders "
        f"that differ from the walk of every tile in order, by cause: "
        f"{moved['equal_t']} equal truncated t ({moved['equal_key']} of them "
        f"equal keys), {moved['near_tie']} other near ties (rel t <= "
        f"{TIE_RTOL}), {moved['block']} where the ray alone gets the walk's "
        f"result (its block decided), {moved['gate']} where the ray's own gate "
        f"leaves out the winner's tile, {moved['other']} none of these; "
        f"{moved['hit_differs']} of all with the hit mask differing; largest "
        f"rel t where both hit {moved['rel']:.3g}")
    if moved["other"]:
        raise AssertionError("planned closest results differ from the walk of "
                             "every tile for no cause the plan explains")
    if diffs[1]:
        raise AssertionError("renders in other launches differ with a walk that "
                             "does not depend on the block")
    return moved, diffs[0]


def check_launches(name, kernels, reports, dev):
    """Each rank's launches of ``kernels`` in run ``name`` (> 0) and its
    calls of the plain versions (none), logged; a CPU rehearsal runs the
    plain versions and only logs."""
    for r, rep in enumerate(reports):
        got = rep[name]
        counts = {k: got["launches"][k] for k in kernels}
        log(f"  rank {r} {name}: launches {counts}, plain calls "
            f"{got['plain_calls'] or 'none'}")
        if dev.type != "cuda":
            continue
        if min(counts.values()) <= 0:
            raise AssertionError(f"rank {r} {name}: a kernel of the path "
                                 f"never launched: {counts}")
        if got["plain_calls"]:
            raise AssertionError(f"rank {r} {name} called plain versions: "
                                 f"{got['plain_calls']}")


def single_value_and_grad(fs, static, cfg, dev, target, reps=0):
    """The one-device ``make_batch_value_and_grad_fn`` of the training step
    on ``target``: ``(loss, grads, fastest wall s of reps more calls)``."""
    from ptx_torch.diff import inverse

    vg = inverse.make_batch_value_and_grad_fn(static, cfg, target, cfg.samples,
                                              param_fields=GRAD_FIELDS)
    params = {f: getattr(fs, f) for f in GRAD_FIELDS}
    loss, grads = vg(params, fs)
    walls = [timed(lambda: vg(params, fs), dev)[1] / 1e3 for _ in range(reps)]
    return float(loss), grads, min(walls, default=None)


def compare_train_step(name, ranks, fs, static, cfg, dev, target,
                       single_image):
    """Rank 0's loss and gradients of a layout against the one-device value
    and gradient (the flipped pixels of every rank left out on both
    sides), after checking every rank's loss, gradients and parameters
    after the Adam step equal to rank 0's bit for bit.  ``ranks``: each
    rank's dict (its report and arrays).  Returns ``(loss relative error,
    {field: gradient relative L2}, pixels left out)``; raises beyond
    ROUTE_REL_L2, or when fewer than MIN_PIXEL_SHARE of the pixels agree."""
    import numpy as np
    import torch

    for r, got in enumerate(ranks[1:], 1):
        for key in [k for k in ranks[0] if k == "loss" or k.startswith(
                ("grad.", "param."))]:
            if not np.array_equal(got[key], ranks[0][key]):
                raise AssertionError(f"{name}: rank {r}'s {key} differs from "
                                     "rank 0's")
    flips = torch.zeros(cfg.width * cfg.height, dtype=torch.bool, device=dev)
    for got in ranks:
        flips[got["flips"]] = True
    n_flips = int(flips.sum())
    if 1.0 - n_flips / flips.numel() < MIN_PIXEL_SHARE:
        raise AssertionError(f"{name}: {n_flips} pixels flipped")
    loss, grads, _ = single_value_and_grad(
        fs, static, cfg, dev, flip_target(target, single_image, flips))
    if not all(np.isfinite(ranks[0][f"grad.{f}"]).all() for f in GRAD_FIELDS):
        raise AssertionError(f"{name}: a gradient is not finite")
    loss_err = abs(ranks[0]["loss"] - loss) / abs(loss)
    errs = {f: rel_l2(torch.from_numpy(ranks[0][f"grad.{f}"]),
                      grads[f].cpu()) for f in GRAD_FIELDS}
    if loss_err > ROUTE_REL_L2 or max(errs.values()) > ROUTE_REL_L2:
        raise AssertionError(f"{name}: loss {loss_err}, gradients {errs} "
                             "against one device")
    return loss_err, errs, n_flips


def check_train_step(dev, reports, tmp, fs, static, cfg, single_image, smi):
    """Phase 12 (f): each layout's training step in the two ranks against
    one device (:func:`compare_train_step`), each rank's plan and sweeps
    launched and no plain version called, then per rank grad-paths/s (the
    fastest of GRAD_REPS), peak device memory, and the collective helpers'
    share of the step's wall and its bytes."""
    import numpy as np

    target = grad_target(cfg, dev)
    _, _, one = single_value_and_grad(fs, static, cfg, dev, target,
                                      reps=GRAD_REPS)
    paths = cfg.width * cfg.height * cfg.samples
    log(f"(f) training step, {GRAD_FIELDS}: {cfg.width}x{cfg.height} "
        f"{cfg.samples} spp {cfg.bounces} bounces; one device "
        f"{paths / one:,.0f} grad-paths/s ({smi})")
    for name, dp, tp, comm in DIST_LAYOUTS:
        key = f"grad_{name}"
        check_launches(key, SCAN_KERNELS, reports, dev)
        ranks = [{**rep[key], **np.load(os.path.join(tmp, f"{key}.rank{r}.npz"))}
                 for r, rep in enumerate(reports)]
        loss_err, errs, n_flips = compare_train_step(
            key, ranks, fs, static, cfg, dev, target, single_image)
        log(f"(f) {name} (dp={dp} tp={tp} {comm}) vs one device: loss "
            f"{loss_err:.3g}, gradients relative L2 "
            + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
            + f" ({n_flips} flipped pixels left out); the ranks' loss, "
            "gradients and parameters after one Adam step bit-equal")
        for r, t in enumerate(ranks):
            peak = (f"{t['peak_bytes']:,} bytes peak" if t["peak_bytes"]
                    is not None else "peak memory not measured")
            log(f"  rank {r} {name}: {t['scan']} scan, "
                f"{paths / min(t['walls']):,.0f} "
                f"grad-paths/s (fastest of {len(t['walls'])}), {peak}; "
                f"train step {t['step_s']:.3f} s, collectives "
                f"{t['collective_s']:.3f} s = "
                f"{100 * t['collective_s'] / t['step_s']:.1f} % of it in "
                f"{t['collective_calls']} calls, {t['bytes_per_step']:,} bytes "
                f"({SHARED}; {smi})")


def check_distributed(dev, single, cfg, smi, scene=SLICE_SCENE,
                      tex_shape=TEX_SHAPE, grad_shape=GRAD_SHAPE):
    """Phase 12: (a) one NCCL rank through torchrun and the CLI; (b) two
    gloo ranks sharing the card render ``scene`` at ``cfg`` as dp=2, tp=2
    reduce and tp=2 ring, each image against ``single`` (the main path's
    image: dp bit-equal, tp within the render-parity bound), every rank's
    launches > 0 and no plain version called, with paths/s, the collective
    share of the sample wall and the bytes per sample; (c) the textured
    quads with a tp-sharded texel pack bit-equal to the replicated pack;
    (f) in the same ranks, each layout's distributed training step on
    ``scene`` at ``grad_shape`` (:func:`check_train_step`).  On the CPU (a
    rehearsal) the CLI's world is gloo too."""
    import numpy as np

    from ptx_torch import render as R
    from ptx_torch.io.png import read_png
    from ptx_torch.scene.flatten import flatten
    from ptx_torch.scene.synthetic import make_textured_quads

    if dev.type == "cuda":
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(f"compute mode: {mode}")
    shape = dict(width=cfg.width, height=cfg.height, samples=cfg.samples,
                 bounces=cfg.bounces)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) torchrun, one rank, the default backend (NCCL on the card).
        out = os.path.join(tmp, "nccl.png")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc-per-node", "1", "--master-addr", "localhost",
             "--master-port", str(_free_port()), "-m", "ptx_torch.cli",
             "render", "--distributed", "--device", dev.type, "--scene",
             scene, *(f"--{k}={v}" for k, v in shape.items()), "--out", out],
            cwd=ROOT, check=True, timeout=DIST_TIMEOUT,
        )
        check_png(out, cfg.width, cfg.height)
        img = read_png(out)
        same = float((np.abs(img.astype(int) - single.image.astype(int))
                      .max(-1) <= 1).mean())
        log(f"(a) torchrun, 1 rank, --distributed: {cfg.width}x{cfg.height} "
            f"PNG, uint8 within 1 of the single-device image on {same:.4f} "
            f"({time.perf_counter() - t0:.1f} s with start-up)")
        if same < MIN_PIXEL_SHARE:
            raise AssertionError("the 1-rank distributed CLI image disagrees")

        # (b), (c), (f) two gloo ranks on the card; first the one-device
        # image of the training step's forward, for the ranks' flips.
        gcfg = grad_config(grad_shape)
        fs1, static1 = R.ensure_accel(*R.load_scene(scene), gcfg, device=dev)
        single_image = single_grad_image(fs1, static1, gcfg, dev)
        np.save(os.path.join(tmp, "grad_single.npy"), single_image.cpu().numpy())
        spec = dict(device=dev.type, scene=scene, shape=shape,
                    tex_shape=tex_shape, grad_shape=grad_shape)
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--rank-worker", str(port), str(r), tmp, json.dumps(spec)],
            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "4"},
        ) for r in range(2)]
        failed = []
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(DIST_TIMEOUT - (time.perf_counter() - t0), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                raise AssertionError(f"rank {r} outlived {DIST_TIMEOUT} s")
            if rc != 0:
                failed.append((r, rc))
        if failed:
            raise AssertionError(f"ranks failed (rank, exit code): {failed}")
        log(f"(b, c) two gloo ranks: {time.perf_counter() - t0:.1f} s with "
            "start-up")
        reports = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))

        def image(name, r):
            z = np.load(os.path.join(tmp, f"{name}.rank{r}.npz"))
            return R.RenderResult(color=z["color"], alpha=z["alpha"],
                                  image=z["image"])

        def check_ranks(name, kernels):
            check_launches(name, kernels, reports, dev)
            a, b = image(name, 0), image(name, 1)
            if not (np.array_equal(a.color, b.color)
                    and np.array_equal(a.alpha, b.alpha)):
                raise AssertionError(f"{name}: the two ranks' images differ")
            return a

        paths = cfg.width * cfg.height * cfg.samples
        for name, dp, tp, comm in DIST_LAYOUTS:
            got = check_ranks(name, DIST_KERNELS)
            if not np.isfinite(got.color).all() or got.image[..., :3].max() == 0:
                raise AssertionError(f"{name}: image black or not finite")
            d = np.abs(got.color - single.color).max(-1)
            exact = (np.array_equal(got.color, single.color)
                     and np.array_equal(got.alpha, single.alpha))
            color_share, alpha_share, image_share = image_agreement(got, single)
            log(f"(b) {name} (dp={dp} tp={tp} {comm}) vs single device: "
                f"bit-equal {exact}; {int((d > 0).sum())} pixels differ, "
                f"{int((d > COLOR_ATOL).sum())} by more than {COLOR_ATOL} "
                f"(|dcolor|<={COLOR_ATOL} on {color_share:.5f}, alpha equal on "
                f"{alpha_share:.5f}, uint8 within 1 on {image_share:.5f})")
            # Each dp rank traces whole launches of the single device's
            # (the same pixels, samples per launch and block composition),
            # on the card through the device pass (a tp rank: the host loop).
            if tp == 1 and not exact:
                raise AssertionError(f"{name}: ray-parallel image not bit-equal "
                                     "to the single device")
            routes = {rep[name]["route"] for rep in reports}
            log(f"  {name}: the ranks' sample pass {sorted(routes)}")
            if tp == 1 and dev.type == "cuda" and routes != {"DevicePass"}:
                raise AssertionError(f"{name}: the dp ranks did not take the "
                                     f"device pass ({routes})")
            if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
                raise AssertionError(f"{name} disagrees with the single-device "
                                     "image")
            for r, rep in enumerate(reports):
                t = rep[name]
                log(f"  rank {r} {name}: sample loop {t['wall_s']:.3f} s = "
                    f"{paths / t['wall_s']:,.0f} paths/s, collectives "
                    f"{t['collective_s']:.3f} s = "
                    f"{100 * t['collective_s'] / t['wall_s']:.1f} % of it in "
                    f"{t['collective_calls']} calls, "
                    f"{t['bytes_per_sample']:,.0f} bytes per sample, "
                    f"{t['k']} sample(s) per launch ({SHARED}; {smi})")

        check_train_step(dev, reports, tmp, fs1, static1, gcfg, single_image,
                         smi)
        del fs1

        rep_img = check_ranks("tex_replicated", TEX_KERNELS)
        shd_img = check_ranks("tex_sharded", TEX_KERNELS)
        if not (np.array_equal(rep_img.color, shd_img.color)
                and np.array_equal(rep_img.alpha, shd_img.alpha)):
            raise AssertionError("sharded textures differ from the replicated "
                                 "pack")
        tex_fs, tex_static = flatten(make_textured_quads(3))
        tex_single = R.render(tex_fs, tex_static, R.RenderConfig(
            environment_factor=(0.0, 0.0, 0.0), **tex_shape), device=dev)
        dmax = float(np.abs(shd_img.color - tex_single.color).max())
        np.testing.assert_allclose(shd_img.color, tex_single.color,
                                   rtol=1e-5, atol=1e-6)
        log(f"(c) sharded texel pack (tp=2) bit-equal to the replicated one; "
            f"max |dcolor| {dmax:.3g} against the single device")


# The device loop (phase 13): the scenes it is held to the host loop on, all
# at the smoke cell's shape (256x256, 4 spp, 4 bounces: 32,768-ray launches
# of four 8,192-lane chunks).  The translucent scene is the smoke cell with
# its columns (material 2) at opacity 0.5: rays pass through them in
# opacity iterations past the bounces (up to 4 + 32).
TRANSLUCENT_MATERIAL = 2
LOOP_TURNS = ("host", "device", "device", "host", "host", "device")
# The phases of the fused step (f): each label's device time less that of
# the labelled calls inside it ("epilogue": the closest hit's call less its
# plan and sweep; "material lookup": materials, textures and the
# environment); "other" is the rest of the sample's kernels.
SPLIT_LABELS = ("plan", "closest", "any", "shadow-ray setup", "shade", "sort",
                "epilogue", "material lookup")


def loop_pair(fs, static, cfg, dev):
    """The fused integrator on the device loop (``make_pallas_integrator``,
    as ``render`` makes it) and on the host loop (``_eager_integrator``)."""
    from ptx_torch import render as R
    from ptx_torch.kernels import shade_cuda as S

    closest, any_hit = R.get_backend(static, cfg, dev, sort=False)
    step = S.make_pallas_step(static, cfg, closest, any_hit)
    return (S.make_pallas_integrator(static, cfg, closest, any_hit),
            S._eager_integrator(static, cfg, step))


def sample_fn_of(integrate, cfg, dev, outs=None):
    """``render.make_sample_fn``'s sample pass over ``integrate`` (one
    sample per launch); each launch's (radiance, alpha) is appended to
    ``outs``."""
    import torch

    from ptx_torch import render as R

    n = cfg.width * cfg.height
    chunk = R.resolve_rays_per_batch(cfg) or n
    if R.resolve_samples_per_launch(cfg) != 1:
        raise ValueError("the loop checks take one sample per launch")

    def sample_pass(fs, sample_id):
        parts = []
        for start in range(0, n, chunk):
            out = integrate(
                fs, torch.arange(start, start + chunk, dtype=torch.int32,
                                 device=dev),
                torch.full((chunk,), sample_id, dtype=torch.int32, device=dev))
            if outs is not None:
                outs.append(out)
            parts.append(out)
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return sample_pass


def loop_render(integrate, fs, static, cfg, dev, outs=None):
    """The production sample loop (``render.progressive_render``) over
    ``integrate``: the RenderResult and its host seconds."""
    import torch

    from ptx_torch import render as R

    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    sync()
    t0 = time.perf_counter()
    res = R.progressive_render(fs, static, cfg,
                               sample_fn_of(integrate, cfg, dev, outs), None,
                               1, dev)
    sync()
    return res, time.perf_counter() - t0


def replay_split(run) -> dict:
    """``run()`` (a sample loop on a device loop) with CUDA events around
    every graph replay and a mark around each ``DeviceLoop._loop`` call (a
    launch's bounce iterations), then where the device sat outside the
    replays: ``wall_ms`` (a start event after a synchronize to an end event
    after ``run`` returned), ``busy_ms`` (the union of the replay spans),
    ``edge_idle_ms`` (the gaps at a launch edge: before the first replay,
    after the last, and every gap that is not between two replays of one
    ``_loop`` call) and ``iteration_idle_ms`` (the gaps between two replays
    of one ``_loop`` call).  Eager kernels (a host loop's edges, the live
    counts' sums and copies) count as idle here.  The methods patched exist
    on every tree since the device loop's, so ``ab_trees.py`` runs this on
    earlier commits too."""
    import torch

    from ptx_torch.integrator import graphs as G

    spans, loops = [], []
    replay, loop = G.GraphRunner._replay, G.DeviceLoop._loop

    def timed_replay(self, graph, tally):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replay(self, graph, tally)
        end.record()
        spans.append((start, end))

    def marked_loop(self, *args, **kwargs):
        first = len(spans)
        try:
            return loop(self, *args, **kwargs)
        finally:
            loops.append((first, len(spans)))

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    G.GraphRunner._replay, G.DeviceLoop._loop = timed_replay, marked_loop
    try:
        t0.record()
        run()
        t1.record()
        t1.synchronize()
    finally:
        G.GraphRunner._replay, G.DeviceLoop._loop = replay, loop
    if not spans:
        raise AssertionError("the sample loop replayed no graph")
    at = [(t0.elapsed_time(a), t0.elapsed_time(b)) for a, b in spans]
    inner = set()
    for first, stop in loops:
        inner.update(range(first, stop - 1))  # gap i: replay i to i + 1
    edge = at[0][0] + (t0.elapsed_time(t1) - at[-1][1])
    iteration = 0.0
    for i in range(len(at) - 1):
        gap = at[i + 1][0] - at[i][1]
        if i in inner:
            iteration += gap
        else:
            edge += gap
    return dict(wall_ms=t0.elapsed_time(t1), busy_ms=sum(b - a for a, b in at),
                edge_idle_ms=edge, iteration_idle_ms=iteration,
                replays=len(at), launches=len(loops))


def split_line(split) -> str:
    """:func:`replay_split`'s numbers as one line of text."""
    w = split["wall_ms"]
    return (f"busy in replays {split['busy_ms']:.3f} of {w:.3f} ms "
            f"({100 * split['busy_ms'] / w:.1f} %); idle at launch edges "
            f"{split['edge_idle_ms']:.3f} ms "
            f"({100 * split['edge_idle_ms'] / w:.1f} %), between iterations "
            f"{split['iteration_idle_ms']:.3f} ms "
            f"({100 * split['iteration_idle_ms'] / w:.1f} %); "
            f"{split['replays']} replays, {split['launches']} launches")


def no_sync(tag, fn):
    """``fn()`` once to set up what it makes on first use, then again under
    ``torch.cuda.set_sync_debug_mode("error")``: raises if it syncs."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"(a) {tag}: no device sync")


def translucent_scene(fs_np, static_np):
    """The smoke cell with material TRANSLUCENT_MATERIAL at opacity 0.5."""
    import numpy as np

    packed = np.array(fs_np.mat_packed)
    opacity = np.array(fs_np.mat_opacity)
    packed[TRANSLUCENT_MATERIAL, 3] = opacity[TRANSLUCENT_MATERIAL] = 0.5
    return (fs_np._replace(mat_packed=packed, mat_opacity=opacity),
            dataclasses.replace(static_np, has_translucent=True))


def hold_loop(tag, fs, static, cfg, dev, tmp):
    """(b) one render through the device loop and through the host loop:
    each launch's radiance and alpha bit-equal, and the PNG bytes equal.
    Returns the device loop."""
    import numpy as np

    from ptx_torch.io.png import write_png
    from ptx_torch.kernels import _build

    loop, host = loop_pair(fs, static, cfg, dev)
    counts = {}
    outs = {}
    images = {}
    for name, integrate in (("host", host), ("device", loop)):
        outs[name] = []
        _build.reset_launches()
        res, wall = loop_render(integrate, fs, static, cfg, dev, outs[name])
        counts[name] = {k: v for k, v in _build.LAUNCHES.items() if v}
        if not np.isfinite(res.color).all() or res.image[..., :3].max() == 0:
            raise AssertionError(f"{tag}: the {name} loop's image is black or "
                                 "not finite")
        path = os.path.join(tmp, f"{tag}_{name}.png")
        write_png(path, res.image)
        with open(path, "rb") as f:
            images[name] = f.read()
        log(f"(b) {tag}, {name} loop: {wall:.3f} s, launches {counts[name]}")
    for i, (got, want) in enumerate(zip(outs["device"], outs["host"])):
        for field, g, w in zip(("radiance", "alpha"), got, want):
            n = int(lane_diffs(g, w).sum())
            if n:
                raise AssertionError(f"{tag}: launch {i}: the device loop's "
                                     f"{field} differs from the host loop's "
                                     f"in {n} lanes")
    if len(outs["device"]) != len(outs["host"]):
        raise AssertionError(f"{tag}: the two loops ran different launches")
    if images["device"] != images["host"]:
        raise AssertionError(f"{tag}: the two loops' PNG bytes differ")
    s = loop.schedule()
    log(f"(b) {tag}: {len(outs['host'])} launches bit-equal (radiance, alpha), "
        f"PNG bytes equal; last launch: counts {s['counts']}, "
        f"{s['iterations']} iterations ({s['host_iterations']} on the host "
        f"loop), {s['sorts']} sorts, {s['chunk_steps']} chunk steps "
        f"({s['dead_chunks']} all-dead)")
    return loop


def hold_launch_counts(loop, host, fs, cfg, dev):
    """(c) per launch of one sample: the device loop's launches (replays x
    their graphs' tallies) equal the host loop's plus one chunk step's for
    each all-dead chunk of the lag."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.kernels import _build

    n = cfg.width * cfg.height
    chunk = R.resolve_rays_per_batch(cfg) or n
    for start in range(0, n, chunk):
        ids = (torch.arange(start, start + chunk, dtype=torch.int32, device=dev),
               torch.zeros((chunk,), dtype=torch.int32, device=dev))
        _build.reset_launches()
        loop(fs, *ids)
        s = loop.schedule()
        got = dict(_build.LAUNCHES)
        _build.reset_launches()
        host(fs, *ids)
        want = dict(_build.LAUNCHES)
        for name, v in want.items():
            per_step, rest = divmod(v, s["host_chunk_steps"])
            if rest or got[name] != v + per_step * s["dead_chunks"]:
                raise AssertionError(
                    f"(c) launch at pixel {start}: {name} {got[name]} on the "
                    f"device loop, {v} on the host loop over "
                    f"{s['host_chunk_steps']} chunk steps, "
                    f"{s['dead_chunks']} all-dead chunks")
        log(f"(c) launch at pixel {start}: "
            f"{ {k: v for k, v in got.items() if v} } = the host loop's "
            f"{ {k: v for k, v in want.items() if v} } + {s['dead_chunks']} "
            f"all-dead chunk steps ({s['chunk_steps']} replayed steps, "
            f"{s['sorts']} sorts)")


def loop_turns(tag, loop, host, fs, static, cfg, dev, smi):
    """(d) the sample loop on each loop in turns (paths/s), then the device
    loop's busy share by CUDA events around each replay (whatever a
    profiler records of a graph) and a profiled sample of each loop."""
    paths = cfg.width * cfg.height * cfg.samples
    rates = {"host": [], "device": []}
    for name in LOOP_TURNS:
        _, wall = loop_render(loop if name == "device" else host, fs, static,
                              cfg, dev)
        rates[name].append(paths / wall)
    for name, r in rates.items():
        log(f"(d) {tag}, {name} loop: " + ", ".join(f"{x:,.0f}" for x in r)
            + f" paths/s in turns ({smi})")
    loop.replay_events = []
    try:
        _, wall = loop_render(loop, fs, static, cfg, dev)
        busy = sum(a.elapsed_time(b) for a, b in loop.replay_events)
        replays = len(loop.replay_events)
    finally:
        loop.replay_events = None
    log(f"(d) {tag}, device loop: busy in its {replays} replays {busy:.1f} of "
        f"{wall * 1e3:.1f} ms for {cfg.samples} samples "
        f"({100 * busy / (wall * 1e3):.0f} %, CUDA events) ({smi})")
    for name, integrate in (("host", host), ("device", loop)):
        n_dev, busy, wall_ms, _ = profile_sample(
            sample_fn_of(integrate, cfg, dev), fs)
        log(f"(d) {tag}, {name} loop: profiled sample {n_dev} device kernels, "
            f"busy {busy:.1f} of {wall_ms:.1f} ms "
            f"({100 * busy / wall_ms:.0f} %) ({smi})")
    return rates


def phase_split(fs, static, cfg, dev, smi):
    """(f) the device time of one profiled sample of the host loop, split by
    phase (SPLIT_LABELS): each phase's calls run under
    ``torch.profiler.record_function``; the five kernels also by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ptx_torch import render as R
    from ptx_torch.integrator import wavefront as W
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels import shade_cuda as S
    from ptx_torch.scene import textures as T

    def labelled(label, fn):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    patches = [(K, "_plan_tiles", "plan"), (K, "closest_sweep", "closest"),
               (K, "any_sweep", "any"), (S, "shadow_rays", "shadow-ray setup"),
               (S, "shade", "shade"), (W, "sort_wavefront", "sort"),
               (T, "material_lookup", "material lookup"),
               (S, "_env_radiance", "material lookup")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, label in patches:
            setattr(mod, name, labelled(label, getattr(mod, name)))
        closest, any_hit = R.get_backend(static, cfg, dev, sort=False)
        step = S.make_pallas_step(static, cfg, labelled("epilogue", closest),
                                  any_hit)
        sample_fn = sample_fn_of(S._eager_integrator(static, cfg, step), cfg,
                                 dev)
        sample_fn(fs, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sample_fn(fs, 0)
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    # Each labelled call leaves a device-side range (its first to its last
    # kernel); a kernel belongs to the innermost range that holds it.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in events if e.name in SPLIT_LABELS),
                    key=lambda x: x[1] - x[0])
    kernels = [e for e in events if e.name not in SPLIT_LABELS]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    split = dict.fromkeys(SPLIT_LABELS + ("other",), 0.0)
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        label = next((name for lo, hi, name in ranges if lo <= a and b <= hi),
                     "other")
        split[label] += b - a
    if not ranges:
        log("(f) host loop: the profiler kept no device-side range; the "
            "split by phase is not measured")
    log(f"(f) host loop, one profiled sample: {len(kernels)} device kernels, "
        f"{total / 1e3:.3f} ms of device time; by phase: " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({100 * v / total:.1f} %)"
            for k, v in split.items()) + f" ({smi})")
    by_name = {}
    for name in ("exact_gate", "closest", "any", "sun", "shade"):
        base, marks = CUDA_FUNCTIONS[name]
        by_name[name] = sum(
            e.time_range.end - e.time_range.start for e in kernels
            if base in e.name
            and (marks is None or any(m in e.name for m in marks)))
    log("(f) the five kernels by name: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms" for k, v in by_name.items()))
    return split


def check_device_loop(fs_np, static_np, cfg, dev, smi):
    """Phase 13: the device loop (``ptx_torch.integrator.graphs``): (a) no
    sync in an eager chunk step; (b) the device loop against the host loop,
    bit for bit per launch and in PNG bytes, on the smoke cell, a
    translucent scene, the small-sweep scene and the bvh path; (c) its
    launch counts; (d) paths/s in turns and the busy share; (e) graphs,
    capture seconds, pool bytes; (f) the host loop's device time by
    phase."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.integrator import wavefront as W
    from ptx_torch.integrator.wavefront import RayState, initial_state
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels import shade_cuda as S
    from ptx_torch.kernels.tiles import _pack_rays

    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    cfg_b = dataclasses.replace(cfg, intersector="bvh")
    fs_b, static_b = R.ensure_accel(fs_np, static_np, cfg_b, device=dev)

    # (a) one eager chunk step of each route, the sort and the frustum plan.
    pix = torch.arange(LAUNCH_RAYS, dtype=torch.int32, device=dev)
    for tag, fs_c, st_c, c in (("fused step, tile traversal", fs, static, cfg),
                               ("fused step, bvh", fs_b, static_b, cfg_b)):
        state = initial_state(fs_c, c, pix, torch.zeros_like(pix))
        sub = RayState(*(x[:CHUNK_RAYS] for x in state))
        step = S.make_pallas_step(st_c, c, *R.get_backend(st_c, c, dev,
                                                          sort=False))
        sun = S.sun_constants(fs_c)
        no_sync(f"{tag}, one {CHUNK_RAYS}-lane chunk",
                lambda: step(fs_c, 0, sub, sun))
    slot = torch.arange(LAUNCH_RAYS, device=dev)
    no_sync(f"sort of a {LAUNCH_RAYS}-lane wavefront",
            lambda: W.sort_wavefront(state, slot, static))
    gen = torch.Generator(device=dev).manual_seed(13)
    lo = torch.rand((4200, 3), device=dev, generator=gen) * 20.0 - 10.0
    boxes = torch.cat([lo, lo + torch.rand((4200, 3), device=dev,
                                           generator=gen),
                       torch.zeros((4200, 2), device=dev)], 1)
    rays = _pack_rays(*camera_rays(fs, 256, 256, CHUNK_RAYS, dev))[0]
    no_sync("frustum plan, 4,200 tiles", lambda: K._plan_tiles(rays, boxes))

    # (b), (c), (d), (e)
    loops = {}
    with tempfile.TemporaryDirectory() as tmp:
        loops["smoke cell"] = hold_loop("smoke cell", fs, static, cfg, dev, tmp)
        fs_t, static_t = R.ensure_accel(*translucent_scene(fs_np, static_np),
                                        cfg, device=dev)
        loops["translucent"] = hold_loop("translucent", fs_t, static_t, cfg,
                                         dev, tmp)
        del fs_t
        fs_sn, static_sn = R.load_scene(SMALL_SCENE)
        fs_sn = fs_sn._replace(sun_dir=fs_np.sun_dir, sun_energy=fs_np.sun_energy,
                               sun_angular_radius=fs_np.sun_angular_radius)
        static_sn = dataclasses.replace(static_sn, has_sun=True)
        fs_sn, static_sn = R.ensure_accel(fs_sn, static_sn, cfg, device=dev)
        loops[SMALL_SCENE] = hold_loop(SMALL_SCENE, fs_sn, static_sn, cfg, dev,
                                       tmp)
        loops["bvh"] = hold_loop("bvh", fs_b, static_b, cfg_b, dev, tmp)
    loop, host = loop_pair(fs, static, cfg, dev)
    loop_render(loop, fs, static, cfg, dev)
    hold_launch_counts(loop, host, fs, cfg, dev)
    rates = {"smoke cell": loop_turns("smoke cell", loop, host, fs, static, cfg,
                                      dev, smi)}
    loop_b, host_b = loop_pair(fs_b, static_b, cfg_b, dev)
    loop_render(loop_b, fs_b, static_b, cfg_b, dev)
    rates["bvh"] = loop_turns("bvh", loop_b, host_b, fs_b, static_b, cfg_b, dev,
                              smi)
    for tag, lp in loops.items():
        pool = lp.pool_bytes()
        log(f"(e) {tag}: {lp.captures} graphs captured in "
            f"{lp.capture_seconds:.3f} s, pool "
            f"{'not measured' if pool is None else f'{pool:,} bytes'}, "
            f"buffers {lp.buffer_bytes():,} bytes")
    phase_split(fs, static, cfg, dev, smi)
    return rates


# The device scan (phase 14): the parameter sets it is held and timed on,
# the second frame it is timed at (eight 32,768-ray chunks), and the order
# of the two scans' timed turns.
SCAN_SETS = (("materials", DIFF_FIELDS), ("tri_a", ("tri_a",)))
SCAN_FRAME = dict(width=256, height=256, samples=4, bounces=4)
SCAN_TURNS = ("host", "device", "device", "host", "host", "device")


def scan_pair(static, cfg, fields, dev):
    """``(host scan, device scan)`` for ``fields`` on the loss functions'
    backend (``inverse.diff_backend`` on ``render.get_backend``): the host
    scan ``make_integrator(differentiable=True)``, and what
    ``inverse.make_diff_integrator`` returns, which on the card must be the
    device scan (on the CPU, a rehearsal, it is built directly)."""
    from ptx_torch import render as R
    from ptx_torch.diff import inverse
    from ptx_torch.diff.graphs import DeviceScan
    from ptx_torch.integrator.wavefront import make_integrator

    pair = inverse.diff_backend(static, cfg, *R.get_backend(static, cfg, dev),
                                fields, dev)
    scan = inverse.make_diff_integrator(static, cfg, *pair, fields, dev)
    if not isinstance(scan, DeviceScan):
        if dev.type == "cuda":
            raise AssertionError("make_diff_integrator did not take the "
                                 "device scan on the card")
        scan = DeviceScan(static, cfg, *pair, *inverse.scan_fields(fields))
    return make_integrator(static, cfg, *pair, differentiable=True), scan


def scan_vgs(host, scan, cfg, target, fields):
    """``{"host": vg, "device": vg}``: ``make_batch_value_and_grad_fn``'s
    body (``inverse.slice_value_and_grad_fn`` over the frame) on each
    scan."""
    from ptx_torch.diff import inverse

    n = cfg.width * cfg.height
    return {name: inverse.slice_value_and_grad_fn(integ, cfg, target,
                                                  cfg.samples, 0, n, fields)
            for name, integ in (("host", host), ("device", scan))}


def hold_scan(tag, vgs, scan, params, fs):
    """(b) one value and gradient through each scan: the loss bit-equal,
    each gradient finite and within ROUTE_REL_L2 (the backward's
    scatter-adds sum in any order on the card).  Returns the device
    scan's schedule."""
    import torch

    v_h, g_h = vgs["host"](params, fs)
    v_d, g_d = vgs["device"](params, fs)
    s = scan.schedule()
    errs = {f: rel_l2(g_d[f], g_h[f]) for f in g_h}
    log(f"(b) {tag}: loss {float(v_d):.9g} device scan, {float(v_h):.9g} host "
        f"scan ({'bit-equal' if torch.equal(v_d, v_h) else 'DIFFERENT'}); "
        "gradients relative L2 " + ", ".join(f"{f} {e:.3g}"
                                             for f, e in errs.items())
        + f"; last launch: counts {s['counts']}, {s['steps']} steps "
        f"({s['host_steps']} on the host scan)")
    if not torch.equal(v_d, v_h):
        raise AssertionError(f"{tag}: the device scan's loss differs")
    for f, e in errs.items():
        if not bool(torch.isfinite(g_d[f]).all()) or e > ROUTE_REL_L2:
            raise AssertionError(f"{tag}: d loss / d {f}: relative L2 {e}")
        if float(g_h[f].abs().max()) == 0.0:
            raise AssertionError(f"{tag}: d loss / d {f} is all zero")
    return s


def eager_scan_step(tag, scan, fs, params, cfg, dev):
    """(a) one eager step of the scan, forward and backward, on one chunk's
    wavefront under ``set_sync_debug_mode("error")``."""
    import torch

    from ptx_torch.diff.inverse import inject_params
    from ptx_torch.integrator.wavefront import RayState, initial_state

    pix, smp = scan_launch(cfg, dev)
    init = initial_state(fs, cfg, pix, smp)

    def run():
        leaves = {f: v.detach().requires_grad_() for f, v in params.items()}
        fsx = inject_params(fs, leaves, keep_tiles=True)
        with torch.enable_grad():
            ins = RayState(*(x.detach().requires_grad_(x.is_floating_point())
                             for x in init))
            out = scan.step(fsx, 0, ins)
            outs = [x for x in out if x.requires_grad]
            torch.autograd.grad(
                outs, [*leaves.values(), *(x for x in ins if x.requires_grad)],
                [torch.ones_like(x) for x in outs], allow_unused=True)

    no_sync(f"{tag}: one eager {pix.shape[0]}-lane step, forward and "
            "backward", run)


def scan_launch(cfg, dev):
    """The pixel and sample ids of the frame's first chunk, as
    ``slice_value_and_grad_fn`` launches it."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    k = cfg.samples
    chunk = inverse._largest_divisor_leq(cfg.width * cfg.height,
                                         R.MAX_RAYS_PER_LAUNCH // k)
    pix = torch.arange(chunk, dtype=torch.int32, device=dev).repeat(k)
    smp = torch.arange(k, dtype=torch.int32,
                       device=dev).repeat_interleave(chunk)
    return pix, smp


def scan_launches(tag, host, scan, fs, params, cfg, dev):
    """(c) one launch's value and gradient (the frame's first chunk) through
    each scan, the counts set to 0 just before and read just after: the
    device scan's launches (replays x their graphs' tallies) equal the host
    scan's plus one step's for each all-dead step of the lag."""
    import torch

    from ptx_torch.diff.inverse import inject_params
    from ptx_torch.kernels import _build

    pix, smp = scan_launch(cfg, dev)

    def run(integrate):
        leaves = {f: v.detach().requires_grad_() for f, v in params.items()}
        radiance, _ = integrate(inject_params(fs, leaves, keep_tiles=True),
                                pix, smp)
        torch.autograd.grad(radiance.sum(), list(leaves.values()),
                            allow_unused=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    counts = {}
    for name, integrate in (("host", host), ("device", scan)):
        run(integrate)
        _build.reset_launches()
        run(integrate)
        counts[name] = {k: v for k, v in _build.LAUNCHES.items() if v}
    s = scan.schedule()
    for name, v in counts["host"].items():
        per_step, rest = divmod(v, s["host_steps"])
        got = counts["device"].get(name)
        if rest or got != v + per_step * s["dead_steps"]:
            raise AssertionError(
                f"(c) {tag}: {name} {got} on the device "
                f"scan, {v} on the host scan over {s['host_steps']} steps, "
                f"{s['dead_steps']} all-dead")
    if dev.type == "cuda":
        for name in SCAN_KERNELS:
            if not counts["device"].get(name):
                raise AssertionError(f"(c) {tag}: the device scan never "
                                     f"launched the {name} kernel")
    log(f"(c) {tag}, one {pix.shape[0]}-ray launch: {counts['device']} = the "
        f"host scan's {counts['host']} + {s['dead_steps']} all-dead steps "
        f"({s['steps']} steps replayed, forward and backward)")


def scan_turns(tag, vgs, params, fs, cfg, dev, smi, turns):
    """(d) one value and gradient per turn on each scan (grad-paths/s)."""
    paths = cfg.width * cfg.height * cfg.samples
    rates = {"host": [], "device": []}
    for name in turns:
        _, ms = timed(lambda: vgs[name](params, fs), dev)
        rates[name].append(paths / ms * 1e3)
    for name, r in rates.items():
        log(f"(d) {tag}, {name} scan: " + ", ".join(f"{x:,.0f}" for x in r)
            + f" grad-paths/s in turns ({smi})")
    return rates


def scan_costs(tag, vgs, scan, params, fs, dev, smi, profiled=True):
    """(e) the device scan's busy share by CUDA events around its replays,
    each scan's peak device memory over one call and, when ``profiled``, a
    profiled value and gradient of each (device kernels, busy share), and
    the device scan's graphs, capture seconds and pool bytes."""
    import torch

    scan.replay_events = []
    try:
        _, wall = timed(lambda: vgs["device"](params, fs), dev)
        busy = sum(a.elapsed_time(b) for a, b in scan.replay_events)
        replays = len(scan.replay_events)
    finally:
        scan.replay_events = None
    log(f"(e) {tag}, device scan: busy in its {replays} replays {busy:.1f} of "
        f"{wall:.1f} ms ({100 * busy / wall:.0f} %, CUDA events) ({smi})")
    for name in ("host", "device"):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vgs[name](params, fs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"(e) {tag}, {name} scan: peak {peak:,} bytes with {held:,} held "
            f"before ({smi})")
        if profiled:
            n_dev, busy, wall_ms, _ = profile_sample(
                lambda f, _s, name=name: vgs[name](params, f), fs)
            log(f"(e) {tag}, {name} scan: profiled value and gradient {n_dev} "
                f"device kernels, busy {busy:.1f} of {wall_ms:.1f} ms "
                f"({100 * busy / wall_ms:.0f} %) ({smi})")
    pool = scan.pool_bytes()
    log(f"(e) {tag}, device scan: {scan.captures} graphs captured in "
        f"{scan.capture_seconds:.3f} s, pool "
        f"{'not measured' if pool is None else f'{pool:,} bytes'}")


def scan_entry_points(fs, static, cfg, dev, small):
    """(f) the loss functions that are not the chunked value and gradient,
    each through the host scan and through the device scan
    (``inverse.takes_device_scan`` answering no, then yes, which on the
    card is its own answer): ``render_grad`` (one sample pass
    of ``make_loss_fn``, whose geometry set packs its tiles inside each
    step) at ``small`` for DIFF_FIELDS and ``tri_a``, and
    ``make_batch_loss_fn`` over two sample groups (both forwards before one
    backward, so the first group's steps run forward again before their
    backward): the loss bit-equal, each gradient within ROUTE_REL_L2."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.diff import graphs, inverse

    take = inverse.takes_device_scan
    rerun = graphs.DeviceScan._recompute
    reruns = []

    def counted_rerun(self, ctx):
        reruns.append(ctx.gen)
        return rerun(self, ctx)

    def both(tag, fn):
        out = {}
        for name in ("host", "device"):
            inverse.takes_device_scan = (
                lambda *a, on=name == "device", **k: on)
            try:
                out[name] = fn()
            finally:
                inverse.takes_device_scan = take
        (v_h, g_h), (v_d, g_d) = out["host"], out["device"]
        errs = {f: rel_l2(g_d[f], g_h[f]) for f in g_h}
        log(f"(f) {tag}: loss {float(v_d):.9g} device scan, {float(v_h):.9g} "
            "host scan; gradients relative L2 "
            + ", ".join(f"{f} {e:.3g}" for f, e in errs.items()))
        if not torch.equal(v_d, v_h) or max(errs.values()) > ROUTE_REL_L2:
            raise AssertionError(f"(f) {tag}: the device scan disagrees")

    c_s = grad_config(small)
    t_s = grad_target(c_s, dev)
    for fields in (DIFF_FIELDS, ("tri_a",)):
        both(f"render_grad {','.join(fields)} {c_s.width}x{c_s.height}",
             lambda: inverse.render_grad(fs, static, c_s, t_s, fields))
    target = grad_target(cfg, dev)

    def batch_loss():
        loss = inverse.make_batch_loss_fn(static, cfg, target, cfg.samples,
                                          param_fields=DIFF_FIELDS)
        leaves = {f: getattr(fs, f).detach().requires_grad_()
                  for f in DIFF_FIELDS}
        v = loss(leaves, fs)
        return v, dict(zip(leaves, torch.autograd.grad(
            v, list(leaves.values()))))

    cap = R.MAX_RAYS_PER_LAUNCH
    R.MAX_RAYS_PER_LAUNCH = cfg.width * cfg.height * cfg.samples // 2
    graphs.DeviceScan._recompute = counted_rerun
    try:
        both(f"make_batch_loss_fn, two sample groups of {cfg.samples // 2}",
             batch_loss)
    finally:
        R.MAX_RAYS_PER_LAUNCH = cap
        graphs.DeviceScan._recompute = rerun
    if not reruns:
        raise AssertionError("(f) the first group's backward did not run its "
                             "forward again")
    log(f"(f) the device scan ran {len(reruns)} forward(s) again before "
        "their backward")


def check_device_scan(dev, smi, scene=None, shape=None, frame=SCAN_FRAME,
                      turns=SCAN_TURNS, small=DIFF_SMALL):
    """Phase 14: the device scan (``ptx_torch.diff.graphs.DeviceScan``)
    against the host scan on ``scene`` at ``shape`` (default: the backward
    rows'): (a) no sync in an eager step, forward and backward; (b) the
    loss bit-equal and the gradients within ROUTE_REL_L2, for DIFF_FIELDS
    and ``tri_a`` (moved vertices, then the scene's: the tiles repacked per
    call read in place), and on the translucent cell; (c) launches per
    launch; (d) grad-paths/s in turns at ``shape`` and at ``frame``; (e)
    busy share, peak memory, graphs, capture seconds, pool bytes; (f)
    ``render_grad`` at ``small`` and ``make_batch_loss_fn`` over two
    sample groups (:func:`scan_entry_points`)."""
    from ptx_torch import bench
    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    cuda = dev.type == "cuda"
    cfg = grad_config(shape or bench.BACKWARD_SHAPE)
    cfg_f = grad_config(frame)
    fs_np, static_np = R.load_scene(scene or bench.BACKWARD_SCENE)
    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    rates = {}
    for name, fields in SCAN_SETS:
        params = {f: getattr(fs, f) for f in fields}
        host, scan = scan_pair(static, cfg, fields, dev)
        if cuda:
            eager_scan_step(name, scan, fs, params, cfg, dev)
        vgs = scan_vgs(host, scan, cfg, grad_target(cfg, dev), fields)
        if fields == ("tri_a",):
            moved = {"tri_a": inverse._DEMO_INITS["tri_a"][0](fs)}
            hold_scan(f"{name}, vertices moved", vgs, scan, moved, fs)
        hold_scan(name, vgs, scan, params, fs)
        if fields == DIFF_FIELDS:
            scan_launches(name, host, scan, fs, params, cfg, dev)
        tag = f"{name} {cfg.width}x{cfg.height} {cfg.samples} spp"
        rates[tag] = scan_turns(tag, vgs, params, fs, cfg, dev, smi, turns)
        if cuda:
            scan_costs(tag, vgs, scan, params, fs, dev, smi)
        del host, scan, vgs
        host, scan = scan_pair(static, cfg_f, fields, dev)
        vgs = scan_vgs(host, scan, cfg_f, grad_target(cfg_f, dev), fields)
        hold_scan(f"{name} {cfg_f.width}x{cfg_f.height}", vgs, scan, params,
                  fs)
        tag = f"{name} {cfg_f.width}x{cfg_f.height} {cfg_f.samples} spp"
        rates[tag] = scan_turns(tag, vgs, params, fs, cfg_f, dev, smi, turns)
        if cuda:
            scan_costs(tag, vgs, scan, params, fs, dev, smi, profiled=False)
        del host, scan, vgs
    # The translucent cell: passthrough steps past the bounces, a scan that
    # ends on its lagged count (the dead step).
    fs_t, static_t = R.ensure_accel(*translucent_scene(fs_np, static_np), cfg,
                                    device=dev)
    params = {f: getattr(fs_t, f) for f in DIFF_FIELDS}
    host, scan = scan_pair(static_t, cfg, DIFF_FIELDS, dev)
    vgs = scan_vgs(host, scan, cfg, grad_target(cfg, dev), DIFF_FIELDS)
    s = hold_scan("translucent", vgs, scan, params, fs_t)
    if s["steps"] <= cfg.bounces or s["dead_steps"] != 1:
        raise AssertionError(f"translucent: {s['steps']} steps, "
                             f"{s['dead_steps']} all-dead")
    scan_launches("translucent", host, scan, fs_t, params, cfg, dev)
    del host, scan, vgs, fs_t
    scan_entry_points(fs, static, cfg, dev, small)
    return rates


# The device pass (phase 15): the cells beside the smoke cell, the bvh path
# and the translucent cell: synthetic:2000 lit by the smoke scene's sun at
# 128x128 x 5 spp (two samples per 32,768-ray launch, the last batch
# ragged), and the claim blend (a transparent background) on the smoke
# scene at 128x128 x 3 spp (two per launch, ragged); the order of the timed
# turns ("edges": the same device loop with eager edges, ``loop_render``).
PASS_BATCHED = dict(width=128, height=128, samples=5, bounces=4)
PASS_CLAIM = dict(width=128, height=128, samples=3, bounces=4,
                  transparent_background=True)
PASS_TURNS = ("edges", "pass", "pass", "edges", "edges", "pass")


def counted_passes(fn):
    """``(fn(), calls of DevicePass.accumulate meanwhile)``."""
    from ptx_torch.integrator import graphs as G

    calls = []
    accumulate = G.DevicePass.accumulate

    def counted(self, *args, **kwargs):
        calls.append(1)
        return accumulate(self, *args, **kwargs)

    G.DevicePass.accumulate = counted
    try:
        return fn(), len(calls)
    finally:
        G.DevicePass.accumulate = accumulate


def png_bytes(res, tmp, name) -> bytes:
    from ptx_torch.io.png import write_png

    path = os.path.join(tmp, f"{name}.png")
    write_png(path, res.image)
    with open(path, "rb") as f:
        return f.read()


def results_bit_equal(tag, got, want, tmp):
    """Raise unless two RenderResults' color and alpha bits and PNG bytes
    are equal."""
    import numpy as np

    for field in ("color", "alpha"):
        a = getattr(got, field).view(np.uint32)
        b = getattr(want, field).view(np.uint32)
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag}: {field} differs in "
                                 f"{int((a != b).sum())} values")
    if png_bytes(got, tmp, f"{tag}_got") != png_bytes(want, tmp, f"{tag}_want"):
        raise AssertionError(f"{tag}: the PNG bytes differ")


def eager_render(fs_np, static_np, cfg, dev):
    """``render.render`` with the fused step on the host loop and the eager
    edges (ids, ``cat``, the plain folds), one or more samples per
    launch."""
    from ptx_torch import render as R
    from ptx_torch.kernels import shade_cuda as S

    def host_loop(static, cfg, device):
        closest, any_hit = R.get_backend(static, cfg, device, sort=False)
        return S._eager_integrator(
            static, cfg, S.make_pallas_step(static, cfg, closest, any_hit))

    make = R.make_integrator_for
    R.make_integrator_for = host_loop
    try:
        return R.render(fs_np, static_np, cfg, device=dev)
    finally:
        R.make_integrator_for = make


def hold_pass(tag, fs_np, static_np, cfg, dev, tmp, kernels=()):
    """(a) ``render.render`` (the device pass, asserted by its calls) against
    :func:`eager_render` (the host loop, eager edges): color, alpha and PNG
    bytes bit-equal; ``kernels``: the path's kernels, each launched (counts
    set to 0 just before the render, read just after).  Returns the
    render."""
    import numpy as np
    import torch

    from ptx_torch import render as R
    from ptx_torch.kernels import _build

    _build.reset_launches()
    got, calls = counted_passes(lambda: R.render(fs_np, static_np, cfg,
                                                 device=dev))
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = eager_render(fs_np, static_np, cfg, dev)
    k = R.resolve_samples_per_launch(cfg)
    if calls != -(-cfg.samples // k):
        raise AssertionError(f"{tag}: render made {calls} device-pass calls "
                             f"for {cfg.samples} samples at {k} per launch")
    for name in kernels if dev.type == "cuda" else ():
        if not launches.get(name):
            raise AssertionError(f"{tag}: the device pass never launched {name}")
    results_bit_equal(tag, got, want, tmp)
    if not np.isfinite(got.color).all() or got.image[..., :3].max() == 0:
        raise AssertionError(f"{tag}: image black or not finite")
    log(f"(a) {tag} ({cfg.width}x{cfg.height}, {cfg.samples} spp, {k} per "
        f"launch): device pass bit-equal to the host loop (color, alpha, PNG "
        f"bytes) in {calls} pass calls; launches {launches}")
    return got


def pass_sample_checks(tag, fs, static, cfg, dev, smi):
    """(b) no sync in a whole sample of the pass after warm-up; (c) one
    sample's launches equal the same device loop's with eager edges, its
    profiled device kernels, the loop's graphs, capture seconds and pool
    bytes.  Returns the pass."""
    import torch

    from ptx_torch import render as R
    from ptx_torch.integrator.graphs import DevicePass
    from ptx_torch.kernels import _build

    k = R.resolve_samples_per_launch(cfg)
    dpass = (R.make_sample_fn(static, cfg, dev) if k == 1
             else R.make_batched_sample_fn(static, cfg, k, dev))
    if not isinstance(dpass, DevicePass):
        raise AssertionError(f"{tag}: the sample function is no device pass")
    R.progressive_render(fs, static, cfg, dpass if k == 1 else None,
                         dpass if k > 1 else None, k, dev)
    no_sync(f"{tag}, one whole sample of the device pass ({k} per launch)",
            lambda: dpass.accumulate(fs, 0, k))
    torch.cuda.synchronize()
    _build.reset_launches()
    dpass.accumulate(fs, 0, k)
    torch.cuda.synchronize()
    got = {n: v for n, v in _build.LAUNCHES.items() if v}
    _build.reset_launches()
    dpass(fs, 0)
    torch.cuda.synchronize()
    want = {n: v for n, v in _build.LAUNCHES.items() if v}
    if got != want:
        raise AssertionError(f"{tag}: a sample's launches {got} on the device "
                             f"pass, {want} with eager edges")
    n_dev, busy, wall_ms, _ = profile_sample(
        lambda fs, s: dpass.accumulate(fs, s, k), fs)
    pool = dpass.loop.pool_bytes()
    log(f"(c) {tag}: one sample's launches {got}, the same as with eager "
        f"edges; profiled sample {n_dev} device kernels, busy {busy:.1f} of "
        f"{wall_ms:.1f} ms; {dpass.loop.captures} graphs captured in "
        f"{dpass.loop.capture_seconds:.3f} s, pool "
        f"{'not measured' if pool is None else f'{pool:,} bytes'} ({smi})")
    return dpass


def pass_turns(tag, dpass, fs, static, cfg, dev, smi):
    """(d) the sample loop through the pass and through the same device loop
    with eager edges (``loop_render``) in turns (paths/s), then one loop of
    each under :func:`replay_split`."""
    from ptx_torch import render as R

    paths = cfg.width * cfg.height * cfg.samples

    def run(name):
        if name == "pass":
            return R.progressive_render(fs, static, cfg, dpass, None, 1, dev)
        return loop_render(dpass.loop, fs, static, cfg, dev)

    rates = {"edges": [], "pass": []}
    for name in PASS_TURNS:
        _, wall = timed(lambda: run(name), dev)
        rates[name].append(paths / wall * 1e3)
    for name, r in rates.items():
        log(f"(d) {tag}, {name}: " + ", ".join(f"{x:,.0f}" for x in r)
            + f" paths/s in turns ({smi})")
    for name in ("edges", "pass"):
        log(f"(d) {tag}, {name}: {split_line(replay_split(lambda: run(name)))} "
            f"({smi})")
    return rates


def check_device_pass(fs_np, static_np, cfg, dev, smi):
    """Phase 15: the sample pass as a device program
    (``ptx_torch.integrator.graphs.DevicePass``): (a) ``render.render``
    against the host loop's render bit for bit (color, alpha, PNG bytes) on
    the smoke cell, the bvh path, the translucent cell, PASS_BATCHED and
    PASS_CLAIM, and a resume (2 samples, then 4) against the uninterrupted
    4; (b) no sync in a whole sample; (c) a sample's launches, device
    kernels, graphs, capture seconds, pool bytes; (d) paths/s against eager
    edges in turns, the busy share and the idle split, on the tile
    traversal and the bvh path; (e) the device scan's load graph, the loss
    bit-equal and the gradients within ROUTE_REL_L2, grad-paths/s in
    turns."""
    from ptx_torch import bench
    from ptx_torch import render as R

    cfg_b = dataclasses.replace(cfg, intersector="bvh")
    with tempfile.TemporaryDirectory() as tmp:
        whole = hold_pass("smoke cell", fs_np, static_np, cfg, dev, tmp,
                          MAIN_PATH_KERNELS)
        hold_pass("bvh", fs_np, static_np, cfg_b, dev, tmp, BVH_PATH_KERNELS)
        hold_pass("translucent", *translucent_scene(fs_np, static_np), cfg,
                  dev, tmp, MAIN_PATH_KERNELS)
        fs_sn, static_sn = R.load_scene(SMALL_SCENE)
        fs_sn = fs_sn._replace(sun_dir=fs_np.sun_dir,
                               sun_energy=fs_np.sun_energy,
                               sun_angular_radius=fs_np.sun_angular_radius)
        static_sn = dataclasses.replace(static_sn, has_sun=True)
        hold_pass(f"{SMALL_SCENE} batched", fs_sn, static_sn,
                  dataclasses.replace(cfg, **PASS_BATCHED), dev, tmp,
                  SMALL_PATH_KERNELS)
        hold_pass("claim blend", fs_np, static_np,
                  dataclasses.replace(cfg, **PASS_CLAIM), dev, tmp,
                  MAIN_PATH_KERNELS)
        path = os.path.join(tmp, "resume.npz")
        R.render(fs_np, static_np, dataclasses.replace(cfg, samples=2),
                 device=dev, checkpoint_path=path, checkpoint_every=2)
        resumed = R.render(fs_np, static_np, cfg, device=dev,
                           checkpoint_path=path, checkpoint_every=2)
        results_bit_equal("resume", resumed, whole, tmp)
        log("(a) resume: 2 samples with a checkpoint, then 4, bit-equal to the "
            "uninterrupted 4 (color, alpha, PNG bytes)")

    rates = {}
    for tag, c in (("tile traversal", cfg), ("bvh", cfg_b)):
        fs, static = R.ensure_accel(fs_np, static_np, c, device=dev)
        dpass = pass_sample_checks(tag, fs, static, c, dev, smi)
        rates[tag] = pass_turns(tag, dpass, fs, static, c, dev, smi)
        del dpass, fs
    fs, static = R.ensure_accel(*R.load_scene(SMALL_SCENE), cfg, device=dev)
    pass_sample_checks(f"{SMALL_SCENE} batched", fs, static,
                       dataclasses.replace(cfg, **PASS_BATCHED), dev, smi)

    # (e) the device scan: its initial state from a load graph per shape.
    g_cfg = grad_config(bench.BACKWARD_SHAPE)
    fs, static = R.ensure_accel(*R.load_scene(bench.BACKWARD_SCENE), g_cfg,
                                device=dev)
    params = {f: getattr(fs, f) for f in DIFF_FIELDS}
    host, scan = scan_pair(static, g_cfg, DIFF_FIELDS, dev)
    vgs = scan_vgs(host, scan, g_cfg, grad_target(g_cfg, dev), DIFF_FIELDS)
    hold_scan("(e) device scan", vgs, scan, params, fs)
    loads = {r: ("load",) in launch.graphs
             for r, launch in scan._launches.items()}
    if dev.type == "cuda" and not all(loads.values()):
        raise AssertionError(f"the device scan's load graphs: {loads}")
    log(f"(e) device scan: a load graph per launch shape {sorted(loads)}")
    tag = f"materials {g_cfg.width}x{g_cfg.height} {g_cfg.samples} spp"
    rates[f"scan {tag}"] = scan_turns(f"(e) {tag}", vgs, params, fs, g_cfg,
                                      dev, smi, SCAN_TURNS)
    return rates


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ptx_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from ptx_torch import render as R
    from ptx_torch.kernels import _build

    dev = torch.device("cuda")

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    print(_build.build_log, file=sys.stderr)
    check_rcp(dev)

    # 3. traversal kernels vs plain versions at the slice's shapes
    cfg = R.RenderConfig(width=256, height=256, samples=4, bounces=4)
    t0 = time.perf_counter()
    fs_np, static_np = R.load_scene(SLICE_SCENE)
    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    from ptx_torch.accel import native

    log(f"{SLICE_SCENE}: {static.n_tris} triangles, {fs.ptiles.shape[0]} tiles, "
        f"load + BVH ({'native' if native.available() else 'numpy'} builder) "
        f"+ pack {time.perf_counter() - t0:.1f} s")
    timing = {}
    scattered = scattered_rays(static, LAUNCH_RAYS, 7, dev)
    # 32,768-ray launches (timed: scattered), then the main path's own
    # sweep launch, the 8,192-ray chunk of 64 blocks (timed: camera, and
    # last the scattered set, whose times go into the kernels' record), and
    # the adversarial chunk for the plan (ties at 0, blocks with no tile).
    errs = check_kernels(fs, static, [
        ("camera", *camera_rays(fs, 256, 256, LAUNCH_RAYS, dev), False),
        ("scattered", *scattered, True),
        ("late bounce chunk", *scattered_rays(static, CHUNK_RAYS, 9, dev,
                                              live=LATE_LIVE), True),
        ("adversarial chunk", *adversarial_rays(fs, static, CHUNK_RAYS, 5, dev),
         False),
        ("640x480 frame launch", *camera_rays(fs, *FRAME, FRAME_RAYS, dev), False),
        ("camera chunk", *camera_rays(fs, 256, 256, CHUNK_RAYS, dev), True),
        ("scattered chunk", *scattered_rays(static, CHUNK_RAYS, 7, dev), True),
    ], SLICE_SCENE, timing, reps=5)
    fs_s, static_s = R.ensure_accel(*R.load_scene(SMALL_SCENE), cfg, device=dev)
    # The small sweeps at 32,768 rays, on a 640x480 frame's launch and on the
    # 8,192-ray chunk (timed: the frame and the chunks; the record keeps the
    # scattered chunk's times).
    small_rays = [
        ("camera", *camera_rays(fs_s, 256, 256, LAUNCH_RAYS, dev), False),
        ("scattered", *scattered_rays(static_s, LAUNCH_RAYS, 8, dev), False),
        ("640x480 frame launch", *camera_rays(fs_s, *FRAME, FRAME_RAYS, dev), True),
        ("camera chunk", *camera_rays(fs_s, 256, 256, CHUNK_RAYS, dev), True),
        ("scattered chunk", *scattered_rays(static_s, CHUNK_RAYS, 8, dev), True),
    ]
    check_kernels(fs_s, static_s, [(*r[:3], False) for r in small_rays],
                  SMALL_SCENE, None, reps=0)
    errs.update(check_small(fs_s, small_rays, SMALL_SCENE, timing, reps=5))
    # The device tile pack, then the scene above FRUSTUM_PLAN_TILES.
    check_pack(SLICE_SCENE, fs)
    check_above_frustum(cfg, dev)
    torch.cuda.empty_cache()

    # 4. sun and shade kernels vs plain versions
    errs.update(check_shade(fs, static, cfg, dev, timing, reps=5))

    # 5. main path: counts reset just before, read just after
    if R.resolve_shader(cfg) != "pallas":
        raise AssertionError("the default shader does not resolve to the kernels")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = R.render(fs_np, static_np, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"main path launches: {launches}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    if launches["sun"] != launches["shade"]:
        raise AssertionError("the main path ran the shadow-ray setup "
                             f"{launches['sun']} times in {launches['shade']} steps")
    if not np.isfinite(res.color).all():
        raise AssertionError("main path image is not finite")
    if res.color.shape != (256, 256, 3) or res.image[..., :3].max() == 0:
        raise AssertionError("main path image is black or misshapen")
    paths = cfg.width * cfg.height * cfg.samples
    log(f"main path: {SLICE_SCENE} 256x256 4spp 4 bounces, render() "
        f"{wall:.2f} s = {paths / wall:,.0f} paths/s incl. BVH and upload "
        f"(mean color {res.color.mean():.4f}; {smi})")

    # Shader A/B on the sample loop, in turns: xla, auto, auto, xla.
    fs_a, static_a = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    images = {}
    for shader in ("xla", "auto", "auto", "xla"):
        c = dataclasses.replace(cfg, shader=shader)
        sample_fn = R.make_sample_fn(static_a, c, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images[shader] = R.progressive_render(fs_a, static_a, c, sample_fn,
                                              None, 1, dev)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        log(f"sample loop, shader {shader} ({R.resolve_shader(c)}): "
            f"{steady:.3f} s = {paths / steady:,.0f} paths/s ({smi})")
    # "auto" runs the device loop; the profiler records the kernels inside
    # its CUDA graphs (torch 2.11), and phase 13 also times their replays.
    for shader in ("xla", "auto"):
        c = dataclasses.replace(cfg, shader=shader)
        n_dev, busy, wall_ms, top = profile_sample(
            R.make_sample_fn(static_a, c, dev), fs_a)
        if n_dev:
            log(f"profiled sample, shader {shader}: {n_dev} device kernels, "
                f"device busy {busy:.1f} of {wall_ms:.1f} ms "
                f"({100 * busy / wall_ms:.0f} %) ({smi})")
            for name, (ms, n) in top:
                log(f"  {ms:9.3f} ms {n:6d}x {name[:90]}")
        else:
            log(f"profiled sample, shader {shader}: the profiler saw no device "
                f"events; kernels per sample not measured")
    color_share, alpha_share, image_share = image_agreement(images["auto"],
                                                            images["xla"])
    log(f"shader auto vs xla, 256x256 4spp: |dcolor|<={COLOR_ATOL} on "
        f"{color_share:.4f}, alpha equal on {alpha_share:.4f}, uint8 within 1 "
        f"on {image_share:.4f}")
    if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
        raise AssertionError("the fused shade path disagrees with the plain one")

    small = dict(width=64, height=64, samples=2, bounces=4)
    r_k = R.render(fs_np, static_np, R.RenderConfig(intersector="pallas", **small),
                   device=dev)
    r_b = R.render(fs_np, static_np, R.RenderConfig(intersector="brute", **small),
                   device=dev)
    color_share, alpha_share, image_share = image_agreement(r_k, r_b)
    log(f"64x64 2spp kernels vs brute: |dcolor|<={COLOR_ATOL} on {color_share:.4f}, "
        f"alpha equal on {alpha_share:.4f}, uint8 within 1 on {image_share:.4f}")
    if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
        raise AssertionError("kernel path image disagrees with the brute path")

    # 6. small-scene path: synthetic:2000 (no sun of its own) lit by the
    # arch scene's sun, so its shadow rays take the small any sweep.
    fs_sn, static_sn = R.load_scene(SMALL_SCENE)
    fs_sn = fs_sn._replace(sun_dir=fs_np.sun_dir, sun_energy=fs_np.sun_energy,
                           sun_angular_radius=fs_np.sun_angular_radius)
    static_sn = dataclasses.replace(static_sn, has_sun=True)
    _build.reset_launches()
    r_k = R.render(fs_sn, static_sn, R.RenderConfig(intersector="pallas", **small),
                   device=dev)
    torch.cuda.synchronize()
    small_launches = dict(_build.LAUNCHES)
    log(f"small-scene path launches: {small_launches}")
    for name in SMALL_PATH_KERNELS:
        if small_launches[name] <= 0:
            raise AssertionError(f"small-scene path never launched the {name} kernel")
    r_b = R.render(fs_sn, static_sn, R.RenderConfig(intersector="brute", **small),
                   device=dev)
    color_share, alpha_share, image_share = image_agreement(r_k, r_b)
    log(f"{SMALL_SCENE} + sun 64x64 2spp kernels vs brute: |dcolor|<={COLOR_ATOL} "
        f"on {color_share:.4f}, alpha equal on {alpha_share:.4f}, uint8 within 1 "
        f"on {image_share:.4f}")
    if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
        raise AssertionError("small-scene kernel path disagrees with the brute path")
    if not np.isfinite(r_k.color).all() or r_k.image[..., :3].max() == 0:
        raise AssertionError("small-scene image is black or not finite")

    # 7. CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ptx_torch_smoke.png")
        subprocess.run(
            [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
             SLICE_SCENE, "--width", "128", "--height", "96", "--samples", "2",
             "--bounces", "4", "--out", out],
            cwd=ROOT, check=True, timeout=600,
        )
        check_png(out, 128, 96)
    log("cli: wrote a 128x96 PNG")

    # 8. the stats sweep: the 32,768 scattered rays of phase 3 (timed), then
    # the bench roofline's camera rays on its two scenes.
    from ptx_torch import bench

    errs["closest_stats"] = check_stats(f"{SLICE_SCENE}/scattered", fs, *scattered,
                                        timing, reps=5)
    for scene, n_rays in STATS_SCENES:
        fs_r, _ = bench.roofline_scene(scene, dev)
        errs["closest_stats"] = max(errs["closest_stats"], check_stats(
            f"{scene}/{n_rays} roofline rays", fs_r,
            *bench.roofline_rays(fs_r, n_rays), None, 0))
        del fs_r

    # 9. the bench path: counts reset just before, read just after
    _build.reset_launches()
    result = bench.run_bench(extras=BENCH_EXTRAS, device=dev)
    torch.cuda.synchronize()
    bench_launches = dict(_build.LAUNCHES)
    log(f"bench path launches: {bench_launches}")
    for name in BENCH_PATH_KERNELS:
        if bench_launches[name] <= 0:
            raise AssertionError(f"bench path never launched the {name} kernel")
    for name, row in [("headline", result), *result.get("extra", {}).items()]:
        if "error" in row or "skipped" in row:
            raise AssertionError(f"bench row {name}: {row}")
    log(json.dumps(result))

    # 10. the differentiable path: counts reset just before each route's
    # run, read just after.
    check_diff(dev, smi=smi)

    # 11. the bvh path: counts reset just before each path's run, read just
    # after.
    bvh_launches = check_bvh_path(fs, static, fs_np, static_np, cfg, dev, smi,
                                  scattered, timing, errs)

    # 12. the multi-rank path: counts reset inside each rank just before
    # each layout's render, read just after; then the kernels on each tp=2
    # shard against their plain versions, and the launch composition.
    check_distributed(dev, res, cfg, smi)
    check_shards(fs, static, fs_np, static_np, cfg, dev)
    check_composition(fs_np, static_np, dev)

    # 13. the device loop: counts reset just before each launch's run, read
    # just after.
    check_device_loop(fs_np, static_np, cfg, dev, smi)

    # 14. the device scan: counts reset just before each launch's value and
    # gradient, read just after.
    check_device_scan(dev, smi)

    # 15. the device pass: counts reset just before each render and each
    # sample, read just after.
    check_device_pass(fs_np, static_np, cfg, dev, smi)

    if "jax" in sys.modules or "ptx" in sys.modules:
        raise AssertionError("the port imported jax or the JAX package")

    record = []
    for name, (source, replaces) in REPLACES.items():
        t = timing[name]
        n = (small_launches if name.endswith("_small") else
             bench_launches if name == "closest_stats" else
             bvh_launches if name.startswith("bvh_") else launches)[name]
        record.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=n,
                           max_abs_err=errs[name], ms=t["ms"],
                           plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                           # No single PyTorch call computes any of these.
                           bound_by=t["bound_by"], library_ms=None,
                           device_ms=t["device_ms"], device_by=t["device_by"]))
    log(smi)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             json.loads(sys.argv[5])))
    sys.exit(main())
