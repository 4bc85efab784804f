#!/usr/bin/env python3
"""The port's multi-rank render with one rank per card, checked and timed.

    python -m torch.distributed.run --nproc-per-node 4 multirank_check.py \\
        [--scene arch:300000] [--width 256 --height 256 --samples 4 \\
        --bounces 4] [--device cuda]

One process per card (NCCL, ``ptx_torch.parallel.multihost.initialize``).
Rank 0 first logs the cards' links (``nvidia-smi topo -m`` and ``nvlink
--status``, each with its exit code) and renders the
frame on its card alone (the single-card sample loop, timed); then every
layout of the world's size (dp only, dp x tp reduce and ring, tp only)
runs through ``chip_smoke.run_layout``, as phase 12 of ``chip_smoke.py``
runs it: each rank's kernel launches counted (> 0) and its calls of the
plain versions (none), every rank's image equal to rank 0's, the image
against a single-card render with the same samples per launch (a k-sample
launch folds its samples into the mean in one sum, which rounds otherwise
than k folds) and, at one sample per launch, the same launches (the rank's
launch size as ``rays_per_batch``; the closest sweep breaks ties by each
block's plan, so other launches give other blocks,
``chip_smoke.check_composition``): a dp-only layout bit-equal, the others
within |dcolor| <= 1e-4 on >= 99 % of pixels and alpha equal on >= 99 %,
the differing pixels counted; every rank's sample pass a device pass
(``integrator.graphs.DevicePass``: a tp rank's chunk steps are programs
of graph segments cut at its exchanges), and a tp rank's image bit-equal
to the same render on the host loop; then each layout's sample loop from
a barrier: the device pass and the host loop in turns (paths/s per rank,
after one warm pass of each), then once plain (paths/s; the collective
helpers' calls and bytes per sample), and once under
``chip_smoke.replay_split`` (the busy share in
graph replays, the idle at launch edges, at segment boundaries and
between iterations), with the loop's graphs and segments per chunk
step.  Rank 0 prints one
line per layout and, last, one JSON object; any failed check raises, and
the exit code is then non-zero.  ``--device cpu`` runs the same on the CPU
over gloo (a rehearsal: plain versions, no launches).

``--backward`` runs the distributed training step instead (at
``chip_smoke.GRAD_SHAPE`` unless the size is given), every layout through
``chip_smoke.run_train_layout`` as phase 12's ranks run it: each rank's
plan and sweeps launched and no plain version called, every rank's loss,
gradients and parameters after one Adam step equal to rank 0's, rank 0's
against the single card's ``make_batch_value_and_grad_fn`` within
``chip_smoke.ROUTE_REL_L2`` (flipped pixels left out), every rank on the
device scan (a tp rank's steps cut into graph segments at its exchanges)
and bit-equal to the host scan on the same exchanges in loss and
gradients (``run_train_layout`` raises otherwise), then per rank
grad-paths/s through the device scan and the host scan in 3 turns each
(the fastest of the device scan's against the single card), the device
scan's idle split over one value and gradient, its graphs, capture
seconds, pool bytes and segments per step, the collective helpers' calls
and bytes in a step, and peak device memory of each scan.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def layouts(world: int):
    """(dp, tp, comm) of every layout of ``world`` ranks: dp only, then each
    split with tp > 1 in both exchanges."""
    out = [(world, 1, "reduce")]
    for tp in range(2, world + 1):
        if world % tp == 0:
            out += [(world // tp, tp, "reduce"), (world // tp, tp, "ring")]
    return out


RENDER_SHAPE = dict(width=256, height=256, samples=4, bounces=4)


def backward(scene, shape, dev, world, rank, cards, log):
    """The distributed training step over every layout of the world (see
    the module's docstring); rank 0 logs one line per layout and, last,
    one JSON object."""
    import torch.distributed as dist

    import chip_smoke as smoke
    from ptx_torch import render as R
    from ptx_torch.parallel import mesh as pmesh

    cfg = smoke.grad_config(shape)
    paths = cfg.width * cfg.height * cfg.samples
    fs, static = R.load_scene(scene)
    log(f"{world} ranks, training step on {scene} {cfg.width}x{cfg.height} "
        f"{cfg.samples} spp {cfg.bounces} bounces, {smoke.GRAD_FIELDS}; "
        f"cards: {cards}")
    # Every rank's one-card image (for its flips), on its own card.
    fs1, static1 = R.ensure_accel(fs, static, cfg, device=dev)
    target = smoke.grad_target(cfg, dev)
    single_image = smoke.single_grad_image(fs1, static1, cfg, dev)
    one = None
    if rank == 0:
        _, _, one = smoke.single_value_and_grad(fs1, static1, cfg, dev, target,
                                                reps=smoke.GRAD_REPS)
        log(f"single card: {paths / one:,.0f} grad-paths/s (fastest of "
            f"{smoke.GRAD_REPS}; {cards[0]})")
    dist.barrier()
    plain = smoke.count_plain_calls()
    rows = []
    for dp, tp, comm in layouts(world):
        name = f"dp={dp} tp={tp} {comm}"
        run = smoke.run_train_layout(fs, static, cfg, pmesh.Plan(dp, tp, tp > 1),
                                     comm, dev, target, single_image, plain)
        every = [None] * world
        dist.all_gather_object(every, run)
        if rank != 0:
            continue
        smoke.check_launches(name, smoke.SCAN_KERNELS,
                             [{name: r} for r in every], dev)
        loss_err, errs, n_flips = smoke.compare_train_step(
            name, every, fs1, static1, cfg, dev, target, single_image)
        fastest = [min(r["walls"]) for r in every]
        host = [min(w for route, w in r["turn_walls"] if route == "host")
                for r in every]
        row = dict(layout=name, scan=[r["scan"] for r in every],
                   loss_rel=loss_err, grad_rel_l2=errs,
                   flipped_pixels=n_flips,
                   grad_paths_per_s=[paths / w for w in fastest],
                   speedup=one / max(fastest),
                   host_grad_paths_per_s=[paths / w for w in host],
                   host_speedup=one / max(host),
                   turns=[[(route, paths / w) for route, w in r["turn_walls"]]
                          for r in every],
                   collective_calls=[r["collective_calls"] for r in every],
                   bytes_per_step=[r["bytes_per_step"] for r in every],
                   peak_bytes=[r["peak_bytes"] for r in every],
                   programs=[r["programs"] for r in every],
                   split=[r.get("split") for r in every])
        rows.append(row)
        log(f"{name} ({', '.join(sorted(set(row['scan'])))} scan, loss and "
            "gradients bit-equal to the host scan on every rank): "
            "grad-paths/s per rank "
            f"{', '.join(f'{g:,.0f}' for g in row['grad_paths_per_s'])} "
            f"({row['speedup']:.2f}x one card; the host scan "
            f"{', '.join(f'{g:,.0f}' for g in row['host_grad_paths_per_s'])}"
            f", {row['host_speedup']:.2f}x); loss {loss_err:.3g}, "
            f"gradients relative L2 {max(errs.values()):.3g} ({n_flips} "
            "flipped pixels left out), ranks bit-equal; collectives "
            f"{', '.join(str(c) for c in row['collective_calls'])} calls, "
            f"{row['bytes_per_step'][0]:,} bytes per step per rank "
            f"({cards[0]})")
        for r, t in enumerate(every):
            smoke.log_train_rank(f"rank {r} {name}", t, paths, cards[r],
                                 "one rank per card, NCCL" if dev.type ==
                                 "cuda" else "gloo on the CPU")
    log(json.dumps({"single_grad_paths_per_s": paths / one if rank == 0 else None,
                    "cards": cards, "layouts": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="arch:300000")
    for key in ("width", "height", "samples", "bounces"):
        ap.add_argument(f"--{key}", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backward", action="store_true",
                    help="the distributed training step, not the render")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as smoke
    from ptx_torch import render as R
    from ptx_torch.parallel import dist as pdist
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import multihost

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if not multihost.initialize(device=args.device):
        raise SystemExit("run under torch.distributed.run")
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = ""
    if cuda:
        import subprocess

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, check=True).stdout.strip()
        if rank == 0:  # the links between the cards, where the tool reads them
            for cmd in (["nvidia-smi", "topo", "-m"],
                        ["nvidia-smi", "nvlink", "--status"]):
                got = subprocess.run(cmd, capture_output=True, text=True)
                print(f"$ {' '.join(cmd)} (exit {got.returncode})\n"
                      f"{got.stdout}{got.stderr}", flush=True)
    cards = [None] * world
    dist.all_gather_object(cards, card)

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shape = {k: getattr(args, k) if getattr(args, k) is not None else v
             for k, v in (smoke.GRAD_SHAPE if args.backward
                          else RENDER_SHAPE).items()}
    if args.backward:
        backward(args.scene, shape, dev, world, rank, cards, log)
        multihost.shutdown()
        return 0
    cfg = R.RenderConfig(intersector="pallas", **shape)
    paths = cfg.width * cfg.height * cfg.samples
    fs, static = R.load_scene(args.scene)
    log(f"{world} ranks, {args.scene} {cfg.width}x{cfg.height} {cfg.samples} spp "
        f"{cfg.bounces} bounces; cards: {cards}; torch {torch.__version__}")

    # The single-card references on rank 0 (the others wait), by samples
    # per launch and, at one sample per launch, pixels per launch.
    references = {}

    def reference(k, launch):
        key = (k, launch if k == 1 else None)
        if key not in references:
            c = (dataclasses.replace(cfg, rays_per_batch=launch) if k == 1
                 else dataclasses.replace(cfg, samples_per_launch=k))
            references[key] = R.render(fs, static, c, device=dev)
        return references[key]

    single_s = None
    if rank == 0:
        R.render(fs, static, cfg, device=dev)  # warm-up
        fs_1, st_1 = R.ensure_accel(fs, static, cfg, device=dev)
        fn = R.make_sample_fn(st_1, cfg, dev)
        sync()
        t0 = time.perf_counter()
        R.progressive_render(fs_1, st_1, cfg, fn, None, 1, dev)
        sync()
        single_s = time.perf_counter() - t0
        log(f"single card: sample loop {single_s:.3f} s = "
            f"{paths / single_s:,.0f} paths/s ({card})")
        del fs_1
    dist.barrier()

    plain = smoke.count_plain_calls()
    results = []
    for dp, tp, comm in layouts(world):
        plan = pmesh.Plan(dp, tp, tp > 1)
        run = smoke.run_layout(fs, static, cfg, plan, comm, dev,
                               timed=1, plain=plain, host=tp > 1,
                               turns=smoke.DIST_TURNS, split=cuda)
        res = run["result"]
        host = run.get("host_result")
        mine = dict(rank=rank,
                    launches={k: run["launches"][k] for k in smoke.DIST_KERNELS},
                    plain_calls=run["plain_calls"], wall_s=run["walls"][0],
                    collective_calls=run["collective_calls"],
                    calls_per_sample=run["calls_per_sample"],
                    bytes_per_sample=run["bytes_per_sample"], k=run["k"],
                    route=run["route"], graphs=run.get("graphs"),
                    turn_walls=run["turn_walls"], split=run.get("split"),
                    host_equal=host is None or (
                        np.array_equal(host.color.view(np.uint32),
                                       res.color.view(np.uint32))
                        and np.array_equal(host.alpha.view(np.uint32),
                                           res.alpha.view(np.uint32))
                        and np.array_equal(host.image, res.image)),
                    color=res.color, alpha=res.alpha)
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank != 0:
            continue
        name = f"dp={dp} tp={tp} {comm}"
        for r in every:
            if cuda and min(r["launches"].values()) <= 0:
                raise AssertionError(f"{name}: rank {r['rank']} never launched "
                                     f"a kernel of the path: {r['launches']}")
            if cuda and r["plain_calls"]:
                raise AssertionError(f"{name}: rank {r['rank']} called plain "
                                     f"versions: {r['plain_calls']}")
            if not (np.array_equal(r["color"], res.color)
                    and np.array_equal(r["alpha"], res.alpha)):
                raise AssertionError(f"{name}: rank {r['rank']}'s image differs")
            if cuda and r["route"] != "DevicePass":
                raise AssertionError(f"{name}: rank {r['rank']} took "
                                     f"{r['route']}, not the device pass")
            if not r["host_equal"]:
                raise AssertionError(f"{name}: rank {r['rank']}'s image differs "
                                     "from its host loop's")
        single = reference(run["k"], pdist.launch_pixels(plan, comm,
                                                         cfg.width * cfg.height))
        d = np.abs(res.color - single.color).max(-1)
        exact = (np.array_equal(res.color, single.color)
                 and np.array_equal(res.alpha, single.alpha))
        share = float((d <= smoke.COLOR_ATOL).mean())
        alpha = float((res.alpha == single.alpha).mean())
        if not np.isfinite(res.color).all() or min(share, alpha) < smoke.MIN_PIXEL_SHARE:
            raise AssertionError(f"{name} disagrees with the single card")
        if tp == 1 and not exact:
            raise AssertionError(f"{name}: ray-parallel image not bit-equal to "
                                 "the single card with the same launches")
        row = dict(
            layout=name, bit_equal=exact, pixels_differ=int((d > 0).sum()),
            pixels_over_atol=int((d > smoke.COLOR_ATOL).sum()),
            paths_per_s=paths / max(r["wall_s"] for r in every),
            speedup=single_s / max(r["wall_s"] for r in every),
            bytes_per_sample=[r["bytes_per_sample"] for r in every],
            samples_per_launch=every[0]["k"],
            launches=[r["launches"] for r in every],
            route=every[0]["route"], graphs=[r["graphs"] for r in every],
            calls_per_sample=[r["calls_per_sample"] for r in every],
            turns=[[(route, paths / w) for route, w in r["turn_walls"]]
                   for r in every],
            split=[r["split"] for r in every])
        results.append(row)
        log(f"{name}: {row['paths_per_s']:,.0f} paths/s "
            f"({row['speedup']:.2f}x one card), bit-equal {exact}, "
            f"{row['pixels_differ']} pixels differ "
            f"({row['pixels_over_atol']} by > {smoke.COLOR_ATOL}); "
            f"{row['bytes_per_sample'][0]:,.0f} bytes per sample per rank "
            f"({cards[0]})")
        log(f"  {name}: route {row['route']}"
            + (", bit-equal to the host loop on every rank" if tp > 1 else "")
            + f"; collective calls per sample {every[0]['calls_per_sample']:.1f}")
        for r in every:
            smoke.log_route(f"rank {r['rank']} {name}", dict(
                graphs=r["graphs"], turn_walls=r["turn_walls"],
                split=r["split"]), paths, cards[r["rank"]],
                "one rank per card, NCCL" if cuda else "gloo on the CPU")
    log(json.dumps({"single_paths_per_s": paths / single_s if rank == 0 else None,
                    "cards": cards, "layouts": results}))
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
