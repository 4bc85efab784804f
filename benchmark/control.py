#!/usr/bin/env python3
"""The readings that bound the limits of ``correct`` from above: the
control and the faults, put in the program's place, at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        [--samples S]

The benchmark's own runs never run this.  Per seed it prints one JSON
line of the numbers the cell compares, read as a run reads them:

* with ``--program``: the program's own readings (the lower ones), each
  seed's set-up and check run in this one process with a window of one
  unit;

* ``control``: the reference computed in bfloat16 (its shading: the
  materials, BRDF, throughput and radiance; the geometry stays float32)
  put in the program's place and judged as a run judges the program
  (``compare`` / ``judge`` of the cell's kind), with ``correct``;
* frame cells at ``S`` samples (default the job's): the pixels and
  samples a run's check reads;
* the inverse cell also ``half_batch``: the reference's steps on half of
  the pixels, the loss their mean (a batch half left out), against the
  whole reference, judged so too; a state left unchanged reads 1 by
  the measure and needs no run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402


def verdict(checks) -> dict:
    """The compared numbers and ``correct``, as a run's line has them."""
    return {"correct": all(c["ok"] for c in checks),
            **{c["name"]: c["value"] for c in checks}}


def frame_readings(ctx, samples: int) -> dict:
    import numpy as np
    import torch

    from benchmark import reference as ref
    from benchmark.kinds import frame

    job = ctx.traffic["job"]
    cfg = frame.render_config(ctx.config, ctx.traffic, ctx.seed)
    n_pixels = job["width"] * job["height"]
    k = ctx.traffic["check"]["pixels"]
    px = np.sort(np.random.default_rng(ctx.seed).choice(n_pixels, k,
                                                        replace=False))
    sc, bvh = ref.load(ctx.config["scene"], ctx.device)
    pix = torch.as_tensor(px, device=ctx.device).repeat(samples)
    smp = torch.arange(samples, device=ctx.device).repeat_interleave(k)
    means = {}
    for name, dtype in (("reference", torch.float32),
                        ("control", torch.bfloat16)):
        c, a = ref.trace_paths(sc, bvh, ctx.config["semantics"], job["width"],
                               job["height"], job["bounces"], cfg.seed, pix,
                               smp, dtype=dtype)
        mc, ma = ref.fold_mean(c.reshape(samples, k, 3),
                               a.reshape(samples, k))
        means[name] = (mc[-1].cpu().numpy(), ma[-1].cpu().numpy())
    checks = frame.compare(ctx, (*means["control"], samples), None,
                           means["reference"], samples)
    return {"control": verdict(checks)}


def inverse_readings(ctx) -> dict:
    import torch

    from benchmark.kinds import frame, inverse

    traffic = ctx.traffic
    cfg = frame.render_config(ctx.config, traffic, ctx.seed)
    n = cfg.width * cfg.height
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    target = torch.rand((n, 3), generator=gen, device=ctx.device) \
        * traffic["target_scale"]
    from benchmark import reference as ref

    sc, _ = ref.load(ctx.config["scene"], "cpu")
    keys = {"mat_albedo": "albedo", "mat_emissive": "emissive"}
    init = {f: torch.full(sc[keys[f]].shape, spec["init"], device=ctx.device)
            for f, spec in traffic["fields"].items()}
    steps = inverse.FIRST_STEPS
    whole = inverse.reference_steps(ctx, cfg, target, init, steps)
    out = {}
    low = inverse.reference_steps(ctx, cfg, target, init, steps,
                                  dtype=torch.bfloat16)
    out["control"] = verdict(inverse.judge(ctx, init, *low, whole))
    half = inverse.reference_steps(ctx, cfg, target, init, steps,
                                   pixels=n // 2)
    out["half_batch"] = verdict(inverse.judge(ctx, init, *half, whole))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    cell = common.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.program:
        return program_readings(cell, seeds, args.device)
    return readings(cell, seeds, args.samples, args.device)


def program_readings(cell: dict, seeds, device="cuda") -> int:
    import time

    import torch

    from benchmark import run

    kind = common.load_module("kinds", cell["traffic"]["kind"])
    for seed in seeds:
        dev = torch.device(device)
        ctx = run.Ctx(workload=cell["workload"]["name"],
                      config=cell["config"], traffic=cell["traffic"],
                      seed=seed, seconds=0.0, trace=False, rank=0, world=1,
                      device=dev, t_proc=time.time())
        out = kind.run(ctx)
        print(json.dumps({"workload": cell["workload"]["name"], "seed": seed,
                          "program": {c["name"]: c["value"]
                                      for c in out["checks"]}}), flush=True)
        ctx.free()
    return 0


def readings(cell: dict, seeds, samples=None, device="cuda") -> int:
    import torch

    for seed in seeds:
        ctx = types.SimpleNamespace(config=cell["config"],
                                    traffic=cell["traffic"], seed=seed,
                                    device=torch.device(device),
                                    log=lambda msg: None)
        if cell["traffic"]["kind"] == "frame":
            got = frame_readings(ctx, samples or cell["traffic"]["job"]["samples"])
        else:
            got = inverse_readings(ctx)
        print(json.dumps({"workload": cell["workload"]["name"], "seed": seed,
                          **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
