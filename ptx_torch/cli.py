"""Command line of the port: the ``render``, ``bench``, ``invert`` and
``partition`` subcommands.

Usage:
    python -m ptx_torch.cli render --scene arch:300000 --out out.png \
        --width 256 --height 256 --samples 4 --bounces 4 [--device cuda] \
        [--intersector bvh] [--checkpoint ck.npz [--checkpoint-every 5]] \
        [--env sky.hdr] [--visualize bvh-depth] [--metrics] [--profile DIR]
    python -m torch.distributed.run --nproc-per-node N -m ptx_torch.cli \
        render --distributed [--tp T] [--comm reduce|ring] --scene ...
    python -m ptx_torch.cli bench [--backward] [--device cpu]
    python -m ptx_torch.cli invert --scene arch:2000 --width 64 --height 64 \
        --samples 2 --bounces 3 --steps 50 --params mat_albedo,mat_emissive
    python -m ptx_torch.cli partition --scene scene.gltf --num-workers 4

``render --checkpoint`` resumes from a compatible checkpoint and writes
one (and a preview PNG beside ``--out``) every ``--checkpoint-every``
samples; ``--visualize`` writes a debug view (``ptx_torch.debug``) in place
of the beauty render; ``--metrics`` prints per-phase times (each phase
ends in a device synchronize); ``--profile DIR`` writes a ``torch.profiler``
Chrome trace into DIR, which holds the program's spans (``ptx.sample``,
``ptx.launch``, ``ptx.replay``, ``ptx.exchange``: ``ptx_torch.utils.span``)
on the kernels' clock and, without ``--metrics``, no synchronize per
sample.  ``render --distributed``
joins the process group torchrun describes (one rank per card over NCCL)
and renders over the rank mesh that ``ptx_torch.parallel.mesh.plan``
picks (``--tp`` forces the scene axis, ``--comm`` its exchange); rank 0
writes the files.  Without torchrun it is a world of 1.  ``bench`` measures the
headline row (``arch:300000`` at 256x256, 16 spp,
4 bounces unless flags say otherwise) and the extra rows of
``ptx_torch.bench`` and prints one JSON line; with ``--backward``, the two
backward rows (grad-paths/s; 128x128, 4 spp, 4 bounces unless flags say
otherwise).  ``invert`` perturbs the named scene parameters and recovers
them by gradient descent (``ptx_torch.diff.inverse.run_inverse_demo``).
``partition`` prints the primitive split of a glTF scene
(``ptx_torch.parallel.partition.split_scene``) as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SHADERS = {
    "pallas": "the fused sun and shade kernels; their plain torch versions "
              "on the CPU",
    "xla": "the plain torch shade stage",
}


def _add_render_args(p: argparse.ArgumentParser, scene_required: bool = True):
    p.add_argument("--scene", required=scene_required,
                   help="glTF path, synthetic:<n_tris>[:seed] or arch:<n_tris>")
    p.add_argument("--out", default="out.png")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--bounces", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "brute", "bvh", "pallas"])
    p.add_argument("--shader", default="auto", choices=["auto", "xla", "pallas"])
    p.add_argument("--transparent-background", action="store_true")
    p.add_argument("--physical", action="store_true",
                   help="physically-correct mode instead of reference quirks")
    p.add_argument("--quirks", default="worker",
                   choices=["worker", "monolithic", "physical"])
    p.add_argument("--sort-rays", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--config", help="JSON RenderConfig (overrides other flags)")
    p.add_argument("--checkpoint", help="checkpoint file for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=5)
    p.add_argument("--env", help="environment map image (.hdr or LDR); "
                                 "glTF scenes only")
    p.add_argument("--visualize", choices=["depth", "normals", "bvh-depth",
                                           "nan-check"],
                   help="debug visualization instead of a beauty render")
    p.add_argument("--distributed", action="store_true",
                   help="render over the rank mesh (one process per rank, "
                        "launched by torch.distributed.run)")
    p.add_argument("--tp", type=int, default=None,
                   help="force the scene-sharding axis size (default: the "
                        "planner picks from scene size vs device memory)")
    p.add_argument("--comm", default="reduce", choices=["reduce", "ring"],
                   help="scene-axis exchange: min reduce or ring schedule")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR; it "
                        "holds the ptx.sample, ptx.launch, ptx.replay and "
                        "ptx.exchange spans")
    p.add_argument("--metrics", action="store_true",
                   help="print per-phase timing/throughput at the end")


def _config_from_args(args):
    from ptx_torch.config import Quirks, RenderConfig

    if args.config:
        with open(args.config) as f:
            return RenderConfig.from_json(f.read())
    mode = "physical" if args.physical else args.quirks
    quirks = {
        "worker": Quirks,
        "monolithic": Quirks.monolithic,
        "physical": Quirks.physical,
    }[mode]()
    return RenderConfig(
        width=args.width,
        height=args.height,
        samples=args.samples,
        bounces=args.bounces,
        seed=args.seed,
        intersector=args.intersector,
        shader=args.shader,
        transparent_background=args.transparent_background,
        sort_rays=args.sort_rays,
        quirks=quirks,
    )


def cmd_render(args) -> int:
    import os

    import torch

    from ptx_torch import render as R
    from ptx_torch.io.png import write_png
    from ptx_torch.utils import Metrics, profiler_trace

    writer = True
    if args.distributed:
        # Before the scene loads: the process group also picks this rank's
        # card.
        import torch.distributed as dist

        from ptx_torch.parallel import multihost

        if multihost.initialize(device=args.device):
            writer = dist.get_rank() == 0
    cfg = _config_from_args(args)
    device = torch.device(args.device)
    env_image = None
    if args.env:
        from ptx_torch.io.hdr import load_env_image

        env_image = load_env_image(args.env)
        if args.scene.startswith(("synthetic:", "arch:")):
            print(f"--env: {args.scene.split(':')[0]} scenes have no "
                  "environment slot; the image is ignored", file=sys.stderr)
    t0 = time.time()
    fs, static = R.load_scene(args.scene, quirks=cfg.quirks, env_image=env_image)
    print(f"loaded {static.n_tris} triangles, {static.n_materials} materials "
          f"in {time.time() - t0:.2f}s (sun={static.has_sun})", file=sys.stderr)

    if args.visualize:
        from ptx_torch.debug import visualize

        image = visualize(fs, static, cfg, args.visualize, device)
        if writer:
            write_png(args.out, image)
            print(f"wrote {args.visualize} visualization to {args.out}",
                  file=sys.stderr)
        return 0

    shader = R.resolve_shader(cfg)
    print(f"device {device}: shader {shader} ({SHADERS[shader]})",
          file=sys.stderr)

    def progress(done, total):
        print(f"\rsample {done}/{total}", end="", file=sys.stderr)

    metrics = Metrics() if args.metrics else None
    # The preview of each checkpoint goes beside the output:
    # out.png -> out.preview.png.
    preview = (os.path.splitext(args.out)[0] + ".preview.png"
               if args.checkpoint else None)
    t0 = time.time()
    with profiler_trace(args.profile):
        if args.distributed:
            from ptx_torch.parallel import dist as pdist
            from ptx_torch.parallel import mesh as pmesh

            plan = pmesh.plan(static.n_tris_padded,
                              n_texels=int(fs.tex_texels.shape[0]),
                              force_tp=args.tp, device=device)
            print(f"mesh plan: dp={plan.dp} tp={plan.tp} "
                  f"scene_sharded={plan.scene_sharded} "
                  f"shard_textures={plan.shard_textures} comm={args.comm}",
                  file=sys.stderr)
            res = pdist.render_distributed(
                fs, static, cfg, plan=plan, comm=args.comm,
                progress=progress, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, metrics=metrics,
                preview_path=preview, device=device)
        else:
            res = R.render(fs, static, cfg, device=device, progress=progress,
                           checkpoint_path=args.checkpoint,
                           checkpoint_every=args.checkpoint_every,
                           metrics=metrics, preview_path=preview)
    dt = time.time() - t0
    paths = cfg.width * cfg.height * cfg.samples
    print(f"\nrendered {paths} primary rays in {dt:.2f}s "
          f"({paths / dt:,.0f} paths/s on {device})", file=sys.stderr)
    if metrics is not None:
        print(metrics.report(), file=sys.stderr)
    if args.profile:
        print(f"wrote a torch.profiler trace to {args.profile}", file=sys.stderr)
    if writer:
        write_png(args.out, res.image)
        print(f"wrote {args.out}", file=sys.stderr)
    if args.distributed:
        from ptx_torch.parallel import multihost

        multihost.shutdown()
    return 0


# The headline row's scene and size: bench's defaults without --backward.
BENCH_DEFAULTS = dict(scene="arch:300000", width=256, height=256, samples=16,
                      bounces=4)


def cmd_bench(args) -> int:
    from ptx_torch import bench

    defaults = (dict(scene=bench.BACKWARD_SCENE, **bench.BACKWARD_SHAPE)
                if args.backward else BENCH_DEFAULTS)
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    run = bench.run_backward_benches if args.backward else bench.run_bench
    result = run(scene=args.scene, cfg=_config_from_args(args), device=args.device)
    print(json.dumps(result))
    return 0


def cmd_invert(args) -> int:
    from ptx_torch.diff.inverse import run_inverse_demo

    fields = tuple(f.strip() for f in args.params.split(",") if f.strip())
    run_inverse_demo(args.scene, _config_from_args(args), steps=args.steps,
                     lr=args.lr, param_fields=fields, device=args.device)
    return 0


def cmd_partition(args) -> int:
    """The scene's primitive split (the reference preprocessor's plan)."""
    from ptx_torch.parallel.partition import split_scene

    split = split_scene(args.scene, num_workers=args.num_workers,
                        memory_per_worker_gb=args.memory_per_worker_gb)
    print(split.to_json())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ptx_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render")
    _add_render_args(p)
    p.set_defaults(fn=cmd_render)
    p = sub.add_parser("bench")
    _add_render_args(p, scene_required=False)
    p.add_argument("--backward", action="store_true",
                   help="grad-paths/s of the two backward rows")
    # Scene and size from BENCH_DEFAULTS or bench's backward shape unless
    # given.
    p.set_defaults(fn=cmd_bench, scene=None, width=None, height=None,
                   samples=None, bounces=None, intersector="pallas")
    p = sub.add_parser("invert")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument(
        "--params", default="mat_albedo,mat_emissive",
        help="comma-separated fields to recover (mat_albedo, mat_emissive, "
             "mat_roughness, mat_metallic, sun_energy; tri_a, through the "
             "Moller-Trumbore epilogue, with intersector pallas or brute)")
    p.set_defaults(fn=cmd_invert)
    p = sub.add_parser("partition")
    p.add_argument("--scene", required=True)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--memory-per-worker-gb", type=float, default=None)
    p.set_defaults(fn=cmd_partition)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
