"""One rank of a gloo world on the CPU, for ``tests/test_torch_parallel.py``.

    RANK=r LOCAL_RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_dist_worker.py OUT_DIR

Joins the world through ``ptx_torch.parallel.multihost.initialize`` (the
torchrun environment; gloo, as there is no card), renders every case of
:data:`CASES` whose world size is ``n`` with
``ptx_torch.parallel.dist.render_distributed`` and writes each rank's
image to ``OUT_DIR/<case>.rank<r>.npz`` (a case of :data:`HOST_LOOP`
also ``<case>.host.rank<r>.npz``, the same render with the fused step on
the host loop, and the route its sample pass took; a ``grad`` case: one
step of
``dist.make_distributed_train_step``, its loss, gradients and parameters
after the Adam update and the class of its integrator, or the
``ValueError`` it raised and the collective calls made before it; a case
of :data:`DEVICE_SCAN` also ``<case>.scan.rank<r>.npz``, the same step on
the device scan); the case :data:`SPANS` again under a CPU ``torch.profiler``,
its ``ptx.exchange`` spans and collective calls in ``spans.rank<r>.json``;
then, in ``mesh.rank<r>.json``,
whether every mesh of a layout reused the groups of its first.  Imports
only ``ptx_torch`` and numpy; the test imports :data:`CASES` and builds
the references.
"""

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = "synthetic:3000"
# Above 4 tiles per shard at tp = 2, so each shard's loop compacts.
BIG_SCENE = "synthetic:6000"
# Rays per rank are a multiple of 128 in every layout (32 x 16 / 4), so
# the distributed and single-device renders take the same shader.
SIZE = dict(width=32, height=16, samples=1, bounces=2)


# The training step's parameters, Adam's rate and the seed of its target
# (uniform in [0, 1), not the scene's own image); the sun-lit scene of its
# cases with a sun or a vertex field (synthetic:3000 has no sun, so
# neither gets a gradient there).
LIT_SCENE = "arch:2000"
MATERIALS = ("mat_albedo", "mat_emissive")
LR = 1e-2
TARGET_SEED = 11


def _case(world, dp, tp, comm="reduce", scene=SCENE, kind="render",
          shard_textures=False, params=MATERIALS, max_chunk_rays=None, **cfg):
    return dict(world=world, dp=dp, tp=tp, comm=comm, scene=scene, kind=kind,
                shard_textures=shard_textures, params=params,
                max_chunk_rays=max_chunk_rays, cfg={**SIZE, **cfg})


def _cases():
    c = {"dp2_brute": _case(2, 2, 1, intersector="brute")}
    for dp, tp, comm in [(1, 2, "reduce"), (1, 2, "ring"), (2, 2, "reduce"),
                         (2, 2, "ring"), (1, 4, "reduce")]:
        for isect in ("brute", "bvh", "pallas"):
            c[f"dp{dp}_tp{tp}_{comm}_{isect}"] = _case(
                dp * tp, dp, tp, comm, intersector=isect, sort_rays="off")
    # Survivor compaction on every shard (the live counts synced).
    for dp, tp, comm in [(1, 2, "reduce"), (1, 2, "ring"), (2, 2, "ring")]:
        c[f"compact_dp{dp}_tp{tp}_{comm}"] = _case(
            dp * tp, dp, tp, comm, scene=BIG_SCENE, intersector="pallas",
            bounces=3)
    # Four samples in one launch, and one per launch.
    for dp, tp, comm in [(2, 1, "reduce"), (1, 2, "ring"), (2, 2, "reduce")]:
        for k in (4, 1):
            c[f"batch{k}_dp{dp}_tp{tp}_{comm}"] = _case(
                dp * tp, dp, tp, comm, intersector="brute", samples=4,
                samples_per_launch=k)
    c["chunk_dp2"] = _case(2, 2, 1, kind="chunk", intersector="brute",
                           width=32, height=32, samples=2)
    # One sample per launch: the resumed run then folds its samples into
    # the mean in the same order as the uninterrupted one (a k-sample fold
    # rounds differently from k single folds).
    c["ckpt_dp2"] = _case(2, 2, 1, kind="ckpt", intersector="brute",
                          width=16, height=16, samples_per_launch=1)
    for shard in (False, True):
        c[f"tex_tp2_{'sharded' if shard else 'replicated'}"] = _case(
            2, 1, 2, scene="textured", shard_textures=shard,
            intersector="brute", width=16, height=16, samples=2,
            environment_factor=(0.0, 0.0, 0.0))
    # The distributed training step (materials unless named), and its two
    # refusals.
    for name, world, dp, tp, comm, isect, extra in [
        ("grad_dp2_brute", 2, 2, 1, "reduce", "brute", {}),
        ("grad_dp1_tp2_reduce_pallas", 2, 1, 2, "reduce", "pallas",
         dict(params=MATERIALS + ("sun_energy",), scene=LIT_SCENE)),
        ("grad_dp1_tp2_ring_brute", 2, 1, 2, "ring", "brute", {}),
        ("grad_dp2_tp2_reduce_pallas", 4, 2, 2, "reduce", "pallas", {}),
        ("grad_dp2_tp2_reduce_brute", 4, 2, 2, "reduce", "brute", {}),
        ("grad_dp2_tri_a_brute", 2, 2, 1, "reduce", "brute",
         dict(params=("tri_a",), scene=LIT_SCENE)),
        # One sample per launch and one pixel per chunk: two sample groups,
        # each run forward (with its exchanges) for the mean and again
        # before its own backward.
        ("grad_groups_dp1_tp2_reduce", 2, 1, 2, "reduce", "brute",
         dict(samples=2, width=4, height=4, max_chunk_rays=1)),
        # Materials on a sharded texel pack: the texel gathers' sums inside
        # every bounce step.
        ("grad_tex_tp2_sharded", 2, 1, 2, "reduce", "brute",
         dict(scene="textured", shard_textures=True, width=16, height=16)),
        ("grad_refuse_tri_a_tp2", 2, 1, 2, "reduce", "brute",
         dict(params=("tri_a",))),
        ("grad_refuse_tex_texels_sharded", 2, 1, 2, "reduce", "brute",
         dict(params=("tex_texels",), scene="textured", shard_textures=True,
              width=16, height=16)),
    ]:
        c[name] = _case(world, dp, tp, comm, kind="grad", intersector=isect,
                        **extra)
    return c


CASES = _cases()
# The tp cases rendered again on the host loop (the fused step's
# ``shade_cuda._eager_integrator``), which their device pass must equal
# bit for bit: reduce and ring with survivor compaction (the sort, the
# chunks and the lagged live counts on every rank), a 2 x 2 ring, and a
# sharded texel pack.
HOST_LOOP = ("compact_dp1_tp2_reduce", "compact_dp1_tp2_ring",
             "compact_dp2_tp2_ring", "tex_tp2_sharded")


# The tp training steps run again on the device scan
# (``diff.graphs.DeviceScan``: each bounce step's forward cut at its
# exchanges; forced on the CPU, where it runs its schedule without
# capture), which must equal the host scan's bit for bit: reduce with a sun,
# ring, a 2 x 2 layout, sample groups (a stale forward rerun with its
# exchanges) and a sharded texel pack.
DEVICE_SCAN = ("grad_dp1_tp2_reduce_pallas", "grad_dp1_tp2_ring_brute",
               "grad_dp2_tp2_reduce_pallas", "grad_groups_dp1_tp2_reduce",
               "grad_tex_tp2_sharded")


# The tp render profiled once more: each collective run (the exchanges of
# its chunk steps, the world's live counts, the gather of the carry) is one
# ``ptx.exchange`` span.
SPANS = "compact_dp1_tp2_reduce"


def grad_target(cfg):
    """The training step's target image [W * H, 3], from TARGET_SEED."""
    import numpy as np

    rng = np.random.default_rng(TARGET_SEED)
    return rng.uniform(0.0, 1.0, (cfg.width * cfg.height, 3)).astype(np.float32)


def train_step(fs, static, spec, plan, mesh, device_scan=False):
    """One distributed training step of a ``grad`` case on this rank: its
    loss, gradients and parameters after the update and the class of the
    integrator ``dist.diff_integrator`` made (``route``), or the refusal's
    message and the collective calls made before it.  ``device_scan``:
    the step on the device scan (``inverse.takes_device_scan`` answering
    yes on the CPU), else the CPU's own route, the host scan."""
    import torch

    from ptx_torch.diff import inverse
    from ptx_torch.parallel import dist as pdist

    cfg = config(spec)
    fs, static = pdist.prepare_scene(fs, static, cfg, plan, mesh, "cpu")
    calls = pdist.STATS.calls
    take, make, routes = inverse.takes_device_scan, pdist.diff_integrator, []

    def recorded(*args, **kwargs):
        integrator = make(*args, **kwargs)
        routes.append(type(integrator).__name__)
        return integrator

    pdist.diff_integrator = recorded
    if device_scan:
        inverse.takes_device_scan = lambda device: True
    try:
        step = pdist.make_distributed_train_step(
            static, cfg, mesh, plan, torch.from_numpy(grad_target(cfg)),
            cfg.samples, spec["comm"], spec["params"], spec["max_chunk_rays"],
            device="cpu", lr=LR)
    except ValueError as e:
        return dict(refused=str(e), calls=pdist.STATS.calls - calls)
    finally:
        pdist.diff_integrator, inverse.takes_device_scan = make, take
    params, opt = step.init({f: getattr(fs, f) for f in spec["params"]})
    loss = step(params, opt, fs)
    out = dict(loss=loss.numpy(), route=routes)
    for f, p in params.items():
        out[f"grad.{f}"] = p.grad.numpy()
        out[f"param.{f}"] = p.detach().numpy()
    return out


def host_loop(render, cfg):
    """``render(cfg)`` with the fused integrator on the host loop."""
    from ptx_torch.kernels import shade_cuda

    make = shade_cuda.make_pallas_integrator

    def eager(static, cfg, closest, any_hit, live_sync=None, tex_shard=None):
        step = shade_cuda.make_pallas_step(static, cfg, closest, any_hit,
                                           tex_shard=tex_shard)
        return shade_cuda._eager_integrator(static, cfg, step, live_sync)

    shade_cuda.make_pallas_integrator = eager
    try:
        return render(cfg)
    finally:
        shade_cuda.make_pallas_integrator = make


def route(fs, static, spec, plan, mesh):
    """The class of the sample pass ``render_distributed`` makes for a
    case on this rank."""
    from ptx_torch import render as R
    from ptx_torch.parallel import dist as pdist

    cfg = config(spec)
    _, static = pdist.prepare_scene(fs, static, cfg, plan, mesh, "cpu")
    k = R.resolve_samples_per_launch(cfg, ways=pdist.ray_ways(plan,
                                                               spec["comm"]))
    return type(pdist.make_distributed_sample_fn(
        static, cfg, mesh, plan, spec["comm"], k=k, device="cpu")).__name__


def load(scene):
    """The host scene of a case (numpy arrays)."""
    from ptx_torch import render as R

    if scene == "textured":
        from ptx_torch.scene.flatten import flatten
        from ptx_torch.scene.synthetic import make_textured_quads

        return flatten(make_textured_quads(3))
    return R.load_scene(scene)


def config(spec, **over):
    from ptx_torch.config import RenderConfig

    return RenderConfig(**{**spec["cfg"], **over})


def main(out_dir: str) -> int:
    sys.path.insert(0, ROOT)
    import json

    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ptx_torch import render as R
    from ptx_torch.parallel import dist as pdist
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import multihost

    assert multihost.initialize(), "no torchrun environment"
    world, rank = dist.get_world_size(), dist.get_rank()
    scenes, reused = {}, []
    # Each layout's groups, made on its first make_mesh; every later mesh
    # of the layout must reuse them.
    groups = {}

    def save(name, res):
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                 color=res.color, alpha=res.alpha, image=res.image)

    for name, spec in CASES.items():
        if spec["world"] != world:
            continue
        plan = pmesh.Plan(dp=spec["dp"], tp=spec["tp"],
                          scene_sharded=spec["tp"] > 1,
                          shard_textures=spec["shard_textures"])
        mesh = pmesh.make_mesh(plan, "cpu")
        made = groups.setdefault((plan.dp, plan.tp),
                                 (mesh.tp_group, mesh.dp_group))
        reused.append(made[0] is mesh.tp_group and made[1] is mesh.dp_group)
        if spec["scene"] not in scenes:
            scenes[spec["scene"]] = load(spec["scene"])
        fs, static = scenes[spec["scene"]]

        def render(cfg, **kw):
            return pdist.render_distributed(fs, static, cfg, plan=plan,
                                            mesh=mesh, comm=spec["comm"],
                                            device="cpu", **kw)

        if spec["kind"] == "render":
            save(name, render(config(spec)))
            if name == SPANS:
                calls = pdist.STATS.calls
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    render(config(spec))
                spans = sum(e.name == "ptx.exchange" for e in prof.events())
                with open(os.path.join(out_dir, f"spans.rank{rank}.json"),
                          "w") as f:
                    json.dump(dict(spans=spans,
                                   calls=pdist.STATS.calls - calls), f)
            if name in HOST_LOOP:
                save(f"{name}.host", host_loop(render, config(spec)))
                with open(os.path.join(out_dir, f"{name}.route.rank{rank}"),
                          "w") as f:
                    f.write(route(fs, static, spec, plan, mesh))
        elif spec["kind"] == "chunk":
            save(f"{name}.whole", render(config(spec)))
            cap = R.MAX_RAYS_PER_LAUNCH
            R.MAX_RAYS_PER_LAUNCH = 128  # 512 rays per rank: 4 chunks
            try:
                save(f"{name}.capped", render(config(spec)))
            finally:
                R.MAX_RAYS_PER_LAUNCH = cap
        elif spec["kind"] == "ckpt":
            path = os.path.join(out_dir, f"{name}.ckpt.npz")
            save(f"{name}.full", render(config(spec, samples=4)))
            render(config(spec, samples=2), checkpoint_path=path,
                   checkpoint_every=1)
            if rank == 0:
                # The 2-sample file, for a single-device resume.
                shutil.copy(path, os.path.join(out_dir, f"{name}.at2.npz"))
            save(f"{name}.resumed",
                 render(config(spec, samples=4), checkpoint_path=path))
        elif spec["kind"] == "grad":
            np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                     **train_step(fs, static, spec, plan, mesh))
            if name in DEVICE_SCAN:
                np.savez(os.path.join(out_dir, f"{name}.scan.rank{rank}.npz"),
                         **train_step(fs, static, spec, plan, mesh,
                                      device_scan=True))
        print(f"rank {rank}: {name} done", flush=True)
    with open(os.path.join(out_dir, f"mesh.rank{rank}.json"), "w") as f:
        json.dump(dict(layouts=len(groups), meshes=len(reused),
                       reused=all(reused)), f)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
