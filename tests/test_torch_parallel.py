"""The port's multi-rank render (``ptx_torch.parallel``) on the CPU.

A module fixture starts one 2-rank and one 4-rank gloo world
(``tests/_torch_dist_worker.py``, one process per rank) and, beside them,
the CLI's ``render --distributed --device cpu`` as two ranks and the CLI
on one process, all under one timeout; each world renders all of its
cases and writes one file per case and rank.  Every case is then one
test:

* against the port's single-device render, with the tolerances of ``ptx``'s
  own ``tests/test_parallel.py``: ray-parallel and brute-force cases
  rtol 1e-5, atol 1e-6 and alpha equal; scene-parallel cases over every
  intersector atol 1e-5 (shard-local BVHs and tiles);
* three layouts against ``ptx.parallel.dist.render_distributed`` on the
  virtual CPU devices, with the render-parity bound of
  ``tests/test_torch_render.py`` (|dcolor| <= 1e-4 on >= 99 % of pixels,
  alpha equal and the uint8 image within 1 on >= 99 %);
* each tp rank's device pass (``integrator.graphs.DevicePass``, its chunk
  steps cut at the exchanges; no capture on the CPU) against the same
  render on the host loop, bit for bit, for reduce and ring with
  compaction, a 2 x 2 ring and a sharded texel pack;
* survivor compaction on every shard, sample batching (k = 4 against
  k = 1, rtol 1e-6, atol 1e-7), the auto-chunk, checkpoint and resume (bit
  for bit) and sharded textures (bit-equal to the replicated pack);
* each layout's process groups made once, and the CLI's PNGs against the
  single process's (ray-parallel bit-equal, scene-parallel within the
  render-parity bound);
* the distributed training step (``grad`` cases): loss and gradients
  against the port's one-device ``make_batch_value_and_grad_fn`` within
  1e-5 (relative; relative L2), the parameters after one Adam step against
  the one-device step, the two refusals raised before any collective, and
  two layouts against ``ptx``'s shard_map training step (composed as
  ``__graft_entry__.dryrun_multichip`` composes it) within 1e-4 (loss) and
  1e-3 relative L2 (gradients);
* each tp training step again on the device scan (``diff.graphs.
  DeviceScan``, its steps' forward cut at the exchanges; no capture on the
  CPU): loss, gradients and parameters after the Adam step bit-equal to
  the host scan's on every rank, route ``DeviceScan``.

Every rank returns the whole image (the whole loss, gradients and
parameters); each rank's is held equal to rank 0's, bit for bit.
A world that fails fails its own test and every case it did not finish.
"""

import functools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import _torch_dist_worker as W
import _torch_port  # noqa: F401  (one torch thread per test process)
from ptx_torch import render as R

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
ROOT = os.path.dirname(os.path.dirname(WORKER))
# Seconds a world may take (about 10 s alone on this suite's CPUs).
WORLD_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, argv, torchrun=True):
    """``world`` processes of ``argv``, each with torchrun's environment of
    its rank (none with ``torchrun=False``: a plain single process)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    if torchrun:
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    return [subprocess.Popen(
        argv, cwd=ROOT,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)} if torchrun else env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]


# The CLI's --distributed on the CPU with two ranks of torchrun's
# environment (the backend follows --device: gloo), and the CLI on one
# process; each writes one PNG.
CLI_ARGS = ["--device", "cpu", "--scene", W.SCENE, "--width", "32",
            "--height", "16", "--samples", "1", "--bounces", "2",
            "--intersector", "brute"]
CLI_RUNS = {"cli_single": (1, [], False),
            "cli_dp2": (2, ["--distributed"], True),
            "cli_tp2_ring": (2, ["--distributed", "--tp", "2", "--comm", "ring"],
                             True)}


def _finish(procs, deadline):
    """None when every rank exited 0, else what went wrong; a world that
    outlives its deadline is killed."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            return f"world of {len(procs)} timed out after {WORLD_TIMEOUT} s"
    bad = [(r, log) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    if bad:
        return "\n".join(f"rank {r} failed:\n{log[-3000:]}" for r, log in bad)
    return None


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("worlds"))
    started = {w: _start(w, [sys.executable, WORKER, out]) for w in (2, 4)}
    for name, (world, flags, torchrun) in CLI_RUNS.items():
        started[name] = _start(world, [
            sys.executable, "-m", "ptx_torch.cli", "render", *flags, *CLI_ARGS,
            "--out", os.path.join(out, f"{name}.png")], torchrun)
    deadline = time.time() + WORLD_TIMEOUT
    errors = {w: _finish(p, deadline) for w, p in started.items()}
    return out, errors


@pytest.mark.parametrize("world", [2, 4])
def test_world_exits_cleanly(worlds, world):
    assert worlds[1][world] is None, worlds[1][world]


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_reuses_each_layouts_groups(worlds, world):
    """Every mesh of a layout after its first reuses the first's groups
    (no new process groups per render)."""
    import json

    out, errors = worlds
    for r in range(world):
        path = os.path.join(out, f"mesh.rank{r}.json")
        assert os.path.exists(path), errors[world]
        with open(path) as f:
            got = json.load(f)
        assert got["reused"] and got["meshes"] > got["layouts"] >= 2, got


def test_exchange_spans_count_the_collectives(worlds):
    """A profiled tp render: on each rank one ``ptx.exchange`` span per
    collective run (``dist.STATS.calls``)."""
    import json

    out, errors = worlds
    world = W.CASES[W.SPANS]["world"]
    for r in range(world):
        path = os.path.join(out, f"spans.rank{r}.json")
        assert os.path.exists(path), errors[world]
        with open(path) as f:
            got = json.load(f)
        assert got["calls"] > 0 and got["spans"] == got["calls"], got


@pytest.mark.parametrize("name", ["cli_dp2", "cli_tp2_ring"])
def test_cli_distributed_on_the_cpu(worlds, name):
    """``render --distributed --device cpu`` under two ranks of torchrun's
    environment: both ranks exit 0 and rank 0 writes the PNG; the
    ray-parallel PNG equals the single process's, the scene-parallel one
    is within the render-parity bound of it."""
    from ptx_torch.io.png import read_png

    out, errors = worlds
    for run in ("cli_single", name):
        assert errors[run] is None, errors[run]
    got, want = (read_png(os.path.join(out, f"{run}.png")).astype(int)
                 for run in (name, "cli_single"))
    assert got.shape == want.shape == (16, 32, 4) and got[..., :3].max() > 0
    if name == "cli_dp2":
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want).max(-1) <= 1).mean() >= 0.99


def _result(worlds, name, world):
    """Rank 0's image of a case, after checking every rank's equals it.  A
    case whose files are missing fails with its world's error."""
    out, errors = worlds
    paths = [os.path.join(out, f"{name}.rank{r}.npz") for r in range(world)]
    assert all(os.path.exists(p) for p in paths), errors[world]
    ranks = [dict(np.load(p)) for p in paths]
    for r in ranks[1:]:
        for key in ("color", "alpha", "image"):
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0]


@functools.lru_cache(maxsize=None)
def _single(name, samples=None):
    """The port's single-device render of a case's scene and config."""
    spec = W.CASES[name]
    fs, static = W.load(spec["scene"])
    over = {} if samples is None else dict(samples=samples)
    res = R.render(fs, static, W.config(spec, **over), device="cpu")
    return dict(color=res.color, alpha=res.alpha, image=res.image)


def _assert_parity(got, ref):
    """The render-parity bound of ``tests/test_torch_render.py``."""
    assert np.isfinite(got["color"]).all() and got["color"].mean() > 0.01
    dcolor = np.abs(got["color"] - ref["color"]).max(-1)
    assert (dcolor <= 1e-4).mean() >= 0.99
    assert (got["alpha"] == ref["alpha"]).mean() >= 0.99
    dimg = np.abs(got["image"].astype(int) - ref["image"].astype(int)).max(-1)
    assert (dimg <= 1).mean() >= 0.99


LAYOUTS = [n for n, s in W.CASES.items()
           if s["kind"] == "render" and not n.startswith(("batch", "tex"))]


@pytest.mark.parametrize("name", LAYOUTS)
def test_distributed_matches_single_device(worlds, name):
    spec = W.CASES[name]
    got = _result(worlds, name, spec["world"])
    ref = _single(name)
    assert got["color"].shape == (16, 32, 3) and got["color"].mean() > 0.01
    if spec["cfg"]["intersector"] == "brute":
        np.testing.assert_allclose(got["color"], ref["color"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["alpha"], ref["alpha"])
    else:
        np.testing.assert_allclose(got["color"], ref["color"], atol=1e-5)


def test_compaction_runs_on_every_shard():
    """The compaction cases compact on each shard's own view, so their live
    counts go through ``live_sync``."""
    from ptx_torch.kernels import sorting
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel.shard_scene import build_shard_scene

    for name, spec in W.CASES.items():
        if name.startswith("compact"):
            fs, static = W.load(spec["scene"])
            cfg = W.config(spec)
            _, local = build_shard_scene(
                fs, static, pmesh.Plan(spec["dp"], spec["tp"], True), cfg,
                device="cpu")
            assert sorting.resolve_compact(local, cfg), name


@pytest.mark.parametrize("dp,tp,comm", [(1, 2, "reduce"), (1, 2, "ring"),
                                        (2, 2, "reduce")])
def test_matches_jax_render_distributed(worlds, dp, tp, comm):
    from ptx import render as jrender
    from ptx.config import RenderConfig
    from ptx.parallel import dist as jdist
    from ptx.parallel import mesh as jmesh

    name = f"dp{dp}_tp{tp}_{comm}_brute"
    got = _result(worlds, name, dp * tp)
    fs, static = jrender.load_scene(W.SCENE, device=False)
    plan = jmesh.Plan(dp=dp, tp=tp, scene_sharded=True)
    ref = jdist.render_distributed(
        fs, static, RenderConfig(**W.CASES[name]["cfg"]), plan=plan,
        mesh=jmesh.make_mesh(plan), comm=comm)
    _assert_parity(got, dict(color=np.asarray(ref.color),
                             alpha=np.asarray(ref.alpha),
                             image=np.asarray(ref.image)))


@pytest.mark.parametrize("layout", ["dp2_tp1_reduce", "dp1_tp2_ring",
                                    "dp2_tp2_reduce"])
def test_sample_batching_matches_unbatched(worlds, layout):
    world = W.CASES[f"batch4_{layout}"]["world"]
    batched = _result(worlds, f"batch4_{layout}", world)
    unbatched = _result(worlds, f"batch1_{layout}", world)
    np.testing.assert_allclose(batched["color"], unbatched["color"],
                               rtol=1e-6, atol=1e-7)


def test_auto_chunk_matches_whole_frame(worlds):
    whole = _result(worlds, "chunk_dp2.whole", 2)
    capped = _result(worlds, "chunk_dp2.capped", 2)
    np.testing.assert_array_equal(capped["color"], whole["color"])
    np.testing.assert_array_equal(capped["alpha"], whole["alpha"])


def test_checkpoint_resume_is_bit_equal(worlds):
    full = _result(worlds, "ckpt_dp2.full", 2)
    resumed = _result(worlds, "ckpt_dp2.resumed", 2)
    np.testing.assert_array_equal(resumed["color"], full["color"])
    np.testing.assert_array_equal(resumed["alpha"], full["alpha"])


def test_two_rank_checkpoint_resumes_on_one_device(worlds, tmp_path):
    import shutil

    from ptx_torch.io import checkpoint as ck

    out, errors = worlds
    assert os.path.exists(os.path.join(out, "ckpt_dp2.at2.npz")), errors[2]
    path = str(tmp_path / "at2.npz")
    shutil.copy(os.path.join(out, "ckpt_dp2.at2.npz"), path)
    assert ck.load(path).samples_done == 2
    spec = W.CASES["ckpt_dp2"]
    fs, static = W.load(spec["scene"])
    resumed = R.render(fs, static, W.config(spec, samples=4), device="cpu",
                       checkpoint_path=path)
    np.testing.assert_array_equal(resumed.color,
                                  _single("ckpt_dp2", samples=4)["color"])
    np.testing.assert_array_equal(resumed.color,
                                  _result(worlds, "ckpt_dp2.full", 2)["color"])


@pytest.mark.parametrize("name", W.HOST_LOOP)
def test_tp_device_pass_matches_host_loop(worlds, name):
    """A tp rank's sample pass is the device pass (its chunk steps cut at
    the exchanges; on the CPU the same schedule runs without capture), and
    its image equals the same render on the host loop bit for bit."""
    out, errors = worlds
    world = W.CASES[name]["world"]
    got = _result(worlds, name, world)
    want = _result(worlds, f"{name}.host", world)
    for key in ("color", "alpha"):
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      want[key].view(np.uint32), err_msg=key)
    np.testing.assert_array_equal(got["image"], want["image"])
    for r in range(world):
        with open(os.path.join(out, f"{name}.route.rank{r}")) as f:
            assert f.read() == "DevicePass", errors[world]


def test_sharded_textures_match_replicated(worlds):
    rep = _result(worlds, "tex_tp2_replicated", 2)
    shd = _result(worlds, "tex_tp2_sharded", 2)
    np.testing.assert_array_equal(shd["color"], rep["color"])
    np.testing.assert_array_equal(shd["alpha"], rep["alpha"])
    ref = _single("tex_tp2_sharded")
    np.testing.assert_allclose(shd["color"], ref["color"], rtol=1e-5, atol=1e-6)


GRADS = [n for n, s in W.CASES.items()
         if s["kind"] == "grad" and "refuse" not in n]
REFUSALS = [n for n, s in W.CASES.items()
            if s["kind"] == "grad" and "refuse" in n]
# Two routes of the same torch code (the bound of tests/test_torch_diff.py);
# against ptx, the bounds of tests/test_torch_inverse.py.
GRAD_REL = 1e-5
JAX_LOSS_REL, JAX_GRAD_REL = 1e-4, 1e-3


def _ranks(worlds, name):
    """Every rank's file of a case, or of its run ``<case>.<route>``
    (missing: its world's error)."""
    out, errors = worlds
    world = W.CASES[name.split(".")[0]]["world"]
    paths = [os.path.join(out, f"{name}.rank{r}.npz") for r in range(world)]
    assert all(os.path.exists(p) for p in paths), errors[world]
    return [dict(np.load(p)) for p in paths]


def _step_result(worlds, name):
    """Rank 0's loss, gradients and parameters after the Adam step of a
    grad case, after checking every rank's equal to them bit for bit."""
    ranks = _ranks(worlds, name)
    for r, got in enumerate(ranks[1:], 1):
        assert got.keys() == ranks[0].keys()
        for key in ranks[0]:
            np.testing.assert_array_equal(got[key], ranks[0][key],
                                          err_msg=f"rank {r}: {key}")
    return ranks[0]


@functools.lru_cache(maxsize=None)
def _single_step(name):
    """The port's one-device value and gradient of a grad case's frame,
    and the parameters after one Adam step from them."""
    import torch

    from ptx_torch.diff import inverse

    spec = W.CASES[name]
    cfg = W.config(spec)
    fs, static = R.ensure_accel(*W.load(spec["scene"]), cfg, device="cpu")
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, torch.from_numpy(W.grad_target(cfg)), cfg.samples,
        param_fields=spec["params"], max_chunk_rays=spec["max_chunk_rays"])
    loss, grads = vg({f: getattr(fs, f) for f in spec["params"]}, fs)
    params = {f: getattr(fs, f).detach().clone().requires_grad_(True)
              for f in spec["params"]}
    opt = inverse.adam(params, W.LR)
    for f, p in params.items():
        p.grad = grads[f]
    opt.step()
    return (float(loss), {f: g.numpy() for f, g in grads.items()},
            {f: p.detach().numpy() for f, p in params.items()})


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def _assert_adam_step(got, want, grad, lr):
    """Parameters after one Adam step: within 1e-5 where the gradient is
    above 1e-3 of its largest magnitude; elsewhere within 2 lr (a first
    step moves a parameter by +-lr whatever its gradient's size, so the
    sign of a tiny gradient decides it)."""
    d = np.abs(got - want)
    big = np.abs(grad) > 1e-3 * np.abs(grad).max()
    assert (d[big] <= 1e-5).all(), float(d[big].max())
    assert (d <= 2 * lr).all(), float(d.max())


@pytest.mark.parametrize("name", GRADS)
def test_distributed_grad_matches_single_device(worlds, name):
    got = _step_result(worlds, name)
    loss, grads, _ = _single_step(name)
    assert np.isfinite(got["loss"]) and loss > 0
    assert abs(float(got["loss"]) - loss) <= GRAD_REL * loss
    for f, g in grads.items():
        assert np.abs(g).max() > 0, f"{f}: no gradient to compare"
        assert _rel_l2(got[f"grad.{f}"], g) <= GRAD_REL, f


@pytest.mark.parametrize("name", GRADS)
def test_distributed_adam_step_matches_single_device(worlds, name):
    got = _step_result(worlds, name)
    _, grads, params = _single_step(name)
    for f, p in params.items():
        _assert_adam_step(got[f"param.{f}"], p, grads[f], W.LR)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", W.DEVICE_SCAN)
def test_tp_device_scan_matches_host_scan(worlds, name):
    """A tp rank's training step on the device scan (each bounce step's
    forward cut into segments at its exchanges, the world's live count read
    one iteration late; on the CPU without capture) gives every rank the
    host scan's loss, gradients and parameters after the Adam step, bit
    for bit."""
    host = _step_result(worlds, name)
    scan = _step_result(worlds, f"{name}.scan")
    assert list(scan["route"]) == ["DeviceScan"]
    assert "DeviceScan" not in list(host["route"])
    assert scan.keys() == host.keys()
    for key in host:
        if key != "route":
            np.testing.assert_array_equal(_bits(scan[key]), _bits(host[key]),
                                          err_msg=key)


@pytest.mark.parametrize("name", REFUSALS)
def test_distributed_grad_refuses_before_any_collective(worlds, name):
    """A vertex field under tp = 2 and the texels of a sharded pack raise
    ValueError on every rank with no collective issued; the world still
    exits cleanly (test_world_exits_cleanly)."""
    for got in _ranks(worlds, name):
        assert "carries no gradient" in str(got["refused"])
        assert int(got["calls"]) == 0


@pytest.mark.parametrize("name", ["grad_dp2_brute", "grad_dp2_tp2_reduce_brute"])
def test_grad_matches_jax_shard_map_step(worlds, name):
    """``ptx``'s training step composed as ``__graft_entry__.
    dryrun_multichip`` composes it (``shard_map`` of the differentiable
    integrator over a dp x tp mesh of the virtual CPU devices,
    ``sharded_closest`` / ``sharded_any_hit`` on the scene axis,
    ``inject_params``, ``jax.value_and_grad`` of the MSE, one
    ``optax.adam`` update) on the case's scene, config and target."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from ptx import render as jrender
    from ptx.config import RenderConfig
    from ptx.diff.inverse import inject_params
    from ptx.integrator.wavefront import make_integrator
    from ptx.parallel import dist as jdist
    from ptx.parallel import mesh as jmesh

    spec = W.CASES[name]
    got = _step_result(worlds, name)
    plan = jmesh.Plan(dp=spec["dp"], tp=spec["tp"],
                      scene_sharded=spec["tp"] > 1)
    mesh = jmesh.make_mesh(plan)
    cfg = RenderConfig(**spec["cfg"])
    fs, static = jrender.load_scene(spec["scene"])
    fs = jmesh.shard_scene(fs, mesh, plan.scene_sharded)
    closest, any_hit = jrender.get_backend(static, cfg)
    if plan.scene_sharded:
        closest = jdist.sharded_closest(closest)
        any_hit = jdist.sharded_any_hit(any_hit)
    inner = jax.shard_map(
        make_integrator(static, cfg, closest, any_hit, differentiable=True),
        mesh=mesh,
        in_specs=(jmesh.scene_shardings(mesh, plan.scene_sharded),
                  P(jmesh.AXIS_RAYS), P(jmesh.AXIS_RAYS)),
        out_specs=(P(jmesh.AXIS_RAYS), P(jmesh.AXIS_RAYS)),
        check_vma=False)
    n_pixels = cfg.width * cfg.height
    target = jnp.asarray(W.grad_target(cfg))
    pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
    sample_ids = jnp.zeros((n_pixels,), jnp.int32)

    def loss_fn(params, fs):
        radiance, _ = inner(inject_params(fs, params), pixel_ids, sample_ids)
        return jnp.mean((radiance - target) ** 2)

    opt = optax.adam(W.LR)

    @jax.jit
    def train_step(params, opt_state, fs):
        val, grads = jax.value_and_grad(loss_fn)(params, fs)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), val, grads

    params = {f: getattr(fs, f) for f in spec["params"]}
    new, val, grads = train_step(params, opt.init(params), fs)
    val = float(val)
    assert abs(float(got["loss"]) - val) <= JAX_LOSS_REL * val
    for f in spec["params"]:
        g = np.asarray(grads[f])
        assert _rel_l2(got[f"grad.{f}"], g) <= JAX_GRAD_REL, f
        _assert_adam_step(got[f"param.{f}"], np.asarray(new[f]), g, W.LR)
