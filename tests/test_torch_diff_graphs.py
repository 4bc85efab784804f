"""The device scan (``ptx_torch.diff.graphs.DeviceScan``) on the CPU, where
it runs its schedule without capture (static buffers, the live count read
one iteration late, the all-dead step past the end, one backward per
step), against the host scan (``wavefront.make_integrator(...,
differentiable=True)``) on the same backend: the value and every gradient
bit for bit through ``inverse.slice_value_and_grad_fn`` (the body of
``make_batch_value_and_grad_fn``), on ``arch:2000`` with the tile
traversal's plain versions.  The JAX package's ``ptx.diff.inverse`` holds
the host scan (``tests/test_torch_inverse.py``, which also runs one case
through the device scan).  The routes to each scan, and a tp rank's
captures (CUDA's calls stubbed), are checked without a card; the tp ranks'
scans are held to the host scan in the gloo worlds of
``tests/test_torch_parallel.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from ptx_torch import render
from ptx_torch.config import RenderConfig
from ptx_torch.diff import graphs, inverse
from ptx_torch.integrator.wavefront import make_integrator
from ptx_torch.parallel import dist
from ptx_torch.parallel.mesh import Plan
from _torch_port import stub_cuda_graphs

SCENE = "arch:2000"
MATERIALS = ("mat_albedo", "mat_emissive", "mat_roughness", "sun_energy")
# A material of arch:2000 set to opacity 0.5: passthrough iterations past
# the bounces, and a scan that ends on its live count (the lag's dead step).
TRANSLUCENT = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(translucent=False):
    fs, static = render.load_scene(SCENE)
    if translucent:
        packed, opacity = np.array(fs.mat_packed), np.array(fs.mat_opacity)
        packed[TRANSLUCENT, 3] = opacity[TRANSLUCENT] = 0.5
        fs = fs._replace(mat_packed=packed, mat_opacity=opacity)
        static = dataclasses.replace(static, has_translucent=True)
    return fs, static


def _target(n):
    rng = np.random.default_rng(12)
    return torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _scans(static, cfg, fields):
    """(host scan, device scan) on ``inverse.diff_backend``'s pair."""
    pair = inverse.diff_backend(static, cfg, *render.get_backend(static, cfg,
                                                                 "cpu"),
                                fields, "cpu")
    return (make_integrator(static, cfg, *pair, differentiable=True),
            graphs.DeviceScan(static, cfg, *pair, *inverse.scan_fields(fields)))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(got, want):
    (v_g, g_g), (v_w, g_w) = got, want
    assert torch.equal(_bits(v_g), _bits(v_w)), (float(v_g), float(v_w))
    for f, w in g_w.items():
        assert torch.equal(g_g[f], w), f
        assert torch.isfinite(g_g[f]).all(), f


# (config, fields, chunk cap, translucent): the schedule each exercises.
CASES = {
    # Two 128-ray chunks replay the same steps.
    "materials": (dict(width=16, height=8, samples=2, bounces=3), MATERIALS,
                  128, False),
    # The tiles repacked per call land in the scan's buffers.
    "tri_a": (dict(width=16, height=8, samples=2, bounces=3), ("tri_a",), 128,
              False),
    # Passthrough iterations; the scan ends on its lagged count.
    "translucent": (dict(width=16, height=8, samples=2, bounces=3),
                    ("mat_albedo", "mat_emissive"), 256, True),
    # A cap of 2 rays over 4 samples: two sample groups per one-pixel chunk.
    "sample-groups": (dict(width=2, height=1, samples=4, bounces=2),
                      ("mat_albedo", "sun_energy"), 2, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_scan_matches_host_scan(case):
    size, fields, cap, translucent = CASES[case]
    cfg = RenderConfig(intersector="pallas", **size)
    fs, static = render.ensure_accel(*_scene(translucent), cfg, device="cpu")
    n = cfg.width * cfg.height
    target = _target(n)
    host, scan = _scans(static, cfg, fields)
    vgs = [inverse.slice_value_and_grad_fn(s, cfg, target, cfg.samples, 0, n,
                                           fields, cap) for s in (host, scan)]
    own = {f: getattr(fs, f) for f in fields}
    calls = [own, own]
    if fields == ("tri_a",):
        # Moved vertices first (their tiles packed anew), then the scene's.
        calls[0] = {"tri_a": fs.tri_a + torch.tensor([0.05, 0.0, 0.0])}
    for params in calls:
        want = vgs[0](params, fs)
        got = vgs[1](params, fs)
        _assert_bit_equal(got, want)
        assert any(float(g.abs().max()) > 0 for g in got[1].values())
        s = scan.schedule()
        assert s["host_steps"] <= s["steps"] <= s["host_steps"] + 1
        assert s["steps"] <= scan.max_iters
    if translucent:
        assert s["steps"] > cfg.bounces and s["dead_steps"] == 1
    assert scan._used  # a parameter buffer took the gradient


def test_batch_loss_sample_groups_recompute(monkeypatch):
    """``make_batch_loss_fn`` over two sample groups runs both forwards
    before one backward: the first group's steps must run forward again
    (their residuals were overwritten) before their backward.  The value is
    bit-equal; the gradients sum the two groups' scans in another order
    than the host scan's one graph (within 1e-6 relative L2)."""
    cfg = RenderConfig(width=8, height=4, samples=4, bounces=2,
                       intersector="pallas")
    fs, static = render.ensure_accel(*_scene(), cfg, device="cpu")
    target = _target(32)
    fields = ("mat_albedo", "mat_emissive")
    monkeypatch.setattr(render, "MAX_RAYS_PER_LAUNCH", 64)  # 2 groups of 2
    recomputes = []
    recompute = graphs.DeviceScan._recompute
    monkeypatch.setattr(graphs.DeviceScan, "_recompute",
                        lambda self, ctx: (recomputes.append(ctx.gen),
                                           recompute(self, ctx)))
    out = {}
    for name, device_scan in (("host", False), ("device", True)):
        monkeypatch.setattr(inverse, "takes_device_scan",
                            lambda *a, on=device_scan, **k: on)
        loss = inverse.make_batch_loss_fn(static, cfg, target, cfg.samples,
                                          param_fields=fields)
        leaves = {f: getattr(fs, f).detach().requires_grad_() for f in fields}
        v = loss(leaves, fs)
        out[name] = v, torch.autograd.grad(v, list(leaves.values()))
    assert len(recomputes) == 1
    assert torch.equal(out["device"][0], out["host"][0])
    for g, w in zip(out["device"][1], out["host"][1]):
        assert float(w.abs().max()) > 0
        assert float((g - w).norm() / w.norm()) <= 1e-6


def test_another_scene_raises():
    cfg = RenderConfig(width=16, height=8, samples=1, bounces=2,
                       intersector="pallas")
    fs_np, static = render.ensure_accel(*_scene(), cfg)
    fs = render.to_device(fs_np, "cpu")
    _, scan = _scans(static, cfg, ("sun_energy",))
    pix = torch.arange(128, dtype=torch.int32)
    smp = torch.zeros_like(pix)
    scan(fs, pix, smp)
    scan(fs._replace(sun_energy=fs.sun_energy * 2.0), pix, smp)  # copied in
    other = render.to_device(fs_np._replace(
        mat_packed=np.array(fs_np.mat_packed)), "cpu")
    with pytest.raises(ValueError, match="another scene"):
        scan(other, pix, smp)
    with pytest.raises(ValueError, match="carry a gradient"):
        leaf = fs.mat_albedo.detach().requires_grad_()
        scan(fs._replace(mat_albedo=leaf), pix, smp)
    with pytest.raises(ValueError, match="sun_energy"):
        scan(fs._replace(sun_energy=fs.sun_energy[:2]), pix, smp)


def test_routes_to_each_scan():
    """The device scan on a CUDA device (built without touching one),
    whatever collectives the step holds (a ``live_sync``, a tp rank's
    exchanges in reduce and ring mode, a sharded texel pack's sums, which
    it takes as its hooks); the host scan on the CPU, with the same
    hooks."""
    cfg = RenderConfig(width=16, height=8, samples=1, bounces=2,
                       intersector="pallas")
    fs, static = render.ensure_accel(*_scene(), cfg)
    pair = render.get_backend(static, cfg, "cpu")
    cuda = torch.device("cuda")
    for fields in (MATERIALS, ("tri_a",)):
        scan = inverse._resolve_diff_integrator(static, cfg, *pair, fields,
                                                cuda)
        assert isinstance(scan, graphs.DeviceScan)
        assert ((scan.grad_fields, scan.copy_fields)
                == inverse.scan_fields(fields))
        assert not isinstance(inverse._resolve_diff_integrator(
            static, cfg, *pair, fields, "cpu"), graphs.DeviceScan)
    sync = lambda n: n  # noqa: E731
    scan = inverse.make_diff_integrator(static, cfg, *pair, MATERIALS, "cuda",
                                        live_sync=sync)
    assert isinstance(scan, graphs.DeviceScan) and scan.live_sync is sync
    assert not isinstance(inverse.make_diff_integrator(
        static, cfg, *pair, MATERIALS, "cpu", live_sync=sync),
        graphs.DeviceScan)
    dp = Plan(dp=2, tp=1, scene_sharded=False)
    assert isinstance(dist.diff_integrator(static, cfg, None, dp, "reduce",
                                           MATERIALS, "cuda"),
                      graphs.DeviceScan)
    tp = Plan(dp=1, tp=2, scene_sharded=True)
    static_tp = dataclasses.replace(static, shard_local=True)
    mesh = types.SimpleNamespace(plan=tp, tp_group=None, tp_index=0)
    for layout, comm, st in [
            (tp, "reduce", static_tp), (tp, "ring", static_tp),
            (Plan(dp=2, tp=2, scene_sharded=True), "reduce", static_tp),
            (Plan(dp=1, tp=2, scene_sharded=True, shard_textures=True),
             "reduce", dataclasses.replace(static_tp, tex_shard_len=16))]:
        mesh.plan = layout
        scan = dist.diff_integrator(st, cfg, mesh, layout, comm, MATERIALS,
                                    "cuda")
        assert isinstance(scan, graphs.DeviceScan), (layout, comm)
        assert scan.live_sync is not None
        assert not isinstance(dist.diff_integrator(
            st, cfg, mesh, layout, comm, MATERIALS, "cpu"), graphs.DeviceScan)


class _FakeEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


def test_tp_step_capture_bookkeeping(monkeypatch):
    """A tp rank's device scan with CUDA's calls stubbed (the work a capture
    would record runs at once, a replay runs nothing) and its row's
    collectives logged (reduce mode, a world of one): each step's forward
    is a program of one segment per exchange plus one (the closest hit's
    key and payload, the occlusion max: four), its backward one graph; a
    step's first use runs each exchange once (its capture is that run),
    then the world's live count; a later call replays each program with its
    exchanges in capture order; a backward issues no exchange, and a stale
    forward's rerun before its backward runs each exchange once more; an
    exchange reached inside a backward capture raises before it runs."""
    from ptx_torch.kernels import _build

    cfg = RenderConfig(width=16, height=8, samples=1, bounces=2,
                       intersector="pallas")
    fs, static = render.ensure_accel(*_scene(), cfg, device="cpu")
    assert static.has_sun  # so each step also runs the occlusion max
    log = stub_cuda_graphs(monkeypatch)
    _build.reset_launches()
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda y, op, group: log.append("collective"))
    init = graphs._Launch.__init__

    def cuda_launch(self, r, device, max_iters):
        init(self, r, device, max_iters)
        self.cuda = True
        self.events = [_FakeEvent() for _ in range(max_iters + 1)]

    monkeypatch.setattr(graphs._Launch, "__init__", cuda_launch)
    plan = Plan(dp=1, tp=2, scene_sharded=True)
    mesh = types.SimpleNamespace(plan=plan, tp_group=None, tp_index=0,
                                 staging=False)
    fields = ("mat_albedo", "mat_emissive")
    closest, any_hit, live_sync, tex_shard = dist._exchanges(
        static, mesh, plan, "reduce", *render.get_backend(static, cfg, "cpu"))
    scan = graphs.DeviceScan(static, cfg, closest, any_hit,
                             *inverse.scan_fields(fields),
                             live_sync=live_sync, tex_shard=tex_shard)
    pix = torch.arange(128, dtype=torch.int32)
    smp = torch.zeros_like(pix)
    leaves = {f: getattr(fs, f).detach().requires_grad_() for f in fields}

    def logged(fn):
        first = len(log)
        out = fn()
        return out, log[first:]

    def call():
        return scan(inverse.inject_params(fs, leaves), pix, smp)[0]

    r1, first = logged(call)
    launch = scan._launches[128]
    steps = launch.steps
    assert len(steps) == scan.schedule()["steps"] >= 2
    for step in steps:
        assert [ex is not None for _, _, ex in step.forward] == [
            True, True, True, False]
        assert isinstance(step.backward[0], type(step.forward[0][0]))
    # The warm-up's three exchanges eagerly, then per step its three cuts
    # and the world's live count.
    assert first.count("collective") == 3 + 4 * len(steps)

    def program(step):
        out = []
        for graph, _, ex in step.forward:
            out += [f"replay {graph.n}"] + (["collective"] if ex else [])
        return out

    load = [f"replay {launch.graphs[('load',)][0][0].n}"]
    forward = sum((program(step) for step in steps), [])
    backward = [f"replay {step.backward[0].n}" for step in reversed(steps)]
    r2, again = logged(call)
    assert again == load + sum((program(step) + ["collective"]
                                for step in steps), [])
    _, grad = logged(lambda: torch.autograd.grad(r2.sum(),
                                                 list(leaves.values())))
    assert grad == backward
    _, rerun = logged(lambda: torch.autograd.grad(r1.sum(),
                                                  list(leaves.values())))
    assert rerun == load + forward + backward

    def exchange_in_backward(step):
        dist.all_reduce(mesh, torch.zeros(1), "sum", None)

    monkeypatch.setattr(scan, "_backward_body", exchange_in_backward)
    start = len(log)
    with pytest.raises(RuntimeError, match="single-graph capture"):
        scan._capture(graphs._Step(0, launch, True))
    bad = log[start:]
    # The forward's three cuts ran; the backward's capture ended at once.
    assert bad.count("collective") == 3
    n = bad[-1].split()[-1]
    assert bad[-3].startswith("replay")
    assert bad[-2:] == [f"begin {n}", f"end {n}"]
    assert scan._open is None and scan._segments is None
    _build.reset_launches()
