"""The device scan (``ptx_torch.diff.graphs.DeviceScan``) on the CPU, where
it runs its schedule without capture (static buffers, the live count read
one iteration late, the all-dead step past the end, one backward per
step), against the host scan (``wavefront.make_integrator(...,
differentiable=True)``) on the same backend: the value and every gradient
bit for bit through ``inverse.slice_value_and_grad_fn`` (the body of
``make_batch_value_and_grad_fn``), on ``arch:2000`` with the tile
traversal's plain versions.  The JAX package's ``ptx.diff.inverse`` holds
the host scan (``tests/test_torch_inverse.py``, which also runs one case
through the device scan).  The routes to each scan are checked without a
card.
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
import _torch_port  # noqa: F401  (one torch thread per test process)

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
    """The device scan on a CUDA device (built without touching one), the
    host scan on the CPU and wherever the step holds collectives: a
    ``live_sync`` or a tp rank's exchanges."""
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
    assert not isinstance(inverse.make_diff_integrator(
        static, cfg, *pair, MATERIALS, "cuda", live_sync=lambda n: n),
        graphs.DeviceScan)
    dp = Plan(dp=2, tp=1, scene_sharded=False)
    assert isinstance(dist.diff_integrator(static, cfg, None, dp, "reduce",
                                           MATERIALS, "cuda"),
                      graphs.DeviceScan)
    tp = Plan(dp=1, tp=2, scene_sharded=True)
    static_tp = dataclasses.replace(static, shard_local=True)
    mesh = types.SimpleNamespace(plan=tp, tp_group=None, tp_index=0)
    for comm in ("reduce", "ring"):
        assert not isinstance(dist.diff_integrator(
            static_tp, cfg, mesh, tp, comm, MATERIALS, "cuda"),
            graphs.DeviceScan)
