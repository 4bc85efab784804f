"""Inverse rendering in the port (``ptx_torch.diff.inverse``) held against
the JAX package's (``ptx.diff.inverse``) on the same numpy inputs, on the
CPU: ``arch:2000`` (10 tiles, sun) at 16x16, 2 spp, 3 bounces with
``intersector="pallas"`` (JAX: the Pallas kernels in interpret mode; the
port: the kernels' plain versions), and the cases of ``tests/test_diff.py``
rebuilt on in-repo scenes.

Tolerances: the loss within 1e-4 relative, each gradient within 1e-3
relative L2 (float32 on both sides; XLA and torch differ by ulps in cos,
sqrt and pow).  A Monte Carlo decision flipped by one ulp changes a pixel
wholly; such pixels (forward radiance apart by more than 1e-4) would be
left out of the comparison by giving them each side's own radiance as the
target, and are counted (at most 1 % of the frame, the bound of
``tests/test_torch_render.py``).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx.config import RenderConfig as JConfig
from ptx.diff import inverse as jinverse
from ptx_torch import bench, render
from ptx_torch.config import RenderConfig
from ptx_torch.diff import inverse
from ptx_torch.kernels import intersect_cuda, tiles
from ptx_torch.scene.bridge import to_device, to_host
from ptx_torch.scene.camera import generate_rays
from _torch_port import jax_params, port_config, port_params, port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "arch:2000"
JCFG = JConfig(width=16, height=16, samples=2, bounces=3, intersector="pallas")
MATERIAL_FIELDS = ("mat_albedo", "mat_emissive", "mat_roughness", "sun_energy")
# One torch thread here and in every process these tests start: torch's
# thread pool spins, and beside the other test workers it multiplies the
# run time.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    """``(jax fs, jax static, port fs, port static)`` of ``arch:2000``,
    BVH-ordered with tiles attached, on the CPU."""
    jfs, jstatic = jrender.load_scene(SCENE, device=False)
    jfs, jstatic = jrender.ensure_accel(jfs, jstatic, JCFG, device=True)
    fs, static = port_scene(jfs, jstatic)
    fs, static = render.ensure_accel(fs, static, port_config(JCFG), device="cpu")
    return jfs, jstatic, fs, static


def _jax_vg(jfs, jstatic, target, fields):
    vg = jinverse.make_batch_value_and_grad_fn(
        jstatic, JCFG, jnp.asarray(target), JCFG.samples, param_fields=fields)
    value, grads = jax.jit(vg)({f: getattr(jfs, f) for f in fields}, jfs)
    return float(value), {f: np.asarray(g) for f, g in grads.items()}


@pytest.fixture(scope="module")
def jax_reference(scenes):
    """A seeded target, the JAX package's forward image, and its value and
    gradients for the material and sun fields and for ``tri_a``."""
    jfs, jstatic, _, _ = scenes
    target = np.random.default_rng(11).uniform(0, 1, (256, 3)).astype(np.float32)
    color = np.asarray(jrender.render(jfs, jstatic, JCFG).color).reshape(-1, 3)
    return target, color, {fields: _jax_vg(jfs, jstatic, target, fields)
                           for fields in (MATERIAL_FIELDS, ("tri_a",))}


@pytest.mark.parametrize("fields", [MATERIAL_FIELDS, ("tri_a",)],
                         ids=["materials", "tri_a"])
def test_value_and_grad_match_jax(fields, scenes, jax_reference):
    _check_value_and_grad_against_jax(fields, scenes, jax_reference)


def test_value_and_grad_match_jax_through_the_device_scan(
        scenes, jax_reference, monkeypatch):
    """The material case on the device scan (``diff.graphs.DeviceScan``,
    the card's route; on the CPU without capture), same tolerances."""
    from ptx_torch.diff import graphs

    monkeypatch.setattr(inverse, "takes_device_scan", lambda *a, **k: True)
    made = []
    init = graphs.DeviceScan.__init__
    monkeypatch.setattr(graphs.DeviceScan, "__init__",
                        lambda self, *a, **k: (made.append(self),
                                               init(self, *a, **k))[1])
    _check_value_and_grad_against_jax(MATERIAL_FIELDS, scenes, jax_reference)
    assert len(made) == 1 and made[0].schedule()["steps"] > 0


def _check_value_and_grad_against_jax(fields, scenes, jax_reference):
    jfs, jstatic, fs, static = scenes
    target, jcolor, ref = jax_reference
    cfg = port_config(JCFG)
    color = render.render(fs, static, cfg, device="cpu").color.reshape(-1, 3)
    flipped = np.abs(color - jcolor).max(-1) > 1e-4
    print(f"{int(flipped.sum())} of {flipped.size} pixels left out")
    assert flipped.mean() <= 0.01
    value_j, grads_j = ref[fields]
    target_p = target
    if flipped.any():
        keep = ~flipped[:, None]
        value_j, grads_j = _jax_vg(jfs, jstatic, np.where(keep, target, jcolor),
                                   fields)
        target_p = np.where(keep, target, color)
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, torch.as_tensor(target_p), cfg.samples, param_fields=fields)
    value, grads = vg(port_params({f: getattr(jfs, f) for f in fields}), fs)
    np.testing.assert_allclose(float(value), value_j, rtol=1e-4)
    for f in fields:
        want, got = grads_j[f], grads[f].numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0, f
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-3, f"{f}: relative L2 error {err:.3g}"


def test_params_carry_across():
    p = {"mat_albedo": np.arange(12, dtype=np.float32).reshape(4, 3),
         "sun_energy": np.ones(3, np.float32)}
    t = port_params({k: jnp.asarray(v) for k, v in p.items()})
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               for x in t.values())
    back = jax_params(t)
    for k, v in p.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)


# --------------------------------------------------------------------------
# Finite differences (tests/test_diff.py:30-75)
# --------------------------------------------------------------------------

# bounces=2 keeps Russian roulette off (it starts below bounces - 2), so the
# loss is smooth in the material parameters and central differences match.
FD_CFG = RenderConfig(width=16, height=16, samples=1, bounces=2,
                      intersector="pallas")


@pytest.mark.parametrize("field,entries,fill", [
    ("mat_albedo", [(0, 0), (1, 1), (2, 2), (3, 0)], 0.0),
    ("mat_emissive", [(0, 0), (1, 1)], 0.5),
])
def test_grad_matches_finite_difference(field, entries, fill, scenes):
    _, _, fs, static = scenes
    target = torch.full((256, 3), fill)
    loss_fn = inverse.make_loss_fn(static, FD_CFG, target, (field,))
    value = getattr(fs, field)
    p = {field: value.clone().requires_grad_(True)}
    (grad,) = torch.autograd.grad(loss_fn(p, fs, 0), [p[field]])
    eps = 1e-3
    with torch.no_grad():
        for mi, ci in entries:
            delta = torch.zeros_like(value)
            delta[mi, ci] = eps
            lp = loss_fn({field: value + delta}, fs, 0)
            lm = loss_fn({field: value - delta}, fs, 0)
            fd = float((lp - lm) / (2 * eps))
            assert abs(float(grad[mi, ci])) > 1e-6, (mi, ci)
            np.testing.assert_allclose(float(grad[mi, ci]), fd, rtol=2e-2, atol=1e-6)


# --------------------------------------------------------------------------
# Chunking (tests/test_diff.py:292-390)
# --------------------------------------------------------------------------


def _value_and_grad(loss_fn, params, *args):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss_fn(leaves, *args)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("fields", [("mat_albedo",), ("tri_a",)])
def test_chunked_value_and_grad_matches_unchunked(fields, scenes):
    """The chunked value and gradient (64-pixel chunks of 2 fused samples)
    and the one-chunk case equal autograd through ``make_batch_loss_fn``
    (sum then scale against a mean: float32 reassociation)."""
    _, _, fs, static = scenes
    cfg = port_config(JCFG)
    target = torch.as_tensor(
        np.random.default_rng(3).uniform(0, 1, (256, 3)).astype(np.float32))
    params = {f: getattr(fs, f) for f in fields}
    ref = inverse.make_batch_loss_fn(static, cfg, target, cfg.samples,
                                     param_fields=fields)
    v_ref, g_ref = _value_and_grad(ref, params, fs)
    for cap, rtol in ((128, 1e-5), (None, 1e-6)):
        vg = inverse.make_batch_value_and_grad_fn(
            static, cfg, target, cfg.samples, param_fields=fields,
            max_chunk_rays=cap)
        v, g = vg(params, fs)
        np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-6)
        for f in fields:
            np.testing.assert_allclose(g[f].numpy(), g_ref[f].numpy(),
                                       rtol=rtol, atol=1e-7)


def test_chunked_vjp_sample_groups_checkpoint(scenes):
    """A cap of 2 rays over 4 samples: groups of 2 samples per one-pixel
    chunk, each group checkpointed; the objective stays the MSE of the
    4-sample mean."""
    _, _, fs, static = scenes
    cfg = RenderConfig(width=8, height=4, samples=4, bounces=2,
                       intersector="pallas")
    target = torch.zeros((32, 3))
    params = {"mat_albedo": fs.mat_albedo}
    ref = inverse.make_batch_loss_fn(static, cfg, target, cfg.samples,
                                     param_fields=("mat_albedo",))
    v_ref, g_ref = _value_and_grad(ref, params, fs)
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=("mat_albedo",),
        max_chunk_rays=2)
    v, g = vg(params, fs)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(g["mat_albedo"].numpy(),
                               g_ref["mat_albedo"].numpy(), rtol=1e-5, atol=1e-7)


def _without_tiles(fs):
    return fs._replace(ptiles=torch.zeros((0, 16, 1)), pboxes=torch.zeros((0, 8)))


def test_chunked_vg_hoisted_tile_repack(scenes):
    """Geometry parameters and attached tiles: one pack per call from the
    detached parameters; the value and gradients equal those of the scene
    without attached tiles (packed in every call)."""
    _, _, fs, static = scenes
    cfg = port_config(JCFG)
    params = {"tri_a": fs.tri_a + torch.tensor([0.05, 0.0, 0.0])}
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, torch.zeros((256, 3)), cfg.samples, param_fields=("tri_a",),
        max_chunk_rays=128)
    v_acc, g_acc = vg(params, fs)
    v_ref, g_ref = vg(params, _without_tiles(fs))
    np.testing.assert_allclose(float(v_acc), float(v_ref), rtol=1e-6)
    np.testing.assert_allclose(g_acc["tri_a"].numpy(), g_ref["tri_a"].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert float(g_acc["tri_a"].abs().max()) > 0


# --------------------------------------------------------------------------
# inject_params (tests/test_diff.py:248-290)
# --------------------------------------------------------------------------


def test_inject_geometry_drops_tiles_and_repacks(scenes):
    """Geometry parameters drop the attached tiles (they bake the old
    vertices); the traversal's in-call device pack then equals
    ``attach_tiles`` of the moved scene, and so do its hits."""
    _, _, fs, _ = scenes
    assert fs.ptiles.shape[0] > 0
    params = {"tri_a": fs.tri_a + torch.tensor([0.0, 0.0, 1.5])}
    fs_inj = inverse.inject_params(fs, params)
    assert fs_inj.ptiles.shape[0] == 0 and fs_inj.pboxes.shape[0] == 0
    np.testing.assert_array_equal(fs_inj.tri_attrs[:, 25:28].numpy(),
                                  params["tri_a"].numpy())
    moved = to_device(tiles.attach_tiles(to_host(fs_inj)), "cpu")
    packed = tiles.pack_tris(fs_inj)
    assert torch.equal(packed[0], moved.ptiles) and torch.equal(packed[1], moved.pboxes)

    pix = torch.arange(1024, dtype=torch.int32)
    orig, dirn = generate_rays(fs, pix, torch.zeros_like(pix), 32, 32)
    got = intersect_cuda.closest(fs_inj, orig, dirn)
    want = intersect_cuda.closest(moved, orig, dirn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    still = intersect_cuda.closest(fs, orig, dirn)
    assert not torch.equal(still.t, got.t)  # the move is real
    # keep_tiles keeps them; materials go into mat_packed.
    assert inverse.inject_params(fs, params, keep_tiles=True).ptiles is fs.ptiles
    albedo = torch.full_like(fs.mat_albedo, 0.25)
    fs_m = inverse.inject_params(fs, {"mat_albedo": albedo})
    assert torch.equal(fs_m.mat_packed[:, 0:3], albedo)
    assert torch.equal(fs_m.mat_packed[:, 3:], fs.mat_packed[:, 3:])


# --------------------------------------------------------------------------
# optimize against the JAX package's
# --------------------------------------------------------------------------


def test_optimize_matches_jax(scenes):
    """Three Adam steps from the demo's initial albedo and sun energy
    (16x8, 1 spp, 2 bounces, brute): the loss history within 1e-4 relative
    and the parameters within 1e-5 of the JAX package's (optax and torch
    Adam round differently in the last place; the update is a ratio of
    moments, so gradients an ulp apart give updates an ulp apart)."""
    jfs, jstatic, fs, static = scenes
    fields = ("mat_albedo", "sun_energy")
    jcfg = JConfig(width=16, height=8, samples=1, bounces=2, intersector="brute")
    cfg = port_config(jcfg)
    sample_fn = jrender.make_sample_fn(jstatic, jcfg)
    target = np.asarray(sample_fn(jfs, jnp.int32(0))[0])
    jinit = {f: jinverse._DEMO_INITS[f][0](jfs) for f in fields}
    clip = {f: jinverse._DEMO_INITS[f][1] for f in fields}
    jp, jhist = jinverse.optimize(jfs, jstatic, jcfg, jnp.asarray(target), jinit,
                                  steps=3, lr=0.05, param_clip=clip)
    init = {f: inverse._DEMO_INITS[f][0](fs) for f in fields}
    for f in fields:
        np.testing.assert_array_equal(init[f].numpy(), np.asarray(jinit[f]))
    p, hist = inverse.optimize(fs, static, cfg, torch.as_tensor(target), init,
                               steps=3, lr=0.05, param_clip=clip)
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert hist[-1] < hist[0]
    for f in fields:
        np.testing.assert_allclose(p[f].numpy(), np.asarray(jp[f]), atol=1e-5)


# --------------------------------------------------------------------------
# The command line
# --------------------------------------------------------------------------


def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", *args], capture_output=True,
        text=True, timeout=300, cwd=ROOT, env={**os.environ, **ONE_THREAD})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("params", ["mat_albedo,sun_energy", "tri_a"])
def test_invert_cli(params):
    """``invert --device cpu`` runs to its end and reports each field's
    error; with materials the loss goes down (tests/test_diff.py:211,433)."""
    text = _cli("invert", "--scene", SCENE, "--width", "16", "--height", "8",
                "--samples", "1", "--bounces", "2", "--steps", "3", "--lr",
                "0.05", "--intersector", "pallas", "--params", params,
                "--device", "cpu")
    losses = [float(m) for m in re.findall(r"loss ([0-9.eE+-]+)", text)]
    assert len(losses) == 2 and all(np.isfinite(losses)), text
    for f in params.split(","):
        assert f"{f} MAE" in text
    if params != "tri_a":
        assert losses[-1] < losses[0]


def test_invert_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inverse.run_inverse_demo(SCENE, RenderConfig(width=16, height=8), steps=1)
    with pytest.raises(ValueError, match="no demo init"):
        inverse.run_inverse_demo(SCENE, RenderConfig(), param_fields=("tri_e1",))


def test_bench_backward_rows_on_the_cpu():
    """The backward rows at a tiny size, called and through ``bench
    --backward``: both rows in grad-paths/s."""
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2,
                       intersector="pallas")
    rows = bench.run_backward_benches(SCENE, cfg, "cpu", reps=1)
    assert [r["metric"] for r in rows.values()] == ["custom_backward",
                                                     "custom_vertex_backward"]
    import json

    doc = json.loads(_cli("bench", "--backward", "--scene", SCENE, "--width",
                          "16", "--height", "16", "--samples", "2", "--bounces",
                          "2", "--device", "cpu").strip().splitlines()[-1])
    for rows in (rows, doc):
        assert list(rows) == ["backward", "vertex_backward"]
        for row in rows.values():
            assert row["unit"] == "grad-paths/s" and row["value"] > 0
            assert row["card"] == "cpu" and row["max_memory_allocated"] is None
    assert doc["vertex_backward"]["metric"] == "custom_vertex_backward"


def test_chip_smoke_differentiable_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 10 at a tiny size on the CPU, where the
    wrappers run their plain versions: the general scan against the fast
    path, ``tri_a`` split and unsplit and against the brute sweep, the Adam
    steps and the backward rows at that size all pass their checks."""
    import chip_smoke

    rows = chip_smoke.check_diff(
        torch.device("cpu"), scene=SCENE,
        shape=dict(width=16, height=16, samples=2, bounces=3),
        small=dict(width=16, height=8, samples=1, bounces=3))
    assert [r["unit"] for r in rows.values()] == ["grad-paths/s"] * 2
