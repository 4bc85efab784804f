"""The port's differentiable integrators (``ptx_torch.diff.fast``,
``wavefront.make_integrator(differentiable=True)``) on the CPU, where the
kernel wrappers run their plain versions: the cases of
``tests/test_fast_diff.py`` and ``tests/test_diff.py`` rebuilt on in-repo
scenes, and the pieces the slice adds (the routing of the loss functions,
the sorting wrapper, the brute backend's winner recompute, the detached
sampling).

Tolerances, as in the JAX package's tests: the fast path's primal runs the
fused schedule, whose rounding differs from the plain shade stage's
(rtol 1e-4, atol 1e-5); its gradients replay the plain shade stage at the
recorded hits (rtol 1e-5, atol 1e-7).  Against the JAX package's fast path
(float32 on both sides, other libm), each gradient within 1e-3 relative L2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx.config import RenderConfig as JConfig
from ptx.diff import fast as jfast
from ptx.diff import inverse as jinverse
from ptx.scene.flatten import flatten
from ptx.scene.gltf import SunData
from ptx.scene.synthetic import make_textured_quads
from ptx_torch import render
from ptx_torch.config import RenderConfig
from ptx_torch.diff.fast import FAST_SAFE_FIELDS, make_fast_diff_integrator
from ptx_torch.diff.inverse import inject_params, make_loss_fn
from ptx_torch.geometry import moller_trumbore
from ptx_torch.integrator.wavefront import make_integrator
from ptx_torch.kernels import intersect_cuda, sorting
from ptx_torch.kernels.intersect import brute_closest, make_brute
from ptx_torch.scene.bridge import to_device
from ptx_torch.scene.camera import generate_rays
from _torch_port import port_config, port_params, port_scene

FIELDS = ("mat_albedo", "mat_emissive", "mat_roughness", "sun_energy",
          "tex_texels")
SMALL = dict(width=16, height=16, samples=1, bounces=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sunny_textured():
    """Textured quads lit by a sun: every recorded trace channel (hits, sun
    NEE shadow results, textures) in one scene (numpy arrays)."""
    scene = make_textured_quads(2)
    d = np.array([0.3, 0.8, 0.5], np.float32)
    return flatten(dataclasses.replace(scene, sun=SunData(
        direction=d / np.linalg.norm(d),
        energy=np.array([40.0, 30.0, 20.0], np.float32))))


@pytest.fixture(scope="module")
def textured():
    """``(jax fs, jax static, port fs, port static)`` of the sunny textured
    quads."""
    fs, static = _sunny_textured()
    pfs, pstatic = port_scene(fs, static)
    return jrender.to_device(fs), static, to_device(pfs, "cpu"), pstatic


@pytest.fixture(scope="module")
def arch():
    """``arch:2000`` (10 tiles, sun) BVH-ordered with its tiles: ``(port
    fs, static)`` on the CPU."""
    cfg = RenderConfig(intersector="pallas", **SMALL)
    fs, static = render.load_scene("arch:2000")
    return render.ensure_accel(fs, static, cfg, device="cpu")


def _ids(cfg):
    n = cfg.width * cfg.height
    return torch.arange(n, dtype=torch.int32), torch.zeros((n,), dtype=torch.int32)


def _integrators(static, cfg):
    closest, any_hit = render.get_backend(static, cfg, "cpu")
    return (make_fast_diff_integrator(static, cfg, closest, any_hit),
            make_integrator(static, cfg, closest, any_hit, differentiable=True))


def _grad(integ, fs, field, cfg, target):
    pix, smp = _ids(cfg)
    p = {field: getattr(fs, field).detach().clone().requires_grad_(True)}
    radiance, _ = integ(inject_params(fs, p), pix, smp)
    loss = torch.mean((radiance - target) ** 2)
    if not loss.requires_grad:  # no path from the field to the image
        return torch.zeros_like(p[field])
    (g,) = torch.autograd.grad(loss, [p[field]], allow_unused=True)
    return torch.zeros_like(p[field]) if g is None else g


# --------------------------------------------------------------------------
# The fast path against the general scan (tests/test_fast_diff.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["sunny_textured", "arch"])
def test_fast_primal_matches_general(scene, textured, arch):
    if scene == "arch":
        fs, static = arch
        cfg = RenderConfig(intersector="pallas", **SMALL)
    else:
        _, _, fs, static = textured
        cfg = RenderConfig(intersector="brute", **SMALL)
    assert render.resolve_shader(cfg) == "pallas"  # the fused forward
    fast, slow = _integrators(static, cfg)
    pix, smp = _ids(cfg)
    with torch.no_grad():
        rf, af = fast(fs, pix, smp)
        rs, as_ = slow(fs, pix, smp)
    assert float(rs.abs().max()) > 0
    np.testing.assert_allclose(rf.numpy(), rs.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(af.numpy(), as_.numpy(), atol=1e-6)


@pytest.mark.parametrize("field", FIELDS)
def test_fast_gradients_match_general(field, textured):
    _, _, fs, static = textured
    cfg = RenderConfig(intersector="brute", **SMALL)
    fast, slow = _integrators(static, cfg)
    target = torch.zeros((cfg.width * cfg.height, 3))
    gf = _grad(fast, fs, field, cfg, target)
    gs = _grad(slow, fs, field, cfg, target)
    assert torch.isfinite(gf).all()
    assert float(gs.abs().max()) > 0  # the scene exercises this field
    np.testing.assert_allclose(gf.numpy(), gs.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("field", ["mat_albedo", "sun_energy"])
def test_fast_gradients_match_general_on_the_tile_traversal(field, arch):
    """The fast path's forward through the plan, the sweeps, the shadow-ray
    setup and the shade kernel (plain versions here), behind the sorting
    wrapper the loss functions get."""
    fs, static = arch
    cfg = RenderConfig(intersector="pallas", **SMALL)
    closest, _ = render.get_backend(static, cfg, "cpu")
    assert closest is not intersect_cuda.closest  # the sorting wrapper
    fast, slow = _integrators(static, cfg)
    target = torch.zeros((cfg.width * cfg.height, 3))
    gf = _grad(fast, fs, field, cfg, target)
    gs = _grad(slow, fs, field, cfg, target)
    assert float(gs.abs().max()) > 0
    np.testing.assert_allclose(gf.numpy(), gs.numpy(), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def jax_fast_grads(textured):
    """The JAX package's fast-path value and gradients of every field of
    FIELDS on the sunny textured quads, 16x16, 2 spp, 3 bounces."""
    jfs, static, _, _ = textured
    cfg = JConfig(width=16, height=16, samples=2, bounces=3, intersector="brute")
    target = np.random.default_rng(5).uniform(0, 1, (256, 3)).astype(np.float32)
    vg = jinverse.make_batch_value_and_grad_fn(
        static, cfg, jnp.asarray(target), 2, param_fields=FIELDS)
    value, grads = jax.jit(vg)({f: getattr(jfs, f) for f in FIELDS}, jfs)
    return cfg, target, float(value), {f: np.asarray(g) for f, g in grads.items()}


def test_fast_value_and_gradients_match_jax(textured, jax_fast_grads):
    """Material, sun and texture fields through the port's fast path
    against the JAX package's, on the same numpy inputs."""
    from ptx_torch.diff.inverse import make_batch_value_and_grad_fn

    jfs, _, fs, static = textured
    jcfg, target, jvalue, jgrads = jax_fast_grads
    vg = make_batch_value_and_grad_fn(static, port_config(jcfg),
                                      torch.as_tensor(target), 2,
                                      param_fields=FIELDS)
    value, grads = vg(port_params({f: getattr(jfs, f) for f in FIELDS}), fs)
    np.testing.assert_allclose(float(value), jvalue, rtol=1e-4)
    for f in FIELDS:
        want, got = jgrads[f], grads[f].numpy()
        assert np.abs(want).max() > 0, f
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want), f


# --------------------------------------------------------------------------
# Routing (tests/test_fast_diff.py)
# --------------------------------------------------------------------------


def test_fast_safe_fields_is_shading_only():
    assert not FAST_SAFE_FIELDS & {"tri_a", "tri_e1", "tri_e2", "tri_attrs",
                                   "cam_origin", "cam_basis", "ptiles",
                                   "pboxes", "n0", "uv0"}
    assert FAST_SAFE_FIELDS == jfast.FAST_SAFE_FIELDS


def test_inverse_routes_geometry_to_general_path(arch):
    """``make_loss_fn`` with ``tri_a`` takes the general scan (as every set
    does), whose backward reaches the vertices (nonzero on the sun-lit
    arch); the fast path's recorded hits detach them (exactly zero)."""
    fs, static = arch
    cfg = RenderConfig(intersector="pallas", **SMALL)
    target = torch.zeros((cfg.width * cfg.height, 3))
    loss_fn = make_loss_fn(static, cfg, target, ("tri_a",))
    p = {"tri_a": fs.tri_a.clone().requires_grad_(True)}
    (g,) = torch.autograd.grad(loss_fn(p, fs, 0), [p["tri_a"]])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0

    fast, _ = _integrators(static, cfg)
    gf = _grad(fast, fs, "tri_a", cfg, target)
    assert float(gf.abs().sum()) == 0.0


@pytest.mark.parametrize("field", FIELDS)
def test_inverse_routes_material_sets_to_the_general_scan(field, textured):
    """The loss functions take the general scan for material, light and
    texture fields too (the JAX package takes its fast path there): the
    value and gradient of ``make_loss_fn`` equal the scan's bit for bit."""
    _, _, fs, static = textured
    cfg = RenderConfig(**SMALL)
    pix, smp = _ids(cfg)
    target = torch.full((cfg.width * cfg.height, 3), 0.25)
    _, general = _integrators(static, cfg)
    want = _grad(general, fs, field, cfg, target)
    loss_fn = make_loss_fn(static, cfg, target, (field,))
    p = {field: getattr(fs, field).detach().clone().requires_grad_(True)}
    (got,) = torch.autograd.grad(loss_fn(p, fs, 0), [p[field]])
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# Detached sampling leaves the forward as it was
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shader", ["xla", "pallas"])
def test_detach_leaves_forward_bit_identical(shader, monkeypatch):
    """``arch:2000`` rendered with the detaches of the sampled directions
    and the lobe probability in place, and again with ``detach`` the
    identity (the forward before it had them): the same image, bit for
    bit."""
    cfg = RenderConfig(width=32, height=24, samples=2, bounces=3,
                       intersector="pallas", shader=shader)
    fs, static = render.load_scene("arch:2000")
    got = render.render(fs, static, cfg, device="cpu")
    monkeypatch.setattr(torch.Tensor, "detach", lambda self: self)
    before = render.render(fs, static, cfg, device="cpu")
    np.testing.assert_array_equal(got.color, before.color)
    np.testing.assert_array_equal(got.alpha, before.alpha)
    assert got.color.mean() > 0.01


# --------------------------------------------------------------------------
# The sorting wrapper
# --------------------------------------------------------------------------


def _scattered(static, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(orig, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32))


def test_sorting_backend_equals_unwrapped_on_brute(arch):
    fs, static = arch
    orig, dirn = _scattered(static, 2048, 3)
    closest, any_hit = make_brute()
    s_closest, s_any = sorting.make_sorting_backend(closest, any_hit, static)
    want, got = closest(fs, orig, dirn), s_closest(fs, orig, dirn)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert torch.equal(any_hit(fs, orig, dirn), s_any(fs, orig, dirn))
    assert bool(want.hit.any()) and not bool(want.hit.all())


def test_sorting_backend_on_the_tile_traversal(arch):
    """Sorted rays form other 128-ray blocks, so a block may walk its tiles
    in another order: winners agree except at near ties of the truncated
    key (the allowance of ``tests/test_torch_intersect.py``)."""
    fs, static = arch
    orig, dirn = _scattered(static, 4096, 4)
    closest, any_hit = intersect_cuda.make_backend()
    s_closest, s_any = sorting.make_sorting_backend(closest, any_hit, static)
    want, got = closest(fs, orig, dirn), s_closest(fs, orig, dirn)
    assert torch.equal(want.hit, got.hit)
    same = want.t == got.t
    assert float(same.float().mean()) >= 1 - 1e-3
    np.testing.assert_allclose(got.t[~same].numpy(), want.t[~same].numpy(),
                               rtol=1e-4)
    assert torch.equal(any_hit(fs, orig, dirn), s_any(fs, orig, dirn))


def test_get_backend_wraps_only_where_the_jax_package_does(arch):
    _, static = arch
    jfs, jstatic = jrender.load_scene("arch:2000", device=False)
    for kw in (dict(intersector="pallas"), dict(intersector="brute"),
               dict(intersector="pallas", sort_rays="off"),
               dict(intersector="brute", sort_rays="on")):
        jcfg = JConfig(**SMALL, **kw)
        cfg = port_config(jcfg)
        assert (render.resolve_sort(static, cfg, render.resolve_intersector(
            static, cfg, "cpu"))
            == jrender.resolve_sort(jstatic, jcfg, jcfg.intersector))
    # The forward integrator never takes the wrapper: the chunked loop
    # sorts the wavefront itself, and the rule sorts only where it runs.
    cfg = RenderConfig(intersector="pallas", **SMALL)
    assert render.get_backend(static, cfg, "cpu", sort=False)[0] is intersect_cuda.closest
    assert render.get_backend(static, cfg, "cpu")[0] is not intersect_cuda.closest


# --------------------------------------------------------------------------
# The brute backend's vertex gradient
# --------------------------------------------------------------------------


def _brute_by_gather(fs, orig, dirn, tile=512):
    """The brute sweep as it was before its winner recompute: t and the
    barycentrics gathered from each tile's [R, tile] tests."""
    n, r = fs.tri_a.shape[0], orig.shape[0]
    best_t = torch.full((r,), 3.0e38)
    best_tri = torch.zeros((r,), dtype=torch.int32)
    best_b, best_g = torch.zeros((r,)), torch.zeros((r,))
    for i in range(-(-n // tile)):
        start = min(i * tile, n - tile)
        sl = slice(start, start + tile)
        t, beta, gamma, _ = moller_trumbore(
            orig[:, None, :], dirn[:, None, :],
            fs.tri_a[None, sl], fs.tri_e1[None, sl], fs.tri_e2[None, sl])
        arg = torch.argmin(t, dim=1, keepdim=True)
        tmin = torch.gather(t, 1, arg)[:, 0]
        closer = tmin < best_t
        best_tri = torch.where(closer, start + arg[:, 0].to(torch.int32), best_tri)
        best_b = torch.where(closer, torch.gather(beta, 1, arg)[:, 0], best_b)
        best_g = torch.where(closer, torch.gather(gamma, 1, arg)[:, 0], best_g)
        best_t = torch.minimum(best_t, tmin)
    return best_t, best_tri, best_b, best_g, best_t < 3.0e38


def test_brute_winner_recompute_is_bit_equal(arch):
    """The brute closest hit selects without autograd and recomputes its
    winner's Moller-Trumbore test: t, triangle, barycentrics and hit equal
    the per-tile gathers' bit for bit, and the gradient reaches the
    winners' vertices only."""
    fs, static = arch
    orig, dirn = generate_rays(fs, torch.arange(1024, dtype=torch.int32),
                               torch.zeros(1024, dtype=torch.int32), 32, 32)
    want = _brute_by_gather(fs, orig, dirn)
    tri_a = fs.tri_a.clone().requires_grad_(True)
    got = brute_closest(fs._replace(tri_a=tri_a), orig, dirn)
    for a, b in zip(want, got):
        assert torch.equal(a, b.detach())
    assert bool(want[4].any()) and not bool(want[4].all())
    (g,) = torch.autograd.grad(got[2].sum() + got[3].sum(), [tri_a])
    winners = torch.unique(want[1][want[4]].long())
    assert float(g[winners].abs().sum()) > 0
    rest = torch.ones(g.shape[0], dtype=torch.bool)
    rest[winners] = False
    assert float(g[rest].abs().sum()) == 0.0


def test_split_geom_grad_changes_the_route_not_the_values(arch):
    """``split_geom_grad``: the same hit payload; the vertex gradient
    reaches ``tri_a`` through its own leaf, not through ``tri_attrs``."""
    fs, static = arch
    orig, dirn = generate_rays(fs, torch.arange(1024, dtype=torch.int32),
                               torch.zeros(1024, dtype=torch.int32), 32, 32)
    p = {"tri_a": fs.tri_a.clone().requires_grad_(True)}
    fsp = inject_params(fs, p, keep_tiles=True)
    hits = [intersect_cuda.make_backend(split)[0](fsp, orig, dirn)
            for split in (False, True)]
    for a, b in zip(*hits):
        assert torch.equal(a, b)
    grads = [torch.autograd.grad(h.position.sum(), [p["tri_a"], fsp.tri_attrs],
                                 allow_unused=True, retain_graph=True)
             for h in hits]
    np.testing.assert_allclose(grads[1][0].numpy(), grads[0][0].numpy(), rtol=1e-6)
    assert float(grads[1][0].abs().sum()) > 0
    # Without the split the gradient goes through the [T, 40] rows.
    assert float(grads[0][1].abs().sum()) > 0 and grads[1][1] is None
