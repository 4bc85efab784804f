"""The port's BVH walk (``ptx_torch.accel.traverse``, the plain version of
``csrc/bvh_traverse.cu``) held against the JAX package's
(``ptx.accel.traverse``) on the same rays, each package walking the BVH it
builds from the same scene (the arrays are bit-identical,
``tests/test_torch_host.py``); the ``bvh`` route of ``render``, ``auto`` on
the CPU and its rule on a card, and inverse rendering under ``bvh``.

Tolerances: XLA may contract Moller-Trumbore's products into fused
multiply-adds, and the determinant and the barycentric dot products cancel
on thin triangles (the random soups of ``synthetic:``), so where the
winners agree t agrees to rtol 1e-4 (atol 1e-6) and the barycentrics to
1e-4 absolute (7.2e-5 and 3.4e-5 relative in t seen on
``synthetic:70000``), and a winner may flip at a near tie (at most 0.1 %
of rays, each with both t within 1e-4).  The port's walk equals its own
brute sweep bit for bit where the winners agree (the same torch
Moller-Trumbore), and the CUDA walk equals the plain walk on every output
(``chip_smoke.py``).
``any_hit`` and ``node_visits`` are exact: the slab test has no product to
contract.  Images: the bound of ``tests/test_torch_render.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx.accel import traverse as jtraverse
from ptx.config import RenderConfig
from ptx_torch import geometry
from ptx_torch import render
from ptx_torch.accel import traverse
from ptx_torch.config import RenderConfig as PortConfig
from ptx_torch.diff import inverse
from ptx_torch.kernels import _build, intersect, intersect_cuda, sorting
from ptx_torch.kernels import traverse_cuda
from ptx_torch.parallel import shard_scene
from ptx_torch.scene.camera import generate_rays
from _torch_port import port_config, port_scene
from test_torch_render import _assert_agrees

MAX_FLIP_SHARE = 1e-3
TIE_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _scenes(spec):
    """(the JAX package's scene on the device, the port's on the CPU),
    each with the BVH its own ``ensure_accel`` builds."""
    cfg = RenderConfig(intersector="bvh")
    jfs, jstatic = jrender.ensure_accel(*jrender.load_scene(spec, device=False),
                                        cfg, device=True)
    fs, static = render.ensure_accel(*render.load_scene(spec), port_config(cfg),
                                     device="cpu")
    assert static.n_bvh_nodes == jstatic.n_bvh_nodes > 0
    np.testing.assert_array_equal(fs.bvh_miss.numpy(), np.asarray(jfs.bvh_miss))
    return jfs, fs, static


def _rays(fs, static, kind, n=1024):
    if kind == "camera":
        pix = torch.arange(n, dtype=torch.int32)
        orig, dirn = generate_rays(fs, pix, pix % 2, 32, n // 32)
        return orig.contiguous(), dirn
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # Axis-aligned directions: exact zeros, NaN slabs.
    d[:64] = 0.0
    d[np.arange(64), np.arange(64) % 3] = 1.0 - 2.0 * (np.arange(64) % 2)
    return _t(orig), _t(d)


def _jax_walk(jfs, orig, dirn, leaf_size, max_steps, any_hit=False):
    one = jtraverse._make_traverse(leaf_size, max_steps, any_hit)
    out = jax.vmap(lambda o, d: one(jfs, o, d))(jnp.asarray(orig.numpy()),
                                                jnp.asarray(dirn.numpy()))
    return [np.asarray(x) for x in out]


def _assert_walks_agree(fs, orig, dirn, got, want):
    """Closest walks of the two packages: hit masks equal, winners equal but
    for near ties, t / beta / gamma close where the winners agree."""
    t, tri, beta, gamma, hit = (x.numpy() for x in got)
    jt, jtri, jbeta, jgamma, jhit = want
    np.testing.assert_array_equal(hit, jhit)
    same = (tri == jtri) | ~hit
    assert (~same).mean() <= MAX_FLIP_SHARE
    for r in np.flatnonzero(~same):
        ta = [float(geometry.moller_trumbore(
            orig[r], dirn[r], fs.tri_a[w], fs.tri_e1[w], fs.tri_e2[w])[0])
            for w in (int(tri[r]), int(jtri[r]))]
        assert abs(ta[0] - ta[1]) <= TIE_RTOL * abs(ta[1])
    np.testing.assert_allclose(t[same], jt[same], rtol=1e-4, atol=1e-6)
    assert (t[~hit] == np.float32(geometry.INF)).all()
    np.testing.assert_allclose(beta[same], jbeta[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gamma[same], jgamma[same], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["camera", "scattered"])
@pytest.mark.parametrize("spec", ["arch:2000", "synthetic:70000"])
def test_walk_matches_jax(spec, kind):
    jfs, fs, static = _scenes(spec)
    orig, dirn = _rays(fs, static, kind)
    leaf = static.bvh_leaf_size
    got = traverse.walk(fs, orig, dirn, leaf)
    _assert_walks_agree(fs, orig, dirn, got, _jax_walk(jfs, orig, dirn, leaf, 4096))
    assert got[4].any()
    jany = _jax_walk(jfs, orig, dirn, leaf, 4096, any_hit=True)[4]
    np.testing.assert_array_equal(traverse.walk(fs, orig, dirn, leaf,
                                                any_hit=True)[4].numpy(), jany)
    np.testing.assert_array_equal(got[4].numpy(), jany)
    visits = traverse.node_visits(fs, orig, dirn)
    jvisits = np.asarray(jtraverse.node_visits(
        jfs, jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy())))
    assert visits.dtype == torch.int32
    np.testing.assert_array_equal(visits.numpy(), jvisits)
    assert visits.max() > 8


@pytest.mark.parametrize("max_steps", [1, 7, 40])
def test_max_steps_cap(max_steps):
    """A small per-ray cap cuts every walk at the same node as the JAX
    package's."""
    jfs, fs, static = _scenes("arch:2000")
    orig, dirn = _rays(fs, static, "camera")
    leaf = static.bvh_leaf_size
    got = traverse.walk(fs, orig, dirn, leaf, max_steps)
    _assert_walks_agree(fs, orig, dirn, got,
                        _jax_walk(jfs, orig, dirn, leaf, max_steps))
    full = traverse.walk(fs, orig, dirn, leaf)[4]
    assert got[4].sum() < full.sum()
    np.testing.assert_array_equal(
        traverse.walk(fs, orig, dirn, leaf, max_steps, any_hit=True)[4].numpy(),
        _jax_walk(jfs, orig, dirn, leaf, max_steps, any_hit=True)[4])
    visits = traverse.node_visits(fs, orig, dirn, max_steps)
    assert int(visits.max()) == max_steps
    np.testing.assert_array_equal(visits.numpy(), np.asarray(
        jtraverse.node_visits(jfs, jnp.asarray(orig.numpy()),
                              jnp.asarray(dirn.numpy()), max_steps)))


def test_parked_rays_never_hit():
    """Lanes parked by survivor compaction miss the root box: no hit, one
    node visited."""
    _, fs, static = _scenes("arch:2000")
    orig, dirn = _rays(fs, static, "scattered")
    keep = _t(np.random.default_rng(5).random(orig.shape[0]) < 0.5)
    orig, dirn = sorting.park(orig, dirn, keep, static)
    t, _, _, _, hit = traverse.walk(fs, orig, dirn, static.bvh_leaf_size)
    assert not hit[~keep].any() and hit[keep].any()
    assert (t[~keep] == geometry.INF).all()
    assert not traverse.walk(fs, orig, dirn, static.bvh_leaf_size,
                             any_hit=True)[4][~keep].any()
    assert (traverse.node_visits(fs, orig, dirn)[~keep] == 1).all()


@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_walk_matches_brute(kind):
    """The walk against the port's brute sweep over every triangle: the
    same winners but for near ties, and where they agree the same t, beta
    and gamma bit for bit (the same torch Moller-Trumbore)."""
    _, fs, static = _scenes("synthetic:3000:1" if kind == "camera" else "arch:2000")
    orig, dirn = _rays(fs, static, kind)
    t, tri, beta, gamma, hit = traverse.walk(fs, orig, dirn, static.bvh_leaf_size)
    bt, btri, bbeta, bgamma, bhit = intersect.brute_closest(fs, orig, dirn)
    assert torch.equal(hit, bhit) and hit.any()
    same = (tri == btri) | ~hit
    assert (~same).float().mean() <= MAX_FLIP_SHARE
    for x, y in ((t, bt), (beta, bbeta), (gamma, bgamma)):
        assert torch.equal(x[same], y[same])
    assert torch.equal(traverse.walk(fs, orig, dirn, static.bvh_leaf_size,
                                     any_hit=True)[4],
                       intersect.brute_any(fs, orig, dirn))


def test_wrapper_routes_cpu_to_plain():
    """On CPU tensors the wrappers run the plain walk and launch nothing;
    the fused step's strided shadow-ray columns are accepted."""
    _, fs, static = _scenes("arch:2000")
    orig, dirn = _rays(fs, static, "scattered")
    rows = torch.cat([orig, dirn, torch.zeros((orig.shape[0], 2))], 1)
    _build.reset_launches()
    leaf = static.bvh_leaf_size
    got = traverse_cuda.closest_walk(fs, rows[:, 0:3], rows[:, 3:6], leaf)
    for x, y in zip(got, traverse.walk(fs, orig, dirn, leaf)):
        assert torch.equal(x, y)
    assert torch.equal(traverse_cuda.any_walk(fs, rows[:, 0:3], rows[:, 3:6], leaf),
                       got[4])
    assert torch.equal(traverse_cuda.visits(fs, orig, dirn),
                       traverse.node_visits(fs, orig, dirn))
    h = traverse_cuda.make_backend(leaf)[0](fs, orig, dirn)
    assert torch.equal(h.t, got[0]) and torch.equal(h.hit, got[4])
    assert set(_build.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="several devices"):
        traverse_cuda.visits(fs, orig.to("meta"), dirn.to("meta"))


def test_resolve_auto_and_accel():
    """``auto`` follows the JAX package on the CPU (brute up to 65,536
    padded triangles, else bvh) and takes the walk on CUDA
    (:func:`test_auto_on_cuda`); ``ensure_accel`` builds a BVH for
    ``bvh`` at any size and packs no tiles for it."""
    _, big = render.load_scene("synthetic:70000")
    _, small = render.load_scene("synthetic:3000")
    cfg = PortConfig()
    assert render.resolve_intersector(big, cfg, "cpu") == "bvh"
    assert render.resolve_intersector(big, cfg, "cuda") == "bvh"
    assert render.resolve_intersector(small, cfg, "cpu") == "brute"
    for spec in ("synthetic:70000", "synthetic:3000"):
        jfs, jst = jrender.load_scene(spec, device=False)
        assert jrender.resolve_intersector(jst, RenderConfig()) == \
            render.resolve_intersector(port_scene(jfs, jst)[1], cfg, "cpu")
    fs, st = render.ensure_accel(*render.load_scene("synthetic:500"),
                                 PortConfig(intersector="bvh"))
    assert st.n_bvh_nodes > 0 and fs.ptiles.shape[0] == 0
    with pytest.raises(ValueError, match="ensure_accel"):
        render.get_backend(small, PortConfig(intersector="bvh"), "cpu")


# "auto" on a card: (scene, tp, the differentiable set, the route).  The
# walk above four tiles (arch:2000 is 5,098 triangles, 10 tiles) and at
# four or fewer (synthetic:2000, 2,048 padded triangles: the walk outran
# the small sweeps on the card); the tile traversal for a geometry set at
# any size; a tp rank on its own shard (arch:300000 over 4: 68,276
# triangles, ~134 tiles).
AUTO_ON_CUDA = {
    "above_four_tiles": ("arch:2000", 1, (), "bvh"),
    "four_tiles": ("synthetic:2000", 1, (), "bvh"),
    "geometry_set": ("arch:2000", 1, ("mat_albedo", "tri_a"), "pallas"),
    "material_set": ("arch:2000", 1, ("mat_albedo", "mat_emissive"), "bvh"),
    "tp4_shard": ("arch:300000", 4, (), "bvh"),
}


@pytest.mark.parametrize("case", sorted(AUTO_ON_CUDA))
def test_auto_on_cuda(case):
    """The rule of ``render.resolve_intersector`` on a CUDA device, read
    from the scene and the parameter set; explicit intersectors are taken
    as given, the CPU's rule is the JAX package's, and a geometry set
    under explicit ``bvh`` is still refused."""
    spec, tp, fields, want = AUTO_ON_CUDA[case]
    _, static = render.load_scene(spec)
    cfg = PortConfig()
    if tp > 1:
        # One rank's view, as build_shard_scene judges it.
        n = max(b - a for a, b in shard_scene.shard_ranges(static.n_tris, tp))
        static = dataclasses.replace(static, n_tris=n,
                                     n_tris_padded=-(-n // 256) * 256)
        assert shard_scene._needs_bvh(static, cfg, "cuda")
    assert render.resolve_intersector(static, cfg, "cuda", fields) == want
    assert (want == "bvh") != inverse.moves_geometry(fields)
    assert render.resolve_intersector(static, cfg, "cpu", fields) == (
        "brute" if static.n_tris_padded <= 65536 else "bvh")
    for name in ("brute", "bvh", "pallas"):
        assert render.resolve_intersector(
            static, PortConfig(intersector=name), "cuda", fields) == name
    if inverse.moves_geometry(fields):
        pair = inverse.diff_backend(static, cfg, None, None, fields, "cuda")
        assert pair[0].__module__ == intersect_cuda.__name__
        with pytest.raises(ValueError, match="refit"):
            inverse.diff_backend(static, PortConfig(intersector="bvh"), None,
                                 None, fields, "cuda")


def test_auto_geometry_set_keeps_its_tiles(monkeypatch):
    """On a CUDA-resolved route ``ensure_accel`` packs the tiles for a
    geometry set under "auto" (the tile traversal runs it) and none for a
    material set or a render (the walk), with a BVH for each."""
    monkeypatch.setattr(render, "to_device", lambda fs, device: fs)
    fs, static = render.load_scene("arch:2000")
    for fields, tiles in ((("tri_a",), True), (("tri_e1", "tri_e2"), True),
                          (("mat_albedo",), False), ((), False)):
        got, st = render.ensure_accel(fs, static, PortConfig(), device="cuda",
                                      param_fields=fields)
        assert st.n_bvh_nodes > 0
        assert (got.ptiles.shape[0] > 0) == tiles, fields


BVH_RENDERS = {
    "xla": ("arch:2000", dict(width=32, height=24, samples=2, bounces=3), "xla", "bvh"),
    "pallas": ("arch:2000", dict(width=32, height=24, samples=2, bounces=3),
               "pallas", "bvh"),
    # "auto" resolves to the walk on the CPU above 65,536 padded triangles.
    "auto": ("synthetic:70000", dict(width=32, height=32, samples=1, bounces=2),
             "auto", "auto"),
}


@pytest.mark.parametrize("case", sorted(BVH_RENDERS))
def test_bvh_render_matches_jax(case):
    spec, size, shader, intersector = BVH_RENDERS[case]
    cfg = RenderConfig(intersector=intersector, shader=shader, **size)
    fs, static = jrender.load_scene(spec, device=False)
    pfs, pstatic = port_scene(fs, static)
    assert render.resolve_intersector(pstatic, port_config(cfg), "cpu") == "bvh"
    got = render.render(pfs, pstatic, port_config(cfg), device="cpu")
    ref = jrender.render(fs, static, cfg)
    _assert_agrees(got, ref, cfg)


def test_inverse_under_bvh():
    """Material sets run under ``bvh`` (its gradient equals the brute
    route's but for near-tie pixels, within 1e-3 relative L2); a geometry
    set is refused, naming the stale BVH."""
    cfg = PortConfig(width=16, height=16, samples=1, bounces=2, intersector="bvh")
    fs, static = render.ensure_accel(*render.load_scene("arch:2000"), cfg,
                                     device="cpu")
    target = torch.full((256, 3), 0.3)
    with pytest.raises(ValueError, match="refit"):
        inverse.make_loss_fn(static, cfg, target, param_fields=("tri_a",))
    grads = {}
    for name in ("bvh", "brute"):
        c = dataclasses.replace(cfg, intersector=name)
        loss_fn = inverse.make_loss_fn(static, c, target,
                                       param_fields=("mat_albedo",))
        params = {"mat_albedo": fs.mat_albedo.clone().requires_grad_(True)}
        loss = loss_fn(params, fs, 0)
        (g,) = torch.autograd.grad(loss, [params["mat_albedo"]])
        assert torch.isfinite(loss) and torch.isfinite(g).all()
        grads[name] = g
    assert grads["bvh"].abs().sum() > 0
    rel = (grads["bvh"] - grads["brute"]).norm() / grads["brute"].norm()
    assert float(rel) <= 1e-3
