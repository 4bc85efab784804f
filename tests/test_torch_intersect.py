"""The port's closest and any hit held against the JAX package's Pallas
traversal (``closest_pallas`` / ``any_pallas``, interpret mode) on the same
rays: ``arch:2000`` takes the planned path (10 tiles), ``synthetic:2000`` the
small path (4 tiles: ``_closest_small_kernel`` / ``_any_small_kernel``, and
the port's small sweep).

Tolerances: the JAX kernel in interpret mode takes its reciprocal in
bfloat16 and refines it with one Newton step, where the port divides
exactly, so swept t values differ in the 16th bit and winners at a
truncated-key near tie may flip: ``tri`` agrees on all but 0.1 % of rays.
After the epilogue's exact Moller-Trumbore recompute, t, position and
normal agree to rtol 1e-5 wherever the winner agrees.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx.accel.bvh import build_bvh
from ptx.kernels import intersect as jintersect
from ptx.kernels import intersect_pallas as kp
from ptx.scene.arch import load_arch
from ptx.scene.flatten import FlatScene as jflat
from ptx.scene.synthetic import load_synthetic
from ptx_torch.kernels import _build, intersect, intersect_cuda, sorting, tiles
from ptx_torch.scene.bridge import to_device
from ptx_torch.scene.camera import generate_rays
from _torch_port import port_flat, port_scene

MAX_FLIP_SHARE = 1e-3


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _scene(spec):
    if spec.startswith("arch"):
        fs, static = build_bvh(*load_arch(spec))
    else:
        fs, static = load_synthetic(spec)
    fs, static = port_scene(fs, static)
    fs = tiles.attach_tiles(fs)
    jfs = jflat(**{k: jnp.asarray(v) for k, v in fs._asdict().items()})
    return fs, jfs, to_device(fs, "cpu"), static


def _rays(fs_t, static, kind):
    if kind == "camera":
        pix = torch.arange(1024, dtype=torch.int32)
        orig, dirn = generate_rays(fs_t, pix, pix % 2, 32, 32)
        return orig.contiguous(), dirn
    rng = np.random.default_rng(0)
    n = 1000
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = _t(rng.random(n) < 0.75)
    return sorting.park(_t(orig), _t(d), keep, static)


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_sweep(rays, ptiles, pboxes, any_mode):
    kernel = kp._any_kernel if any_mode else kp._closest_kernel
    r_pad = rays.shape[0]
    shapes = ([jax.ShapeDtypeStruct((r_pad, 1), jnp.int32)] if any_mode else
              [jax.ShapeDtypeStruct((r_pad, 1), jnp.float32),
               jax.ShapeDtypeStruct((r_pad, 1), jnp.int32)])
    return kp._grid_call(kernel, rays, ptiles, pboxes, shapes, True)


_jax_closest = jax.jit(functools.partial(kp.closest_pallas, interpret=True))
_jax_any = jax.jit(functools.partial(kp.any_pallas, interpret=True))

CASES = [(s, k) for s in ("arch:2000", "synthetic:2000")
         for k in ("camera", "scattered")]


@pytest.mark.parametrize("spec,kind", CASES)
def test_closest_matches_pallas(spec, kind):
    fs, jfs, fs_t, static = _scene(spec)
    orig, dirn = _rays(fs_t, static, kind)
    r = orig.shape[0]

    # Kernel level: the swept winner of the sweep the traversal runs.
    rays, _ = tiles._pack_rays(orig, dirn)
    if fs_t.ptiles.shape[0] <= tiles.SMALL_TILES:
        t_trunc, tri = intersect_cuda.closest_small(rays, fs_t.ptiles)
    else:
        plan = intersect_cuda._plan(rays, fs_t.pboxes)
        t_trunc, tri = intersect_cuda.closest_sweep(*plan, rays, fs_t.ptiles)
    ref_t, ref_tri = (np.asarray(x)[:, 0] for x in _jax_sweep(
        jnp.asarray(rays.numpy()), jfs.ptiles, jfs.pboxes, False))
    hit = t_trunc.numpy() < tiles.HIT_T
    np.testing.assert_array_equal(hit, ref_t < tiles.HIT_T)
    same = (tri.numpy() == ref_tri) | ~hit
    assert (~same).mean() <= MAX_FLIP_SHARE

    # After the epilogue.
    h = intersect_cuda.closest(fs_t, orig, dirn)
    ref = _jax_closest(jfs, jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy()))
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(ref.hit))
    m = h.hit.numpy() & same[:r]
    assert m.mean() > 0.02
    # Absolute floors for components that cross zero: a unit normal's
    # scale is 1 and a position's is the scene's extent.
    extent = float(np.abs(np.asarray([static.aabb_lo, static.aabb_hi])).max())
    for name, atol in (("t", 0.0), ("position", 1e-5 * extent), ("normal", 1e-5)):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(ref, name))[m],
                                   rtol=1e-5, atol=atol, err_msg=name)
    np.testing.assert_array_equal(h.mat_id.numpy()[m], np.asarray(ref.mat_id)[m])


@pytest.mark.parametrize("spec,kind", CASES)
def test_any_matches_pallas(spec, kind):
    fs, jfs, fs_t, static = _scene(spec)
    orig, dirn = _rays(fs_t, static, kind)
    got = intersect_cuda.any_hit(fs_t, orig, dirn)
    ref = _jax_any(jfs, jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy()))
    assert got.dtype == torch.bool and got.shape == (orig.shape[0],)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sweep_wrappers_run_plain_on_cpu():
    fs, _, fs_t, static = _scene("arch:2000")
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, "scattered"))
    plan = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    _build.reset_launches()
    t, tri = intersect_cuda.closest_sweep(*plan, rays, fs_t.ptiles)
    hit = intersect_cuda.any_sweep(*plan, rays, fs_t.ptiles)
    assert set(_build.LAUNCHES.values()) == {0}
    t_p, tri_p = intersect_cuda._sweep(*plan, rays, fs_t.ptiles, any_mode=False)
    assert torch.equal(t, t_p) and torch.equal(tri, tri_p)
    assert torch.equal(hit, intersect_cuda._sweep(*plan, rays, fs_t.ptiles, True))
    # Every ray with a closest hit is occluded, and no other.
    assert torch.equal(hit > 0, t < tiles.HIT_T)


_jax_small = jax.jit(functools.partial(kp._small_call, interpret=True),
                     static_argnums=(0, 3))


@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_small_sweep_matches_pallas(kind):
    """``_small_sweep`` against ``_closest_small_kernel`` /
    ``_any_small_kernel`` on a 4-tile scene, and against the general sweep
    on the identity plan, which must pick the same winners."""
    fs, jfs, fs_t, static = _scene("synthetic:2000")
    assert fs_t.ptiles.shape[0] <= tiles.SMALL_TILES
    rays, r_pad = tiles._pack_rays(*_rays(fs_t, static, kind))
    jr = jnp.asarray(rays.numpy())
    t, tri = intersect_cuda._small_sweep(rays, fs_t.ptiles, any_mode=False)
    hit = intersect_cuda._small_sweep(rays, fs_t.ptiles, any_mode=True)
    ref_t, ref_tri = (np.asarray(x)[:, 0] for x in _jax_small(
        kp._closest_small_kernel, jr, jfs.ptiles,
        (jax.ShapeDtypeStruct((r_pad, 1), jnp.float32),
         jax.ShapeDtypeStruct((r_pad, 1), jnp.int32))))
    ref_hit = np.asarray(_jax_small(
        kp._any_small_kernel, jr, jfs.ptiles,
        (jax.ShapeDtypeStruct((r_pad, 1), jnp.int32),)))[:, 0]
    is_hit = t.numpy() < tiles.HIT_T
    assert 0.05 < is_hit.mean()
    np.testing.assert_array_equal(is_hit, ref_t < tiles.HIT_T)
    same = (tri.numpy() == ref_tri) | ~is_hit
    assert (~same).mean() <= MAX_FLIP_SHARE
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    np.testing.assert_array_equal(hit.numpy() > 0, is_hit)

    plan = tiles.identity_plan(r_pad // tiles.RB, fs_t.ptiles.shape[0], "cpu")
    t_g, tri_g = intersect_cuda._sweep(*plan, rays, fs_t.ptiles, any_mode=False)
    assert torch.equal(t, t_g) and torch.equal(tri, tri_g)
    assert torch.equal(hit, intersect_cuda._sweep(*plan, rays, fs_t.ptiles, True))


@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_small_sweep_duplicated_tile_keeps_the_earlier(kind):
    """A copy of the 4-tile scene whose tile 1 duplicates tile 0: every key
    of tile 1 ties with tile 0's, and the small sweeps keep the earlier
    tile, in the port's wrappers (their plain version here) as in
    ``_closest_small_kernel`` / ``_any_small_kernel`` (interpret mode)."""
    fs, _, fs_t, static = _scene("synthetic:2000")
    ptiles = fs_t.ptiles.clone()
    ptiles[1] = ptiles[0]
    rays, r_pad = tiles._pack_rays(*_rays(fs_t, static, kind))
    jr, jt = jnp.asarray(rays.numpy()), jnp.asarray(ptiles.numpy())
    t, tri = intersect_cuda.closest_small(rays, ptiles)
    hit = intersect_cuda.any_small(rays, ptiles)
    t_p, tri_p = intersect_cuda._small_sweep(rays, ptiles, any_mode=False)
    assert torch.equal(t, t_p) and torch.equal(tri, tri_p)
    assert torch.equal(hit, intersect_cuda._small_sweep(rays, ptiles, True))
    ref_t, ref_tri = (np.asarray(x)[:, 0] for x in _jax_small(
        kp._closest_small_kernel, jr, jt,
        (jax.ShapeDtypeStruct((r_pad, 1), jnp.float32),
         jax.ShapeDtypeStruct((r_pad, 1), jnp.int32))))
    ref_hit = np.asarray(_jax_small(
        kp._any_small_kernel, jr, jt,
        (jax.ShapeDtypeStruct((r_pad, 1), jnp.int32),)))[:, 0]
    is_hit = t.numpy() < tiles.HIT_T
    from_tile0 = (tri.numpy() // tiles.TT == 0) & is_hit
    assert from_tile0.mean() > 0.01
    # No winner lies in the duplicate, in either package.
    assert not ((tri.numpy() // tiles.TT == 1) & is_hit).any()
    assert not ((ref_tri // tiles.TT == 1) & (ref_t < tiles.HIT_T)).any()
    np.testing.assert_array_equal(is_hit, ref_t < tiles.HIT_T)
    same = (tri.numpy() == ref_tri) | ~is_hit
    assert (~same).mean() <= MAX_FLIP_SHARE
    np.testing.assert_array_equal(hit.numpy(), ref_hit)
    # Against the scene without the duplicate: the same hits; a winner in
    # tile 0 there stays; one that was in tile 1 is now tile 0's lane.
    t_o, tri_o = intersect_cuda._small_sweep(rays, fs_t.ptiles, any_mode=False)
    keep = (tri_o // tiles.TT != 1) & (t_o < tiles.HIT_T)
    assert torch.equal(tri[keep], tri_o[keep]) and torch.equal(t[keep], t_o[keep])


def test_small_wrappers_run_plain_on_cpu():
    fs, _, fs_t, static = _scene("synthetic:2000")
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, "scattered"))
    _build.reset_launches()
    t, tri = intersect_cuda.closest_small(rays, fs_t.ptiles)
    hit = intersect_cuda.any_small(rays, fs_t.ptiles)
    assert set(_build.LAUNCHES.values()) == {0}
    t_p, tri_p = intersect_cuda._small_sweep(rays, fs_t.ptiles, any_mode=False)
    assert torch.equal(t, t_p) and torch.equal(tri, tri_p)
    assert torch.equal(hit, intersect_cuda._small_sweep(rays, fs_t.ptiles, True))
    with pytest.raises(ValueError, match="small sweep"):
        intersect_cuda._check_small_args(rays, torch.zeros((5, 16, tiles.TT)))


def test_closest_needs_tiles():
    """A scene without attached tiles gets them packed in the call
    (``tiles.pack_tris``), as in the JAX package: the same hits as with the
    attached tiles."""
    fs, static = load_synthetic("synthetic:2000")
    bare = to_device(port_flat(fs), "cpu")
    assert bare.ptiles.shape[0] == 0
    _, _, fs_t, static = _scene("synthetic:2000")
    orig, dirn = _rays(fs_t, static, "camera")
    got, want = (intersect_cuda.closest(f, orig, dirn) for f in (bare, fs_t))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(intersect_cuda.any_hit(bare, orig, dirn),
                       intersect_cuda.any_hit(fs_t, orig, dirn))


@pytest.mark.parametrize("spec", ["arch:2000", "synthetic:2000"])
def test_brute_matches_jax_brute(spec):
    fs, jfs, fs_t, static = _scene(spec)
    orig, dirn = _rays(fs_t, static, "scattered")
    jo, jd = jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy())
    ref = jintersect.brute_closest(jfs, jo, jd)
    got = intersect.brute_closest(fs_t, orig, dirn)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    m = got[4].numpy() & (got[1].numpy() == np.asarray(ref[1]))
    assert m.mean() >= got[4].numpy().mean() - MAX_FLIP_SHARE
    np.testing.assert_allclose(got[0].numpy()[m], np.asarray(ref[0])[m], rtol=1e-5)
    np.testing.assert_array_equal(intersect.brute_any(fs_t, orig, dirn).numpy(),
                                  np.asarray(jintersect.brute_any(jfs, jo, jd)))


# --------------------------------------------------------------------------
# The planned sweeps' argument checks (csrc/tile_sweep.cu runs only on the
# card; the checks its wrappers make before a launch are Python and run here)
# --------------------------------------------------------------------------


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte line."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case,error,match", [
    ("order dtype", TypeError, "order"),
    ("count shape", ValueError, "count"),
    ("near shape", ValueError, "near"),
    ("rays not contiguous", ValueError, "rays: not contiguous"),
    ("rays misaligned", ValueError, "rays: not 16-byte aligned"),
    ("tiles misaligned", ValueError, "tiles: not 16-byte aligned"),
    ("tiles shape", ValueError, "tiles: shape"),
])
def test_sweep_args_are_checked(case, error, match):
    fs, _, fs_t, static = _scene("arch:2000")
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, "scattered"))
    order, count, near = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    ptiles = fs_t.ptiles
    assert intersect_cuda._check_sweep_args(order, count, near, rays, ptiles) == (
        rays.shape[0] // tiles.RB, ptiles.shape[0])
    args = dict(order=order, count=count, near=near, rays=rays, tiles=ptiles)
    if case == "order dtype":
        args["order"] = order.long()
    elif case == "count shape":
        args["count"] = count[:-1]
    elif case == "near shape":
        args["near"] = near[:, :-1].contiguous()
    elif case == "rays not contiguous":
        args["rays"] = rays.t().contiguous().t()
    elif case == "rays misaligned":
        args["rays"] = _misaligned(rays)
    elif case == "tiles misaligned":
        args["tiles"] = _misaligned(ptiles)
    else:
        args["tiles"] = ptiles[:, :12].contiguous()
    with pytest.raises(error, match=match):
        intersect_cuda._check_sweep_args(**args)
