"""The port's tile pack, gates, plan and ray keys held against the JAX
package (``ptx.kernels.intersect_pallas`` in interpret mode, and
``ptx.kernels.sorting``) on the same numpy inputs.  Everything here is exact:
the pack is the same numpy code, and the gates and keys are the same IEEE
operations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx.accel.bvh import build_bvh
from ptx.kernels import intersect_pallas as kp
from ptx.kernels import sorting as jsorting
from ptx.scene.arch import load_arch
from ptx.scene.synthetic import load_synthetic
from ptx_torch.kernels import _build, intersect_cuda, sorting, tiles
from ptx_torch.scene.bridge import to_device
from ptx_torch.scene.camera import generate_rays
from _torch_port import port_scene


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def arch():
    fs, static = port_scene(*build_bvh(*load_arch("arch:2000")))
    return tiles.attach_tiles(fs), static


def _ray_sets(fs, static):
    """Camera rays (aligned count) and scattered rays from inside the scene,
    a quarter parked (unaligned count)."""
    pix = torch.arange(1024, dtype=torch.int32)
    cam = generate_rays(to_device(fs, "cpu"), pix, pix % 3, 32, 32)
    rng = np.random.default_rng(0)
    n = 1000
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = _t(rng.random(n) < 0.75)
    scat = sorting.park(_t(orig), _t(d), keep, static)
    return [(cam[0].contiguous(), cam[1]), scat]


@pytest.mark.parametrize("spec", ["arch:2000", "synthetic:2000", "synthetic:1700"])
def test_attach_tiles_bit_identical(spec):
    load = load_arch if spec.startswith("arch") else load_synthetic
    fs, static = load(spec)
    if spec.startswith("arch"):
        fs, static = build_bvh(fs, static)
    ref = kp.attach_tiles(fs)
    got = tiles.attach_tiles(port_scene(fs, static)[0])
    assert got.ptiles.dtype == np.float32 and got.ptiles.shape[1:] == (16, tiles.TT)
    np.testing.assert_array_equal(got.ptiles, ref.ptiles)
    np.testing.assert_array_equal(got.pboxes, ref.pboxes)


def _pack_scene(spec):
    """A JAX package scene for the pack.  "crafted": ``synthetic:1700``
    (1,792 triangles: 4 tiles, the last one part padding) with a fifth of
    its triangles invalid and every coordinate drawn from {-0, +0, s},
    s = +1 in even tiles and -1 in odd ones, so that box corners tie at
    zeros of both signs and many triangles are degenerate."""
    if spec == "crafted":
        fs, static = load_synthetic("synthetic:1700")
        rng = np.random.default_rng(3)
        n = fs.tri_a.shape[0]
        s = np.where((np.arange(n) // tiles.TT) % 2 == 0, 1.0, -1.0)[:, None]

        def coords():
            v = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), (n, 3))
            return np.where(v == 1.0, s, v).astype(np.float32)

        return fs._replace(tri_a=coords(), tri_e1=coords(), tri_e2=coords(),
                           tri_valid=rng.random(n) < 0.8), static
    load = load_arch if spec.startswith("arch") else load_synthetic
    fs, static = load(spec)
    if spec.startswith("arch"):
        fs, static = build_bvh(fs, static)
    return fs, static


@pytest.mark.parametrize("spec", ["arch:2000", "synthetic:2000", "synthetic:1700",
                                  "crafted"])
def test_pack_tris_bit_identical(spec):
    """The device pack (``tiles.pack_tris``, here on CPU tensors) equals the
    host pack of both packages (``attach_tiles``) bit for bit.  The JAX
    package's own in-call ``pack_tris`` is XLA's rounding of the same
    formulas (on the CPU it differs from its ``attach_tiles`` by up to a few
    thousand ulps where products cancel): its boxes are equal, its rows
    within rtol 1e-3 / atol 1e-5."""
    fs, static = _pack_scene(spec)
    ref = kp.attach_tiles(fs)
    got_tiles, got_boxes = tiles.pack_tris(to_device(port_scene(fs, static)[0], "cpu"))
    assert got_tiles.dtype == torch.float32 and got_tiles.is_contiguous()
    for got, want in ((got_tiles, ref.ptiles), (got_boxes, ref.pboxes)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    j_tiles, j_boxes = kp.pack_tris(fs._replace(
        **{k: jnp.asarray(getattr(fs, k)) for k in ("tri_a", "tri_e1", "tri_e2",
                                                      "tri_valid")}))
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(j_boxes))
    np.testing.assert_allclose(got_tiles.numpy(), np.asarray(j_tiles), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("spec", ["arch:2000", "synthetic:1700"])
def test_dropped_tiles_are_packed_in_the_call(spec):
    """``closest``, ``any_hit`` and ``any_hit_rows`` on a scene whose tiles
    were dropped (or packed at another TT) equal the same calls with the
    tiles attached: the planned path (arch, 10 tiles) and the small one."""
    fs, static = port_scene(*_pack_scene(spec))
    fs_t = to_device(tiles.attach_tiles(fs), "cpu")
    orig, dirn = _ray_sets(fs_t, static)[1]
    rays, _ = tiles._pack_rays(orig, dirn)
    r = orig.shape[0]
    want_h = intersect_cuda.closest(fs_t, orig, dirn)
    want_a = intersect_cuda.any_hit(fs_t, orig, dirn)
    assert 0 < float(want_a.float().mean()) < 1
    for ptiles in (torch.zeros((0, 16, 1)), fs_t.ptiles[:, :, :256]):
        bare = fs_t._replace(ptiles=ptiles, pboxes=torch.zeros((0, 8)))
        for g, w in zip(intersect_cuda.closest(bare, orig, dirn), want_h):
            assert torch.equal(g, w)
        assert torch.equal(intersect_cuda.any_hit(bare, orig, dirn), want_a)
        assert torch.equal(intersect_cuda.any_hit_rows(bare, rays, r), want_a)


def test_pack_rays_matches(arch):
    fs, static = arch
    for orig, dirn in _ray_sets(fs, static):
        ref, r_pad = kp._pack_rays(jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy()))
        got, got_pad = tiles._pack_rays(orig, dirn)
        assert got_pad == r_pad
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_exact_gate_bit_identical(arch):
    fs, static = arch
    boxes = fs.pboxes
    shares = []
    for orig, dirn in _ray_sets(fs, static):
        rays, _ = tiles._pack_rays(orig, dirn)
        jr, jb = jnp.asarray(rays.numpy()), jnp.asarray(boxes)
        g, n = intersect_cuda._exact_gate(rays, _t(boxes))
        for ref_g, ref_n in (kp._exact_gate(jr, jb),
                             kp._exact_gate_pallas(jr, jb, interpret=True)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(ref_g))
            np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
        shares.append(float(g.float().mean()))
    # The camera sits inside every tile box; scattered rays gate some out.
    assert 0 < min(shares) and max(shares) <= 1 and min(shares) < 1


def test_exact_gate_wrapper_runs_plain_on_cpu(arch):
    """The plan wrapper (the kernel that replaces the exact gate and its
    sort) runs ``sort_plan(_exact_gate(...))`` on CPU tensors, counts no
    launch, and raises on a device it has no kernel for."""
    fs, static = arch
    rays, _ = tiles._pack_rays(*_ray_sets(fs, static)[0])
    _build.reset_launches()
    got = intersect_cuda.exact_plan(rays, _t(fs.pboxes))
    ref = tiles.sort_plan(*intersect_cuda._exact_gate(rays, _t(fs.pboxes)))
    assert _build.LAUNCHES["exact_gate"] == 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert torch.equal(intersect_cuda._plan_tiles(rays, _t(fs.pboxes))[0], got[0])
    with pytest.raises(ValueError):
        intersect_cuda.exact_plan(rays.to("meta"), _t(fs.pboxes).to("meta"))


def _keyed_plan(gated, near):
    """The plan as ``csrc/tile_plan.cu`` writes it from the gate: the key of
    tile t is (bits(near) << 32) | (t << 1) | !gated; a key's slot is its
    rank (the keys below it); the order slots past count repeat the tile at
    rank max(count - 1, 0)."""
    nb, n_tiles = gated.shape
    keys = ((near.view(np.uint32).astype(np.uint64) << np.uint64(32))
            | (np.arange(n_tiles, dtype=np.uint64) << np.uint64(1))
            | (~gated).astype(np.uint64))
    count = gated.sum(1).astype(np.int32)
    order = np.empty((nb, n_tiles), np.int32)
    near_out = np.empty((nb, n_tiles + 1), np.float32)
    near_out[:, n_tiles] = tiles.INF
    for b in range(nb):
        k = keys[b]
        rank = np.zeros(n_tiles, np.int64)
        for c in range(0, n_tiles, 512):  # (keys below k[i]) in chunks
            rank += (k[None, c:c + 512] < k[:, None]).sum(1)
        assert np.array_equal(np.sort(rank), np.arange(n_tiles))
        tile = ((k & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int32)
        near_out[b, rank] = (k >> np.uint64(32)).astype(np.uint32).view(np.float32)
        last = tile[rank == max(count[b] - 1, 0)][0]
        order[b, rank] = np.where(rank < count[b], tile, last)
    return order, count, near_out


@pytest.mark.parametrize("seed,n_tiles,p_gated,palette", [
    (0, 4096, 0.5, "ties"),
    (1, 534, 0.0, "random"),
    (2, 1, 1.0, "ties"),
    (3, 4095, 0.9, "random"),
    (4, 534, 0.3, "ties"),
    (5, 700, 1.0, "random"),
    (6, 1024, 0.9, "ties"),
    (7, 37, 0.3, "random"),
])
def test_keyed_sort_equals_sort_plan(seed, n_tiles, p_gated, palette):
    """The plan kernel's premise: placing the distinct keys (bits(near) << 32)
    | (tile << 1) | !gated at their ranks gives ``sort_plan``'s order, count
    and near (its stable sort), with ties at 0, at 3e38 (ungated tiles, and
    gated ones entered at 3e38) and at +inf, rows with no gated tile, and
    any T up to FRUSTUM_PLAN_TILES."""
    rng = np.random.default_rng(seed)
    nb = 3
    gated = rng.random((nb, n_tiles)) < p_gated
    gated[0] = False  # a block that enters no tile
    if palette == "ties":
        values = np.array([0.0, 0.0, 0.5, 1.0, 7.25, tiles.INF, np.inf], np.float32)
        near = values[rng.integers(0, values.size, (nb, n_tiles))]
    else:
        near = (rng.random((nb, n_tiles)) * 100.0).astype(np.float32)
    near = np.where(gated, near, np.float32(tiles.INF)).astype(np.float32)
    got = _keyed_plan(gated, near)
    ref = tiles.sort_plan(_t(gated), _t(near))
    for g, r in zip(got, ref):
        assert g.dtype == r.numpy().dtype
        np.testing.assert_array_equal(g, r.numpy())


def test_frustum_gate_matches(arch):
    fs, static = arch
    for orig, dirn in _ray_sets(fs, static):
        rays, _ = tiles._pack_rays(orig, dirn)
        ref = kp._frustum_gate(jnp.asarray(rays.numpy()), jnp.asarray(fs.pboxes))
        got = tiles._frustum_gate(rays, _t(fs.pboxes))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _assert_plans_match(got, ref):
    order, count, near = (x.numpy() for x in got)
    r_order, r_count, r_near = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(count, r_count)
    np.testing.assert_array_equal(near, r_near)
    # Tiles at equal entry distance may sort either way: compare the order
    # where a slot's key is distinct from its neighbours'.
    s = near[:, :-1]
    distinct = np.ones_like(s, bool)
    distinct[:, 1:] &= s[:, 1:] != s[:, :-1]
    distinct[:, :-1] &= s[:, :-1] != s[:, 1:]
    live = np.arange(s.shape[1])[None, :] < count[:, None]
    np.testing.assert_array_equal(order[distinct & live], r_order[distinct & live])
    return (distinct & live).mean()


@pytest.mark.parametrize("frustum", [False, True])
def test_plan_tiles_matches(arch, monkeypatch, frustum):
    fs, static = arch
    if frustum:
        monkeypatch.setattr(kp, "FRUSTUM_PLAN_TILES", 0)
        monkeypatch.setattr(intersect_cuda, "FRUSTUM_PLAN_TILES", 0)
    compared = []
    for orig, dirn in _ray_sets(fs, static):
        rays, _ = tiles._pack_rays(orig, dirn)
        ref = kp._plan_tiles(jnp.asarray(rays.numpy()), jnp.asarray(fs.pboxes),
                             interpret=True)
        got = intersect_cuda._plan_tiles(rays, _t(fs.pboxes))
        compared.append(_assert_plans_match(got, ref))
    assert max(compared) > 0.05


def test_ray_keys_and_park_match(arch):
    fs, static = arch
    rng = np.random.default_rng(1)
    n = 2048
    orig = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    dirn[:16, 0] = 0.0
    dirn[16:32, 1] = -0.0
    keep = rng.random(n) < 0.5
    ref = jsorting.ray_keys(orig, dirn, static.aabb_lo, static.aabb_hi)
    got = sorting.ray_keys(_t(orig), _t(dirn), static.aabb_lo, static.aabb_hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref_p = jsorting.park(jnp.asarray(orig), jnp.asarray(dirn), jnp.asarray(keep),
                          static)
    got_p = sorting.park(_t(orig), _t(dirn), _t(keep), static)
    for g, r in zip(got_p, ref_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert sorting.should_compact(static) == jsorting.should_compact(static)


def test_stable_dead_last_sort_matches():
    rng = np.random.default_rng(2)
    key = rng.integers(0, 64, 4096).astype(np.int32)  # many equal keys
    alive = rng.random(4096) < 0.6
    masked = np.where(alive, key, np.int32(1 << 30))
    ref = np.asarray(jax.numpy.argsort(jnp.asarray(masked)))
    got = torch.argsort(_t(masked), stable=True).numpy()
    np.testing.assert_array_equal(got, ref)
