"""The tile traversal: hand-written CUDA kernels and their plain torch
versions (port of the kernels and wrappers of
``ptx/kernels/intersect_pallas.py``).

* :func:`exact_plan` - ``csrc/tile_plan.cu``, plain version
  ``sort_plan(_exact_gate(...))``: the exact per-[ray block x tile] gate
  and its per-block sort, the plan ``(order, count, near)``, in one launch.
* :func:`closest_sweep` / :func:`any_sweep` - ``csrc/tile_sweep.cu``, plain
  version :func:`_sweep`: each block's planned tiles front to back, the
  Baldwin-Weber test and the packed-min key.
* :func:`closest_sweep_stats` - the same kernel's stats instantiation,
  plain version ``_sweep(..., stats=True)``: the closest sweep plus the
  tiles each block tested, for the bench's roofline (:func:`closest_stats`).
* :func:`closest_small` / :func:`any_small` - ``csrc/tile_sweep.cu``, plain
  version :func:`_small_sweep`: scenes of at most SMALL_TILES tiles, every
  block against every tile in tile order, no plan.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (and counts the launch in
``_build.LAUNCHES``) or raises.  :func:`closest` / :func:`any_hit` pick the
small sweep or the planned one and, for the closest hit, run the exact
epilogue: one ``tri_attrs`` row gather, the Moller-Trumbore recompute of
the winner, and ``hit = (t_trunc < HIT_T) & (t_exact < INF)``.  Kernel
outputs carry no gradient; the epilogue does.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch import geometry
from ptx_torch.kernels import _build
from ptx_torch.kernels.intersect import Hit, attrs_from_indices
from ptx_torch.kernels.tiles import (
    FRUSTUM_PLAN_TILES,
    HIT_T,
    INF,
    INIT_KEY,
    LANE_BITS,
    RB,
    SMALL_TILES,
    TT,
    _frustum_gate,
    _pack_rays,
    identity_plan,
    pack_tris,
    sort_plan,
)
from ptx_torch.scene.flatten import FlatScene

# float32(-EPS) and float32(1 + EPS), held as python floats that float32
# represents exactly, so a comparison gives the same answer in any precision.
_NEG_EPS = float(np.float32(-1.0e-4))
_ONE_EPS = float(np.float32(1.0 + 1.0e-4))


# --------------------------------------------------------------------------
# Gate
# --------------------------------------------------------------------------


def _exact_gate(rays, boxes, max_elems: int = 1 << 22):
    """The exact gate (the JAX package's ``_exact_gate``): per-ray slab
    tests reduced to the block level.  Returns ``(gated [B, T] bool,
    near [B, T] float32)``; with :func:`sort_plan`, the plain version of
    ``csrc/tile_plan.cu``.  Runs ``max_elems`` ray-box pairs at a time."""
    nb = rays.shape[0] // RB
    n_tiles = boxes.shape[0]
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    gated = torch.empty((nb, n_tiles), dtype=torch.bool, device=rays.device)
    near = torch.empty((nb, n_tiles), dtype=torch.float32, device=rays.device)
    step = max(1, max_elems // (RB * max(n_tiles, 1)))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        r = rays[b0 * RB:b1 * RB]
        o = r[:, None, 0:3]
        inv_d = 1.0 / r[:, None, 3:6]
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        nan = torch.isnan(t0) | torch.isnan(t1)
        tl = torch.where(nan, float("-inf"), torch.minimum(t0, t1))
        th = torch.where(nan, float("inf"), torch.maximum(t0, t1))
        near_r = tl.amax(-1)  # [n, T]
        far = th.amin(-1)
        enter = torch.where(near_r > 0.0, near_r, 0.0)
        hit = (far >= enter).view(b1 - b0, RB, n_tiles)
        gated[b0:b1] = hit.any(1)
        near[b0:b1] = torch.where(
            hit, enter.view(b1 - b0, RB, n_tiles), INF
        ).amin(1)
    return gated, near


def exact_plan(rays, boxes):
    """The plan ``(order [B, T] int32, count [B] int32, near [B, T+1]
    float32)`` of a scene of at most FRUSTUM_PLAN_TILES tiles: one kernel
    launch for CUDA tensors (counted as ``"exact_gate"``, the kernel it
    replaces), ``sort_plan(_exact_gate(...))`` for CPU tensors."""
    if _build.on_cpu(rays, boxes):
        return sort_plan(*_exact_gate(rays, boxes))
    nb, n_tiles = rays.shape[0] // RB, boxes.shape[0]
    if not 0 < n_tiles <= FRUSTUM_PLAN_TILES:
        raise ValueError(f"{n_tiles} tiles: the exact plan takes "
                         f"1..{FRUSTUM_PLAN_TILES}")
    _build.check(rays, "rays", torch.float32, (nb * RB, 8))
    _build.check(boxes, "boxes", torch.float32, (n_tiles, 8))
    order = torch.empty((nb, n_tiles), dtype=torch.int32, device=rays.device)
    count = torch.empty((nb,), dtype=torch.int32, device=rays.device)
    near = torch.empty((nb, n_tiles + 1), dtype=torch.float32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_tile_plan, rays.data_ptr(),
                      boxes.data_ptr(), nb, n_tiles, order.data_ptr(),
                      count.data_ptr(), near.data_ptr())
        _build.LAUNCHES["exact_gate"] += 1
    return order, count, near


def _plan_tiles(rays, boxes):
    """The block traversal plan ``(order, count, near)`` of
    :func:`ptx_torch.kernels.tiles.sort_plan`: the exact plan up to
    FRUSTUM_PLAN_TILES tiles, the conservative frustum gate and
    :func:`sort_plan` above."""
    if boxes.shape[0] > FRUSTUM_PLAN_TILES:
        return sort_plan(*_frustum_gate(rays, boxes))
    return exact_plan(rays, boxes)


def _plan(rays, boxes):
    """The general sweep's plan for any scene: the identity plan (every
    block, every tile) up to SMALL_TILES tiles.  The traversal itself sends
    such scenes to the small sweep; this plan is what that sweep is checked
    against."""
    nb, n_tiles = rays.shape[0] // RB, boxes.shape[0]
    if n_tiles <= SMALL_TILES:
        return identity_plan(nb, n_tiles, rays.device)
    return _plan_tiles(rays, boxes)


# --------------------------------------------------------------------------
# Sweeps
# --------------------------------------------------------------------------


def _test_matrix(rays, tris):
    """[b, RB, TT] Baldwin-Weber hit distances, INF where no hit.
    ``rays`` [b, RB, 8]; ``tris`` [b, 12, TT] rows of ``tiles._bw_rows``.
    Same operations in the same order as ``csrc/tile_sweep.cu``."""
    ox, oy, oz = rays[..., 0:1], rays[..., 1:2], rays[..., 2:3]
    dx, dy, dz = rays[..., 3:4], rays[..., 4:5], rays[..., 5:6]
    row = [tris[:, i:i + 1, :] for i in range(12)]
    nd = row[0] * dx + row[1] * dy + row[2] * dz
    no = row[0] * ox + row[1] * oy + row[2] * oz + row[3]
    t = -(no * torch.reciprocal(nd))
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    beta = row[4] * px + row[5] * py + row[6] * pz + row[7]
    gamma = row[8] * px + row[9] * py + row[10] * pz + row[11]
    ok = (
        (beta >= _NEG_EPS)
        & (gamma >= _NEG_EPS)
        & (beta <= _ONE_EPS)
        & (beta + gamma <= _ONE_EPS)
        & (t >= 0.0)
    )
    return torch.where(ok, t, INF)


def _sweep(order, count, near, rays, tiles, any_mode: bool,
           stats: bool = False):
    """Plain version of ``csrc/tile_sweep.cu``: all blocks step through
    their plans in lockstep, each block with the kernel's exit rule.
    Returns ``(t_trunc [R_pad] f32, tri [R_pad] i32)`` or, with
    ``any_mode``, ``hit [R_pad] i32``.  ``stats`` adds ``visited [nb] i32``,
    the tiles each block tested (the stats sweep's third output), and in
    ``any_mode`` also ``searched [nb] i64``, the sum over those tiles of the
    block's rays still without a hit (the any sweep's work)."""
    dev = rays.device
    nb = rays.shape[0] // RB
    r = rays.view(nb, RB, 8)
    lane = torch.arange(TT, dtype=torch.int32, device=dev)
    best_key = torch.full((nb, RB), INIT_KEY, dtype=torch.int32, device=dev)
    best_tile = torch.zeros((nb, RB), dtype=torch.int32, device=dev)
    hit = torch.zeros((nb, RB), dtype=torch.bool, device=dev)
    bound = torch.full((nb,), INF, dtype=torch.float32, device=dev)
    visited = torch.zeros((nb,), dtype=torch.int32, device=dev)
    searched = torch.zeros((nb,), dtype=torch.int64, device=dev)
    running = count > 0
    for k in range(int(count.max()) if nb else 0):
        if k > 0:
            running &= hit.all(1).logical_not() if any_mode else near[:, k] < bound
        running &= count > k
        blocks = running.nonzero()[:, 0]
        if blocks.numel() == 0:
            break
        visited[blocks] += 1
        tile = order[blocks, k]
        t = _test_matrix(r[blocks], tiles[tile.long(), 0:12])
        if any_mode:
            searched[blocks] += (~hit[blocks]).sum(1)
            hit[blocks] |= (t < INF).any(-1)
            continue
        key = (t.view(torch.int32) & ~LANE_BITS) | lane
        kmin = key.amin(-1)
        old = best_key[blocks]
        closer = kmin < old
        new_key = torch.where(closer, kmin, old)
        best_key[blocks] = new_key
        best_tile[blocks] = torch.where(closer, tile[:, None], best_tile[blocks])
        bound[blocks] = (new_key & ~LANE_BITS).view(torch.float32).amax(1)
    if any_mode:
        hit = hit.view(-1).to(torch.int32)
        return (hit, visited, searched) if stats else hit
    empty = (count == 0)[:, None]
    t = torch.where(empty, INF, (best_key & ~LANE_BITS).view(torch.float32))
    tri = torch.where(empty, 0, best_tile * TT + (best_key & LANE_BITS))
    if stats:
        return t.view(-1), tri.view(-1), visited
    return t.view(-1), tri.view(-1)


def _check_sweep_args(order, count, near, rays, tiles):
    nb, n_tiles = rays.shape[0] // RB, tiles.shape[0]
    _build.check(order, "order", torch.int32, (nb, n_tiles))
    _build.check(count, "count", torch.int32, (nb,))
    _build.check(near, "near", torch.float32, (nb, n_tiles + 1))
    _build.check(rays, "rays", torch.float32, (nb * RB, 8))
    _build.check(tiles, "tiles", torch.float32, (n_tiles, 16, TT))
    for t, name in ((rays, "rays"), (tiles, "tiles")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    return nb, n_tiles


def closest_sweep(order, count, near, rays, tiles):
    """Closest planned-tile sweep: ``(t_trunc [R_pad], tri [R_pad])``."""
    if _build.on_cpu(order, count, near, rays, tiles):
        return _sweep(order, count, near, rays, tiles, any_mode=False)
    nb, n_tiles = _check_sweep_args(order, count, near, rays, tiles)
    t = torch.empty((nb * RB,), dtype=torch.float32, device=rays.device)
    tri = torch.empty((nb * RB,), dtype=torch.int32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_closest, order.data_ptr(),
                      count.data_ptr(), near.data_ptr(), rays.data_ptr(),
                      tiles.data_ptr(), nb, n_tiles, t.data_ptr(),
                      tri.data_ptr())
        _build.LAUNCHES["closest"] += 1
    return t, tri


def closest_sweep_stats(order, count, near, rays, tiles):
    """The stats sweep (port of ``_closest_stats_kernel``): the closest
    sweep's ``(t_trunc [R_pad], tri [R_pad])`` and ``visited [nb]`` int32,
    the tiles each block tested.  The count is of the port's own exit rule,
    per tile where the Pallas kernel exits per group of 4
    (``csrc/tile_sweep.cu``, ``ptx_closest_stats``)."""
    if _build.on_cpu(order, count, near, rays, tiles):
        return _sweep(order, count, near, rays, tiles, any_mode=False, stats=True)
    nb, n_tiles = _check_sweep_args(order, count, near, rays, tiles)
    t = torch.empty((nb * RB,), dtype=torch.float32, device=rays.device)
    tri = torch.empty((nb * RB,), dtype=torch.int32, device=rays.device)
    visited = torch.empty((nb,), dtype=torch.int32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_closest_stats, order.data_ptr(),
                      count.data_ptr(), near.data_ptr(), rays.data_ptr(),
                      tiles.data_ptr(), nb, n_tiles, t.data_ptr(),
                      tri.data_ptr(), visited.data_ptr())
        _build.LAUNCHES["closest_stats"] += 1
    return t, tri, visited


def any_sweep(order, count, near, rays, tiles):
    """Any-hit planned-tile sweep: ``hit [R_pad]`` int32 (0/1)."""
    if _build.on_cpu(order, count, near, rays, tiles):
        return _sweep(order, count, near, rays, tiles, any_mode=True)
    nb, n_tiles = _check_sweep_args(order, count, near, rays, tiles)
    hit = torch.empty((nb * RB,), dtype=torch.int32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_any, order.data_ptr(),
                      count.data_ptr(), near.data_ptr(), rays.data_ptr(),
                      tiles.data_ptr(), nb, n_tiles, hit.data_ptr())
        _build.LAUNCHES["any"] += 1
    return hit


def _small_sweep(rays, tiles, any_mode: bool):
    """Plain version of the small sweeps of ``csrc/tile_sweep.cu`` (the JAX
    package's ``_closest_small_kernel`` / ``_any_small_kernel``): every
    block against every tile, in tile order; a key replaces the best only
    when strictly smaller, so an equal key keeps the earlier tile.  Returns
    ``(t_trunc [R_pad] f32, tri [R_pad] i32)`` or, with ``any_mode``,
    ``hit [R_pad] i32``."""
    dev = rays.device
    nb = rays.shape[0] // RB
    r = rays.view(nb, RB, 8)
    lane = torch.arange(TT, dtype=torch.int32, device=dev)
    best_key = torch.full((nb, RB), INIT_KEY, dtype=torch.int32, device=dev)
    best_tile = torch.zeros((nb, RB), dtype=torch.int32, device=dev)
    hit = torch.zeros((nb, RB), dtype=torch.bool, device=dev)
    for tile in range(tiles.shape[0]):
        t = _test_matrix(r, tiles[tile:tile + 1, 0:12])
        if any_mode:
            hit |= (t < INF).any(-1)
            continue
        kmin = ((t.view(torch.int32) & ~LANE_BITS) | lane).amin(-1)
        closer = kmin < best_key
        best_key = torch.where(closer, kmin, best_key)
        best_tile = torch.where(closer, tile, best_tile)
    if any_mode:
        return hit.view(-1).to(torch.int32)
    t = (best_key & ~LANE_BITS).view(torch.float32)
    tri = best_tile * TT + (best_key & LANE_BITS)
    return t.view(-1), tri.view(-1)


def _check_small_args(rays, tiles):
    nb, n_tiles = rays.shape[0] // RB, tiles.shape[0]
    if not 0 < n_tiles <= SMALL_TILES:
        raise ValueError(f"{n_tiles} tiles: the small sweep takes 1..{SMALL_TILES}")
    _build.check(rays, "rays", torch.float32, (nb * RB, 8))
    _build.check(tiles, "tiles", torch.float32, (n_tiles, 16, TT))
    for t, name in ((rays, "rays"), (tiles, "tiles")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    return nb, n_tiles


def closest_small(rays, tiles):
    """Closest sweep of a scene of at most SMALL_TILES tiles:
    ``(t_trunc [R_pad], tri [R_pad])``."""
    if _build.on_cpu(rays, tiles):
        return _small_sweep(rays, tiles, any_mode=False)
    nb, n_tiles = _check_small_args(rays, tiles)
    t = torch.empty((nb * RB,), dtype=torch.float32, device=rays.device)
    tri = torch.empty((nb * RB,), dtype=torch.int32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_closest_small, rays.data_ptr(),
                      tiles.data_ptr(), nb, n_tiles, t.data_ptr(),
                      tri.data_ptr())
        _build.LAUNCHES["closest_small"] += 1
    return t, tri


def any_small(rays, tiles):
    """Any-hit sweep of a scene of at most SMALL_TILES tiles: ``hit [R_pad]``
    int32 (0/1)."""
    if _build.on_cpu(rays, tiles):
        return _small_sweep(rays, tiles, any_mode=True)
    nb, n_tiles = _check_small_args(rays, tiles)
    hit = torch.empty((nb * RB,), dtype=torch.int32, device=rays.device)
    if nb:
        _build.launch(_build.load().ptx_any_small, rays.data_ptr(),
                      tiles.data_ptr(), nb, n_tiles, hit.data_ptr())
        _build.LAUNCHES["any_small"] += 1
    return hit


# --------------------------------------------------------------------------
# Backend
# --------------------------------------------------------------------------


def _scene_tiles(fs: FlatScene):
    """The scene's traversal tiles and boxes: the attached ones when packed
    at this TT, else packed in the call on the scene's device
    (:func:`ptx_torch.kernels.tiles.pack_tris`), as the JAX package does
    for scenes built without them."""
    if fs.ptiles.shape[0] > 0 and fs.ptiles.shape[2] == TT:
        return fs.ptiles, fs.pboxes
    return pack_tris(fs)


def closest(fs: FlatScene, orig, dirn, split_geom_grad: bool = False) -> Hit:
    """Closest hit through the planned tile traversal, then the exact
    epilogue: the sweep only selects the winner (truncated t).

    The plan and the sweep run without autograd, on detached rays and
    tiles (the JAX package's ``stop_gradient`` at its ``pallas_call``);
    gradients flow through the epilogue: the ``tri_attrs`` row gather and
    the Moller-Trumbore recompute of the winner.  ``split_geom_grad``
    routes d/d vertices through the [T, 3] ``tri_a`` / ``tri_e1`` /
    ``tri_e2`` leaves and detaches the [T, 40] row, whose backward would
    otherwise scatter 40-wide rows; the values are the same."""
    r = orig.shape[0]
    with torch.no_grad():
        rays, _ = _pack_rays(orig, dirn)
        tiles, boxes = _scene_tiles(fs)
        if tiles.shape[0] <= SMALL_TILES:
            t_trunc, tri = closest_small(rays, tiles)
        else:
            t_trunc, tri = closest_sweep(*_plan_tiles(rays, boxes), rays, tiles)
    t_trunc, tri = t_trunc[:r], tri[:r]
    n = fs.tri_a.shape[0]
    # Out-of-range winners (no-hit lanes of a padded last tile) are clamped
    # like a JAX gather; those lanes are masked by ``hit``.
    tri = torch.clamp(tri, 0, n - 1).long()
    at = fs.tri_attrs[tri] if fs.tri_attrs.shape[0] == n else None
    geom = None
    if at is not None and split_geom_grad:
        at = at.detach()
        a, e1, e2 = fs.tri_a[tri], fs.tri_e1[tri], fs.tri_e2[tri]
        geom = (a, e1, e2)
    elif at is not None:
        a, e1, e2 = at[:, 25:28], at[:, 28:31], at[:, 31:34]
    else:
        a, e1, e2 = fs.tri_a[tri], fs.tri_e1[tri], fs.tri_e2[tri]
    t_exact, beta, gamma, _ = geometry.moller_trumbore(orig, dirn, a, e1, e2)
    hit = (t_trunc < HIT_T) & (t_exact < INF)
    t = torch.where(hit, t_exact, INF)
    return attrs_from_indices(fs, t, tri, beta, gamma, hit, at=at, geom=geom)


def any_hit_rows(fs: FlatScene, rays, r: int):
    """Occlusion of rays already packed as ``[R_pad, 8]`` rows (the layout
    of ``_pack_rays``) of which the first ``r`` are real: [r] bool."""
    with torch.no_grad():
        tiles, boxes = _scene_tiles(fs)
        if tiles.shape[0] <= SMALL_TILES:
            hit = any_small(rays, tiles)
        else:
            hit = any_sweep(*_plan_tiles(rays, boxes), rays, tiles)
    return hit[:r] > 0


def any_hit(fs: FlatScene, orig, dirn):
    """Occlusion through the planned tile traversal: [R] bool."""
    with torch.no_grad():
        rays = _pack_rays(orig, dirn)[0]
    return any_hit_rows(fs, rays, orig.shape[0])


def closest_stats(fs: FlatScene, orig, dirn):
    """The bench roofline's account of the closest sweep (port of
    ``closest_pallas_stats``): the plan and the stats sweep on ``R`` rays,
    ``(t_trunc [R_pad], tri [R_pad], visited [R_pad / 128])``.  Needs a
    scene above the small-sweep path."""
    rays, _ = _pack_rays(orig, dirn)
    tiles, boxes = _scene_tiles(fs)
    if tiles.shape[0] <= SMALL_TILES:
        raise ValueError("stats sweep needs > SMALL_TILES tiles")
    return closest_sweep_stats(*_plan_tiles(rays, boxes), rays, tiles)


def make_backend(split_geom_grad: bool = False):
    """(closest, any_hit) pair of the tile traversal.  ``split_geom_grad``:
    see :func:`closest` (the gradient's route to the vertices; values
    unchanged)."""
    if not split_geom_grad:
        return closest, any_hit

    def closest_split(fs, orig, dirn):
        return closest(fs, orig, dirn, split_geom_grad=True)

    return closest_split, any_hit
