"""Host side of the tile traversal: the triangle-tile pack, ray packing and
the conservative frustum gate (port of the non-kernel parts of
``ptx/kernels/intersect_pallas.py``).

Triangles are BVH-ordered (``ptx_torch.accel.bvh``), so a TT-wide tile of
consecutive triangles is spatially local and has a tight box.  Each tile is
one contiguous [16, TT] float32 block: rows 0-11 hold the Baldwin-Weber
components of :func:`_bw_rows`, rows 12-15 are zero.  The pack is the JAX
package's numpy code, so both packages sweep bit-identical tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.scene.flatten import FlatScene

RB = 128  # rays per block
TT = 512  # triangles per tile
INF = float(np.float32(3.0e38))  # the JAX package's 3e38, exact in f32
# Above this tile count the exact per-ray gate (O(rays x tiles)) gives way
# to the per-block frustum gate (O(blocks x tiles)).
FRUSTUM_PLAN_TILES = 4096
# Scenes up to this many tiles skip the plan: every block sweeps every tile.
SMALL_TILES = 4
# Packed-min key: (bits(t) & ~LANE_BITS) | lane orders like t (positive f32
# bit patterns order like int32), truncating t to 14 mantissa bits.
LANE_BITS = TT - 1
# Swept t values below this are hits; a truncated INF stays above it.
HIT_T = 1.0e38
INIT_KEY = (int(np.float32(INF).view(np.int32)) & ~LANE_BITS) | LANE_BITS


def _bw_rows(a, e1, e2):
    """[12, N] Baldwin-Weber rows: unit plane normal (0-2), plane d (3),
    barycentric rows T1 (4-7) and T2 (8-11) of inv([e1 e2 n]) with
    translation.  Degenerate triangles are all zero, so n.dir = 0 makes t
    NaN and every comparison in the sweep rejects them."""
    f32 = np.float32
    n = np.cross(e1, e2)
    nl = np.sqrt(np.sum(n * n, axis=1, keepdims=True))
    ok = nl[:, 0] > f32(1e-30)
    safe = np.maximum(nl, f32(1e-30))
    nn = n / safe
    d = -np.einsum("ij,ij->i", nn, a)
    t1 = np.cross(e2, nn) / safe
    t2 = np.cross(nn, e1) / safe
    t1w = -np.einsum("ij,ij->i", t1, a)
    t2w = -np.einsum("ij,ij->i", t2, a)
    zero = np.zeros_like(d)
    rows = np.stack([
        *(np.where(ok, nn[:, i], zero) for i in range(3)),
        np.where(ok, d, zero),
        *(np.where(ok, t1[:, i], zero) for i in range(3)),
        np.where(ok, t1w, zero),
        *(np.where(ok, t2[:, i], zero) for i in range(3)),
        np.where(ok, t2w, zero),
    ])
    return rows.astype(np.float32)


def attach_tiles(fs: FlatScene) -> FlatScene:
    """Attach the traversal tiles (``fs.ptiles`` [T, 16, TT]) and their
    boxes (``fs.pboxes`` [T, 8]: lo 0-2, hi 3-5) to a numpy scene.  Called
    once per scene by ``ptx_torch.render.ensure_accel`` after the BVH
    ordering is final."""
    tri_a = np.asarray(fs.tri_a, np.float32)
    tri_e1 = np.asarray(fs.tri_e1, np.float32)
    tri_e2 = np.asarray(fs.tri_e2, np.float32)
    tri_valid = np.asarray(fs.tri_valid, bool)
    n = tri_a.shape[0]
    n_pad = -(-n // TT) * TT
    n_tiles = n_pad // TT
    pad = n_pad - n
    if pad:
        z = np.zeros((pad, 3), np.float32)
        tri_a = np.concatenate([tri_a, z])
        tri_e1 = np.concatenate([tri_e1, z])
        tri_e2 = np.concatenate([tri_e2, z])
    tris = np.zeros((16, n_pad), np.float32)
    tris[0:12] = _bw_rows(tri_a, tri_e1, tri_e2)

    a = tri_a.reshape(n_tiles, TT, 3)
    b = (tri_a + tri_e1).reshape(n_tiles, TT, 3)
    c = (tri_a + tri_e2).reshape(n_tiles, TT, 3)
    valid = np.zeros((n_pad,), bool)
    valid[: tri_valid.shape[0]] = tri_valid
    valid = valid.reshape(n_tiles, TT, 1)
    big = np.float32(INF)
    lo = np.min(np.where(valid, np.minimum(np.minimum(a, b), c), big), axis=1)
    hi = np.max(np.where(valid, np.maximum(np.maximum(a, b), c), -big), axis=1)
    boxes = np.zeros((n_tiles, 8), np.float32)
    boxes[:, 0:3] = lo
    boxes[:, 3:6] = hi
    tiles = np.ascontiguousarray(tris.reshape(16, n_tiles, TT).transpose(1, 0, 2))
    return fs._replace(ptiles=tiles, pboxes=boxes)


# --------------------------------------------------------------------------
# The same pack in torch, on the scene's own device
# --------------------------------------------------------------------------
#
# Bit-equal to :func:`attach_tiles` on the CPU and on the card: every product,
# sum and quotient is its own elementwise op (eager torch runs each as one
# kernel, so nothing contracts into an FMA), the square root is taken in
# float64 and rounded once, and the reductions follow
# numpy's rules where torch's differ: a 3-term sum is ((p0 + p1) + p2) + 0
# (numpy starts from +0, so an all -0 sum is +0), np.minimum / np.maximum
# return their second operand on a tie, and np.min / np.max over an axis
# fold in order, so among tied zeros the last one's sign wins.


def _np_min(a, b):
    return torch.where((a < b) | torch.isnan(a), a, b)


def _np_max(a, b):
    return torch.where((a > b) | torch.isnan(a), a, b)


def _np_sum3(p0, p1, p2):
    return ((p0 + p1) + p2) + 0.0


def _np_dot(u, v):
    return _np_sum3(u[:, 0] * v[:, 0], u[:, 1] * v[:, 1], u[:, 2] * v[:, 2])


def _np_cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], 1)


def _np_reduce(x, dim, largest: bool):
    """np.min / np.max of ``x`` over ``dim``: the value of ``amin`` /
    ``amax``, and where that value is zero, the sign of the last zero."""
    m = x.amax(dim) if largest else x.amin(dim)
    idx = torch.arange(x.shape[dim], device=x.device).view(
        [-1 if d == dim else 1 for d in range(x.dim())])
    last = torch.where(x == 0, idx, -1).amax(dim, keepdim=True).clamp(min=0)
    return torch.where(m == 0, x.gather(dim, last).squeeze(dim), m)


def _bw_rows_torch(a, e1, e2):
    """:func:`_bw_rows` in torch, bit for bit: [12, N] float32."""
    n = _np_cross(e1, e2)
    # torch's float32 sqrt on the CPU is not always correctly rounded; the
    # float64 root rounded to float32 is (as numpy's float32 sqrt is).
    nl = torch.sqrt(_np_sum3(n[:, 0] * n[:, 0], n[:, 1] * n[:, 1],
                             n[:, 2] * n[:, 2]).double()).float()[:, None]
    tiny = float(np.float32(1e-30))
    ok = nl[:, 0] > tiny
    safe = _np_max(nl, torch.full_like(nl, tiny))
    nn = n / safe
    d = -_np_dot(nn, a)
    t1 = _np_cross(e2, nn) / safe
    t2 = _np_cross(nn, e1) / safe
    t1w = -_np_dot(t1, a)
    t2w = -_np_dot(t2, a)
    cols = [nn[:, 0], nn[:, 1], nn[:, 2], d, t1[:, 0], t1[:, 1], t1[:, 2], t1w,
            t2[:, 0], t2[:, 1], t2[:, 2], t2w]
    return torch.stack([torch.where(ok, c, 0.0) for c in cols])


def pack_tris(fs: FlatScene):
    """``(tiles [T, 16, TT], boxes [T, 8])`` of the scene's triangles, on
    the device that holds ``fs``'s tensors (port of the JAX package's
    in-call ``pack_tris``): the traversal's fallback for a scene without
    attached tiles.  Bit-equal to :func:`attach_tiles`.  As there, a padding
    tile gets the inverted box (INF, -INF), which the slab test treats as
    all space: it gates in for every ray and never hits."""
    tri_a, tri_e1, tri_e2 = (torch.as_tensor(x, dtype=torch.float32)
                             for x in (fs.tri_a, fs.tri_e1, fs.tri_e2))
    tri_valid = torch.as_tensor(fs.tri_valid, device=tri_a.device).to(torch.bool)
    dev = tri_a.device
    n = tri_a.shape[0]
    n_pad = -(-n // TT) * TT
    n_tiles = n_pad // TT
    pad = n_pad - n
    if pad:
        z = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        tri_a, tri_e1, tri_e2 = (torch.cat([x, z]) for x in (tri_a, tri_e1, tri_e2))
    tris = torch.zeros((16, n_pad), dtype=torch.float32, device=dev)
    tris[0:12] = _bw_rows_torch(tri_a, tri_e1, tri_e2)

    a = tri_a.reshape(n_tiles, TT, 3)
    b = (tri_a + tri_e1).reshape(n_tiles, TT, 3)
    c = (tri_a + tri_e2).reshape(n_tiles, TT, 3)
    i = torch.arange(n_pad, device=dev)
    n_valid = tri_valid.shape[0]
    valid = ((i < n_valid) & tri_valid[i.clamp(max=max(n_valid - 1, 0))]
             ).reshape(n_tiles, TT, 1)
    lo = _np_reduce(torch.where(valid, _np_min(_np_min(a, b), c), INF), 1, False)
    hi = _np_reduce(torch.where(valid, _np_max(_np_max(a, b), c), -INF), 1, True)
    boxes = torch.zeros((n_tiles, 8), dtype=torch.float32, device=dev)
    boxes[:, 0:3] = lo
    boxes[:, 3:6] = hi
    tiles = tris.reshape(16, n_tiles, TT).transpose(0, 1).contiguous()
    return tiles, boxes


def _pack_rays(orig, dirn):
    """[R_pad, 8] ray rows (ox oy oz dx dy dz 0 0), R_pad a multiple of RB.
    Padding rays get a unit direction so no NaN flows through the sweep."""
    r = orig.shape[0]
    r_pad = -(-r // RB) * RB
    rays = torch.zeros((r_pad, 8), dtype=torch.float32, device=orig.device)
    rays[:r, 0:3] = orig
    rays[:r, 3:6] = dirn
    rays[r:, 3] = 1.0
    return rays, r_pad


def _frustum_gate(rays, boxes):
    """Conservative per-[block x tile] (gated, min entry) from interval
    arithmetic over each block's ray bounds; every quantity
    over-approximates the block's ray set, so results stay exact."""
    nb = rays.shape[0] // RB
    o = rays[:, 0:3].reshape(nb, RB, 3)
    d = rays[:, 3:6].reshape(nb, RB, 3)
    olo, ohi = o.amin(1)[:, None, :], o.amax(1)[:, None, :]  # [B, 1, 3]
    dlo, dhi = d.amin(1)[:, None, :], d.amax(1)[:, None, :]
    inf = torch.full_like(dlo, float("inf"))
    pos = dlo > 0.0
    neg = dhi < 0.0
    ilo = torch.where(pos, 1.0 / dhi, torch.where(neg, 1.0 / dlo, -inf))
    ihi = torch.where(pos, 1.0 / dlo, torch.where(neg, 1.0 / dhi, inf))

    def imul(alo, ahi, blo, bhi):
        c = torch.stack([alo * blo, alo * bhi, ahi * blo, ahi * bhi])
        nan = torch.isnan(c)
        lo = torch.where(nan, float("inf"), c).amin(0)
        hi = torch.where(nan, float("-inf"), c).amax(0)
        return lo, hi

    blo = boxes[None, :, 0:3]
    bhi = boxes[None, :, 3:6]
    t0lo, t0hi = imul(blo - ohi, blo - olo, ilo, ihi)
    t1lo, t1hi = imul(bhi - ohi, bhi - olo, ilo, ihi)
    near_lo = torch.minimum(t0lo, t1lo).amax(-1)  # [B, T]
    far_hi = torch.maximum(t0hi, t1hi).amin(-1)
    enter = torch.clamp(near_lo, min=0.0)
    gated = far_hi >= enter
    return gated, torch.where(gated, enter, INF)


def sort_plan(gated, near_blk):
    """Per-block visit order from a gate: ``order`` [B, T] int32 (tile ids
    front to back by entry distance; slots past ``count`` repeat the last
    gated tile), ``count`` [B] int32, ``near`` [B, T+1] float32 (entry
    distance in visit order, INF past ``count`` and in the extra column)."""
    nb, n_tiles = gated.shape
    count = gated.sum(1, dtype=torch.int32)
    key = torch.where(gated, near_blk, INF)
    near_sorted, order = torch.sort(key, dim=1, stable=True)
    order = order.to(torch.int32)
    slot = torch.arange(n_tiles, device=gated.device)[None, :]
    last = torch.clamp(count - 1, min=0)[:, None].long()
    last_tile = torch.gather(order, 1, last)
    order = torch.where(slot < count[:, None], order, last_tile)
    near = torch.cat(
        [near_sorted, torch.full((nb, 1), INF, device=gated.device)], dim=1
    )
    return order.contiguous(), count, near


def identity_plan(nb: int, n_tiles: int, device):
    """The plan of a scene of at most SMALL_TILES tiles: every block visits
    every tile, at entry distance 0."""
    order = (
        torch.arange(n_tiles, dtype=torch.int32, device=device)
        .expand(nb, n_tiles).contiguous()
    )
    count = torch.full((nb,), n_tiles, dtype=torch.int32, device=device)
    near = torch.zeros((nb, n_tiles + 1), dtype=torch.float32, device=device)
    near[:, n_tiles] = INF
    return order, count, near
