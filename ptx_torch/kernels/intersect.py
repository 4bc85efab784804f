"""Plain torch intersection (port of ``ptx/kernels/intersect.py``): the
tiled brute-force sweep, the ``Hit`` payload and the attribute resolve.

    closest(fs, orig [R,3], dirn [R,3]) -> Hit
    any_hit(fs, orig [R,3], dirn [R,3]) -> hit [R] bool

Misses carry ``t = geometry.INF``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptx_torch import geometry
from ptx_torch.integrator.wavefront import compute_hit_attrs
from ptx_torch.scene.flatten import FlatScene


class Hit(NamedTuple):
    """Per-ray hit payload."""

    hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R] distance, INF on miss
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] interpolated shading normal (pre normal-map)
    tangent: torch.Tensor  # [R, 3]
    uv: torch.Tensor  # [R, 2]
    mat_id: torch.Tensor  # [R] int32


def attrs_from_indices(fs: FlatScene, t, tri, beta, gamma, hit, at=None,
                       geom=None) -> Hit:
    """Resolve (triangle index, barycentrics) to the :class:`Hit` payload.
    ``at``: the already-gathered ``tri_attrs`` rows, if any; ``geom``: an
    (a, e1, e2) override of their vertex columns (the split-geometry-gradient
    path)."""
    position, n_interp, tangent, uv, mat_id = compute_hit_attrs(
        fs, tri, beta, gamma, at=at, geom=geom
    )
    return Hit(hit, t, position, n_interp, tangent, uv, mat_id)


def brute_closest(fs: FlatScene, orig, dirn, tile: int = 512):
    """Closest hit of every ray against every triangle, ``tile`` triangles
    at a time.  Returns ``(t, tri, beta, gamma, hit)``.

    The winner is selected without autograd, then its Moller-Trumbore test
    is recomputed, which autograd records: the JAX package's gradient (its
    brute sweep differentiates through the winner's ``take_along_axis``)
    without an [R, tile] graph per tile.  The recompute is the same
    elementwise operations on the same operands, so its values are the
    selection's, bit for bit."""
    n = fs.tri_a.shape[0]
    tile = min(tile, n)
    r = orig.shape[0]
    with torch.no_grad():
        best_t = torch.full((r,), geometry.INF, device=orig.device)
        best_tri = torch.zeros((r,), dtype=torch.int32, device=orig.device)
        for i in range(-(-n // tile)):
            # The last tile of a non-multiple count is clamped back into range.
            start = min(i * tile, n - tile)
            sl = slice(start, start + tile)
            t, _, _, _ = geometry.moller_trumbore(
                orig[:, None, :], dirn[:, None, :],
                fs.tri_a[None, sl], fs.tri_e1[None, sl], fs.tri_e2[None, sl],
            )  # [R, tile]
            arg = torch.argmin(t, dim=1, keepdim=True)
            tmin = torch.gather(t, 1, arg)[:, 0]
            closer = tmin < best_t
            best_tri = torch.where(closer, start + arg[:, 0].to(torch.int32),
                                   best_tri)
            best_t = torch.minimum(best_t, tmin)
    hit = best_t < geometry.INF
    w = best_tri.long()
    t, beta, gamma, _ = geometry.moller_trumbore(
        orig, dirn, fs.tri_a[w], fs.tri_e1[w], fs.tri_e2[w])
    # A ray without a hit keeps t = INF and zero barycentrics.
    zero = torch.zeros_like(beta)
    return (torch.where(hit, t, best_t), best_tri,
            torch.where(hit, beta, zero), torch.where(hit, gamma, zero), hit)


def brute_any(fs: FlatScene, orig, dirn, tile: int = 512):
    """Boolean occlusion of every ray against every triangle."""
    n = fs.tri_a.shape[0]
    tile = min(tile, n)
    hit = torch.zeros((orig.shape[0],), dtype=torch.bool, device=orig.device)
    with torch.no_grad():
        for i in range(-(-n // tile)):
            sl = slice(i * tile, (i + 1) * tile)
            _, _, _, ok = geometry.moller_trumbore(
                orig[:, None, :], dirn[:, None, :],
                fs.tri_a[None, sl], fs.tri_e1[None, sl], fs.tri_e2[None, sl],
            )
            hit |= ok.any(dim=1)
    return hit


def make_brute(tile: int = 512):
    """(closest, any_hit) callables with the integrator signature."""

    def closest(fs, orig, dirn):
        t, tri, beta, gamma, hit = brute_closest(fs, orig, dirn, tile)
        return attrs_from_indices(fs, t, tri.long(), beta, gamma, hit)

    def any_hit(fs, orig, dirn):
        return brute_any(fs, orig, dirn, tile)

    return closest, any_hit
