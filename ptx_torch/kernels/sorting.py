"""Ray sort keys and dead-ray parking for survivor compaction (port of
``ptx/kernels/sorting.py``).

Rays are ordered by (coarse morton cell of the origin, direction octant) so
each 128-ray block covers a small cell with a narrow cone and the tile gate
culls; dead lanes are parked outside the scene, pointing away, so they sort
into all-dead blocks that fail every gate.  The uint32 arithmetic of the
JAX package is done in int64, where none of it overflows.
:func:`make_sorting_backend` is the per-call sorting wrapper of a backend,
which the loss functions of ``ptx_torch.diff`` reach.
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.scene.flatten import SceneStatic
from ptx_torch.utils import device_constant

# Bits per axis of the coarse morton grid (7 bits/axis = 21-bit cell id).
MORTON_BITS = 7


def resolve_compact(static: SceneStatic, cfg) -> bool:
    """``cfg.sort_rays``: "off" and "on" force it, "auto" follows the scene
    size (:func:`should_compact`)."""
    if cfg.sort_rays == "off":
        return False
    if cfg.sort_rays == "on":
        return True
    return should_compact(static)


def should_compact(static: SceneStatic) -> bool:
    """Sorting and parking pay once the sweep spans several tiles."""
    from ptx_torch.kernels.tiles import TT

    return static.n_tris_padded > 4 * TT


def _expand_bits(x):
    """Spread the low 10 bits of ``x`` two zero bits apart (30-bit morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_keys(orig, dirn, lo, hi, bits: int = MORTON_BITS):
    """[R] int32 sort keys: morton cell of the origin (primary), direction
    octant (secondary)."""
    lo = device_constant(tuple(lo), orig.device)
    hi = device_constant(tuple(hi), orig.device)
    extent = torch.clamp(hi - lo, min=1e-30)
    n_cells = float(1 << bits)
    q = torch.clamp((orig - lo) / extent * n_cells, 0.0, n_cells - 1.0)
    q = q.to(torch.int64)
    morton = (
        _expand_bits(q[:, 0])
        | (_expand_bits(q[:, 1]) << 1)
        | (_expand_bits(q[:, 2]) << 2)
    )
    octant = (
        (dirn[:, 0] >= 0).to(torch.int64)
        | ((dirn[:, 1] >= 0).to(torch.int64) << 1)
        | ((dirn[:, 2] >= 0).to(torch.int64) << 2)
    )
    return ((morton << 3) | octant).to(torch.int32)


def park_constants(static: SceneStatic):
    """``((x, y, z) of the parked origin, the parked direction's component)``
    as python floats: ``hi + (hi - lo) + 1`` of the scene box with each
    operation rounded once in float32, as the JAX package computes it, and
    f32(0.57735027).  Kernels take them by value."""
    hi = np.asarray(static.aabb_hi, np.float32)
    lo = np.asarray(static.aabb_lo, np.float32)
    p_orig = (hi + (hi - lo)) + np.float32(1.0)
    return tuple(float(x) for x in p_orig), float(np.float32(0.57735027))


def park(orig, dirn, keep, static: SceneStatic):
    """Move lanes where ``keep`` is False outside the scene, pointing away:
    they hit nothing, fail every gate and share one morton cell.  Callers
    mask those lanes' results."""
    return park_with(orig, dirn, keep, park_constants(static))


def park_with(orig, dirn, keep, constants):
    """:func:`park` with the scene's :func:`park_constants` given."""
    p_orig, p_dir = constants
    k = keep[..., None]
    return (torch.where(k, orig, device_constant(tuple(p_orig), orig.device)),
            torch.where(k, dirn, device_constant((p_dir,) * 3, orig.device)))


def make_sorting_backend(closest, any_hit, static: SceneStatic):
    """Wrap a (closest, any_hit) backend pair with per-call ray sorting:
    each call sorts its rays by :func:`ray_keys` (a stable sort, as
    ``jnp.argsort`` is), runs the backend on the sorted rays, and returns
    the results in the callers' order."""
    lo, hi = static.aabb_lo, static.aabb_hi

    def closest_sorted(fs, orig, dirn):
        perm = torch.argsort(ray_keys(orig, dirn, lo, hi), stable=True)
        h = closest(fs, orig[perm], dirn[perm])
        inv = torch.argsort(perm)
        return type(h)(*(x[inv] for x in h))

    def any_sorted(fs, orig, dirn):
        perm = torch.argsort(ray_keys(orig, dirn, lo, hi), stable=True)
        return any_hit(fs, orig[perm], dirn[perm])[torch.argsort(perm)]

    return closest_sorted, any_sorted
