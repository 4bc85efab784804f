"""Batched ray/triangle primitives (port of ``ptx/geometry.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptx_torch import math as pmath

# "No hit" distance, the same sentinel as ptx.geometry.INF.
INF = 3.0e38


class Triangles(NamedTuple):
    """A triangle soup in world space, structure of arrays: ``a`` is vertex
    0, ``e1 = b - a``, ``e2 = c - a``; barycentric ``beta`` weighs ``b`` and
    ``gamma`` weighs ``c``."""

    a: torch.Tensor  # [N, 3]
    e1: torch.Tensor  # [N, 3]
    e2: torch.Tensor  # [N, 3]
    valid: torch.Tensor  # [N] bool, False for padding slots


def moller_trumbore(orig, dirn, a, e1, e2, eps: float = pmath.EPS):
    """Batched Moller-Trumbore intersection; arguments broadcast elementwise.

    Returns ``(t, beta, gamma, hit)``: ``t`` is INF where there is no hit.
    The barycentric tests are biased by ``eps`` in favour of a hit, a hit
    needs ``t >= 0`` and a finite ``t``, and a zero determinant never hits.
    """
    pvec = pmath.cross(dirn, e2)
    det = pmath.dot(e1, pvec)
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    tvec = orig - a
    beta = pmath.dot(tvec, pvec) * inv_det
    qvec = pmath.cross(tvec, e1)
    gamma = pmath.dot(dirn, qvec) * inv_det
    t = pmath.dot(e2, qvec) * inv_det
    ok = (
        (beta >= -eps)
        & (beta <= 1.0 + eps)
        & (gamma >= -eps)
        & (beta + gamma <= 1.0 + eps)
        & (t >= 0.0)
        & torch.isfinite(t)
        & ~degenerate
    )
    t = torch.where(ok, t, torch.full_like(t, INF))
    return t, beta, gamma, ok


def aabb_intersect(orig, dirn, box_min, box_max):
    """Slab test of rays against boxes; arguments broadcast (``[R, 1, 3]``
    against ``[N, 3]`` gives ``[R, N]``).  Returns ``(near, far, hit)``,
    ``hit`` where ``[max(near, 0), far]`` is not empty.  A zero direction
    component gives an open slab through IEEE infinities; its NaN (the
    origin exactly on that slab) counts as an open slab too, so the other
    axes decide."""
    inv_d = 1.0 / dirn
    t0 = (box_min - orig) * inv_d
    t1 = (box_max - orig) * inv_d
    inf = torch.full_like(t0, float("inf"))
    tmin = torch.where(torch.isnan(t0), -inf, torch.minimum(t0, t1))
    tmax = torch.where(torch.isnan(t1), inf, torch.maximum(t0, t1))
    tmax = torch.where(torch.isnan(tmax), inf, tmax)
    tmin = torch.where(torch.isnan(tmin), -inf, tmin)
    near = tmin.amax(dim=-1)
    far = tmax.amin(dim=-1)
    hit = (far >= torch.clamp(near, min=0.0)) & (far >= 0.0)
    return near, far, hit


def transform_ray(orig, dirn, basis, origin):
    """Rays ``[..., 3]`` through the affine map ``x -> basis @ x + origin``
    (``basis`` [3, 3]), the direction normalized again.  The products are
    written out, not a matmul: a float32 matmul on the card may run in
    TF32, and the summation order stays fixed this way."""
    new_orig = torch.stack([pmath.dot(orig, basis[i]) for i in range(3)],
                           dim=-1) + origin
    new_dir = torch.stack([pmath.dot(dirn, basis[i]) for i in range(3)],
                          dim=-1)
    return new_orig, pmath.normalize(new_dir)


def pad_triangles(a, e1, e2, multiple: int = 128):
    """Pad a triangle soup ``[N, 3]`` x 3 to a multiple of ``multiple``
    rows with degenerate (never hit) zero triangles; returns ``(a, e1, e2,
    valid)``, ``valid`` [N_pad] False on the padding."""
    n = a.shape[0]
    n_pad = (-n) % multiple
    if n_pad:
        zero = torch.zeros((n_pad, 3), dtype=a.dtype, device=a.device)
        a, e1, e2 = (torch.cat([x, zero]) for x in (a, e1, e2))
    valid = torch.arange(n + n_pad, device=a.device) < n
    return a, e1, e2, valid
