"""Batched ray/triangle primitives (port of ``ptx/geometry.py``)."""

from __future__ import annotations

import torch

from ptx_torch import math as pmath

# "No hit" distance, the same sentinel as ptx.geometry.INF.
INF = 3.0e38


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
