"""Vector math, tonemapping and projection helpers (port of ``ptx/math.py``).

Vectors are tensors whose last axis is the component axis (``[..., 3]``).
Dot products and the cross product are written out component by component
so the summation order is fixed ((x + y) + z) on every device.
"""

from __future__ import annotations

import torch

EPS = 1e-4
PI = 3.14159265358979323846
INV_SQRT3 = 0.5773502691896258


def dot(a, b):
    """Batched dot product over the trailing component axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vdot(a, b):
    """Like :func:`dot` but keeps the trailing axis (shape ``[..., 1]``)."""
    return dot(a, b)[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(a):
    """Euclidean length over the trailing axis."""
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = 1e-20):
    """Normalize over the trailing axis; safe at zero length."""
    return a * torch.rsqrt(torch.clamp(vdot(a, a), min=eps))


def lerp(a, b, t):
    """``a + (b - a) * t`` (not ``torch.lerp``, whose rounding differs)."""
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def reflect(incident, normal):
    return incident - 2.0 * vdot(normal, incident) * normal


def tonemap_approx_aces(hdr):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return saturate((hdr * (a * hdr + b)) / (hdr * (c * hdr + d) + e))


def equirectangular_proj(direction):
    u = torch.atan2(direction[..., 2], direction[..., 0]) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(direction[..., 1], -1.0, 1.0)) * 0.3183 + 0.5
    return torch.stack([u, v], dim=-1)


def srgb_encode(linear):
    """Linear -> display, gamma 2.2."""
    return torch.pow(torch.clamp(linear, min=0.0), 1.0 / 2.2)


def srgb_decode(encoded):
    """Display -> linear, gamma 2.2."""
    return torch.pow(torch.clamp(encoded, min=0.0), 2.2)


def orthonormal_basis(normal):
    """(tangent, binormal) for ``normal`` with the reference's
    non-parallel-axis pick: the first coordinate axis whose component of
    ``normal`` is below 1/sqrt(3)."""
    nx, ny = normal[..., 0].abs(), normal[..., 1].abs()
    use_x = nx < INV_SQRT3
    use_y = ~use_x & (ny < INV_SQRT3)
    one = torch.ones_like(nx)
    zero = torch.zeros_like(nx)
    axis = torch.stack(
        [
            torch.where(use_x, one, zero),
            torch.where(use_y, one, zero),
            torch.where(use_x | use_y, zero, one),
        ],
        dim=-1,
    )
    tangent = normalize(cross(normal, axis))
    binormal = cross(normal, tangent)
    return tangent, binormal
