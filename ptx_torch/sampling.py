"""Counter-based RNG and PBR importance sampling (port of ``ptx/sampling.py``).

The PCG4D hash is computed on uint32 values held in int64 tensors: every
product is split into two 16-bit halves so no intermediate leaves 49 bits,
and every result is masked back to 32 bits.  The stream is therefore the JAX
package's bit for bit, on any device.
"""

from __future__ import annotations

import torch

from ptx_torch import math as pmath

# Purpose salts, verbatim from ptx/sampling.py.
P_AA_JITTER_X = 0x01
P_AA_JITTER_Y = 0x02
P_SUN_PHI = 0x03
P_SUN_THETA = 0x04
P_OPACITY = 0x05
P_LOBE = 0x06
P_BRDF_U = 0x07
P_BRDF_V = 0x08
P_RR = 0x09

_M32 = 0xFFFFFFFF


def _mul32(a, b):
    """(a * b) mod 2^32 for uint32 values in int64 tensors, overflow-free."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lcg(v):
    return (v * 1664525 + 1013904223) & _M32


def _pcg4d(v0, v1, v2, v3):
    """PCG4D hash (Jarzynski & Olano) on uint32 values in int64 tensors."""
    v0, v1, v2, v3 = _lcg(v0), _lcg(v1), _lcg(v2), _lcg(v3)
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul32(v1, v3)) & _M32
    v1 = (v1 + _mul32(v2, v0)) & _M32
    v2 = (v2 + _mul32(v0, v1)) & _M32
    v3 = (v3 + _mul32(v1, v2)) & _M32
    return v0, v1, v2, v3


def uniform(pixel_id, sample_id, bounce: int, purpose: int, seed: int = 0):
    """Deterministic uniform in [0, 1) keyed by (pixel, sample, bounce,
    purpose, seed).  ``pixel_id``/``sample_id``: integer tensors that
    broadcast together; the rest are python ints."""
    a = pixel_id.to(torch.int64) & _M32
    b = sample_id.to(torch.int64) & _M32
    a, b = torch.broadcast_tensors(a, b)
    c = torch.full_like(a, (((int(bounce) & _M32) << 8) & _M32) | purpose)
    d = torch.full_like(a, (int(seed) & _M32) ^ 0x9E3779B9)
    h0, _, _, _ = _pcg4d(a, b, c, d)
    return (h0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def cone_vec(u, cos_theta, axis):
    """Random vector in the cone of half-angle ``acos(cos_theta)`` around
    ``axis`` (``util::rand_cone_vec``)."""
    phi = u * (2.0 * pmath.PI)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    lx = torch.cos(phi) * sin_theta
    ly = torch.sin(phi) * sin_theta
    lz = cos_theta
    tangent, binormal = pmath.orthonormal_basis(axis)
    return tangent * lx[..., None] + binormal * ly[..., None] + axis * lz[..., None]


def importance_diffuse(u1, u2, normal):
    """Cosine-weighted hemisphere direction about ``normal``."""
    return cone_vec(u2, torch.sqrt(torch.clamp(u1, 0.0, 1.0)), normal)


def importance_specular(u1, u2, normal, outcoming, roughness):
    """GGX half-vector sample with the reference's alpha = roughness^4."""
    a = roughness * roughness
    a = a * a
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - u1) / (1.0 + (a - 1.0) * u1), 0.0, 1.0)
    )
    halfway = cone_vec(u2, cos_theta, normal)
    return pmath.reflect(-outcoming, halfway)


def fresnel(outcoming, incoming, ior):
    """Schlick fresnel with the halfway vector as the micro-normal."""
    halfway = pmath.normalize(outcoming + incoming)
    cos_theta = pmath.dot(outcoming, halfway)
    f0 = (ior - 1.0) / (ior + 1.0)
    f0 = f0 * f0
    return pmath.lerp(
        f0, 1.0, torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0)
    )


def _smith_g1(normal, light_dir, k):
    cos_theta = pmath.dot(normal, light_dir)
    return cos_theta / torch.clamp(pmath.lerp(k, 1.0, cos_theta), min=pmath.EPS)


def geometry_smith(normal, outcoming, incoming, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return _smith_g1(normal, outcoming, k) * _smith_g1(normal, incoming, k)


def distribution_ggx(normal, outcoming, incoming, roughness):
    a = roughness * roughness
    a = a * a
    halfway = pmath.normalize(outcoming + incoming)
    cos_phi = pmath.dot(normal, halfway)
    denom = pmath.lerp(1.0, a, cos_phi * cos_phi)
    cos_theta = pmath.dot(normal, incoming)
    return cos_theta * a / torch.clamp(pmath.PI * denom * denom, min=pmath.EPS)


def pdf_diffuse(normal, incoming):
    return pmath.dot(normal, incoming) / pmath.PI


def pdf_specular(normal, outcoming, incoming, roughness):
    dist = distribution_ggx(normal, outcoming, incoming, roughness)
    geo = geometry_smith(normal, outcoming, incoming, roughness)
    n_dot_o = pmath.dot(normal, outcoming)
    n_dot_i = pmath.dot(normal, incoming)
    return (dist * geo) / torch.clamp(4.0 * n_dot_o * n_dot_i, min=pmath.EPS)
