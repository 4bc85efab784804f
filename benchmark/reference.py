"""The plain reference that decides ``correct``: the upstream worker's path
tracer written out in plain PyTorch, independent of the program.

It imports nothing of ``ptx_torch`` (nor ``ptx`` or ``jax``) and takes
nothing the program made: it builds the scene from the configuration's
spec itself (:func:`courtyard`, a frozen copy of the in-repo courtyard
generator, whose output is the input both sides start from), builds its
own BVH (a Morton-ordered binary tree, :func:`build_bvh`), walks it ray by
ray (:func:`walk`) and shades every bounce with the upstream worker's
semantics (``shading_worker.cpp``): environment on a miss, emission x10,
backface cull, sun next-event estimation with the shadow ray, a Fresnel-
or-metallic lobe pick, GGX / cosine importance sampling, the throughput
clamp and Russian roulette after two bounces.  The counter RNG and the
camera are frozen copies too, so a path of the program and the same path
here draw the same numbers.

The scenes it serves have no textures, no translucent material and no
shadow catcher (:func:`load` checks); those parts of the semantics are
left out.

``dtype`` (:func:`trace_paths`) computes the shading (materials, BRDF,
throughput, radiance) in another precision while the geometry stays
float32: ``torch.bfloat16`` is the benchmark's control.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

EPS = 1e-4
PI = 3.14159265358979323846
INV_SQRT3 = 0.5773502691896258
INF = 3.0e38
_M32 = 0xFFFFFFFF

# RNG purpose salts (the program's stream is keyed the same way).
P_AA_JITTER_X, P_AA_JITTER_Y, P_SUN_PHI, P_SUN_THETA = 0x01, 0x02, 0x03, 0x04
P_LOBE, P_BRDF_U, P_BRDF_V, P_RR = 0x06, 0x07, 0x08, 0x09


# --------------------------------------------------------------------------
# The scene: the courtyard of ``arch:<n_tris>``
# --------------------------------------------------------------------------

_LENGTH, _WIDTH, _HEIGHT, _STOREY = 30.0, 12.0, 12.0, 4.0
_COLS_PER_ROW, _COL_RADIUS, _SKYLIGHT = 10, 0.45, (0.7, 0.55)


class _Mesh:
    def __init__(self):
        self.pos, self.idx, self.nrm, self.mat = [], [], [], []
        self._v = 0

    def grid(self, origin, du, dv, nu, nv, normal, mat):
        nu, nv = max(int(nu), 1), max(int(nv), 1)
        u = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
        v = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        p = (np.asarray(origin, np.float32)[None, None]
             + uu[..., None] * np.asarray(du, np.float32)
             + vv[..., None] * np.asarray(dv, np.float32)).reshape(-1, 3)
        i0 = (np.arange(nu)[:, None] * (nv + 1)
              + np.arange(nv)[None, :]).reshape(-1)
        quad = np.stack([i0, i0 + nv + 1, i0 + nv + 2, i0, i0 + nv + 2,
                         i0 + 1], axis=1).reshape(-1, 3)
        nrm = np.broadcast_to(np.asarray(normal, np.float32),
                              (p.shape[0], 3)).copy()
        self._push(p, quad, nrm, mat)

    def cylinder(self, center, radius, height, segs, rings, mat):
        segs, rings = max(int(segs), 3), max(int(rings), 1)
        th = np.linspace(0.0, 2 * np.pi, segs + 1, dtype=np.float32)
        y = np.linspace(0.0, height, rings + 1, dtype=np.float32)
        tt, yy = np.meshgrid(th, y, indexing="ij")
        cx, cy, cz = center
        p = np.stack([cx + radius * np.cos(tt), cy + yy,
                      cz + radius * np.sin(tt)], axis=-1).reshape(-1, 3)
        n = np.stack([np.cos(tt), np.zeros_like(tt), np.sin(tt)],
                     axis=-1).reshape(-1, 3)
        i0 = (np.arange(segs)[:, None] * (rings + 1)
              + np.arange(rings)[None, :]).reshape(-1)
        quad = np.stack([i0, i0 + rings + 1, i0 + rings + 2, i0,
                         i0 + rings + 2, i0 + 1], axis=1).reshape(-1, 3)
        self._push(p.astype(np.float32), quad, n.astype(np.float32), mat)

    def _push(self, p, tri, n, mat):
        self.pos.append(p)
        self.idx.append((tri + self._v).astype(np.uint32))
        self.nrm.append(n)
        self.mat.append(np.full(tri.shape[0], mat, np.int32))
        self._v += p.shape[0]


def courtyard(n_tris: int) -> dict:
    """The courtyard scene ``arch:<n_tris>`` as flat float32 arrays: per
    triangle ``a``, ``e1``, ``e2`` and the vertex normals ``n0..n2``,
    ``mat`` per triangle, the material table, the camera and the sun."""
    hx, hz = _LENGTH / 2, _WIDTH / 2
    area = (_LENGTH * _WIDTH * 2 + 2 * _LENGTH * _HEIGHT * 0.8
            + 2 * _WIDTH * _HEIGHT
            + 2 * _COLS_PER_ROW * 2 * (2 * math.pi * _COL_RADIUS * _STOREY)
            + 2 * (_LENGTH * 2.0) * 2)
    d = math.sqrt(n_tris / (2.0 * area))
    m = _Mesh()
    m.grid((-hx, 0, -hz), (_LENGTH, 0, 0), (0, 0, _WIDTH),
           _LENGTH * d, _WIDTH * d, (0, 1, 0), 0)
    n_win, seg_w = 8, _LENGTH / 8
    for z, nz in ((-hz, 1.0), (hz, -1.0)):
        for storey in range(3):
            y0 = storey * _STOREY
            if storey == 0:
                m.grid((-hx, y0, z), (_LENGTH, 0, 0), (0, _STOREY, 0),
                       _LENGTH * d, _STOREY * d, (0, 0, nz), 1)
                continue
            wy0, wy1 = 1.2, 3.0
            for k in range(n_win):
                x0 = -hx + k * seg_w
                wx1 = x0 + seg_w - 0.6
                m.grid((x0, y0, z), (seg_w, 0, 0), (0, wy0, 0),
                       seg_w * d, wy0 * d, (0, 0, nz), 1)
                m.grid((x0, y0 + wy1, z), (seg_w, 0, 0),
                       (0, _STOREY - wy1, 0), seg_w * d,
                       (_STOREY - wy1) * d, (0, 0, nz), 1)
                m.grid((x0, y0 + wy0, z), (0.6, 0, 0), (0, wy1 - wy0, 0),
                       0.6 * d, (wy1 - wy0) * d, (0, 0, nz), 1)
                m.grid((wx1, y0 + wy0, z), (0.6, 0, 0), (0, wy1 - wy0, 0),
                       0.6 * d, (wy1 - wy0) * d, (0, 0, nz), 1)
    for x, nx in ((-hx, 1.0), (hx, -1.0)):
        m.grid((x, 0, -hz), (0, 0, _WIDTH), (0, _HEIGHT, 0),
               _WIDTH * d, _HEIGHT * d, (nx, 0, 0), 1)
    sx, sz = _SKYLIGHT[0] * _LENGTH, _SKYLIGHT[1] * _WIDTH
    rim_x, rim_z = (_LENGTH - sx) / 2, (_WIDTH - sz) / 2
    y = _HEIGHT
    m.grid((-hx, y, -hz), (_LENGTH, 0, 0), (0, 0, rim_z),
           _LENGTH * d, rim_z * d, (0, -1, 0), 1)
    m.grid((-hx, y, hz - rim_z), (_LENGTH, 0, 0), (0, 0, rim_z),
           _LENGTH * d, rim_z * d, (0, -1, 0), 1)
    m.grid((-hx, y, -hz + rim_z), (rim_x, 0, 0), (0, 0, sz),
           rim_x * d, sz * d, (0, -1, 0), 1)
    m.grid((hx - rim_x, y, -hz + rim_z), (rim_x, 0, 0), (0, 0, sz),
           rim_x * d, sz * d, (0, -1, 0), 1)
    col_z = _WIDTH / 2 - 2.2
    segs = max(int(2 * math.pi * _COL_RADIUS * d), 12)
    rings = max(int(_STOREY * d), 4)
    for zrow in (-col_z, col_z):
        for k in range(_COLS_PER_ROW):
            x = -hx + (k + 0.5) * _LENGTH / _COLS_PER_ROW
            for storey in range(2):
                m.cylinder((x, storey * _STOREY, zrow), _COL_RADIUS, _STOREY,
                           segs, rings, 2)
    slab_w = hz - col_z
    for z0 in (-hz, col_z):
        for ny in (1.0, -1.0):
            y_s = _STOREY + (0.0 if ny > 0 else -0.25)
            m.grid((-hx, y_s, z0), (_LENGTH, 0, 0), (0, 0, slab_w),
                   _LENGTH * d, slab_w * d, (0, ny, 0), 3)

    # + 0: the flattening's world transform (identity) turns -0 into +0.
    pos = np.concatenate(m.pos).astype(np.float32) + np.float32(0.0)
    idx = np.concatenate(m.idx).astype(np.int64)
    nrm = np.concatenate(m.nrm).astype(np.float32)
    mats = np.concatenate(m.mat)
    # Triangles grouped by material, in the order of the scene's primitives.
    order = np.concatenate([np.where(mats == k)[0] for k in range(4)])
    idx, mats = idx[order], mats[order]
    a = pos[idx[:, 0]]

    fwd = np.array([-1.0, 0.0, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    basis = np.stack([np.cross(fwd, up), up, -fwd], axis=1).astype(np.float32)
    sun_dir = np.array([-0.35, 0.85, -0.25], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    return dict(
        a=a, e1=pos[idx[:, 1]] - a, e2=pos[idx[:, 2]] - a,
        n0=nrm[idx[:, 0]], n1=nrm[idx[:, 1]], n2=nrm[idx[:, 2]],
        mat=mats.astype(np.int64),
        albedo=np.array([[0.55, 0.5, 0.45], [0.75, 0.7, 0.62],
                         [0.7, 0.68, 0.62], [0.6, 0.55, 0.5]], np.float32),
        roughness=np.array([0.6, 0.9, 0.5, 0.8], np.float32),
        metallic=np.zeros(4, np.float32),
        emissive=np.zeros((4, 3), np.float32),
        ior=np.full(4, 1.33, np.float32),
        opacity=np.ones(4, np.float32),
        shadow_catcher=np.zeros(4, np.float32),
        textured=False,
        cam_origin=np.array([hx - 3.0, 1.8, 0.0], np.float32),
        cam_basis=basis,
        tan_half_fov=np.float32(np.tan(1.0 * 0.5)),
        sun_dir=sun_dir,
        sun_energy=np.array([6.0, 5.6, 5.0], np.float32),
        sun_radius=np.float32(0.004732),
    )


SCENES = {"arch": courtyard}


def scene_arrays(spec: str) -> dict:
    """The arrays of a scene spec ``<kind>:<n_tris>``."""
    kind, _, n = spec.partition(":")
    if kind not in SCENES:
        raise ValueError(f"the reference has no scene {kind!r}")
    return SCENES[kind](int(n))


# --------------------------------------------------------------------------
# The BVH: Morton-ordered leaves of LEAF triangles under a complete binary
# tree in heap order (children of node i at 2i + 1 and 2i + 2), walked
# without a stack by escape links.
# --------------------------------------------------------------------------

LEAF = 4


class Bvh(NamedTuple):
    box: torch.Tensor  # [N, 6] node boxes (low corner, high corner), padded
    valid: torch.Tensor  # [N] bool: the node holds a triangle
    miss: torch.Tensor  # [N] int64: next node when the box is missed or left
    first_leaf: int  # heap index of the first leaf
    tris: torch.Tensor  # [L * LEAF, 9] (a, e1, e2) in leaf order
    count: torch.Tensor  # [L] triangles in each leaf
    tri: torch.Tensor  # [L * LEAF] scene index of each leaf slot (0 on padding)


def _morton(x):
    """30-bit Morton codes of points in [0, 1)^3."""
    q = np.clip((x * 1024.0).astype(np.int64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_bvh(a: np.ndarray, e1: np.ndarray, e2: np.ndarray, device) -> Bvh:
    n = a.shape[0]
    b, c = a + e1, a + e2
    tlo = np.minimum(np.minimum(a, b), c)
    thi = np.maximum(np.maximum(a, b), c)
    cen = 0.5 * (tlo + thi)
    span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
    order = np.argsort(_morton((cen - cen.min(0)) / span * 0.999999),
                       kind="stable")
    n_leaves = -(-n // LEAF)
    depth = max(int(math.ceil(math.log2(n_leaves))), 0)
    width = 1 << depth
    slots = width * LEAF
    tri = np.zeros(slots, np.int64)
    tri[:n] = order
    used = np.arange(slots) < n
    lo = np.where(used[:, None], tlo[tri], np.inf).reshape(width, LEAF, 3).min(1)
    hi = np.where(used[:, None], thi[tri], -np.inf).reshape(width, LEAF, 3).max(1)
    # Padding: MT's barycentric bias accepts hits a hair outside a triangle.
    pad = 2e-4 * np.max(np.where(np.isfinite(hi - lo), hi - lo, 0.0), axis=1,
                        keepdims=True) + 1e-6
    lo, hi = lo - pad, hi + pad
    valid = np.arange(width) < n_leaves
    levels_lo, levels_hi, levels_valid = [lo], [hi], [valid]
    for _ in range(depth):
        lo = np.minimum(lo[0::2], lo[1::2])
        hi = np.maximum(hi[0::2], hi[1::2])
        valid = valid[0::2]
        levels_lo.append(lo)
        levels_hi.append(hi)
        levels_valid.append(valid)
    node_lo = np.concatenate(levels_lo[::-1]).astype(np.float32)
    node_hi = np.concatenate(levels_hi[::-1]).astype(np.float32)
    node_valid = np.concatenate(levels_valid[::-1])
    n_nodes = node_lo.shape[0]
    # The escape link: a left child's right sibling, else the parent's
    # link; a sibling with no triangle is skipped (parents come first).
    miss = np.full(n_nodes, -1, np.int64)
    for i in range(1, n_nodes):
        up = miss[(i - 1) // 2]
        miss[i] = i + 1 if i % 2 == 1 and node_valid[i + 1] else up
    count = np.clip(n - np.arange(width) * LEAF, 0, LEAF)
    dev = dict(device=device)
    return Bvh(
        box=torch.tensor(np.concatenate([node_lo, node_hi], 1), **dev),
        valid=torch.tensor(node_valid, **dev), miss=torch.tensor(miss, **dev),
        first_leaf=width - 1,
        tris=torch.tensor(np.concatenate([a[tri], e1[tri], e2[tri]], 1),
                          **dev),
        count=torch.tensor(count, **dev), tri=torch.tensor(tri, **dev))


# --------------------------------------------------------------------------
# Vector math, RNG, camera
# --------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(a):
    return a * torch.rsqrt(torch.clamp(dot(a, a)[..., None], min=1e-20))


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(incident, normal):
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _lcg(v):
    return (v * 1664525 + 1013904223) & _M32


def uniform(pixel_id, sample_id, bounce: int, purpose: int, seed: int):
    """PCG4D counter RNG: a uniform in [0, 1) per (pixel, sample, bounce,
    purpose, seed), 24 bits."""
    v0 = pixel_id.to(torch.int64) & _M32
    v1 = sample_id.to(torch.int64) & _M32
    v0, v1 = torch.broadcast_tensors(v0, v1)
    v2 = torch.full_like(v0, (((int(bounce) & _M32) << 8) & _M32) | purpose)
    v3 = torch.full_like(v0, (int(seed) & _M32) ^ 0x9E3779B9)
    v0, v1, v2, v3 = _lcg(v0), _lcg(v1), _lcg(v2), _lcg(v3)
    for shift in (True, False):
        v0 = (v0 + _mul32(v1, v3)) & _M32
        v1 = (v1 + _mul32(v2, v0)) & _M32
        v2 = (v2 + _mul32(v0, v1)) & _M32
        v3 = (v3 + _mul32(v1, v2)) & _M32
        if shift:
            v0, v1, v2, v3 = (v ^ (v >> 16) for v in (v0, v1, v2, v3))
    return (v0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def orthonormal_basis(normal):
    nx, ny = normal[..., 0].abs(), normal[..., 1].abs()
    use_x = nx < INV_SQRT3
    use_y = ~use_x & (ny < INV_SQRT3)
    one, zero = torch.ones_like(nx), torch.zeros_like(nx)
    axis = torch.stack([torch.where(use_x, one, zero),
                        torch.where(use_y, one, zero),
                        torch.where(use_x | use_y, zero, one)], dim=-1)
    tangent = normalize(cross(normal, axis))
    return tangent, cross(normal, tangent)


def cone_vec(u, cos_theta, axis):
    phi = u * (2.0 * PI)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tangent, binormal = orthonormal_basis(axis)
    return (tangent * (torch.cos(phi) * sin_theta)[..., None]
            + binormal * (torch.sin(phi) * sin_theta)[..., None]
            + axis * cos_theta[..., None])


def camera_rays(sc: dict, pixel_ids, sample_ids, width: int, height: int,
                seed: int, first_sample_centered: bool):
    x = (pixel_ids % width).to(torch.float32)
    y = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    jx = uniform(pixel_ids, sample_ids, 0, P_AA_JITTER_X, seed)
    jy = uniform(pixel_ids, sample_ids, 0, P_AA_JITTER_Y, seed)
    if first_sample_centered:
        centered = sample_ids == 0
        jx = torch.where(centered, torch.zeros_like(jx), jx)
        jy = torch.where(centered, torch.zeros_like(jy), jy)
    ndc_x = ((x + jx) / width) * 2.0 - 1.0
    ndc_y = -(((y + jy) / height) * 2.0 - 1.0)
    tan_half = sc["tan_half_fov"]
    d_cam = normalize(torch.stack([tan_half * ndc_x * (width / height),
                                   tan_half * ndc_y,
                                   -torch.ones_like(ndc_x)], dim=-1))
    b = sc["cam_basis"]
    d_world = normalize(torch.stack([dot(d_cam, b[i]) for i in range(3)], -1))
    return sc["cam_origin"].expand(d_world.shape), d_world


# --------------------------------------------------------------------------
# Intersection
# --------------------------------------------------------------------------

def moller_trumbore(orig, dirn, a, e1, e2):
    pvec = cross(dirn, e2)
    det = dot(e1, pvec)
    degenerate = det == 0.0
    inv_det = 1.0 / torch.where(degenerate, torch.ones_like(det), det)
    tvec = orig - a
    beta = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    gamma = dot(dirn, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = ((beta >= -EPS) & (beta <= 1.0 + EPS) & (gamma >= -EPS)
          & (beta + gamma <= 1.0 + EPS) & (t >= 0.0) & torch.isfinite(t)
          & ~degenerate)
    return torch.where(ok, t, torch.full_like(t, INF)), beta, gamma, ok


# Walk steps between two compactions of the rays still walking.
BLOCK = 8


@torch.no_grad()
def walk(bvh: Bvh, orig, dirn, any_hit: bool = False):
    """Closest hit (or, with ``any_hit``, any hit) of every ray:
    ``(t, tri, hit, nodes, tests)`` with ``t = INF`` and ``tri = 0`` on a
    miss; ``nodes`` and ``tests`` count each ray's boxes visited (those of
    the tree's empty padding left out) and triangles tested.  Rays that
    have ended are dropped every ``BLOCK`` steps; in between they step as
    the identity."""
    r, dev = orig.shape[0], orig.device
    best_t = torch.full((r,), INF, device=dev)
    best_slot = torch.zeros((r,), dtype=torch.int64, device=dev)
    nodes = torch.zeros((r,), dtype=torch.int64, device=dev)
    tests = torch.zeros((r,), dtype=torch.int64, device=dev)
    k = torch.arange(LEAF, device=dev)
    # The rays still walking, and their state.
    lanes = torch.arange(r, device=dev)
    o, d = orig, dirn
    inv = 1.0 / dirn
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    bt, bs = best_t.clone(), best_slot.clone()
    nn, tt = nodes.clone(), tests.clone()
    while lanes.numel():
        for _ in range(BLOCK):
            walking = node >= 0
            nd = node.clamp(min=0)
            box = bvh.box[nd]
            t0 = (box[:, :3] - o) * inv
            t1 = (box[:, 3:] - o) * inv
            tmin, tmax = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = torch.where(torch.isnan(tmin), float("-inf"), tmin).amax(-1)
            far = torch.where(torch.isnan(tmax), float("inf"), tmax).amin(-1)
            real = bvh.valid[nd] & walking
            enter = real & (far >= near.clamp(min=0.0)) & (near < bt)
            leaf = nd >= bvh.first_leaf
            nn += real
            at_leaf = enter & leaf
            li = (nd - bvh.first_leaf).clamp(min=0)
            slot = li[:, None] * LEAF + k
            tri = bvh.tris[slot]
            t, _, _, ok = moller_trumbore(o[:, None, :], d[:, None, :],
                                          tri[..., 0:3], tri[..., 3:6],
                                          tri[..., 6:9])
            n_in = torch.where(at_leaf, bvh.count[li], 0)
            t = torch.where((k < n_in[:, None]) & ok, t, INF)
            j = torch.argmin(t, dim=1, keepdim=True)
            lt = t.gather(1, j)[:, 0]
            closer = lt < bt
            bs = torch.where(closer, slot.gather(1, j)[:, 0], bs)
            bt = torch.where(closer, lt, bt)
            tt += n_in
            step = torch.where(enter & ~leaf, 2 * nd + 1, bvh.miss[nd])
            if any_hit:
                step = torch.where(bt < INF, -1, step)
            node = torch.where(walking, step, node)
        done = node < 0
        ended = lanes[done]
        best_t[ended], best_slot[ended] = bt[done], bs[done]
        nodes[ended], tests[ended] = nn[done], tt[done]
        keep = ~done
        lanes, o, d, inv, node = (lanes[keep], o[keep], d[keep], inv[keep],
                                  node[keep])
        bt, bs, nn, tt = bt[keep], bs[keep], nn[keep], tt[keep]
    hit = best_t < INF
    tri = torch.where(hit, bvh.tri[best_slot], torch.zeros_like(best_slot))
    return best_t, tri, hit, nodes, tests


class Hit(NamedTuple):
    hit: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    mat: torch.Tensor


def closest_hit(sc: dict, bvh: Bvh, orig, dirn, counts=None) -> Hit:
    """The closest hit, resolved as the upstream's scene intersect does:
    the winner's Moller-Trumbore test recomputed, the position and the
    interpolated vertex normal at its barycentrics."""
    _, tri, hit, nodes, tests = walk(bvh, orig, dirn)
    if counts is not None:
        counts["nodes"] += int(nodes.sum())
        counts["tests"] += int(tests.sum())
        counts["rays"] += orig.shape[0]
    a, e1, e2 = sc["a"][tri], sc["e1"][tri], sc["e2"][tri]
    _, beta, gamma, _ = moller_trumbore(orig, dirn, a, e1, e2)
    zero = torch.zeros_like(beta)
    beta, gamma = torch.where(hit, beta, zero), torch.where(hit, gamma, zero)
    w0 = (1.0 - beta - gamma)[..., None]
    normal = normalize(sc["n0"][tri] * w0 + sc["n1"][tri] * beta[..., None]
                       + sc["n2"][tri] * gamma[..., None])
    position = a + e1 * beta[..., None] + e2 * gamma[..., None]
    return Hit(hit, position, normal, sc["mat"][tri])


def any_hit(bvh: Bvh, orig, dirn, counts=None):
    _, _, hit, nodes, tests = walk(bvh, orig, dirn, any_hit=True)
    if counts is not None:
        counts["nodes"] += int(nodes.sum())
        counts["tests"] += int(tests.sum())
        counts["rays"] += orig.shape[0]
    return hit


# --------------------------------------------------------------------------
# Shading
# --------------------------------------------------------------------------

def _fresnel(outcoming, incoming, ior):
    halfway = normalize(outcoming + incoming)
    cos_theta = dot(outcoming, halfway)
    f0 = (ior - 1.0) / (ior + 1.0)
    f0 = f0 * f0
    return lerp(f0, 1.0, torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0))


def _pdf_specular(normal, outcoming, incoming, roughness):
    a = roughness * roughness
    a = a * a
    halfway = normalize(outcoming + incoming)
    cos_phi = dot(normal, halfway)
    denom = lerp(1.0, a, cos_phi * cos_phi)
    n_dot_i = dot(normal, incoming)
    n_dot_o = dot(normal, outcoming)
    ggx = n_dot_i * a / torch.clamp(PI * denom * denom, min=EPS)
    r = roughness + 1.0
    k = (r * r) / 8.0

    def g1(cos_theta):
        return cos_theta / torch.clamp(lerp(k, 1.0, cos_theta), min=EPS)

    geo = g1(n_dot_o) * g1(n_dot_i)
    return (ggx * geo) / torch.clamp(4.0 * n_dot_o * n_dot_i, min=EPS)


def _brdf_and_pdfs(normal, outcoming, incoming, albedo, metallic, roughness):
    diffuse_pdf = dot(normal, incoming) / PI
    diffuse_brdf = diffuse_pdf[..., None] * albedo
    specular_pdf = _pdf_specular(normal, outcoming, incoming, roughness)
    specular_brdf = specular_pdf[..., None].expand(albedo.shape)
    fres = lerp(torch.full_like(albedo, 0.04), albedo, metallic[..., None])
    halfway = normalize(outcoming + incoming)
    cos_theta = dot(outcoming, halfway)
    fres = lerp(fres, torch.ones_like(fres),
                torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0)[..., None])
    diffuse_brdf = diffuse_brdf * (1.0 - metallic[..., None])
    return lerp(diffuse_brdf, specular_brdf, fres), diffuse_pdf, specular_pdf


def _importance_specular(u1, u2, normal, outcoming, roughness):
    a = roughness * roughness
    a = a * a
    cos_theta = torch.sqrt(torch.clamp((1.0 - u1) / (1.0 + (a - 1.0) * u1),
                                       0.0, 1.0))
    return reflect(-outcoming, cone_vec(u2, cos_theta, normal))


def trace_paths(sc: dict, bvh: Bvh, sem: dict, width: int, height: int,
                bounces: int, seed: int, pixel_ids, sample_ids,
                params: Optional[Dict[str, torch.Tensor]] = None,
                dtype=torch.float32, counts=None):
    """``(radiance [R, 3] float32, alpha [R])`` of one path per (pixel,
    sample).  ``params`` replaces the ``albedo`` / ``emissive`` tables
    (autograd flows into them through the shading; the hits and sampled
    directions carry none).  ``sem``: the configuration's semantics (the
    upstream worker's constants).  ``dtype``: the shading's precision.
    ``counts``: a dict whose ``nodes``, ``tests`` and ``rays`` the walks
    add to."""
    dev = pixel_ids.device
    r = pixel_ids.shape[0]
    params = params or {}
    albedo_t = params.get("mat_albedo", sc["albedo"]).to(dtype)
    emissive_t = params.get("mat_emissive", sc["emissive"]).to(dtype)
    rough_t, metal_t = sc["roughness"].to(dtype), sc["metallic"].to(dtype)
    ior_t = sc["ior"]
    sun_energy = sc["sun_energy"].to(dtype)
    orig, dirn = camera_rays(sc, pixel_ids, sample_ids, width, height, seed,
                             sem["first_sample_centered"])
    orig = orig.contiguous()
    radiance = torch.zeros((r, 3), dtype=dtype, device=dev)
    throughput = torch.ones((r, 3), dtype=dtype, device=dev)
    alpha = torch.zeros((r,), device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    bounce = torch.full((r,), bounces, dtype=torch.int32, device=dev)

    for it in range(bounces):
        if not bool(alive.any()):
            break

        def u(purpose):
            return uniform(pixel_ids, sample_ids, it, purpose, seed)

        lanes = alive.nonzero()[:, 0]
        h = closest_hit(sc, bvh, orig[lanes], dirn[lanes], counts)
        hit = torch.zeros((r,), dtype=torch.bool, device=dev)
        hit[lanes] = h.hit
        position = torch.zeros((r, 3), device=dev)
        position[lanes] = h.position
        n_interp = torch.zeros((r, 3), device=dev)
        n_interp[lanes] = h.normal
        mat = torch.zeros((r,), dtype=torch.int64, device=dev)
        mat[lanes] = h.mat

        cos_t = torch.cos(u(P_SUN_THETA) * sc["sun_radius"])
        d_sun = cone_vec(u(P_SUN_PHI), cos_t, sc["sun_dir"].expand(dirn.shape))
        sun_exists = dot(n_interp, d_sun) > 0.0
        shadow_hit = torch.zeros((r,), dtype=torch.bool, device=dev)
        cast = (alive & hit & sun_exists).nonzero()[:, 0]
        if cast.numel():
            shadow_hit[cast] = any_hit(
                bvh, (position[cast] + d_sun[cast] * EPS).contiguous(),
                d_sun[cast].contiguous(), counts)

        miss = alive & ~hit
        radiance = torch.where(miss[..., None], radiance + throughput * 1.0,
                               radiance)
        alpha = torch.where(miss, 1.0, alpha)
        live = alive & hit
        alpha = torch.where(hit, 1.0, alpha)
        albedo, emissive = albedo_t[mat], emissive_t[mat]
        roughness_m, metallic = rough_t[mat], metal_t[mat]
        radiance = torch.where(
            live[..., None],
            radiance + throughput * (emissive * sem["emissive_scale"]),
            radiance)
        # The flat tangent-space normal (0, 0, 1) through the TBN basis.
        n_shade = normalize(n_interp)
        outcoming = -dirn
        backface = live & (dot(n_shade, outcoming) <= 0.0)
        roughness = torch.clamp(roughness_m, min=sem["roughness_floor"])
        mirror = reflect(-outcoming, n_shade)
        spec_prob = torch.maximum(_fresnel(outcoming, mirror, ior_t[mat]),
                                  metal_t[mat].float()).detach()
        specular_sample = u(P_LOBE) < spec_prob
        shading = live & ~backface

        low = (lambda x: x.to(dtype))
        nee_ok = (shading & sun_exists & (dot(n_shade, d_sun) > 0.0)
                  & ~shadow_hit)
        brdf, _, _ = _brdf_and_pdfs(low(n_shade), low(outcoming), low(d_sun),
                                    albedo, metallic, roughness)
        direct_in = sun_energy.expand(brdf.shape)
        direct_out = brdf * direct_in
        if sem["clamp_direct_to_light"]:
            direct_out = torch.minimum(torch.clamp(direct_out, min=0.0),
                                       direct_in)
        radiance = torch.where(nee_ok[..., None],
                               radiance + throughput * direct_out, radiance)

        u1, u2 = u(P_BRDF_U), u(P_BRDF_V)
        d_spec = _importance_specular(u1, u2, n_shade, outcoming,
                                      roughness.float().detach())
        d_diff = cone_vec(u2, torch.sqrt(torch.clamp(u1, 0.0, 1.0)), n_shade)
        d_new = torch.where(specular_sample[..., None], d_spec, d_diff).detach()
        up_facing = dot(n_shade, d_new) > 0.0
        brdf_i, diffuse_pdf, specular_pdf = _brdf_and_pdfs(
            low(n_shade), low(outcoming), low(d_new), albedo, metallic,
            roughness)
        pdf = lerp(diffuse_pdf, specular_pdf, low(spec_prob))
        factor = brdf_i / torch.clamp(pdf, min=EPS)[..., None]
        new_throughput = torch.clamp(throughput * factor, 0.0,
                                     sem["throughput_clamp"])
        rr_active = bounce < (bounces - sem["rr_after_bounces"])
        p_survive = new_throughput.amax(-1)
        rr_kill = rr_active & (u(P_RR) > p_survive.float())
        new_throughput = torch.where(
            (rr_active & ~rr_kill)[..., None],
            new_throughput / torch.clamp(p_survive, min=EPS)[..., None],
            new_throughput)
        new_bounce = bounce - 1
        continues = shading & up_facing & ~rr_kill & (new_bounce > 0)
        terminated = shading & (~up_facing | rr_kill | (new_bounce <= 0))
        orig = torch.where(continues[..., None], position + d_new * EPS,
                           orig).contiguous()
        dirn = torch.where(continues[..., None], d_new, dirn).contiguous()
        throughput = torch.where(continues[..., None], new_throughput,
                                 throughput)
        bounce = torch.where(continues, new_bounce, bounce)
        alive = live & continues & ~backface & ~terminated
    return radiance.float(), alpha


def load(spec: str, device) -> tuple:
    """``(scene tensors, BVH)`` of a scene spec on ``device``."""
    arrays = scene_arrays(spec)
    if (arrays["textured"] or (arrays["opacity"] < 1.0 - 1e-4).any()
            or arrays["shadow_catcher"].any()):
        raise ValueError(f"{spec}: the reference serves untextured, opaque "
                         "scenes without shadow catchers")
    bvh = build_bvh(arrays["a"], arrays["e1"], arrays["e2"], device)
    sc = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()
          if isinstance(v, (np.ndarray, np.generic))}
    return sc, bvh


def fold_mean(colors, alphas):
    """The running mean of samples ``colors`` [S, P, 3] / ``alphas`` [S,
    P], folded one sample at a time in float32 as a progressive render
    folds (``(c * n + x) * (1 / (n + 1))``): the mean after each sample,
    ``[S, P, 3]`` and ``[S, P]``."""
    c = torch.zeros_like(colors[0])
    a = torch.zeros_like(alphas[0])
    out_c, out_a = [], []
    for n in range(colors.shape[0]):
        inv = float(np.float32(1.0) / np.float32(n + 1))
        c = (c * float(n) + colors[n]) * inv
        a = (a * float(n) + alphas[n]) * inv
        out_c.append(c)
        out_a.append(a)
    return torch.stack(out_c), torch.stack(out_a)
