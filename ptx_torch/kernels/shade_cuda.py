"""The shade stage: two hand-written CUDA kernels, their plain torch
versions, and the integrator that runs them (port of
``ptx/kernels/shade_pallas.py``).  The kernels compute no gradient: the
fast differentiable path (``ptx_torch.diff.fast``) records the fused
step's trace results and runs its backward through the plain shade
stage.

* :func:`shadow_rays` - ``csrc/shade.cu::ptx_shadow_rays``, plain version
  :func:`_shadow_rays`: the sun's cone sample (:func:`_sun_sample`) and the
  shadow rays, parked and packed as the any sweep reads them.
* :func:`shade` - ``csrc/shade.cu::ptx_shade``, plain version :func:`_shade`:
  the whole shading stage of one bounce, with the Pallas kernel's semantics
  (dead lanes' origins become 0; ``alive = alive & (passthrough |
  continues)``).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (and counts the launch in
``_build.LAUNCHES``) or raises.  The kernels read the wavefront's own
[R] / [R, 3] tensors in place; the TPU kernels' 128-lane planes are not
built.  The plain versions run the Pallas kernels' operations in the same
order on component tensors, so a kernel and its plain version agree bit for
bit on the card.  ``x / PI`` is taken as ``x * f32(1 / PI)``, which is what
XLA makes of a division by a constant and what torch does on the card for a
division by a python scalar.

:func:`make_pallas_integrator` is ``render``'s "pallas" shader: per bounce,
park, closest hit, material fetch, environment, the shadow-ray kernel (sun
sample, shadow rays parked on ``exists & hit`` and packed), any hit, shade
kernel; the bounces run on the device loop (``integrator/graphs.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from ptx_torch import sampling
from ptx_torch.integrator.wavefront import (
    RayState,
    _env_radiance,
    initial_state,
    max_iterations,
    run_forward,
)
from ptx_torch.kernels import _build, intersect_cuda, sorting
from ptx_torch.kernels.tiles import RB, _pack_rays
from ptx_torch.scene import textures
from ptx_torch.config import RenderConfig
from ptx_torch.scene.flatten import FlatScene, SceneStatic

LANES = 128
EPS = 1e-4
PI = 3.14159265358979
INV_PI = float(np.float32(1.0) / np.float32(PI))
INV_SQRT3 = 0.5773502691896258


# --------------------------------------------------------------------------
# Helpers on (x, y, z) component tensors, as the Pallas kernels' planes
# --------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _normalize(a):
    inv = torch.rsqrt(torch.clamp(a[0] * a[0] + a[1] * a[1] + a[2] * a[2],
                                  min=1e-20))
    return a[0] * inv, a[1] * inv, a[2] * inv


def _cone(u, cos_theta, ax):
    """rand_cone_vec about the axis ``ax``, with the reference's
    non-parallel-axis tangent frame (util/rand_cone_vec.cpp:20-33)."""
    phi = u * (2.0 * PI)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    lx = torch.cos(phi) * sin_theta
    ly = torch.sin(phi) * sin_theta
    lz = cos_theta
    use_x = torch.abs(ax[0]) < INV_SQRT3
    use_y = ~use_x & (torch.abs(ax[1]) < INV_SQRT3)
    e = (torch.where(use_x, 1.0, 0.0), torch.where(use_y, 1.0, 0.0),
         torch.where(use_x | use_y, 0.0, 1.0))
    t = _normalize(_cross(ax, e))
    b = _cross(ax, t)
    return tuple(t[k] * lx + b[k] * ly + ax[k] * lz for k in range(3))


def _fresnel(o, i, ior):
    h = _normalize(tuple(o[k] + i[k] for k in range(3)))
    cos_t = _dot(o, h)
    f0 = (ior - 1.0) / (ior + 1.0)
    f0 = f0 * f0
    p = torch.clamp(1.0 - cos_t, min=0.0)
    p5 = p * p * p * p * p
    return f0 + (1.0 - f0) * p5


def _smith_g1(cos_theta, k):
    return cos_theta / torch.clamp(k + (1.0 - k) * cos_theta, min=EPS)


def _brdf_block(n, o, i, alb, metal, rough):
    """shading_worker.cpp:118-139: (brdf (r, g, b), diffuse_pdf,
    specular_pdf)."""
    n_dot_i = _dot(n, i)
    n_dot_o = _dot(n, o)
    diffuse_pdf = n_dot_i * INV_PI
    a = rough * rough
    a = a * a
    h = _normalize(tuple(o[k] + i[k] for k in range(3)))
    cos_phi = _dot(n, h)
    denom = 1.0 + (a - 1.0) * cos_phi * cos_phi
    dist = n_dot_i * a / torch.clamp(PI * denom * denom, min=EPS)
    r1 = rough + 1.0
    k = (r1 * r1) / 8.0
    geo = _smith_g1(n_dot_o, k) * _smith_g1(n_dot_i, k)
    specular_pdf = (dist * geo) / torch.clamp(4.0 * n_dot_o * n_dot_i, min=EPS)
    cos_oh = _dot(o, h)
    p = torch.clamp(1.0 - cos_oh, min=0.0)
    p5 = p * p * p * p * p
    inv_m = 1.0 - metal

    def channel(c):
        fres = (0.04 + (c - 0.04) * metal) * (1.0 - p5) + p5
        diffuse = diffuse_pdf * c * inv_m
        return diffuse + (specular_pdf - diffuse) * fres

    return tuple(channel(c) for c in alb), diffuse_pdf, specular_pdf


def _stack(v):
    return torch.stack(v, dim=-1)


# --------------------------------------------------------------------------
# Kernel arguments
# --------------------------------------------------------------------------


class _Col(ctypes.Structure):
    """One per-ray input: element (or row) i at p[i * s]."""

    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_longlong)]


class _ShadowArgs(ctypes.Structure):
    _fields_ = [
        *((name, _Col) for name in ("pix", "smp", "alive", "hit", "normal",
                                    "position")),
        ("out_dir", ctypes.c_void_p), ("out_exists", ctypes.c_void_p),
        ("out_rays", ctypes.c_void_p),
        ("n", ctypes.c_longlong), ("n_pad", ctypes.c_longlong),
        ("it", ctypes.c_uint32), ("seed", ctypes.c_uint32),
        ("sun_dir", ctypes.c_float * 3), ("angular_radius", ctypes.c_float),
        ("park", ctypes.c_int), ("park_org", ctypes.c_float * 3),
        ("park_dir", ctypes.c_float),
    ]


_SHADE_COLS = (
    "pix", "smp", "dirn", "radiance", "throughput", "alpha", "alive", "bounce",
    "hit", "position", "normal", "tangent",
    "albedo", "opacity", "roughness", "metallic", "ior", "catcher", "emissive",
    "tnormal", "env", "d_sun", "sun_exists", "shadow_hit",
)


class _ShadeArgs(ctypes.Structure):
    _fields_ = [
        *((name, _Col) for name in _SHADE_COLS),
        *((name, ctypes.c_void_p) for name in (
            "out_orig", "out_dirn", "out_radiance", "out_throughput",
            "out_alpha", "out_alive", "out_bounce")),
        ("n", ctypes.c_longlong), ("it", ctypes.c_uint32),
        ("seed", ctypes.c_uint32), ("bounces", ctypes.c_int),
        ("rr_limit", ctypes.c_int), ("alpha_on_miss", ctypes.c_float),
        ("emissive_scale", ctypes.c_float), ("roughness_floor", ctypes.c_float),
        ("throughput_clamp", ctypes.c_float), ("clamp_direct", ctypes.c_int),
        ("indirect_clamp", ctypes.c_int), ("sun_energy", ctypes.c_float * 3),
    ]


def _col(t, name, n, dtype, vec3=False):
    """The (pointer, row stride) of an [n] or [n, 3] tensor; a [n, 3] view
    whose components are not adjacent is copied first."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    shape = (n, 3) if vec3 else (n,)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if vec3 and t.stride(1) != 1:
        t = t.contiguous()
    return t, _Col(t.data_ptr(), t.stride(0))


def _u32(v: int) -> int:
    return int(v) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Sun
# --------------------------------------------------------------------------


def _sun_sample(seed, it, pix, smp, alive, normal, position, sun):
    """The sun's cone sample (the JAX package's ``_sun_kernel``).  ``sun``:
    (dir x, y, z, angular radius) as python floats.  Returns ``(d_sun
    [R, 3], shadow_org [R, 3], exists [R] bool)``."""
    u_theta = sampling.uniform(pix, smp, it, sampling.P_SUN_THETA, seed)
    u_phi = sampling.uniform(pix, smp, it, sampling.P_SUN_PHI, seed)
    cos_t = torch.cos(u_theta * sun[3])
    d = _cone(u_phi, cos_t, tuple(torch.full_like(u_phi, v) for v in sun[:3]))
    n, p = normal.unbind(-1), position.unbind(-1)
    exists = (_dot(n, d) > 0.0) & alive
    org = tuple(p[k] + d[k] * EPS for k in range(3))
    return _stack(d), _stack(org), exists


def _shadow_rays(seed, it, pix, smp, alive, hit, normal, position, sun, park):
    """Plain version of ``ptx_shadow_rays``: :func:`_sun_sample`, then the
    lanes without ``exists & hit`` parked (``sorting.park_with`` when
    ``park`` is the scene's ``sorting.park_constants``; None: no parking),
    then the rows of ``tiles._pack_rays``.  Returns ``(d_sun [R, 3],
    exists [R] bool, rays [R_pad, 8])``."""
    d_sun, org, exists = _sun_sample(seed, it, pix, smp, alive, normal,
                                     position, sun)
    dirn = d_sun
    if park is not None:
        org, dirn = sorting.park_with(org, d_sun, exists & hit, park)
    return d_sun, exists, _pack_rays(org, dirn)[0]


def shadow_rays(seed, it, pix, smp, alive, hit, normal, position, sun, park):
    """The sun's cone sample and the shadow rays of a wavefront, packed for
    the any sweep (arguments and result of :func:`_shadow_rays`): the kernel
    for CUDA tensors, :func:`_shadow_rays` for CPU tensors."""
    if _build.on_cpu(pix, smp, alive, hit, normal, position):
        return _shadow_rays(seed, it, pix, smp, alive, hit, normal, position,
                            sun, park)
    n = pix.shape[0]
    n_pad = -(-n // RB) * RB
    ins = [_col(pix, "pix", n, torch.int32), _col(smp, "smp", n, torch.int32),
           _col(alive, "alive", n, torch.bool), _col(hit, "hit", n, torch.bool),
           _col(normal, "normal", n, torch.float32, True),
           _col(position, "position", n, torch.float32, True)]
    dev = pix.device
    d_sun = torch.empty((n, 3), dtype=torch.float32, device=dev)
    exists = torch.empty((n,), dtype=torch.bool, device=dev)
    rays = torch.empty((n_pad, 8), dtype=torch.float32, device=dev)
    if rays.data_ptr() % 32:
        raise ValueError("rays: not 32-byte aligned")
    p_org, p_dir = park if park is not None else ((0.0, 0.0, 0.0), 0.0)
    args = _ShadowArgs(*(c for _, c in ins), d_sun.data_ptr(),
                       exists.data_ptr(), rays.data_ptr(), n, n_pad, _u32(it),
                       _u32(seed), (ctypes.c_float * 3)(*sun[:3]), sun[3],
                       int(park is not None), (ctypes.c_float * 3)(*p_org),
                       p_dir)
    _build.launch(_build.load().ptx_shadow_rays, ctypes.byref(args))
    _build.LAUNCHES["sun"] += 1
    return d_sun, exists, rays


# --------------------------------------------------------------------------
# Shade
# --------------------------------------------------------------------------


def _shade(cfg: RenderConfig, it: int, state: RayState, h, mat, env,
           sun=None, sun_energy=None) -> RayState:
    """Plain version of ``ptx_shade``: one bounce of shading.  ``h``: the
    closest :class:`Hit`; ``mat``: ``textures.material_lookup``'s dict;
    ``env``: [R, 3] environment radiance of ``state.dirn``; ``sun``:
    ``(d_sun [R, 3], exists [R] bool, shadow_hit [R] bool)`` and
    ``sun_energy`` three python floats, or None for a scene without a sun."""
    q = cfg.quirks
    pix, smp = state.pixel_ids, state.sample_ids

    def u(purpose):
        return sampling.uniform(pix, smp, it, purpose, cfg.seed)

    alive_in = state.alive
    hit = h.hit & alive_in
    miss = alive_in & ~hit
    d = state.dirn.unbind(-1)
    thr = state.throughput.unbind(-1)

    # miss -> environment (shading_worker.cpp:27-41)
    mf = miss.to(torch.float32)
    rad, env3 = state.radiance.unbind(-1), env.unbind(-1)
    rad = tuple(rad[k] + mf * thr[k] * env3[k] for k in range(3))
    alpha_on_miss = 0.0 if cfg.transparent_background else 1.0
    alpha = torch.where(miss, alpha_on_miss, state.alpha)
    alive = alive_in & hit
    alpha = torch.where(hit, 1.0, alpha)

    # emissive (x scale quirk)
    af = alive.to(torch.float32)
    es = q.emissive_scale
    emi = mat["emissive"].unbind(-1)
    rad = tuple(rad[k] + af * thr[k] * emi[k] * es for k in range(3))

    # stochastic opacity passthrough (no bounce consumed)
    opacity = mat["opacity"]
    translucent = torch.abs(opacity - 1.0) > EPS
    passthrough = alive & translucent & (u(sampling.P_OPACITY) > opacity)

    # shading normal: TBN + normal map (intersect.cpp:71-77)
    n = _normalize(h.normal.unbind(-1))
    tg = _normalize(h.tangent.unbind(-1))
    b = _cross(n, tg)
    tn = mat["tangent_normal"].unbind(-1)
    s = _normalize(tuple(tg[k] * tn[0] + b[k] * tn[1] + n[k] * tn[2]
                         for k in range(3)))
    o = tuple(-x for x in d)

    n_dot_o = _dot(s, o)
    backface = alive & ~passthrough & (n_dot_o <= 0.0)

    # shadow catcher at the first bounce (shading_worker.cpp:74-105)
    bounce = state.bounce
    is_catcher = mat["shadow_catcher"] > 0.5
    first_bounce = bounce == cfg.bounces
    catcher_now = alive & ~passthrough & ~backface & is_catcher & first_bounce
    if sun is not None:
        sd = sun[0].unbind(-1)
        sun_exists, shadow_hit = sun[1], sun[2]
        n_dot_sun = _dot(s, sd)
        catcher_lit = (catcher_now & sun_exists & (n_dot_sun > 0.0)
                       & ~shadow_hit)
    else:
        catcher_lit = torch.zeros_like(catcher_now)
    catcher_shadowed = catcher_now & ~catcher_lit
    csf = 1.0 - catcher_shadowed.to(torch.float32)
    rad = tuple(x * csf for x in rad)
    alpha = torch.where(catcher_shadowed, 1.0, alpha)
    passthrough = passthrough | catcher_lit

    # lobe selection; mirror = reflect(-out, n)
    rough = torch.clamp(mat["roughness"], min=q.roughness_floor)
    metal = mat["metallic"]
    d_dot_n = _dot(s, d)
    mirror = tuple(d[k] - 2.0 * d_dot_n * s[k] for k in range(3))
    spec_prob = torch.maximum(_fresnel(o, mirror, mat["ior"]), metal)
    specular_sample = u(sampling.P_LOBE) < spec_prob

    shading = alive & ~passthrough & ~backface & ~catcher_shadowed
    alb = mat["albedo"].unbind(-1)

    # NEE (shading_worker.cpp:112-147): pdf = 1, clamped to the sun energy
    if sun is not None:
        nee_ok = shading & sun_exists & (n_dot_sun > 0.0) & ~shadow_hit
        f, _, _ = _brdf_block(s, o, sd, alb, metal, rough)
        direct = [f[k] * sun_energy[k] for k in range(3)]
        if q.clamp_direct_to_light:
            direct = [torch.clamp(direct[k], 0.0, sun_energy[k])
                      for k in range(3)]
        nf = nee_ok.to(torch.float32)
        rad = tuple(rad[k] + nf * thr[k] * direct[k] for k in range(3))

    # indirect importance sampling (shading_worker.cpp:149-199)
    u1 = u(sampling.P_BRDF_U)
    u2 = u(sampling.P_BRDF_V)
    a4 = rough * rough
    a4 = a4 * a4
    ggx_cos = torch.sqrt(
        torch.clamp((1.0 - u1) / (1.0 + (a4 - 1.0) * u1), 0.0, 1.0)
    )
    hv = _cone(u2, ggx_cos, s)
    o_dot_h = _dot(hv, o)
    spec = tuple(2.0 * o_dot_h * hv[k] - o[k] for k in range(3))
    # cosine-weighted: the reference's cos(acos(2u-1)/2) is sqrt(u)
    diff = _cone(u2, torch.sqrt(u1), s)
    inc = tuple(torch.where(specular_sample, spec[k], diff[k])
                for k in range(3))

    up_facing = _dot(s, inc) > 0.0
    f, diffuse_pdf, specular_pdf = _brdf_block(s, o, inc, alb, metal, rough)
    pdf = diffuse_pdf + (specular_pdf - diffuse_pdf) * spec_prob
    inv_pdf = 1.0 / torch.clamp(pdf, min=EPS)
    if q.indirect_clamp_to_incoming:
        # monolithic convention: per-bounce factor clamped to 1
        nthr = tuple(thr[k] * torch.clamp(f[k] * inv_pdf, 0.0, 1.0)
                     for k in range(3))
    else:
        nthr = tuple(torch.clamp(thr[k] * f[k] * inv_pdf, 0.0,
                                 q.throughput_clamp) for k in range(3))

    # Russian roulette (shading_worker.cpp:182-190)
    rr_active = bounce < (cfg.bounces - q.rr_after_bounces)
    p_survive = torch.maximum(nthr[0], torch.maximum(nthr[1], nthr[2]))
    rr_kill = rr_active & (u(sampling.P_RR) > p_survive)
    comp = torch.where(rr_active & ~rr_kill,
                       1.0 / torch.clamp(p_survive, min=EPS), 1.0)
    nthr = tuple(x * comp for x in nthr)

    new_bounce = bounce - 1
    continues = shading & up_facing & ~rr_kill & (new_bounce > 0)

    # lane merges
    p = h.position.unbind(-1)
    orig = tuple(
        torch.where(passthrough, p[k] + d[k] * EPS,
                    torch.where(continues, p[k] + inc[k] * EPS, 0.0))
        for k in range(3)
    )
    return RayState(
        orig=_stack(orig),
        dirn=_stack([torch.where(continues, inc[k], d[k]) for k in range(3)]),
        radiance=_stack(rad),
        throughput=_stack([torch.where(continues, nthr[k], thr[k])
                           for k in range(3)]),
        alpha=alpha,
        alive=alive & (passthrough | continues),
        bounce=torch.where(continues, new_bounce, bounce),
        pixel_ids=pix,
        sample_ids=smp,
    )


def shade(cfg: RenderConfig, it: int, state: RayState, h, mat, env,
          sun=None, sun_energy=None) -> RayState:
    """One bounce of shading (arguments of :func:`_shade`): the kernel for
    CUDA tensors, :func:`_shade` for CPU tensors."""
    tensors = [*state, h.hit, h.position, h.normal, h.tangent, env,
               *(mat[k] for k in ("albedo", "opacity", "roughness", "metallic",
                                  "ior", "shadow_catcher", "emissive",
                                  "tangent_normal"))]
    if sun is not None:
        tensors += list(sun)
    if _build.on_cpu(*tensors):
        return _shade(cfg, it, state, h, mat, env, sun, sun_energy)
    n = state.alive.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    spec = [
        ("pix", state.pixel_ids, i32, False), ("smp", state.sample_ids, i32, False),
        ("dirn", state.dirn, f32, True), ("radiance", state.radiance, f32, True),
        ("throughput", state.throughput, f32, True),
        ("alpha", state.alpha, f32, False), ("alive", state.alive, b8, False),
        ("bounce", state.bounce, i32, False),
        ("hit", h.hit, b8, False), ("position", h.position, f32, True),
        ("normal", h.normal, f32, True), ("tangent", h.tangent, f32, True),
        ("albedo", mat["albedo"], f32, True),
        ("opacity", mat["opacity"], f32, False),
        ("roughness", mat["roughness"], f32, False),
        ("metallic", mat["metallic"], f32, False),
        ("ior", mat["ior"], f32, False),
        ("catcher", mat["shadow_catcher"], f32, False),
        ("emissive", mat["emissive"], f32, True),
        ("tnormal", mat["tangent_normal"], f32, True),
        ("env", env, f32, True),
    ]
    if sun is not None:
        spec += [("d_sun", sun[0], f32, True), ("sun_exists", sun[1], b8, False),
                 ("shadow_hit", sun[2], b8, False)]
    ins = {name: _col(t, name, n, dtype, vec3) for name, t, dtype, vec3 in spec}
    dev = state.alive.device
    out = RayState(
        orig=torch.empty((n, 3), dtype=f32, device=dev),
        dirn=torch.empty((n, 3), dtype=f32, device=dev),
        radiance=torch.empty((n, 3), dtype=f32, device=dev),
        throughput=torch.empty((n, 3), dtype=f32, device=dev),
        alpha=torch.empty((n,), dtype=f32, device=dev),
        alive=torch.empty((n,), dtype=b8, device=dev),
        bounce=torch.empty((n,), dtype=i32, device=dev),
        pixel_ids=state.pixel_ids,
        sample_ids=state.sample_ids,
    )
    q = cfg.quirks
    args = _ShadeArgs(
        **{name: ins[name][1] if name in ins else _Col(None, 0)
           for name in _SHADE_COLS},
        out_orig=out.orig.data_ptr(), out_dirn=out.dirn.data_ptr(),
        out_radiance=out.radiance.data_ptr(),
        out_throughput=out.throughput.data_ptr(),
        out_alpha=out.alpha.data_ptr(), out_alive=out.alive.data_ptr(),
        out_bounce=out.bounce.data_ptr(),
        n=n, it=_u32(it), seed=_u32(cfg.seed), bounces=cfg.bounces,
        rr_limit=cfg.bounces - q.rr_after_bounces,
        alpha_on_miss=0.0 if cfg.transparent_background else 1.0,
        emissive_scale=q.emissive_scale, roughness_floor=q.roughness_floor,
        throughput_clamp=q.throughput_clamp,
        clamp_direct=int(q.clamp_direct_to_light),
        indirect_clamp=int(q.indirect_clamp_to_incoming),
        sun_energy=(ctypes.c_float * 3)(*(sun_energy or (0.0, 0.0, 0.0))),
    )
    _build.launch(_build.load().ptx_shade, ctypes.byref(args),
                  int(sun is not None))
    _build.LAUNCHES["shade"] += 1
    return out


# --------------------------------------------------------------------------
# Integrator
# --------------------------------------------------------------------------


def sun_constants(fs: FlatScene):
    """``((dir x, y, z, angular radius), energy (r, g, b))`` as python
    floats: the by-value scalars of the sun and shade kernels (one device
    read)."""
    v = torch.cat([fs.sun_dir.reshape(3), fs.sun_angular_radius.reshape(1),
                   fs.sun_energy.reshape(3)]).tolist()
    return tuple(v[:4]), tuple(v[4:])


def make_pallas_step(static: SceneStatic, cfg: RenderConfig,
                     closest: Callable, any_hit: Callable, record: bool = False,
                     tex_shard=None):
    """One bounce ``(fs, it, state, sun) -> RayState`` of the fused schedule
    (``shade_pallas.make_pallas_step``); ``sun`` is :func:`sun_constants`
    of ``fs``, or None without a sun.  The shadow rays go to the tile
    traversal as the rows :func:`shadow_rays` packs
    (``intersect_cuda.any_hit_rows``); another ``any_hit`` gets their
    origins and directions.

    ``record=True``: the step also returns the bounce's trace results
    ``(h, d_sun, sun_exists, shadow_hit)``, the outputs of the closest hit,
    the shadow-ray setup and the any sweep it ran anyway (zeros without a
    sun), which the fast differentiable path (``ptx_torch.diff.fast``)
    saves for its backward.

    ``tex_shard``: the rank's ``textures.TexShard`` for a scene-sharded
    texel pack.  A wrapped ``any_hit`` (the multi-rank exchanges) gets the
    first ``r`` rows: parked lanes point away from the scene, so they miss
    on every shard."""
    do_compact = sorting.resolve_compact(static, cfg)
    park = sorting.park_constants(static) if do_compact else None
    if any_hit is intersect_cuda.any_hit:
        any_rows = intersect_cuda.any_hit_rows
    else:
        def any_rows(fs, rays, r):
            return any_hit(fs, rays[:r, 0:3], rays[:r, 3:6])

    def step(fs: FlatScene, it: int, state: RayState, sun):
        # Dead lanes are parked so they sort into all-dead blocks and fail
        # every tile gate; the shade kernel masks their results.
        if do_compact:
            q_orig, q_dirn = sorting.park_with(state.orig, state.dirn,
                                               state.alive, park)
        else:
            q_orig, q_dirn = state.orig, state.dirn
        h = closest(fs, q_orig, q_dirn)
        mat = textures.material_lookup(fs, h.mat_id, h.uv, static, tex_shard)
        env = _env_radiance(fs, static, cfg, state.dirn, tex_shard)
        if sun is None:
            out = shade(cfg, it, state, h, mat, env)
            if not record:
                return out
            n = state.alive.shape[0]
            no = torch.zeros((n,), dtype=torch.bool, device=state.alive.device)
            return out, (h, torch.zeros_like(state.dirn), no, no)
        # Occlusion matters only where the lane is alive with a hit and an
        # up-facing sun (``exists`` holds alive); with compaction the other
        # lanes' shadow rays are parked.
        d_sun, exists, rays = shadow_rays(
            cfg.seed, it, state.pixel_ids, state.sample_ids, state.alive,
            h.hit, h.normal, h.position, sun[0], park,
        )
        shadow_hit = any_rows(fs, rays, state.alive.shape[0])
        out = shade(cfg, it, state, h, mat, env, (d_sun, exists, shadow_hit),
                    sun[1])
        return (out, (h, d_sun, exists, shadow_hit)) if record else out

    return step


def random_inputs(n: int, bounces: int, seed: int):
    """Seeded shade-stage inputs of ``n`` lanes, as numpy arrays, that reach
    every branch of the shade kernel: hits and misses, dead lanes, opacity
    0.3, shadow catchers at ``bounce == bounces``, random tangent-space
    normals, emission, sun samples up and down, shadowed lanes, and bounces
    on both sides of the Russian-roulette threshold.  For the kernel checks
    (``chip_smoke.py``) and the CPU parity tests."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def unit():
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(f32)

    tnormal = rng.normal(size=(n, 3))
    tnormal[:, 2] = np.abs(tnormal[:, 2]) + 0.5
    r = rng.random(n)
    return dict(
        pix=rng.integers(0, 1 << 20, n).astype(np.int32),
        smp=rng.integers(0, 64, n).astype(np.int32),
        dirn=unit(),
        radiance=rng.random((n, 3)).astype(f32),
        throughput=(2.0 * rng.random((n, 3))).astype(f32),
        alpha=(rng.random(n) < 0.5).astype(f32),
        alive=rng.random(n) < 0.9,
        bounce=np.where(rng.random(n) < 0.3, bounces,
                        rng.integers(1, bounces + 1, n)).astype(np.int32),
        hit=rng.random(n) < 0.8,
        position=(20.0 * rng.random((n, 3)) - 10.0).astype(f32),
        normal=unit(),
        tangent=unit(),
        albedo=rng.random((n, 3)).astype(f32),
        opacity=np.where(rng.random(n) < 0.2, 0.3, 1.0).astype(f32),
        roughness=rng.random(n).astype(f32),
        metallic=np.where(r < 0.3, 0.0, np.where(r < 0.5, 1.0, rng.random(n)))
        .astype(f32),
        ior=(1.0 + rng.random(n)).astype(f32),
        catcher=(rng.random(n) < 0.15).astype(f32),
        emissive=np.where(rng.random((n, 1)) < 0.2, rng.random((n, 3)), 0.0)
        .astype(f32),
        tnormal=(tnormal / np.linalg.norm(tnormal, axis=1, keepdims=True))
        .astype(f32),
        env=(2.0 * rng.random((n, 3))).astype(f32),
        d_sun=unit(),
        sun_exists=rng.random(n) < 0.5,
        shadow_hit=rng.random(n) < 0.3,
    )


def inputs_from_arrays(a, device):
    """:func:`random_inputs` -> ``(state, hit, mat, env, sun)`` tensors on
    ``device``, the arguments of :func:`shade`."""
    from ptx_torch.kernels.intersect import Hit

    t = {k: torch.as_tensor(v, device=device) for k, v in a.items()}
    n = t["pix"].shape[0]
    state = RayState(
        orig=torch.zeros((n, 3), device=device), dirn=t["dirn"],
        radiance=t["radiance"], throughput=t["throughput"], alpha=t["alpha"],
        alive=t["alive"], bounce=t["bounce"], pixel_ids=t["pix"],
        sample_ids=t["smp"],
    )
    h = Hit(hit=t["hit"], t=torch.zeros((n,), device=device),
            position=t["position"], normal=t["normal"], tangent=t["tangent"],
            uv=torch.zeros((n, 2), device=device),
            mat_id=torch.zeros((n,), dtype=torch.int32, device=device))
    mat = dict(albedo=t["albedo"], opacity=t["opacity"],
               roughness=t["roughness"], metallic=t["metallic"],
               ior=t["ior"], shadow_catcher=t["catcher"],
               emissive=t["emissive"], tangent_normal=t["tnormal"])
    return state, h, mat, t["env"], (t["d_sun"], t["sun_exists"],
                                     t["shadow_hit"])


def _eager_integrator(static: SceneStatic, cfg: RenderConfig, step,
                      live_sync: Callable = None):
    """The fused integrator on the host loop (``wavefront.run_forward``,
    one live-count sync per iteration, every kernel launched eagerly): the
    reference the device loop is held to (``chip_smoke.host_render``, the
    CPU tests), for one rank or, with ``live_sync``, a tp rank.  ``step``:
    :func:`make_pallas_step`'s."""
    max_iters = max_iterations(static, cfg)
    do_compact = sorting.resolve_compact(static, cfg)

    def integrate(fs: FlatScene, pixel_ids, sample_ids):
        r = pixel_ids.shape[0]
        if r % LANES:
            raise ValueError(f"ray count {r} must be a multiple of {LANES}")
        state = initial_state(fs, cfg, pixel_ids, sample_ids)
        sun = sun_constants(fs) if static.has_sun else None

        def step_sun(fs, it, s):
            return step(fs, it, s, sun)

        return run_forward(step_sun, fs, state, max_iters, static, do_compact,
                           live_sync)

    return integrate


def make_pallas_integrator(static: SceneStatic, cfg: RenderConfig,
                           closest: Callable, any_hit: Callable,
                           live_sync: Callable = None, tex_shard=None):
    """The forward integrator of the fused shade schedule
    (``shade_pallas.make_pallas_integrator``): the same images as
    ``wavefront.make_integrator`` up to the schedule's rounding.  A launch
    must be a multiple of 128 rays, as in the JAX package.  ``live_sync``
    and ``tex_shard``: as ``wavefront.make_integrator`` takes them.

    It runs on the device loop (``ptx_torch.integrator.graphs.DeviceLoop``:
    CUDA graphs of the chunk step, the live count read one iteration late;
    on CPU tensors the same schedule without capture), one integrator per
    scene.  A tp rank's step holds collectives (the exchanges of
    ``closest`` / ``any_hit`` and ``tex_shard``'s sums): each is an
    exchange point (``graphs.exchange``) that cuts its chunk step's graph
    into segments, and its live counts go through ``live_sync``."""
    from ptx_torch.integrator.graphs import DeviceLoop

    step = make_pallas_step(static, cfg, closest, any_hit, tex_shard=tex_shard)
    return DeviceLoop(static, cfg, step, live_sync)
