"""The wavefront path-tracing integrator (port of
``ptx/integrator/wavefront.py``).

The wavefront is a ``RayState`` of [R] tensors.  Each iteration of a host
loop runs one bounce on the live lanes: the trace stage (closest hit, then
the sun's shadow ray) and the shade stage (every ``shading_worker.cpp``
quirk, term for term as in the JAX package).  The RNG is keyed by (pixel,
sample, bounce, purpose), so lane order never changes a sample.  With
survivor compaction (:func:`_chunked_forward`) the loop sorts the wavefront
dead-last each iteration and steps only the live CHUNK-lane chunks; each
live count read (``.item()``) is one device sync.  The fused integrator
runs that schedule as a device program (``ptx_torch.integrator.graphs``),
and the differentiable scan has one too (``ptx_torch.diff.graphs``).

Sampled directions and the lobe probability are detached (the JAX
package's ``stop_gradient``: detached sampling), so the radiance is
differentiable in the material, light and vertex parameters through the
shading algebra and the Moller-Trumbore epilogue; ``make_integrator(
differentiable=True)`` is the scan that torch autograd runs backward
through.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ptx_torch import math as pmath
from ptx_torch import sampling
from ptx_torch.kernels import sorting
from ptx_torch.scene import camera as pcamera
from ptx_torch.scene import textures
from ptx_torch.config import RenderConfig
from ptx_torch.scene.flatten import FlatScene, SceneStatic
from ptx_torch.utils import device_constant


class RayState(NamedTuple):
    orig: torch.Tensor  # [R, 3]
    dirn: torch.Tensor  # [R, 3]
    radiance: torch.Tensor  # [R, 3] accumulated color
    throughput: torch.Tensor  # [R, 3]
    alpha: torch.Tensor  # [R]
    alive: torch.Tensor  # [R] bool
    bounce: torch.Tensor  # [R] int32, counts down from cfg.bounces
    pixel_ids: torch.Tensor  # [R] int32
    sample_ids: torch.Tensor  # [R] int32


def compute_hit_attrs(fs: FlatScene, tri, beta, gamma, at=None, geom=None):
    """Barycentric attribute interpolation at hit points: (position,
    normal, tangent, uv, mat_id).  Everything comes from one packed
    ``tri_attrs`` row gather when the scene has the pack (``at``: rows the
    caller already gathered).  ``geom=(a, e1, e2)`` overrides the vertex
    columns: the split-geometry-gradient path routes d/d vertices through
    the [T, 3] leaves instead of the [T, 40] rows."""
    alpha_w = 1.0 - beta - gamma
    w0, w1, w2 = alpha_w[..., None], beta[..., None], gamma[..., None]
    if at is None and fs.tri_attrs.shape[0] == fs.tri_a.shape[0]:
        at = fs.tri_attrs[tri]  # [R, 40]
    if at is not None:
        n0, n1, n2 = at[..., 0:3], at[..., 3:6], at[..., 6:9]
        t0, t1, t2 = at[..., 9:12], at[..., 12:15], at[..., 15:18]
        uv0, uv1, uv2 = at[..., 18:20], at[..., 20:22], at[..., 22:24]
        mat_id = at[..., 24].to(torch.int32)
        a, e1, e2 = at[..., 25:28], at[..., 28:31], at[..., 31:34]
    else:
        n0, n1, n2 = fs.n0[tri], fs.n1[tri], fs.n2[tri]
        t0, t1, t2 = fs.t0[tri], fs.t1[tri], fs.t2[tri]
        uv0, uv1, uv2 = fs.uv0[tri], fs.uv1[tri], fs.uv2[tri]
        mat_id = fs.mat_id[tri]
        a, e1, e2 = fs.tri_a[tri], fs.tri_e1[tri], fs.tri_e2[tri]
    if geom is not None:
        a, e1, e2 = geom
    position = a + e1 * beta[..., None] + e2 * gamma[..., None]
    normal = pmath.normalize(n0 * w0 + n1 * w1 + n2 * w2)
    tangent = pmath.normalize(t0 * w0 + t1 * w1 + t2 * w2)
    uv = uv0 * w0 + uv1 * w1 + uv2 * w2
    return position, normal, tangent, uv, mat_id


def _env_radiance(fs: FlatScene, static: SceneStatic, cfg: RenderConfig, dirn,
                  tex_shard=None):
    """Environment contribution on a miss (``tex_shard``: the rank's
    ``textures.TexShard`` for a scene-sharded texel pack)."""
    env_factor = device_constant(tuple(cfg.environment_factor), dirn.device)
    if static.env_tex >= 0:
        uv = pmath.equirectangular_proj(dirn)
        tex = torch.full(dirn.shape[:-1], static.env_tex, dtype=torch.int32,
                         device=dirn.device)
        return (textures.sample_texture(fs, tex, uv, static, tex_shard)[..., :3]
                * env_factor)
    return env_factor.expand(dirn.shape)


def _brdf_and_pdfs(normal, outcoming, incoming, albedo, metallic, roughness):
    """The BRDF block shared by NEE and indirect sampling."""
    diffuse_pdf = sampling.pdf_diffuse(normal, incoming)
    diffuse_brdf = diffuse_pdf[..., None] * albedo
    specular_pdf = sampling.pdf_specular(normal, outcoming, incoming, roughness)
    specular_brdf = specular_pdf[..., None].expand(albedo.shape)
    fres = pmath.lerp(torch.full_like(albedo, 0.04), albedo, metallic[..., None])
    halfway = pmath.normalize(outcoming + incoming)
    cos_theta = pmath.dot(outcoming, halfway)
    fres = pmath.lerp(
        fres, torch.ones_like(fres),
        torch.pow(torch.clamp(1.0 - cos_theta, min=0.0), 5.0)[..., None],
    )
    diffuse_brdf = diffuse_brdf * (1.0 - metallic[..., None])
    brdf = pmath.lerp(diffuse_brdf, specular_brdf, fres)
    return brdf, diffuse_pdf, specular_pdf


# Lanes per compaction chunk, and the live count below which the
# per-iteration re-sort is skipped.  Both were measured on a TPU and are
# kept until the card's own measurement replaces them.
CHUNK = 8192
SKIP_SORT_MAX = 4096
# The sort key of a dead lane: above every morton key, so dead lanes sort
# last.
DEAD_KEY = 1 << 30


def count_live(alive, live_sync=None) -> int:
    """The live lanes of a wavefront (one device sync).  ``live_sync``
    (multi-rank runs whose step holds collectives): a callable that maps
    this rank's count, a 0-d tensor, to the largest count over the ranks,
    so every rank steps the loop the same number of times and issues the
    same collectives in the same order."""
    n = alive.sum()
    return int(live_sync(n)) if live_sync is not None else int(n)


def chunk_layout(r: int):
    """``(chunk, n_chunks)`` of an ``r``-lane wavefront under compaction:
    CHUNK-lane chunks when they divide it, else one chunk of all lanes."""
    chunk = CHUNK if r % CHUNK == 0 else r
    return chunk, r // chunk


def sort_skip_max(chunk: int) -> int:
    """The live count at or below which, once reached, the loop stops
    sorting: every live lane then lies in chunk 0 and only dies in place."""
    return min(chunk, SKIP_SORT_MAX)


def sort_wavefront(state: RayState, slot, static: SceneStatic):
    """The wavefront and its lanes' original slots, sorted dead-last, live
    lanes by their morton key (a stable sort, as ``jnp.argsort`` is)."""
    key = sorting.ray_keys(state.orig, state.dirn, static.aabb_lo,
                           static.aabb_hi)
    perm = torch.argsort(torch.where(state.alive, key, DEAD_KEY), stable=True)
    return RayState(*(x[perm] for x in state)), slot[perm]


def _chunked_forward(step_fn, fs, state: RayState, max_iters: int,
                     static: SceneStatic, live_sync: Callable = None):
    """Forward bounce loop with survivor compaction, on the host: each
    iteration reads the live count (one device sync), sorts the wavefront
    dead-last (:func:`sort_wavefront`) and steps only the first ceil(live /
    CHUNK) chunks; lanes beyond them are dead and final.  Once every live
    lane fits chunk 0 and there are at most SKIP_SORT_MAX of them, lanes
    only die in place and the sort is skipped.  Returns the (radiance,
    alpha) of the lanes in their original order.  The fused integrator on
    one rank runs the same schedule as a device program
    (``ptx_torch.integrator.graphs``).

    With ``live_sync`` (:func:`count_live`) the live count is the largest
    over the ranks: a rank with fewer live lanes steps all-dead chunks,
    which is exact because parked lanes fail every gate."""
    r = state.orig.shape[0]
    chunk, n_chunks = chunk_layout(r)
    slot = torch.arange(r, device=state.orig.device)
    live = count_live(state.alive, live_sync)
    in_c0 = False
    it = 0
    while it < max_iters and live > 0:
        if not in_c0:
            state, slot = sort_wavefront(state, slot, static)
        in_c0 = in_c0 or live <= sort_skip_max(chunk)
        n_live = min(-(-live // chunk), n_chunks)
        for ci in range(n_live):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            sub = step_fn(fs, it, RayState(*(x[sl] for x in state)))
            for dst, src in zip(state, sub):
                dst[sl] = src
        it += 1
        live = count_live(state.alive, live_sync)
    radiance = torch.empty_like(state.radiance)
    radiance[slot] = state.radiance
    alpha = torch.empty_like(state.alpha)
    alpha[slot] = state.alpha
    return radiance, alpha


def make_trace_fn(static: SceneStatic, cfg: RenderConfig, closest: Callable,
                  any_hit: Callable, do_compact: bool = None):
    """The per-bounce trace stage ``(fs, it, state) -> (hit, d_sun,
    sun_exists, shadow_hit)``: the closest hit and the sun's shadow ray."""
    if do_compact is None:
        do_compact = sorting.resolve_compact(static, cfg)

    def trace(fs: FlatScene, it: int, state: RayState):
        r = state.orig.shape[0]
        pix, smp = state.pixel_ids, state.sample_ids

        def u(purpose):
            return sampling.uniform(pix, smp, it, purpose, cfg.seed)

        # Dead lanes are parked outside the scene so they sort into
        # all-dead blocks and fail every tile gate.
        if do_compact:
            q_orig, q_dirn = sorting.park(state.orig, state.dirn, state.alive,
                                          static)
        else:
            q_orig, q_dirn = state.orig, state.dirn
        h = closest(fs, q_orig, q_dirn)

        if static.has_sun:
            cos_theta = torch.cos(u(sampling.P_SUN_THETA) * fs.sun_angular_radius)
            d_sun = sampling.cone_vec(
                u(sampling.P_SUN_PHI), cos_theta, fs.sun_dir.expand(state.dirn.shape)
            ).detach()
            sun_exists = pmath.dot(h.normal, d_sun) > 0.0
            shadow_org = h.position + d_sun * pmath.EPS
            alive_hit = state.alive & h.hit
            if do_compact:
                s_org, s_dir = sorting.park(
                    shadow_org, d_sun, alive_hit & sun_exists, static
                )
            else:
                s_org, s_dir = shadow_org, d_sun
            shadow_hit = any_hit(fs, s_org, s_dir)
        else:
            d_sun = torch.zeros_like(state.dirn)
            sun_exists = torch.zeros((r,), dtype=torch.bool, device=pix.device)
            shadow_hit = torch.zeros((r,), dtype=torch.bool, device=pix.device)
        return h, d_sun, sun_exists, shadow_hit

    return trace


def make_shade_fn(static: SceneStatic, cfg: RenderConfig, tex_shard=None):
    """The per-bounce shade stage ``(fs, it, state, hit, d_sun, sun_exists,
    shadow_hit) -> RayState``: plain torch, no traversal.  ``tex_shard``:
    the rank's ``textures.TexShard`` for a scene-sharded texel pack."""
    q = cfg.quirks

    def shade(fs: FlatScene, it: int, state: RayState, h, d_sun, sun_exists,
              shadow_hit) -> RayState:
        pix, smp = state.pixel_ids, state.sample_ids

        def u(purpose):
            return sampling.uniform(pix, smp, it, purpose, cfg.seed)

        hit = h.hit & state.alive
        position, n_interp, tangent, uv, mat_id = (
            h.position, h.normal, h.tangent, h.uv, h.mat_id
        )

        # Miss: environment, terminate.
        env = _env_radiance(fs, static, cfg, state.dirn, tex_shard)
        miss = state.alive & ~hit
        radiance = torch.where(
            miss[..., None], state.radiance + state.throughput * env,
            state.radiance,
        )
        alpha = torch.where(
            miss, 0.0 if cfg.transparent_background else 1.0, state.alpha
        )
        alive = state.alive & hit
        alpha = torch.where(hit, 1.0, alpha)

        # Material fetch; emission.
        mat = textures.material_lookup(fs, mat_id, uv, static, tex_shard)
        emissive = mat["emissive"] * q.emissive_scale
        radiance = torch.where(
            alive[..., None], radiance + state.throughput * emissive, radiance
        )

        # Stochastic opacity passthrough: does not consume a bounce.
        translucent = torch.abs(mat["opacity"] - 1.0) > pmath.EPS
        passthrough = alive & translucent & (u(sampling.P_OPACITY) > mat["opacity"])

        # Shading normal via TBN + normal map.
        binormal = pmath.cross(n_interp, tangent)
        tn = mat["tangent_normal"]
        n_shade = pmath.normalize(
            tangent * tn[..., 0:1] + binormal * tn[..., 1:2] + n_interp * tn[..., 2:3]
        )
        outcoming = -state.dirn

        # Backface cull.
        backface = alive & ~passthrough & (pmath.dot(n_shade, outcoming) <= 0.0)

        # Shadow catcher, first bounce.
        is_catcher = mat["shadow_catcher"] > 0.5
        first_bounce = state.bounce == cfg.bounces
        catcher_now = alive & ~passthrough & ~backface & is_catcher & first_bounce
        if static.has_sun:
            catcher_lit = (
                catcher_now & sun_exists & (pmath.dot(n_shade, d_sun) > 0.0)
                & ~shadow_hit
            )
        else:
            catcher_lit = torch.zeros_like(catcher_now)
        catcher_shadowed = catcher_now & ~catcher_lit
        radiance = torch.where(catcher_shadowed[..., None], 0.0, radiance)
        alpha = torch.where(catcher_shadowed, 1.0, alpha)
        passthrough = passthrough | catcher_lit

        # Lobe selection.
        roughness = torch.clamp(mat["roughness"], min=q.roughness_floor)
        mirror = pmath.reflect(-outcoming, n_shade)
        spec_prob = sampling.fresnel(outcoming, mirror, mat["ior"])
        spec_prob = torch.maximum(spec_prob, mat["metallic"]).detach()
        specular_sample = u(sampling.P_LOBE) < spec_prob

        shading = alive & ~passthrough & ~backface & ~catcher_shadowed

        # Sun NEE, pdf = 1, clamped to the light energy.
        if static.has_sun:
            nee_ok = (
                shading & sun_exists & (pmath.dot(n_shade, d_sun) > 0.0)
                & ~shadow_hit
            )
            brdf, _, _ = _brdf_and_pdfs(
                n_shade, outcoming, d_sun, mat["albedo"], mat["metallic"], roughness
            )
            direct_in = fs.sun_energy.expand(brdf.shape)
            direct_out = brdf * direct_in
            if q.clamp_direct_to_light:
                direct_out = torch.minimum(
                    torch.clamp(direct_out, min=0.0), direct_in
                )
            radiance = torch.where(
                nee_ok[..., None], radiance + state.throughput * direct_out,
                radiance,
            )

        # Indirect bounce.
        u1, u2 = u(sampling.P_BRDF_U), u(sampling.P_BRDF_V)
        d_spec = sampling.importance_specular(u1, u2, n_shade, outcoming, roughness)
        d_diff = sampling.importance_diffuse(u1, u2, n_shade)
        d_new = torch.where(specular_sample[..., None], d_spec, d_diff).detach()

        up_facing = pmath.dot(n_shade, d_new) > 0.0
        brdf_i, diffuse_pdf, specular_pdf = _brdf_and_pdfs(
            n_shade, outcoming, d_new, mat["albedo"], mat["metallic"], roughness
        )
        pdf = pmath.lerp(diffuse_pdf, specular_pdf, spec_prob)
        factor = brdf_i / torch.clamp(pdf, min=pmath.EPS)[..., None]
        if q.indirect_clamp_to_incoming:
            new_throughput = state.throughput * torch.clamp(factor, 0.0, 1.0)
        else:
            new_throughput = torch.clamp(
                state.throughput * factor, 0.0, q.throughput_clamp
            )

        # Russian roulette after rr_after_bounces completed bounces.
        rr_active = state.bounce < (cfg.bounces - q.rr_after_bounces)
        p_survive = new_throughput.amax(-1)
        rr_kill = rr_active & (u(sampling.P_RR) > p_survive)
        new_throughput = torch.where(
            (rr_active & ~rr_kill)[..., None],
            new_throughput / torch.clamp(p_survive, min=pmath.EPS)[..., None],
            new_throughput,
        )

        new_bounce = state.bounce - 1
        continues = shading & up_facing & ~rr_kill & (new_bounce > 0)
        terminated_here = shading & (~up_facing | rr_kill | (new_bounce <= 0))

        # Merge lane updates.
        cont_or_pass = passthrough | continues
        next_orig = torch.where(
            passthrough[..., None],
            position + state.dirn * pmath.EPS,
            torch.where(
                continues[..., None], position + d_new * pmath.EPS, state.orig
            ),
        )
        next_dirn = torch.where(continues[..., None], d_new, state.dirn)
        next_throughput = torch.where(
            continues[..., None], new_throughput, state.throughput
        )
        next_bounce = torch.where(continues, new_bounce, state.bounce)
        next_alive = alive & cont_or_pass & ~backface & ~terminated_here

        return RayState(
            orig=next_orig,
            dirn=next_dirn,
            radiance=radiance,
            throughput=next_throughput,
            alpha=alpha,
            alive=next_alive,
            bounce=next_bounce,
            pixel_ids=pix,
            sample_ids=smp,
        )

    return shade


def initial_state(fs: FlatScene, cfg: RenderConfig, pixel_ids, sample_ids
                  ) -> RayState:
    """The wavefront of camera rays for ``pixel_ids`` / ``sample_ids``."""
    q = cfg.quirks
    orig, dirn = pcamera.generate_rays(
        fs, pixel_ids, sample_ids, cfg.width, cfg.height, cfg.seed,
        q.first_sample_centered, cfg.transparent_background,
    )
    r = pixel_ids.shape[0]
    dev = pixel_ids.device
    return RayState(
        orig=orig.contiguous(),
        dirn=dirn,
        radiance=torch.zeros((r, 3), device=dev),
        throughput=torch.ones((r, 3), device=dev),
        alpha=torch.zeros((r,), device=dev),
        alive=torch.ones((r,), dtype=torch.bool, device=dev),
        bounce=torch.full((r,), cfg.bounces, dtype=torch.int32, device=dev),
        pixel_ids=pixel_ids.to(torch.int32),
        sample_ids=sample_ids.to(torch.int32),
    )


def max_iterations(static: SceneStatic, cfg: RenderConfig) -> int:
    """Bounce iterations of a launch.  Opacity passthrough does not consume
    a bounce: headroom only when some material can pass rays through."""
    extra = cfg.opacity_extra_iters if static.has_translucent else 0
    return cfg.bounces + extra


def run_forward(step: Callable, fs: FlatScene, state: RayState,
                max_iters: int, static: SceneStatic, do_compact: bool,
                live_sync: Callable = None):
    """Step the wavefront until no lane is alive or ``max_iters``, with
    survivor compaction when ``do_compact``; returns (radiance, alpha).
    ``live_sync``: see :func:`count_live`."""
    if do_compact:
        return _chunked_forward(step, fs, state, max_iters, static, live_sync)
    it = 0
    while it < max_iters and count_live(state.alive, live_sync) > 0:
        state = step(fs, it, state)
        it += 1
    return state.radiance, state.alpha


def make_step(static: SceneStatic, cfg: RenderConfig, closest: Callable,
              any_hit: Callable, tex_shard=None):
    """The plain bounce step ``(fs, it, state) -> state``: the trace stage,
    then the shade stage."""
    trace = make_trace_fn(static, cfg, closest, any_hit)
    shade = make_shade_fn(static, cfg, tex_shard)

    def step(fs: FlatScene, it: int, state: RayState) -> RayState:
        return shade(fs, it, state, *trace(fs, it, state))

    return step


def make_integrator(static: SceneStatic, cfg: RenderConfig, closest: Callable,
                    any_hit: Callable, differentiable: bool = False,
                    live_sync: Callable = None, tex_shard=None):
    """The integrator ``(fs, pixel_ids, sample_ids) -> (radiance [R, 3],
    alpha [R])``.  ``closest(fs, orig, dirn) -> Hit`` and ``any_hit(fs,
    orig, dirn) -> [R] bool`` are the intersection backend.

    ``differentiable``: the scan that autograd runs backward through
    (``ptx/integrator/wavefront.py``'s ``differentiable=True``): up to
    ``max_iters`` steps at full width, no compaction and no in-place
    update of a tensor in the graph; dead lanes stay parked.  A step runs
    only while some lane is alive (one device sync per step), which is
    exact because a step is the identity on dead lanes.  Autograd saves
    what the shade stage's backward needs; the sweeps run without it, so
    the trace adds to the graph only what depends on a parameter (the
    epilogue's gather and Moller-Trumbore recompute, for vertices).  This
    is the host scan; on a CUDA device the loss functions run its schedule
    as a device program (``ptx_torch.diff.graphs.DeviceScan``).

    Multi-rank runs (``ptx_torch.parallel.dist``) pass ``live_sync`` (see
    :func:`count_live`) when the backend holds collectives, and
    ``tex_shard`` (``textures.TexShard``) for a scene-sharded texel pack."""
    max_iters = max_iterations(static, cfg)
    do_compact = sorting.resolve_compact(static, cfg)
    step = make_step(static, cfg, closest, any_hit, tex_shard)

    def integrate(fs: FlatScene, pixel_ids, sample_ids):
        state = initial_state(fs, cfg, pixel_ids, sample_ids)
        if not differentiable:
            return run_forward(step, fs, state, max_iters, static, do_compact,
                               live_sync)
        for it in range(max_iters):
            if count_live(state.alive, live_sync) == 0:
                break
            state = step(fs, it, state)
        return state.radiance, state.alpha

    return integrate
