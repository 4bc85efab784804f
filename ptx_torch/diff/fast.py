"""Fast differentiable integrator (port of ``ptx/diff/fast.py``): the fused
CUDA forward, a shading-only backward.

The general differentiable scan (``make_integrator(differentiable=True)``)
lets autograd record every op, geometry included.  The usual inverse
rendering target is a material, light or texture parameter, for which the
trace results are constants.  This integrator uses that:

* **forward**: the fused bounce step (``shade_cuda.make_pallas_step`` with
  ``record=True``: plan, closest, shadow-ray setup, any and shade kernels)
  when the shader resolves to "pallas" and the launch is a multiple of 128
  rays, else the plain trace and shade stages, without autograd; each
  bounce's trace results ``(h, d_sun, sun_exists, shadow_hit)`` are saved;
* **backward**: autograd through the plain shade stage
  (``wavefront.make_shade_fn``) replayed at the saved trace results, one
  checkpointed step per bounce the forward ran; no sweep runs in backward.

The fused kernels equal the plain shade stage up to rounding, so the
forward's output and the point the backward linearises at agree.
Gradients reach only :data:`FAST_SAFE_FIELDS`: the saved hits detach the
geometry, whose gradients are zero here.

The JAX package's loss functions take this path for material, light and
texture sets.  The port's take the general scan for every set: torch
autograd records nothing in the sweeps, so the scan's backward is
shading-only already, and on the card this path was not faster (its
forward adds the fused shade to the replay's plain one; ``PERF.md``).  It
stays as an independent second route: the tests and ``chip_smoke.py``
hold the scan's value and gradients against it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ptx_torch.config import RenderConfig
from ptx_torch.integrator.wavefront import (
    initial_state,
    make_shade_fn,
    make_trace_fn,
    max_iterations,
)
from ptx_torch.kernels.intersect import Hit
from ptx_torch.scene.flatten import FlatScene, SceneStatic

# FlatScene fields whose gradients survive the recorded-trace backward:
# what the shade stage reads directly.  Geometry, BVH and camera fields are
# detached.
FAST_SAFE_FIELDS = frozenset({
    "mat_albedo", "mat_opacity", "mat_roughness", "mat_metallic",
    "mat_emissive", "mat_ior", "mat_shadow_catcher", "mat_packed",
    "sun_energy", "tex_texels",
})
_SAFE_ORDER = tuple(f for f in FlatScene._fields if f in FAST_SAFE_FIELDS)
# Tensors per saved bounce: the Hit's seven, d_sun, sun_exists, shadow_hit.
_REC_LEN = len(Hit._fields) + 3


class _FastIntegrate(torch.autograd.Function):
    """``apply(run, fs, pixel_ids, sample_ids, names, *safe) -> (radiance,
    alpha)``: ``safe`` are ``fs``'s fields ``names`` (of
    :data:`FAST_SAFE_FIELDS`), passed as tensors so autograd sees them."""

    @staticmethod
    def forward(ctx, run, fs, pixel_ids, sample_ids, names, *safe):
        fs = fs._replace(**dict(zip(names, safe)))
        radiance, alpha, recs = run.primal(fs, pixel_ids, sample_ids)
        ctx.run, ctx.fs, ctx.names, ctx.n_ran = run, fs, names, len(recs)
        flat = [x for h, *sun in recs for x in (*h, *sun)]
        ctx.save_for_backward(pixel_ids, sample_ids, *safe, *flat)
        ctx.mark_non_differentiable(alpha)
        return radiance, alpha

    @staticmethod
    def backward(ctx, g_radiance, _g_alpha):
        pixel_ids, sample_ids, *rest = ctx.saved_tensors
        n_safe = len(ctx.names)
        safe, flat = rest[:n_safe], rest[n_safe:]
        need = ctx.needs_input_grad[5:]
        grads = [None] * n_safe
        if any(need):
            recs = []
            for i in range(ctx.n_ran):
                x = flat[i * _REC_LEN:(i + 1) * _REC_LEN]
                recs.append((Hit(*x[:7]), *x[7:]))
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in zip(safe, need)]
                fs = ctx.fs._replace(**dict(zip(ctx.names, leaves)))
                radiance = ctx.run.replay(fs, pixel_ids, sample_ids, recs)
                wanted = [t for t, n in zip(leaves, need) if n]
                got = iter(torch.autograd.grad(radiance, wanted, g_radiance,
                                               allow_unused=True))
            grads = [next(got) if n else None for n in need]
        return (None, None, None, None, None, *grads)


class _Run:
    """The forward and the backward replay of one integrator."""

    def __init__(self, static: SceneStatic, cfg: RenderConfig, closest,
                 any_hit):
        from ptx_torch.kernels.shade_cuda import make_pallas_step
        from ptx_torch.render import resolve_shader

        self.static, self.cfg = static, cfg
        self.max_iters = max_iterations(static, cfg)
        self.shade = make_shade_fn(static, cfg)
        self.trace = make_trace_fn(static, cfg, closest, any_hit,
                                   do_compact=False)
        self.pallas_step = (
            make_pallas_step(static, cfg, closest, any_hit, record=True)
            if resolve_shader(cfg) == "pallas" else None
        )

    def primal(self, fs: FlatScene, pixel_ids, sample_ids):
        """``(radiance, alpha, recs)``: the forward, and the trace results
        of each bounce it ran (the loop stops once no lane is alive)."""
        from ptx_torch.kernels.shade_cuda import LANES, sun_constants

        state = initial_state(fs, self.cfg, pixel_ids, sample_ids)
        if self.pallas_step is not None and pixel_ids.shape[0] % LANES == 0:
            sun = sun_constants(fs) if self.static.has_sun else None

            def step(it, s):
                return self.pallas_step(fs, it, s, sun)
        else:
            def step(it, s):
                tr = self.trace(fs, it, s)
                return self.shade(fs, it, s, *tr), tr

        recs = []
        while len(recs) < self.max_iters and bool(state.alive.any()):
            state, rec = step(len(recs), state)
            recs.append(rec)
        return state.radiance, state.alpha, recs

    def replay(self, fs: FlatScene, pixel_ids, sample_ids, recs):
        """The shade stage alone at the recorded trace results: the
        function whose backward is the fast path's.  Bounces the forward
        did not run are skipped, as its loop skipped them."""
        state = initial_state(fs, self.cfg, pixel_ids, sample_ids)
        for it, rec in enumerate(recs):
            state = checkpoint(self.shade, fs, it, state, *rec,
                               use_reentrant=False)
        return state.radiance


def make_fast_diff_integrator(static: SceneStatic, cfg: RenderConfig, closest,
                              any_hit):
    """``(fs, pixel_ids, sample_ids) -> (radiance, alpha)`` with a custom
    backward: the forward at the fused kernels' speed, the backward through
    the shade stage only.  ``alpha`` carries no gradient."""
    run = _Run(static, cfg, closest, any_hit)

    def integrate(fs: FlatScene, pixel_ids, sample_ids):
        names = tuple(n for n in _SAFE_ORDER if torch.is_tensor(getattr(fs, n)))
        return _FastIntegrate.apply(run, fs, pixel_ids, sample_ids, names,
                                    *(getattr(fs, n) for n in names))

    return integrate
