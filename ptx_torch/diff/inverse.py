"""Differentiable rendering and inverse-rendering optimisation (port of
``ptx/diff/inverse.py``).

``d pixel / d {albedo, emissive, roughness, metallic, opacity, sun energy,
texels, vertices}`` by *detached sampling*: the integrator detaches every
Monte Carlo decision (sampled directions, lobe choice, Russian roulette,
opacity passthrough) and keeps the BRDF, pdf, throughput and emission
algebra differentiable.  The RNG is counter-based and keyed by absolute
(pixel, sample) ids, so for a fixed sample set the loss is a deterministic
function of the parameters, and finite differences check the gradients.

Every parameter set takes the general differentiable scan
(``make_integrator(differentiable=True)``; on a CUDA device its device
program, ``ptx_torch.diff.graphs.DeviceScan``): the sweeps run without
autograd, so for material, light and texture fields its backward runs
through the shade stage alone, and for a geometry field (``tri_a``,
``tri_e1``, ``tri_e2``) also through the Moller-Trumbore epilogue of each
closest hit.  The JAX package sends material, light and texture sets to
its fast path instead; ``ptx_torch.diff.fast`` ports it, but on the card
it was not faster than the scan (``PERF.md``), so only the checks use
it, as a second route to hold the scan against.  The "bvh" intersector
serves material, light and texture sets (its walk selects the hits and
carries no gradient, as in the JAX package); a geometry set under "bvh"
raises ``ValueError``: the BVH's nodes are never refit when the vertices
move, so the walk would miss triangles that leave their build-time boxes
(the limitation the JAX package documents).  Geometry parameters take the
"pallas" intersector, whose tiles are packed from the current vertices
(``tiles.pack_tris``), or "brute"; "auto" resolves to "pallas" for them on
a card whatever the scene's size (``render.resolve_intersector``, which the
entry points below ask with their ``param_fields``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ptx_torch import utils
from ptx_torch.config import RenderConfig
from ptx_torch.integrator.wavefront import make_integrator
from ptx_torch.scene.flatten import FlatScene, SceneStatic

# FlatScene fields that are meaningful optimisation targets.
DIFFERENTIABLE_FIELDS = (
    "mat_albedo",
    "mat_emissive",
    "mat_roughness",
    "mat_metallic",
    "mat_opacity",
    "sun_energy",
    "tex_texels",
    "tri_a",
    "tri_e1",
    "tri_e2",
)

# tri_attrs mirrors the vertex data in columns 25-33 and mat_packed the
# scalar material factors (the one-row gathers of the hit epilogue and the
# material fetch).  Parameters are written into both places, functionally,
# so renders see them and gradients flow through the packed gathers too.
_GEOM_ATTR_COLS = {"tri_a": (25, 28), "tri_e1": (28, 31), "tri_e2": (31, 34)}
_MAT_PACKED_COLS = {
    "mat_albedo": (0, 3), "mat_opacity": (3, 4), "mat_roughness": (4, 5),
    "mat_metallic": (5, 6), "mat_emissive": (6, 9), "mat_ior": (9, 10),
    "mat_shadow_catcher": (10, 11),
}


def _overlay(row, cols, params):
    """``row`` [N, C] with the columns ``cols[k]`` of each parameter ``k``
    replaced by ``params[k]``, built by ``torch.cat`` (no in-place write)."""
    pieces, at = [], 0
    for lo, hi, k in sorted((*cols[k], k) for k in params if k in cols):
        if lo > at:
            pieces.append(row[:, at:lo])
        v = params[k]
        pieces.append(v if v.dim() == 2 else v[:, None])
        at = hi
    if at < row.shape[1]:
        pieces.append(row[:, at:])
    return torch.cat(pieces, dim=1)


def inject_params(fs: FlatScene, params: Dict[str, torch.Tensor],
                  keep_tiles: bool = False) -> FlatScene:
    """Overlay an optimisation-parameter dict onto a FlatScene.

    Geometry parameters drop the attached traversal tiles (they bake the
    old vertices), so the tile traversal packs them from the current ones
    in the call, unless ``keep_tiles``: the caller has refreshed
    ``fs.ptiles`` / ``fs.pboxes`` for these parameters (the hoisted
    once-per-loss pack of :func:`make_batch_value_and_grad_fn`)."""
    fs = fs._replace(**params)
    geom = [k for k in params if k in _GEOM_ATTR_COLS]
    if geom and fs.tri_attrs.shape[0] == fs.tri_a.shape[0]:
        fs = fs._replace(tri_attrs=_overlay(fs.tri_attrs, _GEOM_ATTR_COLS, params))
    if geom and fs.ptiles.shape[0] > 0 and not keep_tiles:
        dev = fs.tri_a.device
        fs = fs._replace(ptiles=torch.zeros((0, 16, 1), device=dev),
                         pboxes=torch.zeros((0, 8), device=dev))
    mats = [k for k in params if k in _MAT_PACKED_COLS]
    if mats and fs.mat_packed.shape[0] == fs.mat_albedo.shape[0]:
        fs = fs._replace(mat_packed=_overlay(fs.mat_packed, _MAT_PACKED_COLS,
                                             params))
    return fs


def extract_params(fs: FlatScene, fields: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {f: getattr(fs, f) for f in fields}


def moves_geometry(param_fields: Sequence[str]) -> bool:
    """Whether the set holds a geometry field (``tri_a``, ``tri_e1``,
    ``tri_e2``)."""
    return bool(set(param_fields) & set(_GEOM_ATTR_COLS))


def diff_backend(static, cfg, closest, any_hit, param_fields, device):
    """The backend pair of the general differentiable scan for
    ``param_fields``: ``(closest, any_hit)`` as given, except that a set
    with a geometry field runs the tile traversal with ``split_geom_grad``
    (the [T, 3] vertex leaves take the gradient, not the [T, 40]
    ``tri_attrs`` rows) and is refused under "bvh".  A caller that wraps
    the pair (``parallel.dist``'s exchanges) wraps what this returns."""
    if moves_geometry(param_fields):
        from ptx_torch.render import resolve_intersector

        name = resolve_intersector(static, cfg, device, param_fields)
        if name == "bvh":
            raise ValueError(
                "geometry parameters (tri_a, tri_e1, tri_e2) under the bvh "
                "intersector: the BVH's nodes are never refit when the "
                "vertices move, so the walk would miss triangles that leave "
                "their build-time boxes; use intersector pallas or brute")
        if name == "pallas":
            from ptx_torch.kernels import intersect_cuda

            closest, any_hit = intersect_cuda.make_backend(split_geom_grad=True)
    return closest, any_hit


def scan_fields(param_fields: Sequence[str]):
    """``(grad_fields, copy_fields)`` of the device scan for
    ``param_fields``: the scene fields a call may hand it anew.  The
    parameters and the packed rows :func:`inject_params` overlays with them
    carry the gradient; a geometry set's tiles, repacked per call by
    :func:`slice_value_and_grad_fn`, are copied without one."""
    grad, copy = list(param_fields), []
    if set(param_fields) & set(_MAT_PACKED_COLS):
        grad.append("mat_packed")
    if moves_geometry(param_fields):
        grad.append("tri_attrs")
        copy += ["ptiles", "pboxes"]
    return tuple(grad), tuple(copy)


def takes_device_scan(device) -> bool:
    """The rule of :func:`make_diff_integrator`: a CUDA device, whatever
    collectives the step holds."""
    return torch.device(device).type == "cuda"


def make_diff_integrator(static, cfg, closest, any_hit, param_fields, device,
                         live_sync=None, tex_shard=None):
    """The general differentiable scan for ``param_fields`` on ``closest`` /
    ``any_hit`` (:func:`diff_backend`'s pair, or the exchanges wrapped
    around it).  On a CUDA device it is the device scan
    (``ptx_torch.diff.graphs.DeviceScan``: CUDA graphs of each step's
    forward and backward, the live count read one iteration late), one per
    scene, by :func:`takes_device_scan`; a tp rank's ``live_sync`` and
    ``tex_shard`` go to it, and its forward is cut into graph segments at
    the exchanges.  The host scan (``make_integrator(differentiable=True)``
    with the same hooks) is the CPU's route, the reference the tests hold
    the device scan to (as ``chip_smoke.py`` does on the card); the fast
    path's replay (``ptx_torch.diff.fast``) is a route of its own."""
    if takes_device_scan(device):
        from ptx_torch.diff.graphs import DeviceScan

        return DeviceScan(static, cfg, closest, any_hit,
                          *scan_fields(param_fields), live_sync=live_sync,
                          tex_shard=tex_shard)
    return make_integrator(static, cfg, closest, any_hit, differentiable=True,
                           live_sync=live_sync, tex_shard=tex_shard)


def _resolve_diff_integrator(static, cfg, closest, any_hit, param_fields,
                             device):
    """The general differentiable scan on :func:`diff_backend`
    (:func:`make_diff_integrator`)."""
    return make_diff_integrator(static, cfg, *diff_backend(
        static, cfg, closest, any_hit, param_fields, device), param_fields,
        device)


def _backend(static, cfg, device, closest, any_hit, param_fields):
    if closest is None or any_hit is None:
        from ptx_torch.render import get_backend

        return get_backend(static, cfg, device, param_fields=param_fields)
    return closest, any_hit


def make_loss_fn(static: SceneStatic, cfg: RenderConfig, target: torch.Tensor,
                 param_fields: Sequence[str] = ("mat_albedo", "mat_emissive"),
                 closest=None, any_hit=None):
    """``loss(params, fs, sample_id) -> scalar``: the MSE between one
    rendered sample pass and the target HDR image [P, 3], on the target's
    device.  (Against an n-sample target, single-sample MSE is biased
    dark by the Monte Carlo variance; :func:`make_batch_loss_fn` with the
    same sample set recovers the parameters exactly.)"""
    device = target.device
    closest, any_hit = _backend(static, cfg, device, closest, any_hit,
                                param_fields)
    integrator = _resolve_diff_integrator(static, cfg, closest, any_hit,
                                          param_fields, device)
    n_pixels = cfg.width * cfg.height

    def loss(params, fs: FlatScene, sample_id: int):
        fs = inject_params(fs, params)
        pixel_ids = torch.arange(n_pixels, dtype=torch.int32, device=device)
        sample_ids = torch.full((n_pixels,), int(sample_id), dtype=torch.int32,
                                device=device)
        radiance, _ = integrator(fs, pixel_ids, sample_ids)
        return torch.mean((radiance - target) ** 2)

    return loss


def _sample_ids(g: int, k: int, n: int, device):
    """Sample ids of group ``g`` of ``k`` samples over ``n`` pixels."""
    return g * k + torch.arange(k, dtype=torch.int32,
                                device=device).repeat_interleave(n)


def make_batch_loss_fn(static: SceneStatic, cfg: RenderConfig,
                       target: torch.Tensor, n_samples: int, closest=None,
                       any_hit=None,
                       param_fields: Sequence[str] = ("mat_albedo",
                                                      "mat_emissive")):
    """``loss(params, fs) -> scalar``: the MSE of the *mean over n_samples
    passes* against the target.  With the target rendered from the same
    sample ids the loss is deterministic and its optimum is the true
    parameters.  Samples are fused into launches of k x P rays (k the
    largest divisor of n_samples within MAX_RAYS_PER_LAUNCH)."""
    from ptx_torch.render import MAX_RAYS_PER_LAUNCH

    device = target.device
    closest, any_hit = _backend(static, cfg, device, closest, any_hit,
                                param_fields)
    integrator = _resolve_diff_integrator(static, cfg, closest, any_hit,
                                          param_fields, device)
    n_pixels = cfg.width * cfg.height
    k = max(1, min(n_samples, MAX_RAYS_PER_LAUNCH // max(n_pixels, 1)))
    while n_samples % k:
        k -= 1
    n_groups = n_samples // k

    def loss(params, fs: FlatScene):
        fs = inject_params(fs, params)
        pixel_ids = torch.arange(n_pixels, dtype=torch.int32,
                                 device=device).repeat(k)
        total = torch.zeros((n_pixels, 3), device=device)
        for g in range(n_groups):
            radiance, _ = integrator(fs, pixel_ids,
                                     _sample_ids(g, k, n_pixels, device))
            part = radiance.reshape(k, n_pixels, 3).sum(0)
            total = part if n_groups == 1 else total + part
        radiance = total / n_samples
        return torch.mean((radiance - target) ** 2)

    return loss


@dataclasses.dataclass
class ChunkStats:
    """What :func:`slice_value_and_grad_fn`'s functions ran since
    :meth:`reset`: ``calls`` (values and gradients), ``chunks`` (pixel
    chunks, each a ``ptx.chunk`` span), ``groups`` (sample-group forwards
    handed to the integrator: one a chunk, or twice the groups past the
    launch cap) and ``rays`` (the rays of those forwards)."""

    calls: int = 0
    chunks: int = 0
    groups: int = 0
    rays: int = 0

    def reset(self):
        self.calls = self.chunks = self.groups = self.rays = 0


STATS = ChunkStats()


def _largest_divisor_leq(n: int, cap: int, prefer: int = 128) -> int:
    """Largest divisor of ``n`` that is <= ``cap``, preferring multiples of
    ``prefer`` (the fused shade's lane rule), as
    ``render.resolve_rays_per_batch``."""
    cap = max(1, min(cap, n))
    for m in range(cap // prefer, 0, -1):
        if n % (prefer * m) == 0:
            return prefer * m
    for c in range(cap, 0, -1):
        if n % c == 0:
            return c
    return 1


def make_batch_value_and_grad_fn(static: SceneStatic, cfg: RenderConfig,
                                 target: torch.Tensor, n_samples: int,
                                 closest=None, any_hit=None,
                                 param_fields: Sequence[str] = ("mat_albedo",
                                                                "mat_emissive"),
                                 max_chunk_rays: Optional[int] = None):
    """``vg(params, fs) -> (loss, grads)`` for the objective of
    :func:`make_batch_loss_fn`, with the frame cut into pixel chunks whose
    forward and backward run one chunk after the other, so the residual
    memory is one chunk's.  MSE is additive over pixels, so the chunks'
    gradients sum exactly; the per-pixel mean over samples stays inside a
    chunk, and sample groups past the launch cap run forward twice (once
    for the chunk's mean, without autograd, once before their own
    backward) rather than being saved.  Samples are fused first
    (k per launch), then pixels chunked to fit ``max_chunk_rays``
    (default ``cfg.rays_per_batch`` or MAX_RAYS_PER_LAUNCH).

    With geometry parameters and attached tiles, the tiles are packed once
    per call from the detached parameters (they only select the winners;
    gradients flow through the epilogue's recompute)."""
    device = target.device
    closest, any_hit = _backend(static, cfg, device, closest, any_hit,
                                param_fields)
    integrator = _resolve_diff_integrator(static, cfg, closest, any_hit,
                                          param_fields, device)
    n_pixels = cfg.width * cfg.height
    return slice_value_and_grad_fn(integrator, cfg, target, n_samples,
                                   0, n_pixels, param_fields, max_chunk_rays)


def slice_value_and_grad_fn(integrator, cfg: RenderConfig,
                            target: torch.Tensor, n_samples: int, first: int,
                            count: int, param_fields: Sequence[str],
                            max_chunk_rays: Optional[int] = None):
    """The body of :func:`make_batch_value_and_grad_fn` over the pixels
    ``first .. first + count - 1`` of the frame (``target`` is the whole
    frame's [P, 3]), through the differentiable ``integrator``:
    ``vg(params, fs) -> (loss, grads)``, the slice's sum of squared errors
    and its gradients over ``P * 3``, so the slices of a frame sum to the
    frame's objective.  The slice is cut into chunks and sample groups as
    the whole frame would be (``parallel.dist`` runs one slice per rank)."""
    from ptx_torch.render import MAX_RAYS_PER_LAUNCH

    device = target.device
    n_pixels = cfg.width * cfg.height
    cap = max_chunk_rays or cfg.rays_per_batch or MAX_RAYS_PER_LAUNCH
    k = max(1, min(n_samples, cap))
    while n_samples % k:
        k -= 1
    cp = _largest_divisor_leq(count, max(1, cap // k))
    n_chunks = count // cp
    n_groups = n_samples // k
    geom_params = moves_geometry(param_fields)

    def chunk_value_and_grad(leaves, fs: FlatScene, c: int):
        """Sum of squared errors over pixel chunk ``c`` and its gradients.
        Past the launch cap, the chunk's sum over every sample group runs
        first without autograd; then each group's forward and backward in
        turn, with its share of the cotangent: one group's residuals live
        at a time, and a forward is followed by its own backward (the
        device scan's graphs hold one forward's residuals per step)."""
        fsx = inject_params(fs, leaves, keep_tiles=True)
        lo = first + c * cp
        pixel_ids = (lo + torch.arange(cp, dtype=torch.int32,
                                       device=device)).repeat(k)
        wrt = list(leaves.values())

        def one_group(g):
            STATS.groups += 1
            STATS.rays += k * cp
            radiance, _ = integrator(fsx, pixel_ids, _sample_ids(g, k, cp, device))
            return radiance.reshape(k, cp, 3).sum(0)

        def sse(total):
            return torch.sum((total / n_samples - target[lo:lo + cp]) ** 2)

        if n_groups == 1:
            v = sse(one_group(0))
            return v.detach(), torch.autograd.grad(v, wrt, allow_unused=True)
        with torch.no_grad():
            total = one_group(0)
            for g in range(1, n_groups):
                total = total + one_group(g)
        total.requires_grad_(True)
        v = sse(total)
        cot, = torch.autograd.grad(v, total)
        grads = [None] * len(wrt)
        for g in range(n_groups):
            part = torch.autograd.grad(one_group(g), wrt, cot,
                                       allow_unused=True)
            grads = [b if a is None else a if b is None else a + b
                     for a, b in zip(grads, part)]
        return v.detach(), grads

    denom = float(n_pixels * 3)  # the mean over the [P, 3] image

    def value_and_grad(params, fs: FlatScene):
        if geom_params and fs.ptiles.shape[0] > 0:
            from ptx_torch.kernels.tiles import pack_tris

            with torch.no_grad():
                sgp = {k_: v.detach() for k_, v in params.items()}
                tiles, boxes = pack_tris(inject_params(fs, sgp, keep_tiles=True))
            fs = fs._replace(ptiles=tiles, pboxes=boxes)
        leaves = {k_: v.detach().requires_grad_(True) for k_, v in params.items()}
        tot, grads = 0.0, [0.0] * len(leaves)
        STATS.calls += 1
        for c in range(n_chunks):
            STATS.chunks += 1
            with utils.span("ptx.chunk"):
                v, g = chunk_value_and_grad(leaves, fs, c)
            tot = tot + v
            grads = [a if b is None else a + b for a, b in zip(grads, g)]
        return tot / denom, {
            k_: (torch.zeros_like(x) if isinstance(g, float) else g) / denom
            for (k_, x), g in zip(leaves.items(), grads)}

    value_and_grad.integrator = integrator
    return value_and_grad


def adam(params: Dict[str, torch.Tensor], lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over the leaves ``params`` with optax's
    defaults (betas 0.9 / 0.999, eps 1e-8 outside the root)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def render_grad(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
                target: torch.Tensor,
                param_fields: Sequence[str] = ("mat_albedo", "mat_emissive"),
                sample_id: int = 0):
    """One-shot ``(loss, grads)`` for the given parameter fields."""
    loss_fn = make_loss_fn(static, cfg, target, param_fields)
    params = {k: v.detach().requires_grad_(True)
              for k, v in extract_params(fs, param_fields).items()}
    val = loss_fn(params, fs, sample_id)
    grads = torch.autograd.grad(val, list(params.values()), allow_unused=True)
    return val.detach(), {k: torch.zeros_like(v) if g is None else g
                          for (k, v), g in zip(params.items(), grads)}


def optimize(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
             target: torch.Tensor, init_params: Dict[str, torch.Tensor],
             steps: int = 100, lr: float = 0.05,
             param_clip: Optional[Dict[str, tuple]] = None, progress=None):
    """Adam loop recovering scene parameters from a target image.  Each
    step is one value and gradient of :func:`make_batch_value_and_grad_fn`
    over ``cfg.samples`` samples, one ``torch.optim.Adam`` update (optax's
    defaults: betas 0.9 / 0.999, eps 1e-8 outside the root) and the
    optional box constraints ``param_clip[field] = (lo, hi)``.  Returns
    ``(params, history)``, the loss before each update."""
    vg_fn = make_batch_value_and_grad_fn(static, cfg, target, max(cfg.samples, 1),
                                         param_fields=tuple(init_params))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in init_params.items()}
    opt = adam(params, lr)
    history = []
    for step in range(steps):
        val, grads = vg_fn(params, fs)
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        if param_clip:
            with torch.no_grad():
                for k, p in params.items():
                    if k in param_clip:
                        p.copy_(torch.clamp(p, *param_clip[k]))
        history.append(float(val))
        if progress is not None:
            progress(step, history[-1])
    return {k: p.detach() for k, p in params.items()}, history


# Per-field demo perturbation (initial guess) and box constraints for
# run_inverse_demo and the ``invert`` command.
_DEMO_INITS = {
    "mat_albedo": (lambda fs: torch.full_like(fs.mat_albedo, 0.5), (0.0, 1.0)),
    "mat_emissive": (lambda fs: torch.zeros_like(fs.mat_emissive), (0.0, 100.0)),
    "mat_roughness": (lambda fs: torch.full_like(fs.mat_roughness, 0.5),
                      (0.05, 1.0)),
    "mat_metallic": (lambda fs: torch.zeros_like(fs.mat_metallic), (0.0, 1.0)),
    "sun_energy": (lambda fs: torch.ones_like(fs.sun_energy), (0.0, 1e4)),
    # Geometry: the true vertices moved by 2 % of the scene extent along +y;
    # the optimiser pulls them back through the Moller-Trumbore epilogue.
    "tri_a": (lambda fs: fs.tri_a + 0.02 * float(fs.tri_a.abs().max())
              * torch.tensor([0.0, 1.0, 0.0], device=fs.tri_a.device), None),
}


def run_inverse_demo(scene_path: str, cfg: RenderConfig, steps: int = 100,
                     lr: float = 0.05,
                     param_fields: Sequence[str] = ("mat_albedo", "mat_emissive"),
                     device="cuda"):
    """The ``invert`` command: perturb the given scene parameters, then
    recover them by gradient descent against a render of the unperturbed
    scene, on ``device``."""
    from ptx_torch import render as R

    bad = [f for f in param_fields if f not in _DEMO_INITS]
    if bad:
        raise ValueError(f"no demo init for {bad}; choose from {sorted(_DEMO_INITS)}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    fs, static = R.load_scene(scene_path, quirks=cfg.quirks)
    fs, static = R.ensure_accel(fs, static, cfg, device=dev,
                                param_fields=param_fields)
    n_pixels = cfg.width * cfg.height

    # Target: the unperturbed scene, the mean of cfg.samples passes.
    sample_fn = R.make_sample_fn(static, cfg, dev)
    target = torch.zeros((n_pixels, 3), device=dev)
    with torch.no_grad():
        for s in range(cfg.samples):
            target = target + sample_fn(fs, s)[0]
    target = target / max(cfg.samples, 1)

    true = {f: getattr(fs, f) for f in param_fields}
    init = {f: _DEMO_INITS[f][0](fs) for f in param_fields}
    clip = {f: _DEMO_INITS[f][1] for f in param_fields
            if _DEMO_INITS[f][1] is not None}

    def progress(step, val):
        if step % 10 == 0:
            print(f"step {step:4d} loss {val:.6f}", flush=True)

    params, history = optimize(fs, static, cfg, target, init, steps=steps, lr=lr,
                               param_clip=clip, progress=progress)
    report = "  ".join(
        f"{f} MAE {float((params[f] - true[f]).abs().mean()):.4f}"
        for f in param_fields
    )
    print(f"final loss {history[-1]:.6f}  {report}", flush=True)
    return params, history
