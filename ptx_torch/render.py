"""High-level single-device rendering API (port of ``ptx/render.py``).

load scene -> attach the traversal tiles -> per-sample wavefront launches ->
running mean (or claim blend) -> ACES/sRGB finalize.  ``RenderConfig`` is
the port's copy of the JAX package's, with the same fields and meanings:

* ``intersector``: "pallas" is the planned tile traversal (the CUDA kernels
  on a CUDA device, their plain versions on the CPU); "bvh" is the
  stackless BVH walk (``csrc/bvh_traverse.cu`` on a CUDA device, the plain
  walk ``accel/traverse.py`` on the CPU); "brute" is the plain brute-force
  sweep; "auto" picks "pallas" on CUDA and follows the JAX package's CPU
  rule otherwise ("brute" up to 65,536 padded triangles, else "bvh").
* ``shader``: "pallas" is the fused shade schedule (the CUDA sun and shade
  kernels on a CUDA device, their plain versions on the CPU); "xla" is the
  plain torch shade stage; "auto" follows the JAX package: "pallas" when a
  launch is a multiple of 128 rays, "xla" otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ptx_torch.config import RenderConfig
from ptx_torch.scene.flatten import FlatScene, SceneStatic
from ptx_torch.integrator import accumulate, graphs
from ptx_torch.integrator.wavefront import make_integrator
from ptx_torch.scene.bridge import to_device, to_host

# Upper bound on rays per integrator launch when auto-picking the launch
# size; measured on a TPU and kept until the card's own sweep replaces it.
MAX_RAYS_PER_LAUNCH = 1 << 15


def load_scene(path: str, device=None, scene_work=None, env_image=None,
               quirks=None, pad_multiple: int = 256
               ) -> Tuple[FlatScene, SceneStatic]:
    """Load + flatten a glTF scene, ``synthetic:<n_tris>[:seed]`` or
    ``arch:<n_tris>`` with the port's copy of the JAX package's host code.  Returns numpy
    arrays when ``device`` is None, else tensors on ``device``.
    ``env_image`` ([H, W, 3] linear, ``ptx_torch.io.hdr.load_env_image``)
    lights the misses of a glTF scene; the generated scenes ignore it, as
    the JAX package's do."""
    if path.startswith("synthetic:"):
        from ptx_torch.scene.synthetic import load_synthetic

        fs, static = load_synthetic(path)
    elif path.startswith("arch:"):
        from ptx_torch.scene.arch import load_arch

        fs, static = load_arch(path)
    else:
        from ptx_torch.scene import gltf
        from ptx_torch.scene.flatten import apply_emissive_strength, flatten

        scene = gltf.load(path, scene_work=scene_work)
        fs, static = flatten(
            scene, pad_multiple=pad_multiple,
            base_dir=os.path.dirname(os.path.abspath(path)),
            env_image=env_image,
        )
        if quirks is not None and quirks.use_emissive_strength:
            fs = apply_emissive_strength(fs, scene)
    return (to_device(fs, device) if device is not None else fs), static


def resolve_intersector(static: SceneStatic, cfg: RenderConfig, device) -> str:
    name = cfg.intersector
    if name == "auto":
        if torch.device(device).type == "cuda":
            name = "pallas"
        else:
            name = "brute" if static.n_tris_padded <= 65536 else "bvh"
    if name not in ("brute", "bvh", "pallas"):
        raise ValueError(f"unknown intersector {name!r}")
    return name


def resolve_shader(cfg: RenderConfig) -> str:
    """The JAX package's rule (``ptx/render.py::resolve_shader``): "auto"
    is "pallas" when the per-launch ray count (the pixel chunk, else the
    frame) is a multiple of 128, else "xla"; "xla" and "pallas" are taken as
    given."""
    if cfg.shader == "auto":
        launch = resolve_rays_per_batch(cfg) or cfg.width * cfg.height
        return "pallas" if launch % 128 == 0 else "xla"
    if cfg.shader not in ("xla", "pallas"):
        raise ValueError(f"unknown shader {cfg.shader!r}")
    return cfg.shader


def ensure_accel(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
                 device=None):
    """Attach the BVH the resolved backend needs: the BVH walk always, the
    tile traversal above 2048 triangles (BVH order makes its 512-wide tiles
    spatially tight), with its tiles packed.  Runs on the host; returns
    tensors on ``device`` (numpy when ``device`` is None)."""
    for obj, cls in ((static, SceneStatic), (cfg, RenderConfig)):
        if not isinstance(obj, cls):
            raise TypeError(f"{type(obj).__module__}.{type(obj).__name__}: "
                            f"expected ptx_torch's {cls.__name__}")
    name = resolve_intersector(static, cfg, device or "cpu")
    fs = to_host(fs)
    needs_bvh = name == "bvh" or (name == "pallas" and static.n_tris > 2048)
    if needs_bvh and static.n_bvh_nodes == 0:
        from ptx_torch.accel import bvh, native

        t0 = time.perf_counter()
        fs, static = bvh.build_bvh(fs, static)
        print(f"BVH: {'native' if native.available() else 'numpy'} builder, "
              f"{static.n_tris} triangles, {static.n_bvh_nodes} nodes in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    if name == "pallas":
        from ptx_torch.kernels.tiles import attach_tiles

        fs = attach_tiles(fs)
    return (to_device(fs, device) if device is not None else fs), static


def get_backend(static: SceneStatic, cfg: RenderConfig, device, sort=None):
    """The intersection backend pair (closest, any_hit).  ``sort=None``
    takes the per-call sorting wrapper from :func:`resolve_sort`; pass
    False when the caller keeps the wavefront sorted itself (the chunked
    forward loop)."""
    name = resolve_intersector(static, cfg, device)
    if name == "brute":
        from ptx_torch.kernels.intersect import make_brute

        pair = make_brute()
    elif name == "bvh":
        from ptx_torch.kernels import traverse_cuda

        if static.n_bvh_nodes == 0:
            raise ValueError("the bvh backend needs ensure_accel() first")
        pair = traverse_cuda.make_backend(static.bvh_leaf_size)
    else:
        from ptx_torch.kernels import intersect_cuda

        pair = intersect_cuda.make_backend()
    if resolve_sort(static, cfg, name) if sort is None else sort:
        from ptx_torch.kernels import sorting

        pair = sorting.make_sorting_backend(*pair, static)
    return pair


def resolve_sort(static: SceneStatic, cfg: RenderConfig, name: str) -> bool:
    """Per-call ray sorting: ``cfg.sort_rays`` "on" and "off" force it;
    "auto" sorts for the tile traversal of a scene of several tiles."""
    from ptx_torch.kernels import sorting

    if cfg.sort_rays == "on":
        return True
    if cfg.sort_rays == "off":
        return False
    return name == "pallas" and sorting.should_compact(static)


def make_integrator_for(static: SceneStatic, cfg: RenderConfig, device):
    # No per-call sorting wrapper: wherever resolve_sort would add one, the
    # chunked forward loop (resolve_compact) keeps the wavefront sorted.
    closest, any_hit = get_backend(static, cfg, device, sort=False)
    if resolve_shader(cfg) == "pallas":
        from ptx_torch.kernels.shade_cuda import make_pallas_integrator

        return make_pallas_integrator(static, cfg, closest, any_hit)
    return make_integrator(static, cfg, closest, any_hit)


def resolve_rays_per_batch(cfg: RenderConfig):
    """Per-launch pixel chunk, or ``None`` for whole-frame launches: frames
    above MAX_RAYS_PER_LAUNCH render in the largest divisor of the pixel
    count that fits it, preferring multiples of 128.  An explicit
    ``cfg.rays_per_batch`` wins."""
    if cfg.rays_per_batch is not None:
        return cfg.rays_per_batch
    n_pixels = cfg.width * cfg.height
    if n_pixels <= MAX_RAYS_PER_LAUNCH:
        return None
    for m in range(MAX_RAYS_PER_LAUNCH // 128, 0, -1):
        if n_pixels % (128 * m) == 0:
            return 128 * m
    for c in range(MAX_RAYS_PER_LAUNCH, 0, -1):
        if n_pixels % c == 0:
            return c if c > 1 else None
    return None


def resolve_samples_per_launch(cfg: RenderConfig, ways: int = 1) -> int:
    """How many image samples one wavefront launch carries.  ``ways`` is
    the ray-sharding degree (dp, or dp * tp in ring mode): the launch cap
    applies to one rank's wavefront, so a dp-sharded frame batches more."""
    if cfg.rays_per_batch is not None:
        return 1
    n_pixels = cfg.width * cfg.height // max(ways, 1)
    if cfg.samples_per_launch is not None:
        return max(1, min(cfg.samples_per_launch, cfg.samples))
    return max(1, min(cfg.samples, MAX_RAYS_PER_LAUNCH // max(n_pixels, 1)))


def make_sample_fn(static: SceneStatic, cfg: RenderConfig, device):
    """``(fs, sample_id) -> (radiance [P, 3], alpha [P])`` for one full-image
    sample, in pixel chunks of :func:`resolve_rays_per_batch`.  For the
    fused integrator on the device loop it is a
    ``integrator.graphs.DevicePass``, which :func:`progressive_render` runs
    as a device program."""
    integrator = make_integrator_for(static, cfg, device)
    n_pixels = cfg.width * cfg.height
    chunk = resolve_rays_per_batch(cfg) or n_pixels
    if n_pixels % chunk:
        raise ValueError(
            f"rays_per_batch {chunk} must divide the pixel count {n_pixels}"
        )
    if isinstance(integrator, graphs.DeviceLoop):
        return graphs.DevicePass(integrator, cfg, device, 0, n_pixels, chunk, 1)

    def sample_pass(fs: FlatScene, sample_id: int):
        parts = [integrator(fs, *graphs.launch_ids(start, chunk, 1, sample_id,
                                                   device))
                 for start in range(0, n_pixels, chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    return sample_pass


def make_batched_sample_fn(static: SceneStatic, cfg: RenderConfig, k: int,
                           device):
    """``(fs, sample0) -> (radiance [k, P, 3], alpha [k, P])``: samples
    ``sample0 .. sample0+k-1`` in one launch of k*P rays.  The RNG is keyed
    by absolute (pixel, sample) ids, so this equals k single launches.  For
    the fused integrator on the device loop it is a
    ``integrator.graphs.DevicePass``, as in :func:`make_sample_fn`."""
    integrator = make_integrator_for(static, cfg, device)
    n_pixels = cfg.width * cfg.height
    if isinstance(integrator, graphs.DeviceLoop):
        return graphs.DevicePass(integrator, cfg, device, 0, n_pixels,
                                 n_pixels, k)

    def batch_pass(fs: FlatScene, sample0: int):
        radiance, alpha = integrator(
            fs, *graphs.launch_ids(0, n_pixels, k, sample0, device))
        return radiance.reshape(k, n_pixels, 3), alpha.reshape(k, n_pixels)

    return batch_pass


def _update_mean(carry, sample_color, sample_alpha, n: int):
    color, alpha = carry
    inv = np.float32(1.0) / np.float32(n + 1)
    return (color * n + sample_color) * inv, (alpha * n + sample_alpha) * inv


def _update_mean_batch(carry, colors, alphas, n: int, count: int):
    """Fold ``count`` valid samples of the k in ``colors`` [k, P, 3] into the
    running mean."""
    color, alpha = carry
    k = colors.shape[0]
    valid = (torch.arange(k, device=colors.device) < count).to(colors.dtype)
    inv = np.float32(1.0) / np.float32(n + count)
    return (
        (color * n + (colors * valid[:, None, None]).sum(0)) * inv,
        (alpha * n + (alphas * valid[:, None]).sum(0)) * inv,
    )


def _claim_step(carry, sample_color, sample_alpha, n: int):
    """One claim-blend step (transparent background), see
    ``accumulate.accumulate_claim``."""
    color, alpha, claimed = carry
    opaque = sample_alpha > 0.5
    claim_now = opaque & ~claimed
    blend = opaque & claimed
    trans_on_claimed = ~opaque & claimed
    inv = np.float32(1.0) / np.float32(n + 1)
    new_color = torch.where(
        claim_now[:, None],
        sample_color,
        torch.where(blend[:, None], (color * n + sample_color) * inv, color),
    )
    new_alpha = torch.where(
        claim_now,
        float(inv),
        torch.where(blend | trans_on_claimed, (alpha * n + sample_alpha) * inv,
                    alpha),
    )
    return new_color, new_alpha, claimed | claim_now


def _update_claim_batch(carry, colors, alphas, n: int, count: int):
    """Claim-blend the first ``count`` samples of the batch, in order."""
    for i in range(count):
        carry = _claim_step(carry, colors[i], alphas[i], n + i)
    return carry


@dataclasses.dataclass
class RenderResult:
    color: np.ndarray  # [H, W, 3] linear HDR mean
    alpha: np.ndarray  # [H, W]
    image: np.ndarray  # [H, W, 4] uint8 (ACES + sRGB)


def render(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
           device="cuda", progress: Optional[Callable] = None,
           checkpoint_path: Optional[str] = None, checkpoint_every: int = 5,
           metrics=None, preview_path: Optional[str] = None) -> RenderResult:
    """Render ``cfg.samples`` progressive samples on ``device``.  ``fs``
    may be numpy arrays or tensors.

    With ``checkpoint_path``, resumes from a compatible checkpoint and
    writes one every ``checkpoint_every`` samples; the absolute-sample-id
    RNG makes the resumed image identical to an uninterrupted run.  Each
    checkpoint also writes a tonemapped preview PNG to ``preview_path``,
    by default ``<checkpoint_path>.preview.png``.  ``metrics``: a
    ``ptx_torch.utils.Metrics`` that takes the loop's phases."""
    fs, static = ensure_accel(fs, static, cfg, device=device)
    k = resolve_samples_per_launch(cfg)
    if k > 1:
        batch_fn, sample_fn = make_batched_sample_fn(static, cfg, k, device), None
    else:
        batch_fn, sample_fn = None, make_sample_fn(static, cfg, device)
    return progressive_render(fs, static, cfg, sample_fn, batch_fn, k, device,
                              progress=progress,
                              checkpoint_path=checkpoint_path,
                              checkpoint_every=checkpoint_every,
                              metrics=metrics, preview_path=preview_path)


def render_gltf(path: str, cfg: RenderConfig, device=None,
                **load_kwargs) -> RenderResult:
    """Load the glTF file ``path`` (``load_kwargs`` go to
    :func:`load_scene`, the config's quirks with them) and render it on
    ``device``, by default the card."""
    fs, static = load_scene(path, quirks=cfg.quirks, **load_kwargs)
    return render(fs, static, cfg, device="cuda" if device is None else device)


def progressive_render(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
                       sample_fn, batch_fn, k: int, device,
                       progress: Optional[Callable] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 5, metrics=None,
                       preview_path: Optional[str] = None, replicate=None,
                       pixels: Optional[Tuple[int, int]] = None
                       ) -> RenderResult:
    """The progressive sample loop: exactly one of ``sample_fn`` (k == 1) and
    ``batch_fn`` (k > 1 samples per launch) traces; the running mean (or
    claim blend) is carried on ``device`` in buffers updated in place and
    read only at a checkpoint, a preview or the end.  Checkpoints (written
    only between launches), resume (copied into the buffers), previews and
    metrics as :func:`render` describes.

    A ``graphs.DevicePass`` (the fused integrator on the device loop) owns
    the carry and folds each launch into it in the launch's epilogue graph,
    as ``ptx``'s donated ``_update_mean*`` / ``_update_claim*`` do; the
    other routes (the plain shader, tp ranks) trace, then fold with
    :func:`_update_mean` / :func:`_update_mean_batch` / :func:`_claim_step`
    / :func:`_update_claim_batch` and copy the result into the carry.  The
    metrics' "trace" phase times the launches (on a device pass, the fold
    too), "accumulate" the fold of the other routes; on a device pass
    "accumulate" holds no work, since its fold runs inside "trace".

    Multi-rank runs (``ptx_torch.parallel.dist.render_distributed``) carry
    only this rank's ``pixels`` = ``(start, stop)``, which its trace
    functions return, and pass ``replicate``
    (``ptx_torch.parallel.multihost.replicator``): the gather of the carry
    applied before each checkpoint write and the final fetch, with the
    rank that writes files (``replicate.writer``) and a barrier after each
    write.  Every rank resumes from the same file, which holds the whole
    image whatever layout wrote it."""
    from ptx_torch.io import checkpoint as ckpt_mod

    start_px, stop_px = pixels if pixels is not None else (0, cfg.width * cfg.height)
    p = stop_px - start_px
    dpass = next((f for f in (sample_fn, batch_fn)
                  if isinstance(f, graphs.DevicePass)), None)
    if dpass is not None:
        carry = dpass.carry
        for c in carry:
            c.zero_()
    else:
        carry = (torch.zeros((p, 3), device=device),
                 torch.zeros((p,), device=device))
        if cfg.transparent_background:
            carry += (torch.zeros((p,), dtype=torch.bool, device=device),)

    start = 0
    fingerprint = None
    if checkpoint_path is not None:
        fingerprint = ckpt_mod.config_fingerprint(cfg)
        loaded = ckpt_mod.load(checkpoint_path, fingerprint)
        if loaded is not None and 0 < loaded.samples_done <= cfg.samples:
            start = loaded.samples_done
            own = slice(start_px, stop_px)
            parts = [loaded.color[own], loaded.alpha[own]]
            if cfg.transparent_background:
                parts.append(loaded.claimed[own] if loaded.claimed is not None
                             else np.zeros(p, bool))
            for c, x in zip(carry, parts):
                c.copy_(torch.as_tensor(x))
        if preview_path is None:
            preview_path = checkpoint_path + ".preview.png"
        if replicate is not None:
            # No rank may write before every rank has read.
            replicate.barrier()

    def write_checkpoint(done: int):
        c = replicate(carry) if replicate is not None else carry
        if replicate is None or replicate.writer:
            color, alpha = c[0].cpu().numpy(), c[1].cpu().numpy()
            ckpt_mod.save(checkpoint_path, ckpt_mod.Checkpoint(
                color=color, alpha=alpha,
                claimed=(c[2].cpu().numpy() if cfg.transparent_background
                         else None),
                samples_done=done, fingerprint=fingerprint,
            ))
            if preview_path is not None:
                from ptx_torch.io.png import write_png

                image = accumulate.finalize(c[0], c[1]).cpu().numpy()
                write_png(preview_path, image.reshape(cfg.height, cfg.width, 4))
        if replicate is not None:
            replicate.barrier()

    def phase(name, items=0.0, block=None):
        if metrics is None:
            return contextlib.nullcontext()
        return metrics.phase(name, items=items, block=block)

    s = start
    last_ckpt = start // checkpoint_every
    while s < cfg.samples:
        count = min(k, cfg.samples - s)
        if dpass is not None:
            # The fold runs in each launch's epilogue, inside "trace".
            with phase("trace", items=p * count, block=carry):
                dpass.accumulate(fs, s, count)
            with phase("accumulate"):
                pass
        else:
            out = []  # block= is read when the phase ends
            with phase("trace", items=p * count, block=out):
                out[:] = (batch_fn(fs, s) if k > 1 else sample_fn(fs, s))
            with phase("accumulate"):
                if k == 1:
                    fold = (_claim_step if cfg.transparent_background
                            else _update_mean)
                    new = fold(carry, *out, s)
                else:
                    fold = (_update_claim_batch if cfg.transparent_background
                            else _update_mean_batch)
                    new = fold(carry, *out, s, count)
                for c, x in zip(carry, new):
                    c.copy_(x)
        s += count
        if progress is not None:
            progress(s, cfg.samples)
        if (checkpoint_path is not None and s // checkpoint_every > last_ckpt
                and s < cfg.samples):
            last_ckpt = s // checkpoint_every
            with phase("checkpoint"):
                write_checkpoint(s)

    if checkpoint_path is not None:
        with phase("checkpoint"):
            write_checkpoint(cfg.samples)

    color, alpha = carry[0], carry[1]
    if replicate is not None:
        color, alpha = replicate((color, alpha))
    with phase("finalize"):
        image = accumulate.finalize(color, alpha)
        h, w = cfg.height, cfg.width
        result = RenderResult(
            color=color.cpu().numpy().reshape(h, w, 3),
            alpha=alpha.cpu().numpy().reshape(h, w),
            image=image.cpu().numpy().reshape(h, w, 4),
        )
    return result
