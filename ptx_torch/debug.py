"""Debug visualization modes (port of ``ptx/debug.py``).

* ``depth``      - primary-hit distance as grayscale,
* ``normals``    - shading normal as RGB (n * 0.5 + 0.5),
* ``bvh-depth``  - BVH nodes visited per primary ray as a heat ramp (the
  traversal-cost oracle: ``traverse_cuda.visits``, the CUDA walk on the
  card; a BVH is built when none is attached),
* ``nan-check``  - render one sample pass and report any non-finite pixels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptx_torch.config import RenderConfig
from ptx_torch.scene import camera as pcamera
from ptx_torch.scene.flatten import FlatScene, SceneStatic

MODES = ("depth", "normals", "bvh-depth", "nan-check")


def _primary_rays(fs: FlatScene, cfg: RenderConfig, device):
    n_pixels = cfg.width * cfg.height
    pix = torch.arange(n_pixels, dtype=torch.int32, device=device)
    return pcamera.generate_rays(
        fs, pix, torch.zeros_like(pix), cfg.width, cfg.height, cfg.seed,
        first_sample_centered=True,
    )


def _heat(values):
    """Normalized scalar -> blue->red ramp, uint8 RGBA [P, 4]."""
    v = np.asarray(values, np.float32)
    hi = np.percentile(v, 99.0) or 1.0
    t = np.clip(v / max(hi, 1e-9), 0.0, 1.0)
    rgba = np.zeros((*t.shape, 4), np.uint8)
    rgba[..., 0] = (t * 255).astype(np.uint8)
    rgba[..., 1] = (np.sin(t * np.pi) * 160).astype(np.uint8)
    rgba[..., 2] = ((1.0 - t) * 255).astype(np.uint8)
    rgba[..., 3] = 255
    return rgba


def visualize(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
              mode: str, device="cuda") -> np.ndarray:
    """Render a debug visualization on ``device``; returns [H, W, 4]
    uint8."""
    from ptx_torch.render import ensure_accel, get_backend

    if mode not in MODES:
        raise ValueError(f"unknown visualization mode {mode!r}; pick from {MODES}")
    h, w = cfg.height, cfg.width

    if mode == "bvh-depth":
        from ptx_torch.kernels import traverse_cuda

        cfg_bvh = dataclasses.replace(cfg, intersector="bvh")
        fs, static = ensure_accel(fs, static, cfg_bvh, device=device)
        visits = traverse_cuda.visits(fs, *_primary_rays(fs, cfg, device))
        return _heat(visits.cpu().numpy()).reshape(h, w, 4)

    fs, static = ensure_accel(fs, static, cfg, device=device)

    if mode == "nan-check":
        from ptx_torch.render import make_sample_fn

        radiance, _ = make_sample_fn(static, cfg, device)(fs, 0)
        bad = ~np.isfinite(radiance.cpu().numpy()).all(axis=-1)
        n_bad = int(bad.sum())
        if n_bad:
            idx = np.argwhere(bad)[:16, 0]
            print(f"nan-check: {n_bad} non-finite pixels, first at flat ids "
                  f"{idx.tolist()}")
        else:
            print("nan-check: all pixels finite")
        rgba = np.zeros((bad.shape[0], 4), np.uint8)
        rgba[:, 0] = np.where(bad, 255, 0)
        rgba[:, 3] = 255
        return rgba.reshape(h, w, 4)

    closest, _ = get_backend(static, cfg, device)
    hit = closest(fs, *_primary_rays(fs, cfg, device))
    hit_mask = hit.hit.cpu().numpy()

    if mode == "depth":
        t = np.where(hit_mask, hit.t.cpu().numpy(), np.nan)
        finite = t[np.isfinite(t)]
        lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
        g = np.where(
            np.isfinite(t), 1.0 - (t - lo) / max(hi - lo, 1e-9), 0.0
        )
        rgba = np.zeros((t.shape[0], 4), np.uint8)
        rgba[:, 0] = rgba[:, 1] = rgba[:, 2] = (g * 255).astype(np.uint8)
        rgba[:, 3] = 255
        return rgba.reshape(h, w, 4)

    n = hit.normal.cpu().numpy() * 0.5 + 0.5
    n = np.where(hit_mask[:, None], n, 0.0)
    rgba = np.concatenate(
        [(n * 255).astype(np.uint8), np.full((n.shape[0], 1), 255, np.uint8)],
        axis=1,
    )
    return rgba.reshape(h, w, 4)
