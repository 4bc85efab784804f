#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ptx_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then non-zero):
1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: nvcc builds ``ptx_torch/csrc/*.cu`` (timed);
3. each CUDA kernel against its plain torch version, on the card, at the
   main path's shapes: 32,768 camera rays and 32,768 seeded random rays from
   inside ``arch:300000`` (dead lanes parked, sorted as the wavefront is),
   then ``synthetic:2000`` (4 tiles, identity plan); median times by CUDA
   events;
4. the main path: ``ptx_torch.render.render`` on ``arch:300000`` at
   256x256, 4 spp, 4 bounces with the default config, with every kernel's
   launch count; then 64x64, 2 spp through the kernels against the plain
   brute-force intersector;
5. the CLI writes a PNG.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_SCENE = "arch:300000"
SMALL_SCENE = "synthetic:2000"
LAUNCH_RAYS = 1 << 15
# Kernel agreement with the plain version (share of rays), and the relative
# t agreement where the closest winners differ (a near tie).
MIN_AGREE = 0.9999
TIE_RTOL = 1e-4
# Image agreement of the kernel path with the brute-force path: the same
# tolerance as the CPU slice test against the JAX package.
COLOR_ATOL, MIN_PIXEL_SHARE = 1e-4, 0.99

REPLACES = {
    "exact_gate": ("ptx_torch/csrc/exact_gate.cu",
                   "ptx/kernels/intersect_pallas.py:329"),
    "closest": ("ptx_torch/csrc/tile_sweep.cu",
                "ptx/kernels/intersect_pallas.py:507"),
    "any": ("ptx_torch/csrc/tile_sweep.cu",
            "ptx/kernels/intersect_pallas.py:599"),
}


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def camera_rays(fs, width, height, n, device):
    """The main path's first launch: pixels 0..n-1 of sample 0, sorted by
    the wavefront's ray key."""
    import torch

    from ptx_torch.scene.camera import generate_rays

    pix = torch.arange(n, dtype=torch.int32, device=device)
    orig, dirn = generate_rays(fs, pix, torch.zeros_like(pix), width, height)
    return orig.contiguous(), dirn


def scattered_rays(static, n, seed, device):
    """Second-bounce-like rays: seeded origins inside the scene box, random
    directions, a quarter of the lanes dead and parked, sorted dead-last by
    the wavefront's ray key."""
    import numpy as np
    import torch

    from ptx_torch.kernels import sorting

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    orig = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    keep = torch.as_tensor(rng.random(n) < 0.75, device=device)
    orig = torch.as_tensor(orig, dtype=torch.float32, device=device)
    dirn = torch.as_tensor(d, dtype=torch.float32, device=device)
    orig, dirn = sorting.park(orig, dirn, keep, static)
    key = sorting.ray_keys(orig, dirn, static.aabb_lo, static.aabb_hi)
    perm = torch.argsort(torch.where(keep, key, 1 << 30), stable=True)
    return orig[perm].contiguous(), dirn[perm].contiguous()


def check_kernels(fs, static, ray_sets, label, timing, reps):
    """Kernel vs plain version on the card for each (name, orig, dirn)."""
    import torch

    from ptx_torch import geometry
    from ptx_torch.kernels import intersect_cuda as K
    from ptx_torch.kernels.tiles import HIT_T, _pack_rays

    tiles, boxes = fs.ptiles, fs.pboxes
    errs = {}
    for name, orig, dirn in ray_sets:
        rays, _ = _pack_rays(orig, dirn)
        tag = f"{label}/{name}"
        if boxes.shape[0] > K.SMALL_TILES:
            g_k, n_k = K.exact_gate(rays, boxes)
            g_p, n_p = K._exact_gate(rays, boxes)
            torch.cuda.synchronize()
            if not (torch.equal(g_k, g_p) and torch.equal(n_k, n_p)):
                raise AssertionError(f"{tag}: exact_gate differs from plain")
            errs["exact_gate"] = max(errs.get("exact_gate", 0.0),
                                     float((n_k - n_p).abs().max()))
            plan = K.sort_plan(g_k, n_k)
            log(f"{tag}: exact_gate == plain (bit for bit); "
                f"{float(plan[1].float().mean()):.1f} tiles planned per block")
            if timing is not None:
                timing["exact_gate"] = (
                    median_ms(lambda: K.exact_gate(rays, boxes), reps),
                    median_ms(lambda: K._exact_gate(rays, boxes), reps),
                )
        else:
            plan = K._plan(rays, boxes)

        t_k, tri_k = K.closest_sweep(*plan, rays, tiles)
        t_p, tri_p = K._sweep(*plan, rays, tiles, any_mode=False)
        hit_k, hit_p = t_k < HIT_T, t_p < HIT_T
        if not torch.equal(hit_k, hit_p):
            raise AssertionError(f"{tag}: closest hit mask differs from plain")
        same = (tri_k == tri_p) | ~hit_k
        share = float(same.float().mean())
        flips = int((~same).sum())
        if flips:
            # A differing winner must be a near tie: exact MT t agrees.
            r = orig.shape[0]
            bad = (~same[:r]).nonzero()[:, 0]
            ta = [
                geometry.moller_trumbore(
                    orig[bad], dirn[bad], fs.tri_a[tri[:r][bad].long()],
                    fs.tri_e1[tri[:r][bad].long()], fs.tri_e2[tri[:r][bad].long()],
                )[0]
                for tri in (tri_k, tri_p)
            ]
            rel = float(((ta[0] - ta[1]).abs() / ta[1].abs().clamp(min=1e-30)).max())
            if rel > TIE_RTOL:
                raise AssertionError(f"{tag}: closest winner differs, rel t {rel}")
        if share < MIN_AGREE:
            raise AssertionError(f"{tag}: closest tri agrees on {share:.6f}")
        both = hit_k & hit_p & same
        errs["closest"] = max(errs.get("closest", 0.0),
                              float((t_k[both] - t_p[both]).abs().max())
                              if bool(both.any()) else 0.0)
        log(f"{tag}: closest tri agrees on {share:.6f} of rays "
            f"({flips} near-tie flips), {float(hit_k.float().mean()):.3f} hit")

        a_k = K.any_sweep(*plan, rays, tiles)
        a_p = K._sweep(*plan, rays, tiles, any_mode=True)
        a_share = float((a_k == a_p).float().mean())
        if a_share < MIN_AGREE:
            raise AssertionError(f"{tag}: any agrees on {a_share:.6f}")
        errs["any"] = max(errs.get("any", 0.0), float((a_k - a_p).abs().max()))
        log(f"{tag}: any agrees on {a_share:.6f} of rays, "
            f"{float(a_k.float().mean()):.3f} occluded")
        if timing is not None:
            timing["closest"] = (
                median_ms(lambda: K.closest_sweep(*plan, rays, tiles), reps),
                median_ms(lambda: K._sweep(*plan, rays, tiles, False), reps),
            )
            timing["any"] = (
                median_ms(lambda: K.any_sweep(*plan, rays, tiles), reps),
                median_ms(lambda: K._sweep(*plan, rays, tiles, True), reps),
            )
            for k, (ms, plain) in timing.items():
                log(f"{tag}: {k} kernel {ms:.3f} ms, plain torch {plain:.3f} ms")
    return errs


def image_agreement(a, b):
    d = abs(a.color - b.color).max(-1)
    return (
        float((d <= COLOR_ATOL).mean()),
        float((a.alpha == b.alpha).mean()),
        float((abs(a.image.astype(int) - b.image.astype(int)).max(-1) <= 1).mean()),
    )


def check_png(path, width, height):
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    if (w, h) != (width, height):
        raise AssertionError(f"{path} is {w}x{h}, expected {width}x{height}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ptx_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from ptx_torch import render as R
    from ptx_torch.kernels import _build
    from ptx_torch.kernels import intersect_cuda as K

    dev = torch.device("cuda")

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    print(_build.build_log, file=sys.stderr)

    # 3. kernels vs plain versions at the slice's shapes
    cfg = R.RenderConfig(width=256, height=256, samples=4, bounces=4)
    t0 = time.perf_counter()
    fs_np, static_np = R.load_scene(SLICE_SCENE)
    fs, static = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    log(f"{SLICE_SCENE}: {static.n_tris} triangles, {fs.ptiles.shape[0]} tiles, "
        f"load + BVH + pack {time.perf_counter() - t0:.1f} s")
    timing = {}
    errs = check_kernels(fs, static, [
        ("camera", *camera_rays(fs, 256, 256, LAUNCH_RAYS, dev)),
        ("scattered", *scattered_rays(static, LAUNCH_RAYS, 7, dev)),
    ], SLICE_SCENE, timing, reps=5)
    fs_s, static_s = R.ensure_accel(*R.load_scene(SMALL_SCENE), cfg, device=dev)
    check_kernels(fs_s, static_s, [
        ("camera", *camera_rays(fs_s, 256, 256, LAUNCH_RAYS, dev)),
        ("scattered", *scattered_rays(static_s, LAUNCH_RAYS, 8, dev)),
    ], SMALL_SCENE, None, reps=0)

    # 4. main path: counts reset just before, read just after
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = R.render(fs_np, static_np, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    if not np.isfinite(res.color).all():
        raise AssertionError("main path image is not finite")
    if res.color.shape != (256, 256, 3) or res.image[..., :3].max() == 0:
        raise AssertionError("main path image is black or misshapen")
    paths = cfg.width * cfg.height * cfg.samples
    log(f"main path: {SLICE_SCENE} 256x256 4spp 4 bounces, render() "
        f"{wall:.2f} s = {paths / wall:,.0f} paths/s incl. BVH and upload "
        f"(mean color {res.color.mean():.4f}; {smi})")
    fs_a, static_a = R.ensure_accel(fs_np, static_np, cfg, device=dev)
    sample_fn = R.make_sample_fn(static_a, cfg, dev)
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R.progressive_render(fs_a, static_a, cfg, sample_fn, None, 1, dev)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        log(f"main path, sample loop only (run {rep + 1}): {steady:.3f} s = "
            f"{paths / steady:,.0f} paths/s ({smi})")

    small = dict(width=64, height=64, samples=2, bounces=4)
    r_k = R.render(fs_np, static_np, R.RenderConfig(intersector="pallas", **small),
                   device=dev)
    r_b = R.render(fs_np, static_np, R.RenderConfig(intersector="brute", **small),
                   device=dev)
    color_share, alpha_share, image_share = image_agreement(r_k, r_b)
    log(f"64x64 2spp kernels vs brute: |dcolor|<={COLOR_ATOL} on {color_share:.4f}, "
        f"alpha equal on {alpha_share:.4f}, uint8 within 1 on {image_share:.4f}")
    if min(color_share, alpha_share, image_share) < MIN_PIXEL_SHARE:
        raise AssertionError("kernel path image disagrees with the brute path")

    # 5. CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ptx_torch_smoke.png")
        subprocess.run(
            [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
             SLICE_SCENE, "--width", "128", "--height", "96", "--samples", "2",
             "--bounces", "4", "--out", out],
            cwd=ROOT, check=True, timeout=600,
        )
        check_png(out, 128, 96)
    log("cli: wrote a 128x96 PNG")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    record = []
    for name, (source, replaces) in REPLACES.items():
        ms, plain = timing[name]
        record.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[name],
                           max_abs_err=errs[name], ms=ms, plain_ms=plain))
    log(smi)
    log(json.dumps({"kernels": record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
