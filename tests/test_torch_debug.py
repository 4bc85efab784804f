"""The port's debug views (``ptx_torch.debug.visualize``) against the JAX
package's (``ptx.debug.visualize``), and the CLI's ``--visualize``,
``--checkpoint``, ``--metrics`` and ``--profile`` on the CPU.

Tolerances: every view agrees within 1 in uint8 on >= 99 % of pixels: the
two packages' camera rays differ by an ulp in some components (XLA-CPU
and torch-CPU round ``normalize`` differently), which moves a grazing ray's
node count or the quantized depth and normal of a pixel.  Given the same
camera rays, ``bvh-depth`` (node visits, integers) is exact;
``nan-check`` is exact as it is.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import debug as jdebug
from ptx import render as jrender
from ptx.config import RenderConfig
from ptx_torch import debug, render
from ptx_torch.io import checkpoint as ck
from ptx_torch.io.png import read_png
from _torch_port import port_config, port_scene

SIZE = dict(width=32, height=24, samples=1, bounces=2)


# bvh-depth walks the BVH whatever the intersector: one case covers it.
@pytest.mark.parametrize("mode,intersector", [
    *((m, "auto") for m in debug.MODES),
    *((m, "pallas") for m in debug.MODES if m != "bvh-depth"),
])
def test_visualize_matches_jax(mode, intersector):
    cfg = RenderConfig(intersector=intersector, **SIZE)
    fs, static = jrender.load_scene("arch:2000", device=False)
    got = debug.visualize(*port_scene(fs, static), port_config(cfg), mode,
                          device="cpu")
    want = np.asarray(jdebug.visualize(fs, static, cfg, mode))
    assert got.shape == want.shape == (24, 32, 4) and got.dtype == np.uint8
    if mode == "nan-check":
        np.testing.assert_array_equal(got, want)
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.99
    assert got[..., :3].max() > 0 or mode == "nan-check"


def test_bvh_depth_exact_on_the_same_rays(monkeypatch):
    """The port's ``bvh-depth`` view traced from the JAX package's camera
    rays equals the JAX package's view exactly."""
    cfg = RenderConfig(**SIZE)
    fs, static = jrender.load_scene("arch:2000", device=False)
    jrays = jdebug._primary_rays(jax.tree.map(jnp.asarray, fs), cfg)
    monkeypatch.setattr(debug, "_primary_rays", lambda *_: tuple(
        torch.from_numpy(np.array(x)) for x in jrays))
    got = debug.visualize(*port_scene(fs, static), port_config(cfg),
                          "bvh-depth", device="cpu")
    np.testing.assert_array_equal(
        got, np.asarray(jdebug.visualize(fs, static, cfg, "bvh-depth")))


def test_visualize_rejects_unknown_mode():
    fs, static = render.load_scene("synthetic:500")
    with pytest.raises(ValueError, match="unknown visualization mode"):
        debug.visualize(fs, static, render.RenderConfig(width=8, height=8),
                        "albedo", device="cpu")


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--device", "cpu",
         "--scene", "arch:2000", "--width", "16", "--height", "12",
         "--bounces", "2", *args],
        capture_output=True, text=True, check=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_cli_visualize_bvh_depth(tmp_path):
    out = str(tmp_path / "depth.png")
    run = _cli("--samples", "1", "--visualize", "bvh-depth", "--out", out,
               cwd=tmp_path)
    assert "bvh-depth visualization" in run.stderr
    fs, static = render.load_scene("arch:2000")
    cfg = render.RenderConfig(width=16, height=12, samples=1, bounces=2)
    np.testing.assert_array_equal(
        read_png(out), debug.visualize(fs, static, cfg, "bvh-depth", "cpu"))


def test_cli_checkpoint_metrics_profile(tmp_path):
    out = str(tmp_path / "out.png")
    ckpt = str(tmp_path / "render.ckpt.npz")
    prof = str(tmp_path / "trace")
    run = _cli("--samples", "2", "--intersector", "bvh", "--checkpoint", ckpt,
               "--checkpoint-every", "1", "--metrics", "--profile", prof,
               "--out", out, cwd=tmp_path)
    assert read_png(out).shape == (12, 16, 4)
    assert read_png(str(tmp_path / "out.preview.png")).shape == (12, 16, 4)
    assert ck.load(ckpt).samples_done == 2
    # One launch carries both samples: no checkpoint between launches, and
    # the final write is the one checkpoint phase.
    for phase in ("trace:", "accumulate:", "checkpoint:", "finalize:"):
        assert phase in run.stderr
    (trace,) = glob.glob(os.path.join(prof, "*.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("ptx.sample") == 1, names
    # Run again: the finished checkpoint resumes to the same image.
    image = read_png(out)
    _cli("--samples", "2", "--intersector", "bvh", "--checkpoint", ckpt,
         "--out", out, cwd=tmp_path)
    np.testing.assert_array_equal(read_png(out), image)
