"""The slice as a whole: ``ptx_torch.render.render`` on the CPU held against
``ptx.render.render`` with the same ``RenderConfig(intersector="pallas",
shader="xla")`` on the same scene.

Tolerance: |dcolor| <= 1e-4 on >= 99 % of pixels, alpha equal and the uint8
image within 1 on >= 99 %.  XLA-CPU and torch-CPU differ by ulps in cos,
sqrt and pow, and one ulp can flip a ``u < p`` Monte Carlo decision, which
changes that pixel wholly; the share bounds those pixels.
"""

import subprocess
import sys

import numpy as np
import pytest

from ptx import render as jrender
from ptx.config import RenderConfig
from ptx_torch import render

CASES = {
    # Sun, 10 tiles: exact gate + plan, survivor compaction on.
    "arch": ("arch:2000", dict(width=32, height=24, samples=2, bounces=3)),
    # No sun, 4 tiles: identity plan, no compaction.
    "synthetic": ("synthetic:2000", dict(width=32, height=32, samples=1, bounces=2)),
    # Claim-blend accumulation, three samples in one launch.
    "transparent": ("synthetic:2000", dict(width=16, height=16, samples=3,
                                           bounces=2, transparent_background=True)),
}


@pytest.fixture(scope="module")
def jax_free_import():
    code = ("import sys, ptx_torch.render, ptx_torch.cli; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    return subprocess.run([sys.executable, "-c", code]).returncode == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case, jax_free_import):
    assert jax_free_import, "importing ptx_torch pulled in jax"
    spec, size = CASES[case]
    cfg = RenderConfig(intersector="pallas", shader="xla", **size)
    fs, static = jrender.load_scene(spec, device=False)
    got = render.render(fs, static, cfg, device="cpu")
    ref = jrender.render(fs, static, cfg)
    h, w = cfg.height, cfg.width
    assert got.color.shape == (h, w, 3) and got.image.shape == (h, w, 4)
    assert got.image.dtype == np.uint8 and np.isfinite(got.color).all()
    assert got.color.mean() > 0.01
    dcolor = np.abs(got.color - ref.color).max(-1)
    assert (dcolor <= 1e-4).mean() >= 0.99
    assert (got.alpha == ref.alpha).mean() >= 0.99
    dimg = np.abs(got.image.astype(int) - ref.image.astype(int)).max(-1)
    assert (dimg <= 1).mean() >= 0.99


def test_resolution_rules():
    _, static = jrender.load_scene("arch:2000", device=False)
    cfg = RenderConfig()
    assert render.resolve_intersector(static, cfg, "cuda") == "pallas"
    assert render.resolve_intersector(static, cfg, "cpu") == "brute"
    assert render.resolve_shader(cfg) == "xla"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render.resolve_intersector(static, RenderConfig(intersector="bvh"), "cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render.resolve_shader(RenderConfig(shader="pallas"))
    for rpb, cfg in ((None, RenderConfig(width=32, height=24)),
                     (32768, RenderConfig(width=256, height=256)),
                     (28800, RenderConfig(width=1920, height=1080))):
        assert render.resolve_rays_per_batch(cfg) == jrender.resolve_rays_per_batch(cfg)
        assert render.resolve_rays_per_batch(cfg) == rpb
        assert (render.resolve_samples_per_launch(cfg)
                == jrender.resolve_samples_per_launch(cfg))


def test_cli_renders_png(tmp_path):
    from ptx.io.png import read_png

    out = tmp_path / "out.png"
    subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
         "synthetic:2000", "--device", "cpu", "--intersector", "pallas",
         "--width", "16", "--height", "12", "--samples", "1", "--bounces", "2",
         "--out", str(out)],
        check=True,
    )
    assert read_png(str(out)).shape == (12, 16, 4)
    bad = subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
         "synthetic:2000", "--device", "cpu", "--checkpoint", "x.npz",
         "--out", str(out)],
        capture_output=True, text=True,
    )
    assert bad.returncode != 0 and "ROADMAP" in bad.stderr
