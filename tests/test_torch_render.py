"""The slice as a whole: ``ptx_torch.render.render`` on the CPU held against
``ptx.render.render`` with the same ``RenderConfig`` on the same scene:
``intersector="pallas"`` with the plain shade stage (``shader="xla"``) and
with the fused shade schedule (``shader="pallas"`` and "auto", which the
JAX package runs through its Pallas kernels in interpret mode).

Tolerance: |dcolor| <= 1e-4 on >= 99 % of pixels, alpha equal and the uint8
image within 1 on >= 99 %.  XLA-CPU and torch-CPU differ by ulps in cos,
sqrt and pow, and one ulp can flip a ``u < p`` Monte Carlo decision, which
changes that pixel wholly; the share bounds those pixels.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from ptx import render as jrender
from ptx.config import RenderConfig
from ptx.scene.flatten import flatten
from ptx.scene.gltf import SunData
from ptx.scene.synthetic import make_textured_quads
from ptx_torch import render
from ptx_torch.config import RenderConfig as PortConfig
from _torch_port import port_config, port_scene
from test_opacity import stacked_planes_scene

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


def _sunny_textured_quads():
    """Textured quads lit by a sun: textures and sun NEE in one scene."""
    scene = make_textured_quads(2)
    d = np.array([0.3, 0.8, 0.5], np.float32)
    return flatten(dataclasses.replace(scene, sun=SunData(
        direction=d / np.linalg.norm(d),
        energy=np.array([40.0, 30.0, 20.0], np.float32))))


# The fused shade schedule: (scene, size, shader).  Every launch is a
# multiple of 128 rays, as that schedule needs.
PALLAS_CASES = {
    "arch": ("arch:2000", CASES["arch"][1], "pallas"),
    "arch-auto": ("arch:2000", CASES["arch"][1], "auto"),
    "synthetic": ("synthetic:2000", CASES["synthetic"][1], "pallas"),
    "transparent": ("synthetic:2000", CASES["transparent"][1], "auto"),
    # Textures, sun, one tile.
    "textured": (_sunny_textured_quads, dict(width=32, height=16, samples=2,
                                             bounces=3), "pallas"),
    # Opacity passthrough through three 50 % veils.
    "opacity": (lambda: stacked_planes_scene(3, 0.5),
                dict(width=16, height=16, samples=4, bounces=2), "pallas"),
}


def _load(spec):
    return spec() if callable(spec) else jrender.load_scene(spec, device=False)


def _assert_agrees(got, ref, cfg):
    h, w = cfg.height, cfg.width
    assert got.color.shape == (h, w, 3) and got.image.shape == (h, w, 4)
    assert got.image.dtype == np.uint8 and np.isfinite(got.color).all()
    assert got.color.mean() > 0.01
    dcolor = np.abs(got.color - ref.color).max(-1)
    assert (dcolor <= 1e-4).mean() >= 0.99
    assert (got.alpha == ref.alpha).mean() >= 0.99
    dimg = np.abs(got.image.astype(int) - ref.image.astype(int)).max(-1)
    assert (dimg <= 1).mean() >= 0.99


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case, jax_free_import):
    assert jax_free_import, "importing ptx_torch pulled in jax"
    spec, size = CASES[case]
    cfg = RenderConfig(intersector="pallas", shader="xla", **size)
    fs, static = jrender.load_scene(spec, device=False)
    got = render.render(*port_scene(fs, static), port_config(cfg), device="cpu")
    ref = jrender.render(fs, static, cfg)
    _assert_agrees(got, ref, cfg)


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_pallas_render_matches_jax(case):
    spec, size, shader = PALLAS_CASES[case]
    cfg = RenderConfig(intersector="pallas", shader=shader, **size)
    assert render.resolve_shader(port_config(cfg)) == "pallas"
    fs, static = _load(spec)
    got = render.render(*port_scene(fs, static), port_config(cfg), device="cpu")
    ref = jrender.render(fs, static, dataclasses.replace(cfg, shader="pallas"))
    _assert_agrees(got, ref, cfg)


def test_unaligned_pixel_count_rejected():
    fs, static = render.load_scene("synthetic:500")
    cfg = PortConfig(width=33, height=31, samples=1, bounces=1,
                     intersector="brute", shader="pallas")
    with pytest.raises(ValueError, match="multiple of 128"):
        render.render(fs, static, cfg, device="cpu")


def test_auto_falls_back_for_unaligned():
    fs, static = render.load_scene("synthetic:500")
    cfg = PortConfig(width=33, height=31, samples=1, bounces=1,
                     intersector="brute", shader="auto")
    assert render.resolve_shader(cfg) == "xla"
    res = render.render(fs, static, cfg, device="cpu")  # auto -> xla, no error
    assert np.isfinite(res.color).all()
    ref = render.render(fs, static, dataclasses.replace(cfg, shader="xla"),
                        device="cpu")
    np.testing.assert_array_equal(res.color, ref.color)


def test_resolution_rules():
    _, static = render.load_scene("arch:2000")  # 10 tiles
    cfg = PortConfig()
    assert render.resolve_intersector(static, cfg, "cuda") == "bvh"
    assert render.resolve_intersector(static, cfg, "cpu") == "brute"
    for dev in ("cuda", "cpu"):
        assert render.resolve_intersector(
            static, PortConfig(intersector="bvh"), dev) == "bvh"
    with pytest.raises(ValueError, match="unknown intersector"):
        render.resolve_intersector(static, PortConfig(intersector="kd"), "cpu")
    # The shader rule of ptx/render.py::resolve_shader, on any device.
    for shader, size in (("auto", (32, 24)), ("auto", (33, 31)),
                         ("auto", (1920, 1080)), ("auto", (640, 480)),
                         ("xla", (32, 24)), ("pallas", (32, 24)),
                         ("pallas", (33, 31))):
        c = RenderConfig(shader=shader, width=size[0], height=size[1])
        assert render.resolve_shader(port_config(c)) == jrender.resolve_shader(c)
    assert render.resolve_shader(PortConfig(width=32, height=24)) == "pallas"
    assert render.resolve_shader(PortConfig(width=33, height=31)) == "xla"
    with pytest.raises(ValueError, match="unknown shader"):
        render.resolve_shader(PortConfig(shader="cuda"))
    for rpb, cfg in ((None, RenderConfig(width=32, height=24)),
                     (32768, RenderConfig(width=256, height=256)),
                     (28800, RenderConfig(width=1920, height=1080))):
        pcfg = port_config(cfg)
        assert render.resolve_rays_per_batch(pcfg) == jrender.resolve_rays_per_batch(cfg)
        assert render.resolve_rays_per_batch(pcfg) == rpb
        assert (render.resolve_samples_per_launch(pcfg)
                == jrender.resolve_samples_per_launch(cfg))
    # The port refuses the JAX package's classes.
    jfs, jstatic = jrender.load_scene("synthetic:500", device=False)
    with pytest.raises(TypeError, match="ptx_torch"):
        render.render(jfs, jstatic, PortConfig(width=16, height=16), device="cpu")
    with pytest.raises(TypeError, match="ptx_torch"):
        render.render(*port_scene(jfs, jstatic), RenderConfig(width=16, height=16),
                      device="cpu")


def test_cli_renders_png(tmp_path):
    from ptx_torch.io.png import read_png

    out = tmp_path / "out.png"
    subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
         "synthetic:2000", "--device", "cpu", "--intersector", "pallas",
         "--width", "16", "--height", "12", "--samples", "1", "--bounces", "2",
         "--out", str(out)],
        check=True,
    )
    assert read_png(str(out)).shape == (12, 16, 4)
    # Without torchrun, --distributed is a world of 1 (as in ptx) and
    # writes the same image.
    dist_out = tmp_path / "dist.png"
    run = subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--scene",
         "synthetic:2000", "--device", "cpu", "--intersector", "pallas",
         "--width", "16", "--height", "12", "--samples", "1", "--bounces", "2",
         "--distributed", "--tp", "2", "--out", str(dist_out)],
        capture_output=True, text=True,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert "mesh plan: dp=1 tp=1" in run.stderr
    np.testing.assert_array_equal(read_png(str(dist_out)), read_png(str(out)))
