"""Environment maps in the port: ``ptx_torch.io.hdr`` against the JAX
package's ``ptx.io.hdr`` (RLE reads and ``load_env_image`` identical), an
env-lit render
of a glTF written here against the JAX package's, and ``--env`` through
the CLI.

Tolerance of the renders: the image bound of ``tests/test_torch_render.py``
(|dcolor| <= 1e-4 on >= 99 % of pixels, alpha equal and uint8 within 1 on
>= 99 %).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ptx import render as jrender
from ptx.config import RenderConfig
from ptx.io import hdr as jhdr
from ptx.io import png as jpng
from ptx_torch import render
from ptx_torch.io import hdr
from ptx_torch.io.png import read_png
from _torch_port import port_config
from test_torch_host import _gltf_scene
from test_torch_render import _assert_agrees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sky():
    """An 8x16 sky: a bright, blue upper half, a dark lower half, and a
    seeded speckle so every texel differs."""
    rng = np.random.default_rng(11)
    sky = np.zeros((8, 16, 3), np.float32)
    sky[:4] = [0.4, 0.6, 1.2]
    sky[4:] = [0.05, 0.05, 0.05]
    return sky * (0.5 + rng.random((8, 16, 1), np.float32))


def _rle_hdr(path, rgbe):
    """An RLE-scanline Radiance file of ``rgbe`` [H, W, 4] uint8 (W >= 8):
    each channel of a row as one run of its first byte over the first half
    and literals for the rest."""
    h, w, _ = rgbe.shape
    half = w // 2
    rgbe[:, :half] = rgbe[:, :1]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                    + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            out += bytes([128 + half, rgbe[y, 0, c], w - half])
            out += bytes(rgbe[y, half:, c])
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_hdr_rle_read_identical(tmp_path):
    """RLE scanlines (runs and literals) read alike; a file without the
    Radiance magic is refused.  (Flat files and ``write_hdr``'s bytes:
    ``tests/test_torch_host.py``.)"""
    rgbe = (np.random.default_rng(2).random((4, 16, 4)) * 200 + 20).astype(np.uint8)
    _rle_hdr(str(tmp_path / "rle.hdr"), rgbe)
    got = hdr.read_hdr(str(tmp_path / "rle.hdr"))
    np.testing.assert_array_equal(got, jhdr.read_hdr(str(tmp_path / "rle.hdr")))
    assert got.dtype == np.float32 and got.shape == (4, 16, 3)
    assert (got[:, :8] == got[:, :1]).all() and (got[:, 8:] != got[:, 7:8]).any()
    (tmp_path / "bad.hdr").write_bytes(b"P6 not an hdr\n")
    with pytest.raises(ValueError, match="Radiance"):
        hdr.read_hdr(str(tmp_path / "bad.hdr"))


def test_load_env_image_identical(tmp_path):
    hdr.write_hdr(str(tmp_path / "sky.hdr"), _sky())
    ldr = (np.random.default_rng(4).random((6, 10, 3)) * 255).astype(np.uint8)
    jpng.write_png(str(tmp_path / "sky.png"), ldr)
    for name in ("sky.hdr", "sky.png"):
        got = hdr.load_env_image(str(tmp_path / name))
        want = jhdr.load_env_image(str(tmp_path / name))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shader,intersector", [("xla", "brute"),
                                                ("pallas", "bvh")])
def test_env_lit_render_matches_jax(tmp_path, shader, intersector):
    path = _gltf_scene(tmp_path, glb=False)
    env = _sky()
    cfg = RenderConfig(width=32, height=16, samples=2, bounces=3,
                       shader=shader, intersector=intersector)
    fs, static = jrender.load_scene(path, env_image=env, device=False)
    pfs, pstatic = render.load_scene(path, env_image=env)
    assert pstatic.env_tex == static.env_tex >= 0
    np.testing.assert_array_equal(pfs.tex_texels, np.asarray(fs.tex_texels))
    got = render.render(pfs, pstatic, port_config(cfg), device="cpu")
    _assert_agrees(got, jrender.render(fs, static, cfg), cfg)
    # The sky lights the image: without it the misses are the constant
    # environment factor.
    plain = render.render(*render.load_scene(path), port_config(cfg), device="cpu")
    assert np.abs(got.color - plain.color).max() > 0.1


def test_generated_scenes_ignore_env():
    """``synthetic:`` / ``arch:`` scenes have no environment slot in either
    package: the image is ignored."""
    for spec in ("synthetic:500", "arch:2000"):
        fs, static = render.load_scene(spec, env_image=_sky())
        jfs, jstatic = jrender.load_scene(spec, env_image=_sky(), device=False)
        assert static.env_tex == jstatic.env_tex == -1
        np.testing.assert_array_equal(fs.tex_texels, np.asarray(jfs.tex_texels))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "ptx_torch.cli", "render", "--device", "cpu",
         "--width", "32", "--height", "16", "--samples", "1", "--bounces", "2",
         *args],
        capture_output=True, text=True, check=True, timeout=600, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_cli_env(tmp_path):
    path = _gltf_scene(tmp_path, glb=True)
    sky = str(tmp_path / "sky.hdr")
    hdr.write_hdr(sky, _sky())
    out = str(tmp_path / "env.png")
    _cli("--scene", path, "--env", sky, "--out", out)
    cfg = render.RenderConfig(width=32, height=16, samples=1, bounces=2)
    res = render.render(*render.load_scene(path, env_image=hdr.read_hdr(sky)),
                        cfg, device="cpu")
    np.testing.assert_array_equal(read_png(out), res.image)
    run = _cli("--scene", "synthetic:500", "--env", sky, "--out", out)
    assert "ignored" in run.stderr
