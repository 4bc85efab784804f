"""The port's numeric core held against the JAX package on the same inputs:
RNG, sampling, Moller-Trumbore, camera rays, materials, finalize.

Inputs are made from a seed with numpy and fed to both packages.  Float
tolerances: XLA-CPU and torch-CPU use different cos/sin/sqrt/pow
implementations, which differ by an ulp or two (rtol 1e-6); components that
cross zero get the same bound as an absolute tolerance.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import geometry as jgeometry
from ptx import sampling as jsampling
from ptx.integrator import accumulate as jaccumulate
from ptx.scene import camera as jcamera
from ptx.scene import textures as jtextures
from ptx.scene.arch import load_arch
from ptx.scene.flatten import flatten
from ptx.scene.synthetic import make_textured_quads
from ptx_torch import geometry
from ptx_torch import sampling
from ptx_torch.integrator import accumulate
from ptx_torch.scene import camera, textures
from ptx_torch.scene.bridge import to_device
from _torch_port import port_flat, port_static

N = 4096


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


_WITHOUT_JAX_OR_PTX = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ptx"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import ptx_torch
for mod in pkgutil.walk_packages(ptx_torch.__path__, "ptx_torch."):
    importlib.import_module(mod.name)
import chip_smoke
import ab_trees
import multirank_check
assert multirank_check.layouts(4) == [(4, 1, "reduce"), (2, 2, "reduce"),
                                      (2, 2, "ring"), (1, 4, "reduce"),
                                      (1, 4, "ring")]

from ptx_torch import bench, render as R
import ptx_torch.diff.fast, ptx_torch.diff.graphs, ptx_torch.diff.inverse
from ptx_torch.parallel import dist
assert {"ptx_torch.parallel." + m for m in
        ("mesh", "multihost", "partition", "shard_scene", "dist")} <= set(sys.modules)
fs, static = R.load_scene("synthetic:2000")
cfg = R.RenderConfig(width=16, height=16, samples=1, bounces=2)
res = R.render(fs, static, cfg, device="cpu")
assert res.image.shape == (16, 16, 4)
res = dist.render_distributed(fs, static, cfg, device="cpu")
assert res.image.shape == (16, 16, 4)
bench.run_bench(tiny=True, device="cpu")
print("ok")
"""


def test_port_imports_without_jax():
    """Every module of the port (``ptx_torch.diff`` and
    ``ptx_torch.parallel`` included), a render, a distributed render in a
    world of 1 and the tiny bench (its backward rows run
    ``ptx_torch.diff``), with ``jax`` and the JAX package ``ptx`` refused
    at import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _WITHOUT_JAX_OR_PTX], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PTX_BENCH_FULL": "1",
                              # torch's spinning thread pool, beside the
                              # other test workers, multiplies the run time.
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", out.stderr[-3000:]


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_uniform_bit_exact(seed):
    rng = np.random.default_rng(seed % 1000)
    pix = np.concatenate([
        np.array([0, 1, 2**31 - 1, -1, -2**31, 123456789, -987654321], np.int32),
        rng.integers(-2**31, 2**31, N, dtype=np.int64).astype(np.int32),
    ])
    smp = rng.integers(-2**31, 2**31, pix.shape[0], dtype=np.int64).astype(np.int32)
    for bounce in (0, 1, 9, 40):
        for purpose in (sampling.P_AA_JITTER_X, sampling.P_SUN_PHI, sampling.P_RR):
            ref = _np(jsampling.uniform(jnp.asarray(pix), jnp.asarray(smp),
                                        bounce, purpose, seed))
            got = sampling.uniform(_t(pix), _t(smp), bounce, purpose, seed).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_sampling_matches():
    rng = np.random.default_rng(1)
    u1, u2 = rng.random(N, np.float32), rng.random(N, np.float32)
    cos_t = rng.random(N, np.float32)
    normal, outc, inc = _unit(rng, N), _unit(rng, N), _unit(rng, N)
    rough = rng.uniform(0.05, 1.0, N).astype(np.float32)
    ior = rng.uniform(1.0, 2.5, N).astype(np.float32)
    cases = [
        (jsampling.cone_vec(u1, cos_t, normal),
         sampling.cone_vec(_t(u1), _t(cos_t), _t(normal)), 1e-6),
        (jsampling.importance_diffuse(u1, u2, normal),
         sampling.importance_diffuse(_t(u1), _t(u2), _t(normal)), 1e-6),
        # A GGX lobe at low roughness has cos(theta) within 5e-4 of 1, and
        # sin(theta) = sqrt(1 - cos^2) amplifies a one-ulp difference of the
        # two backends' cos(theta) about 200-fold.
        (jsampling.importance_specular(u1, u2, normal, outc, rough),
         sampling.importance_specular(_t(u1), _t(u2), _t(normal), _t(outc),
                                      _t(rough)), 1e-5),
        (jsampling.fresnel(outc, inc, ior),
         sampling.fresnel(_t(outc), _t(inc), _t(ior)), 1e-6),
    ]
    for ref, got, atol in cases:
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6, atol=atol)


def test_moller_trumbore_matches():
    rng = np.random.default_rng(2)
    orig = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    dirn = _unit(rng, N)
    a = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    # Aim half of the rays at a point inside their triangle.
    aim = a + 0.3 * e1 + 0.3 * e2 - orig
    dirn[::2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[::2]
    e1[3] = 0.0  # a degenerate triangle
    ref = [_np(x) for x in jgeometry.moller_trumbore(orig, dirn, a, e1, e2)]
    got = [x.numpy() for x in geometry.moller_trumbore(
        _t(orig), _t(dirn), _t(a), _t(e1), _t(e2))]
    np.testing.assert_array_equal(got[3], ref[3])
    assert ref[3].mean() > 0.4
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g[ref[3]], r[ref[3]], rtol=1e-6, atol=1e-6)


def test_generate_rays_matches():
    fs, _ = load_arch("arch:2000")
    w, h = 32, 24
    pix = np.tile(np.arange(w * h, dtype=np.int32), 3)
    smp = np.repeat(np.arange(3, dtype=np.int32), w * h)
    jfs = fs._replace(**{k: jnp.asarray(getattr(fs, k))
                         for k in ("cam_origin", "cam_basis", "cam_tan_half_fov")})
    ref = jcamera.generate_rays(jfs, jnp.asarray(pix), jnp.asarray(smp), w, h, 3)
    got = camera.generate_rays(to_device(port_flat(fs), "cpu"), _t(pix), _t(smp),
                               w, h, 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=0, atol=1e-6)


def test_material_lookup_matches():
    fs, static = flatten(make_textured_quads())
    rng = np.random.default_rng(3)
    mat_id = rng.integers(0, fs.mat_albedo.shape[0], N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    jfs = fs._replace(**{k: jnp.asarray(v) for k, v in fs._asdict().items()})
    ref = jtextures.material_lookup(jfs, jnp.asarray(mat_id), jnp.asarray(uv), static)
    got = textures.material_lookup(to_device(port_flat(fs), "cpu"), _t(mat_id),
                                   _t(uv), port_static(static))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), _np(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_finalize_matches():
    rng = np.random.default_rng(4)
    color = rng.exponential(0.7, (N, 3)).astype(np.float32)
    alpha = rng.uniform(-0.2, 1.2, N).astype(np.float32)
    ref = _np(jaccumulate.finalize(jnp.asarray(color), jnp.asarray(alpha)))
    got = accumulate.finalize(_t(color), _t(alpha)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_accumulate_matches():
    rng = np.random.default_rng(5)
    radiance = rng.exponential(0.7, (5, 64, 3)).astype(np.float32)
    alpha = (rng.random((5, 64)) > 0.4).astype(np.float32)
    for jfn, fn in ((jaccumulate.accumulate_mean, accumulate.accumulate_mean),
                    (jaccumulate.accumulate_claim, accumulate.accumulate_claim)):
        ref = jfn(jnp.asarray(radiance), jnp.asarray(alpha))
        got = fn(_t(radiance), _t(alpha))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-6, atol=1e-7)
