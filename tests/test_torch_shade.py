"""The port's shade stage (``ptx_torch/kernels/shade_cuda.py``: the plain
versions of the CUDA sun and shade kernels) held against the JAX package's
fused Pallas kernels (``shade_pallas._sun_kernel`` and
``_make_shade_kernel``, interpret mode) on the same seeded inputs.

Tolerance: integer outputs equal, and float outputs within atol 1e-5 /
rtol 1e-4, on >= 99.9 % of lanes (a lane counts only when all its outputs
agree).  XLA-CPU and torch-CPU differ by ulps in cos, sin, sqrt and rsqrt,
and an ulp can flip a ``u < p`` decision, which changes that lane wholly.

Two inputs are ill-conditioned against those ulps, and are treated apart:
* a cone about an axis: near the axis, one ulp of cos(theta) ~ 1 moves
  sin(theta) = sqrt(1 - cos^2) by up to sqrt(2 * 2^-24) ~ 3.5e-4, so the sun
  direction is held to atol SUN_DIR_ATOL on every lane instead;
* GGX lobes of roughness below ~0.1 are such narrow cones, so the shade
  inputs here draw roughness from [0.1, 1).  Lower roughness and the
  roughness floor are held bit for bit against the plain version on the
  card (``chip_smoke.py``) and reached by the slice-level renders.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx.config import Quirks, RenderConfig
from ptx.kernels import intersect_pallas as kp
from ptx.kernels import shade_pallas as sp
from ptx.kernels import sorting as jsorting
from ptx_torch import config as pconfig
from ptx_torch.kernels import _build, shade_cuda
from ptx_torch.kernels import sorting as psorting
from ptx_torch.kernels import tiles as ptiles
from _torch_port import port_config

BOUNCES = 4
MIN_AGREE = 0.999
ATOL, RTOL = 1e-5, 1e-4
SUN_DIR_ATOL = 5e-4
MIN_ROUGHNESS = 0.1
SUN_DIR = np.array([-0.35, 0.85, -0.25], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
SUN_ANGLE = np.float32(0.1)
SUN_ENERGY = (6.0, 5.6, 5.0)
QUIRKS = {"worker": Quirks, "monolithic": Quirks.monolithic,
          "physical": Quirks.physical}
# 1,024 lanes (8 rows of 128), and 65 rows: not a multiple of BLOCK_ROWS.
N_SMALL = 1024
N_PARTIAL = (sp.BLOCK_ROWS + 1) * sp.LANES


def _plane(x, dtype=None):
    x = np.asarray(x) if dtype is None else np.asarray(x).astype(dtype)
    return jnp.asarray(x.reshape(-1, sp.LANES))


def _share(got, want):
    """Share of lanes whose every output agrees: ints equal, floats within
    the tolerance.  ``got`` / ``want``: lists of [R] or [R, 3] arrays."""
    ok = np.ones(got[0].shape[0], bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype.kind == "f":
            close = np.isclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True)
        else:
            close = g == w
        ok &= close.reshape(close.shape[0], -1).all(-1)
    return ok.mean()


def _jax_sun(a, seed, it):
    n_rows = a["pix"].shape[0] // sp.LANES
    fs = types.SimpleNamespace(sun_dir=jnp.asarray(SUN_DIR),
                               sun_angular_radius=jnp.asarray(SUN_ANGLE))
    outs = sp._call_sun(
        None, RenderConfig(seed=seed), jnp.asarray([it], jnp.int32),
        _plane(a["pix"], np.uint32), _plane(a["smp"], np.uint32),
        _plane(a["alive"], np.int32), jnp.asarray(a["normal"]),
        jnp.asarray(a["position"]), fs, n_rows, True,
    )
    sdx, sdy, sdz, sox, soy, soz, exists = (np.asarray(o).reshape(-1) for o in outs)
    return (np.stack([sdx, sdy, sdz], -1), np.stack([sox, soy, soz], -1),
            exists > 0)


@pytest.mark.parametrize("n", [N_SMALL, N_PARTIAL])
def test_sun_matches_pallas(n):
    a = shade_cuda.random_inputs(n, BOUNCES, seed=1)
    seed, it = 7, 3
    t = {k: torch.from_numpy(a[k]) for k in ("pix", "smp", "alive", "normal",
                                             "position")}
    got = shade_cuda._sun_sample(seed, it, t["pix"], t["smp"], t["alive"],
                                 t["normal"], t["position"],
                                 (*map(float, SUN_DIR), float(SUN_ANGLE)))
    want = _jax_sun(a, seed, it)
    d_sun, org, exists = (x.numpy() for x in got)
    np.testing.assert_array_equal(exists, want[2])
    assert _share([org], [want[1]]) >= MIN_AGREE
    np.testing.assert_allclose(d_sun, want[0], rtol=0, atol=SUN_DIR_ATOL)


# A scene box for the parked shadow rays.
BOX = types.SimpleNamespace(aabb_lo=(-12.0, -3.5, -20.25),
                            aabb_hi=(11.0, 17.3, 9.75))


def _jax_shadow_rays(a, seed, it, compact):
    """The JAX package's shadow-ray setup as ``make_pallas_step`` runs it:
    ``_call_sun`` (interpret mode; lanes padded to whole rows of 128, which
    an elementwise kernel ignores), ``sorting.park`` on ``exists & hit``,
    ``intersect_pallas._pack_rays``."""
    n = a["pix"].shape[0]
    pad = -n % sp.LANES
    b = {k: np.concatenate([v, v[:pad]]) for k, v in a.items()}
    d_sun, org, exists = (x[:n] for x in _jax_sun(b, seed, it))
    dirn = d_sun
    if compact:
        org, dirn = (np.asarray(x) for x in jsorting.park(
            jnp.asarray(org), jnp.asarray(d_sun),
            jnp.asarray(exists & a["hit"]), BOX))
    rays, _ = kp._pack_rays(jnp.asarray(org), jnp.asarray(dirn))
    return d_sun, exists, np.asarray(rays)


def _shadow_args(a, seed, it, compact):
    t = {k: torch.from_numpy(a[k]) for k in ("pix", "smp", "alive", "hit",
                                             "normal", "position")}
    park = psorting.park_constants(BOX) if compact else None
    return (seed, it, t["pix"], t["smp"], t["alive"], t["hit"], t["normal"],
            t["position"], (*map(float, SUN_DIR), float(SUN_ANGLE)), park)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n", [N_SMALL, N_PARTIAL, 1000])
def test_shadow_rays_match_pallas(n, compact):
    """The plain shadow-ray setup (``_shadow_rays``, the CUDA kernel's plain
    version) against the JAX package's: ``exists``, the parked rows and the
    padding rows exactly, directions and origins within SUN_DIR_ATOL."""
    a = shade_cuda.random_inputs(n, BOUNCES, seed=12)
    seed, it = 9, 2
    d_sun, exists, rays = (x.numpy() for x in shade_cuda._shadow_rays(
        *_shadow_args(a, seed, it, compact)))
    w_dir, w_exists, w_rays = _jax_shadow_rays(a, seed, it, compact)
    np.testing.assert_array_equal(exists, w_exists)
    assert rays.shape == w_rays.shape == (-(-n // 128) * 128, 8)
    np.testing.assert_array_equal(rays[n:], w_rays[n:])
    kept = (exists & a["hit"]) if compact else np.ones(n, bool)
    np.testing.assert_array_equal(rays[:n][~kept], w_rays[:n][~kept])
    np.testing.assert_allclose(rays[:n][kept], w_rays[:n][kept], rtol=0,
                               atol=SUN_DIR_ATOL)
    np.testing.assert_allclose(d_sun, w_dir, rtol=0, atol=SUN_DIR_ATOL)
    assert 0 < kept.mean() < 1 or not compact


@pytest.mark.parametrize("compact", [True, False])
def test_shadow_rays_equal_the_unfused_chain(compact):
    """The wrapper on CPU tensors equals the chain it replaces on the main
    path (``_sun_sample``, ``sorting.park`` on ``exists & hit``,
    ``tiles._pack_rays``) bit for bit, and counts no launch."""
    n = 1000
    a = shade_cuda.random_inputs(n, BOUNCES, seed=13)
    args = _shadow_args(a, 4, 1, compact)
    _build.reset_launches()
    d_sun, exists, rays = shade_cuda.shadow_rays(*args)
    assert set(_build.LAUNCHES.values()) == {0}
    w_dir, org, w_exists = shade_cuda._sun_sample(*args[:5], *args[6:9])
    dirn = w_dir
    if compact:
        org, dirn = psorting.park(org, w_dir, w_exists & args[5], BOX)
    w_rays, _ = ptiles._pack_rays(org, dirn)
    for got, want in ((d_sun, w_dir), (exists, w_exists), (rays, w_rays)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _jax_shade(a, cfg, has_sun, it):
    n_rows = a["pix"].shape[0] // sp.LANES
    p = {
        "pix": _plane(a["pix"], np.uint32), "smp": _plane(a["smp"], np.uint32),
        "alpha": _plane(a["alpha"]), "alive": _plane(a["alive"], np.int32),
        "bounce": _plane(a["bounce"]), "hit": _plane(a["hit"], np.int32),
        "opacity": _plane(a["opacity"]), "rough": _plane(a["roughness"]),
        "metal": _plane(a["metallic"]), "ior": _plane(a["ior"]),
        "catcher": _plane(a["catcher"]),
    }
    for prefix, key in (("d", "dirn"), ("p", "position"), ("n", "normal"),
                        ("tg", "tangent"), ("tn_", "tnormal"), ("sd", "d_sun")):
        for k, c in enumerate("xyz"):
            p[prefix + c] = _plane(a[key][:, k])
    for prefix, key in (("rad_", "radiance"), ("thr_", "throughput"),
                        ("alb_", "albedo"), ("emi_", "emissive"),
                        ("env_", "env")):
        for k, c in enumerate("rgb"):
            p[prefix + c] = _plane(a[key][:, k])
    if has_sun:
        p["sun_exists"] = _plane(a["sun_exists"], np.int32)
        p["shadow_hit"] = _plane(a["shadow_hit"], np.int32)
    else:  # what make_pallas_step hands the kernel without a sun
        for c in "xyz":
            p["sd" + c] = jnp.zeros((n_rows, sp.LANES), jnp.float32)
        p["sun_exists"] = p["shadow_hit"] = jnp.zeros((n_rows, sp.LANES),
                                                      jnp.int32)
    kernel = sp._make_shade_kernel(types.SimpleNamespace(has_sun=has_sun), cfg)
    energy = jnp.asarray([[*SUN_ENERGY, 0.0]], jnp.float32)
    outs = sp._call_shade(kernel, energy, jnp.asarray([it], jnp.int32),
                          [p[k] for k in sp.SHADE_INPUTS], n_rows, True)
    o = {k: np.asarray(v).reshape(-1) for k, v in zip(sp.SHADE_OUTPUTS, outs)}

    def vec(*names):
        return np.stack([o[k] for k in names], -1)

    return [vec("ox", "oy", "oz"), vec("dx", "dy", "dz"),
            vec("rad_r", "rad_g", "rad_b"), vec("thr_r", "thr_g", "thr_b"),
            o["alpha"], o["alive"] > 0, o["bounce"]]


def _inputs(n, seed):
    a = shade_cuda.random_inputs(n, BOUNCES, seed=seed)
    a["roughness"] = (MIN_ROUGHNESS + (1.0 - MIN_ROUGHNESS) * a["roughness"]
                      ).astype(np.float32)
    return a


def _port_shade(a, cfg, has_sun, it):
    state, h, mat, env, sun = shade_cuda.inputs_from_arrays(a, "cpu")
    out = shade_cuda._shade(cfg, it, state, h, mat, env,
                            sun if has_sun else None,
                            SUN_ENERGY if has_sun else None)
    return [x.numpy() for x in out[:7]]


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("quirks", sorted(QUIRKS))
@pytest.mark.parametrize("has_sun", [True, False])
def test_shade_matches_pallas(has_sun, quirks, transparent):
    cfg = RenderConfig(bounces=BOUNCES, seed=5, quirks=QUIRKS[quirks](),
                       transparent_background=transparent)
    a = _inputs(N_SMALL, seed=2)
    got = _port_shade(a, port_config(cfg), has_sun, it=1)
    want = _jax_shade(a, cfg, has_sun, it=1)
    assert _share(got, want) >= MIN_AGREE
    # Every branch was taken: passthrough, catcher, continue and stop.
    alive_out = got[5]
    assert 0.1 < alive_out.mean() < 0.9
    assert (got[6] < a["bounce"]).any() and (got[6] == a["bounce"]).any()


@pytest.mark.parametrize("has_sun", [True, False])
def test_partial_block_rows_shade_correctly(has_sun):
    cfg = RenderConfig(bounces=BOUNCES, seed=3)
    a = _inputs(N_PARTIAL, seed=4)
    got = _port_shade(a, port_config(cfg), has_sun, it=0)
    want = _jax_shade(a, cfg, has_sun, it=0)
    assert _share(got, want) >= MIN_AGREE


def test_wrappers_run_plain_on_cpu():
    cfg = pconfig.RenderConfig(bounces=BOUNCES)
    a = shade_cuda.random_inputs(256, BOUNCES, seed=6)
    state, h, mat, env, sun = shade_cuda.inputs_from_arrays(a, "cpu")
    sun_consts = (*map(float, SUN_DIR), float(SUN_ANGLE))
    _build.reset_launches()
    got = shade_cuda.shade(cfg, 2, state, h, mat, env, sun, SUN_ENERGY)
    want = shade_cuda._shade(cfg, 2, state, h, mat, env, sun, SUN_ENERGY)
    s_args = (0, 2, state.pixel_ids, state.sample_ids, state.alive, h.hit,
              h.normal, h.position, sun_consts, ((30.0, 20.0, 10.0), 0.5))
    s_got = shade_cuda.shadow_rays(*s_args)
    s_want = shade_cuda._shadow_rays(*s_args)
    assert set(_build.LAUNCHES.values()) == {0}
    for x, y in zip((*got, *s_got), (*want, *s_want)):
        assert torch.equal(x, y)
    # The kernel's semantics: a lane that stops has origin 0.
    stopped = ~got.alive
    assert bool((got.orig[stopped] == 0).all())
