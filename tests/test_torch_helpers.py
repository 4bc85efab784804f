"""The port's small public helpers against their ``ptx`` counterparts on
seeded numpy inputs: ``geometry.Triangles``, ``aabb_intersect``,
``transform_ray``, ``pad_triangles``, ``math.length``, ``srgb_decode`` and
``render.render_gltf``.

Tolerances: the slab test's ``hit`` bit for bit (zero directions and
origins on a slab included), its distances within rtol 1e-6; the padded
soup exact; ``transform_ray``, ``length`` and ``srgb_decode`` within rtol
1e-6 (XLA may contract the products of a dot, and ``rsqrt`` / ``pow``
differ by ulps; ``transform_ray``'s relative to the magnitude of each
component's terms); ``render_gltf`` within the render-parity bound of
``tests/test_torch_render.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import geometry as jgeometry
from ptx import math as jmath
from ptx_torch import geometry, math as pmath
from _torch_port import port_config

RTOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _slab_inputs():
    """Rays [R, 1, 3] against boxes [N, 3]; a third of the direction
    components exactly 0 (either sign), and some of those rays' origins
    exactly on box 0's lower or box 1's upper slab."""
    rng = _rng(1)
    r, n = 96, 12
    lo = rng.uniform(-2.0, 1.0, (n, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2.0, (n, 3))).astype(np.float32)
    orig = rng.uniform(-3.0, 3.0, (r, 3)).astype(np.float32)
    dirn = rng.normal(size=(r, 3)).astype(np.float32)
    zero = rng.uniform(size=(r, 3)) < 1 / 3
    dirn[zero] = np.where(rng.uniform(size=int(zero.sum())) < 0.5, 0.0, -0.0)
    axis = np.argmax(zero, axis=1)
    on_lo = zero.any(1) & (np.arange(r) % 3 == 0)
    on_hi = zero.any(1) & (np.arange(r) % 3 == 1)
    orig[on_lo, axis[on_lo]] = lo[0, axis[on_lo]]
    orig[on_hi, axis[on_hi]] = hi[1, axis[on_hi]]
    return orig[:, None, :], dirn[:, None, :], lo, hi


def test_aabb_intersect_matches_ptx():
    orig, dirn, lo, hi = _slab_inputs()
    want = jgeometry.aabb_intersect(*map(jnp.asarray, (orig, dirn, lo, hi)))
    got = geometry.aabb_intersect(*(torch.from_numpy(x) for x in (orig, dirn,
                                                                   lo, hi)))
    near, far, hit = (np.asarray(x) for x in want)
    # The inputs reach the NaN branch and still hit somewhere.
    with np.errstate(invalid="ignore", divide="ignore"):
        assert np.isnan((lo - orig) * (1.0 / dirn)).any()
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got[2].numpy(), hit)
    np.testing.assert_allclose(got[0].numpy(), near, rtol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), far, rtol=RTOL)


def test_transform_ray_matches_ptx():
    rng = _rng(2)
    orig = rng.uniform(-5.0, 5.0, (257, 3)).astype(np.float32)
    dirn = rng.normal(size=(257, 3)).astype(np.float32)
    basis = rng.normal(size=(3, 3)).astype(np.float32)
    origin = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
    want = jgeometry.transform_ray(*map(jnp.asarray, (orig, dirn, basis,
                                                      origin)))
    got = geometry.transform_ray(*(torch.from_numpy(x) for x in (orig, dirn,
                                                                  basis, origin)))
    # rtol against the size of each component's terms: a component that
    # cancels to near 0 carries the rounding of terms far larger than it.
    mapped = np.abs(dirn) @ np.abs(basis).T
    scales = (np.abs(orig) @ np.abs(basis).T + np.abs(origin),
              mapped / np.linalg.norm(dirn @ basis.T, axis=-1, keepdims=True))
    for g, w, scale in zip(got, want, scales):
        assert (np.abs(g.numpy() - np.asarray(w)) <= RTOL * scale).all()


@pytest.mark.parametrize("n,multiple", [(300, 128), (256, 128), (5, 64)])
def test_pad_triangles_and_triangles_match_ptx(n, multiple):
    rng = _rng(n)
    soup = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    want = jgeometry.Triangles(*jgeometry.pad_triangles(*soup, multiple))
    got = geometry.Triangles(*geometry.pad_triangles(
        *(torch.from_numpy(x) for x in soup), multiple))
    assert got._fields == want._fields
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.valid.shape[0] % multiple == 0 and int(got.valid.sum()) == n


def test_length_and_srgb_decode_match_ptx():
    rng = _rng(3)
    v = rng.normal(size=(64, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(pmath.length(torch.from_numpy(v)).numpy(),
                               np.asarray(jmath.length(jnp.asarray(v))),
                               rtol=RTOL)
    x = rng.uniform(-0.2, 4.0, (1000,)).astype(np.float32)
    got = pmath.srgb_decode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jmath.srgb_decode(jnp.asarray(x))), rtol=RTOL)
    # Round trip through the port's own encode.
    y = x[x > 0.01]
    np.testing.assert_allclose(
        pmath.srgb_decode(pmath.srgb_encode(torch.from_numpy(y))).numpy(), y,
        rtol=1e-5)


def _write_minimal_gltf(tmp_path):
    """A loadable glTF: one triangle in z = 0 and a perspective camera in
    front of it (``tests/test_scene.py``'s writer, one camera node)."""
    import base64
    import json

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    buf = pos.tobytes()
    nodes = [{"mesh": 0, "name": "tri"},
             {"camera": 0, "translation": [0.3, 0.3, 1.5], "name": "camnode0"}]
    g = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "cameras": [{"name": "Cam", "type": "perspective",
                     "perspective": {"yfov": 0.7, "znear": 0.1}}],
        "meshes": [{"name": "tri", "primitives": [
            {"attributes": {"POSITION": 0}}]}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(buf)}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3",
                       "min": [0, 0, 0], "max": [1, 1, 0]}],
    }
    p = tmp_path / "one_tri.gltf"
    p.write_text(json.dumps(g))
    return str(p)


def test_render_gltf_matches_ptx(tmp_path):
    from ptx import render as jrender
    from ptx.config import RenderConfig
    from ptx_torch import render

    path = _write_minimal_gltf(tmp_path)
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2)
    want = jrender.render_gltf(path, cfg)
    got = render.render_gltf(path, port_config(cfg), device="cpu")
    assert got.color.shape == (16, 16, 3) and np.isfinite(got.color).all()
    # The triangle covers part of the frame and shades differently from
    # the background.
    assert got.color.reshape(-1, 3).std(0).max() > 0.01
    dcolor = np.abs(got.color - np.asarray(want.color)).max(-1)
    assert (dcolor <= 1e-4).mean() >= 0.99
    assert (got.alpha == np.asarray(want.alpha)).mean() >= 0.99
    dimg = np.abs(got.image.astype(int) - np.asarray(want.image).astype(int))
    assert (dimg.max(-1) <= 1).mean() >= 0.99
