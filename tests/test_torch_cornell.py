"""The published Cornell Box through the port's glTF path, on the CPU.

``benchmark/data/cornell/cornell.gltf`` (written by
``benchmark/make_cornell.py`` from the published table in
``benchmark/reference_cornell.py``) loads into the table's triangles,
normals, materials and camera, with no sun; the port's value and gradient
of the image loss on it (``inverse.make_batch_value_and_grad_fn``) agree
with the plain reference's (``reference_cornell`` + ``reference.trace_paths``,
plain torch that imports nothing of the port); and the pixel chunks of
``slice_value_and_grad_fn`` sum to the one-chunk value and gradient, each
a ``ptx.chunk`` span counted in ``inverse.STATS``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port  # noqa: F401  (one torch thread per test process)
from benchmark import reference, reference_cornell
from ptx_torch import render
from ptx_torch.config import Quirks, RenderConfig
from ptx_torch.diff import inverse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLTF = os.path.join(ROOT, "benchmark", "data", "cornell", "cornell.gltf")
# The upstream worker's constants (the configuration's ``semantics``).
SEM = {"emissive_scale": 10.0, "throughput_clamp": 10.0,
       "roughness_floor": 0.05, "clamp_direct_to_light": True,
       "rr_after_bounces": 2, "first_sample_centered": True}
FIELDS = ("mat_albedo", "mat_emissive")
SIZE = dict(width=16, height=16, samples=2, bounces=4)


def _cfg(**kw):
    return RenderConfig(**{**SIZE, "seed": 3_000_000_019, **kw},
                        quirks=Quirks(**SEM))


def _tri_rows(a, e1, e2):
    """Each triangle as the sorted rows of its three corners, float64."""
    corners = np.stack([a, a + e1, a + e2], axis=1).astype(np.float64)
    order = np.lexsort(corners.transpose(2, 0, 1)[::-1], axis=-1)
    return np.take_along_axis(corners, order[..., None], axis=1).reshape(-1, 9)


def _by_corners(rows):
    return np.lexsort(rows.T[::-1])


def test_gltf_loads_the_published_table():
    fs, static = render.load_scene(GLTF)
    arr = reference_cornell.arrays()
    n = static.n_tris
    assert n == 32 == len(arr["a"])
    assert static.has_sun is False and static.n_materials == 4
    assert not static.has_textures and not static.has_translucent
    assert np.all(np.asarray(fs.sun_energy) == 0)
    mine = _tri_rows(fs.tri_a[:n], fs.tri_e1[:n], fs.tri_e2[:n])
    theirs = _tri_rows(arr["a"], arr["e1"], arr["e2"])
    i, j = _by_corners(mine), _by_corners(theirs)
    # The same triangles as sets, to 1e-7 m.
    np.testing.assert_allclose(mine[i], theirs[j], rtol=0, atol=1e-7)
    # Each one's normals (one per quad, into the room) and material.
    for k in ("n0", "n1", "n2"):
        np.testing.assert_allclose(getattr(fs, k)[:n][i], arr[k][j], rtol=0,
                                   atol=1e-7)
    assert np.array_equal(fs.mat_id[:n][i], arr["mat"][j])
    for mine_k, ref_k in (("mat_albedo", "albedo"), ("mat_emissive", "emissive"),
                          ("mat_roughness", "roughness"),
                          ("mat_metallic", "metallic"), ("mat_ior", "ior"),
                          ("mat_opacity", "opacity")):
        np.testing.assert_array_equal(getattr(fs, mine_k), arr[ref_k])
    np.testing.assert_array_equal(fs.cam_origin, arr["cam_origin"])
    np.testing.assert_array_equal(fs.cam_basis, arr["cam_basis"])
    assert np.float32(fs.cam_tan_half_fov) == arr["tan_half_fov"]


def test_the_light_is_the_only_emitter_and_faces_down():
    fs, static = render.load_scene(GLTF)
    n = static.n_tris
    lit = np.asarray(fs.mat_emissive)[fs.mat_id[:n]].max(1) > 0
    assert lit.sum() == 2
    assert np.allclose(fs.n0[:n][lit], [0.0, -1.0, 0.0])
    # Below the ceiling, so the two never tie for a closest hit.
    ceiling = fs.tri_a[:n][:, 1].max()
    assert (fs.tri_a[:n][lit][:, 1] < ceiling).all()


def _port_value_and_grad(cfg, params, max_chunk_rays=None):
    fs, static = render.load_scene(GLTF)
    fs, static = render.ensure_accel(fs, static, cfg, device="cpu",
                                     param_fields=FIELDS)
    n = cfg.width * cfg.height
    target = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    vg = inverse.make_batch_value_and_grad_fn(
        static, cfg, target, cfg.samples, param_fields=FIELDS,
        max_chunk_rays=max_chunk_rays)
    return vg, render.to_device(fs, "cpu"), target


def _tables(seed):
    g = torch.Generator().manual_seed(seed)
    return {"mat_albedo": torch.rand((4, 3), generator=g),
            "mat_emissive": 2.0 * torch.rand((4, 3), generator=g)}


@pytest.mark.parametrize("intersector", ["auto", "bvh"])
@pytest.mark.parametrize("seed", [0, 7])
def test_value_and_grad_match_the_plain_reference(intersector, seed):
    """The port ("auto" is "brute" on the CPU; "bvh" is the card's route)
    against the plain reference over the same paths.  Both run the same
    float32 operations in the same order per path, so the loss agrees to
    rounding (1e-6 relative); a leaf's gradient sums each material's terms
    over every path in another order (autograd's scatter into the [4, 3]
    tables), so it agrees to 1e-5 of the leaf's norm."""
    cfg = _cfg(intersector=intersector)
    params = _tables(seed)
    vg, fs, target = _port_value_and_grad(cfg, params)
    val, grads = vg(params, fs)

    sc, bvh = reference_cornell.load(GLTF, "cpu")
    n, s = cfg.width * cfg.height, cfg.samples
    pix = torch.arange(n).repeat(s)
    smp = torch.arange(s).repeat_interleave(n)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    c, alpha = reference.trace_paths(sc, bvh, SEM, cfg.width, cfg.height,
                                     cfg.bounces, cfg.seed, pix, smp,
                                     params=leaves)
    loss = torch.sum((c.reshape(s, n, 3).sum(0) / s - target) ** 2) / (n * 3)
    ref_grads = torch.autograd.grad(loss, list(leaves.values()))
    assert torch.equal(alpha, torch.ones_like(alpha))  # the walls or the sky
    loss = float(loss.detach())
    assert abs(float(val) - loss) <= 1e-6 * abs(loss)
    for k, r in zip(leaves, ref_grads):
        scale = float(torch.linalg.vector_norm(r))
        assert scale > 0, k
        assert float((grads[k] - r).abs().max()) <= 1e-5 * scale, k


def _chunk_spans(prof, tmp_path) -> int:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "ptx.chunk")


def test_chunks_sum_to_the_whole_and_are_counted(tmp_path):
    """At 16x16 x 2 spp a cap of 128 rays cuts the frame into 4 chunks of
    64 pixels, 512 rays into one; the chunks' squared errors and
    gradients add up to the one chunk's (to 1e-6 relative: the sums'
    order differs).  Each chunk is one ``ptx.chunk`` span and adds to
    ``inverse.STATS``."""
    cfg = _cfg()
    params = _tables(3)
    whole, fs, _ = _port_value_and_grad(cfg, params, max_chunk_rays=512)
    parts, _, _ = _port_value_and_grad(cfg, params, max_chunk_rays=128)
    v1, g1 = whole(params, fs)
    before = dict(vars(inverse.STATS))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        v4, g4 = parts(params, fs)
    after = dict(vars(inverse.STATS))
    assert {k: after[k] - before[k] for k in before} == dict(
        calls=1, chunks=4, groups=4, rays=4 * 64 * 2)
    assert _chunk_spans(prof, tmp_path) == 4
    assert abs(float(v4) - float(v1)) <= 1e-6 * abs(float(v1))
    for k in FIELDS:
        scale = float(torch.linalg.vector_norm(g1[k]))
        assert float((g4[k] - g1[k]).abs().max()) <= 1e-6 * scale, k
    assert parts.integrator is not None


def test_stats_reset():
    inverse.STATS.calls += 1
    inverse.STATS.reset()
    assert dict(vars(inverse.STATS)) == dict(calls=0, chunks=0, groups=0,
                                             rays=0)
