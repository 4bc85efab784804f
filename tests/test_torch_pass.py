"""The sample pass as a device program (``ptx_torch.integrator.graphs.
DevicePass``) on the CPU, where it runs its prologue, the device loop and
its epilogue without capture:

* the in-place folds on device scalars (``graphs.fold_mean`` /
  ``fold_claim`` over ``graphs.launch_scalars``) against the plain folds
  of ``ptx_torch.render`` (``_update_mean``, ``_update_mean_batch``,
  ``_claim_step``, ``_update_claim_batch``), bit for bit;
* the ids the prologue writes against the ids of the JAX package's jitted
  ``sample_pass`` / ``chunk_pass`` / ``batch_pass`` (``ptx/render.py``),
  read through a stand-in integrator;
* ``render()`` through the pass against the same render with the host loop
  and eager edges (``shade_cuda._eager_integrator``), bit for bit: a
  chunked frame, batches with a ragged last one, the claim blend, and a
  resume.

``wavefront.CHUNK`` is cut so that launches of a few hundred rays have
several chunks, as in ``tests/test_torch_graphs.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx_torch import render
from ptx_torch.config import RenderConfig
from ptx_torch.integrator import graphs, wavefront
from ptx_torch.kernels import shade_cuda
import _torch_port  # noqa: F401  (one torch thread per test process)

FOLD_CASES = [  # (k, count, n): n up to ~2^23
    (1, 1, 0), (1, 1, 6), (1, 1, (1 << 23) - 1), (2, 2, 3), (2, 1, 40),
    (3, 2, 1000), (4, 4, 77), (4, 1, (1 << 23) - 5),
]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _fold_inputs(seed, k, p=300):
    rng = np.random.default_rng(seed)
    colors = torch.from_numpy(rng.uniform(0, 4, (k, p, 3)).astype(np.float32))
    # Alphas on both sides of the claim threshold, some exactly 0 and 1.
    alphas = torch.from_numpy(
        rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], (k, p)).astype(np.float32))
    carry = (torch.from_numpy(rng.uniform(0, 2, (p, 3)).astype(np.float32)),
             torch.from_numpy(rng.uniform(0, 1, p).astype(np.float32)),
             torch.from_numpy(rng.random(p) < 0.5))
    return colors, alphas, carry


@pytest.mark.parametrize("claim", [False, True], ids=["mean", "claim"])
@pytest.mark.parametrize("k,count,n", FOLD_CASES)
def test_fold_on_device_scalars_matches_plain_fold(k, count, n, claim):
    colors, alphas, carry = _fold_inputs(k * 1000 + count, k)
    if not claim:
        carry = carry[:2]
    if k == 1:
        plain = render._claim_step if claim else render._update_mean
        want = plain(carry, colors[0], alphas[0], n)
    else:
        plain = (render._update_claim_batch if claim
                 else render._update_mean_batch)
        want = plain(carry, colors, alphas, n, count)
    scalars = torch.from_numpy(graphs.launch_scalars(7, n, count, k, claim))
    assert scalars[:2].tolist() == [7, n]
    got = tuple(c.clone() for c in carry)
    fold = graphs.fold_claim if claim else graphs.fold_mean
    fold(got, colors, alphas, scalars[2:].view(torch.float32))
    _assert_bit_equal(got, want)


def _jax_ids(cfg, k, sample0, monkeypatch):
    """The (pixel, sample) ids of the JAX package's jitted sample pass
    (k = 1: ``sample_pass`` / ``chunk_pass``) or ``batch_pass``, read
    through a stand-in integrator that returns them as its radiance."""
    def fake_integrator(fs, pixel_ids, sample_ids):
        rad = jnp.stack([pixel_ids, sample_ids, pixel_ids], -1)
        return rad.astype(jnp.float32), sample_ids.astype(jnp.float32)

    monkeypatch.setattr(jrender, "make_integrator_for",
                        lambda static, cfg: fake_integrator)
    if k == 1:
        rad, _ = jrender.make_sample_fn(None, cfg)({}, sample0)
    else:
        rad, _ = jrender.make_batched_sample_fn(None, cfg, k)({}, sample0)
    rad = np.asarray(rad).reshape(-1, 3).astype(np.int64)
    return rad[:, 0], rad[:, 1]


ID_CASES = {
    # (frame, rays_per_batch, k, the pass's first pixel and pixel count)
    "frame": (dict(width=16, height=16), None, 1, None),
    "chunked-frame": (dict(width=32, height=16), 128, 1, None),
    "batched-frame": (dict(width=16, height=8), None, 3, None),
    "dp-slice": (dict(width=32, height=16), 128, 1, (256, 256)),
    "dp-slice-batched": (dict(width=16, height=16), None, 2, (128, 128)),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_prologue_ids_match_jax_sample_pass(case, monkeypatch):
    size, chunk, k, part = ID_CASES[case]
    from ptx.config import RenderConfig as JaxConfig

    jcfg = JaxConfig(samples=4, bounces=1, rays_per_batch=chunk, **size)
    want_pix, want_smp = _jax_ids(jcfg, k, 5, monkeypatch)
    n = size["width"] * size["height"]
    first, count = part or (0, n)
    if part is not None:  # a rank's slice of the same launches
        want_pix = want_pix.reshape(k, n)[:, first:first + count].ravel()
        want_smp = want_smp.reshape(k, n)[:, first:first + count].ravel()
    cfg = RenderConfig(samples=4, bounces=1, intersector="pallas",
                       shader="pallas", **size)
    fs, static = render.ensure_accel(*render.load_scene("synthetic:2000"), cfg,
                                     device="cpu")
    loop = render.make_integrator_for(static, cfg, "cpu")
    dpass = graphs.DevicePass(loop, cfg, "cpu", first, count,
                              chunk if k == 1 and chunk else count, k)
    seen = []

    def record(self, fs, launch, r):  # the ids as the prologue left them
        seen.append((launch.state.pixel_ids.clone(),
                     launch.state.sample_ids.clone()))

    monkeypatch.setattr(graphs.DeviceLoop, "_loop", record)
    dpass.accumulate(fs, 5, k)
    got_pix = torch.cat([p for p, _ in seen]).numpy()
    got_smp = torch.cat([s for _, s in seen]).numpy()
    np.testing.assert_array_equal(got_pix, want_pix)
    np.testing.assert_array_equal(got_smp, want_smp)
    # The plain sample function's ids are the same.
    eager = torch.cat([graphs.launch_ids(s, dpass.chunk, k, 5, "cpu")[0]
                       for s in dpass._starts()])
    np.testing.assert_array_equal(eager.numpy(), want_pix)


def _host_loop_render(fs, static, cfg, monkeypatch, **kw):
    """``render()`` with the fused step on the host loop and eager edges."""
    def eager(static, cfg, device):
        closest, any_hit = render.get_backend(static, cfg, device, sort=False)
        step = shade_cuda.make_pallas_step(static, cfg, closest, any_hit)
        return shade_cuda._eager_integrator(static, cfg, step)

    with monkeypatch.context() as m:
        m.setattr(render, "make_integrator_for", eager)
        return render.render(fs, static, cfg, device="cpu", **kw)


def _equal(a, b):
    for name in ("color", "alpha", "image"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


RENDER_CASES = {
    # Two 256-ray launches per sample, two chunks each.
    "chunked": ("arch:2000", dict(width=32, height=16, samples=2, bounces=3,
                                  rays_per_batch=256)),
    # Three samples per launch, the last batch one sample (ragged).
    "batched-ragged": ("arch:2000", dict(width=16, height=8, samples=4,
                                         bounces=3, samples_per_launch=3)),
    # The claim blend over batches of three, the last one ragged.
    "claim-batched": ("synthetic:2000", dict(width=16, height=16, samples=4,
                                             bounces=2, samples_per_launch=3,
                                             transparent_background=True)),
    # The claim blend sample by sample over a chunked frame.
    "claim-chunked": ("synthetic:2000", dict(width=16, height=16, samples=2,
                                             bounces=2, rays_per_batch=128,
                                             transparent_background=True)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_through_the_pass_matches_eager_edges(case, monkeypatch):
    monkeypatch.setattr(wavefront, "CHUNK", 128)
    spec, size = RENDER_CASES[case]
    cfg = RenderConfig(intersector="pallas", shader="pallas", **size)
    fs, static = render.load_scene(spec)
    fs, static = render.ensure_accel(fs, static, cfg)
    assert isinstance(render.make_sample_fn(static, cfg, "cpu")
                      if render.resolve_samples_per_launch(cfg) == 1 else
                      render.make_batched_sample_fn(
                          static, cfg, render.resolve_samples_per_launch(cfg),
                          "cpu"), graphs.DevicePass)
    got = render.render(fs, static, cfg, device="cpu")
    want = _host_loop_render(fs, static, cfg, monkeypatch)
    _equal(got, want)
    assert np.isfinite(got.color).all() and got.image[..., :3].max() > 0


def test_resume_through_the_pass(tmp_path, monkeypatch):
    """2 samples with a checkpoint, then 4 resumed from it: equal to an
    uninterrupted 4 through the pass and through the host loop; the pass's
    carry is reset between renders."""
    monkeypatch.setattr(wavefront, "CHUNK", 128)
    cfg = RenderConfig(width=32, height=16, samples=4, bounces=3,
                       rays_per_batch=256, intersector="pallas",
                       shader="pallas")
    fs, static = render.ensure_accel(*render.load_scene("arch:2000"), cfg)
    path = str(tmp_path / "c.npz")
    render.render(fs, static, dataclasses.replace(cfg, samples=2),
                  device="cpu", checkpoint_path=path, checkpoint_every=2)
    resumed = render.render(fs, static, cfg, device="cpu",
                            checkpoint_path=path, checkpoint_every=2)
    whole = render.render(fs, static, cfg, device="cpu")
    _equal(resumed, whole)
    _equal(whole, _host_loop_render(fs, static, cfg, monkeypatch))
    # One pass rendering twice starts from a zero carry each time.
    fs = render.to_device(fs, "cpu")
    dpass = render.make_sample_fn(static, cfg, "cpu")
    first = render.progressive_render(fs, static, cfg, dpass, None, 1, "cpu")
    again = render.progressive_render(fs, static, cfg, dpass, None, 1, "cpu")
    _equal(first, whole)
    _equal(again, whole)
