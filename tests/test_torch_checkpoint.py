"""Checkpoint / resume, previews and metrics of the port's sample loop
(``ptx_torch.render.progressive_render``, ``ptx_torch.io.checkpoint``,
``ptx_torch.utils.Metrics``), on in-repo scenes: the cases of
``tests/test_checkpoint.py`` plus the JAX package's checkpoints resuming in
the port and the other way round.

A resumed port render equals the uninterrupted one bit for bit (the RNG is
keyed by absolute sample ids and the running mean is folded in the same
order, batch by batch).  Across packages the image bound of
``tests/test_torch_render.py`` applies.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx.config import Quirks, RenderConfig
from ptx.io import checkpoint as jck
from ptx_torch import render
from ptx_torch.config import RenderConfig as PortConfig
from ptx_torch.integrator import accumulate
from ptx_torch.io import checkpoint as ck
from ptx_torch.io.png import read_png
from ptx_torch.utils import Metrics
from _torch_port import port_config, port_scene
from test_torch_render import _assert_agrees

SCENE = "synthetic:3000"
SIZE = dict(width=16, height=16, bounces=2)


@pytest.fixture(scope="module")
def scene():
    return render.load_scene(SCENE)


def _cfg(samples, **kw):
    return PortConfig(samples=samples, intersector="brute", **SIZE, **kw)


def _equal(a, b):
    for name in ("color", "alpha", "image"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


RESUME_CASES = {
    "k1": dict(samples_per_launch=1),
    "k1-transparent": dict(samples_per_launch=1, transparent_background=True),
    "k2": dict(samples_per_launch=2),
    "k2-transparent": dict(samples_per_launch=2, transparent_background=True),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_bit_identical(scene, tmp_path, case):
    fs, static = scene
    kw = RESUME_CASES[case]
    path = str(tmp_path / "render.ckpt.npz")
    full = render.render(fs, static, _cfg(4, **kw), device="cpu")
    render.render(fs, static, _cfg(2, **kw), device="cpu",
                  checkpoint_path=path, checkpoint_every=1)
    loaded = ck.load(path)
    assert loaded.samples_done == 2
    assert (loaded.claimed is not None) == kw.get("transparent_background", False)
    resumed = render.render(fs, static, _cfg(4, **kw), device="cpu",
                            checkpoint_path=path, checkpoint_every=1)
    _equal(resumed, full)
    assert ck.load(path).samples_done == 4
    # A checkpoint of the full count resumes to a finished image.
    _equal(render.render(fs, static, _cfg(4, **kw), device="cpu",
                         checkpoint_path=path), full)


CADENCE = {
    # (samples, samples per launch, checkpoint_every)
    "k1-every2": (5, 1, 2),
    "k2-every1": (5, 2, 1),
    "k2-every3": (6, 2, 3),
}


@pytest.mark.parametrize("case", sorted(CADENCE))
def test_checkpoint_cadence_matches_jax(tmp_path, monkeypatch, case):
    """Checkpoints at ``s // every > last and s < samples`` (only between
    launches when a launch carries several samples), then the final one:
    the same sample counts as the JAX package writes."""
    samples, k, every = CADENCE[case]
    cfg = RenderConfig(samples=samples, samples_per_launch=k, intersector="brute",
                       width=8, height=8, bounces=1)
    written = {"jax": [], "port": []}
    for name, mod in (("jax", jck), ("port", ck)):
        save = mod.save
        monkeypatch.setattr(mod, "save", lambda p, c, save=save, name=name: (
            written[name].append(c.samples_done), save(p, c))[1])
    fs, static = jrender.load_scene(SCENE, device=False)
    jrender.render(fs, static, cfg, checkpoint_path=str(tmp_path / "j.npz"),
                   checkpoint_every=every)
    render.render(*port_scene(fs, static), port_config(cfg), device="cpu",
                  checkpoint_path=str(tmp_path / "p.npz"), checkpoint_every=every)
    assert written["port"] == written["jax"]
    assert written["port"][-1] == samples and len(written["port"]) > 1


def test_mismatched_config_rejected(scene, tmp_path):
    fs, static = scene
    path = str(tmp_path / "render.ckpt.npz")
    render.render(fs, static, _cfg(2), device="cpu", checkpoint_path=path,
                  checkpoint_every=1)
    other = _cfg(2, seed=9)
    assert ck.load(path, ck.config_fingerprint(other)) is None
    assert ck.load(path, ck.config_fingerprint(_cfg(7))) is not None
    # The other config renders from sample 0 and overwrites the checkpoint.
    fresh = render.render(fs, static, other, device="cpu")
    _equal(render.render(fs, static, other, device="cpu", checkpoint_path=path),
           fresh)
    assert ck.load(path, ck.config_fingerprint(other)).samples_done == 2


def test_missing_checkpoint_file(tmp_path):
    assert ck.load(str(tmp_path / "nope.npz")) is None


def test_preview_matches_checkpoint(scene, tmp_path):
    """Each checkpoint writes a preview that is ``finalize`` of the
    checkpointed accumulator; by default beside the checkpoint."""
    fs, static = scene
    path = str(tmp_path / "render.ckpt.npz")
    preview = str(tmp_path / "partial.preview.png")
    render.render(fs, static, _cfg(3), device="cpu", checkpoint_path=path,
                  checkpoint_every=1, preview_path=preview)
    loaded = ck.load(path)
    expect = accumulate.finalize(torch.as_tensor(loaded.color),
                                 torch.as_tensor(loaded.alpha)).numpy()
    np.testing.assert_array_equal(read_png(preview), expect.reshape(16, 16, 4))
    path2 = str(tmp_path / "render2.ckpt.npz")
    render.render(fs, static, _cfg(3), device="cpu", checkpoint_path=path2)
    assert os.path.exists(path2 + ".preview.png")


def test_fingerprints_match_jax():
    for cfg in (RenderConfig(),
                RenderConfig(width=33, height=17, samples=3, seed=9,
                             intersector="bvh", shader="xla",
                             transparent_background=True, rays_per_batch=128,
                             quirks=Quirks.physical()),
                RenderConfig(samples_per_launch=4, sort_rays="off",
                             environment_factor=(2.0, 1.0, 0.5),
                             quirks=Quirks.monolithic())):
        assert ck.config_fingerprint(port_config(cfg)) == jck.config_fingerprint(cfg)
        # samples is left out: a checkpoint serves any larger target.
        more = dataclasses.replace(cfg, samples=cfg.samples + 5)
        assert ck.config_fingerprint(port_config(more)) == jck.config_fingerprint(cfg)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_resumes_across_packages(tmp_path, direction):
    """A checkpoint one package writes on the CPU resumes in the other, and
    the finished image agrees with the JAX package's uninterrupted one at
    the render bound."""
    cfg2 = RenderConfig(samples=2, intersector="brute", **SIZE)
    cfg4 = dataclasses.replace(cfg2, samples=4)
    fs, static = jrender.load_scene(SCENE, device=False)
    pfs, pstatic = port_scene(fs, static)
    path = str(tmp_path / "render.ckpt.npz")
    if direction == "jax-to-port":
        jrender.render(fs, static, cfg2, checkpoint_path=path)
        got = render.render(pfs, pstatic, port_config(cfg4), device="cpu",
                            checkpoint_path=path)
    else:
        render.render(pfs, pstatic, port_config(cfg2), device="cpu",
                      checkpoint_path=path)
        got = jrender.render(fs, static, cfg4, checkpoint_path=path)
    assert ck.load(path).samples_done == jck.load(path).samples_done == 4
    _assert_agrees(got, jrender.render(fs, static, cfg4), cfg4)


def test_metrics_phases(scene, tmp_path):
    fs, static = scene
    m = Metrics()
    render.render(fs, static, _cfg(3, samples_per_launch=1), device="cpu",
                  checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=1,
                  metrics=m)
    # The device pass folds inside "trace": it has no "accumulate" phase.
    assert set(m.phases) == {"trace", "checkpoint", "finalize"}
    assert m.phases["trace"].calls == 3
    assert m.phases["checkpoint"].calls == 3  # samples 1 and 2, the final 3
    assert m.phases["finalize"].calls == 1
    assert m.phases["trace"].items == 3 * 16 * 16
    assert m.phases["trace"].items_per_s > 0
    report = m.report()
    assert "trace:" in report and "/s" in report
    # block= waits only for CUDA tensors: a CPU tensor passes through.
    with m.phase("other", block=(torch.zeros(2), {"x": torch.ones(1)})):
        pass
    assert m.phases["other"].calls == 1
    # The plain shader traces, then folds in "accumulate".
    plain = Metrics()
    render.render(fs, static, _cfg(2, samples_per_launch=1, shader="xla"),
                  device="cpu", metrics=plain)
    assert set(plain.phases) == {"trace", "accumulate", "finalize"}
    assert plain.phases["trace"].calls == plain.phases["accumulate"].calls == 2
