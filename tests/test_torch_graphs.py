"""The device loop (``ptx_torch.integrator.graphs.DeviceLoop``) on the CPU,
where it runs its schedule without capture (static buffers, the live count
read one iteration late, the extra all-dead chunks), against the host loop
(``shade_cuda._eager_integrator``: ``wavefront._chunked_forward``) on the
same fused step: radiance and alpha bit for bit.  The JAX package's
``_chunked_forward`` is the reference of that host loop
(``tests/test_torch_render.py`` holds the port's renders, which now take the
device loop, against it).

``wavefront.CHUNK`` is cut so that launches of a few hundred rays have
several chunks, as the card's 32,768-ray launches have four.
"""

import numpy as np
import pytest
import torch

from ptx_torch import render
from ptx_torch.config import RenderConfig
from ptx_torch.integrator import graphs, wavefront
from ptx_torch.integrator.wavefront import RayState
from ptx_torch.kernels import shade_cuda
from _torch_port import port_scene, stub_cuda_graphs
from test_opacity import stacked_planes_scene


def _loops(fs, static, cfg):
    closest, any_hit = render.get_backend(static, cfg, "cpu", sort=False)
    step = shade_cuda.make_pallas_step(static, cfg, closest, any_hit)
    return (graphs.DeviceLoop(static, cfg, step),
            shade_cuda._eager_integrator(static, cfg, step), step)


def _scene(spec, cfg):
    fs, static = (port_scene(*spec()) if callable(spec)
                  else render.load_scene(spec))
    return render.ensure_accel(fs, static, cfg, device="cpu")


def _ids(cfg, k):
    p = cfg.width * cfg.height
    pixel_ids = torch.arange(p, dtype=torch.int32).repeat(k)
    sample_ids = torch.arange(k, dtype=torch.int32).repeat_interleave(p)
    return pixel_ids, sample_ids


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


# (scene, config, samples per launch, CHUNK): the schedule each exercises.
CASES = {
    # Sun, 10 tiles, compaction: two chunks, the lag's extra chunks.
    "arch-sun-two-chunks": ("arch:2000", dict(width=32, height=16, bounces=6),
                            1, 256),
    # 4 tiles, no compaction: the small sweeps on the whole wavefront.
    "synthetic-small-sweeps": ("synthetic:2000",
                               dict(width=32, height=32, bounces=2), 1, 256),
    # Three 50 % veils, compaction forced: opacity iterations past the
    # bounces and the straggler sort skip.
    "opacity-stragglers": (lambda: stacked_planes_scene(3, 0.5),
                           dict(width=16, height=16, bounces=2, sort_rays="on"),
                           1, 128),
    # Transparent background, three samples in one launch.
    "transparent": ("synthetic:2000", dict(width=16, height=16, bounces=2,
                                           transparent_background=True), 3,
                    256),
    # Four samples in one launch of four chunks.
    "arch-batched": ("arch:2000", dict(width=16, height=16, bounces=3), 4, 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_matches_host_loop(case, monkeypatch):
    spec, size, k, chunk = CASES[case]
    monkeypatch.setattr(wavefront, "CHUNK", chunk)
    cfg = RenderConfig(samples=k, intersector="pallas", shader="pallas", **size)
    fs, static = _scene(spec, cfg)
    loop, eager, _ = _loops(fs, static, cfg)
    ids = _ids(cfg, k)
    want = eager(fs, *ids)
    got = loop(fs, *ids)
    _assert_bit_equal(got, want)
    assert torch.isfinite(got[0]).all() and got[0].sum() > 0
    s = loop.schedule()
    assert s["host_iterations"] <= s["iterations"] <= s["host_iterations"] + 1
    assert s["chunk_steps"] == s["host_chunk_steps"] + s["dead_chunks"]
    assert s["dead_chunks"] >= 0
    if case == "arch-sun-two-chunks":
        assert s["dead_chunks"] > 0  # a lagged count stepped a dead chunk
    if case == "opacity-stragglers":
        assert s["iterations"] > cfg.bounces  # passthrough iterations
        assert 0 < s["sorts"] < s["iterations"]  # the straggler skip
    # A second launch reuses the buffers and gives the same result.
    _assert_bit_equal(loop(fs, *ids), want)


def test_render_takes_the_device_loop():
    cfg = RenderConfig(width=16, height=16, samples=1, bounces=2,
                       intersector="pallas", shader="pallas")
    fs, static = render.load_scene("synthetic:2000")
    assert isinstance(render.make_integrator_for(static, cfg, "cpu"),
                      graphs.DeviceLoop)


def test_dead_chunk_step_is_the_identity(monkeypatch):
    """A step of a chunk whose lanes are all dead (the lag's extra chunks,
    the iteration past the end) leaves every state tensor as it was, bit for
    bit."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    cfg = RenderConfig(width=32, height=16, samples=1, bounces=3,
                       intersector="pallas", shader="pallas")
    fs, static = _scene("arch:2000", cfg)
    loop, _, step = _loops(fs, static, cfg)
    loop(fs, *_ids(cfg, 1))
    state = loop._launches[512].state  # the wavefront after its last bounce
    assert not state.alive.any()
    sun = shade_cuda.sun_constants(fs)
    for it in (1, loop.max_iters):
        for ci in range(2):
            sub = RayState(*(x[ci * 256:(ci + 1) * 256].clone() for x in state))
            _assert_bit_equal(step(fs, it, sub, sun), sub)


def test_another_scene_raises():
    cfg = RenderConfig(width=16, height=8, samples=1, bounces=2,
                       intersector="pallas", shader="pallas")
    fs_np, static = render.ensure_accel(*render.load_scene("synthetic:2000"),
                                        cfg)
    fs = render.to_device(fs_np, "cpu")
    loop, _, _ = _loops(fs, static, cfg)
    ids = _ids(cfg, 1)
    loop(fs, *ids)
    loop(fs, *ids)
    other = render.to_device(fs_np._replace(
        mat_packed=np.array(fs_np.mat_packed)), "cpu")
    with pytest.raises(ValueError, match="another scene"):
        loop(other, *ids)
    with pytest.raises(ValueError, match="multiple of 128"):
        loop(fs, ids[0][:100], ids[1][:100])


def test_device_constant_outlives_any_number_of_others():
    """A captured graph reads ``utils.device_constant``'s tensors by
    pointer for as long as it lives, so the cache never lets one go: after
    300 other distinct constants the first call's tensor is the same live
    object at the same address."""
    from ptx_torch import utils

    first = utils.device_constant((0.25, -0.0, 3.0), "cpu")
    ptr = first.data_ptr()
    others = [utils.device_constant(float(i) + 0.5, "cpu") for i in range(300)]
    assert len({id(t) for t in others}) == 300
    again = utils.device_constant((0.25, -0.0, 3.0), "cpu")
    assert again is first and again.data_ptr() == ptr
    assert torch.equal(again, torch.tensor([0.25, -0.0, 3.0]))


def test_program_is_cut_at_its_exchanges(monkeypatch):
    """``GraphRunner``'s program with CUDA's calls stubbed: a unit with two
    exchanges is captured as three segments, each replayed at its cut and
    followed by its exchange (the last replayed after the capture), so the
    first use runs the work once; a later use replays segment, exchange,
    segment, ... in capture order; each segment adds the launches counted
    while it was captured; a unit without an exchange is one graph; an
    exchange outside a capture runs at once; a failed unit leaves no cut
    open."""
    from ptx_torch.kernels import _build

    log = stub_cuda_graphs(monkeypatch)
    _build.reset_launches()

    def op(name):
        def run(src, dst):
            log.append(name)
            dst.copy_(src + 1)
        return run

    def unit():
        log.append("a")
        _build.LAUNCHES["shade"] += 1
        y = torch.zeros(1)
        graphs.exchange(op("x0"), y, y)
        log.append("b")
        _build.LAUNCHES["closest"] += 2
        graphs.exchange(op("x1"), torch.ones(1), torch.zeros(1))
        log.append("c")

    runner, programs = graphs.GraphRunner(), {}
    runner._run(programs, ("step",), unit, cuda=True)
    assert log == ["begin 0", "a", "end 0", "replay 0", "x0", "begin 1", "b",
                   "end 1", "replay 1", "x1", "begin 2", "c", "end 2",
                   "replay 2"]
    segments = programs[("step",)]
    assert [s[1] for s in segments] == [{"shade": 1}, {"closest": 2}, {}]
    assert [s[2] is None for s in segments] == [False, False, True]
    assert runner.captures == 3 and dict(_build.LAUNCHES)["closest"] == 2
    log.clear()
    runner._run(programs, ("step",), unit, cuda=True)
    assert log == ["replay 0", "x0", "replay 1", "x1", "replay 2"]
    assert _build.LAUNCHES["shade"] == 2 and _build.LAUNCHES["closest"] == 4

    log.clear()
    runner._run(programs, ("sort",), lambda: log.append("s"), cuda=True)
    assert log == ["begin 3", "s", "end 3", "replay 3"]
    assert len(programs[("sort",)]) == 1

    log.clear()
    y = torch.zeros(1)
    graphs.exchange(op("now"), y, y)
    assert log == ["now"] and y.item() == 1.0

    def failing():
        graphs.exchange(op("x"), torch.zeros(1), torch.zeros(1))
        raise RuntimeError("in the second segment")

    log.clear()
    with pytest.raises(RuntimeError, match="second segment"):
        runner._run({}, ("bad",), failing, cuda=True)
    assert log[-1] == "end 5" and graphs._CUTTER is None
    assert runner._open is None and runner._segments is None
    _build.reset_launches()
