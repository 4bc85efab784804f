"""The program's spans (``ptx_torch.utils.span``) and the device loop's
counters, on the CPU.

With no profiler recording the program enters no ``record_function``; under
``torch.profiler`` a render's Chrome trace holds a ``ptx.sample`` span per
turn of the sample loop with its launches (``ptx.launch``) inside, and the
image is the same bit for bit.  With CUDA's calls stubbed
(``_torch_port.stub_cuda_graphs``) every graph replay of the device loop
and of the device scan is one ``ptx.replay`` span.  The device loop's
running totals (``DeviceLoop.counters``) follow each launch's
``schedule()`` and wait for no count the loop does not read itself, and
``render --metrics`` reports them.  The gloo worlds of ``tests/test_torch_parallel.py`` count
the ``ptx.exchange`` spans of a tp render.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port  # noqa: F401  (one torch thread per test process)
from _torch_port import stub_cuda_graphs
from ptx_torch import render, utils
from ptx_torch.config import RenderConfig
from ptx_torch.diff import graphs as dgraphs
from ptx_torch.diff import inverse
from ptx_torch.integrator import graphs, wavefront
from ptx_torch.kernels import _build, shade_cuda

# A frame of two launches per sample on the device pass (CHUNK cut to 256
# lanes, so each launch steps two chunks).
SIZE = dict(width=32, height=16, samples=2, bounces=3, rays_per_batch=256)


def _cfg(**kw):
    return RenderConfig(intersector="pallas", shader="pallas", **{**SIZE, **kw})


def _scene(cfg, spec="arch:2000"):
    return render.ensure_accel(*render.load_scene(spec), cfg, device="cpu")


def _spans(prof, tmp_path) -> list:
    """``(name, start, end)`` of each ``ptx.*`` span of a profile's Chrome
    trace, in start order."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("ptx."))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _equal(a, b):
    for name in ("color", "alpha", "image"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_no_record_function_without_a_profiler(monkeypatch):
    """A render on the device pass enters no ``record_function`` while no
    profiler records, and under one enters its spans and renders the same
    image bit for bit."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    cfg = _cfg()
    fs, static = _scene(cfg)
    assert isinstance(render.make_sample_fn(static, cfg, "cpu"),
                      graphs.DevicePass)
    entered = []
    record = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return record(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = render.render(fs, static, cfg, device="cpu")
    assert entered == []
    with _cpu_profile():
        profiled = render.render(fs, static, cfg, device="cpu")
    assert entered.count("ptx.sample") == cfg.samples
    assert entered.count("ptx.launch") == 2 * cfg.samples
    _equal(profiled, plain)
    assert plain.image[..., :3].max() > 0


def test_profiled_render_nests_launches_in_samples(monkeypatch, tmp_path):
    """Under a CPU profiler a render's trace holds one ``ptx.sample`` per
    turn of the sample loop, each enclosing that turn's launches; the CPU
    replays no graph."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    cfg = _cfg(samples=3)
    fs, static = _scene(cfg)
    with _cpu_profile() as prof:
        render.render(fs, static, cfg, device="cpu")
    spans = _spans(prof, tmp_path)
    samples = [s for s in spans if s[0] == "ptx.sample"]
    launches = [s for s in spans if s[0] == "ptx.launch"]
    assert len(samples) == 3 and len(launches) == 6
    for _, start, end in launches:
        inside = [s for s in samples if s[1] <= start and end <= s[2]]
        assert len(inside) == 1
    assert [len([x for x in launches if s[1] <= x[1] <= s[2]])
            for s in samples] == [2, 2, 2]
    assert not any(s[0] == "ptx.replay" for s in spans)


class _FakeEvent:
    waits = 0  # synchronize() calls, all events

    def record(self):
        pass

    def synchronize(self):
        _FakeEvent.waits += 1


def _as_cuda(monkeypatch, launch_class):
    """``launch_class``'s buffers on the CPU, marked as a card's (so the
    runner captures and replays through the stubbed graphs)."""
    init = launch_class.__init__

    def cuda_launch(self, r, device, max_iters, *args):
        init(self, r, device, max_iters, *args)
        self.cuda = True
        self.events = [_FakeEvent() for _ in range(max_iters + 1)]

    monkeypatch.setattr(launch_class, "__init__", cuda_launch)


def test_replay_spans_count_the_replays(monkeypatch, tmp_path):
    """With CUDA's calls stubbed, each graph replay of the device loop (a
    launch's load, sorts and chunk steps; captures replay their programs
    too) and of the device scan (each step's forward and backward) is one
    ``ptx.replay`` span, inside its launch's ``ptx.launch``."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    log = stub_cuda_graphs(monkeypatch)
    _as_cuda(monkeypatch, graphs._Launch)
    _as_cuda(monkeypatch, dgraphs._Launch)
    cfg = _cfg(samples=1)
    fs, static = _scene(cfg)
    fs = render.to_device(fs, "cpu")
    closest, any_hit = render.get_backend(static, cfg, "cpu", sort=False)
    loop = graphs.DeviceLoop(static, cfg, shade_cuda.make_pallas_step(
        static, cfg, closest, any_hit))
    pix = torch.arange(512, dtype=torch.int32)
    smp = torch.zeros_like(pix)
    fields = ("mat_albedo", "mat_emissive")
    pair = inverse.diff_backend(static, cfg, closest, any_hit, fields, "cpu")
    scan = dgraphs.DeviceScan(static, cfg, *pair, *inverse.scan_fields(fields))
    leaves = {f: getattr(fs, f).detach().clone().requires_grad_()
              for f in fields}

    def value_and_grad():
        out = scan(inverse.inject_params(fs, leaves), pix[:256], smp[:256])[0]
        torch.autograd.grad(out.sum(), list(leaves.values()))

    for work in (lambda: loop(fs, pix, smp), value_and_grad):
        work()  # the first use captures, and replays each program once
        for _ in range(2):
            log.clear()
            with _cpu_profile() as prof:
                work()
            replays = sum(x.startswith("replay") for x in log)
            spans = _spans(prof, tmp_path)
            assert replays > 0
            assert sum(s[0] == "ptx.replay" for s in spans) == replays
            outer = [s for s in spans if s[0] == "ptx.launch"]
            assert all(any(o[1] <= s[1] and s[2] <= o[2] for o in outer)
                       for s in spans if s[0] == "ptx.replay")


@pytest.mark.parametrize("bounces", [2, 16])
def test_device_loop_counters_follow_its_schedule(bounces, monkeypatch):
    """Per launch the change of ``DeviceLoop.counters()`` is its
    ``schedule()``: iterations and sorts run, chunk steps x the chunk's
    lanes stepped, and the sum of the live counts entering each iteration
    run; the count entering the last of ``max_iters`` iterations, which
    the loop leaves unread, is added by ``counters()``."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    cfg = _cfg(samples=1, bounces=bounces)
    fs, static = _scene(cfg)
    fs = render.to_device(fs, "cpu")
    closest, any_hit = render.get_backend(static, cfg, "cpu", sort=False)
    loop = graphs.DeviceLoop(static, cfg, shade_cuda.make_pallas_step(
        static, cfg, closest, any_hit))
    ran_out = []
    for n, sample in ((512, 0), (512, 1), (256, 2)):
        pix = torch.arange(n, dtype=torch.int32)
        before = loop.counters()
        loop(fs, pix, torch.full_like(pix, sample))
        s = loop.schedule()
        after = loop.counters()
        diff = {k: after[k] - before[k] for k in after}
        chunk = loop._launches[n].chunk
        assert diff == dict(iterations=s["iterations"], sorts=s["sorts"],
                            lanes_stepped=s["chunk_steps"] * chunk,
                            lanes_live=sum(s["counts"][:s["iterations"]]))
        assert 0 < diff["lanes_live"] <= diff["lanes_stepped"]
        ran_out.append(s["iterations"] == loop.max_iters
                       and s["counts"][-2] > 0)
    # Two bounces end with lanes alive (the owed count); at 16 a launch runs
    # dry first.
    assert all(ran_out) if bounces == 2 else not all(ran_out)


@pytest.mark.parametrize("bounces", [3, 5])
def test_device_loop_counters_wait_for_nothing(bounces, monkeypatch):
    """Launch after launch, the device loop waits on no event but for its
    own reads of the live counts.  The count it leaves unread (the last of
    ``max_iters`` iterations) is taken after the next launch's first read;
    where that launch has written its slot again first (three iterations,
    the same launch shape), the iteration leaves both lane totals, and
    ``counters()`` takes the last launch's with a wait."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    stub_cuda_graphs(monkeypatch)
    _as_cuda(monkeypatch, graphs._Launch)
    cfg = _cfg(samples=1, bounces=bounces)
    fs, static = _scene(cfg)
    fs = render.to_device(fs, "cpu")
    closest, any_hit = render.get_backend(static, cfg, "cpu", sort=False)
    loop = graphs.DeviceLoop(static, cfg, shade_cuda.make_pallas_step(
        static, cfg, closest, any_hit))
    sizes = (512, 512, 256)
    want = dict(iterations=0, sorts=0, lanes_stepped=0, lanes_live=0)
    owed = []  # per launch: (slot, lanes, count) of its unread iteration
    for n, sample in zip(sizes, range(3)):
        pix = torch.arange(n, dtype=torch.int32)
        _FakeEvent.waits = 0
        loop(fs, pix, torch.full_like(pix, sample))
        _, read, steps, _ = loop._last
        assert _FakeEvent.waits == len(read) - 1  # c_2, c_3, ...: its own
        s = loop.schedule()
        chunk = loop._launches[n].chunk
        want["iterations"] += s["iterations"]
        want["sorts"] += s["sorts"]
        want["lanes_stepped"] += s["chunk_steps"] * chunk
        want["lanes_live"] += sum(s["counts"][:s["iterations"]])
        owed.append((len(read), chunk * steps[-1],
                     s["counts"][len(read)]) if len(read) < len(steps)
                    else None)
    dropped = [k for k in range(len(sizes) - 1) if owed[k] is not None
               and sizes[k + 1] == sizes[k] and owed[k][0] <= 2]
    for k in dropped:
        want["lanes_stepped"] -= owed[k][1]
        want["lanes_live"] -= owed[k][2]
    assert loop.counters() == want
    assert any(owed[:-1])
    assert bool(dropped) == (bounces == 3)


def test_metrics_report_the_device_loop_counters(monkeypatch):
    """``render --metrics`` counts the device loop's iterations, sorts and
    lanes over the render and reports the share of live lanes, beside the
    intersector and its entry points' launches (none on the CPU, whose
    wrappers run the plain versions)."""
    monkeypatch.setattr(wavefront, "CHUNK", 256)
    cfg = _cfg()
    fs, static = _scene(cfg)
    m = utils.Metrics()
    render.render(fs, static, cfg, device="cpu", metrics=m)
    c = m.counters
    launches = {f"launches {k}" for k in _build.INTERSECT_LAUNCHES}
    assert set(c) == {"iterations", "sorts", "lanes_stepped",
                      "lanes_live"} | launches
    assert all(c[k] == 0 for k in launches)
    assert m.notes == {"intersector": render.resolve_intersector(
        static, cfg, "cpu")}
    assert f"intersector: {m.notes['intersector']}" in m.report()
    assert 0 < c["lanes_live"] <= c["lanes_stepped"]
    assert c["iterations"] >= 2 * cfg.samples  # two launches a sample
    share = 100 * c["lanes_live"] / c["lanes_stepped"]
    assert f"live lanes: {share:.2f}% of the lanes stepped" in m.report()
