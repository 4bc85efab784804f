"""The ``cornell`` configuration on the CPU: its glTF is what
``make_cornell.py`` writes, its reference imports nothing of the program
and walks the box as brute force does, its loop (``kinds/inverse_scene.py``)
runs a tiny job correct, and the two readers of its per-layer metrics."""

import ast
import copy
import os

import pytest
import torch

from benchmark import common, make_cornell
from benchmark import reference as ref
from benchmark import reference_cornell as rc
from benchmark.tests import faults, tiny
from benchmark.tests import test_ptxbench_imports as imports

CELL = "cornell.inverse"


def test_make_cornell_writes_the_committed_gltf():
    with open(make_cornell.PATH, encoding="utf-8") as f:
        assert f.read() == make_cornell.text()


def test_reference_loads_nothing_of_the_program():
    loaded = imports._loaded_after("import benchmark.reference_cornell")
    assert "ptx_torch" not in loaded
    assert not loaded & set(common.FORBIDDEN)
    with open(os.path.join(common.BENCH, "reference_cornell.py")) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "numpy", "torch", "benchmark"}


def test_walk_finds_the_brute_force_closest_hit():
    """Rays from inside the box and from the camera, in every direction."""
    sc, bvh = rc.load(None, "cpu")
    g = torch.Generator().manual_seed(0)
    inside = torch.rand((512, 3), generator=g) * 0.5 + 0.02
    orig = torch.cat([inside, sc["cam_origin"].expand(128, 3)])
    dirn = ref.normalize(torch.randn((640, 3), generator=g))
    t, tri, hit, nodes, tests = ref.walk(bvh, orig, dirn)
    bt, _, _, ok = ref.moller_trumbore(orig[:, None], dirn[:, None],
                                       sc["a"][None], sc["e1"][None],
                                       sc["e2"][None])
    assert torch.equal(hit, ok.any(1))
    assert torch.equal(t[hit], bt.min(1).values[hit])
    # Closed but for its front: most rays from inside hit, some leave.
    assert 0.5 < float(hit[:512].float().mean()) < 1.0
    assert torch.equal(ref.any_hit(bvh, orig, dirn), hit)


def test_sun_term_is_zero():
    sc, _ = rc.load(None, "cpu")
    assert float(sc["sun_energy"].abs().sum()) == 0.0
    assert len(rc.QUADS) == 16 and sc["a"].shape == (32, 3)


def _tiny(job=None):
    c = copy.deepcopy(common.cell(CELL))
    c["traffic"]["job"] = job or {"width": 16, "height": 16, "samples": 2,
                                  "bounces": 3}
    c["traffic"]["trace_steps"] = 2
    return c


def _run(trace, seed=3_000_000_019, fault=None):
    import contextlib
    import io

    from benchmark import run

    out = io.StringIO()
    with tiny._planted(fault), contextlib.redirect_stdout(out):
        code = run.run(tiny._args(CELL, seed, 0.5, trace), _tiny())
    return code, tiny._line(out.getvalue())


@pytest.mark.parametrize("trace", [0, 1])
def test_the_loop_runs_correct(trace):
    code, line = _run(trace)
    assert code == 0 and line["correct"] is True, line
    if trace:
        # The counter reads on the CPU; the span's idle needs a card's trace.
        assert line["metrics"]["chunks_per_step.cornell"]["value"] == 1.0
        assert "chunk_idle_pct.cornell" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"grad_paths_per_s", "step_ms_p95",
                                        "setup_s"}


@pytest.mark.parametrize("fault", [faults.inverse_unchanged,
                                   faults.inverse_half_batch,
                                   faults.inverse_altered],
                         ids=lambda f: f.__name__)
def test_a_fault_under_the_loop_reads_not_correct(fault):
    code, line = _run(0, fault=fault)
    assert code == 0 and line["correct"] is False, line["checks"]


def test_half_batch_reads_not_correct():
    import types

    from benchmark.control import verdict
    from benchmark.kinds import inverse_scene
    from benchmark.kinds.inverse import FIRST_STEPS, judge

    c = _tiny()
    ctx = types.SimpleNamespace(config=c["config"], traffic=c["traffic"],
                                seed=11, device=torch.device("cpu"),
                                log=lambda msg: None)
    cfg = inverse_scene.render_config(ctx.config, ctx.traffic, ctx.seed)
    g = torch.Generator().manual_seed(2)
    target = torch.rand((cfg.width * cfg.height, 3), generator=g)
    init = {"mat_albedo": torch.full((4, 3), 0.5),
            "mat_emissive": torch.zeros((4, 3))}
    whole = inverse_scene.reference_steps(ctx, cfg, target, init, FIRST_STEPS)
    # Blocks of pixels add up to the whole image.
    old, inverse_scene.BLOCK = inverse_scene.BLOCK, 96
    try:
        blocked = inverse_scene.reference_steps(ctx, cfg, target, init,
                                                FIRST_STEPS)
    finally:
        inverse_scene.BLOCK = old
    assert verdict(judge(ctx, init, *blocked, whole))["correct"] is True
    half = inverse_scene.reference_steps(ctx, cfg, target, init, FIRST_STEPS,
                                         pixels=cfg.width * cfg.height // 2)
    assert verdict(judge(ctx, init, *half, whole))["correct"] is False


def _summary(**kw):
    return dict(busy_s=0.8, window_s=1.0, units=5, kernels={}, device_ops={},
                gaps={}, **kw)


def test_readers():
    chunks = common.load_module("metrics", "chunks_per_step.cornell")
    idle = common.load_module("metrics", "chunk_idle_pct.cornell")
    for reader in (chunks, idle):
        assert reader.read({"ranks": [None], "cell": CELL,
                            "device": "cpu"}) is None
        assert reader.read({"ranks": [_summary()], "cell": CELL,
                            "device": "cpu"}) is None
    counters = dict(calls=5, chunks=160, groups=160, rays=160 * 32768)
    assert chunks.read({"ranks": [_summary(counters=counters)]}) == 32.0
    spans = {"ptx.chunk": dict(count=160, host_s=0.9, device_s=0.7,
                               idle_in_s=0.15, idle_at_s=0.02),
             "idle_outside_s": 0.05, "exchanges": []}
    assert idle.read({"ranks": [_summary(spans=spans)]}) == pytest.approx(15.0)
    # A trace without device time (a CPU run) gives nothing.
    cpu = _summary(spans=spans)
    cpu["busy_s"] = 0.0
    assert idle.read({"ranks": [cpu]}) is None
