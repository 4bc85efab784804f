"""The port's bench (``ptx_torch.bench``) and its stats sweep.

The bench surface is walked at tiny sizes on the CPU, as
``tests/test_bench.py`` walks the JAX package's.  The stats sweep
(``intersect_cuda.closest_sweep_stats``, plain version
``_sweep(..., stats=True)``) must return the closest sweep's ``t`` and
``tri`` exactly, and its per-block tile count ``visited`` (v) must relate
to the JAX package's ``closest_pallas_stats`` count (p, interpret mode) as
the two exit rules allow.  With c the block's plan count:

* p == 0 when c == 0;
* p == ceil4(c) when v == c;
* p in {ceil4(v), ceil4(v) + 4} otherwise.

The Pallas kernel walks groups of 4 tiles against a bound one group old;
the port exits before each tile against the bound left by the tile before
(``csrc/tile_sweep.cu``).  The relation needs the two bounds to be the same
numbers, so it is held on every block whose truncated ``t`` equal JAX's;
blocks where they differ hold the reciprocal near ties that
``tests/test_torch_intersect.py`` allows, and a block there that breaks the
relation is held to that test's allowance (a share of the rays).
"""

import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptx.accel.bvh import build_bvh
from ptx.kernels import intersect_pallas as kp
from ptx.scene.arch import load_arch
from ptx.scene.flatten import FlatScene as jflat
from ptx.scene.synthetic import load_synthetic
from ptx_torch import bench
from ptx_torch.kernels import _build, intersect_cuda, tiles
from ptx_torch.scene.bridge import to_device
from ptx_torch.scene.camera import generate_rays
from _torch_port import port_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The near-tie allowance of tests/test_torch_intersect.py.
MAX_FLIP_SHARE = 1e-3
# One torch thread in every process these tests start: torch's thread pool
# spins, and beside the other test workers it multiplies the run time.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# The bench surface
# --------------------------------------------------------------------------


def test_tiny_bench_has_all_entries_and_no_errors(monkeypatch):
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    monkeypatch.setenv("PTX_BENCH_BUDGET_S", "100000")
    result = bench.run_bench(tiny=True, device="cpu")

    assert result["unit"] == "paths/s" and result["value"] > 0
    assert result["vs_baseline"] is None and result["vs_baseline_reason"]
    assert result["device"] == "cpu" and result["card"] == "cpu"
    extra = result["extra"]
    assert list(extra) == list(bench.extra_benches(tiny=True))
    for name, entry in extra.items():
        assert "error" not in entry and "skipped" not in entry, f"{name}: {entry}"
    for name in ("pallas_intersect_roofline", "pallas_roofline_arch"):
        row = extra[name]
        assert 0 < row["visited_tiles"] <= row["tiles"] * row["rays"] // tiles.RB
        # No card: no peaks, no shares, no bound.
        assert row["sol_fp32"] is None and row["bound_ms"] is None
    json.dumps(result)


def test_emit_fires_before_and_during_extras(monkeypatch):
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    emitted = []
    bench.run_bench(tiny=True, device="cpu",
                    extras=["intersect_roofline", "pallas_intersect_roofline"],
                    emit=lambda r: emitted.append(json.dumps(r)))
    assert len(emitted) >= 3
    first = json.loads(emitted[0])
    assert "extra" not in first and first["value"] > 0
    assert list(json.loads(emitted[1])["extra"]) == ["intersect_roofline"]
    assert list(json.loads(emitted[-1])["extra"]) == [
        "intersect_roofline", "pallas_intersect_roofline"]


def test_past_deadline_skips_extras_but_emits_headline(monkeypatch):
    monkeypatch.setenv("PTX_BENCH_FULL", "1")
    emitted = []
    result = bench.run_bench(tiny=True, device="cpu",
                             emit=lambda r: emitted.append(dict(r)),
                             deadline=time.monotonic() - 1.0)
    assert emitted and emitted[0]["value"] > 0
    assert result["extra"] and all("skipped" in e for e in result["extra"].values())


def test_full_extra_bench_table_entries_are_callable():
    tiny = bench.extra_benches(tiny=True, device="cpu")
    full = bench.extra_benches(tiny=False)
    assert list(tiny) == list(full)
    assert all(callable(fn) for fn in full.values())


def test_bench_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench()
    assert bench.card_peaks("cpu") == (None, None)


def test_backward_rows_are_not_among_the_extras():
    """``run_bench`` stores an extra row's error and goes on; the backward
    rows run only through ``bench --backward``, where nothing is caught."""
    for tiny in (True, False):
        assert not [n for n in bench.extra_benches(tiny=tiny, device="cpu")
                    if "backward" in n]


def test_bench_backward_defaults_and_lets_a_failure_through(monkeypatch):
    """``bench --backward`` without size flags runs bench's backward scene
    and shape under the rows' own names, and a row that fails makes the
    command fail."""
    from ptx_torch import cli

    calls = []

    def fail(scene, cfg, fields, metric, reps, device):
        calls.append((scene, cfg, fields, metric))
        raise RuntimeError("the closest kernel failed to launch")

    monkeypatch.setattr(bench, "run_backward_bench", fail)
    with pytest.raises(RuntimeError, match="failed to launch"):
        cli.main(["bench", "--backward", "--device", "cpu"])
    ((scene, cfg, fields, metric),) = calls
    assert (scene, metric) == (bench.BACKWARD_SCENE, bench.BACKWARD_METRIC)
    assert {k: getattr(cfg, k) for k in bench.BACKWARD_SHAPE} == bench.BACKWARD_SHAPE
    assert fields == ("mat_albedo", "mat_emissive")


def test_bench_cli_smoke():
    """``ptx_torch.cli bench`` honours the size flags and prints one JSON
    object; with ``--backward``, the two backward rows in grad-paths/s."""
    base = [sys.executable, "-m", "ptx_torch.cli", "bench", "--scene",
            "arch:2000", "--width", "16", "--height", "16", "--samples", "2",
            "--bounces", "2", "--device", "cpu"]
    env = {**os.environ, "PTX_BENCH_FULL": "0", **ONE_THREAD}
    out = subprocess.run(base, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["value"] > 0 and doc["scene"] == "arch:2000"
    assert doc["config"].startswith("16x16 2 spp 2 bounces")
    out = subprocess.run(base + ["--backward"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert [row["metric"] for row in doc.values()] == [
        "custom_backward", "custom_vertex_backward"]
    assert all(row["unit"] == "grad-paths/s" and row["value"] > 0
               for row in doc.values())


# --------------------------------------------------------------------------
# The stats sweep
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scene(spec):
    if spec.startswith("arch"):
        fs, static = build_bvh(*load_arch(spec))
    else:
        fs, static = load_synthetic(spec)
    fs, static = port_scene(fs, static)
    fs = tiles.attach_tiles(fs)
    jfs = jflat(**{k: jnp.asarray(v) for k, v in fs._asdict().items()})
    return jfs, to_device(fs, "cpu"), static


def _rays(fs_t, static, kind):
    """``camera``: a 64x64 frame, two samples; ``cones``: 64 blocks of 128
    rays, each from one seeded point inside the scene box in a narrow cone,
    so a block's rays hit close together and its walk can stop early."""
    if kind == "camera":
        pix = torch.arange(4096, dtype=torch.int32)
        orig, dirn = generate_rays(fs_t, pix, pix % 2, 64, 64)
        return orig.contiguous(), dirn
    nb = 64
    rng = np.random.default_rng(0)
    lo, hi = np.asarray(static.aabb_lo), np.asarray(static.aabb_hi)
    o = lo + (hi - lo) * rng.random((nb, 1, 3))
    d = rng.normal(size=(nb, 1, 3)) + 0.02 * rng.normal(size=(nb, tiles.RB, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(o, d.shape)
    return (torch.from_numpy(o.reshape(-1, 3).astype(np.float32)),
            torch.from_numpy(d.reshape(-1, 3).astype(np.float32)))


_jax_stats = jax.jit(functools.partial(kp.closest_pallas_stats, interpret=True))

CASES = [(s, k) for s in ("arch:20000", "synthetic:8192")
         for k in ("camera", "cones")]


def _ceil4(x):
    return (x + 3) // 4 * 4


@pytest.mark.parametrize("spec,kind", CASES)
def test_stats_sweep_matches_closest_sweep(spec, kind):
    _, fs_t, static = _scene(spec)
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, kind))
    order, count, near = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    t, tri, visited = intersect_cuda._sweep(order, count, near, rays,
                                            fs_t.ptiles, False, stats=True)
    t_c, tri_c = intersect_cuda._sweep(order, count, near, rays, fs_t.ptiles, False)
    assert torch.equal(t, t_c) and torch.equal(tri, tri_c)
    assert visited.dtype == torch.int32 and visited.shape == count.shape
    assert bool((visited <= count).all())
    # A block tests its first planned tile whenever it has one.
    assert torch.equal(visited > 0, count > 0)


@pytest.mark.parametrize("spec,kind", CASES)
def test_visited_relates_to_pallas_stats(spec, kind):
    jfs, fs_t, static = _scene(spec)
    orig, dirn = _rays(fs_t, static, kind)
    t, tri, v = intersect_cuda.closest_stats(fs_t, orig, dirn)
    ref_t, ref_tri, p = (np.asarray(x) for x in _jax_stats(
        jfs, jnp.asarray(orig.numpy()), jnp.asarray(dirn.numpy())))
    rays, _ = tiles._pack_rays(orig, dirn)
    c = intersect_cuda._plan_tiles(rays, fs_t.pboxes)[1].numpy()
    v = v.numpy()
    nb = c.shape[0]
    assert p.shape == v.shape == (nb,)

    holds = np.where(c == 0, p == 0,
                     np.where(v == c, p == _ceil4(c),
                              (p == _ceil4(v)) | (p == _ceil4(v) + 4)))
    t_differs = (t.numpy() != ref_t).reshape(nb, tiles.RB)
    tie_blocks = t_differs.any(1)
    assert holds[~tie_blocks].all(), np.nonzero(~holds & ~tie_blocks)
    # Where a near tie moved t, a broken relation counts its block's rays
    # against the near-tie allowance.
    assert (~holds).sum() * tiles.RB <= MAX_FLIP_SHARE * orig.shape[0]
    # The winners themselves agree as in tests/test_torch_intersect.py.
    hit = t.numpy() < tiles.HIT_T
    np.testing.assert_array_equal(hit, ref_t < tiles.HIT_T)
    assert ((tri.numpy() != ref_tri) & hit).mean() <= MAX_FLIP_SHARE
    if (spec, kind) == ("arch:20000", "cones"):
        assert (v < c).any(), "no block stopped early: the exit rule went untested"


def test_stats_wrappers_run_plain_on_cpu():
    _, fs_t, static = _scene("arch:20000")
    orig, dirn = _rays(fs_t, static, "cones")
    rays, _ = tiles._pack_rays(orig, dirn)
    plan = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    _build.reset_launches()
    got = intersect_cuda.closest_sweep_stats(*plan, rays, fs_t.ptiles)
    via_scene = intersect_cuda.closest_stats(fs_t, orig, dirn)
    assert set(_build.LAUNCHES.values()) == {0}
    want = intersect_cuda._sweep(*plan, rays, fs_t.ptiles, False, stats=True)
    for g, s, w in zip(got, via_scene, want):
        assert torch.equal(g, w) and torch.equal(s, w)


def test_closest_stats_needs_more_than_small_tiles():
    _, fs_t, static = _scene("synthetic:2000")
    assert fs_t.ptiles.shape[0] <= tiles.SMALL_TILES
    orig, dirn = _rays(fs_t, static, "camera")
    with pytest.raises(ValueError, match="SMALL_TILES"):
        intersect_cuda.closest_stats(fs_t, orig, dirn)


def test_sweep_work_and_bound_count_this_runs_data():
    """The bound's operations are the tests the data needed: every visited
    tile for every ray of the closest sweep, and for the any sweep only the
    rays still without a hit; its bytes move each distinct tile once."""
    _, fs_t, static = _scene("arch:20000")
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, "cones"))
    plan = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    visited = intersect_cuda._sweep(*plan, rays, fs_t.ptiles, False, stats=True)[2]
    hit, a_visited, searched = intersect_cuda._sweep(*plan, rays, fs_t.ptiles,
                                                     True, stats=True)
    assert torch.equal(hit, intersect_cuda._sweep(*plan, rays, fs_t.ptiles, True))
    assert bool((a_visited <= plan[1]).all())
    assert bool((searched <= a_visited.long() * tiles.RB).all())
    assert int(searched.sum()) < int(a_visited.sum()) * tiles.RB  # hits stop rays

    ops, nbytes = bench.sweep_work(plan, visited, bench.SWEEP_RAY_BYTES)
    assert ops == int(visited.sum()) * tiles.RB * tiles.TT * bench.BW_FLOPS
    distinct = {int(plan[0][b, k]) for b in range(plan[0].shape[0])
                for k in range(int(visited[b]))}
    assert nbytes >= len(distinct) * bench.TILE_BYTES
    a_ops, _ = bench.sweep_work(plan, a_visited, 36, searched)
    assert a_ops == int(searched.sum()) * tiles.TT * bench.BW_FLOPS

    assert bench.bound(ops, nbytes, (None, None)) == (None, None)
    ms, by = bench.bound(ops, nbytes, bench.CARD_PEAKS["h100 80gb hbm3"])
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)
    assert bench.bound(1.0, 3.35e12, (67e12, 3.35e12)) == (1e3, "bytes")


# Work of the sweeps on the seeded plans of _rays(arch:2000, kind): planned
# tiles, tiles the closest sweep's per-tile exit rule visits, tiles the any
# sweep visits, and the rays it searches over those visits.
PINNED_WORK = {
    "camera": (205, 205, 205, 18315),
    "cones": (262, 251, 212, 25401),
}


@pytest.mark.parametrize("kind", sorted(PINNED_WORK))
def test_sweep_work_is_pinned_on_a_seeded_plan(kind):
    """The yardstick of the sweeps' bounds (chip_smoke.check_kernels,
    bench.sweep_work) counts the work the inputs need under the plain
    version's rules -- the closest sweep's unlagged per-tile exit, the any
    sweep's searched rays -- never a kernel's own schedule; a change to the
    rules or to the count shows here."""
    _, fs_t, static = _scene("arch:2000")
    rays, _ = tiles._pack_rays(*_rays(fs_t, static, kind))
    plan = intersect_cuda._plan_tiles(rays, fs_t.pboxes)
    visited = intersect_cuda._sweep(*plan, rays, fs_t.ptiles, False, stats=True)[2]
    _, a_visited, searched = intersect_cuda._sweep(*plan, rays, fs_t.ptiles,
                                                   True, stats=True)
    _, c_visits, _, n_searched = PINNED_WORK[kind]
    assert (int(plan[1].sum()), int(visited.sum()), int(a_visited.sum()),
            int(searched.sum())) == PINNED_WORK[kind]
    ops, _ = bench.sweep_work(plan, visited, bench.SWEEP_RAY_BYTES)
    assert ops == c_visits * tiles.RB * tiles.TT * bench.BW_FLOPS
    a_ops, _ = bench.sweep_work(plan, a_visited, 32 + 4, searched)
    assert a_ops == n_searched * tiles.TT * bench.BW_FLOPS
