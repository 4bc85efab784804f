"""``ab_trees.py``, the A/B timer of checkouts, on the CPU: its check and
its count of the sweeps' work on this checkout (the wrappers run their
plain versions here; timing needs the card).  The counts are pinned, so a
change to the ray sets of ``chip_smoke.py`` or to the yardstick
(``bench.sweep_work`` on the plain version's visits and searched rays)
shows here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ab_trees  # noqa: E402
from ptx_torch import bench  # noqa: E402
from ptx_torch import render as R  # noqa: E402
from ptx_torch.kernels.tiles import RB, TT  # noqa: E402
import _torch_port  # noqa: E402,F401  (one torch thread per test process)

S_GATE_OPS = ab_trees._smoke().GATE_OPS

# Per ray set of ab_trees.ray_sets(..., 512, 256, 384) on arch:2000: blocks,
# all-dead blocks, planned tiles, tiles the closest sweep visits, its
# longest walk, and the rays the any sweep searches.
PINNED = {
    "camera 512": (4, 0, 32, 32, 8, 2981),
    "scattered 512": (4, 1, 30, 30, 10, 2251),
    "camera 256": (2, 0, 16, 16, 8, 1494),
    "scattered 256": (2, 0, 20, 20, 10, 1692),
    "late bounce 256": (2, 0, 20, 20, 10, 1931),
    "frame camera 384": (3, 0, 22, 22, 8, 2109),
}


@pytest.fixture(scope="module")
def report():
    S = ab_trees._smoke()
    cfg = R.RenderConfig(width=16, height=16, samples=1, bounces=2,
                         intersector="pallas")
    fs, static = R.ensure_accel(*R.load_scene("arch:2000"), cfg, device="cpu")
    sets = ab_trees.ray_sets(S, fs, static, "cpu", 512, 256, 384)
    return ab_trees.sweep_report(S, fs, sets, "cpu", timed=False)


@pytest.mark.parametrize("label", sorted(PINNED))
def test_ab_trees_counts_the_plain_versions_work(report, label):
    row = report[label]
    assert (row["blocks"], row["all_dead_blocks"], row["planned"], row["visited"],
            row["longest_walk"], row["searched"]) == PINNED[label]
    peak_ops = bench.CARD_PEAKS["h100 80gb hbm3"][0]
    k = row["kernels"]
    assert k["closest"] == k["closest_stats"]
    assert k["closest"]["bound_by"] == k["any"]["bound_by"] == "operations"
    assert k["closest"]["bound_ms"] == pytest.approx(
        row["visited"] * RB * TT * bench.BW_FLOPS / peak_ops * 1e3)
    assert k["any"]["bound_ms"] == pytest.approx(
        row["searched"] * TT * bench.BW_FLOPS / peak_ops * 1e3)
    assert "ms" not in k["any"]  # timed only on the card
    # The plan: its slab tests at the float32 peak, or its bytes (rays,
    # boxes, then order, count and near) at the memory rate.
    nb, n_tiles = row["blocks"], 10
    ops = nb * RB * n_tiles * S_GATE_OPS
    nbytes = nb * RB * 32 + n_tiles * 32 + nb * (2 * n_tiles + 2) * 4
    assert "ms" not in row["plan"]
    assert (row["plan"]["bound_ms"], row["plan"]["bound_by"]) == pytest.approx(
        bench.bound(ops, nbytes, bench.CARD_PEAKS["h100 80gb hbm3"]))


def test_ab_trees_small_report_on_cpu():
    """The small sweeps' report: no lane differs from ``_small_sweep`` (the
    wrappers run it here), and the bounds count every ray against every
    tile (closest) and the rays still searching before each tile (any)."""
    S = ab_trees._smoke()
    cfg = R.RenderConfig(width=16, height=16, samples=1, bounces=2,
                         intersector="pallas")
    fs, static = R.ensure_accel(*R.load_scene("synthetic:2000"), cfg, device="cpu")
    rep = ab_trees.small_report(S, fs, ab_trees.small_sets(S, fs, static, "cpu",
                                                            512, 256, 384),
                                "cpu", timed=False)
    assert sorted(rep) == ["camera 256", "camera 512", "frame camera 384",
                           "frame scattered 384", "scattered 256", "scattered 512"]
    peak_ops = bench.CARD_PEAKS["h100 80gb hbm3"][0]
    for row in rep.values():
        assert row["differing_lanes"] == [0, 0, 0]
        k = row["kernels"]
        assert k["closest_small"]["bound_ms"] == pytest.approx(
            row["rays"] * 4 * TT * bench.BW_FLOPS / peak_ops * 1e3)
        assert 0 < k["any_small"]["bound_ms"] < k["closest_small"]["bound_ms"]
        assert "ms" not in k["any_small"]
