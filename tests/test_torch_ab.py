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

# Per ray set of ab_trees.ray_sets(..., 512, 256) on arch:2000: blocks,
# all-dead blocks, planned tiles, tiles the closest sweep visits, its
# longest walk, and the rays the any sweep searches.
PINNED = {
    "camera 512": (4, 0, 32, 32, 8, 2981),
    "scattered 512": (4, 1, 30, 30, 10, 2251),
    "camera 256": (2, 0, 16, 16, 8, 1494),
    "scattered 256": (2, 0, 20, 20, 10, 1692),
    "late bounce 256": (2, 0, 20, 20, 10, 1931),
}


@pytest.fixture(scope="module")
def report():
    S = ab_trees._smoke()
    cfg = R.RenderConfig(width=16, height=16, samples=1, bounces=2,
                         intersector="pallas")
    fs, static = R.ensure_accel(*R.load_scene("arch:2000"), cfg, device="cpu")
    sets = ab_trees.ray_sets(S, fs, static, "cpu", 512, 256)
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
