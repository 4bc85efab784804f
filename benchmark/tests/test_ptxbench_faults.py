"""A run of each cell, cut to a CPU size, is correct as the program
stands and not correct with a fault planted underneath its timed path
(the harness's look for a chip skipped, the rest of a run driven)."""

import pytest

from benchmark.tests import faults, tiny

FRAME_FAULTS = [faults.frame_unchanged, faults.frame_half_pixels,
                faults.frame_altered]
INVERSE_FAULTS = [faults.inverse_unchanged, faults.inverse_half_batch,
                  faults.inverse_altered]


@pytest.mark.parametrize("fault", [None] + FRAME_FAULTS,
                         ids=lambda f: f.__name__ if f else "sound")
def test_frame_cell(fault):
    code, line = tiny.run_cell("courtyard300k-1w.frame", fault=fault)
    assert code == 0 and line is not None
    assert line["correct"] is (fault is None), line["checks"]
    assert line["attempted"] > 0


@pytest.mark.parametrize("fault", [None] + INVERSE_FAULTS,
                         ids=lambda f: f.__name__ if f else "sound")
def test_inverse_cell(fault):
    code, line = tiny.run_cell("courtyard300k-1w.inverse", fault=fault)
    assert code == 0 and line is not None
    assert line["correct"] is (fault is None), line["checks"]
    assert set(line["metrics"]) == {"grad_paths_per_s", "step_ms_p95",
                                    "setup_s"}


@pytest.mark.parametrize("fault", [None, faults.exchange_left_out,
                                   faults.frame_altered],
                         ids=lambda f: f.__name__ if f else "sound")
def test_four_rank_frame_cell(fault):
    code, line = tiny.run_cell("courtyard300k-4w.frame", fault=fault, trace=1)
    assert code == 0 and line is not None
    assert line["correct"] is (fault is None), line["checks"]
    assert line["device"]["count"] == 4


# Layouts in which each rank holds a slice of the pixels: a configuration
# that differs from the cell's in its ``layout`` alone.
SLICED = {"dp4": {"dp": 4, "tp": 1, "comm": "reduce"},
          "tp4_ring": {"dp": 1, "tp": 4, "comm": "ring"}}


@pytest.mark.parametrize("layout,fault", [
    ("dp4", None), ("tp4_ring", None), ("dp4", faults.frame_altered)],
    ids=["dp4-sound", "tp4_ring-sound", "dp4-frame_altered"])
def test_four_rank_frame_cell_by_pixel_slices(layout, fault):
    code, line = tiny.run_cell("courtyard300k-4w.frame", fault=fault,
                               layout=SLICED[layout])
    assert code == 0 and line is not None
    assert line["correct"] is (fault is None), line["checks"]
    assert line["checks"]["ranks_differ"]["value"] == 0


def test_four_rank_run_refuses_jax_on_another_rank():
    code, line = tiny.run_cell("courtyard300k-4w.frame",
                               fault=faults.jax_held_by_rank_1)
    assert code != 0 and line is None
