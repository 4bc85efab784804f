"""On a CUDA device: a short run of each one-card cell through the
command, correct, and the control at the cell's own size, judged by the
cell's comparison, not correct; without a device the command refuses
(exit code, no result line).  Run on the card: ``python -m pytest
benchmark/tests -m card``."""

import json
import subprocess
import sys

import pytest

from benchmark import common


def _run(name, seed, seconds=3):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0"],
        capture_output=True, text=True, cwd=common.ROOT, timeout=900)


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_refuses_without_a_card():
    if _has_card():
        pytest.skip("a CUDA device is present")
    out = _run("courtyard300k-1w.frame", 1)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.card
@pytest.mark.parametrize("name", ["courtyard300k-1w.frame", "courtyard300k-1w.inverse"])
def test_one_card_cell_is_correct(name):
    if not _has_card():
        pytest.skip("needs a CUDA device")
    out = _run(name, 4_000_000_007)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", ["courtyard300k-1w.frame",
                                  "courtyard300k-1w.inverse"])
def test_control_at_the_cells_size_is_not_correct(name):
    if not _has_card():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", name,
         "--seeds", "4000000009"],
        capture_output=True, text=True, cwd=common.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["control"]["correct"] is False, got
