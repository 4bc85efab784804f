"""The control, the reference in bfloat16 put in the program's place, is
judged by the cell's own comparison and comes out not correct; the
float32 reference put there comes out correct (tiny cells, the CPU)."""

import types

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.kinds import frame
from benchmark.tests import tiny


def _ctx(name, seed):
    c = tiny.cell(name)
    return types.SimpleNamespace(config=c["config"], traffic=c["traffic"],
                                 seed=seed, device=torch.device("cpu"),
                                 log=lambda msg: None)


@pytest.mark.parametrize("seed", [11, 3_000_000_019])
def test_frame_control_is_not_correct(seed):
    ctx = _ctx("courtyard300k-1w.frame", seed)
    got = control.frame_readings(ctx, ctx.traffic["job"]["samples"])
    assert got["control"]["correct"] is False, got


def test_frame_reference_in_the_programs_place_is_correct():
    ctx = _ctx("courtyard300k-1w.frame", 11)
    k = ctx.traffic["check"]["pixels"]
    rng = np.random.default_rng(0)
    ref = (rng.random((k, 3), np.float32), rng.random(k, np.float32))
    checks = frame.compare(ctx, (*ref, 3), ref, ref + ref, 3)
    assert control.verdict(checks)["correct"] is True


@pytest.mark.parametrize("seed", [11, 3_000_000_019])
def test_inverse_control_is_not_correct(seed):
    got = control.inverse_readings(_ctx("courtyard300k-1w.inverse", seed))
    assert got["control"]["correct"] is False, got
    assert got["half_batch"]["correct"] is False, got
