"""The arithmetic of the end-to-end metrics and of the frozen roofline
bound, on numbers made up for the test."""

import json
import os

import pytest

from benchmark import common

ROOFLINE = common.load_module("metrics", "intersect_roofline_pct.fwd")
IDLE = common.load_module("metrics", "device_idle_pct.fwd")
SPREAD = common.load_module("metrics", "rank_idle_spread_pct.tp")
KERNELS = common.load_module("metrics", "kernels_per_step.grad")
EXCHANGE = common.load_module("metrics", "exchange_pct.tp")
H100 = "NVIDIA H100 80GB HBM3"


def test_rate_counts_all_work_over_all_time():
    # 37 samples of a 640x480 frame in 30.5 s.
    assert common.rate(37, 640 * 480, 30.5) == pytest.approx(
        37 * 307200 / 30.5)


def test_p95_is_the_tail_of_every_step_not_of_chunks():
    steps = [0.1] * 190 + [0.2] * 10  # 200 steps, 10 slow ones
    assert common.percentile(steps, 95) == 0.1
    steps = [0.1] * 189 + [0.2] * 11
    assert common.percentile(steps, 95) == 0.2
    # The median of chunk p95s would hide a tail that one chunk holds.
    chunks = [sorted(steps[i:i + 20]) for i in range(0, 200, 20)]
    assert sorted(c[18] for c in chunks)[5] == 0.1
    assert common.percentile([3.0], 95) == 3.0


def test_frozen_bound_from_the_data_file():
    with open(os.path.join(common.BENCH, "data",
                           "intersect_counts.json")) as f:
        counts = json.load(f)
    with open(os.path.join(common.BENCH, "data", "peaks.json")) as f:
        peak = json.load(f)[H100]
    want = 1e3 * max(counts["flops_per_spp"] / peak["float32_flops"],
                     counts["bytes_per_spp"] / peak["bytes_per_s"])
    assert ROOFLINE.bound_ms_per_spp(H100) == pytest.approx(want)
    assert counts["flops_per_spp"] == pytest.approx(
        counts["job"]["width"] * counts["job"]["height"]
        * (counts["per_path"]["nodes"] * counts["node_flops"]
           + counts["per_path"]["tests"] * counts["tri_flops"]))
    summary = {"units": 4, "busy_s": 1.0, "window_s": 1.1,
               "kernels": {"closest_sweep_kernel<...>": [10, 2.0],
                           "any_sweep_kernel": [10, 1.0],
                           "shade_kernel": [10, 0.5]}}
    data = {"ranks": [summary], "device": H100}
    ms = 1e3 * 3.0 / 4
    assert ROOFLINE.read(data) == pytest.approx(100 * want / ms)
    assert ROOFLINE.read({"ranks": [summary], "device": "cpu"}) is None


def test_idle_and_kernel_readers():
    a = {"units": 5, "busy_s": 0.9, "window_s": 1.0,
         "kernels": {"k": [100, 0.5], "j": [50, 0.3]}}
    b = dict(a, busy_s=0.6)
    assert IDLE.read({"ranks": [a, b]}) == pytest.approx((10 + 40) / 2)
    assert SPREAD.read({"ranks": [a, b]}) == pytest.approx(30)
    assert SPREAD.read({"ranks": [a]}) is None
    assert KERNELS.read({"ranks": [a]}) == 30
    assert IDLE.read({"ranks": [dict(a, busy_s=0.0)]}) is None
    c = dict(a, kernels={"ncclDevKernel_AllReduce_Sum_u64": [8, 0.25],
                         "k": [100, 0.5]})
    d = dict(c, kernels={"ncclDevKernel_AllReduce_Sum_u32": [8, 0.05]})
    assert EXCHANGE.read({"ranks": [c, d]}) == pytest.approx((25 + 5) / 2)
    assert EXCHANGE.read({"ranks": [a, b]}) is None


def test_check_passes_at_its_limit_and_fails_on_nan():
    assert common.check("x", 1.0, 1.0)["ok"]
    assert not common.check("x", float("nan"), 1.0)["ok"]
    assert not common.check("x", 2.0, 1.0)["ok"]
