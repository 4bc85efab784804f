"""The manifest against the rules of a benchmark manifest, and the discovery of
every file a cell names by its name."""

import json
import os
import re

import pytest

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) < 65536
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_config_is_used_and_found():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        data = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_discovery(w):
    cell = common.cell(w["name"])
    assert cell["config"]["name"] == w["config"]
    kind = cell["traffic"]["kind"]
    assert os.path.exists(os.path.join(common.BENCH, "kinds", kind + ".py"))
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in reported


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    reader = common.load_module("metrics", m["name"])
    assert callable(reader.read)
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    # A reader that finds nothing to read returns nothing.
    assert reader.read({"ranks": [None], "cell": "", "device": "cpu"}) is None


def test_applies_without_workloads_follows_moves():
    m = {"name": "x", "moves": "paths_per_s"}
    assert common.applies(m, "any", ["paths_per_s"])
    assert not common.applies(m, "any", ["grad_paths_per_s"])
    assert common.applies({"name": "y", "workloads": ["a"]}, "a")


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_traffic_files_are_data():
    for w in BENCH["workloads"]:
        path = os.path.join(common.BENCH, "traffic", w["traffic"] + ".json")
        with open(path) as f:
            json.load(f)
