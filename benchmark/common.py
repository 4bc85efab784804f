"""What every part of the benchmark shares: the manifest and the files it
names, the arithmetic of the end-to-end metrics, the device's description
and the guard against the JAX package.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix, which live in
``benchmark/configs/<config>.json`` and ``benchmark/traffic/<traffic>.json``;
the traffic file's ``kind`` names its loop, ``benchmark/kinds/<kind>.py``;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Dict, List

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
# Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "ptx")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none and the end-to-end metric it moves is
    among ``reported``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str) -> dict:
    """The cell ``name`` with everything it names: ``workload``,
    ``config`` and ``traffic`` (the parsed files), ``end_to_end`` and
    ``per_layer`` (the manifest's metric entries that the cell reports)."""
    bench = manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    names = [m["name"] for m in e2e]
    return dict(
        workload=w,
        config=load_json(os.path.join(ROOT, config["file"])),
        traffic=load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if applies(m, name, names)],
    )


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold, each
    compared whole (``ptx_torch`` is not ``ptx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs():
    """Fixed cache directories inside the checkout for every compiler the
    program may call, set before torch is imported; the program's own nvcc
    and g++ builds already live in ``ptx_torch/build/``."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")


# --------------------------------------------------------------------------
# Arithmetic of the end-to-end metrics
# --------------------------------------------------------------------------

def rate(units: int, per_unit: int, seconds: float) -> float:
    """Work per second over a whole window: every unit completed in it
    (``per_unit`` paths each) over all of its time."""
    return units * per_unit / seconds


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile over every value (not over
    groups of them): the smallest value with at least ``q`` % of all
    values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


# --------------------------------------------------------------------------
# The device
# --------------------------------------------------------------------------

def card_power(index: int) -> str:
    """``name, power limit`` of a card as ``nvidia-smi`` reads it, or what
    went wrong."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def checks_line(checks: List[dict]) -> Dict[str, dict]:
    """The compared numbers as the result line's last key: name -> value
    and limit."""
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def check(name: str, value: float, limit: float) -> dict:
    """A compared number; it passes at or below its limit (a NaN fails)."""
    return dict(name=name, value=float(value), limit=float(limit),
                ok=bool(float(value) <= float(limit)))
