"""Helpers the per-layer metrics in ``benchmark/metrics/`` share."""

from __future__ import annotations

import json
import os
from typing import Optional

from benchmark import common


def idle_pct(summary: Optional[dict]) -> Optional[float]:
    """100 x the share of a rank's traced window with no device operation;
    None where the trace holds no device time (a CPU run)."""
    if not summary or summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def kernel_seconds(summary: Optional[dict], names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``."""
    if not summary:
        return 0.0
    return sum(sec for name, (_, sec) in summary["kernels"].items()
               if any(n in name for n in names))


def peaks(device: str) -> Optional[dict]:
    """The published peaks of ``device`` (``benchmark/data/peaks.json``,
    keyed by ``torch.cuda.get_device_name``), or None."""
    with open(os.path.join(common.BENCH, "data", "peaks.json")) as f:
        table = json.load(f)
    return table.get(device)
