"""Render checkpoint / resume.

The reference has no resume — partial progress only surfaces as the periodic
image flush (``renderer.cpp:409-424``) and the per-pixel sample counter that
makes accumulation order-independent (``accumulation_worker.cpp:44-52``).
Here that order-independence becomes a real checkpoint unit (SURVEY.md §5):

    (accumulated HDR color, accumulated alpha, claim mask, samples done,
     config fingerprint)

Because sample passes are keyed by absolute sample ids through the
counter-based RNG, resuming at sample k reproduces *exactly* the image an
uninterrupted run would have produced — verified in tests.

The port's own copy of ``ptx/io/checkpoint.py``: only the import of
``RenderConfig`` differs.  The fingerprint hashes ``RenderConfig.to_json()``,
which both packages write alike, so a checkpoint of either package resumes
in the other (``tests/test_torch_host.py``, ``tests/test_torch_checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Tuple

import numpy as np

from ptx_torch.config import RenderConfig

_VERSION = 1


def config_fingerprint(cfg: RenderConfig) -> str:
    """Hash of every field that affects per-sample radiance values.

    ``samples`` is deliberately excluded: each sample pass depends only on
    its absolute sample id, so a checkpoint taken at k samples is valid for
    any target sample count >= k (that is the point of resuming).
    """
    import json

    raw = json.loads(cfg.to_json())
    raw.pop("samples", None)
    return hashlib.sha256(json.dumps(raw, sort_keys=True).encode()).hexdigest()[:16]


@dataclasses.dataclass
class Checkpoint:
    color: np.ndarray  # [P, 3] running-mean HDR
    alpha: np.ndarray  # [P]
    claimed: Optional[np.ndarray]  # [P] bool (transparent-background mode)
    samples_done: int
    fingerprint: str


def save(path: str, ckpt: Checkpoint) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        version=_VERSION,
        color=ckpt.color,
        alpha=ckpt.alpha,
        claimed=(
            ckpt.claimed if ckpt.claimed is not None else np.zeros(0, bool)
        ),
        samples_done=ckpt.samples_done,
        fingerprint=ckpt.fingerprint,
    )
    # numpy appends .npz to the temp name.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load(path: str, expect_fingerprint: Optional[str] = None) -> Optional[Checkpoint]:
    """Load a checkpoint; returns None when absent or incompatible."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _VERSION:
            return None
        fingerprint = str(z["fingerprint"])
        if expect_fingerprint is not None and fingerprint != expect_fingerprint:
            return None
        claimed = z["claimed"]
        return Checkpoint(
            color=z["color"],
            alpha=z["alpha"],
            claimed=claimed if claimed.size else None,
            samples_done=int(z["samples_done"]),
            fingerprint=fingerprint,
        )
