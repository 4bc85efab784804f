"""The numpy <-> torch bridge for the shared scene arrays.

The port loads and flattens scenes with its own copy of the JAX package's
host code (``ptx_torch.scene.flatten.FlatScene`` of numpy arrays); this
module carries that NamedTuple across to torch tensors on a chosen device
and back, keeping every dtype (float32, int32, bool).
"""

from __future__ import annotations

import numpy as np
import torch

from ptx_torch.scene.flatten import FlatScene


def _check(fs) -> None:
    if not isinstance(fs, FlatScene):
        raise TypeError(f"{type(fs).__module__}.{type(fs).__name__}: expected "
                        "ptx_torch.scene.flatten.FlatScene")


def to_device(fs: FlatScene, device) -> FlatScene:
    """``FlatScene`` of numpy arrays (or tensors) -> ``FlatScene`` of tensors
    on ``device``."""
    _check(fs)
    return FlatScene(*(
        torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        .to(device)
        for v in fs
    ))


def to_host(fs: FlatScene) -> FlatScene:
    """``FlatScene`` of tensors (or numpy arrays) -> numpy arrays."""
    _check(fs)
    return FlatScene(*(
        v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        for v in fs
    ))
