"""ctypes bridge to the native BVH builder (ptx_torch/accel/cpp).

The port's own copy of ``ptx/accel/native.py``.  It builds the shared
library on first use with one ``g++`` call into ``ptx_torch/build/`` (git
ignored), named by a hash of the source and flags, and never writes into
the source directory.  Every result is interchangeable with the numpy
builder in ``ptx_torch.accel.bvh``, which remains the oracle and the
fallback when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "cpp", "bvh_builder.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libptxbvh_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        subprocess.run([cxx, *CXX_FLAGS, "-o", out, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(out, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            f = lib.ptx_build_bvh
            f.restype = ctypes.c_int32
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f.argtypes = [
                f32p, f32p, f32p,  # v0, e1, e2
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # n, leaf, bins
                ctypes.c_int32,  # max_nodes
                i32p, f32p, f32p, i32p, i32p, i32p,  # outputs
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(
    tri_a: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    leaf_size: int = 8,
    n_bins: int = 16,
):
    """Run the C++ builder.  Returns (order, bb_min, bb_max, first, count,
    miss, n_nodes) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = tri_a.shape[0]
    max_nodes = 2 * max(n // max(leaf_size // 2, 1), 1) + 16
    order = np.empty(n, np.int32)
    bb_min = np.empty((max_nodes, 3), np.float32)
    bb_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    n_nodes = lib.ptx_build_bvh(
        np.ascontiguousarray(tri_a, np.float32),
        np.ascontiguousarray(tri_e1, np.float32),
        np.ascontiguousarray(tri_e2, np.float32),
        n, leaf_size, n_bins, max_nodes,
        order, bb_min, bb_max, first, count, miss,
    )
    if n_nodes < 0:
        return None
    return (
        order,
        bb_min[:n_nodes],
        bb_max[:n_nodes],
        first[:n_nodes],
        count[:n_nodes],
        miss[:n_nodes],
        n_nodes,
    )
