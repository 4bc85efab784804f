"""Build and load the port's CUDA kernels.

On first use, ``nvcc`` compiles every ``ptx_torch/csrc/*.cu`` into one
shared library with a plain C interface (``ptx_torch/build/``, git-ignored),
named by a hash of the sources and flags so an edit rebuilds it; the
library is bound with ``ctypes``.  ``-fmad=false`` keeps nvcc from fusing
``a * b + c`` into an FMA, so the kernels round exactly like their plain
torch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ptx_exact_gate": [_P, _P, _I, _I, _P, _P, _P],
    "ptx_closest": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "ptx_any": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
# nvcc's output of the last build (ptxas register / shared-memory report)
# and its wall time in seconds; empty / 0.0 when the library was cached.
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built on the machine with the card"
        )
    return path


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptx_torch_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                capture_output=True, text=True,
            )
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
