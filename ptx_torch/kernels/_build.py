"""Build, load and launch the port's CUDA kernels.

On first use, ``nvcc`` compiles each ``ptx_torch/csrc/*.cu`` to an object,
all sources at once in parallel, and links them into one shared library
with a plain C interface (``ptx_torch/build/``, git-ignored), named by a
hash of the sources and flags so an edit rebuilds it; the library is bound
with ``ctypes``.  ``-fmad=false`` keeps nvcc from fusing ``a * b + c`` into
an FMA, so the kernels round exactly like their plain torch versions.

The wrappers share the rest: a wrapper runs its plain version only when
every tensor lies on the CPU (:func:`on_cpu`), checks what it hands a kernel
(:func:`check`), launches on torch's current stream and raises on a launch
error (:func:`launch`), and counts each launch in ``LAUNCHES``.  A launch
made while a CUDA graph is captured runs at each replay; the replay counts
it (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "ptx_tile_plan": [_P, _P, _I, _I, _P, _P, _P, _P],
    "ptx_closest": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "ptx_closest_stats": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "ptx_any": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    "ptx_closest_small": [_P, _P, _I, _I, _P, _P, _P],
    "ptx_any_small": [_P, _P, _I, _I, _P, _P],
    "ptx_shadow_rays": [_P, _P],
    "ptx_shade": [_P, _I, _P],
    "ptx_rcp_check": [_P, _P],
    "ptx_bvh_closest": [_P, _L, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P],
    "ptx_bvh_any": [_P, _L, _P, _L, _I, _P, _P, _P],
    "ptx_bvh_visits": [_P, _L, _P, _L, _I, _P, _P, _P],
    "ptx_row_grad": [_P, _P, _L, _I, _I, _I, _L, _I, _P, _P, _P],
}

# Kernel launches per wrapper since the last reset_launches() ("exact_gate":
# the plan kernel, which replaces the JAX package's exact gate kernel;
# "sun": the shadow-ray setup, which replaces its sun kernel; "bvh_*": the
# BVH walk, which replaces the JAX package's traversal loop; "row_grad":
# the backward of a gather of table rows, its two kernels per call).
LAUNCHES = {
    "exact_gate": 0, "closest": 0, "any": 0, "closest_small": 0,
    "any_small": 0, "sun": 0, "shade": 0, "closest_stats": 0,
    "bvh_closest": 0, "bvh_any": 0, "bvh_visits": 0, "row_grad": 0,
}
# The intersection queries' entry points among them, of the tile traversal
# and of the walk (``render --metrics`` reports their launches).
INTERSECT_LAUNCHES = ("exact_gate", "closest", "any", "closest_small",
                      "any_small", "bvh_closest", "bvh_any")

_lock = threading.Lock()
_lib = None
# nvcc's output of the last build (ptxas register / shared-memory report)
# and its wall time in seconds; empty / 0.0 when the library was cached.
build_log = ""
build_seconds = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(tally) -> None:
    """Count the launches of a CUDA graph's replay: ``tally`` maps a kernel
    to its launches in the graph (what the wrappers counted while it was
    captured, which launched nothing)."""
    for k, n in tally.items():
        LAUNCHES[k] += n


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU; False when all are on one
    CUDA device; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(fn, *args):
    """Call a C entry point with torch's current stream; raise on a CUDA
    error (a refused launch never runs, and a synchronize would not say)."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


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


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptx_torch_{h.hexdigest()[:16]}.so")


def _build(path: str) -> str:
    """One nvcc per source, all started together, then one link.  Returns
    the compilers' output."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        for obj, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                raise RuntimeError("nvcc failed:\n" + "".join(log))
        lib_tmp = os.path.join(tmp, "lib.so")
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
             *(obj for obj, _ in procs)],
            capture_output=True, text=True,
        )
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "".join(log))
        os.replace(lib_tmp, path)
    return "".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has no build."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            t0 = time.perf_counter()
            build_log = _build(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
