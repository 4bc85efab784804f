"""Observability: phase timers, throughput counters, spans, profiler traces
(port of ``ptx/utils.py``).

:class:`Metrics` times named phases on the host clock, with an item count
for a rate; a phase given ``block=`` tensors on a CUDA device waits for the
device (``torch.cuda.synchronize``) before it stops the clock, as the JAX
package waits with ``jax.block_until_ready``.  :func:`profiler_trace` runs
``torch.profiler`` over a scope and writes a Chrome trace (JSON, open it in
``chrome://tracing`` or Perfetto) into a directory; the JAX package's
``jax.profiler`` writes TensorBoard / xprof files instead.

:func:`span` marks a step of the program on the profiler's own timeline
while a ``torch.profiler`` records, and costs one flag check otherwise.
The program's spans, each at a layer boundary: ``ptx.sample`` (a turn of
``render.progressive_render``'s sample loop: the trace and the fold),
``ptx.launch`` (a launch of the device loop or pass, a forward or a
backward of the device scan), ``ptx.replay`` (one CUDA graph replay, a
whole unit or one segment of a program), ``ptx.exchange`` (one
collective run by ``parallel.dist``, eager or between two segments) and
``ptx.chunk`` (one pixel chunk's forward and backward in
``diff.inverse.slice_value_and_grad_fn``).  In
the Chrome trace each is a ``user_annotation`` on the kernels' clock; the
device work of one is the work launched inside it (matched by correlation
id).

The JAX package's ``compile_cache_dir`` / ``enable_compile_cache`` point
XLA's persistent compile cache and are not ported: the port compiles no
XLA, and its kernel library is cached by ``ptx_torch.kernels._build`` (a
build per source hash under ``ptx_torch/build/``).

:func:`device_constant` holds the small constant tensors of the per-bounce
code (scene bounds, park values, environment factor), one per device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

log = logging.getLogger("ptx_torch")

# What :func:`span` returns while no profiler records: one shared object.
_IDLE = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its block as the span ``name``: the
    profiler's ``record_function(name)`` while a ``torch.profiler``
    records, else a shared no-op (no object made, no clock read, no device
    call).  Spans nest by time: the enclosing span is the parent."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _IDLE


@dataclasses.dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0
    items: float = 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


def _cuda_devices(obj):
    """The CUDA devices of the tensors in ``obj`` (a tensor, or tuples,
    lists and dicts of them)."""
    if torch.is_tensor(obj):
        return {obj.device} if obj.device.type == "cuda" else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in obj))
    return set()


class Metrics:
    """Accumulates per-phase wall time + item throughput.

    >>> m = Metrics()
    >>> with m.phase("intersect", items=65536):
    ...     ...
    >>> m.report()
    """

    def __init__(self):
        self.phases: Dict[str, PhaseStat] = {}
        self.counters: Dict[str, int] = {}
        self.notes: Dict[str, str] = {}

    def count(self, name: str, n: int):
        """Add ``n`` to the counter ``name``."""
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def phase(self, name: str, items: float = 0.0, block=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block):
                torch.cuda.synchronize(dev)
            stat = self.phases.setdefault(name, PhaseStat())
            stat.calls += 1
            stat.seconds += time.perf_counter() - t0
            stat.items += items

    def report(self) -> str:
        lines = [f"{name}: {v}" for name, v in sorted(self.notes.items())]
        for name, s in sorted(self.phases.items()):
            rate = f" {s.items_per_s:,.0f}/s" if s.items else ""
            lines.append(
                f"{name}: {s.seconds:.3f}s over {s.calls} calls{rate}"
            )
        for name, n in sorted(self.counters.items()):
            lines.append(f"{name}: {n:,}")
        # The device loop's counters (``integrator.graphs.DeviceLoop``).
        stepped = self.counters.get("lanes_stepped")
        if stepped:
            live = 100 * self.counters["lanes_live"] / stepped
            lines.append(f"live lanes: {live:.2f}% of the lanes stepped")
        text = "\n".join(lines)
        log.info("metrics:\n%s", text)
        return text


def device_constant(values, device):
    """The float32 tensor of ``values`` (a number or a tuple of them) on
    ``device``, made once per (float32 bits, device) and shared by every
    caller, who must not write to it.  ``torch.tensor(..., device=)`` makes
    a synchronous host-to-device copy on each call, which CUDA graph
    capture refuses and which stalls the host's queue of launches.  The
    bits key the cache, so -0.0 and 0.0 stay apart.  The cache is never
    evicted: a captured CUDA graph reads these tensors by pointer for as
    long as it lives, and each entry is a few bytes."""
    arr = np.asarray(values, np.float32)
    return _device_constant(arr.tobytes(), arr.shape, torch.device(device))


@functools.cache
def _device_constant(data: bytes, shape, device):
    host = np.frombuffer(data, np.float32).reshape(shape).copy()
    return torch.from_numpy(host).to(device)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace scope (no-op when ``log_dir`` is None): the
    host's operators, the program's spans (:func:`span`) and, with a card,
    its kernels, written on exit as
    ``<log_dir>/ptx_torch_<pid>_<time>.trace.json`` (Chrome trace format)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"ptx_torch_{os.getpid()}_{int(time.time())}.trace.json"))
