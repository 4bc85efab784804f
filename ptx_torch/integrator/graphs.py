"""The forward wavefront loop as a device program: the counterpart of the
JAX package's ``lax.while_loop`` (``ptx/integrator/wavefront.py::
_chunked_forward``: ``outer_cond``, ``outer_body`` and ``chunk_body``).

:class:`DeviceLoop` is the fused integrator of one scene
(``shade_cuda.make_pallas_integrator``).  It runs the schedule of the host
loop ``wavefront._chunked_forward`` -- sort the wavefront dead-last, step
the live CHUNK-lane chunks, stop sorting once the stragglers fit chunk 0
-- with three changes that leave every image bit-identical to it:

* **Static buffers.**  Each launch shape (``r`` lanes) has a wavefront of
  its own: the launch's initial state is copied into it, the sort gathers
  and copies back into it, and each chunk step writes its slice in place.
  The outputs are copied out (un-permuted) before the call returns, so the
  next launch may reuse the buffers.
* **The live count one iteration late.**  After it enqueues iteration
  ``i``, the loop enqueues the live count ``c_{i+1}`` as an asynchronous
  copy into pinned host memory and records an event; before it issues
  iteration ``i + 1`` it waits only on the event of ``c_i``, so the device
  still holds a whole iteration when the host waits, and no count is read
  with a device sync.  The sort at ``i`` depends on ``c_j``, ``j < i``, as
  the host loop's does, so the permutations and every 128-ray block are the
  same.  The chunk count is ``ceil(c_{i-1} / CHUNK)`` where the host loop's
  is ``ceil(c_i / CHUNK)``, and the loop runs while ``c_{i-1} > 0``, at most
  one all-dead iteration past the end.  Lanes never revive, so the extra
  chunks hold only dead lanes, and stepping a dead lane is the identity: a
  parked lane fails every gate and the shade kernel passes a dead lane
  through (the JAX package's own argument for its lockstep ranks).  The
  sort of an all-dead wavefront is the identity (equal keys, a stable
  sort).
* **CUDA graphs.**  On a CUDA device each chunk step and the sort are
  captured on first use, into one memory pool, and replayed after that.
  The kernels take ``it``, the pointers and the scalars by value, so a
  chunk step's graph is keyed by (launch shape, iteration, chunk) and the
  sort's by the launch shape: at most ``max_iters * n_chunks + 1`` graphs
  per shape.  Each graph keeps the kernel launches its capture counted and
  adds them to ``_build.LAUNCHES`` on every replay.

The graphs read the scene's tensors in place, so a loop serves one scene:
a call with another scene's tensors raises, and a failed capture raises.
On CPU tensors the loop runs the same schedule (buffers, lagged count,
dead chunks) without capture; the CPU tests hold it against the host loop.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from ptx_torch.config import RenderConfig
from ptx_torch.integrator import wavefront
from ptx_torch.integrator.wavefront import (RayState, initial_state,
                                            max_iterations)
from ptx_torch.kernels import _build, shade_cuda, sorting
from ptx_torch.scene.flatten import FlatScene, SceneStatic


class GraphRunner:
    """The CUDA graphs of a device program (:class:`DeviceLoop`, and
    ``ptx_torch.diff.graphs.DeviceScan``): captured into one memory pool on
    a stream of their own, each with the kernel launches its capture
    counted, and replayed.

    Read by ``chip_smoke.py``: ``captures`` and ``capture_seconds`` (graphs
    captured so far, host seconds spent capturing them),
    :meth:`pool_bytes`, and ``replay_events``: set it to a list and each
    replay appends its (start, end) CUDA events."""

    def __init__(self):
        self._pool = None
        self._stream = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.replay_events: Optional[List[Tuple]] = None

    def _graph(self, fn):
        """``(graph, tally, fn())``: ``fn``'s work captured into a CUDA
        graph in the pool on the runner's stream, and the launches the
        wrappers counted meanwhile (taken back out of ``_build.LAUNCHES``:
        a capture launches nothing).  Raises if the capture fails."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        before = dict(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(self._pool)
                try:
                    result = fn()
                finally:
                    graph.capture_end()
        finally:
            tally = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                     if n != before[k]}
            _build.LAUNCHES.update(before)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return graph, tally, result

    def _replay(self, graph, tally):
        """Replay ``graph`` and count its capture's launches."""
        if self.replay_events is None:
            graph.replay()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            self.replay_events.append((start, end))
        _build.add_launches(tally)

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the graphs' memory pool holds (the caching
        allocator's segments of that pool); None before the first
        capture."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


def read_count(launch, i: int) -> int:
    """``c_i`` of a launch whose live counts are copied into (pinned) host
    memory ``launch.host`` and recorded on ``launch.events``, once its copy
    has landed (an event wait, not a sync)."""
    if launch.cuda:
        launch.events[i].synchronize()
    return int(launch.host[i])


class _Launch:
    """The wavefront buffers, live counts and graphs of one launch shape."""

    def __init__(self, template: RayState, max_iters: int, compact: bool):
        r = template.orig.shape[0]
        dev = template.orig.device
        self.cuda = dev.type == "cuda"
        # Without compaction the host loop steps the whole wavefront.
        self.chunk, self.n_chunks = (wavefront.chunk_layout(r) if compact
                                     else (r, 1))
        self.state = RayState(*(torch.empty_like(x) for x in template))
        self.slot = torch.empty((r,), dtype=torch.int64, device=dev)
        self.lanes = torch.arange(r, device=dev)
        # counts[i] = c_i, the live count entering iteration i, written by
        # the device into (pinned) host memory and read through ``host``.
        self.counts = torch.zeros((max_iters + 1,), dtype=torch.int64,
                                  pin_memory=self.cuda)
        self.host = self.counts.numpy()
        self.events = ([torch.cuda.Event() for _ in range(max_iters + 1)]
                       if self.cuda else None)
        self.graphs = {}
        self.warm = not self.cuda

    def buffer_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (*self.state, self.slot, self.lanes))


class DeviceLoop(GraphRunner):
    """The fused integrator ``(fs, pixel_ids, sample_ids) -> (radiance
    [R, 3], alpha [R])`` of one scene on the device loop (module
    docstring).  ``step`` is ``shade_cuda.make_pallas_step``'s bounce.
    Read by ``chip_smoke.py`` as a :class:`GraphRunner`, and its
    :meth:`schedule` (the last call's counts against the host loop's)."""

    def __init__(self, static: SceneStatic, cfg: RenderConfig, step):
        super().__init__()
        self.static, self.cfg, self.step = static, cfg, step
        self.max_iters = max_iterations(static, cfg)
        self.compact = sorting.resolve_compact(static, cfg)
        self._scene = None  # (fs, its tensors' (pointer, shape)) it serves
        self._sun = None
        self._launches = {}
        self._last = None

    def __call__(self, fs: FlatScene, pixel_ids, sample_ids):
        r = pixel_ids.shape[0]
        if r % shade_cuda.LANES:
            raise ValueError(f"ray count {r} must be a multiple of "
                             f"{shade_cuda.LANES}")
        self._bind(fs)
        with torch.no_grad():
            init = initial_state(fs, self.cfg, pixel_ids, sample_ids)
            launch = self._launches.get(r)
            if launch is None:
                launch = self._launches[r] = _Launch(init, self.max_iters,
                                                     self.compact)
            for dst, src in zip(launch.state, init):
                dst.copy_(src)
            launch.slot.copy_(launch.lanes)
            if not launch.warm:
                self._warm_up(fs, launch)
            return self._loop(fs, launch, r)

    def _bind(self, fs: FlatScene):
        """Take ``fs`` as the loop's scene on the first call; raise on a
        later call with other tensors (the graphs hold their pointers).
        Holding ``fs`` keeps its memory from going to another scene."""
        key = tuple((x.data_ptr(), tuple(x.shape)) for x in fs)
        if self._scene is None:
            self._scene = (fs, key)
            # The sun's by-value kernel scalars: one device read per scene.
            if self.static.has_sun:
                self._sun = shade_cuda.sun_constants(fs)
        elif key != self._scene[1]:
            raise ValueError(
                "this integrator serves another scene's tensors (its CUDA "
                "graphs read them in place): make one integrator per scene")

    def _warm_up(self, fs: FlatScene, launch: _Launch):
        """One chunk step and one sort, eagerly, on a copy of the launch's
        first chunk and into new tensors, before the shape's first capture:
        what a kernel or a constant sets up on first use (a module load, a
        shared-memory opt-in, ``utils.device_constant``) happens outside
        capture."""
        sub = RayState(*(x[:launch.chunk].clone() for x in launch.state))
        self.step(fs, 0, sub, self._sun)
        if self.compact:
            wavefront.sort_wavefront(launch.state, launch.slot, self.static)
        launch.warm = True

    def _loop(self, fs: FlatScene, launch: _Launch, r: int):
        chunk, n_chunks = launch.chunk, launch.n_chunks
        skip = wavefront.sort_skip_max(chunk)
        counts = [r]  # c_0 (every camera lane starts alive), c_1, ... read
        steps = []  # chunks stepped in each iteration
        sorts = 0
        in_c0 = False
        for it in range(self.max_iters):
            if it > 0:
                if it > 1:
                    counts.append(read_count(launch, it - 1))
                if counts[it - 1] == 0:
                    break
                in_c0 = in_c0 or counts[it - 1] <= skip
            n_live = min(-(-counts[max(it - 1, 0)] // chunk), n_chunks)
            if self.compact and not in_c0:
                self._run(launch, ("sort",), lambda: self._sort(launch))
                sorts += 1
            for ci in range(n_live):
                self._run(launch, (it, ci),
                          lambda ci=ci: self._chunk_step(fs, launch, it, ci))
            launch.counts[it + 1].copy_(launch.state.alive.sum(),
                                        non_blocking=True)
            if launch.cuda:
                launch.events[it + 1].record()
            steps.append(n_live)
        self._last = (launch, counts, steps, sorts)
        state = launch.state
        if not self.compact:
            return state.radiance.clone(), state.alpha.clone()
        radiance = torch.empty_like(state.radiance)
        radiance[launch.slot] = state.radiance
        alpha = torch.empty_like(state.alpha)
        alpha[launch.slot] = state.alpha
        return radiance, alpha

    def _sort(self, launch: _Launch):
        state, slot = wavefront.sort_wavefront(launch.state, launch.slot,
                                               self.static)
        for dst, src in zip((*launch.state, launch.slot), (*state, slot)):
            dst.copy_(src)

    def _chunk_step(self, fs: FlatScene, launch: _Launch, it: int, ci: int):
        sl = slice(ci * launch.chunk, (ci + 1) * launch.chunk)
        sub = self.step(fs, it, RayState(*(x[sl] for x in launch.state)),
                        self._sun)
        for dst, src in zip(launch.state, sub):
            dst[sl] = src

    def _run(self, launch: _Launch, key, fn):
        """``fn`` on the CPU; on a CUDA device the replay of its graph,
        captured on first use."""
        if not launch.cuda:
            fn()
            return
        entry = launch.graphs.get(key)
        if entry is None:
            entry = launch.graphs[key] = self._graph(fn)[:2]
        self._replay(*entry)

    def buffer_bytes(self) -> int:
        """Device bytes of the static wavefront buffers, all shapes."""
        return sum(x.buffer_bytes() for x in self._launches.values())

    def schedule(self) -> dict:
        """The last call's schedule from its live counts (waits for the last
        of them; call it before the next launch reuses them):
        ``iterations``, ``sorts`` and ``chunk_steps`` run,
        ``host_iterations`` and ``host_chunk_steps`` that the host loop runs
        on the same counts, and ``dead_chunks``, the chunk steps the lag
        added."""
        launch, counts, steps, sorts = self._last
        counts = list(counts)
        for i in range(len(counts), len(steps) + 1):
            counts.append(read_count(launch, i))
        host = []
        for c in counts[:self.max_iters]:
            if c == 0:
                break
            host.append(min(-(-c // launch.chunk), launch.n_chunks))
        return dict(counts=counts, iterations=len(steps), sorts=sorts,
                    chunk_steps=sum(steps), host_iterations=len(host),
                    host_chunk_steps=sum(host),
                    dead_chunks=sum(steps) - sum(host))
