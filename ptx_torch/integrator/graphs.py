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

A tp rank's loop is the same program with its exchanges between graphs
(the counterpart of the collectives inside ``ptx``'s ``shard_map``): each
collective of a chunk step is an exchange point (:func:`exchange`) where
the step's capture is cut, so the step is a program of segments -- graph,
exchange, graph, ... -- replayed in capture order, each exchange run
eagerly between two replays (enqueued on the stream under NCCL, staged
through the host under gloo).  The live count is the world's largest
(``live_sync``, reduced on the device under NCCL) and still read one
iteration late, so every rank runs the same iterations, chunk steps and
exchanges in the same order.  A step without exchanges is one segment:
the one-card and dp routes' graphs.

A call ``(fs, pixel_ids, sample_ids)`` copies the ids into the wavefront,
replays the shape's load graph (camera rays and fresh lanes,
``wavefront.load_initial_state``), runs the loop and returns the outputs
un-permuted into new tensors.  :class:`DevicePass` runs a whole sample
pass without those eager edges: per launch one copy of its scalars, a
prologue graph that also makes the ids, the loop, and an epilogue graph
that folds the launch into the pass's carry in place -- the counterpart
of ``ptx``'s jitted sample pass and donated running mean.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch

from ptx_torch import utils
from ptx_torch.config import RenderConfig
from ptx_torch.integrator import wavefront
from ptx_torch.integrator.wavefront import (RayState, empty_state,
                                            load_initial_state, max_iterations)
from ptx_torch.kernels import _build, shade_cuda, sorting
from ptx_torch.scene.flatten import FlatScene, SceneStatic


# The runner whose program capture :func:`exchange` cuts (None: an exchange
# runs eagerly; :data:`_REFUSE` inside a single-graph capture).
_CUTTER = None


class _Refuse:
    """The cutter of a capture that may hold no exchange
    (:meth:`GraphRunner._graph`)."""

    @staticmethod
    def _cut(op, src, dst):
        raise RuntimeError(
            "an exchange inside a single-graph capture: a collective there "
            "would not run between replays (capture the unit as a program)")


_REFUSE = _Refuse()


def exchange(op, src, dst):
    """An exchange point of a device program: ``op(src, dst)``, a collective
    that reads ``src`` and writes ``dst`` in place (``src`` may be ``dst``).

    It runs eagerly, unless a :class:`GraphRunner` is capturing a program
    (:meth:`GraphRunner._program`): then the graph captured so far ends and
    is replayed, ``op`` runs, and the next graph begins, and every later run
    of the program replays the graph, runs ``op`` on the same two tensors,
    replays the next graph, and so on.  So ``src`` and ``dst`` must be made
    inside the capture (they then sit in the graph pool, and the program
    holds them at their addresses) or outlive the program.  Inside a
    single-graph capture (:meth:`GraphRunner._graph`: the device scan's
    backward) it raises, and ``op`` does not run."""
    if _CUTTER is None:
        op(src, dst)
    else:
        _CUTTER._cut(op, src, dst)


class GraphRunner:
    """The CUDA graphs of a device program (:class:`DeviceLoop`, and
    ``ptx_torch.diff.graphs.DeviceScan``): captured into one memory pool on
    a stream of their own, each with the kernel launches its capture
    counted, and replayed.

    A unit of work that holds exchanges (:func:`exchange`: a tp rank's
    collectives) is a program of segments, one graph each, cut at its
    exchanges; the exchanges run between the replays, on the current
    stream.  A unit without one is a program of one graph.

    Each replay is a ``ptx.replay`` span (``utils.span``).  Read by
    ``chip_smoke.py``: ``captures`` and ``capture_seconds`` (graphs
    captured so far, host seconds spent capturing them, the replays and
    exchanges run meanwhile included) and :meth:`pool_bytes`."""

    def __init__(self):
        self._pool = None
        self._stream = None
        self._outer = None  # the stream the program runs on
        self._open = None  # the graph being captured, its launches before
        self._segments = None  # the segments of the program being captured
        self.captures = 0
        self.capture_seconds = 0.0

    def _record(self, fn, cuts: bool):
        """``(segments, fn())``: ``fn``'s work captured into CUDA graphs in
        the pool on the runner's stream, as ``[graph, tally, exchange]``
        segments (``tally``: the launches the wrappers counted meanwhile,
        taken back out of ``_build.LAUNCHES``: a capture launches nothing;
        ``exchange``: the ``(op, src, dst)`` that follows the segment, None
        for the last).  Without ``cuts`` the work is one segment, and an
        exchange reached inside ``fn`` raises.  Raises if a capture fails.

        The garbage collector is off during the capture: a collection
        there may free another runner's graphs and memory pool, and the
        CUDA calls that destroy them invalidate the capture."""
        global _CUTTER
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        self._outer = torch.cuda.current_stream()
        self._segments = []
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                self._begin_graph()
                _CUTTER = self if cuts else _REFUSE
                try:
                    result = fn()
                finally:
                    _CUTTER = None
                    if self._open is not None:
                        self._end_graph()
        finally:
            if collecting:
                gc.enable()
            self.capture_seconds += time.perf_counter() - t0
            segments, self._segments = self._segments, None
        return segments, result

    def _begin_graph(self):
        graph = torch.cuda.CUDAGraph()
        self._open = (graph, dict(_build.LAUNCHES))
        # Thread-local: an unsafe call of this thread (a sync, an
        # allocation outside the pool) fails the capture, while another
        # thread's (NCCL's watchdog polls its events) does not.
        graph.capture_begin(self._pool, capture_error_mode="thread_local")

    def _end_graph(self):
        """End the open capture; its segment joins the program."""
        (graph, before), self._open = self._open, None
        try:
            graph.capture_end()
        finally:
            tally = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                     if n != before[k]}
            _build.LAUNCHES.update(before)
        self.captures += 1
        self._segments.append([graph, tally, None])

    def _cut(self, op, src, dst):
        """At an exchange inside a program's capture: end the segment,
        replay it, run the exchange on the outer stream, begin the next."""
        self._end_graph()
        segment = self._segments[-1]
        segment[2] = (op, src, dst)
        with torch.cuda.stream(self._outer):
            self._replay(segment[0], segment[1])
            op(src, dst)
        self._begin_graph()

    def _graph(self, fn):
        """``(graph, tally, fn())``: ``fn``'s work captured as one graph
        (:meth:`_record` without cuts: an exchange inside raises), not
        run."""
        ((graph, tally, _),), result = self._record(fn, cuts=False)
        return graph, tally, result

    def _program(self, fn):
        """``(segments, fn())``: ``fn``'s work captured as a program cut at
        its exchanges, and run once meanwhile (each segment replayed at its
        cut, the last one after the capture), so the capture is the unit's
        first run: each exchange runs once."""
        segments, result = self._record(fn, cuts=True)
        self._replay(*segments[-1][:2])
        return segments, result

    def _run(self, graphs: dict, key, fn, cuda: bool, warm=None):
        """``fn()`` on the CPU; on a CUDA device the program
        ``graphs[key]``, captured (and so run) on first use after ``warm()``
        (an eager run of the same work, so that what a first use sets up
        happens outside capture), replayed after that."""
        if not cuda:
            fn()
            return
        segments = graphs.get(key)
        if segments is None:
            if warm is not None:
                warm()
            graphs[key], _ = self._program(fn)
        else:
            self._run_program(segments)

    def _run_program(self, segments):
        """Replay a program: each segment, then its exchange."""
        for graph, tally, ex in segments:
            self._replay(graph, tally)
            if ex is not None:
                ex[0](ex[1], ex[2])

    def _replay(self, graph, tally):
        """Replay ``graph`` and count its capture's launches."""
        with utils.span("ptx.replay"):
            graph.replay()
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

    def __init__(self, r: int, device, max_iters: int, compact: bool):
        self.cuda = device.type == "cuda"
        # Without compaction the host loop steps the whole wavefront.
        self.chunk, self.n_chunks = (wavefront.chunk_layout(r) if compact
                                     else (r, 1))
        self.state = empty_state(r, device)
        self.slot = torch.empty((r,), dtype=torch.int64, device=device)
        self.lanes = torch.arange(r, device=device)
        # The outputs in lane order again (a pass's epilogue writes them).
        self.out = ((torch.empty((r, 3), device=device),
                     torch.empty((r,), device=device)) if compact else None)
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
                   for x in (*self.state, self.slot, self.lanes,
                             *(self.out or ())))

    def unpermuted(self):
        """The launch's (radiance, alpha) in lane order: the wavefront's
        own buffers without compaction, else ``out`` written through
        ``slot`` (no allocation outlives the call)."""
        state = self.state
        if self.out is None:
            return state.radiance, state.alpha
        self.out[0][self.slot] = state.radiance
        self.out[1][self.slot] = state.alpha
        return self.out


class DeviceLoop(GraphRunner):
    """The fused integrator ``(fs, pixel_ids, sample_ids) -> (radiance
    [R, 3], alpha [R])`` of one scene on the device loop (module
    docstring).  ``step`` is ``shade_cuda.make_pallas_step``'s bounce;
    ``live_sync`` (a tp rank's, ``parallel.dist``) maps this rank's live
    count, a tensor, to the world's largest on the device.
    Read by ``chip_smoke.py`` as a :class:`GraphRunner`, and its
    :meth:`schedule` (the last call's counts against the host loop's).

    Running totals over every launch, read with :meth:`counters` (and
    printed by ``render --metrics``): ``iterations`` and ``sorts`` run,
    ``lanes_stepped`` (chunk steps run x the chunk's lanes) and
    ``lanes_live`` (the sum of ``c_i``, the live count entering each
    iteration run), so that ``lanes_live / lanes_stepped`` is the share of
    the lanes stepped that were alive.  They take only the counts the loop
    reads anyway, and wait for none.  A launch that runs all ``max_iters``
    does not read the count entering its last iteration: the next launch
    takes it after its own first read, which follows it in stream order,
    and :meth:`counters` with a wait.  Where that launch has no read before
    it writes the slot again (loops of at most three iterations), the
    iteration is left out of both lane totals."""

    def __init__(self, static: SceneStatic, cfg: RenderConfig, step,
                 live_sync=None):
        super().__init__()
        self.static, self.cfg, self.step = static, cfg, step
        self.live_sync = live_sync
        self.max_iters = max_iterations(static, cfg)
        self.compact = sorting.resolve_compact(static, cfg)
        self._scene = None  # (fs, its tensors' (pointer, shape)) it serves
        self._sun = None
        self._launches = {}
        self._last = None
        self.iterations = self.sorts = 0
        self.lanes_stepped = self.lanes_live = 0
        # (launch, i, lanes): the last iteration of the previous launch,
        # whose entering count c_i is unread, and the lanes it stepped.
        self._owed = None

    def __call__(self, fs: FlatScene, pixel_ids, sample_ids):
        r = pixel_ids.shape[0]
        self._bind(fs)
        with torch.no_grad(), utils.span("ptx.launch"):
            launch = self._launch(r, pixel_ids.device)
            launch.state.pixel_ids.copy_(pixel_ids)
            launch.state.sample_ids.copy_(sample_ids)
            self._start(fs, launch, launch.graphs, ("load",))
            self._loop(fs, launch, r)
            return tuple(x.clone() for x in launch.unpermuted())

    def _launch(self, r: int, device) -> _Launch:
        """The buffers of launch shape ``r``."""
        if r % shade_cuda.LANES:
            raise ValueError(f"ray count {r} must be a multiple of "
                             f"{shade_cuda.LANES}")
        launch = self._launches.get(r)
        if launch is None:
            launch = self._launches[r] = _Launch(r, torch.device(device),
                                                 self.max_iters, self.compact)
        return launch

    def _start(self, fs: FlatScene, launch: _Launch, graphs: dict, key,
               ids=None):
        """A launch's prologue, as the graph ``graphs[key]`` on a CUDA
        device: ``ids()`` (writes the wavefront's pixel and sample ids;
        None: they are there already), the camera rays and the fresh lanes
        into the wavefront, the slots reset.  Before the shape's first
        chunk step, the warm-up."""
        def prologue():
            if ids is not None:
                ids()
            load_initial_state(fs, self.cfg, launch.state)
            launch.slot.copy_(launch.lanes)

        self._run(graphs, key, prologue, launch.cuda, warm=prologue)
        if not launch.warm:
            self._warm_up(fs, launch)

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
        shared-memory opt-in, ``utils.device_constant``, a communicator)
        happens outside capture.  A tp rank's step issues its collectives
        here too; every rank of the world warms up at the same point, since
        each makes the same launch shapes in the same order and steps them
        on the same (world-largest) live counts."""
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
                    if it == 2:
                        self._settle(launch)
                if counts[it - 1] == 0:
                    break
                in_c0 = in_c0 or counts[it - 1] <= skip
            n_live = min(-(-counts[max(it - 1, 0)] // chunk), n_chunks)
            if self.compact and not in_c0:
                self._run(launch.graphs, ("sort",),
                          lambda: self._sort(launch), launch.cuda)
                sorts += 1
            for ci in range(n_live):
                self._run(launch.graphs, (it, ci),
                          lambda ci=ci: self._chunk_step(fs, launch, it, ci),
                          launch.cuda)
            live = launch.state.alive.sum()
            if self.live_sync is not None:
                live = self.live_sync(live)
            launch.counts[it + 1].copy_(live, non_blocking=True)
            if launch.cuda:
                launch.events[it + 1].record()
            steps.append(n_live)
        self._last = (launch, counts, steps, sorts)
        n = len(counts)  # the iterations whose entering count was read
        self.iterations += len(steps)
        self.sorts += sorts
        self.lanes_stepped += chunk * sum(steps[:n])
        self.lanes_live += sum(counts)
        # An owed count this launch did not take is dropped (class docstring).
        self._owed = (launch, n, chunk * steps[n]) if n < len(steps) else None

    def _settle(self, current: Optional[_Launch] = None):
        """Add the owed iteration to the lane totals: read by a wait with
        ``current`` None, else right after ``current``'s first read, with
        no wait, unless ``current`` has written its slot again."""
        if self._owed is None:
            return
        launch, i, lanes = self._owed
        self._owed = None
        if current is None:
            c = read_count(launch, i)
        elif launch is not current or i > 2:
            c = int(launch.host[i])
        else:
            return
        self.lanes_live += c
        self.lanes_stepped += lanes

    def counters(self) -> dict:
        """The running totals (class docstring), the owed count read."""
        self._settle()
        return dict(iterations=self.iterations, sorts=self.sorts,
                    lanes_stepped=self.lanes_stepped,
                    lanes_live=self.lanes_live)

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


# --------------------------------------------------------------------------
# The sample pass
# --------------------------------------------------------------------------

def launch_ids(first: int, p: int, k: int, sample0: int, device):
    """The ids of a launch of ``k`` samples of pixels ``first .. first + p
    - 1``, as ``ptx``'s ``chunk_pass`` / ``batch_pass`` make them:
    ``first + tile(arange(p), k)`` and ``sample0 + repeat(arange(k), p)``."""
    pixel_ids = first + torch.arange(p, dtype=torch.int32,
                                     device=device).repeat(k)
    sample_ids = sample0 + torch.arange(
        k, dtype=torch.int32, device=device).repeat_interleave(p)
    return pixel_ids, sample_ids


def launch_scalars(first: int, s: int, count: int, k: int, claim: bool
                   ) -> np.ndarray:
    """The scalars of a :class:`DevicePass` launch of samples ``s .. s + k
    - 1`` (``count`` of them folded): int32 ``[first pixel, s]``, then the
    bits of float32 ``[count, n_0 .. n_{k-1}, inv_0 .. inv_{k-1}]``: for the
    running mean ``n_0 = s`` and ``inv_0 = 1 / (s + count)``, for the claim
    blend ``n_i = s + i`` and ``inv_i = 1 / (s + i + 1)``, each divided in
    float32 as the plain folds divide (IEEE division rounds correctly on
    every device, and every ``n`` below 2^24 is exact in float32)."""
    h = np.zeros(3 + 2 * k, np.int32)
    h[0], h[1] = first, s
    f = h[2:].view(np.float32)
    f[0] = count
    if claim:
        n = np.arange(s, s + k)
        f[1:1 + k] = n
        f[1 + k:] = np.float32(1.0) / (n + 1).astype(np.float32)
    else:
        f[1] = s
        f[1 + k] = np.float32(1.0) / np.float32(s + count)
    return h


def fold_mean(carry, colors, alphas, f):
    """``render._update_mean`` (k = 1) and ``_update_mean_batch`` on device
    scalars, into ``carry`` in place: ``colors`` [k, P, 3], ``alphas`` [k,
    P], ``f`` the launch's float scalars (:class:`DevicePass`).  The same
    operations on the same shapes as the plain versions, each rounded where
    theirs is, so the carry is theirs bit for bit."""
    k = colors.shape[0]
    color, alpha = carry[0], carry[1]
    if k == 1:
        x, a = colors[0], alphas[0]
    else:
        valid = (torch.arange(k, device=colors.device) < f[0]).to(colors.dtype)
        x = (colors * valid[:, None, None]).sum(0)
        a = (alphas * valid[:, None]).sum(0)
    n, inv = f[1], f[1 + k]
    color.mul_(n).add_(x).mul_(inv)
    alpha.mul_(n).add_(a).mul_(inv)


def fold_claim(carry, colors, alphas, f):
    """``render._update_claim_batch`` on device scalars, into ``carry`` in
    place, as ``ptx``'s ``_update_claim_batch`` folds: every one of the k
    samples runs ``_claim_step`` and is kept where ``i < count``."""
    k = colors.shape[0]
    color, alpha, claimed = carry
    for i in range(k):
        x, a = colors[i], alphas[i]
        n, inv = f[1 + i], f[1 + k + i]
        opaque = a > 0.5
        claim_now = opaque & ~claimed
        blend = opaque & claimed
        trans_on_claimed = ~opaque & claimed
        new_color = torch.where(
            claim_now[:, None], x,
            torch.where(blend[:, None], (color * n + x) * inv, color))
        new_alpha = torch.where(
            claim_now, inv,
            torch.where(blend | trans_on_claimed, (alpha * n + a) * inv, alpha))
        new_claimed = claimed | claim_now
        do = f[0] > i
        color.copy_(torch.where(do, new_color, color))
        alpha.copy_(torch.where(do, new_alpha, alpha))
        claimed.copy_(torch.where(do, new_claimed, claimed))


class DevicePass:
    """The sample pass of a frame, or of a rank's pixel slice, on a
    :class:`DeviceLoop`: the counterpart of ``ptx``'s jitted
    ``sample_pass`` / ``chunk_pass`` / ``batch_pass`` followed by its
    donated ``_update_mean*`` / ``_update_claim*`` (``ptx/render.py``).
    ``render.make_sample_fn`` / ``make_batched_sample_fn`` and
    ``parallel.dist.make_distributed_sample_fn`` return it for the fused
    integrator.

    The pass covers pixels ``first .. first + n_pixels - 1`` in launches of
    ``chunk`` pixels and ``k`` samples (``k > 1``: one launch of the whole
    slice).  It owns the carry (``carry``: color [n_pixels, 3], alpha, and
    for a transparent background the claimed mask), which
    ``render.progressive_render`` resets or loads and reads only at a
    checkpoint, a preview or the end.  :meth:`accumulate` folds samples
    ``s .. s + count - 1`` into it; each launch is

    1. one non-blocking copy of its scalars from pinned memory (a fresh
       block of the caching host allocator, so no copy still in flight is
       overwritten): the first pixel and ``sample0``, then as float32
       ``count``, ``n_i = s + i`` and ``inv_i`` (the mean's ``1 / (s +
       count)``, or the claim blend's ``1 / (s + i + 1)``), computed as the
       plain folds compute them;
    2. the prologue graph: the ids (``launch_ids``' formula on the
       scalars), the camera rays and fresh lanes into the loop's wavefront
       (``DeviceLoop._start``);
    3. the device loop's replays;
    4. the epilogue graph of the launch's place in the frame: the outputs
       un-permuted through the slots and folded into that slice of the
       carry in place (:func:`fold_mean`, :func:`fold_claim`; a fold is
       elementwise per pixel, so slices folded one by one equal the
       concatenated frame folded once).

    No host read happens between launches but the loop's lagged live
    counts.  On CPU tensors the same code runs without capture.  Graphs
    live on the pass (they read its carry); at most one prologue and
    ``n_pixels / chunk`` epilogues.  Called as ``(fs, sample0) ->
    (radiance, alpha)`` ([P, 3] / [P], or [k, P, 3] / [k, P] when ``k >
    1``) it is the plain sample function over ``DeviceLoop.__call__``
    (the debug views, a profiled sample)."""

    def __init__(self, loop: DeviceLoop, cfg: RenderConfig, device,
                 first: int, n_pixels: int, chunk: int, k: int):
        self.loop, self.k, self.first, self.chunk = loop, k, first, chunk
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.claim = cfg.transparent_background
        dev = dict(device=self.device)
        self.carry = (torch.zeros((n_pixels, 3), **dev),
                      torch.zeros((n_pixels,), **dev))
        if self.claim:
            self.carry += (torch.zeros((n_pixels,), dtype=torch.bool, **dev),)
        # ints [first, sample0], then float32 bits [count, n_i.., inv_i..].
        self._scalars = torch.zeros((3 + 2 * k,), dtype=torch.int32, **dev)
        self._lanes = launch_ids(0, chunk, k, 0, self.device)
        self._graphs = {}

    def __call__(self, fs: FlatScene, sample0: int):
        parts = [self.loop(fs, *launch_ids(start, self.chunk, self.k,
                                           sample0, self.device))
                 for start in self._starts()]
        radiance = torch.cat([p[0] for p in parts])
        alpha = torch.cat([p[1] for p in parts])
        if self.k == 1:
            return radiance, alpha
        return (radiance.reshape(self.k, self.chunk, 3),
                alpha.reshape(self.k, self.chunk))

    def _starts(self):
        return range(self.first, self.first + self.carry[1].shape[0],
                     self.chunk)

    def accumulate(self, fs: FlatScene, s: int, count: int):
        """Fold samples ``s .. s + count - 1`` (``count <= k``; the launch
        traces all k) into the carry, enqueued without a device sync."""
        loop = self.loop
        loop._bind(fs)
        r = self.chunk * self.k
        with torch.no_grad():
            launch = loop._launch(r, self.device)
            for j, start in enumerate(self._starts()):
                with utils.span("ptx.launch"):
                    self._write_scalars(start, s, count)
                    loop._start(fs, launch, self._graphs, ("prologue",),
                                lambda: self._ids(launch))
                    loop._loop(fs, launch, r)
                    part = tuple(c[j * self.chunk:(j + 1) * self.chunk]
                                 for c in self.carry)
                    loop._run(self._graphs, ("epilogue", j),
                              lambda: self._fold(launch, part), launch.cuda,
                              warm=lambda: self._fold(
                                  launch, tuple(c.clone() for c in part)))

    def _write_scalars(self, first: int, s: int, count: int):
        host = torch.empty(self._scalars.shape, dtype=torch.int32,
                           pin_memory=self.cuda)
        host.numpy()[:] = launch_scalars(first, s, count, self.k, self.claim)
        self._scalars.copy_(host, non_blocking=True)

    def _ids(self, launch: _Launch):
        pixel_lanes, sample_lanes = self._lanes
        torch.add(pixel_lanes, self._scalars[0], out=launch.state.pixel_ids)
        torch.add(sample_lanes, self._scalars[1], out=launch.state.sample_ids)

    def _fold(self, launch: _Launch, carry):
        radiance, alpha = launch.unpermuted()
        colors = radiance.view(self.k, self.chunk, 3)
        alphas = alpha.view(self.k, self.chunk)
        f = self._scalars[2:].view(torch.float32)
        (fold_claim if self.claim else fold_mean)(carry, colors, alphas, f)
