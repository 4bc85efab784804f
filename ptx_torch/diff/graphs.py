"""The differentiable scan as a device program: the counterpart of the JAX
package's compiled value and gradient (``jax.jit`` of
``inverse.make_batch_value_and_grad_fn`` in ``ptx/bench.py`` and of the
training step in ``ptx/diff/inverse.py::optimize``, around the general
scan's ``lax.scan`` in ``ptx/integrator/wavefront.py``).

:class:`DeviceScan` is the differentiable integrator ``(fs, pixel_ids,
sample_ids) -> (radiance [R, 3], alpha [R])`` of one scene
(``diff.inverse.make_diff_integrator`` on a CUDA device, a tp rank's
included).  It runs the schedule of the host scan
``wavefront.make_integrator(..., differentiable=True)`` -- up to
``max_iters`` full-width bounce steps, no compaction, dead lanes parked --
with three changes that leave the loss bit-identical to it:

* **Static buffers.**  Each launch shape (``r`` lanes) has an initial
  state of its own, and step ``it`` of it reads its predecessor's outputs
  in place.  A call copies its pixel and sample ids into the initial
  state and replays the shape's load graph, which writes the camera rays
  and the fresh lanes from them (``wavefront.load_initial_state``).  The
  fields a call may hand over anew (the parameters, the packed rows
  ``inject_params`` overlays with them, the tiles a geometry set repacks
  per call) are copied into the scan's own buffers; every other field of
  the scene is read in place, so a call with another scene's tensors
  raises.
* **The live count one iteration late**, as in ``integrator.graphs.
  DeviceLoop``: after it enqueues step ``i`` the scan copies the live count
  ``c_{i+1}`` into pinned host memory and records an event; before step
  ``i + 1`` it waits only on the event of ``c_i``, never on the device.
  On a tp rank the count is the world's largest (``live_sync``: a
  device-side max under NCCL, staged through the host under gloo), as the
  host scan's is, so every rank runs the same steps.
  Step ``i`` runs while ``c_{i-1} > 0`` where the host scan's runs while
  ``c_i > 0``: at most one all-dead step past the end.  A step is the
  identity on dead lanes and its backward passes their cotangents through
  unchanged (each update is a ``where`` on a mask that is False there), so
  the extra step changes no value and no gradient.  ``ptx``'s static trip
  count is not copied: at ``opacity_extra_iters`` = 32 it would run ~24
  all-dead full-width steps of a translucent scene.
* **CUDA graphs of each step's forward and backward.**  On a CUDA device
  step ``it`` of a launch shape is captured on first use, into one memory
  pool: its forward under autograd (the state fields that carry a gradient
  and the parameter buffers as leaves) as a program
  (``GraphRunner._program``), and ``torch.autograd.grad`` of it as one
  graph, which writes the cotangents of the step's inputs into its
  predecessor's cotangent buffers and the parameters' running sums in
  place.  The backward is captured with ``retain_graph``, so the
  forward's residuals keep their pool memory.  ``it`` is baked into the
  RNG constants, so graphs are keyed by (launch shape, ``it``).  Before a
  shape's first capture one step runs eagerly, forward and backward, so
  module loads, ``utils.device_constant`` and a communicator's set-up
  happen outside capture.  Each graph keeps the kernel launches its
  capture counted and adds them to ``_build.LAUNCHES`` on every replay.

A tp rank's step holds its exchanges (the counterpart of the collectives
inside ``ptx``'s ``shard_map`` of the scan): the closest hit's reduce or
ring shifts, the occlusion max, a sharded texel pack's sums, each an
exchange point (``integrator.graphs.exchange``).  The forward's capture is
cut at each of them, so a step's forward is a program of segments -- graph,
exchange, graph, ... -- replayed in capture order with each exchange run
between two replays, as ``integrator.graphs.DeviceLoop`` runs a tp chunk
step.  The capture runs the program once (each segment replayed at its
cut), and that run is the step's first: each exchange runs once per step
on every rank.  The exchanges' tensors are made inside the capture and
held by the program; the residuals of every segment are held by the
step's autograd graph (``_settle``), which the backward graph reads for as
long as the scan lives.  No exchange carries a gradient (each is an
all-reduce or a shift of a copy), so ``autograd.grad`` of a step issues no
collective and its backward stays one graph; an exchange reached inside
that capture raises.  A step without exchanges is a program of one
segment: the one-card and dp routes.

Why neither ``torch.cuda.make_graphed_callables`` nor one graph of a whole
chunk's ``autograd.grad``: the trip count is decided on the host from the
lagged count, so a chunk has no fixed program to capture; the graphed
callables copy every input into their static inputs on each call and make
each step an autograd node of its own, where here a step reads its
predecessor's outputs in place and the whole scan is one node
(:class:`_Scan`); and a second forward overwrites their residuals before
the first backward without notice, which the loss functions do
(checkpointed sample groups, a batch loss over several launches).  Here
every forward bumps a generation, and a backward whose forward is no
longer the last first runs that forward again from the inputs it kept
(the pixel and sample ids, the per-call tensors), so each step's backward
reads its own forward's residuals.  Each step ends with a view of each
parameter whose cotangent is the running sum, so autograd adds a step's
terms to it one by one, in the order of the host scan's backward.

The eager edges run on every rank at the same points: the warm-up of a
launch shape's first use, and the rerun of a stale forward (exchanges
included) before its backward.  Every rank makes the same launch shapes
and loss calls in the same order (``parallel.dist`` cuts every rank's
slice alike), so these points match across the world.

A failed capture, a sync inside a captured segment, or an exchange inside
a backward capture raises; nothing falls back to the host scan.  On CPU
tensors the scan runs the same schedule (buffers, lagged count, dead step,
a backward per step, the exchanges eagerly) without capture; the CPU tests
hold it to the host scan bit for bit, tp ranks included.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ptx_torch import utils
from ptx_torch.config import RenderConfig
from ptx_torch.integrator.graphs import GraphRunner, read_count
from ptx_torch.integrator.wavefront import (RayState, empty_state,
                                            load_initial_state, make_step,
                                            max_iterations)
from ptx_torch.scene.flatten import FlatScene, SceneStatic


class _Launch:
    """The initial state, live counts and steps of one launch shape.  Step
    0 reads the initial state as a later step reads its predecessor's
    outputs; no gradient enters through it."""

    fields: Tuple[str, ...] = ()

    def __init__(self, r: int, device, max_iters: int):
        self.cuda = device.type == "cuda"
        self.out = empty_state(r, device)
        self.graphs = {}  # the load's
        self.gout = {}
        self.steps: List[_Step] = []
        # counts[i] = c_i, the live count entering step i, written by the
        # device into (pinned) host memory and read through ``host``.
        self.counts = torch.zeros((max_iters + 1,), dtype=torch.int64,
                                  pin_memory=self.cuda)
        self.host = self.counts.numpy()
        self.events = ([torch.cuda.Event() for _ in range(max_iters + 1)]
                       if self.cuda else None)
        self.warm = False


class _Step:
    """Bounce step ``it`` of one launch shape.  ``fields``: its outputs that
    carry a gradient, ``gout``: their cotangents; ``ins`` / ``out`` /
    ``seeds``: its last run under autograd (on a CUDA device the capture's,
    whose memory the graphs read and write); on a CUDA device
    ``forward``, the forward's program (``[graph, tally, exchange]``
    segments, one more than its exchanges), and ``backward``, the
    backward's graph and the kernel launches it holds (None while no
    parameter takes a gradient)."""

    def __init__(self, it: int, prev, cuda: bool):
        self.it, self.prev, self.cuda = it, prev, cuda
        self.fields: Optional[Tuple[str, ...]] = None
        self.gout = {}
        self.ins = self.out = self.seeds = None
        self.forward = self.backward = None


def _versions(call) -> list:
    pixel_ids, sample_ids, copies, grads = call
    return [x._version for x in (pixel_ids, sample_ids, *copies, *grads)]


class _Scan(torch.autograd.Function):
    """The scan as one autograd node: the forward runs the steps' forward
    graphs, the backward their backward graphs in reverse; each a
    ``ptx.launch`` span (``utils.span``)."""

    @staticmethod
    def forward(ctx, scan, pixel_ids, sample_ids, copies, *grads):
        ctx.scan = scan
        ctx.call = (pixel_ids, sample_ids, copies, grads)
        ctx.versions = _versions(ctx.call)
        with utils.span("ptx.launch"):
            ctx.launch, ctx.steps = scan._forward(*ctx.call)
        ctx.gen = scan._gen
        out = ctx.steps[-1].out
        alpha = out.alpha.detach().clone()
        ctx.mark_non_differentiable(alpha)
        return out.radiance.detach().clone(), alpha

    @staticmethod
    def backward(ctx, g_radiance, _g_alpha):
        with utils.span("ptx.launch"):
            grads = ctx.scan._backward(ctx, g_radiance)
        return (None, None, None, None, *grads)


class DeviceScan(GraphRunner):
    """The differentiable integrator ``(fs, pixel_ids, sample_ids) ->
    (radiance [R, 3], alpha [R])`` of one scene on the device scan (module
    docstring), over the plain bounce step on ``closest`` / ``any_hit``.
    ``grad_fields``: the scene fields it differentiates (a call's tensors
    of them are copied in; a field outside them that carries a gradient
    raises); ``copy_fields``: fields copied in per call without a gradient
    (a geometry set's repacked tiles).  Read by ``chip_smoke.py`` as an
    ``integrator.graphs.GraphRunner``, and its :meth:`schedule` (the last
    call's steps against the host scan's).  A tp rank's hooks, as
    ``wavefront.make_integrator`` takes them: ``live_sync`` maps this
    rank's live count, a tensor, to the world's largest; ``tex_shard``
    (``textures.TexShard``) sums a scene-sharded texel pack over the row."""

    def __init__(self, static: SceneStatic, cfg: RenderConfig, closest,
                 any_hit, grad_fields: Sequence[str],
                 copy_fields: Sequence[str] = (), live_sync=None,
                 tex_shard=None):
        super().__init__()
        self.static, self.cfg = static, cfg
        self.step = make_step(static, cfg, closest, any_hit, tex_shard)
        self.live_sync = live_sync
        self.max_iters = max_iterations(static, cfg)
        self.grad_fields = tuple(grad_fields)
        self.copy_fields = tuple(copy_fields)
        self._bound = None  # (pointer, shape, dtype) of the other fields
        self._fs = None  # the scene the steps read: those fields, the buffers
        self._bufs = {}
        self._used = None  # grad fields a step differentiates (warm-up)
        self._acc = {}  # their running sums during a backward
        self._launches = {}
        self._gen = 0
        self._last = None

    def __call__(self, fs: FlatScene, pixel_ids, sample_ids):
        self._bind(fs)
        return _Scan.apply(self, pixel_ids, sample_ids,
                           [getattr(fs, f) for f in self.copy_fields],
                           *(getattr(fs, f) for f in self.grad_fields))

    def _bind(self, fs: FlatScene):
        """Take ``fs`` as the scan's scene on the first call: its per-call
        fields get buffers, the rest is read in place.  Raise on a later
        call whose other fields are other tensors (the graphs hold their
        pointers), or whose per-call fields change shape."""
        own = self.grad_fields + self.copy_fields
        stray = [f for f, x in zip(fs._fields, fs)
                 if x.requires_grad and f not in self.grad_fields]
        if stray:
            raise ValueError(f"{stray} carry a gradient, but this scan "
                             f"differentiates only {list(self.grad_fields)}")
        key = tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                    for f, x in zip(fs._fields, fs) if f not in own)
        if self._bound is None:
            self._bufs = {f: getattr(fs, f).detach().clone() for f in own}
            for f in self.grad_fields:
                self._bufs[f].requires_grad_(True)
            self._fs = fs._replace(**self._bufs)
            self._bound = key
            return
        if key != self._bound:
            raise ValueError(
                "this integrator serves another scene's tensors (its CUDA "
                "graphs read them in place): make one integrator per scene")
        for f in own:
            x, buf = getattr(fs, f), self._bufs[f]
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"{f}: {tuple(x.shape)} {x.dtype}, where the "
                                 f"scan holds {tuple(buf.shape)} {buf.dtype}")

    # ----------------------------------------------------------------------
    # Forward
    # ----------------------------------------------------------------------

    def _forward(self, pixel_ids, sample_ids, copies, grads):
        with torch.no_grad():
            launch = self._load(pixel_ids, sample_ids, copies, grads)
        if not launch.warm:
            self._warm_up(launch)
        self._gen += 1
        return launch, self._loop(launch)

    def _load(self, pixel_ids, sample_ids, copies, grads) -> _Launch:
        """The per-call tensors into the buffers, the ids into their
        launch's initial state, then the rest of it (camera rays, fresh
        lanes) from them: on a CUDA device the replay of the launch
        shape's load graph.  Returns the launch."""
        for f, x in zip(self.copy_fields + self.grad_fields, (*copies, *grads)):
            self._bufs[f].copy_(x)
        r = pixel_ids.shape[0]
        launch = self._launches.get(r)
        if launch is None:
            launch = self._launches[r] = _Launch(r, pixel_ids.device,
                                                 self.max_iters)
        launch.out.pixel_ids.copy_(pixel_ids)
        launch.out.sample_ids.copy_(sample_ids)

        def load():
            load_initial_state(self._fs, self.cfg, launch.out)

        self._run(launch.graphs, ("load",), load, launch.cuda, warm=load)
        return launch

    def _warm_up(self, launch: _Launch):
        """One step, forward and backward, eagerly on a copy of the
        launch's initial state, before the shape's first capture: what a
        kernel, a constant or a communicator sets up on first use happens
        outside capture.  A tp rank's exchanges run here eagerly; every
        rank warms up at the same point, since each makes the same launch
        shapes in the same order.  The first warm-up also finds the grad
        fields the step differentiates; the others get no running sum and
        no gradient."""
        with torch.enable_grad():
            ins = RayState(*(x.detach().clone().requires_grad_(
                x.is_floating_point()) for x in launch.out))
            out = self.step(self._fs, 0, ins)
            outs = [x for x in out if x.requires_grad]
            leaves = [self._bufs[f] for f in self.grad_fields]
            wrt = [x for x in ins if x.requires_grad] + leaves
            grads = (torch.autograd.grad(
                outs, wrt, [torch.ones_like(x) for x in outs],
                allow_unused=True) if outs else [None] * len(wrt))
        if self._used is None:
            used = grads[len(wrt) - len(leaves):]
            self._used = tuple(f for f, g in zip(self.grad_fields, used)
                               if g is not None)
            self._acc = {f: torch.zeros_like(self._bufs[f]) for f in self._used}
        launch.warm = True

    def _loop(self, launch: _Launch) -> List[_Step]:
        counts = [launch.out.orig.shape[0]]  # c_0: every lane starts alive
        steps = []
        for it in range(self.max_iters):
            if it > 1:
                counts.append(read_count(launch, it - 1))
            if it > 0 and counts[it - 1] == 0:
                break
            step = self._step(launch, it)
            self._run_forward(step)
            live = step.out.alive.sum()
            if self.live_sync is not None:
                live = self.live_sync(live)
            launch.counts[it + 1].copy_(live, non_blocking=True)
            if launch.cuda:
                launch.events[it + 1].record()
            steps.append(step)
        self._last = (launch, counts, len(steps))
        return steps

    def _step(self, launch: _Launch, it: int) -> _Step:
        if it == len(launch.steps):
            launch.steps.append(_Step(it, launch.steps[-1] if it else launch,
                                      launch.cuda))
        return launch.steps[it]

    def _forward_body(self, step: _Step):
        """The step under autograd on its predecessor's outputs: ``(ins,
        out, seeds)``.  The inputs are detached; those that carry a gradient
        are leaves.  The seeds, views of the parameters made after the step,
        take the running sums as their cotangents."""
        prev = step.prev
        with torch.enable_grad():
            ins = RayState(*(x.detach().requires_grad_() if f in prev.fields
                             else x.detach()
                             for f, x in zip(RayState._fields, prev.out)))
            out = self.step(self._fs, step.it, ins)
            seeds = [self._bufs[f].view_as(self._bufs[f]) for f in self._used]
        return ins, out, seeds

    @staticmethod
    def _settle(step: _Step, ins, out, seeds):
        """Keep a run's autograd graph on its step; on the first run, the
        step's gradient-carrying outputs and their cotangent buffers."""
        fields = tuple(f for f, x in zip(RayState._fields, out)
                       if x.requires_grad)
        if step.fields is None:
            step.fields = fields
            step.gout = {f: torch.zeros_like(getattr(out, f)) for f in fields}
        elif fields != step.fields:
            raise RuntimeError(f"step {step.it}: outputs {fields} carry a "
                               f"gradient, {step.fields} did before")
        step.ins, step.out, step.seeds = ins, out, seeds

    def _run_forward(self, step: _Step):
        """The step's forward: eagerly under autograd on the CPU; on a CUDA
        device its program, captured on first use (the capture's run is the
        step's first run), replayed after that."""
        if not step.cuda:
            self._settle(step, *self._forward_body(step))
        elif step.forward is None:
            self._capture(step)
        else:
            self._run_program(step.forward)

    # ----------------------------------------------------------------------
    # Backward
    # ----------------------------------------------------------------------

    def _backward(self, ctx, g_radiance) -> list:
        if not self._used:
            return [None] * len(self.grad_fields)
        if ctx.gen != self._gen:
            self._recompute(ctx)
        last = ctx.steps[-1]
        with torch.no_grad():
            for f, g in last.gout.items():
                if f == "radiance" and g_radiance is not None:
                    g.copy_(g_radiance)
                else:
                    g.zero_()
            for acc in self._acc.values():
                acc.zero_()
        for step in reversed(ctx.steps):
            self._run_backward(step)
        return [self._acc[f].clone()
                if f in self._acc and ctx.needs_input_grad[4 + i] else None
                for i, f in enumerate(self.grad_fields)]

    def _recompute(self, ctx):
        """``ctx``'s forward again, its steps from the inputs it kept: a
        later forward overwrote the residuals its backward reads.  A tp
        rank's exchanges run again with them; every rank reruns at the
        same point (the same loss calls in the same order)."""
        if _versions(ctx.call) != ctx.versions:
            raise RuntimeError("a tensor the scan read was modified in place "
                               "before its backward")
        with torch.no_grad():
            self._load(*ctx.call)
        for step in ctx.steps:
            self._run_forward(step)
        self._gen += 1
        ctx.gen = self._gen

    def _backward_body(self, step: _Step):
        """``autograd.grad`` of the step's last run: the cotangents of its
        gradient-carrying inputs into its predecessor's ``gout``, the
        parameters' running sums into ``_acc``."""
        prev = step.prev
        outs = [getattr(step.out, f) for f in step.fields] + step.seeds
        couts = ([step.gout[f] for f in step.fields]
                 + [self._acc[f] for f in self._used])
        wrt = ([getattr(step.ins, f) for f in prev.fields]
               + [self._bufs[f] for f in self._used])
        grads = torch.autograd.grad(outs, wrt, couts, retain_graph=True,
                                    allow_unused=True)
        with torch.no_grad():
            for f, g in zip(prev.fields, grads):
                if g is None:
                    prev.gout[f].zero_()
                else:
                    prev.gout[f].copy_(g)
            for f, g in zip(self._used, grads[len(prev.fields):]):
                self._acc[f].copy_(g)

    def _run_backward(self, step: _Step):
        if not step.cuda:
            self._backward_body(step)
        else:
            self._replay(*step.backward)

    # ----------------------------------------------------------------------
    # Graphs
    # ----------------------------------------------------------------------

    def _capture(self, step: _Step):
        """The step's forward program, cut at its exchanges and run once
        meanwhile (its run kept on the step), then its backward graph, which
        may hold no exchange.  Raises if a capture fails."""
        step.forward, run = self._program(lambda: self._forward_body(step))
        self._settle(step, *run)
        if self._used:
            graph, tally, _ = self._graph(lambda: self._backward_body(step))
            step.backward = (graph, tally)

    def schedule(self) -> dict:
        """The last call's schedule from its live counts (waits for the
        last of them; call it before the next call reuses them): ``steps``
        run, ``host_steps`` that the host scan runs on the same counts, and
        ``dead_steps``, the all-dead steps the lag added."""
        launch, counts, n = self._last
        counts = list(counts)
        for i in range(len(counts), n + 1):
            counts.append(read_count(launch, i))
        host = 0
        for c in counts[:self.max_iters]:
            if c == 0:
                break
            host += 1
        return dict(counts=counts, steps=n, host_steps=host,
                    dead_steps=n - host)
