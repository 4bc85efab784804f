"""Multi-rank rendering on ``torch.distributed`` (port of
``ptx/parallel/dist.py``).

``ptx`` runs one SPMD program under ``shard_map``; the port runs one process
per rank (``ptx_torch.parallel.mesh``), each with its own wavefront loop on
its own device, and the exchanges are ``torch.distributed`` collectives on
the mesh's groups:

* **Ray parallelism** (``dp``): each rank traces its own slice of the
  pixels; no per-ray collective.
* **Scene parallelism** (``tp``): each rank of a ``dp`` row holds one
  triangle shard.  In "reduce" mode the row's ranks hold the same rays and
  resolve each closest hit by one min of a key (the distance's bits, then
  the tp index: the lowest index among the nearest shards) and one sum of
  the winner's masked payload; an occlusion query is a max.  In "ring"
  mode each rank owns a block of rays and the blocks travel around the
  row's ring, carrying their running best hit (the ring-attention
  schedule: 1/tp the rays per rank).

Inverse rendering over the ranks (:func:`make_distributed_train_step`):
each rank takes the value and gradient of its pixel slice through the same
exchanges, and one all-reduce gives every rank the frame's loss and
gradients, so each rank's replica of the parameters and of the Adam state
stays equal to every other's.

Every rank must issue the same collectives in the same order.  The
wrappers below always issue theirs, whatever their rank's rays; the loop's
live counts are the largest over the world (``live_sync``), so every rank
steps the same chunks; and every choice of path (intersector, compaction,
shader, launch size) is taken from the same per-shard ``SceneStatic`` and
the same counts on every rank.

A tp rank renders on the device pass, as a dp rank does
(``integrator.graphs.DevicePass``): each collective of its bounce step is
an exchange point (``integrator.graphs.exchange``) that cuts the step's
CUDA graph into segments, and runs between their replays, on the stream
(NCCL) or staged through the host (gloo); the live counts are reduced on
the device and read one iteration late.  Its value and gradient runs on
the device scan (``diff.graphs.DeviceScan``) the same way: each bounce
step's forward is cut at the same exchange points, and its backward,
through which no exchange carries a gradient, is one graph.

The collective helpers (:func:`all_reduce`, :func:`all_gather`,
:func:`ring_shift`) are the one place that talks to ``torch.distributed``.
Each reduces in place into a tensor of its own, made where the call is
made (inside a capture: in the graph pool, so a replay finds it at the
same address).  Under gloo with CUDA tensors (ranks sharing one card) they
copy each tensor to the host and back: gloo's CUDA support covers only
some collectives (not all-gather, not point-to-point), so every call takes
the one staged path.  They also keep :data:`STATS` (calls and bytes handed
over) at every run, replays included, and mark each run as a
``ptx.exchange`` span (``utils.span``), whose device work a profiled run
times without a synchronize.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ptx_torch import geometry, utils
from ptx_torch.config import RenderConfig
from ptx_torch.kernels.intersect import Hit
from ptx_torch.parallel import mesh as pmesh
from ptx_torch.scene.flatten import FlatScene, SceneStatic


# --------------------------------------------------------------------------
# Collective helpers
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CommStats:
    """What this rank handed to collectives since :meth:`reset`: calls and
    payload bytes (the tensor of an all-reduce or a send, this rank's slice
    of an all-gather)."""

    calls: int = 0
    bytes: int = 0

    def reset(self):
        self.calls, self.bytes = 0, 0


STATS = CommStats()


def _collective(mesh, src, dst, run):
    """``run(src, dst)``, a collective that reads ``src`` and writes
    ``dst`` in place, as an exchange point (``graphs.exchange``: eagerly,
    or between two graphs of a device program).  Under gloo with CUDA
    tensors it runs on host copies and ``dst`` is copied back.  Each run
    is a ``ptx.exchange`` span and adds to STATS (``src``'s bytes)."""
    from ptx_torch.integrator.graphs import exchange

    def op(src, dst):
        with utils.span("ptx.exchange"):
            if mesh.staging:
                hs = src.cpu()
                hd = hs if dst is src else torch.empty(dst.shape,
                                                       dtype=dst.dtype)
                run(hs, hd)
                dst.copy_(hd)
            else:
                run(src, dst)
        STATS.calls += 1
        STATS.bytes += src.numel() * src.element_size()

    exchange(op, src, dst)
    return dst


def all_reduce(mesh, x, op: str, group):
    """``op`` ("sum", "min", "max") of ``x`` over ``group`` (None: the
    world), in place on a detached copy of ``x`` (made where the call runs:
    inside a capture, in the graph pool; no exchange carries a gradient, so
    no backward, not even the device scan's warm-up with every state field
    a leaf, runs through a collective); a bool is reduced as int32 and
    comes back int32."""
    import torch.distributed as dist

    y = (x.to(torch.int32) if x.dtype == torch.bool
         else x.detach().clone()).contiguous()
    red = getattr(dist.ReduceOp, op.upper())

    def run(y, _):
        dist.all_reduce(y, op=red, group=group)

    return _collective(mesh, y, y, run)


def all_gather(mesh, x, group):
    """Every rank's ``x`` over ``group`` (None: the world), concatenated
    along axis 0 in group-rank order.  A bool travels as uint8."""
    import torch.distributed as dist

    is_bool = x.dtype == torch.bool
    x = (x.to(torch.uint8) if is_bool else x).contiguous()
    n = dist.get_world_size(group)

    def run(y, out):
        dist.all_gather(list(out.chunk(n)), y, group=group)

    out = _collective(mesh, x, x.new_empty((n * x.shape[0], *x.shape[1:])),
                      run)
    return out.to(torch.bool) if is_bool else out


def ring_shift(mesh, x):
    """``ptx``'s ``ppermute`` to the right around the scene axis: send ``x``
    to tp index ``i + 1`` and receive from ``i - 1`` of this rank's row,
    into a new tensor."""
    import torch.distributed as dist

    group, tp = mesh.tp_group, mesh.plan.tp
    right = dist.get_global_rank(group, (mesh.tp_index + 1) % tp)
    left = dist.get_global_rank(group, (mesh.tp_index - 1) % tp)

    def run(y, buf):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, right, group),
            dist.P2POp(dist.irecv, buf, left, group),
        ])
        for r in reqs:
            r.wait()

    x = x.contiguous()
    return _collective(mesh, x, torch.empty_like(x), run)


# --------------------------------------------------------------------------
# The exchanges
# --------------------------------------------------------------------------

def _payload(h: Hit):
    """The winner's payload as one float32 row: position 0-2, normal 3-5,
    tangent 6-8, uv 9-10, mat_id 11 (a float32 holds every material index
    below 2^24 exactly)."""
    return torch.cat([h.position, h.normal, h.tangent, h.uv,
                      h.mat_id.to(torch.float32)[..., None]], -1)


def reduce_closest(h: Hit, ax, reduce) -> Hit:
    """The closest hit over a row of shards from this shard's ``h`` and its
    tp index ``ax``, in two calls of ``reduce(x, op)`` (an all-reduce over
    the row): ``ptx``'s ``sharded_closest`` -- the least ``t``, the lowest
    tp index among the shards that reach it, the payload of that one shard
    and the OR of ``hit`` -- bit for bit.

    1. One int64 min of ``(bits(t) << 32) | ax``: a hit's ``t`` is finite
       and ``>= 0`` (a miss: ``geometry.INF``), so its bits order as the
       float does, and the least key holds the least ``t`` and the lowest
       tp index that reaches it.  The Moller-Trumbore test every backend
       ends with admits ``t = -0.0``; it is keyed as ``+0.0``, the tie
       ``t == t_min`` makes of it, and comes back as ``+0.0``.  No ``t`` is
       NaN (a hit needs a finite ``t``).
    2. One float32 sum of ``[payload masked to the winner | hit]``: one
       non-zero payload term (exact), and a count of the shards that hit,
       above 0 where any did.

    The shard axis may also be a leading axis of ``h`` and ``ax`` (the
    tests simulate a row so)."""
    t = torch.where(h.hit, h.t, geometry.INF)
    t = torch.where(t == 0.0, 0.0, t)
    key = reduce((t.view(torch.int32).to(torch.int64) << 32) | ax, "min")
    win = (key & 0xFFFFFFFF) == ax
    pay = reduce(torch.cat([torch.where(win[..., None], _payload(h), 0.0),
                            h.hit.to(torch.float32)[..., None]], -1), "sum")
    return Hit(hit=pay[..., 12] > 0,
               t=(key >> 32).to(torch.int32).view(torch.float32),
               position=pay[..., 0:3], normal=pay[..., 3:6],
               tangent=pay[..., 6:9], uv=pay[..., 9:11],
               mat_id=pay[..., 11].to(torch.int32))


def sharded_closest(base_closest, mesh):
    """Wrap a rank's closest-hit backend with the min reduce over its row
    (``ptx``'s ``sharded_closest``, in the two collectives of
    :func:`reduce_closest`).  Every rank of the row ends with the same
    Hit."""

    def reduce(x, op):
        return all_reduce(mesh, x, op, mesh.tp_group)

    def closest(fs: FlatScene, orig, dirn) -> Hit:
        return reduce_closest(base_closest(fs, orig, dirn), mesh.tp_index,
                              reduce)

    return closest


def sharded_any_hit(base_any, mesh):
    """OR of the rank's occlusion over its row (a max of int32)."""

    def any_hit(fs: FlatScene, orig, dirn):
        return all_reduce(mesh, base_any(fs, orig, dirn), "max",
                          mesh.tp_group) > 0

    return any_hit


def _pack_ring(orig, dirn, h: Hit):
    """One float32 row per ray for a ring hop: orig 0-2, dirn 3-5, t 6,
    hit 7, payload 8-19 (mat_id carried by its bits)."""
    bits = h.mat_id.to(torch.int32).view(torch.float32)[:, None]
    return torch.cat([orig, dirn, h.t[:, None],
                      h.hit.to(torch.float32)[:, None], h.position, h.normal,
                      h.tangent, h.uv, bits], 1)


def _unpack_ring(x):
    h = Hit(hit=x[:, 7] > 0, t=x[:, 6].contiguous(), position=x[:, 8:11],
            normal=x[:, 11:14], tangent=x[:, 14:17], uv=x[:, 17:19],
            mat_id=x[:, 19].contiguous().view(torch.int32))
    return x[:, 0:3].contiguous(), x[:, 3:6].contiguous(), h


def ring_closest(base_closest, mesh):
    """Ring-scheduled closest hit (``ptx``'s ``ring_closest``): this rank's
    ray block is tested against its own shard, then travels to the right
    ``tp - 1`` times, each rank keeping the nearer hit (the earlier one on a
    tie), and one last hop brings each block home.  One message per hop:
    the rays and their running best hit, packed in one row."""
    n = mesh.plan.tp

    def closest(fs: FlatScene, orig, dirn) -> Hit:
        def local(o, d):
            h = base_closest(fs, o, d)
            return h._replace(t=torch.where(h.hit, h.t, geometry.INF))

        def merge(best: Hit, new: Hit) -> Hit:
            closer = new.t < best.t

            def sel(a, b):
                mask = closer if a.ndim == 1 else closer[:, None]
                return torch.where(mask, b, a)

            return Hit(hit=best.hit | new.hit, t=torch.minimum(best.t, new.t),
                       position=sel(best.position, new.position),
                       normal=sel(best.normal, new.normal),
                       tangent=sel(best.tangent, new.tangent),
                       uv=sel(best.uv, new.uv),
                       mat_id=sel(best.mat_id, new.mat_id))

        carry = _pack_ring(orig, dirn, local(orig, dirn))
        for _ in range(n - 1):
            o, d, best = _unpack_ring(ring_shift(mesh, carry))
            carry = _pack_ring(o, d, merge(best, local(o, d)))
        return _unpack_ring(ring_shift(mesh, carry))[2]

    return closest


def ring_any_hit(base_any, mesh):
    """Ring-scheduled occlusion: the OR accumulates around the ring."""
    n = mesh.plan.tp

    def any_hit(fs: FlatScene, orig, dirn):
        def pack(o, d, hit):
            return torch.cat([o, d, hit.to(torch.float32)[:, None]], 1)

        carry = pack(orig, dirn, base_any(fs, orig, dirn))
        for _ in range(n - 1):
            x = ring_shift(mesh, carry)
            o, d = x[:, 0:3].contiguous(), x[:, 3:6].contiguous()
            carry = pack(o, d, (x[:, 6] > 0) | base_any(fs, o, d))
        return ring_shift(mesh, carry)[:, 6] > 0

    return any_hit


# --------------------------------------------------------------------------
# The sample pass
# --------------------------------------------------------------------------


def ray_ways(plan: pmesh.Plan, comm: str) -> int:
    """How many ways the pixels are split: dp, and tp too in ring mode."""
    return plan.dp * (plan.tp if comm == "ring" else 1)


def pixel_range(mesh, comm: str, n_pixels: int) -> Tuple[int, int]:
    """This rank's pixels ``(start, stop)``: one of ``ray_ways`` equal
    contiguous slices, numbered by the dp index (and in ring mode the tp
    index within it, i.e. the global rank)."""
    plan = mesh.plan
    ways = ray_ways(plan, comm)
    if n_pixels % ways:
        raise ValueError(
            f"pixel count {n_pixels} must divide the ray sharding ({ways})"
        )
    idx = (mesh.dp_index * plan.tp + mesh.tp_index if comm == "ring"
           else mesh.dp_index)
    n = n_pixels // ways
    return idx * n, (idx + 1) * n


def launch_pixels(plan: pmesh.Plan, comm: str, n_pixels: int) -> int:
    """Pixels of one rank's launch when one sample is traced per launch:
    the rank's whole slice, or, when that is above ``MAX_RAYS_PER_LAUNCH``,
    ``ptx``'s distributed auto-chunk: the largest multiple of 128 * ways
    that divides the frame and keeps one rank's part under the cap."""
    from ptx_torch import render as R

    ways = ray_ways(plan, comm)
    if n_pixels // ways > R.MAX_RAYS_PER_LAUNCH:
        cap = R.MAX_RAYS_PER_LAUNCH * ways
        align = 128 * ways
        for m in range(cap // align, 0, -1):
            if n_pixels % (align * m) == 0:
                return align * m // ways
    return n_pixels // ways


def _check_layout(static: SceneStatic, plan: pmesh.Plan, comm: str):
    """Raise ``ValueError`` for a layout the exchanges cannot serve."""
    if plan.scene_sharded and static.n_bvh_nodes > 0 and not static.shard_local:
        raise ValueError(
            "scene-sharded plan with a globally-built BVH: prepare the "
            "scene with prepare_scene()/build_shard_scene() so every shard "
            "holds a self-contained BVH over its own triangles"
        )
    if static.tex_shard_len > 0 and comm == "ring":
        raise ValueError(
            "sharded textures (tex_shard_len > 0) require comm='reduce' "
            "(rays replicated over tp); ring mode shards rays over tp"
        )
    if comm not in ("reduce", "ring"):
        raise ValueError(f"unknown comm {comm!r}")


def _exchanges(static: SceneStatic, mesh, plan: pmesh.Plan, comm: str,
               base_closest, base_any):
    """This rank's backend with the scene axis's exchanges wrapped around
    it, and the loop's hooks: ``(closest, any_hit, live_sync, tex_shard)``
    for ``make_integrator`` / ``make_pallas_integrator`` (both hooks None
    unless the scene is sharded)."""
    from ptx_torch.scene.textures import TexShard

    if not plan.scene_sharded:
        return base_closest, base_any, None, None
    if comm == "ring":
        closest = ring_closest(base_closest, mesh)
        any_hit = ring_any_hit(base_any, mesh)
    else:
        closest = sharded_closest(base_closest, mesh)
        any_hit = sharded_any_hit(base_any, mesh)

    # Trip counts agree over the whole world (strictly only a row must
    # agree; one int32 max per bounce costs little).  On the device loop
    # the max stays on the device (NCCL) until the loop reads it one
    # iteration late.
    def live_sync(n):
        return all_reduce(mesh, n.reshape(1).to(torch.int32), "max", None)[0]

    tex_shard = None
    if static.tex_shard_len > 0:
        tex_shard = TexShard(
            mesh.tp_index, lambda x: all_reduce(mesh, x, "sum", mesh.tp_group))
    return closest, any_hit, live_sync, tex_shard


def make_distributed_sample_fn(
    static: SceneStatic,
    cfg: RenderConfig,
    mesh,
    plan: pmesh.Plan,
    comm: str = "reduce",
    k: int = 1,
    device="cuda",
):
    """This rank's sample pass over its pixels (:func:`pixel_range`), with
    the scene's exchanges wrapped around its backend.

    With ``k == 1``: ``(fs, sample_id) -> (radiance [P_r, 3], alpha
    [P_r])``.  With ``k > 1``: ``(fs, sample0) -> (radiance [k, P_r, 3],
    alpha [k, P_r])``, samples ``sample0 .. sample0 + k - 1`` in one launch.
    The launch cap applies to one rank's wavefront: with ``k == 1`` a slice
    is traced in launches of :func:`launch_pixels`.

    On the fused integrator every rank gets the device pass over its slice
    (``integrator.graphs.DevicePass``: each launch a scalar copy and
    prologue, loop and epilogue graphs, the fold into its carry in place);
    a tp rank's chunk steps are programs of graph segments with its
    exchanges between them, in "reduce" and "ring" mode and with a sharded
    texel pack.  The plain shader keeps the host loop with eager edges.

    The port splits whole pixels over the ranks (``ptx`` splits the k * P
    lanes), so each rank's carry holds whole pixels; the RNG is keyed by
    absolute (pixel, sample) ids, so which rank traces a lane never changes
    its sample."""
    from ptx_torch import render as R
    from ptx_torch.integrator.graphs import DeviceLoop, DevicePass, launch_ids
    from ptx_torch.kernels import sorting

    _check_layout(static, plan, comm)
    # The compacted loop sorts the wavefront itself: no per-call sorting
    # wrapper then (as make_integrator_for).
    chunk_active = sorting.resolve_compact(static, cfg)
    closest, any_hit, live_sync, tex_shard = _exchanges(
        static, mesh, plan, comm,
        *R.get_backend(static, cfg, device,
                       sort=False if chunk_active else None))

    n_pixels = cfg.width * cfg.height
    start, stop = pixel_range(mesh, comm, n_pixels)
    n_local = stop - start
    rays_per_chip = n_local * k
    if R.resolve_shader(cfg) == "pallas" and rays_per_chip % 128 == 0:
        from ptx_torch.kernels.shade_cuda import make_pallas_integrator

        integrator = make_pallas_integrator(static, cfg, closest, any_hit,
                                            live_sync=live_sync,
                                            tex_shard=tex_shard)
    else:
        from ptx_torch.integrator.wavefront import make_integrator

        integrator = make_integrator(static, cfg, closest, any_hit,
                                     live_sync=live_sync, tex_shard=tex_shard)

    chunk = launch_pixels(plan, comm, n_pixels) if k == 1 else n_local
    if isinstance(integrator, DeviceLoop):
        return DevicePass(integrator, cfg, device, start, n_local, chunk, k)

    if k == 1:
        def sample_pass(fs: FlatScene, sample_id: int):
            parts = [integrator(fs, *launch_ids(s, chunk, 1, sample_id, device))
                     for s in range(start, stop, chunk)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]))

        return sample_pass

    def batch_pass(fs: FlatScene, sample0: int):
        radiance, alpha = integrator(
            fs, *launch_ids(start, n_local, k, sample0, device))
        return radiance.reshape(k, n_local, 3), alpha.reshape(k, n_local)

    return batch_pass


# --------------------------------------------------------------------------
# The training step
# --------------------------------------------------------------------------

def diff_integrator(static: SceneStatic, cfg: RenderConfig, mesh,
                    plan: pmesh.Plan, comm: str, param_fields, device="cuda"):
    """This rank's general differentiable scan
    (``diff.inverse.make_diff_integrator``) on ``diff.inverse.diff_backend``
    with the exchanges of :func:`make_distributed_sample_fn` and
    ``live_sync`` around it: on every CUDA rank (dp, tp reduce and ring,
    dp x tp, a sharded texel pack) the device scan, whose forward steps a
    tp rank's exchanges cut into graph segments; on the CPU the host
    scan."""
    from ptx_torch import render as R
    from ptx_torch.diff import inverse

    _check_layout(static, plan, comm)
    closest, any_hit = inverse.diff_backend(
        static, cfg, *R.get_backend(static, cfg, device,
                                    param_fields=param_fields),
        param_fields, device)
    closest, any_hit, live_sync, tex_shard = _exchanges(
        static, mesh, plan, comm, closest, any_hit)
    return inverse.make_diff_integrator(static, cfg, closest, any_hit,
                                        param_fields, device,
                                        live_sync=live_sync,
                                        tex_shard=tex_shard)


def make_distributed_value_and_grad_fn(
    static: SceneStatic,
    cfg: RenderConfig,
    mesh,
    plan: pmesh.Plan,
    target: torch.Tensor,
    n_samples: int,
    comm: str = "reduce",
    param_fields=("mat_albedo", "mat_emissive"),
    max_chunk_rays: Optional[int] = None,
    device="cuda",
):
    """``vg(params, fs_local) -> (loss, grads)``, the objective of
    ``diff.inverse.make_batch_value_and_grad_fn`` over the whole frame
    (``target`` [W * H, 3], samples ``0 .. n_samples - 1``), the same on
    every rank.

    Each rank runs the one-device body on its slice
    (:func:`pixel_range`, cut into chunks and sample groups as one device
    cuts the frame) through :func:`diff_integrator` (the device scan on a
    card), whose ``live_sync`` makes every rank step the scan, and each
    sample group's two forwards and its backward, in the same order.  The slices' losses and
    gradients are summed over the world in one :func:`all_reduce`; in
    reduce mode the tp ranks of a row trace the same pixels, so the sum is
    divided by tp (``ptx``'s shard_map transpose does the same to a
    tp-replicated output).  Summing over the world rather than over the dp
    group gives every rank the same bits even where a row's ranks differ
    in the order of the backward's scatter-adds.

    Raises ``ValueError``, before any collective, for a geometry field
    under tp > 1 or ``tex_texels`` with a sharded texel pack: their
    gradients would cross an exchange that carries none."""
    from ptx_torch.diff import inverse

    # No scene-axis exchange carries a gradient: the masked-sum payload of
    # a closest hit and the sharded-texel gather are all-reduces of copies.
    if inverse.moves_geometry(param_fields) and plan.tp > 1:
        geom = [f for f in param_fields if f in inverse._GEOM_ATTR_COLS]
        raise ValueError(
            f"geometry parameters {geom} under tp={plan.tp}: the closest "
            "hit's masked-sum payload is an all-reduce that carries no "
            "gradient, so the vertex gradient would be 0; use tp=1")
    if "tex_texels" in param_fields and static.tex_shard_len > 0:
        raise ValueError(
            "tex_texels with a sharded texel pack (tex_shard_len > 0): the "
            "texel gather's sum over tp carries no gradient; shard the "
            "scene with replicated textures")
    start, stop = pixel_range(mesh, comm, cfg.width * cfg.height)
    local = inverse.slice_value_and_grad_fn(
        diff_integrator(static, cfg, mesh, plan, comm, param_fields, device),
        cfg, target, n_samples, start, stop - start, param_fields,
        max_chunk_rays)
    copies = plan.tp if comm == "reduce" else 1

    def value_and_grad(params, fs: FlatScene):
        loss, grads = local(params, fs)
        flat = all_reduce(mesh, torch.cat(
            [loss.reshape(1), *(g.reshape(-1) for g in grads.values())]),
            "sum", None) / copies
        parts = flat[1:].split([g.numel() for g in grads.values()])
        return flat[0], {k: p.reshape(grads[k].shape)
                         for k, p in zip(grads, parts)}

    return value_and_grad


def make_distributed_train_step(
    static: SceneStatic,
    cfg: RenderConfig,
    mesh,
    plan: pmesh.Plan,
    target: torch.Tensor,
    n_samples: int,
    comm: str = "reduce",
    param_fields=("mat_albedo", "mat_emissive"),
    max_chunk_rays: Optional[int] = None,
    device="cuda",
    lr: float = 1e-2,
):
    """One inverse-rendering step on every rank (the counterpart of the
    shard_map training step ``ptx`` runs on a dp x tp mesh):
    ``step(params, opt, fs_local) -> loss`` runs one value and gradient of
    :func:`make_distributed_value_and_grad_fn` (on a card every rank's
    scan is the device scan, a tp rank's exchanges between its graph
    segments) and one Adam update of ``params`` in place.  Each rank keeps a replica of the parameters and
    of the optimizer state; every rank gets the same gradients, so the
    replicas stay bit-equal.  ``step.init(init_params) -> (params, opt)``
    makes the leaves and ``diff.inverse.adam`` over them at ``lr``."""
    from ptx_torch.diff import inverse

    vg = make_distributed_value_and_grad_fn(
        static, cfg, mesh, plan, target, n_samples, comm, param_fields,
        max_chunk_rays, device)

    def step(params, opt, fs: FlatScene):
        loss, grads = vg(params, fs)
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        return loss

    def init(init_params):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in init_params.items()}
        return params, inverse.adam(params, lr)

    step.init = init
    return step


def prepare_scene(fs: FlatScene, static: SceneStatic, cfg: RenderConfig,
                  plan: pmesh.Plan, mesh, device="cuda", param_fields=()):
    """Accel-build and place a scene for the plan; returns ``(fs_local,
    static_local)``, this rank's scene on ``device`` and the per-rank view.
    ``param_fields``: the differentiable set the scene is for
    (``render.resolve_intersector`` reads it); the intersector is resolved
    on the per-rank view.

    * scene-sharded: split into shard-local chunks with per-shard BVHs
      (``ptx_torch.parallel.shard_scene``); this rank keeps its shard and,
      for the tile traversal, packs its shard's tiles on the host
      (``tiles.attach_tiles``, once at setup, bit-equal to the device
      pack).  Textures are binned over tp when the plan says so.
    * replicated: ``ensure_accel`` on the whole scene, as one device
      renders it."""
    from ptx_torch import render as R
    from ptx_torch.scene.bridge import to_device, to_host

    if not plan.scene_sharded:
        return R.ensure_accel(fs, static, cfg, device=device,
                              param_fields=param_fields)
    from ptx_torch.parallel.shard_scene import (
        build_shard_scene, build_texture_shards,
    )

    fs, static = build_shard_scene(to_host(fs), static, plan, cfg,
                                   device=device)
    if plan.shard_textures:
        fs, static = build_texture_shards(fs, static, plan.tp)
    fs = pmesh.shard_scene(fs, mesh, True, shard_bvh=static.n_bvh_nodes > 0,
                           shard_tex=static.tex_shard_len > 0)
    if R.log_intersector(static, cfg, device, param_fields) == "pallas":
        from ptx_torch.kernels.tiles import attach_tiles

        fs = attach_tiles(fs)
    return to_device(fs, device), static


def render_distributed(
    fs: FlatScene,
    static: SceneStatic,
    cfg: RenderConfig,
    plan: Optional[pmesh.Plan] = None,
    mesh=None,
    progress=None,
    comm: str = "reduce",
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    metrics=None,
    preview_path: Optional[str] = None,
    device="cuda",
):
    """Multi-rank progressive render, the same contract as
    ``ptx_torch.render.render``: every rank returns the whole image.  Each
    rank loads the whole host scene (``fs``, numpy arrays) and keeps its
    shard.  Checkpoint and resume as there: only rank 0 writes, every rank
    resumes from the same file, and a checkpoint written by any layout
    resumes on any other, or on one device."""
    from ptx_torch import render as R
    from ptx_torch.parallel.multihost import replicator

    if plan is None:
        plan = pmesh.plan(static.n_tris_padded,
                          n_texels=int(np.asarray(fs.tex_texels).shape[0]),
                          device=device)
    if mesh is None:
        mesh = pmesh.make_mesh(plan, device)
    if plan.shard_textures and comm == "ring":
        raise ValueError(
            "plan shards textures but comm='ring' shards rays over tp; "
            "sharded-texel gathers need rays replicated over tp — use "
            "comm='reduce' (or force a plan with replicated textures)"
        )
    fs, static = prepare_scene(fs, static, cfg, plan, mesh, device)
    k = R.resolve_samples_per_launch(cfg, ways=ray_ways(plan, comm))
    fn = make_distributed_sample_fn(static, cfg, mesh, plan, comm, k=k,
                                    device=device)
    return R.progressive_render(
        fs, static, cfg,
        sample_fn=fn if k == 1 else None,
        batch_fn=fn if k > 1 else None,
        k=k, device=device,
        progress=progress,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        metrics=metrics,
        preview_path=preview_path,
        replicate=replicator(mesh, comm),
        pixels=pixel_range(mesh, comm, cfg.width * cfg.height),
    )
