"""The rank mesh and the sharding planner (port of ``ptx/parallel/mesh.py``).

``ptx`` runs one SPMD program over a ``jax.sharding.Mesh`` with axes
``("dp", "tp")``; the port runs one process per rank on
``torch.distributed``:

* ``dp`` (ray axis)   - pixels sharded across ranks, scene replicated, no
  per-ray collective;
* ``tp`` (scene axis) - triangles sharded across ranks; every rank of a
  ``dp`` row intersects the row's rays against its shard and the hits are
  min-reduced over the row (``ptx_torch.parallel.dist``).

Ranks are laid out row-major, ``rank = dp_index * tp + tp_index``, as
``ptx``'s ``make_mesh`` reshapes its device list.  :func:`make_mesh` gives
each rank its coordinates and two process groups: its ``dp`` row (the ranks
that share the scene axis, the group of every ``tp`` exchange) and its
``tp`` column (the ranks that share a scene shard, the group that gathers
the image in reduce mode).  Every rank creates every group, in the same
order, as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

from ptx_torch.accel.bvh import TRI_FIELDS

AXIS_RAYS = "dp"
AXIS_SCENE = "tp"

# Bytes per triangle across the FlatScene SoA arrays, as ``ptx`` counts them:
# 3x tri (a/e1/e2) + 3x normal + 3x tangent = 9 vec3 + 3 uv (vec2) = 33 f32
# + mat_id i32 + valid byte.  The port's traversal tiles and the packed
# ``tri_attrs`` rows are not counted, as in ``ptx`` (ROADMAP A7).
_BYTES_PER_TRI = 33 * 4 + 4 + 1

# ``ptx``'s per-chip memory when none is given and no card is asked for.
_DEFAULT_HBM = 16 * 2**30

# The BVH node fields: split along tp only for per-shard BVHs.
BVH_FIELDS = ("bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Execution plan: mesh shape and whether the scene is sharded."""

    dp: int
    tp: int
    scene_sharded: bool
    # Shard the texture pack along tp too (texel gathers then ride a sum
    # over the scene axis, ptx_torch.scene.textures.sample_texture).
    shard_textures: bool = False

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp


def scene_bytes(n_tris: int, n_texels: int = 0) -> int:
    return n_tris * _BYTES_PER_TRI + n_texels * 16


def plan(
    n_tris: int,
    n_devices: Optional[int] = None,
    n_texels: int = 0,
    hbm_bytes_per_chip: Optional[int] = None,
    scene_budget_fraction: float = 0.25,
    force_tp: Optional[int] = None,
    device="cuda",
) -> Plan:
    """Choose a mesh shape, as ``ptx``'s ``plan``: the scene is replicated
    while it fits in ``scene_budget_fraction`` of a rank's memory; otherwise
    the scene axis grows by powers of two until each shard fits.  Triangles
    always shard with tp; the texture pack is sharded only when it does not
    fit beside the triangle shard.

    ``n_devices`` defaults to the world size.  ``hbm_bytes_per_chip``
    defaults to the memory of ``device`` when it is a CUDA device, else to
    ``ptx``'s 16 GiB."""
    import torch
    import torch.distributed as dist

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if hbm_bytes_per_chip is None:
        dev = torch.device(device)
        hbm_bytes_per_chip = (
            torch.cuda.get_device_properties(dev).total_memory
            if dev.type == "cuda" else _DEFAULT_HBM
        )
    budget = hbm_bytes_per_chip * scene_budget_fraction
    if force_tp is not None:
        tp = force_tp
    else:
        tp = 1
        while (
            scene_bytes(n_tris // tp, 0) + n_texels * 16 > budget
            and tp < n_devices
        ):
            tp *= 2
    tp = min(tp, n_devices)
    needed = tp
    while n_devices % tp:
        tp += 1  # round up to the next divisor to keep the mesh rectangular
    if tp > needed and tp >= 2 * needed:
        logging.getLogger(__name__).warning(
            "plan(): scene axis rounded from tp=%d to the next divisor %d of "
            "%d devices; consider a device count divisible by %d",
            needed, tp, n_devices, needed,
        )
    shard_tex = tp > 1 and (
        scene_bytes(n_tris // tp, 0) + n_texels * 16 > budget
    )
    return Plan(
        dp=n_devices // tp, tp=tp, scene_sharded=tp > 1,
        shard_textures=shard_tex,
    )


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in the ``(dp, tp)`` mesh.  The groups are None in
    a single-process run (a world of 1, where no collective is issued)."""

    plan: Plan
    rank: int
    dp_index: int
    tp_index: int
    device: str = "cpu"  # where this rank's tensors live
    tp_group: object = None  # this rank's dp row: the scene axis
    dp_group: object = None  # this rank's tp column: the ray axis
    # gloo holding CUDA tensors: the collectives stage through the host.
    staging: bool = False

    @property
    def distributed(self) -> bool:
        return self.tp_group is not None


# The groups of each (dp, tp) layout of the current process group, made the
# first time the layout is asked for: a layout met again reuses its groups
# (under NCCL each group holds communicators and device memory).  Every rank
# asks for the same layouts in the same order, so every rank makes the same
# groups in the same order.  ``multihost.shutdown`` drops them before it
# destroys the process group (a gloo group that outlives it can abort the
# process at exit).
_GROUPS = {"world": None, "layouts": {}}


def _layout_groups(dp: int, tp: int):
    """(rows, cols): one group per dp row (its tp ranks) and one per tp
    column (its dp ranks), cached per process group."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["layouts"] = world, {}
    layouts = _GROUPS["layouts"]
    if (dp, tp) not in layouts:
        rows = [dist.new_group([d * tp + t for t in range(tp)])
                for d in range(dp)]
        cols = [dist.new_group([d * tp + t for d in range(dp)])
                for t in range(tp)]
        layouts[dp, tp] = rows, cols
    return layouts[dp, tp]


def make_mesh(p: Plan, device="cuda") -> Mesh:
    """This rank's coordinates and groups for ``p`` (the groups made once
    per layout, :func:`_layout_groups`).  The world size must be
    ``p.n_devices``; without a process group the plan must be one device."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        if p.n_devices != 1:
            raise ValueError(
                f"plan of {p.n_devices} devices without a process group: "
                "call ptx_torch.parallel.multihost.initialize() first"
            )
        return Mesh(plan=p, rank=0, dp_index=0, tp_index=0, device=str(device))
    world = dist.get_world_size()
    if world != p.n_devices:
        raise ValueError(f"plan of {p.n_devices} devices in a world of {world}")
    rank = dist.get_rank()
    rows, cols = _layout_groups(p.dp, p.tp)
    dp_index, tp_index = divmod(rank, p.tp)
    staging = (dist.get_backend() == "gloo"
               and torch.device(device).type == "cuda")
    return Mesh(plan=p, rank=rank, dp_index=dp_index, tp_index=tp_index,
                device=str(device), tp_group=rows[dp_index], dp_group=cols[tp_index],
                staging=staging)


def scene_shardings(scene_sharded: bool, shard_bvh: bool = False,
                    shard_tex: bool = False) -> dict:
    """Per-field rule of a FlatScene: ``AXIS_SCENE`` for a field split along
    tp (each rank keeps its ``1/tp`` slice), None for a replicated one.

    ``shard_bvh`` splits the BVH node arrays too: only for scenes prepared
    by :func:`ptx_torch.parallel.shard_scene.build_shard_scene`, whose
    per-shard node blocks hold shard-local leaf ranges.  A globally built
    BVH must never be split, nor replicated over split triangles.
    ``shard_tex`` splits the texel pack: only for packs rebuilt by
    :func:`ptx_torch.parallel.shard_scene.build_texture_shards`."""
    from ptx_torch.scene.flatten import FlatScene

    spec = {}
    for field in FlatScene._fields:
        split = scene_sharded and (
            field in TRI_FIELDS
            or (shard_bvh and field in BVH_FIELDS)
            or (shard_tex and field == "tex_texels")
        )
        spec[field] = AXIS_SCENE if split else None
    return spec


def shard_scene(fs, mesh: Mesh, scene_sharded: bool, shard_bvh: bool = False,
                shard_tex: bool = False):
    """This rank's view of a host FlatScene (numpy arrays) under the plan:
    each split field cut to the rank's tp slice, the rest whole.  Every
    process holds the whole host scene (the same file loaded on each) and
    keeps only its own shard (``multihost.put_global``)."""
    from ptx_torch.parallel.multihost import put_global
    from ptx_torch.scene.flatten import FlatScene

    specs = scene_shardings(scene_sharded, shard_bvh, shard_tex)
    return FlatScene(**{
        f: put_global(np.asarray(getattr(fs, f)), specs[f], mesh)
        for f in FlatScene._fields
    })
