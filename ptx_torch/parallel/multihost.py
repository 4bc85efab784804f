"""Process-group setup and the cross-rank image gather (port of
``ptx/parallel/multihost.py``).

``ptx`` wires hosts into one JAX runtime with ``jax.distributed``; the port
runs one process per rank on ``torch.distributed``, launched by torchrun:

    python -m torch.distributed.run --nproc-per-node N \\
        -m ptx_torch.cli render --distributed ...

:func:`initialize` joins the process group (NCCL on CUDA, one rank per
card; gloo on the CPU, or when the caller asks for it to let several ranks
share one card).  A run without torchrun's environment is a world of 1.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group; returns True when distributed.

    With no arguments the rank, world size and address come from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without it the run is single-process (False, nothing
    done).  ``coordinator_address`` is ``host:port``.  ``backend=None`` is
    "nccl" when the ranks render on CUDA and "gloo" when they render on the
    CPU: ``device`` is the device the caller renders on; None means CUDA
    when it is available.

    Under NCCL each rank takes ``cuda:{LOCAL_RANK}``; NCCL cannot run two
    ranks on one card, so more ranks on a host than cards raises.  Under
    gloo each rank takes ``cuda:{LOCAL_RANK % cards}`` (several ranks may
    share a card; the collectives then stage through the host,
    ``ptx_torch.parallel.dist``)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if not all(k in env for k in _TORCHRUN_ENV):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        raise ValueError("num_processes given without coordinator_address")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count() if cuda else 0
        if local_world > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {local_world} ranks on this "
                f"host but {cards} CUDA device(s) (NCCL refuses two ranks on "
                "one card as a duplicate GPU); pass backend=\"gloo\" to share "
                "a card"
            )
        torch.cuda.set_device(local_rank)
    elif cuda:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        print(f"rank {process_id}: gloo on cuda:"
              f"{local_rank % torch.cuda.device_count()}, collectives staged "
              "through the host", file=sys.stderr)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    print(f"rank {process_id}/{num_processes}: {backend} process group",
          file=sys.stderr)
    return True


def shutdown():
    """Leave the process group: drop the meshes' cached groups
    (``mesh._layout_groups``) first, so none outlives it, then destroy it.
    Nothing to do when no group was joined."""
    import torch.distributed as dist

    from ptx_torch.parallel import mesh

    mesh._GROUPS.update(world=None, layouts={})
    if dist.is_initialized():
        dist.destroy_process_group()


class Replicator:
    """The gather ``ptx_torch.render.progressive_render`` applies to its
    carry (this rank's pixels) before checkpoint writes and the final
    fetch: an all-gather over the ranks that split the pixels, in pixel
    order.  ``writer`` is True on rank 0 only, the one that writes files;
    :meth:`barrier` holds every rank until a write is done."""

    def __init__(self, mesh, comm: str = "reduce"):
        self.mesh = mesh
        ring = comm == "ring" and mesh.plan.scene_sharded
        # Ring mode splits pixels over every rank (global rank order is the
        # ray order); reduce mode over the dp axis, each tp column holding
        # the same image.
        self.group = None if ring else mesh.dp_group
        self.writer = mesh.rank == 0

    def __call__(self, tree):
        from ptx_torch.parallel import dist as pdist

        return tuple(pdist.all_gather(self.mesh, x, self.group) for x in tree)

    def barrier(self):
        import torch

        from ptx_torch.parallel import dist as pdist

        pdist.all_reduce(self.mesh, torch.zeros(1, device=self.mesh.device),
                         "sum", None)


def replicator(mesh, comm: str = "reduce") -> Optional[Replicator]:
    """The gather of the carry across ranks (:class:`Replicator`); None in
    a world of 1, where this rank holds every pixel."""
    return Replicator(mesh, comm) if mesh.distributed else None


def put_global(x: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's part of a host array that every process holds whole (the
    scene is loaded from the same file on each): the ``mesh.tp_index``-th
    of ``tp`` equal slices along axis 0 when ``spec`` is the scene axis,
    else the whole array."""
    if spec is None:
        return x
    tp = mesh.plan.tp
    n = x.shape[0] // tp
    if n * tp != x.shape[0]:
        raise ValueError(f"array of {x.shape[0]} rows does not split {tp} ways")
    return x[mesh.tp_index * n:(mesh.tp_index + 1) * n]
