"""Stackless BVH traversal: the plain torch walk (port of
``ptx/accel/traverse.py``).

Every ray carries one node register and follows the escape links of the
flattened BVH (``ptx_torch.accel.bvh``): a hit on an interior box falls
through to ``node + 1`` (the left child, DFS order), a leaf or a missed box
jumps to ``bvh_miss[node]``, and ``-1`` ends the walk.  The JAX package
runs that loop per ray under ``vmap`` (a ``while_loop`` in lock step); here
one loop steps every ray still walking, as a batch, until none is.  Leaves
are contiguous triangle ranges of at most ``leaf_size``, tested with a
``[R, leaf_size]`` Moller-Trumbore block and a count mask.

This is the ``bvh`` backend on the CPU and the oracle of the CUDA walk
(``csrc/bvh_traverse.cu``, ``ptx_torch.kernels.traverse_cuda``), which must
equal it bit for bit: the slab test keeps the JAX package's NaN rules (a
NaN-propagating min / max per axis, then NaN -> -inf / +inf), a leaf's
winner is the first least ``t``, and a winner replaces the best only on a
strictly smaller ``t``.  Node and triangle indices are clamped into range
as a JAX gather clamps them.  Outputs carry no gradient.
"""

from __future__ import annotations

import torch

from ptx_torch import geometry
from ptx_torch.scene.flatten import FlatScene

INF = geometry.INF
# The per-ray cap on node visits (the JAX package's default).
MAX_STEPS = 4096


def _reads(fs: FlatScene, dev):
    """Per array of ``fs`` a walk may read, a mask of the rows it read, all
    False to start (arrays always read together share one mask): the bytes
    a walk must move, which a bound counts."""
    nodes = fs.bvh_min.shape[0]
    boxes, links, leaves = (torch.zeros((nodes,), dtype=torch.bool, device=dev)
                            for _ in range(3))
    tris = torch.zeros((fs.tri_a.shape[0],), dtype=torch.bool, device=dev)
    return {"bvh_min": boxes, "bvh_max": boxes, "bvh_count": boxes,
            "bvh_miss": links, "bvh_first": leaves,
            "tri_a": tris, "tri_e1": tris, "tri_e2": tris}


def _slab(fs: FlatScene, nd, o, inv_d):
    """Entry and exit distance of each ray's box ``nd``; an axis whose slab
    distance is NaN (0 * inf) drops out."""
    t0 = (fs.bvh_min[nd] - o) * inv_d
    t1 = (fs.bvh_max[nd] - o) * inv_d
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    near = torch.where(torch.isnan(tmin), float("-inf"), tmin).amax(-1)
    far = torch.where(torch.isnan(tmax), float("inf"), tmax).amin(-1)
    return near, far


@torch.no_grad()
def walk(fs: FlatScene, orig, dirn, leaf_size: int = 8,
         max_steps: int = MAX_STEPS, any_hit: bool = False,
         counts: bool = False):
    """Closest hit of every ray through the BVH: ``(t [R], tri [R] int32,
    beta [R], gamma [R], hit [R] bool)``, ``t = INF`` and ``tri = 0`` on a
    miss.  ``any_hit`` stops a ray at its first hit (only ``hit`` is then
    meaningful).  ``counts`` appends each ray's nodes visited and triangles
    tested ([R] int32 each) and the rows read of each array (see
    :func:`_reads`), the work a bound counts."""
    r, dev = orig.shape[0], orig.device
    n_nodes, n_tris = fs.bvh_min.shape[0], fs.tri_a.shape[0]
    inv_d = 1.0 / dirn
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)
    best_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((r,), dtype=torch.int32, device=dev)
    best_b = torch.zeros((r,), dtype=torch.float32, device=dev)
    best_g = torch.zeros((r,), dtype=torch.float32, device=dev)
    tests = torch.zeros((r,), dtype=torch.int32, device=dev)
    k = torch.arange(leaf_size, device=dev)
    reads = _reads(fs, dev) if counts else None
    while True:
        live = (node >= 0) & (steps < max_steps)
        if any_hit:
            live &= best_t >= INF
        lanes = live.nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        cur = node[lanes]
        nd = cur.clamp(max=n_nodes - 1)
        near, far = _slab(fs, nd, orig[lanes], inv_d[lanes])
        box = (far >= near.clamp(min=0.0)) & (near < best_t[lanes])
        count = fs.bvh_count[nd]
        leaf = count > 0
        sel = (box & leaf).nonzero()[:, 0]
        if sel.numel():
            ln = lanes[sel]
            idx = (fs.bvh_first[nd[sel]].long()[:, None] + k).clamp(max=n_tris - 1)
            t, beta, gamma, ok = geometry.moller_trumbore(
                orig[ln][:, None, :], dirn[ln][:, None, :],
                fs.tri_a[idx], fs.tri_e1[idx], fs.tri_e2[idx],
            )
            t = torch.where((k < count[sel][:, None]) & ok, t, INF)
            j = torch.argmin(t, dim=1, keepdim=True)  # the first least t
            lt = t.gather(1, j)[:, 0]
            closer = lt < best_t[ln]
            w = ln[closer]
            best_t[w] = lt[closer]
            best_tri[w] = idx.gather(1, j)[:, 0][closer].to(torch.int32)
            best_b[w] = beta.gather(1, j)[:, 0][closer]
            best_g[w] = gamma.gather(1, j)[:, 0][closer]
            tests[ln] += count[sel].clamp(max=leaf_size)
            if counts:
                reads["bvh_first"][nd[sel]] = True
                reads["tri_a"][idx[k < count[sel][:, None]]] = True
        descend = box & ~leaf
        node[lanes] = torch.where(descend, cur + 1, fs.bvh_miss[nd].long())
        steps[lanes] += 1
        if counts:
            reads["bvh_min"][nd] = True
            reads["bvh_miss"][nd[~descend]] = True
    out = (best_t, best_tri, best_b, best_g, best_t < INF)
    return out + (steps, tests, reads) if counts else out


@torch.no_grad()
def node_visits(fs: FlatScene, orig, dirn, max_steps: int = MAX_STEPS,
                counts: bool = False):
    """BVH nodes each ray visits when it walks the whole tree (no leaf
    test, every box it enters opened): [R] int32, the traversal-cost
    oracle of ``ptx.debug``'s ``bvh-depth`` view.  ``counts`` also returns
    the rows read of each array (see :func:`_reads`)."""
    r, dev = orig.shape[0], orig.device
    n_nodes = fs.bvh_min.shape[0]
    inv_d = 1.0 / dirn
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    steps = torch.zeros((r,), dtype=torch.int32, device=dev)
    reads = _reads(fs, dev) if counts else None
    while True:
        lanes = ((node >= 0) & (steps < max_steps)).nonzero()[:, 0]
        if lanes.numel() == 0:
            break
        cur = node[lanes]
        nd = cur.clamp(max=n_nodes - 1)
        near, far = _slab(fs, nd, orig[lanes], inv_d[lanes])
        descend = (far >= near.clamp(min=0.0)) & (fs.bvh_count[nd] == 0)
        node[lanes] = torch.where(descend, cur + 1, fs.bvh_miss[nd].long())
        steps[lanes] += 1
        if counts:
            reads["bvh_min"][nd] = True
            reads["bvh_miss"][nd[~descend]] = True
    return (steps, reads) if counts else steps
