"""The BVH walk: the hand-written CUDA kernel and its plain torch version
(port of ``ptx/accel/traverse.py``'s walk and ``make_backend``).

* :func:`closest_walk` - ``ptx_bvh_closest`` (``csrc/bvh_traverse.cu``),
  plain version ``ptx_torch.accel.traverse.walk``: ``(t, tri, beta, gamma,
  hit)`` of every ray;
* :func:`any_walk` - ``ptx_bvh_any``, plain version ``walk(...,
  any_hit=True)``: occlusion, each ray stopping at its first hit;
* :func:`visits` - ``ptx_bvh_visits``, plain version
  ``traverse.node_visits``: the nodes each ray visits (the ``bvh-depth``
  debug view).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (and counts the launch in
``_build.LAUNCHES``) or raises.  The rays may be strided rows (each row's
three floats contiguous); the scene's BVH and triangle arrays must be
contiguous.  Kernel outputs carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ptx_torch.accel import traverse
from ptx_torch.accel.traverse import MAX_STEPS
from ptx_torch.kernels import _build
from ptx_torch.kernels.intersect import Hit, attrs_from_indices
from ptx_torch.scene.flatten import FlatScene


class _BvhArgs(ctypes.Structure):
    """``BvhArgs`` of ``csrc/bvh_traverse.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("lo", "hi", "first", "count", "miss", "a", "e1", "e2")] + [
        (name, ctypes.c_int) for name in
        ("n_nodes", "n_tris", "leaf_size", "max_steps")]


def _bvh_args(fs: FlatScene, leaf_size: int, max_steps: int) -> _BvhArgs:
    n_nodes, n_tris = fs.bvh_min.shape[0], fs.tri_a.shape[0]
    for name, dtype, shape in (
        ("bvh_min", torch.float32, (n_nodes, 3)),
        ("bvh_max", torch.float32, (n_nodes, 3)),
        ("bvh_first", torch.int32, (n_nodes,)),
        ("bvh_count", torch.int32, (n_nodes,)),
        ("bvh_miss", torch.int32, (n_nodes,)),
        ("tri_a", torch.float32, (n_tris, 3)),
        ("tri_e1", torch.float32, (n_tris, 3)),
        ("tri_e2", torch.float32, (n_tris, 3)),
    ):
        _build.check(getattr(fs, name), name, dtype, shape)
    return _BvhArgs(
        fs.bvh_min.data_ptr(), fs.bvh_max.data_ptr(), fs.bvh_first.data_ptr(),
        fs.bvh_count.data_ptr(), fs.bvh_miss.data_ptr(), fs.tri_a.data_ptr(),
        fs.tri_e1.data_ptr(), fs.tri_e2.data_ptr(),
        n_nodes, n_tris, leaf_size, max_steps)


def _rows(x, name):
    """``x`` [R, 3] float32 whose rows are three contiguous floats (strided
    rows of a wider array and broadcast rows are read in place; anything
    else is copied), and its row stride."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: expected float32 [R, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def _launch(fn, kernel, fs, orig, dirn, leaf_size, max_steps, *outs):
    """Launch walk ``fn`` (counted as ``kernel``) on ``orig`` / ``dirn``
    into ``outs``."""
    orig, so = _rows(orig, "orig")
    dirn, sd = _rows(dirn, "dirn")
    r = orig.shape[0]
    if dirn.shape[0] != r:
        raise ValueError(f"{r} origins, {dirn.shape[0]} directions")
    if r == 0:
        return
    args = _bvh_args(fs, leaf_size, max_steps)
    _build.launch(fn, orig.data_ptr(), so, dirn.data_ptr(), sd, r,
                  ctypes.byref(args), *(o.data_ptr() for o in outs))
    _build.LAUNCHES[kernel] += 1


def _on_cpu(fs, orig, dirn):
    return _build.on_cpu(orig, dirn, fs.bvh_min, fs.tri_a)


def closest_walk(fs: FlatScene, orig, dirn, leaf_size: int = 8,
                 max_steps: int = MAX_STEPS):
    """``(t [R], tri [R] int32, beta [R], gamma [R], hit [R] bool)`` of the
    closest-hit walk."""
    with torch.no_grad():
        if _on_cpu(fs, orig, dirn):
            return traverse.walk(fs, orig, dirn, leaf_size, max_steps)
        r, dev = orig.shape[0], orig.device
        t = torch.empty((r,), dtype=torch.float32, device=dev)
        tri = torch.empty((r,), dtype=torch.int32, device=dev)
        beta = torch.empty((r,), dtype=torch.float32, device=dev)
        gamma = torch.empty((r,), dtype=torch.float32, device=dev)
        hit = torch.empty((r,), dtype=torch.bool, device=dev)
        _launch(_build.load().ptx_bvh_closest, "bvh_closest", fs, orig, dirn,
                leaf_size, max_steps, t, tri, beta, gamma, hit)
        return t, tri, beta, gamma, hit


def any_walk(fs: FlatScene, orig, dirn, leaf_size: int = 8,
             max_steps: int = MAX_STEPS):
    """Occlusion of every ray: [R] bool."""
    with torch.no_grad():
        if _on_cpu(fs, orig, dirn):
            return traverse.walk(fs, orig, dirn, leaf_size, max_steps,
                                 any_hit=True)[4]
        hit = torch.empty((orig.shape[0],), dtype=torch.bool, device=orig.device)
        _launch(_build.load().ptx_bvh_any, "bvh_any", fs, orig, dirn,
                leaf_size, max_steps, hit)
        return hit


def visits(fs: FlatScene, orig, dirn, max_steps: int = MAX_STEPS):
    """Nodes each ray visits walking the whole BVH: [R] int32."""
    with torch.no_grad():
        if _on_cpu(fs, orig, dirn):
            return traverse.node_visits(fs, orig, dirn, max_steps)
        steps = torch.empty((orig.shape[0],), dtype=torch.int32,
                            device=orig.device)
        _launch(_build.load().ptx_bvh_visits, "bvh_visits", fs, orig, dirn,
                1, max_steps, steps)
        return steps


def make_backend(leaf_size: int = 8, max_steps: int = MAX_STEPS):
    """``(closest, any_hit)`` over the attached BVH, with the integrator
    signature: the walk selects the hit, ``attrs_from_indices`` resolves
    it (the JAX package's ``traverse.make_backend``)."""

    def closest(fs: FlatScene, orig, dirn) -> Hit:
        t, tri, beta, gamma, hit = closest_walk(fs, orig, dirn, leaf_size,
                                                max_steps)
        return attrs_from_indices(fs, t, tri.long(), beta, gamma, hit)

    def any_hit(fs: FlatScene, orig, dirn):
        return any_walk(fs, orig, dirn, leaf_size, max_steps)

    return closest, any_hit
