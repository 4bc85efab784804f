"""SAH BVH: host-side build, flattened stackless layout for device traversal.

Counterpart of the reference's per-mesh SAH KD-tree
(``core/mesh.cpp:131-298``).  Differences are deliberate TPU re-design, not
translation:

* **BVH, not KD-tree** — object partitioning means no triangle duplication
  (the reference clones straddlers into both children, ``mesh.cpp:51-74``)
  and leaves are contiguous *ranges* into a globally reordered triangle
  array, which is exactly what a vectorized/Pallas leaf test wants.
* **Binned SAH** (16 bins/axis, cost = area x count, leaf when no split
  beats the parent cost) instead of the reference's exact sorted-event sweep
  — O(N log N) with vectorized numpy, same quality class.
* **Stackless escape links** — the flattened node array is in DFS order;
  interior hit -> fall through to ``node+1`` (left child), miss (or leaf
  done) -> jump to ``miss_next``.  Traversal is a bounded ``while_loop`` with
  two int registers per lane: the shape XLA and Pallas both like (no
  per-lane stack memory).

The builder is numpy (scenes are built once on the host); a C++ builder
(``ptx/accel/cpp``) accelerates million-triangle scenes with the same
output layout.

The port's own copy of ``ptx/accel/bvh.py``: the imports differ, and a build
always returns numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ptx_torch.scene.flatten import FlatScene, SceneStatic

SENTINEL = np.int32(-1)

# Triangle-indexed FlatScene fields that get permuted by the build.
TRI_FIELDS = (
    "tri_a", "tri_e1", "tri_e2", "tri_valid",
    "n0", "n1", "n2", "t0", "t1", "t2",
    "uv0", "uv1", "uv2", "mat_id", "tri_attrs",
)


@dataclasses.dataclass
class _BuildNode:
    bb_min: np.ndarray
    bb_max: np.ndarray
    first: int  # range into the ordering array
    count: int
    left: int = -1  # build-tree child indices
    right: int = -1


def _sah_build(centroids, bb_min_tri, bb_max_tri, leaf_size, n_bins):
    """Binned-SAH top-down build over triangle indices.

    Returns (nodes, order): ``nodes`` is a list of _BuildNode over index
    ranges of ``order``.
    """
    n = centroids.shape[0]
    order = np.arange(n)
    nodes = []

    def node_bounds(idx):
        return bb_min_tri[idx].min(axis=0), bb_max_tri[idx].max(axis=0)

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def build(first, count):
        idx = order[first : first + count]
        mn, mx = node_bounds(idx)
        node_id = len(nodes)
        nodes.append(_BuildNode(mn, mx, first, count))
        if count <= leaf_size:
            return node_id

        # Binned SAH over the centroid extent of the widest axes.
        best = None  # (cost, axis, threshold)
        cen = centroids[idx]
        cmin, cmax = cen.min(axis=0), cen.max(axis=0)
        parent_area = surface(mn, mx)
        leaf_cost = float(count)
        for axis in range(3):
            extent = cmax[axis] - cmin[axis]
            if extent <= 1e-12:
                continue
            rel = (cen[:, axis] - cmin[axis]) / extent
            bins = np.minimum((rel * n_bins).astype(np.int32), n_bins - 1)
            counts = np.bincount(bins, minlength=n_bins)
            # Per-bin bounds.
            bmn = np.full((n_bins, 3), np.inf)
            bmx = np.full((n_bins, 3), -np.inf)
            for b in range(n_bins):
                sel = bins == b
                if counts[b]:
                    bmn[b] = bb_min_tri[idx[sel]].min(axis=0)
                    bmx[b] = bb_max_tri[idx[sel]].max(axis=0)
            # Prefix/suffix sweep.
            lmn = np.minimum.accumulate(bmn, axis=0)
            lmx = np.maximum.accumulate(bmx, axis=0)
            rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1]
            rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = count - lcount
            for b in range(n_bins - 1):
                nl, nr = lcount[b], rcount[b]
                if nl == 0 or nr == 0:
                    continue
                cost = (
                    surface(lmn[b], lmx[b]) * nl + surface(rmn[b + 1], rmx[b + 1]) * nr
                ) / max(parent_area, 1e-30)
                if best is None or cost < best[0]:
                    thresh = cmin[axis] + extent * (b + 1) / n_bins
                    best = (cost, axis, thresh)

        # Leaf if no split beats the no-split cost (mesh.cpp:219-227 analog).
        if best is None or best[0] >= leaf_cost:
            return node_id

        _, axis, thresh = best
        sel = centroids[idx, axis] < thresh
        n_left = int(sel.sum())
        if n_left == 0 or n_left == count:
            return node_id
        # Partition the ordering range in place.
        order[first : first + count] = np.concatenate([idx[sel], idx[~sel]])
        nodes[node_id].left = build(first, n_left)
        nodes[node_id].right = build(first + n_left, count - n_left)
        nodes[node_id].count = 0  # interior
        return node_id

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old_limit)
    return nodes, order


def _flatten_dfs(nodes):
    """DFS-order the build tree and compute stackless miss links."""
    n_out = len(nodes)
    bb_min = np.zeros((n_out, 3), np.float32)
    bb_max = np.zeros((n_out, 3), np.float32)
    first = np.zeros(n_out, np.int32)
    count = np.zeros(n_out, np.int32)
    miss = np.full(n_out, SENTINEL, np.int32)

    # Pass 1 assigns DFS slots; pass 2 fills data + miss links.
    slot = [0]
    out_index = {}

    def assign(node_id):
        i = slot[0]
        slot[0] += 1
        out_index[node_id] = i
        nd = nodes[node_id]
        if not nd.count:
            assign(nd.left)
            assign(nd.right)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        assign(0)

        def fill(node_id, miss_link):
            i = out_index[node_id]
            nd = nodes[node_id]
            bb_min[i] = nd.bb_min
            bb_max[i] = nd.bb_max
            miss[i] = miss_link
            if nd.count:
                first[i] = nd.first
                count[i] = nd.count
            else:
                fill(nd.left, out_index[nd.right])
                fill(nd.right, miss_link)

        fill(0, SENTINEL)
    finally:
        sys.setrecursionlimit(old_limit)
    return bb_min, bb_max, first, count, miss


def build_bvh(
    fs: FlatScene,
    static: SceneStatic,
    leaf_size: int = 8,
    n_bins: int = 16,
    backend: str = "auto",
) -> Tuple[FlatScene, SceneStatic]:
    """Build the BVH over the *valid* triangles and return a new
    (FlatScene, SceneStatic) with triangles reordered leaf-contiguously and
    the flattened node arrays attached.

    The returned triangle arrays keep their padded length; padding slots sit
    at the tail, outside every leaf range.
    """
    a = np.asarray(fs.tri_a)
    e1 = np.asarray(fs.tri_e1)
    e2 = np.asarray(fs.tri_e2)
    n = static.n_tris
    if n == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    v0, v1, v2 = a[:n], a[:n] + e1[:n], a[:n] + e2[:n]
    bb_min_tri = np.minimum(np.minimum(v0, v1), v2)
    bb_max_tri = np.maximum(np.maximum(v0, v1), v2)
    centroids = (v0 + v1 + v2) / 3.0

    result = None
    if backend in ("auto", "native"):
        from ptx_torch.accel import native

        result = native.build_bvh_native(v0, e1[:n], e2[:n], leaf_size, n_bins)
        if result is None and backend == "native":
            raise RuntimeError("native BVH builder unavailable")
    if result is not None:
        order, bb_min, bb_max, first, count, miss, _ = result
        nodes = range(len(first))  # only len() is used below
    else:
        nodes, order = _sah_build(
            centroids, bb_min_tri, bb_max_tri, leaf_size, n_bins
        )
        bb_min, bb_max, first, count, miss = _flatten_dfs(nodes)

    # Permute triangle-indexed arrays (identity on the padding tail).
    # The build is host-side: numpy in, numpy out (callers upload once with
    # ptx_torch.scene.bridge.to_device).
    perm = np.concatenate([order, np.arange(n, a.shape[0])])
    new_fields = {f: np.asarray(getattr(fs, f))[perm] for f in TRI_FIELDS}
    fs = fs._replace(
        **new_fields,
        bvh_min=np.asarray(bb_min),
        bvh_max=np.asarray(bb_max),
        bvh_first=np.asarray(first),
        bvh_count=np.asarray(count),
        bvh_miss=np.asarray(miss),
    )
    static = dataclasses.replace(
        static, n_bvh_nodes=len(nodes), bvh_leaf_size=leaf_size
    )
    return fs, static
