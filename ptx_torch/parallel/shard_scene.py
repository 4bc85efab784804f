"""Shard-local scenes for the scene-parallel (``tp``) axis (port of
``ptx/parallel/shard_scene.py``).

The flattened triangle soup is split into ``tp`` contiguous chunks, each
chunk gets its *own* BVH over exactly its triangles, and the shard-local
arrays are stacked so that rank ``i`` of a ``dp`` row, keeping the ``i``-th
slice (``ptx_torch.parallel.mesh.shard_scene``), holds a self-contained
mini-scene whose leaf ranges (``bvh_first``) index its *local* triangle
arrays.  A globally built BVH is never carried onto a shard: its leaf
ranges index the global triangle order.

Everything here is host-side numpy, run once at scene setup.  The stacked
scene carries no traversal tiles; each rank packs its own shard's tiles
(``ptx_torch.parallel.dist.prepare_scene``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ptx_torch.accel.bvh import TRI_FIELDS, build_bvh
from ptx_torch.config import RenderConfig
from ptx_torch.parallel.mesh import BVH_FIELDS, Plan
from ptx_torch.scene.bridge import to_host
from ptx_torch.scene.flatten import FlatScene, SceneStatic

_INF = np.float32(3.0e38)


def shard_ranges(n_tris: int, tp: int) -> List[Tuple[int, int]]:
    """Contiguous, balanced triangle ranges (the equal-count split of the
    reference partitioner, at triangle granularity)."""
    q = -(-n_tris // tp) if n_tris else 0
    return [(min(i * q, n_tris), min((i + 1) * q, n_tris)) for i in range(tp)]


def _empty_bvh():
    """A 1-node BVH that can never be entered: an empty box (lo > hi) fails
    the slab test, and the root's escape link ends the walk at once."""
    return (
        np.full((1, 3), _INF, np.float32),     # bvh_min
        np.full((1, 3), -_INF, np.float32),    # bvh_max
        np.zeros(1, np.int32),                 # bvh_first
        np.zeros(1, np.int32),                 # bvh_count
        np.full(1, -1, np.int32),              # bvh_miss
    )


def _needs_bvh(static_local: SceneStatic, cfg: RenderConfig, device) -> bool:
    """``ptx_torch.render.ensure_accel``'s decision, taken on the per-shard
    view (what the distributed sample function resolves with): the bvh
    backend needs nodes; the tile traversal wants the BVH *order* for tight
    tiles once a shard spans several tiles."""
    from ptx_torch.render import resolve_intersector

    name = resolve_intersector(static_local, cfg, device)
    return name == "bvh" or (name == "pallas" and static_local.n_tris > 2048)


def build_shard_scene(
    fs: FlatScene,
    static: SceneStatic,
    plan: Plan,
    cfg: RenderConfig,
    pad_multiple: int = 256,
    device="cuda",
) -> Tuple[FlatScene, SceneStatic]:
    """Split the scene into ``plan.tp`` shard-local chunks (host-side).

    Returns ``(fs_stacked, static_local)``: the triangle fields as
    ``[tp * per_shard_padded]`` (shard i's chunk at ``i *
    per_shard_padded``), and, when the backend resolved on ``device`` wants
    one, per-shard BVH node arrays stacked to ``[tp * n_nodes_padded]``;
    ``static_local`` describes one rank's view (``n_tris_padded`` the shard
    length, ``n_bvh_nodes`` the padded per-shard node count, the scene
    bounds still global)."""
    tp = plan.tp
    if tp <= 1:
        raise ValueError("build_shard_scene requires a scene-sharded plan")

    host = to_host(fs)
    n = static.n_tris
    ranges = shard_ranges(n, tp)
    counts = [stop - start for start, stop in ranges]
    per_pad = max(pad_multiple, -(-max(counts) // pad_multiple) * pad_multiple)

    want_bvh = _needs_bvh(
        dataclasses.replace(static, n_tris=max(counts), n_tris_padded=per_pad),
        cfg, device,
    )

    shard_tri: List[dict] = []
    shard_bvh: List[tuple] = []
    for (start, stop), count in zip(ranges, counts):
        fields = {}
        for f in TRI_FIELDS:
            src = getattr(host, f)
            out = np.zeros((per_pad,) + src.shape[1:], src.dtype)
            out[:count] = src[start:stop]
            fields[f] = out
        fields["tri_valid"] = np.arange(per_pad) < count

        if want_bvh and count > 0:
            sub_fs = host._replace(**fields)
            sub_static = dataclasses.replace(
                static, n_tris=count, n_tris_padded=per_pad, n_bvh_nodes=0
            )
            sub_fs, sub_static = build_bvh(
                sub_fs, sub_static, leaf_size=static.bvh_leaf_size or 8
            )
            fields = {f: np.asarray(getattr(sub_fs, f)) for f in TRI_FIELDS}
            shard_bvh.append(
                tuple(np.asarray(getattr(sub_fs, f)) for f in BVH_FIELDS)
            )
        elif want_bvh:
            shard_bvh.append(_empty_bvh())
        shard_tri.append(fields)

    stacked = {
        f: np.concatenate([s[f] for s in shard_tri], axis=0)
        for f in TRI_FIELDS
    }

    n_nodes = 0
    if want_bvh:
        n_nodes = max(b[0].shape[0] for b in shard_bvh)
        padded = []
        for bmn, bmx, first, cnt, miss in shard_bvh:
            k = bmn.shape[0]
            if k < n_nodes:
                # Tail nodes are unreachable (links never point past the
                # shard's real node set); empty boxes keep them inert even so.
                bmn = np.concatenate([bmn, np.full((n_nodes - k, 3), _INF, np.float32)])
                bmx = np.concatenate([bmx, np.full((n_nodes - k, 3), -_INF, np.float32)])
                first = np.concatenate([first, np.zeros(n_nodes - k, np.int32)])
                cnt = np.concatenate([cnt, np.zeros(n_nodes - k, np.int32)])
                miss = np.concatenate([miss, np.full(n_nodes - k, -1, np.int32)])
            padded.append((bmn, bmx, first, cnt, miss))
        for i, f in enumerate(BVH_FIELDS):
            stacked[f] = np.concatenate([p[i] for p in padded], axis=0)

    # Drop any attached traversal tiles: they index the *global* triangle
    # order, and carrying them onto a shard would make the sweep gather
    # global tile ids from shard-local arrays (a silently wrong image).
    fs_stacked = host._replace(
        **stacked,
        ptiles=np.zeros((0, 16, 1), np.float32),
        pboxes=np.zeros((0, 8), np.float32),
    )
    static_local = dataclasses.replace(
        static,
        n_tris=max(counts),
        n_tris_padded=per_pad,
        n_bvh_nodes=n_nodes,
        shard_local=True,
    )
    return fs_stacked, static_local


def texture_bins(sizes: List[int], tp: int) -> List[int]:
    """Greedy balanced bin assignment: textures (by texel count) land in the
    currently lightest of ``tp`` bins, largest first.  Returns the bin of
    each texture."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    totals = [0] * tp
    assign = [0] * len(sizes)
    for i in order:
        b = totals.index(min(totals))
        assign[i] = b
        totals[b] += sizes[i]
    return assign


def build_texture_shards(
    fs: FlatScene,
    static: SceneStatic,
    tp: int,
    pad_multiple: int = 8,
) -> Tuple[FlatScene, SceneStatic]:
    """Split the texel pack into ``tp`` whole-texture bins (host-side): the
    pack rebuilt as ``[tp * per_shard, 4]`` with bin ``b``'s textures
    contiguous at global offset ``b * per_shard``, to be split along the
    scene axis.  ``tex_offset`` stays global; the sampler masks each gather
    to the rank's range and sums across tp
    (``ptx_torch.scene.textures.sample_texture``).  Whole-texture bins keep
    all four bilinear corners of a sample on one shard.  Returns ``(fs,
    static)`` with ``static.tex_shard_len = per_shard``."""
    if tp <= 1:
        raise ValueError("build_texture_shards requires tp > 1")
    texels = np.asarray(fs.tex_texels)
    offsets = np.asarray(fs.tex_offset)
    widths = np.asarray(fs.tex_width)
    heights = np.asarray(fs.tex_height)
    sizes = (widths.astype(np.int64) * heights).tolist()

    assign = texture_bins(sizes, tp)
    bin_totals = [0] * tp
    for i, b in enumerate(assign):
        bin_totals[b] += sizes[i]
    per_shard = max(pad_multiple, -(-max(bin_totals) // pad_multiple) * pad_multiple)

    # The within-texture index is float32 in the sampler, so one texture
    # must stay below 2^24 texels; int32 bounds the stacked pack.
    if sizes and max(sizes) >= (1 << 24):
        raise ValueError(
            f"largest texture has {max(sizes)} texels (>= 2^24); float32 "
            "within-texture addressing would lose exactness — flatten() "
            "mips oversized textures, route loading through it"
        )
    if tp * per_shard >= (1 << 31):
        raise ValueError("stacked texel pack exceeds int32 addressing")

    new_texels = np.zeros((tp * per_shard, 4), np.float32)
    new_offsets = np.zeros_like(offsets)
    cursors = [b * per_shard for b in range(tp)]
    for i, b in enumerate(assign):
        new_offsets[i] = cursors[b]
        new_texels[cursors[b] : cursors[b] + sizes[i]] = texels[
            offsets[i] : offsets[i] + sizes[i]
        ]
        cursors[b] += sizes[i]

    fs = fs._replace(tex_texels=new_texels, tex_offset=new_offsets)
    static = dataclasses.replace(static, tex_shard_len=per_shard)
    return fs, static
