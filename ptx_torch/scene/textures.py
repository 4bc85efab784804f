"""Bilinear texture sampling over the flat texel pack (port of
``ptx/scene/textures.py``).

Wrap addressing uses float ``v - size * floor(v / size)`` and V is flipped,
as in the JAX package.  A scene-sharded texel pack (``tex_shard_len > 0``,
``ptx_torch.parallel.shard_scene.build_texture_shards``) is sampled with the
rank's :class:`TexShard`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ptx_torch import math as pmath
from ptx_torch.kernels import gather_cuda
from ptx_torch.scene.flatten import (
    FlatScene,
    SLOT_ALBEDO,
    SLOT_EMISSIVE,
    SLOT_METALLIC,
    SLOT_NORMAL,
    SLOT_OPACITY,
    SLOT_ROUGHNESS,
)
from ptx_torch.utils import device_constant


class TexShard(NamedTuple):
    """A rank's place on the scene axis, for a sharded texel pack: its
    ``tp`` coordinate (it holds texels ``[tp_index * tex_shard_len, +
    tex_shard_len)`` of the global pack) and the sum over its ``dp`` row
    (``ptx``'s ``psum`` over the scene axis)."""

    tp_index: int
    psum: Callable


def sample_texture(fs: FlatScene, tex_idx, uv, static=None, shard=None):
    """Bilinear sample.  ``tex_idx``: [R] int pack slots; ``uv``: [R, 2].
    Returns linear RGBA [R, 4].

    With ``static.tex_shard_len > 0`` this rank holds one bin of whole
    textures; ``tex_offset`` stays global.  Each corner gather is masked to
    the local range and the bilinear result (all four corners of a sample
    live on one shard) is summed over the scene axis by ``shard.psum``:
    one non-zero term, so the sum is exact.  The rays must be the same on
    every rank of the row (the "reduce" exchange)."""
    shard_len = getattr(static, "tex_shard_len", 0) if static is not None else 0
    if shard_len > 0 and shard is None:
        raise ValueError("a scene-sharded texel pack needs the rank's TexShard")
    tex_idx = tex_idx.long()
    w = fs.tex_width[tex_idx].to(torch.float32)
    h = fs.tex_height[tex_idx].to(torch.float32)

    cx = uv[..., 0] * w - 0.5
    cy = (1.0 - uv[..., 1]) * h - 0.5
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    dx = cx - x0
    dy = cy - y0

    def fwrap(v, size):
        return v - size * torch.floor(v / size)

    x0f = fwrap(x0, w)
    x1f = fwrap(x0 + 1.0, w)
    y0f = fwrap(y0, h)
    y1f = fwrap(y0 + 1.0, h)
    offset = fs.tex_offset[tex_idx]

    if shard_len > 0:
        offset = offset - shard.tp_index * shard_len

        def texel(xf, yf):
            local = offset + (yf * w + xf).to(torch.int32)
            ok = (local >= 0) & (local < shard_len)
            v = fs.tex_texels[torch.clamp(local, 0, shard_len - 1).long()]
            return torch.where(ok[..., None], v, 0.0)
    else:

        def texel(xf, yf):
            idx = offset + (yf * w + xf).to(torch.int32)
            return fs.tex_texels[idx.long()]

    top = pmath.lerp(texel(x0f, y0f), texel(x1f, y0f), dx[..., None])
    bot = pmath.lerp(texel(x0f, y1f), texel(x1f, y1f), dx[..., None])
    out = pmath.lerp(top, bot, dy[..., None])
    return shard.psum(out) if shard_len > 0 else out


def material_lookup(fs: FlatScene, mat_id, uv, static=None, shard=None):
    """All shading inputs for a wavefront of hits: a dict of per-ray
    material properties.  The static facts recorded at flatten time
    (``tex_slot_used`` and the two share flags) prune the fetch exactly as
    the JAX package does, so the results are the same values.  ``shard``:
    the rank's :class:`TexShard` for a scene-sharded texel pack."""
    used = static.tex_slot_used if static is not None else (True,) * 7
    share_op = static.opacity_shares_albedo if static is not None else False
    share_mr = static.metallic_shares_roughness if static is not None else False

    mat_id = mat_id.long()
    tex = fs.mat_tex[mat_id] if any(used) else None  # [R, 7]
    # [R, 16]; its backward is the row_grad kernel when the rows carry a
    # gradient (gather_cuda.gather_rows), else autograd's own.
    row = gather_cuda.gather_rows(fs.mat_packed, mat_id)

    alb_rgba = None
    if used[SLOT_ALBEDO] or (used[SLOT_OPACITY] and share_op):
        alb_rgba = sample_texture(fs, tex[..., SLOT_ALBEDO], uv, static, shard)
    albedo = row[..., 0:3]
    if alb_rgba is not None and used[SLOT_ALBEDO]:
        albedo = albedo * alb_rgba[..., :3]

    opacity = row[..., 3]
    if used[SLOT_OPACITY]:
        if share_op:
            op_a = torch.where(
                tex[..., SLOT_OPACITY] == tex[..., SLOT_ALBEDO],
                alb_rgba[..., 3],
                torch.ones_like(opacity),
            )
        else:
            op_a = sample_texture(fs, tex[..., SLOT_OPACITY], uv, static, shard)[..., 3]
        opacity = opacity * op_a

    mr = None
    if used[SLOT_ROUGHNESS] or (used[SLOT_METALLIC] and share_mr):
        mr = sample_texture(fs, tex[..., SLOT_ROUGHNESS], uv, static, shard)
    roughness = row[..., 4]
    if mr is not None and used[SLOT_ROUGHNESS]:
        roughness = roughness * mr[..., 1]
    metallic = row[..., 5]
    if used[SLOT_METALLIC]:
        mb = mr if share_mr else sample_texture(
            fs, tex[..., SLOT_METALLIC], uv, static, shard
        )
        metallic = metallic * mb[..., 2]

    emissive = row[..., 6:9]
    if used[SLOT_EMISSIVE]:
        emissive = emissive * sample_texture(
            fs, tex[..., SLOT_EMISSIVE], uv, static, shard
        )[..., :3]

    if used[SLOT_NORMAL]:
        tangent_normal = (
            sample_texture(fs, tex[..., SLOT_NORMAL], uv, static, shard)[..., :3] * 2.0
            - 1.0
        )
    else:
        tangent_normal = device_constant((0.0, 0.0, 1.0), uv.device).expand(
            uv.shape[:-1] + (3,))

    return dict(
        albedo=albedo,
        opacity=opacity,
        roughness=roughness,
        metallic=metallic,
        emissive=emissive,
        tangent_normal=tangent_normal,
        ior=row[..., 9],
        shadow_catcher=row[..., 10],
    )
