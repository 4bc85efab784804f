"""Bake a parsed scene into flat SoA device arrays.

The reference keeps a live entity tree and per-mesh KD-trees, transforming
each ray world->local per model at every intersection
(``scene/model.cpp:20-63``).  On TPU the scene is static, so we bake node
transforms into *world-space* triangle/attribute arrays once at load:

* intersection happens directly in world space (the reference's back-and-forth
  local transform + scale-corrected distance at ``model.cpp:57-60`` becomes a
  no-op — world-space ``t`` *is* the world distance),
* vertex normals/tangents are pre-multiplied by the normal matrix
  ``transpose(inverse(basis))`` but left un-normalized, so interpolating then
  normalizing at the hit point is bit-for-bit the reference's
  ``normalize(normal_matrix * interp(n))`` (``src/scene/intersect.cpp:121-140``),
* everything is padded to static, lane-aligned shapes.

``FlatScene`` is a pure-array NamedTuple — a pytree that jits, shards, and
differentiates (inverse rendering takes gradients w.r.t. its material leaves).
Static facts (counts, flags) live in ``SceneStatic`` and are closed over by
the jitted render functions.

The port's own copy of ``ptx/scene/flatten.py``: only the imports differ, so both
packages build bit-identical arrays (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from ptx_torch.scene.gltf import SceneData, decode_image

# float32 within-texture addressing is exact below this many texels
# (ptx/scene/textures.py); larger textures are box-filter mipped down at
# flatten instead of rejected (the reference streams any size from S3,
# load_gltf.cpp:142-162 — refusing to load would be a capability gap).
TEXEL_LIMIT = 1 << 24


def _mip_once(px: np.ndarray) -> np.ndarray:
    """One 2x2 box-filter level (odd trailing row/col cropped); degenerate
    1-wide/1-tall images halve along their long axis only."""
    h, w = px.shape[:2]
    if h >= 2 and w >= 2:
        px = px[: h // 2 * 2, : w // 2 * 2]
        return 0.25 * (px[0::2, 0::2] + px[1::2, 0::2]
                       + px[0::2, 1::2] + px[1::2, 1::2])
    if w >= 2:
        return 0.5 * (px[:, : w // 2 * 2][:, 0::2] + px[:, : w // 2 * 2][:, 1::2])
    return 0.5 * (px[: h // 2 * 2][0::2] + px[: h // 2 * 2][1::2])


def mip_to_limit(px: np.ndarray, limit: int = TEXEL_LIMIT,
                 label: str = "texture") -> np.ndarray:
    """Box-filter ``px`` [H, W, C] down until H*W < limit (linear-space
    average — textures are already sRGB-decoded at this point)."""
    import warnings

    h0, w0 = px.shape[:2]
    while px.shape[0] * px.shape[1] >= limit:
        px = _mip_once(px.astype(np.float32, copy=False))
    if (h0, w0) != px.shape[:2]:
        warnings.warn(
            f"{label} is {w0}x{h0} (>= 2^24 texels, past exact float32 "
            f"addressing); box-mipped to {px.shape[1]}x{px.shape[0]}"
        )
    return px


# Texture slot order in FlatScene.mat_tex.
SLOT_NORMAL = 0
SLOT_ALBEDO = 1
SLOT_OPACITY = 2
SLOT_OCCLUSION = 3
SLOT_ROUGHNESS = 4
SLOT_METALLIC = 5
SLOT_EMISSIVE = 6

# Pack slots 0/1 are synthesized neutral textures so "no texture" becomes a
# multiply-by-identity gather instead of a branch:
#   0: white   (1,1,1,1) — albedo/opacity/rough/metal/emissive/occlusion no-op
#   1: flat normal (0.5,0.5,1,1) — decodes to (0,0,1) in tangent space
_N_DUMMY = 2


class FlatScene(NamedTuple):
    # Triangle soup (world space), padded to a lane multiple.
    tri_a: np.ndarray  # [N, 3]
    tri_e1: np.ndarray  # [N, 3]
    tri_e2: np.ndarray  # [N, 3]
    tri_valid: np.ndarray  # [N] bool
    # Per-triangle-vertex shading attributes (world space).
    n0: np.ndarray  # [N, 3] (normal-matrix applied, unnormalized)
    n1: np.ndarray
    n2: np.ndarray
    t0: np.ndarray  # [N, 3] tangents
    t1: np.ndarray
    t2: np.ndarray
    uv0: np.ndarray  # [N, 2]
    uv1: np.ndarray
    uv2: np.ndarray
    mat_id: np.ndarray  # [N] i32
    # Material table.
    mat_albedo: np.ndarray  # [M, 3]
    mat_opacity: np.ndarray  # [M]
    mat_roughness: np.ndarray  # [M]
    mat_metallic: np.ndarray  # [M]
    mat_emissive: np.ndarray  # [M, 3]
    mat_ior: np.ndarray  # [M]
    mat_shadow_catcher: np.ndarray  # [M] f32 {0,1}
    mat_tex: np.ndarray  # [M, 7] i32 into texture pack
    # Texture pack (flat texel buffer + per-texture geometry).
    tex_texels: np.ndarray  # [K, 4] f32 linear RGBA
    tex_offset: np.ndarray  # [T] i32
    tex_width: np.ndarray  # [T] i32
    tex_height: np.ndarray  # [T] i32
    # Camera.
    cam_origin: np.ndarray  # [3]
    cam_basis: np.ndarray  # [3, 3]
    cam_tan_half_fov: np.ndarray  # scalar
    # Sun (zeros when absent; presence is static in SceneStatic).
    sun_dir: np.ndarray  # [3] toward the sun
    sun_energy: np.ndarray  # [3]
    sun_angular_radius: np.ndarray  # scalar
    # Flattened stackless BVH (dummy 1-node arrays until ptx.accel.build_bvh
    # attaches the real thing; presence is SceneStatic.n_bvh_nodes > 0).
    # Packed per-triangle shading attributes: ONE gather resolves a hit.
    # Columns: n0(3) n1(3) n2(3) t0(3) t1(3) t2(3) uv0(2) uv1(2) uv2(2)
    # mat_id(1) tri_a(3) tri_e1(3) tri_e2(3) pad -> 40.  (Row gathers cost
    # ~1.4 ms per gather op at 131k indices regardless of width, so the
    # vertex data rides along instead of three extra gathers.)
    tri_attrs: np.ndarray = np.zeros((1, 40), np.float32)  # [N, 40]
    # Packed material factors: albedo(3) opacity rough metal emissive(3)
    # ior catcher pad -> 16.  (Texture slots stay in mat_tex.)
    mat_packed: np.ndarray = np.zeros((1, 16), np.float32)  # [M, 16]
    bvh_min: np.ndarray = np.zeros((1, 3), np.float32)  # [Nn, 3]
    bvh_max: np.ndarray = np.zeros((1, 3), np.float32)  # [Nn, 3]
    bvh_first: np.ndarray = np.zeros(1, np.int32)  # [Nn] leaf first tri
    bvh_count: np.ndarray = np.zeros(1, np.int32)  # [Nn] leaf size (0=interior)
    bvh_miss: np.ndarray = np.full(1, -1, np.int32)  # [Nn] escape link
    # Pre-packed Pallas traversal tiles (ptx.kernels.intersect_pallas
    # .pack_tris, attached by ptx.render.ensure_accel) so the 16-row
    # component repack runs once per scene, not twice per bounce inside the
    # jitted loop.  Empty (0-tile) until attached; the kernels fall back to
    # packing in-call (the scene-sharded path still does).
    ptiles: np.ndarray = np.zeros((0, 16, 1), np.float32)  # [n_tiles, 16, TT]
    pboxes: np.ndarray = np.zeros((0, 8), np.float32)  # [n_tiles, 8]


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    n_tris: int  # real (unpadded) triangle count
    n_tris_padded: int
    n_materials: int
    has_sun: bool
    has_textures: bool
    env_tex: int = -1  # texture-pack slot of an equirect env map, -1 = none
    has_translucent: bool = True  # any material can pass rays through
    n_bvh_nodes: int = 0  # 0 = no BVH attached
    bvh_leaf_size: int = 8
    # World-space scene bounds over valid triangles (ray-sorting morton grid
    # + dead-ray parking). Stored as plain tuples so SceneStatic stays
    # hashable / jit-closure-safe.
    aabb_lo: tuple = (0.0, 0.0, 0.0)
    aabb_hi: tuple = (1.0, 1.0, 1.0)
    # Static texture facts (gathers are the TPU bottleneck — every slot that
    # provably hits only dummy texels costs 4 pointless gathers per ray):
    # tex_slot_used[s]: any material has a real texture in slot s;
    # the two share flags record glTF's packing (opacity = baseColor alpha,
    # metallic-roughness one texture) so one bilinear fetch serves both.
    tex_slot_used: tuple = (True,) * 7
    opacity_shares_albedo: bool = False
    metallic_shares_roughness: bool = False
    # True only for the per-device view produced by
    # ptx.parallel.shard_scene.build_shard_scene: triangle/BVH arrays are
    # stacked shard-local chunks.  Guards against round 1's silent
    # wrong-image bug (a globally-built BVH sharded or replicated over
    # sharded triangles).
    shard_local: bool = False
    # > 0 only for the per-device view produced by
    # ptx.parallel.shard_scene.build_texture_shards: the texel pack is split
    # along the scene axis into tp bins of this many texels (whole textures
    # per bin); texel gathers mask to the local range and psum across tp
    # (ptx.scene.textures.sample_texture).
    tex_shard_len: int = 0


def flatten(
    scene: SceneData,
    pad_multiple: int = 256,
    base_dir: Optional[str] = None,
    env_image: Optional[np.ndarray] = None,
) -> tuple[FlatScene, SceneStatic]:
    """Bake ``SceneData`` -> (FlatScene, SceneStatic) numpy arrays (callers
    move them to device / shard them)."""
    tri_a, tri_e1, tri_e2 = [], [], []
    n0s, n1s, n2s, t0s, t1s, t2s = [], [], [], [], [], []
    uv0s, uv1s, uv2s, mids = [], [], [], []

    for prim in scene.primitives:
        basis = prim.world_basis
        origin = prim.world_origin
        normal_matrix = np.linalg.inv(basis).T.astype(np.float32)
        pos_w = prim.positions @ basis.T + origin
        nrm_w = prim.normals @ normal_matrix.T
        tan_w = prim.tangents[:, :3] @ normal_matrix.T
        idx = prim.indices.astype(np.int64)
        a, b, c = pos_w[idx[:, 0]], pos_w[idx[:, 1]], pos_w[idx[:, 2]]
        tri_a.append(a)
        tri_e1.append(b - a)
        tri_e2.append(c - a)
        n0s.append(nrm_w[idx[:, 0]])
        n1s.append(nrm_w[idx[:, 1]])
        n2s.append(nrm_w[idx[:, 2]])
        t0s.append(tan_w[idx[:, 0]])
        t1s.append(tan_w[idx[:, 1]])
        t2s.append(tan_w[idx[:, 2]])
        uv0s.append(prim.uvs[idx[:, 0]])
        uv1s.append(prim.uvs[idx[:, 1]])
        uv2s.append(prim.uvs[idx[:, 2]])
        mids.append(np.full(len(idx), prim.material, np.int32))

    def cat(parts, width):
        if parts:
            return np.ascontiguousarray(
                np.concatenate(parts).astype(np.float32, copy=False)
            ).reshape(-1, width)
        return np.zeros((0, width), np.float32)

    tri_a = cat(tri_a, 3)
    n = tri_a.shape[0]
    n_padded = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)

    def pad3(x, width=3):
        x = cat([x] if isinstance(x, np.ndarray) else x, width)
        out = np.zeros((n_padded, width), np.float32)
        out[:n] = x
        return out

    flat = dict(
        tri_a=pad3([tri_a]),
        tri_e1=pad3(tri_e1),
        tri_e2=pad3(tri_e2),
        n0=pad3(n0s),
        n1=pad3(n1s),
        n2=pad3(n2s),
        t0=pad3(t0s),
        t1=pad3(t1s),
        t2=pad3(t2s),
        uv0=pad3(uv0s, 2),
        uv1=pad3(uv1s, 2),
        uv2=pad3(uv2s, 2),
    )
    mat_id = np.zeros(n_padded, np.int32)
    if n:
        mat_id[:n] = np.concatenate(mids)
    tri_valid = np.arange(n_padded) < n

    # --- materials ----------------------------------------------------------
    mats = scene.materials
    m = len(mats)
    mat_tex = np.zeros((m, 7), np.int32)

    # Texture pack: dummies first, then each *used* image once.
    image_to_slot = {}
    used_images = sorted(
        {
            t
            for mat in mats
            for t in (
                mat.normal_tex,
                mat.albedo_tex,
                mat.opacity_tex,
                mat.occlusion_tex,
                mat.roughness_tex,
                mat.metallic_tex,
                mat.emissive_tex,
            )
            if t >= 0
        }
    )
    texel_parts = [
        np.array([[1.0, 1.0, 1.0, 1.0]], np.float32),  # slot 0: white
        np.array([[0.5, 0.5, 1.0, 1.0]], np.float32),  # slot 1: flat normal
    ]
    widths, heights, offsets = [1, 1], [1, 1], [0, 1]
    cursor = 2
    for img_idx in used_images:
        img = scene.images[img_idx]
        pixels = img.pixels
        if pixels is None and base_dir is not None:
            pixels = decode_image(img, base_dir)
        if pixels is None:
            raise ValueError(f"texture {img.uri} not decoded")
        pixels = mip_to_limit(pixels, label=f"texture {img.uri!r}")
        h, w = pixels.shape[:2]
        image_to_slot[img_idx] = len(widths)
        widths.append(w)
        heights.append(h)
        offsets.append(cursor)
        texel_parts.append(pixels.reshape(-1, 4).astype(np.float32, copy=False))
        cursor += w * h

    env_tex = -1
    if env_image is not None:
        env_image = mip_to_limit(env_image, label="environment map")
        h, w = env_image.shape[:2]
        env_tex = len(widths)
        widths.append(w)
        heights.append(h)
        offsets.append(cursor)
        if env_image.shape[-1] == 3:
            env_image = np.concatenate(
                [env_image, np.ones((*env_image.shape[:2], 1), np.float32)], -1
            )
        texel_parts.append(env_image.reshape(-1, 4).astype(np.float32, copy=False))
        cursor += w * h

    def slot(img_idx, is_normal=False):
        if img_idx < 0:
            return 1 if is_normal else 0
        return image_to_slot[img_idx]

    for i, mat in enumerate(mats):
        mat_tex[i] = [
            slot(mat.normal_tex, is_normal=True),
            slot(mat.albedo_tex),
            slot(mat.opacity_tex),
            slot(mat.occlusion_tex),
            slot(mat.roughness_tex),
            slot(mat.metallic_tex),
            slot(mat.emissive_tex),
        ]

    # Texture addressing: the *within-texture* index runs in float32 (exact
    # integers < 2^24), pack offsets stay int32 — see ptx/scene/textures.py.
    # The limit is per texture, not per pack (sponza-new's real texture set
    # packs 68M texels and must flatten single-chip); mip_to_limit above
    # guarantees it, so this is an internal invariant.
    biggest = max((w * h for w, h in zip(widths, heights)), default=0)
    assert biggest < TEXEL_LIMIT, biggest
    if cursor >= (1 << 31):
        raise ValueError(
            f"texture pack has {cursor} texels; int32 addressing overflows"
        )

    sun = scene.sun
    mat_packed = np.zeros((m, 16), np.float32)
    mat_packed[:, 0:3] = [mm.albedo for mm in mats]
    mat_packed[:, 3] = [mm.opacity for mm in mats]
    mat_packed[:, 4] = [mm.roughness for mm in mats]
    mat_packed[:, 5] = [mm.metallic for mm in mats]
    mat_packed[:, 6:9] = [mm.emissive for mm in mats]
    mat_packed[:, 9] = [mm.ior for mm in mats]
    mat_packed[:, 10] = [1.0 if mm.shadow_catcher else 0.0 for mm in mats]

    # One packed row per triangle: EVERYTHING a hit resolution needs in a
    # SINGLE gather.  TPU row gathers cost ~1.4 ms per gather *op* at 131k
    # indices regardless of row width (3..48 floats measured identical), so
    # the winner-triangle vertices ride along in rows 25-33: the closest-hit
    # epilogue's four gathers (tri_a/e1/e2 + attrs) collapse to one.
    tri_attrs = np.zeros((n_padded, 40), np.float32)
    tri_attrs[:, 0:3] = flat["n0"]
    tri_attrs[:, 3:6] = flat["n1"]
    tri_attrs[:, 6:9] = flat["n2"]
    tri_attrs[:, 9:12] = flat["t0"]
    tri_attrs[:, 12:15] = flat["t1"]
    tri_attrs[:, 15:18] = flat["t2"]
    tri_attrs[:, 18:20] = flat["uv0"]
    tri_attrs[:, 20:22] = flat["uv1"]
    tri_attrs[:, 22:24] = flat["uv2"]
    tri_attrs[:, 24] = mat_id.astype(np.float32)
    tri_attrs[:, 25:28] = flat["tri_a"]
    tri_attrs[:, 28:31] = flat["tri_e1"]
    tri_attrs[:, 31:34] = flat["tri_e2"]

    fs = FlatScene(
        tri_attrs=tri_attrs,
        mat_packed=mat_packed,
        tri_valid=tri_valid,
        mat_id=mat_id,
        mat_albedo=np.asarray([mm.albedo for mm in mats], np.float32),
        mat_opacity=np.asarray([mm.opacity for mm in mats], np.float32),
        mat_roughness=np.asarray([mm.roughness for mm in mats], np.float32),
        mat_metallic=np.asarray([mm.metallic for mm in mats], np.float32),
        mat_emissive=np.asarray([mm.emissive for mm in mats], np.float32),
        mat_ior=np.asarray([mm.ior for mm in mats], np.float32),
        mat_shadow_catcher=np.asarray(
            [1.0 if mm.shadow_catcher else 0.0 for mm in mats], np.float32
        ),
        mat_tex=mat_tex,
        tex_texels=np.concatenate(texel_parts, axis=0),
        tex_offset=np.asarray(offsets, np.int32),
        tex_width=np.asarray(widths, np.int32),
        tex_height=np.asarray(heights, np.int32),
        cam_origin=scene.camera.world_origin,
        cam_basis=scene.camera.world_basis,
        cam_tan_half_fov=np.float32(np.tan(scene.camera.yfov * 0.5)),
        sun_dir=(sun.direction if sun else np.zeros(3, np.float32)),
        sun_energy=(sun.energy if sun else np.zeros(3, np.float32)),
        sun_angular_radius=np.float32(sun.angular_radius if sun else 0.0),
        **flat,
    )
    has_translucent = any(
        mm.opacity < 1.0 - 1e-4 or mm.opacity_tex >= 0 for mm in mats
    )
    if n:
        a = flat["tri_a"][:n]
        b = a + flat["tri_e1"][:n]
        c = a + flat["tri_e2"][:n]
        lo = np.minimum(np.minimum(a, b), c).min(axis=0)
        hi = np.maximum(np.maximum(a, b), c).max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    dummy = np.array([1, 0, 0, 0, 0, 0, 0], np.int32)  # per-slot neutral id
    slot_used = tuple(
        bool((mat_tex[:, s] != dummy[s]).any()) for s in range(7)
    ) if m else (False,) * 7
    # Opacity rides baseColor's alpha for non-opaque materials and the white
    # dummy otherwise (gltf loader parity, load_gltf.cpp:291-296) — when that
    # invariant holds for EVERY material, the albedo sample plus a per-ray
    # slot compare reconstructs the opacity sample with zero extra gathers.
    share_op = bool(m) and bool(
        (
            (mat_tex[:, SLOT_OPACITY] == mat_tex[:, SLOT_ALBEDO])
            | (mat_tex[:, SLOT_OPACITY] == 0)
        ).all()
    )
    share_mr = bool(m) and bool(
        (mat_tex[:, SLOT_METALLIC] == mat_tex[:, SLOT_ROUGHNESS]).all()
    )
    static = SceneStatic(
        n_tris=n,
        n_tris_padded=n_padded,
        n_materials=m,
        has_sun=sun is not None,
        has_textures=len(used_images) > 0,
        env_tex=env_tex,
        has_translucent=has_translucent,
        aabb_lo=tuple(float(v) for v in lo),
        aabb_hi=tuple(float(v) for v in hi),
        tex_slot_used=slot_used,
        opacity_shares_albedo=share_op,
        metallic_shares_roughness=share_mr,
    )
    return fs, static


def apply_emissive_strength(fs: FlatScene, scene: SceneData) -> FlatScene:
    """Fold KHR emissive_strength into the emissive factors (physical mode —
    the reference ignores the extension and uses its x10 debug multiplier
    instead, ``shading_worker.cpp:50``).  Updates BOTH mat_emissive and its
    mirror in the packed factor row (material_lookup reads the row)."""
    strengths = np.asarray(
        [m.emissive_strength for m in scene.materials], np.float32
    )[:, None]
    packed = np.array(fs.mat_packed)
    packed[:, 6:9] = packed[:, 6:9] * strengths
    return fs._replace(
        mat_emissive=fs.mat_emissive * strengths, mat_packed=packed
    )
