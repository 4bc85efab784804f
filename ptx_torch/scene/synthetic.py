"""Synthetic scene generation for benchmarks and BVH stress tests.

The reference's de-facto regression corpus is its bundled glTF scenes
(SURVEY.md §4); the largest one (sponza-new, ~262k tris) ships *without* its
geometry buffer, so the tree-traversal stress configs (BASELINE.md #3/#5:
~100k-1M triangles) are served by deterministic procedural scenes instead:
a grid of displaced, randomly-oriented triangle clusters inside an emissive
-lit box, with a camera that sees most of it.

The port's own copy of ``ptx/scene/synthetic.py``: only the imports differ, so both
packages build bit-identical arrays (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import numpy as np

from ptx_torch.scene.gltf import CameraData, MaterialData, PrimitiveData, SceneData


def make_tri_soup(
    n_tris: int,
    seed: int = 0,
    extent: float = 10.0,
    tri_size: float = 0.15,
) -> SceneData:
    """Deterministic triangle soup of ``n_tris`` triangles in a cube of
    half-width ``extent``, lit by an emissive ceiling quad, viewed from
    +Z.  Materials cycle through diffuse / rough-metal / emissive."""
    rng = np.random.default_rng(seed)

    centers = rng.uniform(-extent, extent, (n_tris, 3)).astype(np.float32)
    a = centers + rng.normal(0, tri_size, (n_tris, 3)).astype(np.float32)
    b = centers + rng.normal(0, tri_size, (n_tris, 3)).astype(np.float32)
    c = centers + rng.normal(0, tri_size, (n_tris, 3)).astype(np.float32)

    positions = np.concatenate([a, b, c]).astype(np.float32)
    indices = np.arange(3 * n_tris, dtype=np.uint32).reshape(3, n_tris).T
    # Geometric normals, per vertex.
    gn = np.cross(b - a, c - a)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
    normals = np.concatenate([gn, gn, gn]).astype(np.float32)
    uvs = np.zeros((3 * n_tris, 2), np.float32)
    tangents = np.zeros((3 * n_tris, 4), np.float32)
    tangents[:, 0] = 1.0
    tangents[:, 3] = 1.0

    mat_ids = rng.integers(0, 3, n_tris)
    prims = []
    for m in range(3):
        sel = np.where(mat_ids == m)[0]
        if sel.size == 0:
            continue
        prims.append(
            PrimitiveData(
                mesh_name=f"soup{m}",
                prim_index=0,
                positions=positions,
                normals=normals,
                uvs=uvs,
                tangents=tangents,
                indices=indices[sel].astype(np.uint32),
                material=m,
                world_basis=np.eye(3, dtype=np.float32),
                world_origin=np.zeros(3, np.float32),
            )
        )

    materials = [
        MaterialData(name="diffuse", albedo=(0.7, 0.7, 0.7), roughness=0.7,
                     metallic=0.0, emissive=(0.0, 0.0, 0.0)),
        MaterialData(name="metal", albedo=(0.9, 0.8, 0.6), roughness=0.2,
                     metallic=1.0, emissive=(0.0, 0.0, 0.0)),
        MaterialData(name="glow", albedo=(0.8, 0.8, 0.8), roughness=0.5,
                     metallic=0.0, emissive=(0.3, 0.25, 0.2)),
    ]

    camera = CameraData(
        yfov=0.8,
        world_basis=np.eye(3, dtype=np.float32),
        world_origin=np.array([0.0, 0.0, extent * 2.2], np.float32),
    )
    return SceneData(
        primitives=prims,
        materials=materials,
        images=[],
        camera=camera,
        sun=None,
        mesh_primitive_counts={p.mesh_name: 1 for p in prims},
    )


def load_synthetic(spec: str):
    """Parse ``synthetic:<n_tris>[:seed]`` -> flattened scene arrays (host)."""
    from ptx_torch.scene.flatten import flatten

    parts = spec.split(":")
    n_tris = int(parts[1])
    seed = int(parts[2]) if len(parts) > 2 else 0
    scene = make_tri_soup(n_tris, seed=seed)
    return flatten(scene)


def _checker(h: int, w: int, c0, c1) -> np.ndarray:
    img = np.empty((h, w, 4), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((yy // 2 + xx // 2) % 2).astype(bool)
    img[mask] = c1
    img[~mask] = c0
    return img


def make_textured_quads(n_textures: int = 3) -> SceneData:
    """A fan of textured quads facing the camera, each with its own
    checkerboard albedo (distinct sizes so texture binning is non-trivial),
    lit by an emissive backdrop — the deterministic textured-scene fixture
    for the texture-sharding paths (``ptx.parallel.shard_scene``)."""
    from ptx_torch.scene.gltf import ImageData

    prims, materials, images = [], [], []

    def quad(z, half, cx, mesh, mat):
        positions = np.array(
            [[cx - half, -half, z], [cx + half, -half, z],
             [cx + half, half, z], [cx - half, half, z]], np.float32
        )
        normals = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        tangents = np.zeros((4, 4), np.float32)
        tangents[:, 0] = 1.0
        tangents[:, 3] = 1.0
        indices = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
        return PrimitiveData(
            mesh_name=mesh, prim_index=0, positions=positions,
            normals=normals, uvs=uvs, tangents=tangents, indices=indices,
            material=mat, world_basis=np.eye(3, dtype=np.float32),
            world_origin=np.zeros(3, np.float32),
        )

    span = 3.0
    for i in range(n_textures):
        size = 4 * (i + 1)  # 4x4, 8x8, 12x12 ... distinct byte sizes
        col0 = np.array([1.0, 0.2 * i, 0.1, 1.0], np.float32)
        col1 = np.array([0.1, 1.0 - 0.2 * i, 0.9, 1.0], np.float32)
        images.append(ImageData(uri=f"checker{i}", srgb=False,
                                pixels=_checker(size, size, col0, col1)))
        materials.append(MaterialData(
            name=f"tex{i}", albedo=(1.0, 1.0, 1.0), opacity=1.0,
            roughness=1.0, metallic=0.0, emissive=(0.0, 0.0, 0.0),
            albedo_tex=i,
        ))
        cx = -span + 2 * span * i / max(n_textures - 1, 1)
        prims.append(quad(-2.0, 0.9, cx, f"quad{i}", i))

    materials.append(MaterialData(
        name="glow", albedo=(0.0, 0.0, 0.0), opacity=1.0, roughness=1.0,
        metallic=0.0, emissive=(1.0, 1.0, 1.0),
    ))
    prims.append(quad(-6.0, 20.0, 0.0, "backdrop", n_textures))

    camera = CameraData(
        yfov=1.2,
        world_basis=np.eye(3, dtype=np.float32),
        world_origin=np.array([0.0, 0.0, 3.0], np.float32),
    )
    return SceneData(
        primitives=prims, materials=materials, images=images, camera=camera,
        sun=None,
        mesh_primitive_counts={p.mesh_name: 1 for p in prims},
    )
