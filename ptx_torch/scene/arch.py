"""Deterministic *architectural* benchmark scene (VERDICT r4 #5).

The reference's default fixture is sponza — an atrium building — but its
geometry buffer is S3-only, so the repo's sponza-class rows previously ran
on jittered ribbon soup (``ptx.scene.standin``), whose spatial incoherence
is unlike real architecture and leaves the BVH-quality / tile-gate numbers
uncalibrated.  This module generates a sponza-like *structured* building:

* a courtyard floor, four perimeter walls with punched window openings,
* two colonnades of round columns on two storeys,
* balcony slabs between columns and walls (real interior occlusion),
* a roof ring with an open skylight so the tilted sun enters the atrium,

all tessellated into small coherent quads whose density is scaled to hit a
requested triangle budget.  Everything is analytic + seeded jitter-free:
the same spec string always produces bit-identical geometry.

Load with ``arch:<n_tris>`` (``ptx.render.load_scene``).

The port's own copy of ``ptx/scene/arch.py``: only the imports differ, so both
packages build bit-identical arrays (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ptx_torch.scene.gltf import (
    CameraData, MaterialData, PrimitiveData, SceneData, SunData,
)

# Courtyard proportions (metres), loosely sponza's atrium.
LENGTH = 30.0   # x
WIDTH = 12.0    # z
HEIGHT = 12.0   # y
STOREY = 4.0
COLS_PER_ROW = 10
COL_RADIUS = 0.45
SKYLIGHT = (0.7, 0.55)  # open fraction of the roof (x, z)


class _Builder:
    def __init__(self):
        self.pos: List[np.ndarray] = []
        self.idx: List[np.ndarray] = []
        self.nrm: List[np.ndarray] = []
        self.uv: List[np.ndarray] = []
        self.mat: List[np.ndarray] = []
        self._v = 0
        self.tris = 0

    def grid(self, origin, du, dv, nu, nv, normal, mat):
        """Tessellated parallelogram origin + u*du + v*dv, (nu x nv) quads."""
        nu, nv = max(int(nu), 1), max(int(nv), 1)
        u = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
        v = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
        uu, vv = np.meshgrid(u, v, indexing="ij")  # [nu+1, nv+1]
        p = (np.asarray(origin, np.float32)[None, None]
             + uu[..., None] * np.asarray(du, np.float32)
             + vv[..., None] * np.asarray(dv, np.float32))
        p = p.reshape(-1, 3)
        n_v = p.shape[0]
        i0 = (np.arange(nu)[:, None] * (nv + 1) + np.arange(nv)[None, :])
        i0 = i0.reshape(-1)
        quad = np.stack([i0, i0 + nv + 1, i0 + nv + 2, i0, i0 + nv + 2,
                         i0 + 1], axis=1).reshape(-1, 3)
        nrm = np.broadcast_to(
            np.asarray(normal, np.float32), (n_v, 3)
        ).copy()
        uvc = np.stack([uu, vv], axis=-1).reshape(-1, 2)
        self._push(p, quad, nrm, uvc, mat)

    def cylinder(self, center, radius, height, segs, rings, mat):
        """Open vertical cylinder (no caps), outward normals."""
        segs, rings = max(int(segs), 3), max(int(rings), 1)
        th = np.linspace(0.0, 2 * np.pi, segs + 1, dtype=np.float32)
        y = np.linspace(0.0, height, rings + 1, dtype=np.float32)
        tt, yy = np.meshgrid(th, y, indexing="ij")  # [segs+1, rings+1]
        cx, cy, cz = center
        p = np.stack([cx + radius * np.cos(tt), cy + yy,
                      cz + radius * np.sin(tt)], axis=-1).reshape(-1, 3)
        n = np.stack([np.cos(tt), np.zeros_like(tt), np.sin(tt)],
                     axis=-1).reshape(-1, 3)
        i0 = (np.arange(segs)[:, None] * (rings + 1)
              + np.arange(rings)[None, :]).reshape(-1)
        quad = np.stack([i0, i0 + rings + 1, i0 + rings + 2, i0,
                         i0 + rings + 2, i0 + 1], axis=1).reshape(-1, 3)
        uvc = np.stack([tt / (2 * np.pi), yy / max(height, 1e-6)],
                       axis=-1).reshape(-1, 2)
        self._push(p.astype(np.float32), quad, n.astype(np.float32),
                   uvc.astype(np.float32), mat)

    def _push(self, p, tri, n, uv, mat):
        self.pos.append(p)
        self.idx.append((tri + self._v).astype(np.uint32))
        self.nrm.append(n)
        self.uv.append(uv)
        self.mat.append(np.full(tri.shape[0], mat, np.int32))
        self._v += p.shape[0]
        self.tris += tri.shape[0]


def _walls(b: _Builder, d: float, mat: int):
    """Perimeter walls with two storeys of punched window openings, built
    as tessellated panels between the openings (the openings are real holes
    — light passes through them)."""
    hx, hz = LENGTH / 2, WIDTH / 2
    n_win = 8
    seg_w = LENGTH / n_win
    for side, z, nz in ((0, -hz, 1.0), (1, hz, -1.0)):
        for storey in range(3):
            y0 = storey * STOREY
            # Window: centered hole per segment on storeys 1-2; solid base.
            if storey == 0:
                b.grid((-hx, y0, z), (LENGTH, 0, 0), (0, STOREY, 0),
                       LENGTH * d, STOREY * d, (0, 0, nz), mat)
                continue
            wy0, wy1 = 1.2, 3.0  # window band within the storey
            for k in range(n_win):
                x0 = -hx + k * seg_w
                wx0, wx1 = x0 + 0.6, x0 + seg_w - 0.6
                # below band, above band, left pier, right pier
                b.grid((x0, y0, z), (seg_w, 0, 0), (0, wy0, 0),
                       seg_w * d, wy0 * d, (0, 0, nz), mat)
                b.grid((x0, y0 + wy1, z), (seg_w, 0, 0),
                       (0, STOREY - wy1, 0),
                       seg_w * d, (STOREY - wy1) * d, (0, 0, nz), mat)
                b.grid((x0, y0 + wy0, z), (0.6, 0, 0), (0, wy1 - wy0, 0),
                       0.6 * d, (wy1 - wy0) * d, (0, 0, nz), mat)
                b.grid((wx1, y0 + wy0, z), (0.6, 0, 0), (0, wy1 - wy0, 0),
                       0.6 * d, (wy1 - wy0) * d, (0, 0, nz), mat)
    # End walls (solid).
    for x, nx in ((-hx, 1.0), (hx, -1.0)):
        b.grid((x, 0, -hz), (0, 0, WIDTH), (0, HEIGHT, 0),
               WIDTH * d, HEIGHT * d, (nx, 0, 0), mat)


def make_arch_scene(n_tris: int = 300_000, seed: int = 0) -> SceneData:
    """Build the courtyard at a tessellation density targeting ``n_tris``.

    ``seed`` is accepted for interface parity but unused — the scene is
    fully deterministic by construction."""
    del seed
    # Estimate surface area driving the quad count, then solve density so
    # total tris ~= n_tris:  tris ~= 2 * area * d^2  (+ columns, which
    # tessellate by (segs x rings) ~ area * d^2 as well).
    hx, hz = LENGTH / 2, WIDTH / 2
    area = (
        LENGTH * WIDTH * 2                      # floor + roof
        + 2 * LENGTH * HEIGHT * 0.8             # long walls minus openings
        + 2 * WIDTH * HEIGHT                    # end walls
        + 2 * COLS_PER_ROW * 2                  # columns (2 storeys)
        * (2 * math.pi * COL_RADIUS * STOREY)
        + 2 * (LENGTH * 2.0) * 2                # balcony slabs, both faces
    )
    d = math.sqrt(n_tris / (2.0 * area))  # grid steps per metre

    b = _Builder()
    MAT_FLOOR, MAT_WALL, MAT_COL, MAT_SLAB = 0, 1, 2, 3
    # Floor.
    b.grid((-hx, 0, -hz), (LENGTH, 0, 0), (0, 0, WIDTH),
           LENGTH * d, WIDTH * d, (0, 1, 0), MAT_FLOOR)
    _walls(b, d, MAT_WALL)
    # Roof ring with open skylight (sun enters through the hole).
    sx, sz = SKYLIGHT[0] * LENGTH, SKYLIGHT[1] * WIDTH
    rim_x, rim_z = (LENGTH - sx) / 2, (WIDTH - sz) / 2
    y = HEIGHT
    b.grid((-hx, y, -hz), (LENGTH, 0, 0), (0, 0, rim_z),
           LENGTH * d, rim_z * d, (0, -1, 0), MAT_WALL)
    b.grid((-hx, y, hz - rim_z), (LENGTH, 0, 0), (0, 0, rim_z),
           LENGTH * d, rim_z * d, (0, -1, 0), MAT_WALL)
    b.grid((-hx, y, -hz + rim_z), (rim_x, 0, 0), (0, 0, sz),
           rim_x * d, sz * d, (0, -1, 0), MAT_WALL)
    b.grid((hx - rim_x, y, -hz + rim_z), (rim_x, 0, 0), (0, 0, sz),
           rim_x * d, sz * d, (0, -1, 0), MAT_WALL)
    # Colonnades: two rows x two storeys.
    col_z = WIDTH / 2 - 2.2
    segs = max(int(2 * math.pi * COL_RADIUS * d), 12)
    rings = max(int(STOREY * d), 4)
    for zrow in (-col_z, col_z):
        for k in range(COLS_PER_ROW):
            x = -hx + (k + 0.5) * LENGTH / COLS_PER_ROW
            for storey in range(2):
                b.cylinder((x, storey * STOREY, zrow), COL_RADIUS, STOREY,
                           segs, rings, MAT_COL)
    # Balcony slabs (between colonnade and wall) at storey 1, both rows,
    # tessellated both faces — interior occluders above the walkway.
    slab_w = hz - col_z
    for zrow, z0 in ((-1, -hz), (1, col_z)):
        for ny in (1.0, -1.0):
            y_s = STOREY + (0.0 if ny > 0 else -0.25)
            b.grid((-hx, y_s, z0), (LENGTH, 0, 0), (0, 0, slab_w),
                   LENGTH * d, slab_w * d, (0, ny, 0), MAT_SLAB)

    positions = np.concatenate(b.pos).astype(np.float32)
    indices = np.concatenate(b.idx)
    normals = np.concatenate(b.nrm).astype(np.float32)
    uvs = np.concatenate(b.uv).astype(np.float32)
    mats = np.concatenate(b.mat)
    tangents = np.zeros((positions.shape[0], 4), np.float32)
    tangents[:, 0] = 1.0
    tangents[:, 3] = 1.0

    prims = []
    for m in range(4):
        sel = np.where(mats == m)[0]
        if sel.size == 0:
            continue
        prims.append(PrimitiveData(
            mesh_name=f"arch{m}", prim_index=0, positions=positions,
            normals=normals, uvs=uvs, tangents=tangents,
            indices=indices[sel], material=m,
            world_basis=np.eye(3, dtype=np.float32),
            world_origin=np.zeros(3, np.float32),
        ))

    materials = [
        MaterialData(name="floor", albedo=(0.55, 0.5, 0.45), roughness=0.6,
                     metallic=0.0, emissive=(0.0, 0.0, 0.0)),
        MaterialData(name="plaster", albedo=(0.75, 0.7, 0.62), roughness=0.9,
                     metallic=0.0, emissive=(0.0, 0.0, 0.0)),
        MaterialData(name="column", albedo=(0.7, 0.68, 0.62), roughness=0.5,
                     metallic=0.0, emissive=(0.0, 0.0, 0.0)),
        MaterialData(name="slab", albedo=(0.6, 0.55, 0.5), roughness=0.8,
                     metallic=0.0, emissive=(0.0, 0.0, 0.0)),
    ]

    # Camera: inside the courtyard, looking down the colonnade (-x), the
    # classic sponza view.  Basis columns = (right, up, backward).
    fwd = np.array([-1.0, 0.0, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, up)
    basis = np.stack([right, up, -fwd], axis=1).astype(np.float32)
    camera = CameraData(
        yfov=1.0,
        world_basis=basis,
        world_origin=np.array([hx - 3.0, 1.8, 0.0], np.float32),
    )
    # Tilted afternoon sun slanting through the skylight.  fs.sun_dir /
    # SunData.direction points FROM the surface TOWARD the sun (the NEE
    # shadow-ray direction, wavefront.make_trace_fn), so it must have +y.
    sun_dir = np.array([-0.35, 0.85, -0.25], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sun = SunData(direction=sun_dir, energy=np.array([6.0, 5.6, 5.0],
                                                     np.float32))
    return SceneData(
        primitives=prims, materials=materials, images=[], camera=camera,
        sun=sun, mesh_primitive_counts={p.mesh_name: 1 for p in prims},
    )


def load_arch(spec: str):
    """Parse ``arch:<n_tris>`` -> flattened scene arrays (host)."""
    from ptx_torch.scene.flatten import flatten

    parts = spec.split(":")
    n_tris = int(parts[1]) if len(parts) > 1 else 300_000
    return flatten(make_arch_scene(n_tris))
