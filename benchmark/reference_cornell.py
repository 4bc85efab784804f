"""The plain reference of the ``cornell`` configuration: the published
Cornell Box (Cornell University Program of Computer Graphics, "Cornell
Box Data", https://www.graphics.cornell.edu/online/box/data.html) built
from its own table, shaded by ``benchmark/reference.py``.

:data:`QUADS` is the published table, in millimetres: the floor, the
ceiling, the back, right and left walls, the light, and the five faces of
each block, 16 quads and 32 triangles.  :func:`arrays` turns it into the
reference's scene arrays, and ``benchmark/make_cornell.py`` writes the
configuration's glTF from the same arrays, so the glTF is the one input
both sides share: the reference never reads what the program flattened.

What the published data leaves open, set here (and listed under the
configuration's ``assumed``):

* units: metres (the millimetres / 1000), as glTF requires; at millimetre
  scale the 1e-4 ray offset is about one float32 ulp at 500, and paths
  would hit their own surface;
* reflectances: the published spectra's usual RGB reduction (white 0.73,
  red (0.63, 0.065, 0.05), green (0.14, 0.45, 0.091)); the light's
  reflectance 0.78 (the published data gives none); metallic 0, roughness 1;
* the light's emission: the usual RGB reduction of its spectrum (18.387,
  13.987, 6.754) over its largest channel, an ``emissiveFactor`` of at
  most 1 under the upstream worker's emission x10;
* the light sits :data:`LIGHT_DROP_MM` below the coplanar ceiling, so the
  two never tie for a closest hit;
* one normal per quad, facing into the room: the cross product of its
  diagonals, turned toward the room's centre for a wall and away from the
  block's centre for a block face;
* no sun: the upstream's white environment on a miss is the only light
  besides the emitter, seen through the open front.

:func:`load` returns ``(scene tensors, BVH)`` as ``reference.load`` does,
with ``sun_energy`` zero: the sun's term of ``reference.trace_paths`` is
then exactly 0, and the counter RNG keeps every other draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference as ref

# Name, glTF baseColorFactor (RGB), emissiveFactor; metallic 0, roughness 1.
MATERIALS = (
    ("white", (0.73, 0.73, 0.73), (0.0, 0.0, 0.0)),
    ("red", (0.63, 0.065, 0.05), (0.0, 0.0, 0.0)),
    ("green", (0.14, 0.45, 0.091), (0.0, 0.0, 0.0)),
    ("light", (0.78, 0.78, 0.78), (1.0, 13.987 / 18.387, 6.754 / 18.387)),
)
WHITE, RED, GREEN, LIGHT = range(4)
LIGHT_DROP_MM = 0.5

# The published table: (object, material, four corners in millimetres).
QUADS = (
    ("floor", WHITE, ((552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
                      (549.6, 0.0, 559.2))),
    ("ceiling", WHITE, ((556.0, 548.8, 0.0), (556.0, 548.8, 559.2),
                        (0.0, 548.8, 559.2), (0.0, 548.8, 0.0))),
    ("back_wall", WHITE, ((549.6, 0.0, 559.2), (0.0, 0.0, 559.2),
                          (0.0, 548.8, 559.2), (556.0, 548.8, 559.2))),
    ("right_wall", GREEN, ((0.0, 0.0, 559.2), (0.0, 0.0, 0.0),
                           (0.0, 548.8, 0.0), (0.0, 548.8, 559.2))),
    ("left_wall", RED, ((552.8, 0.0, 0.0), (549.6, 0.0, 559.2),
                        (556.0, 548.8, 559.2), (556.0, 548.8, 0.0))),
    ("light", LIGHT, ((343.0, 548.8, 227.0), (343.0, 548.8, 332.0),
                      (213.0, 548.8, 332.0), (213.0, 548.8, 227.0))),
    ("short_block", WHITE, ((130.0, 165.0, 65.0), (82.0, 165.0, 225.0),
                            (240.0, 165.0, 272.0), (290.0, 165.0, 114.0))),
    ("short_block", WHITE, ((290.0, 0.0, 114.0), (290.0, 165.0, 114.0),
                            (240.0, 165.0, 272.0), (240.0, 0.0, 272.0))),
    ("short_block", WHITE, ((130.0, 0.0, 65.0), (130.0, 165.0, 65.0),
                            (290.0, 165.0, 114.0), (290.0, 0.0, 114.0))),
    ("short_block", WHITE, ((82.0, 0.0, 225.0), (82.0, 165.0, 225.0),
                            (130.0, 165.0, 65.0), (130.0, 0.0, 65.0))),
    ("short_block", WHITE, ((240.0, 0.0, 272.0), (240.0, 165.0, 272.0),
                            (82.0, 165.0, 225.0), (82.0, 0.0, 225.0))),
    ("tall_block", WHITE, ((423.0, 330.0, 247.0), (265.0, 330.0, 296.0),
                           (314.0, 330.0, 456.0), (472.0, 330.0, 406.0))),
    ("tall_block", WHITE, ((423.0, 0.0, 247.0), (423.0, 330.0, 247.0),
                           (472.0, 330.0, 406.0), (472.0, 0.0, 406.0))),
    ("tall_block", WHITE, ((472.0, 0.0, 406.0), (472.0, 330.0, 406.0),
                           (314.0, 330.0, 456.0), (314.0, 0.0, 456.0))),
    ("tall_block", WHITE, ((314.0, 0.0, 456.0), (314.0, 330.0, 456.0),
                           (265.0, 330.0, 296.0), (265.0, 0.0, 296.0))),
    ("tall_block", WHITE, ((265.0, 0.0, 296.0), (265.0, 330.0, 296.0),
                           (423.0, 330.0, 247.0), (423.0, 0.0, 247.0))),
)
# The room's centre (a wall's normal faces it).
ROOM_CENTRE_MM = (278.0, 274.4, 279.6)

# The camera: at (278, 273, -800) mm looking along +z with +y up, a 35 mm
# pinhole distance over a 25 mm square film.
CAMERA_MM = (278.0, 273.0, -800.0)
YFOV = 2.0 * math.atan(12.5 / 35.0)
# The glTF node's rotation ([x, y, z, w]): half a turn about +y, so the
# camera's -z looks along the world's +z.
CAMERA_ROTATION = (0.0, 1.0, 0.0, 0.0)
CAMERA_BASIS = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))


def _corners_mm(name: str, corners):
    """A quad's corners, the light's dropped below the ceiling."""
    c = np.asarray(corners, np.float64)
    if name == "light":
        c[:, 1] -= LIGHT_DROP_MM
    return c


def _normal(name: str, c: np.ndarray, centre) -> np.ndarray:
    """The quad's unit normal (float64): the cross product of its
    diagonals, facing ``centre`` for a wall and away from it for a
    block face."""
    d1, d2 = c[2] - c[0], c[3] - c[1]
    n = np.array([d1[1] * d2[2] - d1[2] * d2[1],
                  d1[2] * d2[0] - d1[0] * d2[2],
                  d1[0] * d2[1] - d1[1] * d2[0]])
    n = n / math.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    towards = float(np.dot(n, np.asarray(centre) - c.mean(0)))
    block = name.endswith("_block")
    return -n if (towards < 0) != block else n


def quads() -> list:
    """Per quad ``(object, material, corners [4, 3] float32 metres,
    normal [3] float32)``, in the table's order."""
    blocks = {}
    for name, _, corners in QUADS:
        if name.endswith("_block"):
            blocks.setdefault(name, []).append(np.asarray(corners))
    centres = {k: np.concatenate(v).mean(0) for k, v in blocks.items()}
    out = []
    for name, mat, corners in QUADS:
        c = _corners_mm(name, corners)
        n = _normal(name, c, centres.get(name, ROOM_CENTRE_MM))
        # + 0 turns -0 into +0, as the program's world transform does.
        out.append((name, mat, (c / 1000.0).astype(np.float32),
                    n.astype(np.float32) + np.float32(0.0)))
    return out


def arrays() -> dict:
    """The Cornell Box as the reference's flat float32 arrays (the keys of
    ``reference.scene_arrays``): two triangles per quad, (0, 1, 2) and
    (0, 2, 3), each vertex carrying its quad's normal."""
    a, e1, e2, nrm, mat = [], [], [], [], []
    for _, m, c, n in quads():
        for i, j, k in ((0, 1, 2), (0, 2, 3)):
            a.append(c[i])
            e1.append(c[j] - c[i])
            e2.append(c[k] - c[i])
            nrm.append(n)
            mat.append(m)
    nrm = np.stack(nrm)
    return dict(
        a=np.stack(a), e1=np.stack(e1), e2=np.stack(e2),
        n0=nrm, n1=nrm.copy(), n2=nrm.copy(),
        mat=np.asarray(mat, np.int64),
        albedo=np.asarray([m[1] for m in MATERIALS], np.float32),
        roughness=np.ones(len(MATERIALS), np.float32),
        metallic=np.zeros(len(MATERIALS), np.float32),
        emissive=np.asarray([m[2] for m in MATERIALS], np.float32),
        ior=np.full(len(MATERIALS), 1.33, np.float32),
        opacity=np.ones(len(MATERIALS), np.float32),
        shadow_catcher=np.zeros(len(MATERIALS), np.float32),
        textured=False,
        cam_origin=(np.asarray(CAMERA_MM) / 1000.0).astype(np.float32),
        cam_basis=np.asarray(CAMERA_BASIS, np.float32).T.copy(),
        tan_half_fov=np.float32(np.tan(YFOV * 0.5)),
        # No sun: its energy is zero, so its term adds exactly nothing.
        sun_dir=np.array([0.0, 1.0, 0.0], np.float32),
        sun_energy=np.zeros(3, np.float32),
        sun_radius=np.float32(0.004732),
    )


def load(spec: str, device) -> tuple:
    """``(scene tensors, BVH)`` of the Cornell Box on ``device``, built
    from :data:`QUADS` (``spec``, the configuration's glTF path, is not
    read).  Float32 matrix products stay out of TF32."""
    del spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arr = arrays()
    bvh = ref.build_bvh(arr["a"], arr["e1"], arr["e2"], device)
    sc = {k: torch.as_tensor(v, device=device) for k, v in arr.items()
          if isinstance(v, (np.ndarray, np.generic))}
    return sc, bvh
