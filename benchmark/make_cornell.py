#!/usr/bin/env python3
"""Writes ``benchmark/data/cornell/cornell.gltf``, the ``cornell``
configuration's scene, from the published table in
``benchmark/reference_cornell.py``:

    python3 benchmark/make_cornell.py

One mesh per object of the table (one primitive each), its quads as four
vertices with the quad's normal and two triangles, in the table's order;
four metallic-roughness materials; one perspective camera node; the
buffer embedded as a data URI.  No ``KHR_lights_punctual``, so no sun.
The output is the same bytes on every run (``benchmark/tests`` holds the
committed file to it).
"""

from __future__ import annotations

import base64
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import reference_cornell as rc  # noqa: E402

PATH = os.path.join(ROOT, "benchmark", "data", "cornell", "cornell.gltf")
FLOAT, USHORT = 5126, 5123
ARRAY_BUFFER, ELEMENT_ARRAY_BUFFER = 34962, 34963


def _floats(values) -> list:
    """float32 values as the JSON numbers that read back as them."""
    return [float(np.float32(v)) for v in values]


def build() -> dict:
    """The glTF document."""
    objects = {}  # object -> [(material, corners, normal)], table order
    for name, mat, corners, normal in rc.quads():
        objects.setdefault(name, []).append((mat, corners, normal))
    pos, nrm, idx = [], [], []
    meshes, accessors = [], []
    n_vert = n_idx = 0
    for name, faces in objects.items():
        mats = {m for m, _, _ in faces}
        assert len(mats) == 1, name
        p = np.concatenate([c for _, c, _ in faces])
        n = np.concatenate([np.tile(v, (4, 1)) for _, _, v in faces])
        i = np.concatenate([np.array([0, 1, 2, 0, 2, 3]) + 4 * q
                            for q in range(len(faces))]).astype(np.uint16)
        pos.append(p)
        nrm.append(n)
        idx.append(i)
        base = len(accessors)
        accessors += [
            dict(bufferView=0, byteOffset=12 * n_vert, componentType=FLOAT,
                 count=len(p), type="VEC3", min=_floats(p.min(0)),
                 max=_floats(p.max(0))),
            dict(bufferView=1, byteOffset=12 * n_vert, componentType=FLOAT,
                 count=len(n), type="VEC3"),
            dict(bufferView=2, byteOffset=2 * n_idx, componentType=USHORT,
                 count=len(i), type="SCALAR"),
        ]
        meshes.append(dict(name=name, primitives=[dict(
            attributes=dict(POSITION=base, NORMAL=base + 1),
            indices=base + 2, material=mats.pop())]))
        n_vert += len(p)
        n_idx += len(i)
    blobs = [np.concatenate(pos).astype("<f4").tobytes(),
             np.concatenate(nrm).astype("<f4").tobytes(),
             np.concatenate(idx).astype("<u2").tobytes()]
    views, at = [], 0
    for blob, target in zip(blobs, (ARRAY_BUFFER, ARRAY_BUFFER,
                                    ELEMENT_ARRAY_BUFFER)):
        views.append(dict(buffer=0, byteOffset=at, byteLength=len(blob),
                          target=target))
        at += len(blob)
    data = b"".join(blobs)
    materials = []
    for name, albedo, emissive in rc.MATERIALS:
        m = dict(name=name, pbrMetallicRoughness=dict(
            baseColorFactor=[*albedo, 1.0], metallicFactor=0.0,
            roughnessFactor=1.0))
        if any(emissive):
            m["emissiveFactor"] = list(emissive)
        materials.append(m)
    nodes = [dict(name=name, mesh=k) for k, name in enumerate(objects)]
    nodes.append(dict(name="Camera", camera=0,
                      translation=_floats(np.asarray(rc.CAMERA_MM) / 1000.0),
                      rotation=list(rc.CAMERA_ROTATION)))
    return dict(
        asset=dict(version="2.0", generator="benchmark/make_cornell.py",
                   copyright="geometry: Cornell University Program of "
                   "Computer Graphics, Cornell Box Data"),
        scene=0,
        scenes=[dict(name="cornell", nodes=list(range(len(nodes))))],
        nodes=nodes,
        cameras=[dict(name="Camera", type="perspective", perspective=dict(
            yfov=rc.YFOV, aspectRatio=1.0, znear=0.01))],
        meshes=meshes,
        materials=materials,
        accessors=accessors,
        bufferViews=views,
        buffers=[dict(byteLength=len(data),
                      uri="data:application/octet-stream;base64,"
                      + base64.b64encode(data).decode("ascii"))],
    )


def text() -> str:
    """The file's contents."""
    return json.dumps(build(), indent=1) + "\n"


def main() -> int:
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    with open(PATH, "w") as f:
        f.write(text())
    print(PATH)
    return 0


if __name__ == "__main__":
    sys.exit(main())
