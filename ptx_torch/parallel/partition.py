"""Scene partitioner — the sharding planner of the preprocessor Lambda.

Re-implements O5 (``preprocessor-function/preprocess/preprocessor.py:14-111``)
against the local filesystem: walk the glTF scene's nodes, estimate each
primitive's memory footprint (vertex/index buffer-view byte lengths plus the
byte size of every texture its material references — the reference issues an
S3 ``head_object`` per texture; we ``stat`` the file), and greedily assign
primitives to workers by either a per-worker memory budget or an equal
primitive count.

The output ``{worker_id: {mesh_name: [primitive ids]}}`` feeds
``ptx_torch.scene.gltf.load(scene_work=...)`` — the same contract as the
reference's ``worker_info.scene_work`` payload
(``src/models/work_info.hpp:11-15``) — and, on-device, drives which triangle
ranges land on which mesh axis shard.

The port's own copy of ``ptx/parallel/partition.py``: only the docstring
differs, so both packages give the same plan (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class WorkerShard:
    work: Dict[str, List[int]]  # mesh name -> primitive indices
    total_size_gb: float


@dataclasses.dataclass
class SplitScene:
    split_work: Dict[int, WorkerShard]
    total_size_gb: float

    def to_json(self) -> str:
        return json.dumps(
            {
                "split_work": {
                    k: {"work": v.work, "total_size": v.total_size_gb}
                    for k, v in self.split_work.items()
                },
                "total_size": self.total_size_gb,
            }
        )


def _texture_size(gltf: dict, base_dir: str, tex_info) -> int:
    """File size of the texture's image (reference ``get_texture_size``,
    ``preprocessor.py:104-111``, S3 head_object -> local stat)."""
    if not tex_info:
        return 0
    tex = gltf.get("textures", [])[tex_info["index"]]
    src = tex.get("source")
    if src is None:
        return 0
    uri = gltf["images"][src].get("uri")
    if not uri or uri.startswith("data:"):
        return 0
    path = os.path.join(base_dir, uri)
    try:
        return os.stat(path).st_size
    except OSError:
        return 0


def _primitive_size(gltf: dict, base_dir: str, prim: dict) -> int:
    """Vertex-attribute buffer views + material texture bytes
    (reference ``get_primitive_size``, ``preprocessor.py:77-102``)."""
    views = gltf.get("bufferViews", [])
    accessors = gltf.get("accessors", [])

    def attr_size(acc_idx) -> int:
        if acc_idx is None:
            return 0
        acc = accessors[acc_idx]
        if "bufferView" not in acc:
            return 0
        return views[acc["bufferView"]].get("byteLength", 0)

    attrs = prim.get("attributes", {})
    size = sum(
        attr_size(attrs.get(k))
        for k in ("POSITION", "NORMAL", "TANGENT", "TEXCOORD_0")
    )

    mat_idx = prim.get("material")
    if mat_idx is not None:
        mat = gltf["materials"][mat_idx]
        pbr = mat.get("pbrMetallicRoughness", {})
        size += sum(
            _texture_size(gltf, base_dir, t)
            for t in (
                mat.get("normalTexture"),
                mat.get("occlusionTexture"),
                mat.get("emissiveTexture"),
                pbr.get("baseColorTexture"),
                pbr.get("metallicRoughnessTexture"),
            )
        )
    return size


def split_scene(
    path: str,
    num_workers: Optional[int] = 1,
    memory_per_worker_gb: Optional[float] = None,
) -> SplitScene:
    """Greedy primitive assignment (reference ``get_split_scene``,
    ``preprocessor.py:26-75``): advance to the next worker when either the
    per-worker memory budget or the equal-count threshold is reached."""
    if num_workers is not None and num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if memory_per_worker_gb is not None and memory_per_worker_gb <= 0:
        raise ValueError("memory_per_worker_gb must be positive")
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        gltf = json.load(f)

    scene = gltf["scenes"][gltf.get("scene", 0)]
    nodes = gltf.get("nodes", [])
    meshes = gltf.get("meshes", [])

    # DFS pre-order over the node tree — the SAME traversal as the loader
    # (``gltf.load``'s walk recurses into children, ``gltf.py:459-460``).
    # This deliberately diverges from the reference partitioner, which walks
    # only scene.nodes (``preprocessor.py:37-49``): a root-only walk never
    # assigns child-node meshes, so every worker's scene_work filter would
    # silently drop them (partitioner/loader disagreement, VERDICT r3 #7).
    def mesh_node_indices():
        out: List[int] = []

        def walk(i: int):
            if "mesh" in nodes[i]:
                out.append(i)
            for c in nodes[i].get("children", []):
                walk(c)

        for root in scene.get("nodes", []):
            walk(root)
        return out

    mesh_nodes = mesh_node_indices()

    # scene_work is keyed by mesh NAME (the reference payload contract,
    # ``work_info.hpp:11-15``); two DIFFERENT meshes sharing a name would
    # silently mis-shard on load — fail loud instead.  (The same mesh
    # instanced by several nodes is fine: every instance loads the shard's
    # allowed primitive ids, matching the reference's name-filtered load.)
    name_of: Dict[str, int] = {}
    for i in mesh_nodes:
        m = nodes[i]["mesh"]
        mesh_name = meshes[m].get("name", f"mesh{m}")
        if name_of.setdefault(mesh_name, m) != m:
            raise ValueError(
                f"two distinct meshes share the name {mesh_name!r}; the "
                "name-keyed scene_work contract cannot shard them — rename "
                "one of them"
            )

    total_primitives = sum(
        len(meshes[nodes[i]["mesh"]].get("primitives", [])) for i in mesh_nodes
    )

    split: Dict[int, WorkerShard] = {}
    worker_id = 1
    current_size = 0.0
    current_primitive = 0
    total_size = 0.0

    for node_idx in mesh_nodes:
        node = nodes[node_idx]
        mesh = meshes[node["mesh"]]
        mesh_name = mesh.get("name", f"mesh{node['mesh']}")
        for prim_id, prim in enumerate(mesh.get("primitives", [])):
            current_primitive += 1
            prim_size = _primitive_size(gltf, base_dir, prim) * 1e-9
            total_size += prim_size

            shard = split.setdefault(worker_id, WorkerShard(work={}, total_size_gb=0.0))
            shard.work.setdefault(mesh_name, []).append(prim_id)
            shard.total_size_gb += prim_size

            over_memory = (
                memory_per_worker_gb is not None
                and (current_size + prim_size) >= memory_per_worker_gb
            )
            over_count = (
                num_workers is not None
                and current_primitive >= total_primitives / num_workers
            )
            if over_memory or over_count:
                worker_id += 1
                current_size = 0.0
                current_primitive = 0
            else:
                current_size += prim_size

    return SplitScene(split_work=split, total_size_gb=total_size)
