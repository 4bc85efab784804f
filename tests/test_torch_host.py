"""The port's own copies of the JAX package's numpy host modules give
bit-identical results: scene loaders and flatten, the BVH builders, the
config's JSON round trip, the PNG and HDR bytes, checkpoint files and the
scene partitioner.

Each case runs the ``ptx`` original and its ``ptx_torch`` copy on the same
input and compares every array exactly (values, dtypes and shapes), every
``SceneStatic`` field, and the bytes written.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest

from ptx import config as jconfig
from ptx.accel import bvh as jbvh
from ptx.accel import native as jnative
from ptx.io import checkpoint as jcheckpoint
from ptx.io import hdr as jhdr
from ptx.io import png as jpng
from ptx.parallel import partition as jpartition
from ptx.scene import arch as jarch
from ptx.scene import flatten as jflatten
from ptx.scene import gltf as jgltf
from ptx.scene import synthetic as jsynthetic
from ptx_torch import config as pconfig
from ptx_torch.accel import bvh as pbvh
from ptx_torch.accel import native as pnative
from ptx_torch.io import checkpoint as pcheckpoint
from ptx_torch.io import hdr as phdr
from ptx_torch.io import png as ppng
from ptx_torch.parallel import partition as ppartition
from ptx_torch.scene import arch as parch
from ptx_torch.scene import flatten as pflatten
from ptx_torch.scene import gltf as pgltf
from ptx_torch.scene import synthetic as psynthetic
from _torch_port import port_config, port_scene


def _assert_same(got, want):
    """``(FlatScene, SceneStatic)`` of the port against the JAX package's."""
    fs, static = got
    jfs, jstatic = want
    assert isinstance(fs, pflatten.FlatScene)
    assert isinstance(static, pflatten.SceneStatic)
    assert fs._fields == jfs._fields
    for name in jfs._fields:
        a, b = np.asarray(getattr(fs, name)), np.asarray(getattr(jfs, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dataclasses.asdict(static) == dataclasses.asdict(jstatic)


@pytest.mark.parametrize("spec", ["synthetic:2000", "synthetic:8192:3"])
def test_load_synthetic_identical(spec):
    _assert_same(psynthetic.load_synthetic(spec), jsynthetic.load_synthetic(spec))


def test_load_arch_identical():
    _assert_same(parch.load_arch("arch:20000"), jarch.load_arch("arch:20000"))


def test_flatten_textured_quads_identical():
    _assert_same(pflatten.flatten(psynthetic.make_textured_quads()),
                 jflatten.flatten(jsynthetic.make_textured_quads()))


def _gltf_scene(tmp_path, glb: bool) -> str:
    """A small glTF written here: a textured, normal-mapped quad under a
    rotated and scaled parent node, a bare triangle with an emissive
    material (KHR_materials_emissive_strength), a camera and a directional
    sun (KHR_lights_punctual).  ``glb``: one binary container with the
    texture in a buffer view; else a .gltf with a .bin and a .png beside."""
    rng = np.random.default_rng(3)
    tex = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
    jpng.write_png(str(tmp_path / "albedo.png"), tex)
    png_bytes = (tmp_path / "albedo.png").read_bytes()

    quad_pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    quad_nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    quad_uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    quad_idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    tri_pos = np.array([[0, 0.5, 0], [0.5, 1.5, 0.2], [-0.4, 1.2, 0.3]], np.float32)
    arrays = [quad_pos, quad_nrm, quad_uv, quad_idx, tri_pos]
    blob, views = b"", []
    for arr in arrays:
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob += arr.tobytes() + b"\x00" * ((-arr.nbytes) % 4)
    image = {"mimeType": "image/png"}
    if glb:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(png_bytes)})
        image["bufferView"] = len(views) - 1
        blob += png_bytes + b"\x00" * ((-len(png_bytes)) % 4)
    else:
        image["uri"] = "albedo.png"

    def acc(view, count, typ, comp=5126):
        return {"bufferView": view, "componentType": comp, "count": count, "type": typ}

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 2, 3]}],
        "nodes": [
            {"children": [1], "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "scale": [2.0, 1.0, 1.5], "translation": [0.0, -0.5, 0.0]},
            {"mesh": 0, "translation": [0.2, 0.0, 0.1]},
            {"camera": 0, "translation": [0.0, 1.0, 4.0],
             "rotation": [-0.0871557, 0.0, 0.0, 0.9961947]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "rotation": [-0.4545195, 0.1227878, 0.0616284, 0.8799416]},
        ],
        "meshes": [{"name": "things", "primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
             "indices": 3, "material": 0},
            {"attributes": {"POSITION": 4}, "material": 1},
        ]}],
        "accessors": [
            dict(acc(0, 4, "VEC3"), min=[-1, 0, -1], max=[1, 0, 1]),
            acc(1, 4, "VEC3"), acc(2, 4, "VEC2"), acc(3, 6, "SCALAR", 5123),
            dict(acc(4, 3, "VEC3"), min=[-0.4, 0.5, 0], max=[0.5, 1.5, 0.3]),
        ],
        "materials": [
            {"name": "floor", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}, "roughnessFactor": 0.6,
                "metallicFactor": 0.1},
             "normalTexture": {"index": 0}},
            {"name": "lamp", "emissiveFactor": [1.0, 0.8, 0.5],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 4.0}}},
        ],
        "textures": [{"source": 0}],
        "images": [image],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.8, "znear": 0.01}}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "name": "sun", "intensity": 3.0,
             "color": [1.0, 0.9, 0.8]}]}},
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    if glb:
        js = json.dumps(doc).encode()
        js += b" " * ((-len(js)) % 4)
        path = tmp_path / "scene.glb"
        path.write_bytes(
            struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    else:
        (tmp_path / "scene.bin").write_bytes(blob)
        doc["buffers"][0]["uri"] = "scene.bin"
        path = tmp_path / "scene.gltf"
        path.write_text(json.dumps(doc))
    return str(path)


def _multi_mesh_gltf(tmp_path) -> str:
    """A .gltf written here for the partitioner: four meshes with six
    primitives in all, one mesh on a child node, one material with an
    albedo texture in a file beside the scene (its bytes count toward the
    partitioner's sizes), and a camera."""
    rng = np.random.default_rng(5)
    jpng.write_png(str(tmp_path / "albedo.png"),
                   (rng.random((4, 4, 4)) * 255).astype(np.uint8))
    blob, views, accessors, prims = b"", [], [], []
    for i in range(6):
        pos = (rng.random((3, 3)) * 2.0 - 1.0 + [0.0, 0.0, -3.0]).astype(np.float32)
        uv = rng.random((3, 2)).astype(np.float32)
        attrs = {}
        for name, arr, typ in (("POSITION", pos, "VEC3"), ("TEXCOORD_0", uv, "VEC2")):
            views.append({"buffer": 0, "byteOffset": len(blob),
                          "byteLength": arr.nbytes})
            blob += arr.tobytes()
            acc = {"bufferView": len(views) - 1, "componentType": 5126,
                   "count": 3, "type": typ}
            if name == "POSITION":
                acc.update(min=pos.min(0).tolist(), max=pos.max(0).tolist())
            accessors.append(acc)
            attrs[name] = len(accessors) - 1
        prims.append({"attributes": attrs, "material": i % 2})
    (tmp_path / "scene.bin").write_bytes(blob)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 3, 4]}],
        "nodes": [
            {"mesh": 0},
            {"mesh": 1, "children": [2]},
            {"mesh": 2, "translation": [0.0, 0.5, 0.0]},
            {"mesh": 3},
            {"camera": 0, "translation": [0.0, 0.0, 2.0]},
        ],
        "meshes": [
            {"name": "floor", "primitives": prims[0:2]},
            {"name": "wall", "primitives": prims[2:3]},
            {"name": "lamp", "primitives": prims[3:5]},
            {"name": "rock", "primitives": prims[5:6]},
        ],
        "materials": [
            {"name": "tex", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}}},
            {"name": "glow", "emissiveFactor": [1.0, 0.9, 0.8]},
        ],
        "textures": [{"source": 0}],
        "images": [{"uri": "albedo.png"}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.8, "znear": 0.01}}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob), "uri": "scene.bin"}],
    }
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("workers,budget", [(1, None), (2, None), (4, None),
                                            (None, 1e-12), (3, 1e-7)])
def test_partition_split_identical(tmp_path, workers, budget):
    path = _multi_mesh_gltf(tmp_path)
    got = ppartition.split_scene(path, workers, budget)
    want = jpartition.split_scene(path, workers, budget)
    assert got.to_json() == want.to_json()
    assert sum(len(v) for w in got.split_work.values()
               for v in w.work.values()) == 6


@pytest.mark.parametrize("glb", [False, True], ids=["gltf", "glb"])
def test_gltf_load_and_flatten_identical(tmp_path, glb):
    path = _gltf_scene(tmp_path, glb)
    base = str(tmp_path)
    jscene, pscene = jgltf.load(path), pgltf.load(path)
    assert len(pscene.primitives) == len(jscene.primitives) == 2
    jfs, jstatic = jflatten.flatten(jscene, base_dir=base)
    pfs, pstatic = pflatten.flatten(pscene, base_dir=base)
    assert jstatic.has_sun and jstatic.has_textures
    _assert_same((pfs, pstatic), (jfs, jstatic))
    _assert_same((pflatten.apply_emissive_strength(pfs, pscene), pstatic),
                 (jflatten.apply_emissive_strength(jfs, jscene), jstatic))


@pytest.mark.parametrize("spec", ["synthetic:2000", "arch:2000"])
def test_numpy_bvh_identical(spec):
    load = parch.load_arch if spec.startswith("arch") else psynthetic.load_synthetic
    jload = jarch.load_arch if spec.startswith("arch") else jsynthetic.load_synthetic
    got = pbvh.build_bvh(*load(spec), backend="numpy")
    _assert_same(got, jbvh.build_bvh(*jload(spec), backend="numpy"))


def test_native_bvh_identical():
    if not (pnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain: the native BVH builder does not build here")
    got = pbvh.build_bvh(*parch.load_arch("arch:20000"), backend="native")
    want = jbvh.build_bvh(*jarch.load_arch("arch:20000"), backend="native")
    _assert_same(got, want)
    assert pnative.library_path().endswith(".so") and "/ptx_torch/build/" in pnative.library_path()


def test_render_config_json_round_trip():
    for cfg in (jconfig.RenderConfig(),
                jconfig.RenderConfig(width=33, height=17, samples=3, seed=9,
                                     intersector="pallas", shader="xla",
                                     transparent_background=True,
                                     rays_per_batch=128,
                                     quirks=jconfig.Quirks.physical())):
        pcfg = port_config(cfg)
        assert isinstance(pcfg, pconfig.RenderConfig)
        assert pcfg.to_json() == cfg.to_json()
        assert pconfig.RenderConfig.from_json(cfg.to_json()) == pcfg
        assert jconfig.RenderConfig.from_json(pcfg.to_json()) == cfg
    assert pconfig.Quirks.monolithic() == port_config(
        jconfig.RenderConfig(quirks=jconfig.Quirks.monolithic())).quirks


@pytest.mark.parametrize("channels", [3, 4])
def test_png_bytes_identical(tmp_path, channels):
    rgba = (np.random.default_rng(channels).random((7, 5, channels)) * 255).astype(np.uint8)
    for writer in ("write_png", "_write_png_pure"):
        getattr(jpng, writer)(str(tmp_path / "j.png"), rgba)
        getattr(ppng, writer)(str(tmp_path / "p.png"), rgba)
        assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
        back = ppng.read_png(str(tmp_path / "p.png"))  # always RGBA
        np.testing.assert_array_equal(back[..., :channels], rgba)


def test_hdr_bytes_identical(tmp_path):
    rng = np.random.default_rng(8)
    rgb = (rng.random((6, 9, 3)) * 4.0).astype(np.float32)
    rgb[0, 0] = 0.0  # exponent 0
    rgb[1, 1] = [1e-33, 0.0, 0.0]  # below the format's floor
    jhdr.write_hdr(str(tmp_path / "j.hdr"), rgb)
    phdr.write_hdr(str(tmp_path / "p.hdr"), rgb)
    assert (tmp_path / "p.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = phdr.read_hdr(str(tmp_path / "p.hdr"))
    np.testing.assert_array_equal(back, jhdr.read_hdr(str(tmp_path / "p.hdr")))
    # RGBE keeps 8 mantissa bits of the largest channel and truncates;
    # texels below 1e-32 are written as zero.
    assert (np.abs(back - rgb) <= rgb.max(-1, keepdims=True) / 128 + 1e-32).all()


@pytest.mark.parametrize("claimed", [False, True])
def test_checkpoint_files_interchangeable(tmp_path, claimed):
    """A checkpoint either package writes loads in the other with every
    field equal; the fingerprints of one config agree."""
    rng = np.random.default_rng(9)
    cfg = jconfig.RenderConfig(width=5, height=4, seed=3,
                               transparent_background=claimed)
    fp = jcheckpoint.config_fingerprint(cfg)
    assert pcheckpoint.config_fingerprint(port_config(cfg)) == fp
    fields = dict(color=rng.random((20, 3)).astype(np.float32),
                  alpha=rng.random(20).astype(np.float32),
                  claimed=(rng.random(20) < 0.5) if claimed else None,
                  samples_done=7, fingerprint=fp)
    for writer, reader in ((jcheckpoint, pcheckpoint), (pcheckpoint, jcheckpoint)):
        path = str(tmp_path / f"{writer.__name__}.npz")
        writer.save(path, writer.Checkpoint(**fields))
        got = reader.load(path, fp)
        assert isinstance(got, reader.Checkpoint)
        for name, want in fields.items():
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(getattr(got, name), want)
            else:
                assert getattr(got, name) == want
        assert reader.load(path, "0" * 16) is None


def test_port_scene_helper_builds_port_classes():
    """The port's helper rebuilds its own classes; the JAX package's
    objects convert field by field."""
    fs, static = port_scene(*jsynthetic.load_synthetic("synthetic:500"))
    assert isinstance(fs, pflatten.FlatScene) and isinstance(static, pflatten.SceneStatic)
