"""Host-side pieces of the port's multi-rank render, with no process group,
held against ``ptx.parallel`` on the same inputs: the planner, the shard
ranges, the per-shard scenes and texture bins (array by array, exact), the
partitioner's partial loads, the sharded texel gather, the refusals, and
``multihost.initialize``'s refusal of NCCL with more ranks than cards.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ptx import render as jrender
from ptx.config import RenderConfig as JConfig
from ptx.parallel import mesh as jmesh
from ptx.parallel import shard_scene as jshard
from ptx.scene import flatten as jflatten
from ptx.scene import synthetic as jsynthetic
from ptx_torch import render as R
from ptx_torch.parallel import dist as pdist
from ptx_torch.parallel import mesh as pmesh
from ptx_torch.parallel import multihost
from ptx_torch.parallel import partition as ppartition
from ptx_torch.parallel import shard_scene as pshard
from ptx_torch.scene import gltf as pgltf
from ptx_torch.scene import textures
from ptx_torch.scene.flatten import FlatScene
from _torch_port import port_config, port_scene
from test_torch_host import _assert_same, _multi_mesh_gltf

GIB = 2**30


@pytest.mark.parametrize("n_devices", [1, 2, 4, 6, 8])
def test_plan_matches_jax(n_devices):
    for n_tris in (1024, 3_000_000, 40_000_000, 500_000_000):
        for n_texels in (0, 1000, 300_000_000):
            for force_tp in (None, 1, 2, 4):
                for hbm in (16 * GIB, 80 * GIB):
                    kw = dict(n_tris=n_tris, n_devices=n_devices,
                              n_texels=n_texels, force_tp=force_tp,
                              hbm_bytes_per_chip=hbm)
                    got = pmesh.plan(**kw)
                    want = jmesh.plan(**kw)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
                    assert got.n_devices == n_devices


def test_plan_defaults():
    # No process group: one device; on the CPU ptx's 16 GiB per device.
    assert pmesh.plan(1024, device="cpu") == pmesh.Plan(1, 1, False, False)
    p = pmesh.plan(500_000_000, n_devices=8, device="cpu")
    assert p == pmesh.Plan(**dataclasses.asdict(jmesh.plan(500_000_000, 8)))


def test_shard_ranges_match_jax():
    for n in (0, 1, 7, 3000, 3001, 273_102):
        for tp in (1, 2, 3, 4, 8):
            assert pshard.shard_ranges(n, tp) == jshard.shard_ranges(n, tp)


SHARD_CASES = [("synthetic:3000", 2, "brute"), ("synthetic:3000", 4, "bvh"),
               ("synthetic:3000", 2, "bvh"), ("synthetic:6000", 2, "pallas")]


@pytest.mark.parametrize("spec,tp,isect", SHARD_CASES)
def test_build_shard_scene_matches_jax(spec, tp, isect):
    fs, static = jrender.load_scene(spec, device=False)
    cfg = JConfig(width=16, height=16, intersector=isect)
    jplan = jmesh.Plan(dp=1, tp=tp, scene_sharded=True)
    want = jshard.build_shard_scene(fs, static, jplan, cfg)
    got = pshard.build_shard_scene(
        *port_scene(fs, static), pmesh.Plan(1, tp, True), port_config(cfg),
        device="cpu")
    _assert_same(got, want)
    assert got[1].shard_local and (got[1].n_bvh_nodes > 0) == (isect != "brute")


@pytest.mark.parametrize("tp", [2, 4])
def test_build_texture_shards_match_jax(tp):
    fs, static = jflatten.flatten(jsynthetic.make_textured_quads(3))
    want = jshard.build_texture_shards(fs, static, tp)
    got = pshard.build_texture_shards(*port_scene(fs, static), tp)
    _assert_same(got, want)
    sizes = [16, 1, 1, 50, 49, 1, 144]
    assert pshard.texture_bins(sizes, tp) == jshard.texture_bins(sizes, tp)


def test_rank_shards_reassemble_the_stacked_scene():
    """Each rank's slice (``mesh.shard_scene``), stacked in tp order, is the
    stacked scene: triangles, per-shard BVHs and the texel pack; the rest is
    whole on every rank."""
    from ptx_torch.scene.flatten import flatten
    from ptx_torch.scene.synthetic import make_textured_quads

    fs, static = flatten(make_textured_quads(3))
    cfg = R.RenderConfig(intersector="bvh")
    plan = pmesh.Plan(1, 2, True, True)
    fs, static = pshard.build_shard_scene(fs, static, plan, cfg, device="cpu")
    fs, static = pshard.build_texture_shards(fs, static, 2)
    parts = [pmesh.shard_scene(fs, pmesh.Mesh(plan, r, 0, r), True, True, True)
             for r in range(2)]
    spec = pmesh.scene_shardings(True, True, True)
    for f in fs._fields:
        a = [getattr(p, f) for p in parts]
        if spec[f] is None:
            assert all(x is getattr(fs, f) for x in a), f
        else:
            np.testing.assert_array_equal(np.concatenate(a), getattr(fs, f))
    assert parts[0].tex_texels.shape[0] == static.tex_shard_len


def test_partial_loads_cover_the_scene(tmp_path):
    path = _multi_mesh_gltf(tmp_path)
    full = {(p.mesh_name, p.prim_index) for p in pgltf.load(path).primitives}
    split = ppartition.split_scene(path, num_workers=3)
    seen = []
    for shard in split.split_work.values():
        part = pgltf.load(path, scene_work=shard.work)
        assert 0 < len(part.primitives) < len(full)
        seen += [(p.mesh_name, p.prim_index) for p in part.primitives]
    assert len(seen) == len(set(seen)) and set(seen) == full


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_texture_gather_sums_to_the_whole_pack(tp):
    """Each rank's masked gather, summed over the scene axis, equals
    ``ptx``'s sample of the unsharded pack bit for bit."""
    from ptx.scene import textures as jtextures

    jfs, jstatic = jflatten.flatten(jsynthetic.make_textured_quads(3))
    fs, static = pshard.build_texture_shards(*port_scene(jfs, jstatic), tp)
    n = 256
    rng = np.random.default_rng(tp)
    uv = rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    tex = rng.integers(0, jfs.tex_offset.shape[0], n).astype(np.int32)
    want = np.asarray(jtextures.sample_texture(jfs, tex, uv))
    length = static.tex_shard_len
    total = 0.0
    for r in range(tp):
        local = fs._replace(tex_texels=fs.tex_texels[r * length:(r + 1) * length])
        local = FlatScene(*(torch.as_tensor(np.asarray(v)) for v in local))
        total = total + textures.sample_texture(
            local, torch.as_tensor(tex), torch.as_tensor(uv), static,
            textures.TexShard(r, lambda x: x)).numpy()
    np.testing.assert_array_equal(total, want)
    with pytest.raises(ValueError, match="TexShard"):
        textures.sample_texture(local, torch.as_tensor(tex),
                                torch.as_tensor(uv), static)


def test_ring_with_sharded_textures_raises():
    from ptx_torch.scene.flatten import flatten
    from ptx_torch.scene.synthetic import make_textured_quads

    fs, static = flatten(make_textured_quads(3))
    cfg = R.RenderConfig(width=16, height=16, samples=1, bounces=2,
                         intersector="brute")
    plan = pmesh.Plan(dp=1, tp=2, scene_sharded=True, shard_textures=True)
    with pytest.raises(ValueError, match="ring"):
        pdist.render_distributed(fs, static, cfg, plan=plan, comm="ring",
                                 mesh=pmesh.Mesh(plan, 0, 0, 0), device="cpu")
    _, sharded = pshard.build_texture_shards(fs, static, 2)
    with pytest.raises(ValueError, match="ring"):
        pdist.make_distributed_sample_fn(sharded, cfg, None, plan, "ring",
                                         device="cpu")


def test_global_bvh_under_scene_sharding_raises():
    fs, static = R.load_scene("synthetic:3000")
    cfg = R.RenderConfig(width=16, height=16, intersector="bvh")
    _, static = R.ensure_accel(fs, static, cfg)
    assert static.n_bvh_nodes > 0 and not static.shard_local
    plan = pmesh.Plan(dp=1, tp=2, scene_sharded=True)
    with pytest.raises(ValueError, match="globally-built BVH"):
        pdist.make_distributed_sample_fn(static, cfg, None, plan, device="cpu")


def test_mesh_needs_a_process_group_for_several_devices():
    with pytest.raises(ValueError, match="initialize"):
        pmesh.make_mesh(pmesh.Plan(2, 1, False), "cpu")
    m = pmesh.make_mesh(pmesh.Plan(1, 1, False), "cpu")
    assert not m.distributed and multihost.replicator(m) is None


def test_initialize_refuses_nccl_with_more_ranks_than_cards(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False  # no torchrun environment
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in (None, "nccl"):  # None is NCCL when CUDA is there
        with pytest.raises(RuntimeError, match="gloo"):
            multihost.initialize("localhost:1", 2, 0, backend=backend)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"),
                                            (None, "nccl")])
def test_initialize_backend_follows_the_device(monkeypatch, device, backend):
    """With no backend given, the ranks of a CPU render join over gloo even
    where CUDA is available, and those of a CUDA render over NCCL, each on
    its own card."""
    joined, cards = [], []
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: joined.append(b))
    assert multihost.initialize("localhost:1", 2, 1, device=device)
    assert joined == [backend]
    assert cards == ([] if backend == "gloo" else [1])


def test_shutdown_drops_the_cached_groups(monkeypatch):
    """``multihost.shutdown`` empties the meshes' group cache; without a
    process group it does nothing else."""
    monkeypatch.setattr(pmesh, "_GROUPS", {"world": object(),
                                           "layouts": {(1, 2): ([], [])}})
    multihost.shutdown()
    assert pmesh._GROUPS == {"world": None, "layouts": {}}
    assert not torch.distributed.is_initialized()


def test_parked_rows_miss_on_every_shard():
    """The fused step hands a wrapped any-hit the first ``r`` shadow rows;
    the parked ones (lanes without a shadow ray) must miss on every shard,
    so the exchanges never take a hit from them: the tile traversal and the
    brute sweep, each shard with its own tiles."""
    from ptx_torch.kernels import intersect_cuda, sorting
    from ptx_torch.kernels.intersect import make_brute
    from ptx_torch.kernels.tiles import attach_tiles
    from ptx_torch.scene.bridge import to_device

    fs, static = R.load_scene("synthetic:6000")
    plan = pmesh.Plan(1, 2, True)
    stacked, local = pshard.build_shard_scene(
        fs, static, plan, R.RenderConfig(intersector="pallas"), device="cpu")
    p_orig, p_dir = sorting.park_constants(static)
    orig = torch.tensor(p_orig).expand(256, 3).contiguous()
    dirn = torch.full((256, 3), p_dir)
    for r in range(2):
        shard = to_device(attach_tiles(pmesh.shard_scene(
            stacked, pmesh.Mesh(plan, r, 0, r), True, local.n_bvh_nodes > 0)),
            "cpu")
        assert shard.ptiles.shape[0] > 4  # the planned sweep
        for any_hit in (intersect_cuda.any_hit, make_brute()[1]):
            assert not any_hit(shard, orig, dirn).any()


@pytest.mark.parametrize("size", [(256, 256), (640, 480), (1920, 1080),
                                  (32, 16)])
def test_launch_pixels_follow_the_single_device_chunk(size):
    """One rank's launch at one sample per launch: the single-device chunk
    rule (``render.resolve_rays_per_batch``) with the cap per rank."""
    cfg = R.RenderConfig(width=size[0], height=size[1])
    n = size[0] * size[1]
    assert pdist.launch_pixels(pmesh.Plan(1, 1, False), "reduce", n) == (
        R.resolve_rays_per_batch(cfg) or n)
    for dp, tp, comm in [(2, 1, "reduce"), (2, 2, "reduce"), (1, 4, "ring")]:
        plan = pmesh.Plan(dp, tp, tp > 1)
        ways = pdist.ray_ways(plan, comm)
        launch = pdist.launch_pixels(plan, comm, n)
        assert launch <= max(R.MAX_RAYS_PER_LAUNCH, n // ways)
        assert (n // ways) % launch == 0 and launch % 128 == 0


def _row_reduce(calls):
    """An all-reduce over a row of shards simulated as the leading axis of
    one tensor: every shard gets the reduction of all rows."""
    def reduce(x, op):
        calls.append(op)
        red = {"min": torch.amin, "max": torch.amax, "sum": torch.sum}[op]
        return red(x, 0, keepdim=True).expand_as(x).clone()

    return reduce


def _four_call_closest(h, ax, n_ax, reduce):
    """The four-call reduce the two-call one replaces (``ptx``'s
    ``sharded_closest``): the min of ``t``, the min of the winning tp
    index, the sum of the masked payload, the max of ``hit``."""
    from ptx_torch.kernels.intersect import Hit

    t = torch.where(h.hit, h.t, 3.0e38)
    t_min = reduce(t, "min")
    ax_win = reduce(torch.where(t == t_min, ax, n_ax).to(torch.int32), "min")
    win = (t == t_min) & (ax_win == ax)
    pay = reduce(torch.where(win[..., None], pdist._payload(h), 0.0), "sum")
    hit = reduce(h.hit.to(torch.int32), "max") > 0
    return Hit(hit=hit, t=t_min, position=pay[..., 0:3], normal=pay[..., 3:6],
               tangent=pay[..., 6:9], uv=pay[..., 9:11],
               mat_id=pay[..., 11].to(torch.int32))


def _crafted_shards(n_shards=3, n_rays=64, seed=5):
    """A Hit per shard stacked on a leading axis: seeded random hits and
    distances (ties among them), then crafted rays: equal ``t`` on two
    shards, no hit anywhere, a hit at ``+inf``, the smallest subnormal
    ``t`` (alone and tied), ``-0.0`` against ``+0.0``, and payloads whose
    normals hold ``-0.0``."""
    from ptx_torch.kernels.intersect import Hit

    rng = np.random.default_rng(seed)
    shape = (n_shards, n_rays)
    hit = rng.random(shape) < 0.6
    t = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0, 7.75]), shape)
    t = np.where(hit, t, np.float32(3.0e38)).astype(np.float32)
    normal = rng.normal(size=(*shape, 3)).astype(np.float32)
    normal[rng.random((*shape, 3)) < 0.3] = -0.0
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    inf, big = np.float32(np.inf), np.float32(3.0e38)
    crafted = [  # (t per shard, hit per shard)
        ([2.0, 1.5, 1.5], [1, 1, 1]),  # a tie: the lower tp index wins
        ([big, big, big], [0, 0, 0]),  # no hit anywhere
        ([inf, big, big], [1, 0, 0]),  # a hit at +inf
        ([inf, inf, inf], [1, 1, 1]),
        ([1.0, 0.5, tiny], [1, 1, 1]),  # the smallest subnormal
        ([tiny, 1.0, tiny], [1, 1, 1]),
        ([1.0, 0.0, -0.0], [1, 1, 1]),  # +0.0 and -0.0 tie at index 1
        ([-0.0, 0.0, 1.0], [1, 1, 1]),
        ([3.0, -0.0, 2.0], [1, 1, 1]),  # -0.0 alone
    ]
    for i, (ts, hs) in enumerate(crafted):
        t[:, i] = ts
        hit[:, i] = np.array(hs, bool)
    normal[:, 0:len(crafted)] = -0.0
    as_t = torch.from_numpy
    return Hit(hit=as_t(hit), t=as_t(t),
               position=as_t(rng.normal(size=(*shape, 3)).astype(np.float32)),
               normal=as_t(normal),
               tangent=as_t(rng.normal(size=(*shape, 3)).astype(np.float32)),
               uv=as_t(rng.random((*shape, 2)).astype(np.float32)),
               mat_id=as_t(rng.integers(0, 1000, shape).astype(np.int32)))


def test_two_call_closest_reduce_matches_four_calls(monkeypatch):
    """``dist.sharded_closest`` issues two collectives per call and gives
    the four-call reduce's Hit bit for bit on every field, on crafted
    shards: ties, misses, ``+inf``, subnormals, ``-0.0`` payloads.  A hit
    at ``-0.0`` ties with ``+0.0`` as ``t == t_min`` makes it, and its
    ``t`` comes back as ``+0.0``, equal as a float."""
    import types

    h = _crafted_shards()
    n = h.t.shape[0]
    ax = torch.arange(n)[:, None]
    calls = []
    reduce = _row_reduce(calls)
    monkeypatch.setattr(pdist, "all_reduce",
                        lambda mesh, x, op, group: reduce(x, op))
    mesh = types.SimpleNamespace(tp_index=ax, tp_group=None)
    got = pdist.sharded_closest(lambda fs, o, d: h, mesh)(None, None, None)
    assert calls == ["min", "sum"]
    calls.clear()
    want = _four_call_closest(h, ax, n, reduce)
    assert len(calls) == 4
    def bits(x):
        return x.view(torch.uint8 if x.dtype == torch.bool else torch.int32)

    for field in ("hit", "position", "normal", "tangent", "uv", "mat_id"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b)), field
    zero = want.t == 0.0
    assert torch.equal(bits(got.t[~zero]), bits(want.t[~zero]))
    assert (got.t[zero] == 0.0).all() and not torch.signbit(got.t[zero]).any()
    # Every shard ends with the same Hit, and the crafted winners hold.
    assert torch.equal(bits(got.t), bits(got.t[:1]).expand_as(bits(got.t)))
    assert got.t[0, 0] == 1.5 and torch.equal(got.normal[0, 0], h.normal[1, 0])
    assert not got.hit[0, 1] and got.hit[0, 2] and got.hit[0, 3]
    assert got.t[0, 4] == h.t[2, 4] and got.t[0, 5] == h.t[0, 5]
    assert torch.equal(got.mat_id[0, 6], h.mat_id[1, 6])
    assert torch.equal(got.mat_id[0, 7], h.mat_id[0, 7])
    assert torch.equal(got.mat_id[0, 8], h.mat_id[1, 8])
