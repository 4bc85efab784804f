"""The plain reference against itself and against brute force at a tiny
size on the CPU, and the control's distance from it."""

import numpy as np
import torch

from benchmark import reference as ref
from benchmark.tests import tiny

SEM = {"emissive_scale": 10.0, "throughput_clamp": 10.0,
       "roughness_floor": 0.05, "clamp_direct_to_light": True,
       "rr_after_bounces": 2, "first_sample_centered": True}


def _rays(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    orig = torch.rand((n, 3), generator=g) * torch.tensor([28.0, 11.0, 10.0]) \
        - torch.tensor([14.0, -0.5, 5.0])
    dirn = ref.normalize(torch.randn((n, 3), generator=g))
    return orig, dirn


def test_walk_finds_the_brute_force_closest_hit():
    sc, bvh = ref.load(tiny.SCENE, "cpu")
    orig, dirn = _rays(512)
    t, tri, hit, nodes, tests = ref.walk(bvh, orig, dirn)
    bt, _, _, ok = ref.moller_trumbore(orig[:, None], dirn[:, None],
                                       sc["a"][None], sc["e1"][None],
                                       sc["e2"][None])
    best = bt.min(1).values
    assert torch.equal(hit, ok.any(1))
    assert torch.equal(t[hit], best[hit])
    assert (nodes > 0).all() and (tests[hit] > 0).all()
    any_hit = ref.any_hit(bvh, orig, dirn)
    assert torch.equal(any_hit, hit)


def test_paths_are_deterministic_and_the_control_departs():
    sc, bvh = ref.load(tiny.SCENE, "cpu")
    pix = torch.arange(64).repeat(2)
    smp = torch.arange(2).repeat_interleave(64)
    args = (sc, bvh, SEM, 16, 16, 4, 12345, pix, smp)
    c1, a1 = ref.trace_paths(*args)
    c2, a2 = ref.trace_paths(*args)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert torch.isfinite(c1).all() and (c1 > 0).any()
    assert torch.equal(a1, torch.ones_like(a1))  # opaque background
    low, _ = ref.trace_paths(*args, dtype=torch.bfloat16)
    assert not torch.equal(low, c1)


def test_fold_is_the_running_mean():
    x = torch.rand((5, 7, 3))
    a = torch.rand((5, 7))
    mc, ma = ref.fold_mean(x, a)
    for n in range(5):
        assert torch.allclose(mc[n], x[:n + 1].mean(0), atol=1e-6)
        assert torch.allclose(ma[n], a[:n + 1].mean(0), atol=1e-6)


def test_scene_arrays_are_the_spec_s():
    arrays = ref.scene_arrays("arch:2000")
    n = arrays["a"].shape[0]
    assert n > 1500 and arrays["mat"].shape == (n,)
    assert np.all(np.isfinite(arrays["a"]))
    assert set(np.unique(arrays["mat"])) <= {0, 1, 2, 3}


def test_gradients_flow_into_the_materials():
    sc, bvh = ref.load(tiny.SCENE, "cpu")
    leaves = {"mat_albedo": sc["albedo"].clone().requires_grad_(True),
              "mat_emissive": sc["emissive"].clone().requires_grad_(True)}
    pix = torch.arange(64)
    c, _ = ref.trace_paths(sc, bvh, SEM, 8, 8, 3, 7, pix,
                           torch.zeros_like(pix), params=leaves)
    g = torch.autograd.grad(c.sum(), list(leaves.values()))
    assert all(torch.isfinite(x).all() and x.abs().sum() > 0 for x in g)
