"""Carry the JAX package's host objects over to the port's own classes,
hold torch to one intra-op thread per test process, and stub CUDA's graph
calls for the device programs' bookkeeping tests.

The port (``ptx_torch``) keeps its own copies of ``ptx.config`` and
``ptx.scene.flatten`` and refuses the JAX package's classes.  Parity tests
that load a scene or build a config with the JAX package rebuild the port's
``FlatScene`` / ``SceneStatic`` / ``RenderConfig`` from it, field by field,
and carry optimisation-parameter dicts both ways.
"""

import dataclasses

import numpy as np
import torch

from ptx_torch import config as pconfig
from ptx_torch.scene import flatten as pflatten

# One intra-op thread per test process.  The suite runs several pytest
# workers on a few cores; at torch's default (a thread per core in each
# worker) their threads spin against each other and a file that takes
# 20 s alone takes minutes.  Every port test module imports this helper.
torch.set_num_threads(1)


def port_flat(fs):
    """A ``ptx_torch`` ``FlatScene`` of numpy arrays from a JAX package one."""
    return pflatten.FlatScene(**{k: np.asarray(v) for k, v in fs._asdict().items()})


def port_static(static):
    return pflatten.SceneStatic(**{
        f.name: getattr(static, f.name)
        for f in dataclasses.fields(pflatten.SceneStatic)
    })


def port_scene(fs, static):
    return port_flat(fs), port_static(static)


def port_config(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(pconfig.RenderConfig)}
    fields["quirks"] = pconfig.Quirks(**dataclasses.asdict(cfg.quirks))
    return pconfig.RenderConfig(**fields)


def port_params(params, device="cpu"):
    """A JAX parameter dict ``{field: jnp array}`` as the port's
    ``{field: torch tensor}`` on ``device``."""
    import torch

    return {k: torch.as_tensor(np.array(v), device=device) for k, v in params.items()}


def jax_params(params):
    """The port's parameter dict ``{field: torch tensor}`` as the JAX
    package's ``{field: jnp array}``."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v.detach().cpu().numpy()) for k, v in params.items()}


class FakeGraph:
    """A CUDA graph's calls, logged (the CPU has none to capture: the work
    a capture would record runs at once, and a replay runs nothing)."""

    made, log = [], []

    def __init__(self):
        self.n = len(FakeGraph.made)
        FakeGraph.made.append(self)

    def capture_begin(self, pool, capture_error_mode):
        FakeGraph.log.append(f"begin {self.n}")

    def capture_end(self):
        FakeGraph.log.append(f"end {self.n}")

    def replay(self):
        FakeGraph.log.append(f"replay {self.n}")


def stub_cuda_graphs(monkeypatch) -> list:
    """``integrator.graphs.GraphRunner``'s CUDA calls (graphs, their pool,
    streams) stubbed with :class:`FakeGraph`; returns its log, empty."""
    from contextlib import nullcontext

    FakeGraph.log, FakeGraph.made = [], []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda: "side")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "outer")
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    return FakeGraph.log
