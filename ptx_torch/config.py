"""Typed render configuration.

The reference spreads configuration over three layers — infra parameter
overrides, the ``worker_info`` JSON payload (``src/models/work_info.hpp:17-31``)
and hard-coded C++ member defaults (``worker.hpp:20-24``,
``renderer.hpp:21-33``).  Here it is a single dataclass, JSON round-trippable
for payload parity, consumed by every entry point (render / invert / bench /
distributed planner).

The port's own copy of ``ptx/config.py``: nothing differs, and both
packages write the same JSON (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass
class Quirks:
    """Reference-exact semantics switches (SURVEY.md §7 capability #4).

    Defaults reproduce the reference wavefront worker; set
    ``Quirks.physical()`` for the physically-correct mode.
    """

    # `emissive * 10` debug multiplier (shading_worker.cpp:50, renderer.cpp:469).
    emissive_scale: float = 10.0
    # Throughput clamp (shading_worker.cpp:175).
    throughput_clamp: float = 10.0
    # Roughness floor against precision artifacts (shading_worker.cpp:107).
    roughness_floor: float = 0.05
    # Clamp NEE contribution to the light energy (shading_worker.cpp:140).
    clamp_direct_to_light: bool = True
    # Russian roulette only after 2 completed bounces (shading_worker.cpp:182).
    rr_after_bounces: int = 2
    # Sample 0 is unjittered unless the background is transparent
    # (worker.cpp:125-129).
    first_sample_centered: bool = True
    # Honour KHR_materials_emissive_strength (the reference ignores it and
    # compensates with emissive_scale=10; enabling both double-counts).
    use_emissive_strength: bool = False
    # The reference ships TWO indirect-light clamping conventions:
    # the wavefront worker clamps accumulated throughput to
    # ``throughput_clamp`` (shading_worker.cpp:173-175, the default here),
    # while the monolithic renderer clamps every level's contribution to its
    # incoming radiance — ``indirect_out = clamp(brdf*in/pdf, 0, in)``
    # (renderer.cpp:616-620), which equals clamping the per-bounce
    # throughput *factor* to 1. Set True for monolithic parity.
    indirect_clamp_to_incoming: bool = False

    @staticmethod
    def monolithic() -> "Quirks":
        """Semantics of the monolithic renderer (core/renderer.cpp trace()):
        per-level out<=in clamping, and no Russian roulette (trace() always
        recurses to the full bounce depth)."""
        return Quirks(indirect_clamp_to_incoming=True, rr_after_bounces=255)

    @staticmethod
    def physical() -> "Quirks":
        return Quirks(
            emissive_scale=1.0,
            throughput_clamp=1e30,
            roughness_floor=0.02,
            clamp_direct_to_light=False,
            rr_after_bounces=2,
            first_sample_centered=False,
            use_emissive_strength=True,
        )


@dataclasses.dataclass
class RenderConfig:
    """Full render configuration.

    Field parity with the worker payload (``src/models/work_info.hpp:17-31``):
    resolution / samples / bounces / scene path; the AWS bucket+ARN plumbing is
    replaced by a filesystem path and the device-mesh spec.
    """

    width: int = 640  # worker.hpp:20 default resolution
    height: int = 480
    samples: int = 50  # worker.hpp:22
    bounces: int = 10  # worker.hpp:23
    # Extra wavefront iterations to absorb stochastic-opacity passthroughs
    # (which do not consume a bounce — shading_worker.cpp:54-63; the
    # reference re-enqueues indefinitely).  The loop is liveness-driven, so
    # a generous cap costs nothing at runtime; truncation error is bounded
    # by (1 - opacity)^E of the transmitted radiance (tests/test_opacity.py
    # measures the bound on a worst-case 16-deep stack).  32 makes any
    # stack at opacity >= 0.35 exact to < 1e-6.
    opacity_extra_iters: int = 32
    environment_factor: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    transparent_background: bool = False
    seed: int = 0
    # Ray batching: rays per wavefront launch (static shape). None = whole image.
    rays_per_batch: Optional[int] = None
    # Samples per integrator launch: batching k image samples into one
    # wavefront launch (k*W*H rays) amortizes sort/plan/dispatch overhead and
    # fills bigger Pallas grids. None = auto (largest k with the launch under
    # MAX_RAYS_PER_LAUNCH); 1 = one launch per sample (round-1 behaviour).
    samples_per_launch: Optional[int] = None
    # Intersection backend: "auto" | "brute" | "bvh" | "pallas".
    intersector: str = "auto"
    # Shading engine: "auto" (fused Pallas kernels on TPU, XLA elsewhere),
    # "xla", or "pallas".
    shader: str = "auto"
    # Per-bounce ray sorting (wavefront coherence/compaction): "auto" (on for
    # multi-tile Pallas sweeps), "on", or "off".
    sort_rays: str = "auto"
    quirks: Quirks = dataclasses.field(default_factory=Quirks)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(payload: str) -> "RenderConfig":
        raw = json.loads(payload)
        quirks = Quirks(**raw.pop("quirks", {}))
        raw["environment_factor"] = tuple(raw.get("environment_factor", (1.0, 1.0, 1.0)))
        return RenderConfig(quirks=quirks, **raw)
