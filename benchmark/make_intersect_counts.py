#!/usr/bin/env python3
"""Freeze the work of a sample's intersection queries, which
``benchmark/metrics/intersect_roofline_pct.fwd.py`` divides by the card's
peaks:

    python3 benchmark/make_intersect_counts.py [--device cpu]

A fixed probe (``PROBE_PIXELS`` pixels drawn with ``PROBE_SEED``, samples
``0 .. PROBE_SAMPLES - 1``) of the frame cells' job is traced by the
reference (``benchmark/reference.py``) on the configuration's scene; its
BVH walk counts, over every closest and shadow query of each path, the
boxes it visited and the triangles it tested.  A box costs
``NODE_FLOPS`` and a triangle ``TRI_FLOPS`` float32 operations (a slab
test and a Moller-Trumbore test, counted as the repository's BVH walk
bound counts them); the bytes are the scene's triangles
(36 B each) and boxes (24 B each) read once per sample and each query's
ray, 32 B in and 8 B out.  Both are scaled from the probe to the frame's
pixels and written to ``benchmark/data/intersect_counts.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common, reference as ref  # noqa: E402

PROBE_SEED = 0
PROBE_PIXELS = 2048
PROBE_SAMPLES = 2
NODE_FLOPS = 34
TRI_FLOPS = 58
TRI_BYTES = 36
NODE_BYTES = 24
RAY_BYTES = 32 + 8
CELL = "courtyard300k-1w.frame"
OUT = os.path.join(common.BENCH, "data", "intersect_counts.json")


def counts(config: dict, job: dict, device="cpu", pixels=PROBE_PIXELS,
           samples=PROBE_SAMPLES) -> dict:
    import numpy as np
    import torch

    sc, bvh = ref.load(config["scene"], device)
    n_pixels = job["width"] * job["height"]
    px = np.sort(np.random.default_rng(PROBE_SEED).choice(
        n_pixels, pixels, replace=False))
    pix = torch.as_tensor(px, device=device)
    tally = dict(nodes=0, tests=0, rays=0)
    ref.trace_paths(sc, bvh, config["semantics"], job["width"], job["height"],
                    job["bounces"], PROBE_SEED, pix.repeat(samples),
                    torch.arange(samples, device=device).repeat_interleave(
                        pixels), counts=tally)
    paths = pixels * samples
    per_path = {k: v / paths for k, v in tally.items()}
    n_tris = int(sc["a"].shape[0])
    n_nodes = int(bvh.valid.sum())
    flops = n_pixels * (per_path["nodes"] * NODE_FLOPS
                        + per_path["tests"] * TRI_FLOPS)
    nbytes = (n_tris * TRI_BYTES + n_nodes * NODE_BYTES
              + n_pixels * per_path["rays"] * RAY_BYTES)
    return dict(
        scene=config["scene"], job=job, probe_seed=PROBE_SEED,
        probe_pixels=pixels, probe_samples=samples, bvh_leaf=ref.LEAF,
        per_path=per_path, triangles=n_tris, bvh_nodes=n_nodes,
        node_flops=NODE_FLOPS, tri_flops=TRI_FLOPS, tri_bytes=TRI_BYTES,
        node_bytes=NODE_BYTES, ray_bytes=RAY_BYTES,
        flops_per_spp=flops, bytes_per_spp=nbytes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    cell = common.cell(CELL)
    out = counts(cell["config"], cell["traffic"]["job"], args.device)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
