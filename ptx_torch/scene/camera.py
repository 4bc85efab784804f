"""Pinhole camera ray generation (port of ``ptx/scene/camera.py``)."""

from __future__ import annotations

import torch

from ptx_torch import math as pmath
from ptx_torch import sampling
from ptx_torch.scene.flatten import FlatScene


def generate_rays(
    fs: FlatScene,
    pixel_ids,
    sample_ids,
    width: int,
    height: int,
    seed: int = 0,
    first_sample_centered: bool = True,
    transparent_background: bool = False,
):
    """Primary rays for flat ``pixel_ids`` (= y * width + x) and
    ``sample_ids``.  Sample 0 is unjittered unless the background is
    transparent.  Returns ``(origins [R,3], directions [R,3])``."""
    x = (pixel_ids % width).to(torch.float32)
    y = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)

    jx = sampling.uniform(pixel_ids, sample_ids, 0, sampling.P_AA_JITTER_X, seed)
    jy = sampling.uniform(pixel_ids, sample_ids, 0, sampling.P_AA_JITTER_Y, seed)
    if first_sample_centered and not transparent_background:
        centered = sample_ids == 0
        jx = torch.where(centered, torch.zeros_like(jx), jx)
        jy = torch.where(centered, torch.zeros_like(jy), jy)

    ndc_x = ((x + jx) / width) * 2.0 - 1.0
    ndc_y = -(((y + jy) / height) * 2.0 - 1.0)
    ratio = width / height

    tan_half = fs.cam_tan_half_fov
    d_cam = torch.stack(
        [tan_half * ndc_x * ratio, tan_half * ndc_y, -torch.ones_like(ndc_x)],
        dim=-1,
    )
    d_cam = pmath.normalize(d_cam)
    # d_cam @ cam_basis.T written out: a float32 matmul on the card may run
    # in TF32, and the summation order stays fixed this way.
    b = fs.cam_basis
    d_world = torch.stack([pmath.dot(d_cam, b[i]) for i in range(3)], dim=-1)
    d_world = pmath.normalize(d_world)
    origins = fs.cam_origin.expand(d_world.shape)
    return origins, d_world
