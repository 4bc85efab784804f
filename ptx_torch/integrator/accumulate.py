"""Sample accumulation and image finalize (port of
``ptx/integrator/accumulate.py``)."""

from __future__ import annotations

import torch

from ptx_torch import math as pmath


def accumulate_mean(radiance, alpha):
    """Mean over the sample axis: ``radiance`` [S, P, 3], ``alpha`` [S, P]."""
    return radiance.mean(0), alpha.mean(0)


def accumulate_claim(radiance, alpha):
    """Claim-blend accumulation for transparent backgrounds, sample by
    sample in order: an opaque sample (alpha > 0.5) on an unclaimed pixel
    overwrites the color and claims it with alpha 1/(s+1); opaque on claimed
    blends color and alpha; transparent on claimed blends alpha only;
    transparent on unclaimed stays transparent black."""
    p = radiance.shape[1]
    dev = radiance.device
    color = torch.zeros((p, 3), device=dev)
    acc_alpha = torch.zeros((p,), device=dev)
    claimed = torch.zeros((p,), dtype=torch.bool, device=dev)
    for s in range(radiance.shape[0]):
        opaque = alpha[s] > 0.5
        claim_now = opaque & ~claimed
        blend = opaque & claimed
        trans_on_claimed = ~opaque & claimed
        inv = 1.0 / (torch.full((p,), float(s), device=dev) + 1.0)
        color = torch.where(
            claim_now[:, None],
            radiance[s],
            torch.where(
                blend[:, None], (color * float(s) + radiance[s]) * inv[:, None],
                color,
            ),
        )
        acc_alpha = torch.where(
            claim_now,
            inv,
            torch.where(
                blend | trans_on_claimed, (acc_alpha * float(s) + alpha[s]) * inv,
                acc_alpha,
            ),
        )
        claimed = claimed | claim_now
    return color, acc_alpha


def finalize(color, alpha):
    """HDR -> display: ACES tonemap, gamma-2.2 encode, 8-bit quantize with
    round-half-up.  Returns uint8 RGBA."""
    rgb = pmath.srgb_encode(pmath.tonemap_approx_aces(color))
    rgba = torch.cat([rgb, torch.clamp(alpha, 0.0, 1.0)[..., None]], dim=-1)
    return torch.clamp(rgba * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
