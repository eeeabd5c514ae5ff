"""Radar math helpers on tensors (counterpart of `beifong_tpu/core/math.py`,
the part the flagship receive needs)."""

from __future__ import annotations

import torch

Pi = 3.141592653589793
TwoPi = 6.283185307179586

# Propagation speeds [m/s].
C_VACUUM = 299792458.0
C_AIR_SOUND = 340.0
C_WATER_SOUND = 1480.0


def sinc(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized sinc sin(x)/x with sinc(0) = 1."""
    big = x.abs() > 1e-8
    safe = torch.where(big, x, torch.ones_like(x))
    return torch.where(big, torch.sin(safe) / safe, torch.ones_like(x))


def tri(x: torch.Tensor) -> torch.Tensor:
    """Triangle of base 1: 1 - 2|x| on |x| < 1/2, else 0."""
    ax = x.abs()
    return torch.where(ax < 0.5, 1.0 - 2.0 * ax, torch.zeros_like(x))


def rect(x: torch.Tensor) -> torch.Tensor:
    """Rectangular window of width 1."""
    return torch.where(x.abs() < 0.5, torch.ones_like(x), torch.zeros_like(x))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """a / |a| along the last axis (rsqrt clamped at 1e-30, as the JAX
    package's `safe_rsqrt`)."""
    return a * torch.rsqrt(torch.clamp((a * a).sum(-1, keepdim=True),
                                       min=1e-30))
