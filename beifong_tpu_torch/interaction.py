"""Interaction records carried through the eager wavefront (counterpart of
`beifong_tpu/interaction.py`): plain dataclasses of tensors with a
leading lane dimension."""

from __future__ import annotations

import dataclasses

import torch

from .core import transform as tfm
from .core.math import dot


@dataclasses.dataclass
class SurfaceInteraction:
    """Per-lane surface interaction (every field (n, ...))."""

    valid: torch.Tensor      # (n,) bool: hit anything
    t: torch.Tensor          # (n,) distance along the ray (inf on a miss)
    p: torch.Tensor          # (n, 3) world hit position
    n: torch.Tensor          # (n, 3) geometric normal (world)
    sh_frame: torch.Tensor   # (n, 3, 3) shading frame rows (s, t, n)
    uv: torch.Tensor         # (n, 2)
    wi: torch.Tensor         # (n, 3) -d in the local shading frame
    wi_world: torch.Tensor   # (n, 3) -d (world)
    shape_idx: torch.Tensor  # (n,) int32 shape row (-1 = miss)
    prim_idx: torch.Tensor   # (n,) int32 triangle index (-1 otherwise)

    def to_local(self, v_world):
        return tfm.to_local(self.sh_frame, v_world)

    def to_world(self, v_local):
        return tfm.to_world(self.sh_frame, v_local)

    def spawn_origin(self, d_world, eps: float = 1e-4):
        """The hit point offset along the geometric normal, to the side of
        d_world, by eps x max(1, max |p|) (above the float32 ulp of far
        hits)."""
        sign = torch.where(dot(self.n, d_world)[..., None] >= 0.0, 1.0, -1.0)
        scale = eps * torch.clamp(self.p.abs().amax(-1, keepdim=True),
                                  min=1.0)
        return self.p + sign * scale * self.n


@dataclasses.dataclass
class DirectionSample:
    """Direction sample toward an endpoint: position, normal, unit
    direction from the reference point, distance, solid-angle pdf."""

    p: torch.Tensor       # (n, 3)
    n: torch.Tensor       # (n, 3)
    d: torch.Tensor       # (n, 3)
    dist: torch.Tensor    # (n,)
    pdf: torch.Tensor     # (n,)
    delta: torch.Tensor   # (n,) bool
    uv: torch.Tensor      # (n, 2)
