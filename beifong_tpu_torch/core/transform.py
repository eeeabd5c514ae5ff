"""Affine 4x4 transforms (counterpart of `beifong_tpu/core/transform.py`,
the part the scene builder needs).

Transforms are float32 (4, 4) tensors on the CPU: they are host-side scene
description, turned into device tables by `Scene.compile`.
"""

from __future__ import annotations

import torch

from .math import normalize

_F32 = torch.float32


def _vec(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def translate(v) -> torch.Tensor:
    t = torch.eye(4, dtype=_F32)
    t[:3, 3] = _vec(v)
    return t


def scale(v) -> torch.Tensor:
    v = _vec(v)
    if v.ndim == 0:
        v = v.expand(3)
    return torch.diag(torch.cat([v, torch.ones(1, dtype=_F32)]))


def look_at(origin, target, up=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Maps local +Z to (target - origin), like Mitsuba's `<lookat>`."""
    origin, target, up = _vec(origin), _vec(target), _vec(up)
    d = normalize(target - origin)
    left = normalize(torch.linalg.cross(up, d))
    new_up = torch.linalg.cross(d, left)
    m = torch.eye(4, dtype=_F32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def compose(*mats) -> torch.Tensor:
    """compose(A, B, C) = A @ B @ C (applied right to left)."""
    out = torch.as_tensor(mats[0], dtype=_F32)
    for mx in mats[1:]:
        out = out @ torch.as_tensor(mx, dtype=_F32)
    return out


def inverse(m) -> torch.Tensor:
    """World-to-object inverse of a to-world transform."""
    return torch.linalg.inv(torch.as_tensor(m, dtype=_F32))
