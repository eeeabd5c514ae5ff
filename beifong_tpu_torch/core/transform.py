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


# ---------------------------------------------------------------------------
# Frames: orthonormal (s, t, n) bases stored as (..., 3, 3) with rows s, t, n
# ---------------------------------------------------------------------------


def frame_from_normal(n: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame around unit normal n (Duff et al., branchless)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    t = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return torch.stack([s, t, n], dim=-2)


def to_local(frame: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World -> local: the rows of `frame` are the basis vectors."""
    p = frame * v[..., None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def to_world(frame: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    p = frame * v[..., :, None]
    return p[..., 0, :] + p[..., 1, :] + p[..., 2, :]
