"""Affine 4x4 transforms (counterpart of `beifong_tpu/core/transform.py`,
the part the scene builder needs).

Transforms are float32 (4, 4) tensors on the CPU: they are host-side scene
description, turned into device tables by `Scene.compile`.
`AnimatedTransform` (keyframed motion) is host-side float64 numpy, as in
the JAX package: `Scene.at_time` evaluates it once per pulse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def rotate(axis, angle_deg) -> torch.Tensor:
    """Rotation about `axis` by `angle_deg` degrees (Mitsuba's
    `<rotate>`)."""
    a = normalize(_vec(axis))
    th = torch.deg2rad(_vec(angle_deg))
    s, c = torch.sin(th), torch.cos(th)
    x, y, z = a[0], a[1], a[2]
    r = torch.stack([
        torch.stack([c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s]),
        torch.stack([y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s]),
        torch.stack([z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)])])
    m = torch.eye(4, dtype=_F32)
    m[:3, :3] = r
    return m


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


# ---------------------------------------------------------------------------
# AnimatedTransform: keyframed (time -> 4x4) motion.  Each keyframe is split
# into a translation, a rotation quaternion and a symmetric stretch (polar
# decomposition), interpolated lerp / slerp / lerp.  float64 numpy on the
# host; `velocity` is the Doppler source term the kernels read per shape.
# ---------------------------------------------------------------------------


def _polar_rotation(m3):
    """Orthogonal polar factor of a 3x3 matrix (Higham iteration)."""
    r = np.asarray(m3, np.float64)
    for _ in range(32):
        r_next = 0.5 * (r + np.linalg.inv(r).T)
        if np.abs(r_next - r).max() < 1e-12:
            r = r_next
            break
        r = r_next
    return r


def _quat_from_mat(r):
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _mat_from_quat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0, q1, u):
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d > 1.0 - 1e-8:
        q = (1 - u) * q0 + u * q1
        return q / np.linalg.norm(q)
    th = np.arccos(d)
    return (np.sin((1 - u) * th) * q0 + np.sin(u * th) * q1) / np.sin(th)


@dataclasses.dataclass(frozen=True)
class AnimatedTransform:
    """Keyframed (time -> 4x4) transform; see the note above."""

    times: np.ndarray     # (K,) increasing keyframe times [s]
    trans: np.ndarray     # (K, 3) translations
    quats: np.ndarray     # (K, 4) unit rotation quaternions (w, x, y, z)
    stretch: np.ndarray   # (K, 3, 3) symmetric stretches S (M3 = R S)

    @staticmethod
    def from_keyframes(pairs) -> "AnimatedTransform":
        """pairs: iterable of (time, (4, 4) matrix)."""
        pairs = sorted(pairs, key=lambda p: float(p[0]))
        times, trans, quats, stretch = [], [], [], []
        prev_q = None
        for t, m in pairs:
            m = np.asarray(m, np.float64)
            r = _polar_rotation(m[:3, :3])
            q = _quat_from_mat(r)
            if prev_q is not None and np.dot(prev_q, q) < 0:
                q = -q   # the short arc between neighbours
            prev_q = q
            times.append(float(t))
            trans.append(m[:3, 3])
            quats.append(q)
            stretch.append(r.T @ m[:3, :3])
        return AnimatedTransform(np.asarray(times), np.asarray(trans),
                                 np.asarray(quats), np.asarray(stretch))

    def eval(self, t: float) -> np.ndarray:
        """The interpolated (4, 4) float32 matrix at time t (the ends
        clamped)."""
        t = float(t)
        if len(self.times) == 1:
            tr, q, s = self.trans[0], self.quats[0], self.stretch[0]
        else:
            k = int(np.searchsorted(self.times, t, side='right')) - 1
            k = max(0, min(k, len(self.times) - 2))
            t0, t1 = self.times[k], self.times[k + 1]
            u = np.clip((t - t0) / max(t1 - t0, 1e-30), 0.0, 1.0)
            tr = (1 - u) * self.trans[k] + u * self.trans[k + 1]
            q = _slerp(self.quats[k], self.quats[k + 1], u)
            s = (1 - u) * self.stretch[k] + u * self.stretch[k + 1]
        m = np.eye(4)
        m[:3, :3] = _mat_from_quat(q) @ s
        m[:3, 3] = tr
        return m.astype(np.float32)

    def velocity(self, t: float, p_local=(0.0, 0.0, 0.0)) -> np.ndarray:
        """World-frame velocity [m/s] of the local point p_local at time t:
        a central difference of the interpolation over 1e-5 of the
        keyframe span."""
        if len(self.times) == 1:
            return np.zeros(3, np.float32)
        span = float(self.times[-1] - self.times[0])
        dt = max(span * 1e-5, 1e-9)
        p = np.asarray([*p_local, 1.0])
        a = (self.eval(t + dt).astype(np.float64) @ p)[:3]
        b = (self.eval(t - dt).astype(np.float64) @ p)[:3]
        return ((a - b) / (2 * dt)).astype(np.float32)
