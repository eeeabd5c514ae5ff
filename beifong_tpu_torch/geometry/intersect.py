"""Batched ray / primitive intersection of the eager wavefront
(counterpart of `beifong_tpu/geometry/intersect.py`).

Analytic primitives are tested all against all, (rays x prims), in their
unit object spaces (rectangle [-1, 1]^2 in z = 0, normal +z; unit sphere;
unit disk in z = 0; cylinder of radius 1, z in [0, 1]) with an argmin.
Triangles go through the hand-written kernels on a card: the brute-force
K4 (`geometry/intersect_kernel.py`) when the scene has no BVH, the BVH
walks K2 / K3 (`geometry/bvh_kernel.py`) when `SceneData.bvh` is set.  On
the CPU the same calls run K4's plain version and the lock-step BVH walks
of `geometry/bvh.py`.  tmin is 1e-4, as those kernels fix it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import transform as tfm
from ..core.math import safe_acos, safe_sqrt, normalize, TwoPi, Pi
from ..interaction import SurfaceInteraction
from . import bvh as bvh_mod
from . import bvh_kernel as bk
from . import intersect_kernel as ik
from .shapes import RECTANGLE, SPHERE, DISK, CYLINDER, ShapeTable

INF = float('inf')
TMIN = 1e-4
_SHADOW_EPS = 1.0 - 1e-3


@dataclasses.dataclass(frozen=True)
class TriData:
    """Pre-transformed triangle soup (world space), one row per face."""

    v0: torch.Tensor          # (F, 3) float32
    e1: torch.Tensor          # (F, 3) v1 - v0
    e2: torch.Tensor          # (F, 3) v2 - v0
    n: torch.Tensor           # (F, 3) geometric normal (normalised)
    shape_idx: torch.Tensor   # (F,) int32 row in the scene's shape table

    @property
    def n_faces(self) -> int:
        return int(self.v0.shape[0])


def _object_ray(to_object, o, d):
    """Rays in each primitive's object space: (R, P, 3) origins and
    directions."""
    oo = torch.einsum('pij,rj->rpi', to_object[:, :3, :3], o) \
        + to_object[None, :, :3, 3]
    od = torch.einsum('pij,rj->rpi', to_object[:, :3, :3], d)
    return oo, od


def _t_rectangle(oo, od):
    dz = od[..., 2]
    ok = dz.abs() > 1e-12
    t = -oo[..., 2] / torch.where(ok, dz, 1e-12)
    p = oo + t[..., None] * od
    hit = ok & (p[..., 0].abs() <= 1.0) & (p[..., 1].abs() <= 1.0)
    return torch.where(hit, t, INF)


def _t_sphere(oo, od):
    a = (od * od).sum(-1)
    b = 2.0 * (oo * od).sum(-1)
    c = (oo * oo).sum(-1) - 1.0
    disc = b * b - 4 * a * c
    sq = safe_sqrt(disc)
    sgn_b = torch.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn_b * sq)
    t0 = q / torch.where(a.abs() > 1e-20, a, 1e-20)
    t1 = c / torch.where(q.abs() > 1e-20, q, INF)
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t = torch.where(tn > 0.0, tn, tf)
    return torch.where((disc >= 0.0) & (t > 0.0), t, INF)


def _t_disk(oo, od):
    dz = od[..., 2]
    ok = dz.abs() > 1e-12
    t = -oo[..., 2] / torch.where(ok, dz, 1e-12)
    p = oo + t[..., None] * od
    r2 = p[..., 0] ** 2 + p[..., 1] ** 2
    return torch.where(ok & (r2 <= 1.0), t, INF)


def _t_cylinder(oo, od):
    a = od[..., 0] ** 2 + od[..., 1] ** 2
    b = 2.0 * (oo[..., 0] * od[..., 0] + oo[..., 1] * od[..., 1])
    c = oo[..., 0] ** 2 + oo[..., 1] ** 2 - 1.0
    disc = b * b - 4 * a * c
    sq = safe_sqrt(disc)
    a_safe = torch.where(a.abs() > 1e-20, a, 1e-20)
    t0 = (-b - sq) / (2 * a_safe)
    t1 = (-b + sq) / (2 * a_safe)

    def z_ok(t):
        z = oo[..., 2] + t * od[..., 2]
        return (z >= 0.0) & (z <= 1.0) & (t > 0.0)

    v0 = z_ok(t0) & (disc >= 0.0)
    v1 = z_ok(t1) & (disc >= 0.0)
    return torch.where(v0, t0, torch.where(v1, t1, INF))


_T_FNS = {RECTANGLE: _t_rectangle, SPHERE: _t_sphere, DISK: _t_disk,
          CYLINDER: _t_cylinder}


def analytic_ts(table: ShapeTable, o, d, tmin=TMIN, tmax=None):
    """Distances of every (ray, analytic prim) pair: (R, P), inf = miss.
    `tmax` (R, 1) bounds them from above.  t is in world units: the object
    transform is affine and d is not renormalised."""
    oo, od = _object_ray(table.to_object, o, d)
    t = torch.full(oo.shape[:2], INF, dtype=o.dtype, device=o.device)
    for code, fn in _T_FNS.items():
        t = torch.where((table.kind == code)[None, :], fn(oo, od), t)
    valid = t > tmin
    if tmax is not None:
        valid = valid & (t < tmax)
    return torch.where(valid, t, INF)


def analytic_attrs(table: ShapeTable, o, d, t, idx):
    """Hit point, world normal and uv of the winning analytic prims idx
    (R,) at distances t (R,)."""
    to_obj = table.to_object[idx]
    kind = table.kind[idx]
    flip = table.flip[idx]
    p_world = o + t[..., None] * d
    po = torch.einsum('rij,rj->ri', to_obj[:, :3, :3], p_world) \
        + to_obj[:, :3, 3]
    zeros = torch.zeros_like(po[..., 0])
    n_rect = torch.stack([zeros, zeros, torch.ones_like(zeros)], -1)
    uv_rect = 0.5 * (po[..., :2] + 1.0)
    n_sph = normalize(po)
    azim = torch.atan2(po[..., 1], po[..., 0]) / TwoPi + 0.5
    uv_sph = torch.stack([azim, safe_acos(po[..., 2]) / Pi], -1)
    n_cyl = normalize(torch.stack([po[..., 0], po[..., 1], zeros], -1))
    uv_cyl = torch.stack([azim, po[..., 2]], -1)
    is_sph = (kind == SPHERE)[..., None]
    is_cyl = (kind == CYLINDER)[..., None]
    n_o = torch.where(is_sph, n_sph, torch.where(is_cyl, n_cyl, n_rect))
    uv = torch.where(is_sph, uv_sph, torch.where(is_cyl, uv_cyl, uv_rect))
    # normal to world: (M^-1)^T n
    n_w = normalize(torch.einsum('rji,rj->ri', to_obj[:, :3, :3], n_o))
    return p_world, n_w * flip[..., None], uv


def packed_bvh(bvh: bvh_mod.BVH, device) -> bk.PackedBVH:
    """The kernel tables of `bvh` on `device`, packed once per BVH (one
    BVH belongs to one SceneData)."""
    cache = bvh.__dict__.setdefault('_packed', {})
    if device not in cache:
        cache[device] = bk.pack(bvh).to(device)
    return cache[device]


def _triangle_closest(tri: TriData, o, d, bvh):
    """(t, face index (-1 on a miss), u, v) of the closest triangle."""
    if bvh is None:
        return ik.ray_triangle_closest(o, d, tri.v0, tri.e1, tri.e2)
    if o.device.type == 'cpu':
        return bvh_mod.traverse_closest(bvh, o, d, tmin=TMIN)
    return bk.bvh_closest(packed_bvh(bvh, o.device), o, d)


def closest_hit(table: ShapeTable, tri: TriData | None, o, d,
                bvh=None) -> SurfaceInteraction:
    """Closest hit over the analytic prims and the triangle soup (the
    reference's `Scene::ray_intersect`), for (R, 3) contiguous rays."""
    n = int(o.shape[0])
    t_an = analytic_ts(table, o, d)
    best_an = torch.argmin(t_an, dim=1)
    t_best_an = t_an.gather(1, best_an[:, None])[:, 0]
    has_tri = tri is not None and tri.n_faces > 0
    if has_tri:
        t_best_tr, idx_tr, u_tr, v_tr = _triangle_closest(tri, o, d, bvh)
        best_tr = idx_tr.long().clamp(min=0)
    else:
        t_best_tr = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    use_tri = t_best_tr < t_best_an
    t = torch.minimum(t_best_an, t_best_tr)
    valid = torch.isfinite(t)
    t_safe = torch.where(valid, t, 1.0)
    p, nrm, uv = analytic_attrs(table, o, d, t_safe, best_an)
    shape_idx = best_an.to(torch.int32)
    prim_idx = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if has_tri:
        ut = use_tri[:, None]
        p = torch.where(ut, o + t_safe[:, None] * d, p)
        nrm = torch.where(ut, tri.n[best_tr], nrm)
        uv = torch.where(ut, torch.stack([u_tr, v_tr], -1), uv)
        shape_idx = torch.where(use_tri, tri.shape_idx[best_tr], shape_idx)
        prim_idx = torch.where(use_tri, best_tr.to(torch.int32), prim_idx)
    # two-sided shading frame: the normal flipped to face the ray
    facing = (nrm * d).sum(-1) < 0.0
    n_sh = torch.where(facing[:, None], nrm, -nrm)
    frame = tfm.frame_from_normal(n_sh)
    wi = tfm.to_local(frame, -d)
    return SurfaceInteraction(
        valid=valid, t=torch.where(valid, t, INF), p=p,
        n=torch.where(valid[:, None], nrm, 0.0), sh_frame=frame, uv=uv,
        wi=wi, wi_world=-d, shape_idx=torch.where(valid, shape_idx, -1),
        prim_idx=torch.where(valid, prim_idx, -1))


def any_hit(table: ShapeTable, tri: TriData | None, o, d, maxt, bvh=None):
    """Shadow test: True where something blocks the (R, 3) rays before
    maxt (1 - 1e-3) (the reference's `Scene::ray_test`)."""
    t_an = analytic_ts(table, o, d, tmax=maxt[:, None] * _SHADOW_EPS)
    hit = torch.isfinite(t_an).any(dim=1)
    if tri is None or tri.n_faces == 0:
        return hit
    if bvh is None:
        return hit | ik.ray_triangle_any(o, d, tri.v0, tri.e1, tri.e2, maxt)
    if o.device.type == 'cpu':
        return hit | bvh_mod.traverse_any(bvh, o, d, maxt, tmin=TMIN)
    return hit | bk.bvh_any(packed_bvh(bvh, o.device), o, d, maxt)
