"""Analytic shape tables (counterpart of `beifong_tpu/geometry/shapes.py`).

Shape builders are host-side dataclasses (numpy); `ShapeTable.build`
flattens them into tensors.  Unit-object conventions follow the JAX
package: the unit rectangle spans [-1, 1]^2 in the z = 0 plane, normal +z;
the unit sphere has radius 1 at the origin; the unit disk radius 1 in the
z = 0 plane; the unit cylinder radius 1 with z in [0, 1].  Triangle meshes
(`geometry/mesh.py`) take one TRIANGLE row per mesh, their faces in
`SceneData.tris`.  A `shapegroup` names a list of shapes, and each
`instance` of it adds their copies to the scene under its own transform
(`Scene.add`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

RECTANGLE = 0
SPHERE = 1
DISK = 2
CYLINDER = 3
TRIANGLE = 4


@dataclasses.dataclass
class ShapeSpec:
    """Host-side shape description (pre-compile)."""

    kind: int
    to_world: np.ndarray                     # (4, 4) float32
    bsdf: Optional[str] = None
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    transmitter: Optional[str] = None
    receiver: Optional[str] = None
    flip_normals: bool = False


def _m4(m) -> np.ndarray:
    if m is None:
        return np.eye(4, dtype=np.float32)
    return np.asarray(m, np.float32).reshape(4, 4)


def rectangle(to_world=None, **kw) -> ShapeSpec:
    """Unit rectangle spanning [-1, 1]^2 in the z = 0 plane, normal +z."""
    return ShapeSpec(kind=RECTANGLE, to_world=_m4(to_world), **kw)


def sphere(to_world=None, center=None, radius: float = 1.0,
           **kw) -> ShapeSpec:
    """Sphere: the unit sphere under to_world @ translate(center) @
    scale(radius)."""
    m = _m4(to_world)
    if center is not None or radius != 1.0:
        c = np.zeros(3, np.float32) if center is None else \
            np.asarray(center, np.float32)
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = c
        sc = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
        m = m @ t @ sc
    return ShapeSpec(kind=SPHERE, to_world=m, **kw)


def disk(to_world=None, **kw) -> ShapeSpec:
    """Unit disk: radius 1 in the z = 0 plane, normal +z."""
    return ShapeSpec(kind=DISK, to_world=_m4(to_world), **kw)


def cylinder(to_world=None, **kw) -> ShapeSpec:
    """Unit cylinder: radius 1, z in [0, 1], open ends."""
    return ShapeSpec(kind=CYLINDER, to_world=_m4(to_world), **kw)


@dataclasses.dataclass
class ShapeGroup:
    """A named list of shapes for instancing (the reference's
    `shapegroup`): not drawn itself; each `instance` of it adds
    transformed copies of its shapes to the scene."""

    id: str
    shapes: list
    endpoint_kind: str = dataclasses.field(default='shapegroup', init=False)


@dataclasses.dataclass
class InstanceSpec:
    """An instance of the ShapeGroup `group` (the reference's `instance`):
    `Scene.add` adds each member with to_world = this to_world @ the
    member's to_world, in float32."""

    group: str
    to_world: np.ndarray
    endpoint_kind: str = dataclasses.field(default='instance', init=False)


def shapegroup(id, shapes) -> ShapeGroup:
    return ShapeGroup(id=id, shapes=list(shapes))


def instance(group, to_world=None) -> InstanceSpec:
    return InstanceSpec(group=group, to_world=_m4(to_world))


def trihedral(apex, toward, size: float = 1.0, **kw) -> list:
    """Trihedral corner reflector: three mutually perpendicular square
    plates of side `size` meeting at `apex`, the corner's symmetry axis
    (1, 1, 1) / sqrt(3) rotated onto `toward` (apex toward the radar).  No
    face then faces the boresight, so the return is the triple-bounce
    retro path, a point reflection through the apex.  Returns three
    rectangle specs (pass a smooth `conductor` BSDF through **kw)."""
    from ..core import transform as tfm
    a = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    b = np.asarray(toward, np.float64)
    b = b / np.linalg.norm(b)
    vx = np.cross(a, b)
    s = np.linalg.norm(vx)
    cth = float(a.dot(b))
    if s < 1e-12:
        rot = np.eye(3) if cth > 0 else -np.eye(3)
    else:
        k = np.array([[0, -vx[2], vx[1]],
                      [vx[2], 0, -vx[0]],
                      [-vx[1], vx[0], 0]])
        rot = np.eye(3) + k + k @ k * ((1 - cth) / s ** 2)
    h = size / 2
    faces = []
    for i in range(3):
        n_l = np.eye(3)[i]                    # face normal: local axis i
        t1, t2 = np.eye(3)[(i + 1) % 3], np.eye(3)[(i + 2) % 3]
        c = np.asarray(apex, np.float64) + rot @ (h * t1 + h * t2)
        m = tfm.compose(tfm.look_at(c, c + rot @ n_l, up=tuple(rot @ t2)),
                        tfm.scale(h))
        faces.append(rectangle(to_world=m.numpy(), **kw))
    return faces


@dataclasses.dataclass(frozen=True)
class ShapeTable:
    """Structure-of-arrays of analytic primitives."""

    kind: torch.Tensor             # (n,) int32
    to_world: torch.Tensor         # (n, 4, 4)
    to_object: torch.Tensor        # (n, 4, 4)
    velocity: torch.Tensor         # (n, 3)
    bsdf_idx: torch.Tensor         # (n,) int32, -1 if none
    transmitter_idx: torch.Tensor  # (n,) int32, -1 if none
    receiver_idx: torch.Tensor     # (n,) int32, -1 if none
    flip: torch.Tensor             # (n,) +1 / -1 normal sign
    surface_area: torch.Tensor     # (n,)

    @property
    def n(self) -> int:
        return int(self.kind.shape[0])

    @staticmethod
    def build(specs, resolve, device) -> "ShapeTable":
        """`resolve(kind_name, id)` maps string ids to table rows."""
        n = max(len(specs), 1)
        kind = np.full(n, -1, np.int32)   # padding rows are inert
        tw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        vel = np.zeros((n, 3), np.float32)
        bsdf = np.full(n, -1, np.int32)
        tx = np.full(n, -1, np.int32)
        rx = np.full(n, -1, np.int32)
        flip = np.ones(n, np.float32)
        for i, s in enumerate(specs):
            kind[i] = s.kind
            tw[i] = s.to_world
            vel[i] = s.velocity
            bsdf[i] = resolve('bsdf', s.bsdf)
            tx[i] = resolve('transmitter', s.transmitter)
            rx[i] = resolve('receiver', s.receiver)
            flip[i] = -1.0 if s.flip_normals else 1.0
        to = np.linalg.inv(tw)
        area = np.array([_surface_area(specs[i]) if i < len(specs) else 1.0
                         for i in range(n)], np.float32)

        def t(a):
            return torch.as_tensor(a, device=device)

        return ShapeTable(kind=t(kind), to_world=t(tw), to_object=t(to),
                          velocity=t(vel), bsdf_idx=t(bsdf),
                          transmitter_idx=t(tx), receiver_idx=t(rx),
                          flip=t(flip), surface_area=t(area))


def _surface_area(s: ShapeSpec) -> float:
    """World surface area from the to_world column norms (1.0 for a mesh:
    `Scene.compile` sets the mesh's own area)."""
    m = s.to_world
    sx = float(np.linalg.norm(m[:3, 0]))
    sy = float(np.linalg.norm(m[:3, 1]))
    sz = float(np.linalg.norm(m[:3, 2]))
    if s.kind == RECTANGLE:
        return 4.0 * sx * sy          # the unit rectangle spans [-1, 1]^2
    if s.kind == DISK:
        return float(np.pi) * sx * sy
    if s.kind == SPHERE:
        r = (sx + sy + sz) / 3.0
        return float(4.0 * np.pi * r * r)
    if s.kind == CYLINDER:
        return float(2.0 * np.pi) * sx * sz
    return 1.0


def aperture_extents(table: ShapeTable, idx):
    """Half-widths (wx, wy) of rectangle rows `idx`: the norms of their
    to_world x and y columns."""
    m = table.to_world[idx]
    return m[..., :3, 0].norm(dim=-1), m[..., :3, 1].norm(dim=-1)
