"""Analytic shape tables (counterpart of `beifong_tpu/geometry/shapes.py`).

Shape builders are host-side dataclasses (numpy); `ShapeTable.build`
flattens them into tensors.  Unit-object conventions follow the JAX
package: the unit rectangle spans [-1, 1]^2 in the z = 0 plane, normal +z.
This port builds rectangles and triangle meshes (`geometry/mesh.py`, one
TRIANGLE row per mesh, its faces in `SceneData.tris`); the other kinds
keep their codes so the packed tables read the same in both packages.
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


def rectangle(to_world=None, **kw) -> ShapeSpec:
    """Unit rectangle spanning [-1, 1]^2 in the z = 0 plane, normal +z."""
    m = np.eye(4, dtype=np.float32) if to_world is None else \
        np.asarray(to_world, np.float32).reshape(4, 4)
    return ShapeSpec(kind=RECTANGLE, to_world=m, **kw)


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
    if s.kind == TRIANGLE:
        return 1.0   # placeholder: Scene.compile sets the mesh's own area
    if s.kind != RECTANGLE:
        raise NotImplementedError(
            f'shape kind {s.kind}: only rectangles and meshes are ported '
            '(ROADMAP A3)')
    m = s.to_world
    return 4.0 * float(np.linalg.norm(m[:3, 0])) \
        * float(np.linalg.norm(m[:3, 1]))
