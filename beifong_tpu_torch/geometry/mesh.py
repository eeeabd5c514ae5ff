"""Triangle meshes (counterpart of `beifong_tpu/geometry/mesh.py`).

A `MeshSpec` is a host-side triangle soup in object space; `Scene.compile`
bakes it into world space (`geometry.intersect.TriData`), so the kernels
need no per-ray transforms.  The OBJ, PLY, serialized and Blender loaders
are ROADMAP A10.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .shapes import ShapeSpec, TRIANGLE


@dataclasses.dataclass
class MeshSpec(ShapeSpec):
    """Host-side triangle mesh (kind = TRIANGLE)."""

    vertices: np.ndarray = None   # (V, 3) float32, object space
    faces: np.ndarray = None      # (F, 3) int32

    def __init__(self, vertices, faces, to_world=None, **kw):
        m = np.eye(4, dtype=np.float32) if to_world is None else \
            np.asarray(to_world, np.float32).reshape(4, 4)
        super().__init__(kind=TRIANGLE, to_world=m, **kw)
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int32).reshape(-1, 3)

    def world_vertices(self) -> np.ndarray:
        m = self.to_world
        return self.vertices @ m[:3, :3].T + m[:3, 3]

    def surface_area_world(self) -> float:
        v = self.world_vertices()
        a, b, c = v[self.faces[:, 0]], v[self.faces[:, 1]], v[self.faces[:, 2]]
        return float(0.5 * np.linalg.norm(np.cross(b - a, c - a),
                                          axis=1).sum())


def make_grid(nx: int = 1, ny: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Unit grid mesh on [-1, 1]^2, z = 0: (vertices (V, 3) float32, faces
    (2 nx ny, 3) int32)."""
    xs = np.linspace(-1, 1, nx + 1)
    ys = np.linspace(-1, 1, ny + 1)
    vv = np.array([[x, y, 0.0] for y in ys for x in xs], np.float32)
    ff = []
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i
            b = a + 1
            c = a + nx + 1
            d = c + 1
            ff += [[a, b, d], [a, d, c]]
    return vv, np.array(ff, np.int32)
