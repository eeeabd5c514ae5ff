"""Scene builder and its compiled tensor tables (counterpart of
`beifong_tpu/scene.py`, for rectangles and triangle meshes).

A `Scene` collects host-side specs; `compile()` flattens them into
`SceneData`, a dataclass of tensors on one device, baking meshes into a
world-space triangle table (`tris`).  The tables the port does not fill
yet (emitters, medium) are `None`, and so is `bvh`: it is the JAX
package's wavefront BVH (ROADMAP A4); the receive kernel builds its own
from `tris`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .bsdf.tables import BSDFSpec, BSDFTable
from .core.config import Band, ULTRASOUND_40K
from .geometry.intersect import TriData
from .geometry.mesh import MeshSpec
from .geometry.shapes import ShapeSpec, ShapeTable
from .radar.endpoints import ReceiverTable, TransmitterTable
from .textures import TextureTable


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Everything the receive path reads, as tensors on one device."""

    band: Band
    shapes: ShapeTable
    bsdfs: BSDFTable
    textures: TextureTable
    transmitters: Optional[TransmitterTable]
    receivers: Optional[ReceiverTable]
    tris: Optional[TriData] = None   # world-space faces of every mesh
    emitters: None = None    # optical emitters: ROADMAP A12
    medium: None = None      # ambient media: ROADMAP A10 / B7
    bvh: None = None         # the wavefront's BVH: ROADMAP A4


@dataclasses.dataclass
class Scene:
    """Host-side scene description (mutable builder)."""

    band: Band = ULTRASOUND_40K
    shapes: list = dataclasses.field(default_factory=list)
    bsdfs: list = dataclasses.field(default_factory=list)
    transmitters: list = dataclasses.field(default_factory=list)
    receivers: list = dataclasses.field(default_factory=list)

    def add(self, *objs) -> "Scene":
        for o in objs:
            if isinstance(o, ShapeSpec):
                self.shapes.append(o)
            elif isinstance(o, BSDFSpec):
                self.bsdfs.append(o)
            else:
                kind = getattr(o, 'endpoint_kind', None)
                if kind == 'transmitter':
                    self.transmitters.append(o)
                elif kind == 'receiver':
                    self.receivers.append(o)
                else:
                    raise TypeError(f"don't know where to put {o!r}")
        return self

    def _index_of(self, lst, id_) -> int:
        if id_ is None:
            return -1
        for i, s in enumerate(lst):
            if s.id == id_:
                return i
        raise KeyError(f'unresolved reference {id_!r}')

    def shape_index_of_endpoint(self, kind: str, endpoint_id: str) -> int:
        """Row of the shape that carries endpoint `endpoint_id` (-1 if
        free-standing)."""
        for i, s in enumerate(self.shapes):
            if getattr(s, kind, None) == endpoint_id:
                return i
        return -1

    def compile(self, device=None) -> SceneData:
        """Flatten the scene into tensors on `device` (`cuda` by default)."""
        dev = resolve_device(device)
        lists = {'bsdf': self.bsdfs, 'transmitter': self.transmitters,
                 'receiver': self.receivers}

        def resolve(kind, id_):
            return self._index_of(lists[kind], id_)

        tx_table = rx_table = None
        if self.transmitters:
            tx_table = TransmitterTable.build(
                self.transmitters,
                lambda tid: self.shape_index_of_endpoint('transmitter', tid),
                dev)
        if self.receivers:
            rx_table = ReceiverTable.build(
                self.receivers,
                lambda rid: self.shape_index_of_endpoint('receiver', rid),
                dev)
        shapes = ShapeTable.build(self.shapes, resolve, dev)
        # meshes: world-space faces, and the mesh's own surface area
        areas = shapes.surface_area.cpu().numpy().copy()
        chunks = []
        for i, s in enumerate(self.shapes):
            if isinstance(s, MeshSpec):
                areas[i] = s.surface_area_world()
                v = s.world_vertices()
                a, b, c = (v[s.faces[:, 0]], v[s.faces[:, 1]],
                           v[s.faces[:, 2]])
                e1, e2 = b - a, c - a
                n = np.cross(e1, e2)
                n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                                   1e-20)
                chunks.append((a, e1, e2, n, np.full(len(a), i, np.int32)))
        shapes = dataclasses.replace(
            shapes, surface_area=torch.as_tensor(areas, device=dev))
        tris = None
        if chunks:
            cols = [np.concatenate([c[j] for c in chunks]) for j in range(5)]
            tris = TriData(*(torch.as_tensor(
                c.astype(np.float32) if j < 4 else c, device=dev)
                for j, c in enumerate(cols)))
        return SceneData(band=self.band, shapes=shapes,
                         bsdfs=BSDFTable.build(self.bsdfs, dev),
                         textures=TextureTable.empty(dev),
                         transmitters=tx_table, receivers=rx_table,
                         tris=tris)
