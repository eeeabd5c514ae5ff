"""Scene builder and its compiled tensor tables (counterpart of
`beifong_tpu/scene.py`).

A `Scene` collects host-side specs; `compile()` flattens them into
`SceneData`, a dataclass of tensors on one device, baking meshes into a
world-space triangle table (`tris`).  Above `bvh_threshold` faces it also
builds the eager wavefront's BVH (`bvh`, host tables; the K2 / K3 kernels
read them packed, once per SceneData and device).  The receive kernel
builds its own, leaf-aligned BVH from `tris`.  The tables the port does
not fill yet (emitters, medium) are `None`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .bsdf.tables import BSDFSpec, BSDFTable
from .core.config import Band, ULTRASOUND_40K
from .geometry import bvh as bvh_mod
from .geometry.intersect import TriData, closest_hit, any_hit
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
    bvh: Optional[bvh_mod.BVH] = None   # the wavefront's BVH over `tris`

    # --- queries (the reference's Scene::ray_intersect / ray_test) ---

    def ray_intersect(self, o, d):
        return closest_hit(self.shapes, self.tris, o.contiguous(),
                           d.contiguous(), bvh=self.bvh)

    def ray_test(self, o, d, maxt):
        return any_hit(self.shapes, self.tris, o.contiguous(),
                       d.contiguous(), maxt.contiguous(), bvh=self.bvh)

    # --- per-hit attribute gathers ---

    def bsdf_of(self, shape_idx):
        return torch.where(shape_idx >= 0, self.shapes.bsdf_idx[
            torch.clamp(shape_idx, min=0).long()], -1)

    def transmitter_of(self, shape_idx):
        return torch.where(shape_idx >= 0, self.shapes.transmitter_idx[
            torch.clamp(shape_idx, min=0).long()], -1)

    def velocity_of(self, shape_idx):
        return torch.where((shape_idx >= 0)[..., None], self.shapes.velocity[
            torch.clamp(shape_idx, min=0).long()], 0.0)


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

    def compile(self, use_bvh: str | bool = 'auto', bvh_threshold: int = 1024,
                device=None) -> SceneData:
        """Flatten the scene into tensors on `device` (`cuda` by default).
        `use_bvh`: True builds the wavefront's BVH over the mesh faces,
        'auto' above `bvh_threshold` faces, False never."""
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
        bvh = None
        if tris is not None and (use_bvh is True or (
                use_bvh == 'auto' and tris.n_faces > bvh_threshold)):
            bvh = bvh_mod.build(*(c.cpu().numpy()
                                  for c in (tris.v0, tris.e1, tris.e2)))
        return SceneData(band=self.band, shapes=shapes,
                         bsdfs=BSDFTable.build(self.bsdfs, dev),
                         textures=TextureTable.empty(dev),
                         transmitters=tx_table, receivers=rx_table,
                         tris=tris, bvh=bvh)
