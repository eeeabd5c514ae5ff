"""Scene builder and its compiled tensor tables (counterpart of
`beifong_tpu/scene.py`, for analytic scenes).

A `Scene` collects host-side specs; `compile()` flattens them into
`SceneData`, a dataclass of tensors on one device.  The tables the
flagship leaves empty (emitters, triangles, BVH, medium) are `None` here:
the builder takes no spec that would fill them (`add` raises on one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ._device import resolve_device
from .bsdf.tables import BSDFSpec, BSDFTable
from .core.config import Band, ULTRASOUND_40K
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
    tris: None = None        # triangle meshes: ROADMAP A7
    emitters: None = None    # optical emitters: ROADMAP A12
    medium: None = None      # ambient media: ROADMAP A10 / B7
    bvh: None = None         # ROADMAP A7


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
        return SceneData(band=self.band,
                         shapes=ShapeTable.build(self.shapes, resolve, dev),
                         bsdfs=BSDFTable.build(self.bsdfs, dev),
                         textures=TextureTable.empty(dev),
                         transmitters=tx_table, receivers=rx_table)
