"""Carry a compiled scene over from the JAX package.

`scene_data_from_numpy(leaves, band)` turns the JAX `SceneData`'s leaves,
taken as numpy arrays and keyed by their pytree path ('.shapes.kind',
'.transmitters.wf.f_centre', ...), into the port's `SceneData`, so both
packages compute on the same tables.  The band is static metadata in the
JAX pytree, not a leaf, so it comes separately.  Nothing here imports JAX:
the caller flattens the pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .bsdf.tables import BSDFTable
from .core.config import Band
from .geometry.intersect import TriData
from .geometry.shapes import ShapeTable
from .radar.endpoints import ReceiverTable, TransmitterTable
from .radar.waveform import Waveform
from .scene import SceneData
from .textures import TextureTable

_PORTED_ELSEWHERE = {'.bvh': "the wavefront's BVH (ROADMAP A4)",
                     '.medium': 'ambient media (ROADMAP A10)'}


def scene_data_from_numpy(leaves: dict, band: Band, device=None) -> SceneData:
    """Build the port's `SceneData` from JAX `SceneData` leaves.  Leaves of
    tables the port does not hold yet raise `NotImplementedError`; the
    optical emitter table, which the receive path never reads, is
    skipped."""
    dev = resolve_device(device)
    for key in leaves:
        for prefix, what in _PORTED_ELSEWHERE.items():
            if key.startswith(prefix):
                raise NotImplementedError(f'{key}: {what}')

    def table(cls, prefix, **extra):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in extra:
                continue
            kw[f.name] = torch.tensor(np.array(leaves[f'{prefix}.{f.name}']),
                                      device=dev)
        return cls(**kw, **extra)

    bsdf_types = np.asarray(leaves['.bsdfs.type'])
    bsdfs = table(BSDFTable, '.bsdfs',
                  present=tuple(sorted({int(t) for t in bsdf_types})))
    tx = None
    if '.transmitters.kind' in leaves:
        wf = table(Waveform, '.transmitters.wf')
        tx = table(TransmitterTable, '.transmitters', wf=wf)
    rx = table(ReceiverTable, '.receivers') \
        if '.receivers.kind' in leaves else None
    tris = table(TriData, '.tris') if '.tris.v0' in leaves else None
    return SceneData(band=band, shapes=table(ShapeTable, '.shapes'),
                     bsdfs=bsdfs, textures=table(TextureTable, '.textures'),
                     transmitters=tx, receivers=rx, tris=tris)
