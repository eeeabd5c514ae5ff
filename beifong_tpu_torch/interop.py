"""Carry a compiled scene over from the JAX package.

`scene_data_from_numpy(leaves, band)` turns the JAX `SceneData`'s leaves,
taken as numpy arrays and keyed by their pytree path ('.shapes.kind',
'.transmitters.wf.f_centre', ...), into the port's `SceneData`, so both
packages compute on the same tables.  The band is static metadata in the
JAX pytree, not a leaf, so it comes separately.  Nothing here imports JAX:
the caller flattens the pytree.  `cpi_tables_from_numpy` does the same for
the per-pulse snapshots of a coherent processing interval (CPI), the JAX
scene's `at_time(t0 + p / prf).compile()` of each pulse p, and packs them
for the receive kernel's one-launch CPI.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .bsdf.tables import BSDFTable
from .core.config import Band
from .geometry.bvh import BVH
from .geometry.intersect import TriData
from .geometry.shapes import ShapeTable
from .media import HeterogeneousMedium, HomogeneousMedium, LayeredMedium
from .radar.endpoints import ReceiverTable, TransmitterTable
from .radar.waveform import Waveform
from .scene import SceneData
from .textures import TextureTable

# a JAX medium's kind, told by the leaves it has
_MEDIA = ((('sigma_t',), HomogeneousMedium),
          (('sigma', 'z_min', 'z_max'), LayeredMedium),
          (('sigma_grid', 'box_min', 'box_max'), HeterogeneousMedium))


def _medium(leaves: dict, dev):
    """The port's medium of the JAX `.medium.*` leaves (None if absent)."""
    names = {k[len('.medium.'):] for k in leaves if k.startswith('.medium.')}
    if not names:
        return None
    for keys, cls in _MEDIA:
        if set(keys) <= names:
            return cls(**{f.name: torch.tensor(
                np.array(leaves[f'.medium.{f.name}'], np.float32),
                device=dev) for f in dataclasses.fields(cls)})
    raise NotImplementedError(f'ambient medium with leaves {sorted(names)}: '
                              'not one of the three media')


def scene_data_from_numpy(leaves: dict, band: Band, device=None) -> SceneData:
    """Build the port's `SceneData` from JAX `SceneData` leaves, a
    mesh-attribute texture's per-face values among them; the optical
    emitter table, which the receive path never reads, is skipped.  The
    shading-map flag is static metadata in the JAX pytree: it is set where
    a normal or bump map column names a texture.  The ambient medium's kind
    follows from its leaves: `sigma_t` homogeneous, `sigma` / `z_min` /
    `z_max` layered, `sigma_grid` / `box_min` / `box_max` the 3-D grid."""
    dev = resolve_device(device)

    def table(cls, prefix, **extra):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in extra:
                continue
            kw[f.name] = torch.tensor(np.array(leaves[f'{prefix}.{f.name}']),
                                      device=dev)
        return cls(**kw, **extra)

    bsdf_types = np.asarray(leaves['.bsdfs.type'])
    grid = leaves.get('.bsdfs.measured_grid')
    bsdfs = table(BSDFTable, '.bsdfs',
                  present=tuple(sorted({int(t) for t in bsdf_types})),
                  measured_grid=None if grid is None
                  else torch.tensor(np.array(grid), device=dev))
    tx = None
    if '.transmitters.kind' in leaves:
        wf = table(Waveform, '.transmitters.wf')
        tx = table(TransmitterTable, '.transmitters', wf=wf)
    rx = table(ReceiverTable, '.receivers') \
        if '.receivers.kind' in leaves else None
    tris = table(TriData, '.tris') if '.tris.v0' in leaves else None
    bvh = BVH(**{f.name: np.array(leaves[f'.bvh.{f.name}'])
                 for f in dataclasses.fields(BVH)}) \
        if '.bvh.bb_min' in leaves else None
    # a mesh-attribute texture's per-face values and its row, where the
    # scene has one
    attr = leaves.get('.textures.face_attr')
    textures = table(
        TextureTable, '.textures',
        face_attr=None if attr is None
        else torch.tensor(np.array(attr), device=dev),
        face_attr_row=None if attr is None
        else int(leaves['.textures.face_attr_row']))
    return SceneData(band=band, shapes=table(ShapeTable, '.shapes'),
                     bsdfs=bsdfs, textures=textures,
                     transmitters=tx, receivers=rx, tris=tris, bvh=bvh,
                     medium=_medium(leaves, dev),
                     has_shading_maps=bool(
                         (bsdfs.normalmap_idx >= 0).any()
                         or (bsdfs.bumpmap_idx >= 0).any()))


def cpi_tables_from_numpy(pulse_leaves: list, band: Band, rx,
                          shape_idx: int):
    """The receive kernel's stacked CPI tables (`receive_kernel.PackedCPI`)
    of a JAX scene's per-pulse snapshots: `pulse_leaves[p]` holds the
    leaves of pulse p's compiled snapshot, `rx` is the port's receiver
    spec and `shape_idx` the row of its shape.  Both packages then pack
    the same CPI."""
    from .integrators.receive_kernel import pack_cpi_tables
    return pack_cpi_tables([scene_data_from_numpy(leaves, band, device='cpu')
                            for leaves in pulse_leaves], rx, shape_idx)
