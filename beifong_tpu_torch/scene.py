"""Scene builder and its compiled tensor tables (counterpart of
`beifong_tpu/scene.py`).

A `Scene` collects host-side specs; `compile()` flattens them into
`SceneData`, a dataclass of tensors on one device, baking meshes into a
world-space triangle table (`tris`).  Above `bvh_threshold` faces it also
builds the eager wavefront's BVH (`bvh`, host tables; the K2 / K3 kernels
read them packed, once per SceneData and device).  The receive kernel
builds its own, leaf-aligned BVH from `tris`.  The textures
(`textures.TextureSpec`) become the texture table, which the BSDFs'
`texture` ids index.  The ambient medium (`media.py`, or None for vacuum)
moves to the scene's device.  The optical emitter table, which the port
does not fill, is `None`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .bsdf.tables import BSDFSpec, BSDFTable
from .core.config import Band, ULTRASOUND_40K
from .core.transform import AnimatedTransform
from .geometry import bvh as bvh_mod
from .geometry.intersect import TriData, closest_hit, any_hit
from .geometry.mesh import MeshSpec
from .geometry.shapes import InstanceSpec, ShapeGroup, ShapeSpec, ShapeTable
from .media import HeterogeneousMedium, HomogeneousMedium, LayeredMedium
from .core import transform as tfm
from .core.math import normalize
from .radar.endpoints import ReceiverTable, TransmitterTable
from .textures import TextureSpec, TextureTable, texture_eval


Medium = Union[HomogeneousMedium, LayeredMedium, HeterogeneousMedium]


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
    medium: Optional[Medium] = None   # ambient medium; None: vacuum
    bvh: Optional[bvh_mod.BVH] = None   # the wavefront's BVH over `tris`
    has_shading_maps: bool = False   # a BSDF with a normal or bump map

    # --- queries (the reference's Scene::ray_intersect / ray_test) ---

    def ray_intersect(self, o, d):
        si = closest_hit(self.shapes, self.tris, o.contiguous(),
                         d.contiguous(), bvh=self.bvh)
        if self.has_shading_maps:
            si = self._apply_shading_maps(si)
        return si

    def _apply_shading_maps(self, si):
        """The hits' shading frames perturbed by their BSDFs' normal or
        bump maps (the reference's `normalmap` / `bumpmap`), the tangent
        basis the frame's s and t rows, in the JAX package's arithmetic: a
        normal map's rgb in [0, 1] is the tangent normal 2 rgb - 1; a bump
        map tilts the normal by forward differences (1e-3 in uv) of its
        channel 0 times its scale (the BSDF's alpha).  The frame is rebuilt
        about the new normal and `wi` taken in it."""
        i = torch.clamp(self.bsdf_of(si.shape_idx), min=0).long()
        nm = self.bsdfs.normalmap_idx[i]
        bm = self.bsdfs.bumpmap_idx[i]
        frame = si.sh_frame
        rgb = texture_eval(self.textures, nm, si.uv)
        n_nm = tfm.to_world(frame, normalize(2.0 * rgb - 1.0))
        eps = 1e-3
        h0 = texture_eval(self.textures, bm, si.uv)[..., 0]
        hx = texture_eval(self.textures, bm, si.uv + torch.tensor(
            [eps, 0.0], device=si.uv.device))[..., 0]
        hy = texture_eval(self.textures, bm, si.uv + torch.tensor(
            [0.0, eps], device=si.uv.device))[..., 0]
        scale = self.bsdfs.alpha[i]
        dhdu = (hx - h0) / eps * scale
        dhdv = (hy - h0) / eps * scale
        n_bm = tfm.to_world(frame, normalize(torch.stack(
            [-dhdu, -dhdv, torch.ones_like(dhdu)], -1)))
        n_new = torch.where((nm >= 0)[:, None], n_nm,
                            torch.where((bm >= 0)[:, None], n_bm,
                                        frame[:, 2]))
        new_frame = tfm.frame_from_normal(normalize(n_new))
        use = (nm >= 0) | (bm >= 0)
        frame = torch.where(use[:, None, None], new_frame, frame)
        return dataclasses.replace(si, sh_frame=frame,
                                   wi=tfm.to_local(frame, si.wi_world))

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
    medium: Optional[Medium] = None   # ambient absorption of every path
    textures: list = dataclasses.field(default_factory=list)
    groups: dict = dataclasses.field(default_factory=dict)

    def add(self, *objs) -> "Scene":
        """Add specs; a ShapeGroup is kept by its id, and an InstanceSpec
        adds a copy of each of its group's shapes with to_world = the
        instance's to_world @ the member's, in float32."""
        for o in objs:
            if isinstance(o, ShapeGroup):
                self.groups[o.id] = o
            elif isinstance(o, InstanceSpec):
                for member in self.groups[o.group].shapes:
                    m = copy.copy(member)
                    m.to_world = np.asarray(o.to_world, np.float32) \
                        @ member.to_world
                    self.shapes.append(m)
            elif isinstance(o, ShapeSpec):
                self.shapes.append(o)
            elif isinstance(o, BSDFSpec):
                self.bsdfs.append(o)
            elif isinstance(o, TextureSpec):
                self.textures.append(o)
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

    def at_time(self, t: float) -> "Scene":
        """The scene at absolute time t: every `to_world` that is an
        `AnimatedTransform` (shapes, free-standing endpoints) is evaluated
        at t and the spec's `velocity` set from the keyframe derivative, so
        the intra-pulse Doppler follows the animation; an endpoint carried
        by an animated shape takes that shape's velocity.  Slow time is
        quasistatic: one snapshot per pulse (`receive.receive_cpi`).  The
        medium and the textures are the same in every snapshot."""

        def snap(spec, vel_override=None):
            anim = getattr(spec, 'to_world', None)
            animated = isinstance(anim, AnimatedTransform)
            if not animated and vel_override is None:
                return spec, None
            c = copy.copy(spec)
            vel = vel_override
            if animated:
                c.to_world = anim.eval(t)
                vel = anim.velocity(t)
            if hasattr(c, 'velocity'):
                c.velocity = np.asarray(vel, np.float32)
            return c, vel

        out = Scene(band=self.band, bsdfs=list(self.bsdfs),
                    medium=self.medium, textures=list(self.textures),
                    groups=dict(self.groups))
        endpoint_vel = {}   # endpoint id -> the carrying shape's velocity
        for s in self.shapes:
            c, vel = snap(s)
            out.shapes.append(c)
            if vel is not None:
                for kind in ('transmitter', 'receiver'):
                    eid = getattr(s, kind, None)
                    if eid is not None:
                        endpoint_vel[eid] = vel
        for src, dst in ((self.transmitters, out.transmitters),
                         (self.receivers, out.receivers)):
            for e in src:
                dst.append(snap(e, endpoint_vel.get(e.id))[0])
        return out

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
                dev, self.band.wavelength_centre)
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
                         bsdfs=BSDFTable.build(
                             self.bsdfs, dev, lambda tid: self._index_of(
                                 self.textures, tid)),
                         textures=TextureTable.build(self.textures, dev),
                         transmitters=tx_table, receivers=rx_table,
                         tris=tris, bvh=bvh,
                         medium=None if self.medium is None
                         else self.medium.to(dev),
                         has_shading_maps=any(
                             b.normalmap is not None or b.bumpmap is not None
                             for b in self.bsdfs))
