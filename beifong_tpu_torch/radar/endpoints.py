"""Transmitter and receiver endpoints and their sampling and evaluation
ops (counterpart of `beifong_tpu/radar/endpoints.py`).

Transmitters compile into a tensor table (the receive kernel packs it; the
eager wavefront samples and evaluates it per lane): Wigner apertures,
phased arrays (their virtual element pairs, steered at the band-centre
wavelength) and plain area transmitters.  The receiver stays a host spec
whose ADC config sets the binning.  A phased receive array is analog
(its cross-WDF weights each receive ray, `rx_sample_ray` /
`rx_aperture_weight`) or, through `receive.receive_mimo`, digital: its
frame, per-element offsets and single-element pattern gain are here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import film as film_mod
from ..core import transform as tfm, warp
from ..core.math import Pi, TwoPi, sinc
from ..geometry.sample import sample_position
from ..interaction import DirectionSample
from .waveform import Waveform, stack as wf_stack
from .wigner import phased_aperture_gain, rect_aperture_gain

WIGNER = 0
PHASED = 1
AREA = 2
OMNI = 3


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """Signal store config: fast-time bins x frequency bins."""

    n_time: int = 64
    n_freq: int = 1
    sampling_start: float = 0.0     # fast-time window start [s]
    sampling_time: float = 1e-3     # window length [s]
    freq_lo: float = 0.0            # frequency axis window [Hz]
    freq_hi: float = 1.0
    rfilter: int = film_mod.TENT


@dataclasses.dataclass
class TransmitterSpec:
    id: str
    kind: int
    waveform: Waveform
    gain: float = 1.0
    resample_freq: bool = False
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    # phased array (kind PHASED): n_elems elements elem_spacing apart along
    # elem_axis (in the attached shape's frame), each of half-widths
    # elem_wid, steered steer_deg off the normal toward +elem_axis
    n_elems: int = 1
    elem_spacing: float = 0.0
    elem_axis: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    elem_wid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.01, 0.01], np.float32))
    steer_deg: float = 0.0
    endpoint_kind: str = dataclasses.field(default='transmitter', init=False)


def wigner_transmitter(id, waveform, gain=1.0,
                       resample_freq=False) -> TransmitterSpec:
    """Aperture transmitter on a rectangle shape; directional gain from the
    shape's Wigner distribution."""
    return TransmitterSpec(id=id, kind=WIGNER, waveform=waveform, gain=gain,
                           resample_freq=resample_freq)


def phased_transmitter(id, waveform, n_elems, elem_spacing, elem_wid,
                       steer_deg=0.0, elem_axis=(1, 0, 0), gain=1.0,
                       resample_freq=False) -> TransmitterSpec:
    """Phased-array transmitter on a rectangle shape: `n_elems` elements
    along `elem_axis`, `elem_spacing` apart, each of half-widths
    `elem_wid`, its beam steered `steer_deg` degrees."""
    return TransmitterSpec(id=id, kind=PHASED, waveform=waveform, gain=gain,
                           resample_freq=resample_freq, n_elems=int(n_elems),
                           elem_spacing=float(elem_spacing),
                           elem_axis=np.asarray(elem_axis, np.float32),
                           elem_wid=np.asarray(elem_wid, np.float32),
                           steer_deg=float(steer_deg))


def area_transmitter(id, waveform, gain=1.0,
                     resample_freq=False) -> TransmitterSpec:
    """Plain diffuse area transmitter on a shape (no directivity)."""
    return TransmitterSpec(id=id, kind=AREA, waveform=waveform, gain=gain,
                           resample_freq=resample_freq)


@dataclasses.dataclass
class ReceiverSpec:
    id: str
    kind: int
    adc: ADCConfig
    lo_waveform: Optional[Waveform] = None
    receive_type: str = 'raw'      # raw | raw_resample | mix_resample | mixer
    gain: float = 1.0
    to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    # phased array: n_elems elements elem_spacing apart along elem_axis
    # (in the attached shape's frame), each of half-widths elem_wid
    n_elems: int = 1
    elem_spacing: float = 0.0
    elem_axis: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    elem_wid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.01, 0.01], np.float32))
    steer_deg: float = 0.0
    endpoint_kind: str = dataclasses.field(default='receiver', init=False)


def wigner_receiver(id, adc, receive_type='raw', lo_waveform=None,
                    gain=1.0) -> ReceiverSpec:
    """Shape-attached aperture receiver."""
    return ReceiverSpec(id=id, kind=WIGNER, adc=adc,
                        receive_type=receive_type, lo_waveform=lo_waveform,
                        gain=gain)


def phased_receiver(id, adc, n_elems, elem_spacing, elem_wid, steer_deg=0.0,
                    elem_axis=(1, 0, 0), receive_type='raw', lo_waveform=None,
                    gain=1.0) -> ReceiverSpec:
    """Phased receive array on a shape: `n_elems` elements along
    `elem_axis`, `elem_spacing` apart, each of half-widths `elem_wid`.
    It runs through `receive.receive_mimo` (one I / Q channel an
    element)."""
    return ReceiverSpec(id=id, kind=PHASED, adc=adc,
                        receive_type=receive_type, lo_waveform=lo_waveform,
                        gain=gain, n_elems=int(n_elems),
                        elem_spacing=float(elem_spacing),
                        elem_axis=np.asarray(elem_axis, np.float32),
                        elem_wid=np.asarray(elem_wid, np.float32),
                        steer_deg=float(steer_deg))


def omni_receiver(id, adc, position=(0, 0, 0), receive_type='raw',
                  lo_waveform=None, gain=1.0) -> ReceiverSpec:
    """Isotropic point receiver."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = position
    return ReceiverSpec(id=id, kind=OMNI, adc=adc, receive_type=receive_type,
                        lo_waveform=lo_waveform, gain=gain, to_world=m)


def _elem_locs(spec) -> np.ndarray:
    """(E, 3) element centres in the array's local frame [m], symmetric
    about its origin along the normalised element axis."""
    n = spec.n_elems
    axis = spec.elem_axis / max(np.linalg.norm(spec.elem_axis), 1e-20)
    if n % 2 == 0:
        return np.stack([-spec.elem_spacing * axis * (i - n / 2.0 + 0.5)
                         for i in range(n)]).astype(np.float32)
    return np.stack([-spec.elem_spacing * axis * (i - (n - 1) / 2.0)
                     for i in range(n)]).astype(np.float32)


def _phased_pairs(spec, band_wl_centre: float):
    """The E^2 virtual element pairs (i, j) in the array's local frame:
    midpoints (E^2, 3), baselines r_i - r_j (E^2, 3) and steering phases
    (E^2,), baked at the band-centre wavelength."""
    n = spec.n_elems
    axis = spec.elem_axis / max(np.linalg.norm(spec.elem_axis), 1e-20)
    locs = _elem_locs(spec)
    mids, bases, psis = [], [], []
    steer = np.sin(np.deg2rad(spec.steer_deg))
    k_steer = 2.0 * np.pi / band_wl_centre * steer
    for i in range(n):
        for j in range(n):
            mids.append((locs[i] + locs[j]) / 2.0)
            bases.append(locs[i] - locs[j])
            # the conjugate pair's steering term exp(-i k (ri - rj) . axis)
            psis.append(-k_steer * float(np.dot(locs[i] - locs[j], axis)))
    return (np.asarray(mids, np.float32), np.asarray(bases, np.float32),
            np.asarray(psis, np.float32))


@dataclasses.dataclass(frozen=True)
class TransmitterTable:
    kind: torch.Tensor           # (T,) int32
    shape_idx: torch.Tensor      # (T,) int32, -1 for free-standing
    gain: torch.Tensor           # (T,)
    resample: torch.Tensor       # (T,) bool
    wf: Waveform                 # stacked (T,)
    velocity: torch.Tensor       # (T, 3)
    # phased-array pair geometry, one empty pair per Wigner transmitter
    elem_mid: torch.Tensor       # (T, K, 3)
    elem_baseline: torch.Tensor  # (T, K, 3)
    psi: torch.Tensor            # (T, K)
    pair_mask: torch.Tensor      # (T, K) bool
    elem_wid: torch.Tensor       # (T, 2)

    @property
    def n(self) -> int:
        return int(self.kind.shape[0])

    @staticmethod
    def build(specs: list[TransmitterSpec], shape_of, device,
              band_wl_centre: float) -> "TransmitterTable":
        """The table of `specs`; a phased array's K = n_elems^2 pairs
        (padded to the largest K, one empty pair if none) are steered at
        `band_wl_centre` [m]."""
        n = len(specs)
        K = max(max((s.n_elems ** 2 for s in specs), default=1), 1)
        mids = np.zeros((n, K, 3), np.float32)
        bases = np.zeros((n, K, 3), np.float32)
        psis = np.zeros((n, K), np.float32)
        mask = np.zeros((n, K), bool)
        wid = np.full((n, 2), 0.01, np.float32)
        for i, s in enumerate(specs):
            if s.kind == PHASED:
                m, b, p = _phased_pairs(s, band_wl_centre)
                k = len(m)
                mids[i, :k], bases[i, :k], psis[i, :k] = m, b, p
                mask[i, :k] = True
                wid[i] = s.elem_wid

        def t(a):
            return torch.as_tensor(a, device=device)

        wf = wf_stack([s.waveform for s in specs])
        return TransmitterTable(
            kind=t(np.asarray([s.kind for s in specs], np.int32)),
            shape_idx=t(np.asarray([shape_of(s.id) for s in specs],
                                   np.int32)),
            gain=t(np.asarray([s.gain for s in specs], np.float32)),
            resample=t(np.asarray([s.resample_freq for s in specs], bool)),
            wf=wf.to(device),
            velocity=t(np.stack([np.asarray(s.velocity, np.float32)
                                 for s in specs])),
            elem_mid=t(mids), elem_baseline=t(bases), psi=t(psis),
            pair_mask=t(mask), elem_wid=t(wid))


@dataclasses.dataclass(frozen=True)
class ReceiverTable:
    """Shape attachment of each receiver; `receive()` works from the host
    `ReceiverSpec`."""

    kind: torch.Tensor
    shape_idx: torch.Tensor

    @staticmethod
    def build(specs, shape_of, device) -> "ReceiverTable":
        return ReceiverTable(
            kind=torch.as_tensor(np.asarray([s.kind for s in specs],
                                            np.int32), device=device),
            shape_idx=torch.as_tensor(
                np.asarray([shape_of(s.id) for s in specs], np.int32),
                device=device))


# ---------------------------------------------------------------------------
# transmitter ops (per lane)
# ---------------------------------------------------------------------------


def tx_aperture_gain(scene, tx_idx, p_world, d_world, wavelength):
    """Directional aperture gain of transmitter rows tx_idx for radiation
    leaving p_world along d_world at `wavelength` (n,): the rectangle WDF
    of a Wigner transmitter, the cross-WDF of a phased array's pairs, 1
    for an area transmitter."""
    tx = scene.transmitters
    i = torch.clamp(tx_idx, min=0).long()
    kind = tx.kind[i]
    sidx = torch.clamp(tx.shape_idx[i], min=0).long()
    g = torch.where(kind == WIGNER, rect_aperture_gain(
        scene.shapes, sidx, p_world, d_world, wavelength), 1.0)
    ph = (kind == PHASED).nonzero().squeeze(1)
    if ph.numel():
        # the array's frame from its shape; the pairs' local (s, t)
        # offsets along it
        tw = scene.shapes.to_world[sidx[ph]]
        s_ax, t_ax = tw[:, :3, 0], tw[:, :3, 1]
        sn = s_ax / torch.clamp(s_ax.norm(dim=-1, keepdim=True), min=1e-20)
        tn = t_ax / torch.clamp(t_ax.norm(dim=-1, keepdim=True), min=1e-20)
        ip = i[ph]

        def world(local):
            return local[..., 0:1] * sn[:, None] + local[..., 1:2] * tn[:, None]
        g[ph] = phased_aperture_gain(
            world(tx.elem_mid[ip]), world(tx.elem_baseline[ip]), tx.psi[ip],
            tx.pair_mask[ip], sn, tn, tx.elem_wid[ip], tw[:, :3, 3],
            p_world[ph], d_world[ph], wavelength[ph])
    return g


def tx_eval(scene, tx_idx, p_world, d_out_world, cos_theta, time_at_tx,
            freq_at_tx, wavelength):
    """Weight of a direct transmitter hit: W_signal(t, f) x gain x
    aperture WDF x 2 pi, on the front side.  Returns (weight (n,),
    f_emitted (n,)); a resampling transmitter emits at its instantaneous
    frequency."""
    tx = scene.transmitters
    i = torch.clamp(tx_idx, min=0).long()
    wf = tx.wf.row(i)
    f_emit = torch.where(tx.resample[i], wf.inst_freq(time_at_tx),
                         freq_at_tx)
    sig = wf.eval_wdf(time_at_tx, f_emit)
    wl_emit = scene.band.c / torch.clamp(f_emit, min=1e-6)
    ap = tx_aperture_gain(scene, tx_idx, p_world, d_out_world, wl_emit)
    w = sig * tx.gain[i] * ap * TwoPi
    live = (tx_idx >= 0) & (cos_theta > 0.0)
    return torch.where(live, w, 0.0), f_emit


def tx_sample_geom(scene, ref_p, u_sel, u_pos):
    """Pick a transmitter uniformly and a point on its shape.  Returns
    (DirectionSample, tx_row (n,), cos at the transmitter (n,))."""
    tx = scene.transmitters
    n_tx = tx.n
    e = torch.clamp((u_sel * n_tx).to(torch.int32), 0, n_tx - 1).long()
    sidx = torch.clamp(tx.shape_idx[e], min=0).long()
    p_s, n_s, pdf_a, uv = sample_position(scene.shapes, sidx, u_pos)
    d_vec = p_s - ref_p
    dist2 = (d_vec * d_vec).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    d = d_vec / dist[..., None]
    cos_tx = (-d * n_s).sum(-1)
    pdf_sa = torch.where(cos_tx > 1e-6,
                         pdf_a * dist2 / torch.clamp(cos_tx, min=1e-6), 0.0)
    pdf = pdf_sa / n_tx
    ds = DirectionSample(p=p_s, n=n_s, d=d, dist=dist, pdf=pdf,
                         delta=torch.zeros_like(pdf, dtype=torch.bool),
                         uv=uv)
    return ds, e, cos_tx


def tx_sample_direction(scene, ref_p, time_at_ref, freq_at_ref, u_sel,
                        u_pos, t_emit_override=None):
    """NEE toward the transmitters with the retarded emission time (or
    `t_emit_override`, the deferred gate sample).  Returns
    (DirectionSample, weight = radiance / pdf (n,), f_emit (n,),
    t_emit (n,), tx_row (n,))."""
    ds, e, cos_tx = tx_sample_geom(scene, ref_p, u_sel, u_pos)
    t_emit = time_at_ref - ds.dist / scene.band.c \
        if t_emit_override is None else t_emit_override
    w_tx, f_emit = tx_eval(scene, e, ds.p, -ds.d, cos_tx, t_emit,
                           freq_at_ref,
                           scene.band.c / torch.clamp(freq_at_ref, min=1e-6))
    weight = torch.where(ds.pdf > 0.0,
                         w_tx / torch.clamp(ds.pdf, min=1e-30), 0.0)
    return ds, weight, f_emit, t_emit, e


def tx_pdf_direction(scene, tx_idx, dist, cos_at_tx):
    """Solid-angle pdf of sampling that transmitter direction (for MIS)."""
    tx = scene.transmitters
    i = torch.clamp(tx_idx, min=0).long()
    sidx = torch.clamp(tx.shape_idx[i], min=0).long()
    area_pdf = 1.0 / torch.clamp(scene.shapes.surface_area[sidx], min=1e-20)
    pdf = area_pdf * dist * dist / torch.clamp(cos_at_tx, min=1e-6) / tx.n
    return torch.where((tx_idx >= 0) & (cos_at_tx > 1e-6), pdf, 0.0)


# ---------------------------------------------------------------------------
# receiver ops (host spec, per-lane sampling)
# ---------------------------------------------------------------------------


def rx_sample_ray(scene, rx_spec: ReceiverSpec, shape_idx: int, time,
                  u_pos, u_dir, wavelength=None):
    """The receive ray: a point on the antenna and a direction, with the
    importance weight.  A rectangle aperture draws from a 50/50 mixture of
    the cosine hemisphere and a power-cosine lobe as wide as the WDF main
    lobe (first null at sin(theta) = lambda / 2w); u_dir[:, 0] picks the
    branch and is rescaled.  A phased array (of more than one element)
    draws a point over its bounding rectangle and a cosine-hemisphere
    direction.  An omni receiver samples the sphere.  Returns (o, d,
    weight)."""
    n = int(time.shape[0])
    dev = time.device
    if rx_spec.kind == OMNI:
        p = torch.as_tensor(np.asarray(rx_spec.to_world)[:3, 3],
                            dtype=torch.float32, device=dev).expand(n, 3)
        d = warp.square_to_uniform_sphere(u_dir)
        return p, d, torch.full((n,), 4.0 * Pi, device=dev)
    if rx_spec.kind == PHASED and rx_spec.n_elems > 1:
        # a position uniform over the array's bounding rectangle (the
        # support of its pairs' footprints, however small the attached
        # shape) and a cosine-hemisphere direction about its normal; the
        # cross-WDF weight comes from rx_aperture_weight
        origin, sn, tn, nrm = rx_array_frame(scene, rx_spec, shape_idx)
        locs = _elem_locs(rx_spec)
        hx = float(np.abs(locs[:, 0]).max()) + float(rx_spec.elem_wid[0])
        hy = float(np.abs(locs[:, 1]).max()) + float(rx_spec.elem_wid[1])
        lx = (u_pos[:, 0] * 2.0 - 1.0) * hx
        ly = (u_pos[:, 1] * 2.0 - 1.0) * hy
        p = origin[None] + lx[:, None] * sn[None] + ly[:, None] * tn[None]
        frame = tfm.frame_from_normal(nrm.expand(n, 3))
        d = tfm.to_world(frame, warp.square_to_cosine_hemisphere(u_dir))
        return p + 1e-4 * nrm[None], d, \
            torch.full((n,), Pi * (4.0 * hx * hy) * rx_spec.gain, device=dev)
    if rx_spec.kind not in (WIGNER, PHASED):
        raise ValueError(f'receiver kind {rx_spec.kind}')
    idxs = torch.full((n,), shape_idx, dtype=torch.long, device=dev)
    p, nrm, pdf_a, _ = sample_position(scene.shapes, idxs, u_pos)
    frame = tfm.frame_from_normal(nrm)
    if wavelength is None:
        d = tfm.to_world(frame, warp.square_to_cosine_hemisphere(u_dir))
        return p + 1e-4 * nrm, d, \
            Pi / torch.clamp(pdf_a, min=1e-20) * rx_spec.gain
    tw = scene.shapes.to_world[shape_idx]
    w_min = torch.minimum(tw[:3, 0].norm(), tw[:3, 1].norm())
    # power-cosine exponent of the WDF main lobe: lobe rms angle
    # sqrt(2 / (k + 2)) ~= 0.6 lambda / (2 w_min)
    k = torch.clamp(2.0 * (2.0 * w_min / (0.6 * wavelength)) ** 2 - 2.0,
                    min=0.0)
    pick_lobe = u_dir[:, 0] >= 0.5
    u0 = torch.where(pick_lobe, 2.0 * u_dir[:, 0] - 1.0, 2.0 * u_dir[:, 0])
    u1 = u_dir[:, 1]
    d_cos = warp.square_to_cosine_hemisphere(torch.stack([u0, u1], -1))
    ct = torch.pow(torch.clamp(u0, min=1e-12), 1.0 / (k + 1.0))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = TwoPi * u1
    d_lobe = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    d_local = torch.where(pick_lobe[:, None], d_lobe, d_cos)
    cos_t = torch.clamp(d_local[:, 2], min=0.0)
    pdf_dir = (0.5 * cos_t / Pi + 0.5 * (k + 1.0) / TwoPi
               * torch.pow(torch.clamp(cos_t, min=1e-12), k))
    d = tfm.to_world(frame, d_local)
    w = cos_t / torch.clamp(pdf_dir * pdf_a, min=1e-30)
    return p + 1e-4 * nrm, d, w * rx_spec.gain


def rx_aperture_weight(scene, rx_spec: ReceiverSpec, shape_idx: int, p, d,
                       wavelength):
    """Directional WDF weight of the receive aperture at (p, d): the
    rectangle WDF, or a phased array's cross-WDF; may be negative.  1 for
    an omni receiver."""
    n = int(p.shape[0])
    if rx_spec.kind == OMNI:
        return torch.ones(n, device=p.device)
    if rx_spec.kind == PHASED and rx_spec.n_elems > 1:
        # the pairs steered at the band-centre wavelength, in world
        # offsets along the attached shape's frame
        mids, bases, psis = _phased_pairs(rx_spec,
                                          scene.band.wavelength_centre)
        origin, sn, tn, _ = rx_array_frame(scene, rx_spec, shape_idx)

        def world(local):
            loc = torch.as_tensor(local, device=p.device)
            return loc[:, 0:1] * sn[None] + loc[:, 1:2] * tn[None]
        return phased_aperture_gain(
            world(mids), world(bases), torch.as_tensor(psis, device=p.device),
            torch.ones(len(mids), dtype=torch.bool, device=p.device), sn, tn,
            torch.as_tensor(np.asarray(rx_spec.elem_wid, np.float32),
                            device=p.device), origin, p, d, wavelength)
    if rx_spec.kind not in (WIGNER, PHASED):
        raise ValueError(f'receiver kind {rx_spec.kind}')
    idxs = torch.full((n,), shape_idx, dtype=torch.long, device=p.device)
    return rect_aperture_gain(scene.shapes, idxs, p, d, wavelength)


def rx_array_frame(scene, rx_spec: ReceiverSpec, shape_idx: int):
    """Aperture frame of a receive array: (origin, s_n, t_n, normal), each
    (3,), the normalised in-plane axes and the outward normal, from the
    attached shape's to_world (the spec's own when free-standing)."""
    if shape_idx >= 0:
        tw = scene.shapes.to_world[shape_idx]
    else:
        tw = torch.as_tensor(np.asarray(rx_spec.to_world, np.float32),
                             device=scene.shapes.to_world.device)
    s_ax, t_ax = tw[:3, 0], tw[:3, 1]
    sn = s_ax / torch.clamp(torch.linalg.norm(s_ax), min=1e-20)
    tn = t_ax / torch.clamp(torch.linalg.norm(t_ax), min=1e-20)
    nrm = torch.linalg.cross(sn, tn)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm), min=1e-20)
    return tw[:3, 3], sn, tn, nrm


def rx_elem_offsets(scene, rx_spec: ReceiverSpec, shape_idx: int):
    """(E, 3) world-frame offsets of the receive elements from the array
    origin: MIMO channels need each element's own position."""
    _, sn, tn, nrm = rx_array_frame(scene, rx_spec, shape_idx)
    locs = torch.as_tensor(_elem_locs(rx_spec), device=sn.device)
    return (locs[:, 0:1] * sn[None] + locs[:, 1:2] * tn[None]
            + locs[:, 2:3] * nrm[None])


def rx_elem_pattern_gain(rx_spec: ReceiverSpec, sn, tn, d, wavelength):
    """One element's Wigner gain times its area toward directions d (n, 3)
    at `wavelength` (n,): the aperture-centre cut of the rectangle WDF
    (tri(0) = 1) with the spec's element half-widths.  Equal for every
    element in the far field, so one factor serves every MIMO channel."""
    wx = float(rx_spec.elem_wid[0])
    wy = float(rx_spec.elem_wid[1])
    nu_x = torch.einsum('nj,j->n', d, sn) / wavelength
    nu_y = torch.einsum('nj,j->n', d, tn) / wavelength
    area = 4.0 * wx * wy
    return area * 4.0 * sinc(TwoPi * nu_x * wx) * sinc(TwoPi * nu_y * wy)


def rx_sample_frequency(receive_type: str, lo_wf, band, time, u,
                        adc_cfg: ADCConfig | None = None):
    """Receive frequency per receive type: raw draws uniformly over the
    band; raw_resample and mix_resample take the LO's instantaneous
    frequency (raw_resample without an LO degrades to raw); mixer draws
    the beat uniformly over the ADC's frequency window and sets f = f_LO -
    beat.  Returns (f_rx, pdf weight)."""
    if receive_type == 'mix_resample':
        if lo_wf is None:
            raise ValueError('mix_resample receiver needs lo_waveform')
        f = lo_wf.inst_freq(time)
        return f, torch.ones_like(f)
    if receive_type == 'raw_resample' and lo_wf is not None:
        f = lo_wf.inst_freq(time)
        return f, torch.ones_like(f)
    if receive_type == 'mixer':
        if lo_wf is None:
            raise ValueError('mixer receiver needs lo_waveform')
        if adc_cfg is None:
            raise ValueError('mixer receiver needs the ADC config')
        beat = adc_cfg.freq_lo + u * (adc_cfg.freq_hi - adc_cfg.freq_lo)
        f = lo_wf.inst_freq(time) - beat
        return f, torch.ones_like(f)
    if receive_type not in ('raw', 'raw_resample'):
        raise ValueError(f'unknown receive_type {receive_type!r}')
    f = band.freq_min + u * (band.freq_max - band.freq_min)
    return f, torch.ones_like(f)
