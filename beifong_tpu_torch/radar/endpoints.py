"""Transmitter and receiver endpoints (counterpart of
`beifong_tpu/radar/endpoints.py`, the part the flagship receive needs).

Transmitters compile into a tensor table that the receive kernel packs;
the receiver stays a host spec whose ADC config sets the fast-time
binning.  Phased arrays follow in ROADMAP B6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import film as film_mod
from .waveform import Waveform, stack as wf_stack

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
    endpoint_kind: str = dataclasses.field(default='transmitter', init=False)


def wigner_transmitter(id, waveform, gain=1.0,
                       resample_freq=False) -> TransmitterSpec:
    """Aperture transmitter on a rectangle shape; directional gain from the
    shape's Wigner distribution."""
    return TransmitterSpec(id=id, kind=WIGNER, waveform=waveform, gain=gain,
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
    endpoint_kind: str = dataclasses.field(default='receiver', init=False)


def wigner_receiver(id, adc, receive_type='raw', lo_waveform=None,
                    gain=1.0) -> ReceiverSpec:
    """Shape-attached aperture receiver."""
    return ReceiverSpec(id=id, kind=WIGNER, adc=adc,
                        receive_type=receive_type, lo_waveform=lo_waveform,
                        gain=gain)


def omni_receiver(id, adc, position=(0, 0, 0), receive_type='raw',
                  lo_waveform=None, gain=1.0) -> ReceiverSpec:
    """Isotropic point receiver."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = position
    return ReceiverSpec(id=id, kind=OMNI, adc=adc, receive_type=receive_type,
                        lo_waveform=lo_waveform, gain=gain, to_world=m)


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
    def build(specs: list[TransmitterSpec], shape_of,
              device) -> "TransmitterTable":
        n = len(specs)
        for s in specs:
            if s.kind == PHASED:
                raise NotImplementedError(
                    'phased transmitters are not ported yet (ROADMAP B6)')

        def t(a):
            return torch.as_tensor(a, device=device)

        wf = wf_stack([s.waveform for s in specs])
        return TransmitterTable(
            kind=t(np.asarray([s.kind for s in specs], np.int32)),
            shape_idx=t(np.asarray([shape_of(s.id) for s in specs],
                                   np.int32)),
            gain=t(np.asarray([s.gain for s in specs], np.float32)),
            resample=t(np.asarray([s.resample_freq for s in specs], bool)),
            wf=Waveform(**{f.name: getattr(wf, f.name).to(device)
                           for f in dataclasses.fields(Waveform)}),
            velocity=t(np.stack([np.asarray(s.velocity, np.float32)
                                 for s in specs])),
            elem_mid=t(np.zeros((n, 1, 3), np.float32)),
            elem_baseline=t(np.zeros((n, 1, 3), np.float32)),
            psi=t(np.zeros((n, 1), np.float32)),
            pair_mask=t(np.zeros((n, 1), bool)),
            elem_wid=t(np.full((n, 2), 0.01, np.float32)))


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
