"""Analytic waveforms evaluated through their Wigner distributions
(counterpart of `beifong_tpu/radar/waveform.py`).

A `Waveform` is a dataclass of float32 tensors, one entry per transmitter
once stacked; the kind code picks the closed form per row.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import TwoPi, sinc, tri, rect

CW = 0
PULSE = 1
LINFMCW = 2


@dataclasses.dataclass(frozen=True)
class Waveform:
    """amplitude [V], rep_freq = PRF/CRF [Hz], t_ext = pulse/chirp length
    [s], f_centre [Hz], f_ext = sweep/bandwidth [Hz], phi0 [rad]."""

    kind: torch.Tensor        # int32
    amplitude: torch.Tensor
    rep_freq: torch.Tensor
    t_ext: torch.Tensor
    f_centre: torch.Tensor
    f_ext: torch.Tensor
    phi0: torch.Tensor
    is_delta: torch.Tensor    # bool

    def _fold(self, time):
        pri = 1.0 / torch.clamp(self.rep_freq, min=1e-12)
        return torch.remainder(time, pri), 0.5 * self.t_ext

    def inst_freq(self, time):
        """Instantaneous frequency (the chirp ridge; f_centre otherwise)."""
        t, ti = self._fold(time)
        fi_chirp = self.f_centre + (
            self.f_ext / torch.clamp(self.t_ext, min=1e-12)) * (t - ti)
        return torch.where(self.kind == LINFMCW, fi_chirp, self.f_centre)

    def eval_wdf(self, time, freq):
        """Wigner distribution W(t, f) in V^2/Hz (may be negative)."""
        t, ti = self._fold(time)
        fi = self.inst_freq(time)
        w = self.t_ext
        x = (t - ti) / torch.clamp(w, min=1e-12)
        tw = tri((t - ti) / w)
        w_chirp = 2.0 * self.amplitude * self.amplitude * w * tw \
            * sinc(TwoPi * (freq - fi) * w * tw)
        w_pulse = torch.where(rect(x) > 0.0, w_chirp,
                              torch.zeros_like(w_chirp))
        return torch.where(self.kind == CW,
                           self.amplitude * self.amplitude, w_pulse)

    def phase(self, time):
        """Instantaneous carrier phase [rad] at absolute time."""
        t, ti = self._fold(time)
        slope = self.f_ext / torch.clamp(self.t_ext, min=1e-12)
        ph_chirp = self.phi0 + TwoPi * (t - ti) * (
            self.f_centre + 0.5 * slope * (t - ti))
        ph_tone = self.phi0 + TwoPi * t * self.f_centre
        return torch.where(self.kind == LINFMCW, ph_chirp, ph_tone)

    def sample_frequency(self, time, u):
        """An emission frequency at `time`: the instantaneous frequency for
        delta waveforms (weight 1), else uniform over the band weighted by
        the WDF.  Returns (freq, weight)."""
        f_delta = self.inst_freq(time)
        f_uni = (u - 0.5) * self.f_ext + self.f_centre
        f = torch.where(self.is_delta, f_delta, f_uni)
        w_uni = self.eval_wdf(time, f_uni)
        return f, torch.where(self.is_delta, torch.ones_like(f), w_uni)

    def to(self, device) -> "Waveform":
        return Waveform(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(Waveform)})

    def row(self, idx) -> "Waveform":
        """The waveforms of rows idx of a stacked table."""
        return Waveform(**{f.name: getattr(self, f.name)[idx]
                           for f in dataclasses.fields(Waveform)})


def _b(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cw(f_centre, amplitude=1.0, phi0=0.0, f_ext=0.0,
       is_delta=True) -> Waveform:
    return Waveform(kind=torch.tensor(CW, dtype=torch.int32),
                    amplitude=_b(amplitude), rep_freq=_b(1.0), t_ext=_b(1.0),
                    f_centre=_b(f_centre), f_ext=_b(f_ext), phi0=_b(phi0),
                    is_delta=torch.tensor(bool(is_delta)))


def pulse(f_centre, prf, pulse_len, amplitude=1.0, f_ext=None, phi0=0.0,
          is_delta=False) -> Waveform:
    if f_ext is None:
        f_ext = 1.0 / pulse_len   # transform-limited
    return Waveform(kind=torch.tensor(PULSE, dtype=torch.int32),
                    amplitude=_b(amplitude), rep_freq=_b(prf),
                    t_ext=_b(pulse_len), f_centre=_b(f_centre),
                    f_ext=_b(f_ext), phi0=_b(phi0),
                    is_delta=torch.tensor(bool(is_delta)))


def linfmcw(f_centre, crf, chirp_len, freq_sweep, amplitude=1.0, phi0=0.0,
            is_delta=True) -> Waveform:
    return Waveform(kind=torch.tensor(LINFMCW, dtype=torch.int32),
                    amplitude=_b(amplitude), rep_freq=_b(crf),
                    t_ext=_b(chirp_len), f_centre=_b(f_centre),
                    f_ext=_b(freq_sweep), phi0=_b(phi0),
                    is_delta=torch.tensor(bool(is_delta)))


def stack(waveforms: list[Waveform]) -> Waveform:
    """Stack per-transmitter waveforms into one Waveform of shape (n,)."""
    return Waveform(**{f.name: torch.stack([getattr(w, f.name)
                                            for w in waveforms])
                       for f in dataclasses.fields(Waveform)})
