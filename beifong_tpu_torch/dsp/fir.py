"""FIR design and reference waveform synthesis (counterpart of
`beifong_tpu/dsp/fir.py`), float32 / complex64 on `device` (`cuda` unless
the caller names another)."""

from __future__ import annotations

import math

import torch

from .._device import resolve_device
from . import windows


def design_lowpass(n_taps: int, cutoff: float, window: str = 'hamming',
                   device=None) -> torch.Tensor:
    """Windowed-sinc lowpass; cutoff as a fraction of Nyquist (0..1),
    normalised to unit DC gain."""
    m = n_taps - 1
    k = torch.arange(n_taps, dtype=torch.float32,
                     device=resolve_device(device)) - m / 2.0
    h = torch.sinc(cutoff * k) * windows.get(window, n_taps, device=device)
    return (h / h.sum()).to(torch.float32)


def lfm_chirp(n: int, fs: float, f0: float, bandwidth: float,
              duration: float, complex_baseband: bool = True,
              device=None) -> torch.Tensor:
    """Sampled linear-FM chirp replica for matched filtering: n samples
    (zero past `duration`), complex baseband or real passband from f0."""
    t = torch.arange(n, dtype=torch.float32,
                     device=resolve_device(device)) / fs
    k = bandwidth / duration
    active = t < duration
    if complex_baseband:
        ph = 2 * math.pi * (0.5 * k * t * t + f0 * t)
        sig = torch.exp(1j * ph.to(torch.float32))
    else:
        ph = 2 * math.pi * (f0 * t + 0.5 * k * t * t)
        sig = torch.cos(ph)
    return torch.where(active, sig, torch.zeros_like(sig))
