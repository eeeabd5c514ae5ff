"""Range-Doppler processing: dechirp, fast- and slow-time FFTs, the map
and its axes (counterpart of `beifong_tpu/dsp/rangedoppler.py`), on
`torch.fft` on the input's device."""

from __future__ import annotations

import torch

from .._device import resolve_device
from .pulse import correlate_full


def dechirp(rx: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """FMCW stretch processing: multiply by the conjugate reference chirp.
    rx, ref: (..., N) complex baseband at the ADC rate."""
    return rx * torch.conj(ref)


def range_fft(cube: torch.Tensor, window=None, n_fft: int | None = None):
    """Fast-time FFT of a dechirped FMCW cube: beat-frequency (range)
    bins."""
    n = cube.shape[-1]
    if window is not None:
        cube = cube * window
    return torch.fft.fft(cube, n_fft or n, dim=-1)


def doppler_fft(cube: torch.Tensor, window=None, n_fft: int | None = None):
    """Slow-time FFT across pulses (axis -2), fftshifted to centre zero
    Doppler."""
    n = cube.shape[-2]
    if window is not None:
        cube = cube * window[..., None]
    return torch.fft.fftshift(torch.fft.fft(cube, n_fft or n, dim=-2),
                              dim=-2)


def range_doppler_map(cube: torch.Tensor, replica=None, range_window=None,
                      doppler_window=None, mode: str = 'pulse'):
    """The complex (doppler_bins, range_bins) map of a (pulses, samples)
    cube.  mode 'pulse': matched-filter pulse compression along fast time,
    then the slow-time FFT; 'fmcw': the cube is dechirped already, range
    FFT then slow-time FFT."""
    if mode == 'pulse':
        if replica is None:
            raise ValueError("mode 'pulse' needs the replica")
        rc = correlate_full(cube, replica)
        if range_window is not None:
            rc = rc * range_window
    elif mode == 'fmcw':
        rc = range_fft(cube, range_window)
    else:
        raise ValueError(f'mode {mode!r}: pulse or fmcw')
    return doppler_fft(rc, doppler_window)


def doppler_axis(n_pulses: int, prf: float, device=None) -> torch.Tensor:
    """Doppler frequency of each (fftshifted) slow-time bin [Hz]."""
    return (torch.arange(n_pulses, device=resolve_device(device))
            - n_pulses // 2) * (prf / n_pulses)


def range_axis_pulse(n_samples: int, fs: float, c: float,
                     device=None) -> torch.Tensor:
    """Range of each fast-time sample after pulse compression [m]
    (two-way: r = c t / 2)."""
    return torch.arange(n_samples, device=resolve_device(device)) / fs \
        * c / 2.0


def range_axis_fmcw(n_fft: int, fs: float, chirp_slope: float, c: float,
                    device=None) -> torch.Tensor:
    """Range of each beat-frequency bin of a dechirped FMCW signal [m]."""
    f_beat = torch.arange(n_fft, device=resolve_device(device)) \
        * (fs / n_fft)
    return f_beat * c / (2.0 * chirp_slope)
