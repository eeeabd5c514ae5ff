"""Polyphase resampling to the ADC rate (counterpart of
`beifong_tpu/dsp/resample.py`): a windowed-sinc anti-alias FIR and a
polyphase up / down filter as a gather of input windows times a (phases,
taps) coefficient bank, on the input's device."""

from __future__ import annotations

import math

import torch

from .fir import design_lowpass


def resample_poly(x: torch.Tensor, up: int, down: int,
                  taps_per_phase: int = 16) -> torch.Tensor:
    """Rational-rate resampling by up / down with a polyphase FIR.

    x: (..., N) real or complex.  Returns (..., ceil(N up / down))."""
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return x
    dev = x.device
    n_taps = taps_per_phase * up
    h = design_lowpass(n_taps, 1.0 / max(up, down), device=dev) * up
    # polyphase bank[p, k] = h[k up + p]
    bank = h.reshape(taps_per_phase, up).T
    n = x.shape[-1]
    n_out = int(math.ceil(n * up / down))
    # output m reads the input window ending at floor(m down / up), with
    # phase (m down) % up
    m = torch.arange(n_out, device=dev)
    in_pos = (m * down) // up
    phase = (m * down) % up
    idx = in_pos[:, None] - torch.arange(taps_per_phase, device=dev)[None, :]
    valid = idx >= 0
    win = x[..., idx.clamp(0, n - 1)]               # (..., n_out, K)
    win = torch.where(valid, win, torch.zeros_like(win))
    return torch.sum(win * bank[phase], dim=-1)


def decimate(x: torch.Tensor, q: int, taps_per_phase: int = 16):
    return resample_poly(x, 1, q, taps_per_phase)


def interpolate(x: torch.Tensor, q: int, taps_per_phase: int = 16):
    return resample_poly(x, q, 1, taps_per_phase)
