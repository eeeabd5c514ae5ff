"""Matched-filter pulse compression on `torch.fft` (counterpart of
`beifong_tpu/dsp/pulse.py`)."""

from __future__ import annotations

import torch


def matched_filter_freq(replica: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Frequency response of the matched filter h[k] = conj(s[-k])."""
    return torch.conj_physical(torch.fft.fft(replica, n_fft))


def correlate_full(x: torch.Tensor, replica: torch.Tensor) -> torch.Tensor:
    """Full matched-filter correlation y[n] = sum_k x[n+k] conj(s[k]).

    x: (..., N); replica: (M,).  Output (..., N), "same"-aligned: y[n] is the
    correlation with the replica starting at n."""
    n = x.shape[-1]
    m = replica.shape[-1]
    n_fft = 1
    while n_fft < n + m - 1:
        n_fft *= 2
    X = torch.fft.fft(x, n_fft)
    H = torch.conj_physical(torch.fft.fft(replica, n_fft))
    return torch.fft.ifft(X * H, n_fft)[..., :n]


def overlap_save(x: torch.Tensor, h_freq: torch.Tensor, n_fft: int,
                 n_taps: int, history=None) -> torch.Tensor:
    """Blocked overlap-save convolution / correlation.

    x: (..., N); h_freq: (n_fft,) filter response.  Returns (..., N)
    same-aligned output.  Each block reads `n_taps - 1` samples of left
    history from `history` (zeros if None)."""
    L = n_fft - n_taps + 1
    n = x.shape[-1]
    n_pad = (-n) % L
    if n_pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (n_pad,))], dim=-1)
    n_padded = n + n_pad
    n_blocks = n_padded // L
    if history is None:
        history = x.new_zeros(x.shape[:-1] + (n_taps - 1,))
    xp = torch.cat([history.to(x.dtype), x], dim=-1)
    idx = (torch.arange(n_blocks, device=x.device)[:, None] * L
           + torch.arange(n_fft, device=x.device)[None, :])
    Y = torch.fft.fft(xp[..., idx], n_fft) * h_freq
    y = torch.fft.ifft(Y, n_fft)[..., n_taps - 1:]
    return y.reshape(x.shape[:-1] + (n_padded,))[..., :n]


def pulse_compress(cube: torch.Tensor, replica: torch.Tensor,
                   window=None) -> torch.Tensor:
    """Matched-filter a (pulses, samples) cube along fast time; the output
    peaks at the target's delay sample."""
    rep = replica
    if window is not None and window.shape[0] >= replica.shape[0]:
        rep = replica * window[: replica.shape[0]]
    return correlate_full(cube, rep)


def compression_gain(replica: torch.Tensor) -> torch.Tensor:
    """Matched-filter SNR gain sum |s|^2 (the time-bandwidth product for a
    unit-amplitude LFM chirp)."""
    return torch.sum(torch.abs(replica) ** 2)
