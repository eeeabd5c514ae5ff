"""Window functions of the radar DSP chain (counterpart of
`beifong_tpu/dsp/windows.py`): float32 tensors on `device` (`cuda` unless
the caller names another)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device


def _k(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=resolve_device(device))


def rect(n: int, device=None) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=resolve_device(device))


def hann(n: int, device=None) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2 * math.pi * _k(n, device) / n)


def hamming(n: int, device=None) -> torch.Tensor:
    return 0.54 - 0.46 * torch.cos(2 * math.pi * _k(n, device) / n)


def blackman(n: int, device=None) -> torch.Tensor:
    x = 2 * math.pi * _k(n, device) / n
    return 0.42 - 0.5 * torch.cos(x) + 0.08 * torch.cos(2 * x)


def blackman_harris(n: int, device=None) -> torch.Tensor:
    x = 2 * math.pi * _k(n, device) / n
    return (0.35875 - 0.48829 * torch.cos(x) + 0.14128 * torch.cos(2 * x)
            - 0.01168 * torch.cos(3 * x))


def taylor(n: int, nbar: int = 4, sll_db: float = -30.0,
           device=None) -> torch.Tensor:
    """Taylor window (classic radar sidelobe control), computed in float64
    on the host as the JAX package does."""
    a = np.arccosh(10 ** (-sll_db / 20.0)) / np.pi
    a2 = a * a
    sigma2 = nbar ** 2 / (a2 + (nbar - 0.5) ** 2)
    ms = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    for mi, m in enumerate(ms):
        num = np.prod(1 - (m ** 2 / sigma2) / (a2 + (ms - 0.5) ** 2))
        den = np.prod([1 - m ** 2 / k ** 2 for k in ms if k != m])
        fm[mi] = ((-1) ** (m + 1)) * num / (2 * den)
    k = np.arange(n)
    w = np.ones(n)
    for mi, m in enumerate(ms):
        w = w + 2 * fm[mi] * np.cos(2 * np.pi * m * (k - (n - 1) / 2) / n)
    return torch.tensor(w / w.max(), dtype=torch.float32,
                        device=resolve_device(device))


def get(name: str, n: int, device=None, **kw) -> torch.Tensor:
    return {'rect': rect, 'hann': hann, 'hamming': hamming,
            'blackman': blackman, 'blackman_harris': blackman_harris,
            'taylor': taylor}[name](n, device=device, **kw)
