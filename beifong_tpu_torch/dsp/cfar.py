"""CA-CFAR detection on range-Doppler maps (counterpart of
`beifong_tpu/dsp/cfar.py`), in plain PyTorch on the map's device."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_sum(x: torch.Tensor, hd: int, hr: int) -> torch.Tensor:
    """Sum of each cell's inclusive box of half-sizes (hd, hr), cells past
    the edges counting 0: a double cumsum over the map padded by hd + 1 /
    hd rows and hr + 1 / hr columns, then the box's four corners."""
    D, R = x.shape
    xp = F.pad(x, (hr + 1, hr, hd + 1, hd))
    c = torch.cumsum(torch.cumsum(xp, dim=0), dim=1)
    a = c[2 * hd + 1:, 2 * hr + 1:][:D, :R]
    b = c[:D, 2 * hr + 1:][:, :R]
    d = c[2 * hd + 1:, :R][:D, :]
    e = c[:D, :R]
    return a - b - d + e


def ca_cfar_2d(power: torch.Tensor, guard: tuple = (2, 2),
               train: tuple = (8, 8), pfa: float = 1e-4):
    """Cell-averaging CFAR over a (D, R) non-negative power map.  Returns
    (detections bool (D, R), threshold (D, R)).  The noise estimate of a
    cell is the mean over its training ring (the box of half-sizes guard +
    train less the guard box), counting only cells inside the map, and the
    threshold is alpha times it, alpha = N (Pfa^{-1/N} - 1) for N training
    cells (exponential noise)."""
    if power.dim() != 2:
        raise ValueError(f'power: expected (D, R), got {tuple(power.shape)}')
    gd, gr = guard
    td, tr = train
    x = power.to(torch.float32)
    ones = torch.ones_like(x)
    outer = _box_sum(x, gd + td, gr + tr)
    inner = _box_sum(x, gd, gr)
    n_train = torch.clamp(_box_sum(ones, gd + td, gr + tr)
                          - _box_sum(ones, gd, gr), min=1.0)
    noise = (outer - inner) / n_train
    alpha = n_train * (torch.pow(torch.full_like(n_train, pfa),
                                 -1.0 / n_train) - 1.0)
    thresh = alpha * noise
    return x > thresh, thresh
