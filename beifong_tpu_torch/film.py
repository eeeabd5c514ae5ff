"""ADC accumulation grid and reconstruction-filter splatting (counterpart of
`beifong_tpu/film.py`).

Layout: (H, W, C + 2): C value channels, then a weight and a count
channel, as in the JAX package.  `splat` is one scatter-add (`index_add_`)
per filter tap; the JAX package's dense-matmul splat for small grids is a
TPU workaround (no fast scatter there) and is not carried over.  On a
card the adds are atomic, so their order, and the last bits of a sum,
change from run to run.
"""

from __future__ import annotations

import torch

from ._device import resolve_device

# filter codes
BOX = 0
TENT = 1
GAUSSIAN = 2
MITCHELL = 3
CATMULLROM = 4
LANCZOS = 5

_RADIUS = {BOX: 1, TENT: 1, GAUSSIAN: 2, MITCHELL: 2, CATMULLROM: 2,
           LANCZOS: 3}


def filter_eval(kind: int, x: torch.Tensor) -> torch.Tensor:
    """1-D filter kernel value at offset x."""
    ax = x.abs()
    if kind == BOX:
        return torch.where(ax <= 0.5, 1.0, 0.0)
    if kind == TENT:
        return torch.clamp(1.0 - ax, min=0.0)
    if kind == GAUSSIAN:
        s = 0.5
        v = torch.exp(-0.5 * (x / s) ** 2) - float(
            torch.exp(torch.tensor(-0.5 * (2.0 / s) ** 2)))
        return torch.clamp(v, min=0.0)
    if kind in (MITCHELL, CATMULLROM):
        b, c = (1 / 3, 1 / 3) if kind == MITCHELL else (0.0, 0.5)
        x2, x3 = ax * ax, ax * ax * ax
        v1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
              + (6 - 2 * b)) / 6
        v2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
              + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6
        return torch.where(ax < 1.0, v1, torch.where(ax < 2.0, v2, 0.0))
    if kind == LANCZOS:
        a = 3.0
        pix = torch.pi * ax

        def sinc(t):
            ts = torch.where(t.abs() > 1e-6, t, 1.0)
            return torch.where(t.abs() > 1e-6, torch.sin(ts) / ts, 1.0)

        return torch.where(ax < a, sinc(pix) * sinc(pix / a), 0.0)
    raise ValueError(f'unknown filter {kind}')


def film_new(h: int, w: int, n_channels: int = 3,
             device=None) -> torch.Tensor:
    """Zeroed (h, w, n_channels + 2) grid on `device` (`cuda` by default;
    raises without a card)."""
    return torch.zeros((h, w, n_channels + 2), dtype=torch.float32,
                       device=resolve_device(device))


def splat(film: torch.Tensor, pos: torch.Tensor, values: torch.Tensor,
          active: torch.Tensor, rfilter: int = BOX) -> torch.Tensor:
    """Scatter-add filtered samples into `film` in place and return it.

    pos: (n, 2) continuous (x = column, y = row) pixel coordinates, pixel
    (i, j) centred at (j + 0.5, i + 0.5); values: (n, C); active: (n,)
    bool.  Each tap adds value x weight, the weight, and a count of 1."""
    h, w, ctot = film.shape
    c = ctot - 2
    r = _RADIUS[rfilter]
    x = pos[:, 0] - 0.5
    y = pos[:, 1] - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    flat = film.view(h * w, ctot)
    for dy in range(-r + 1, r + 1):
        py = y0 + dy
        fy = filter_eval(rfilter, py.to(x.dtype) - y)
        oky = (py >= 0) & (py < h)
        for dx in range(-r + 1, r + 1):
            px = x0 + dx
            fx = filter_eval(rfilter, px.to(x.dtype) - x)
            wgt = fx * fy
            ok = oky & (px >= 0) & (px < w) & active & (wgt != 0.0)
            wk = torch.where(ok, wgt, 0.0)
            contrib = torch.cat([values * wk[:, None], wk[:, None],
                                 ok.to(values.dtype)[:, None]], dim=-1)
            contrib = torch.where(ok[:, None], contrib, 0.0)
            idx = torch.clamp(py, 0, h - 1) * w + torch.clamp(px, 0, w - 1)
            flat.index_add_(0, idx, contrib)
    return film
