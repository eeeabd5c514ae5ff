"""ADC accumulation grid (counterpart of `beifong_tpu/film.py`, the part the
receive path needs).

Layout: (H, W, C + 2) — C value channels, then a weight and a count
channel, as in the JAX package.  The receive kernel splats with the TENT
reconstruction filter (the JAX package's filter code 1).
"""

from __future__ import annotations

import torch

from ._device import resolve_device

TENT = 1


def film_new(h: int, w: int, n_channels: int = 3,
             device=None) -> torch.Tensor:
    """Zeroed (h, w, n_channels + 2) grid on `device` (`cuda` by default;
    raises without a card)."""
    return torch.zeros((h, w, n_channels + 2), dtype=torch.float32,
                       device=resolve_device(device))
