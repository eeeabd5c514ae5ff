"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device.  Asking for `cuda`
    (explicitly or by default) on a machine without a card raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
