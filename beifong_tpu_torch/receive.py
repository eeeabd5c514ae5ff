"""receive(): the radar-side entry point (counterpart of
`beifong_tpu/receive.py`).

A scene inside the receive kernel's scope (`integrators.receive_kernel.
supported`) runs the CUDA kernel on a card, or its plain PyTorch version on
the CPU.  Anything else raises `NotImplementedError` naming what is
missing: the eager wavefront that the JAX package falls back to
(`radar_path.radar_receive_trace`) is ROADMAP A4, and until it lands there
is nothing to route to.  A failing build or launch raises as well.
"""

from __future__ import annotations

import torch

from . import film as film_mod
from ._device import resolve_device
from .integrators.receive_kernel import receive_kernel
from .radar.endpoints import ADCConfig


def receive(scene, scene_data=None, receiver=None, seed: int = 0,
            spp: int = 4096, max_depth: int = 3,
            time_sampling: str = 'fixed', device=None):
    """Simulate the received signal; returns (adc_grid, total_samples).

    adc_grid: (n_time, n_freq, 3) float32 — accumulated power, then the
    weight and count channels of the JAX package's layout (left at zero by
    the kernel, as there).  `time_sampling`: 'fixed' (reference semantics)
    or 'gate' (deferred time-gated importance sampling).  Runs on `device`
    (`cuda` by default; raises without a card)."""
    dev = resolve_device(device)
    if scene_data is None:
        scene_data = scene.compile(device=dev)
    rx = receiver or scene.receivers[0]
    out, n = receive_kernel(scene, scene_data, rx, spp=spp, seed=seed,
                            max_depth=max_depth, time_sampling=time_sampling,
                            device=dev)
    adc = film_mod.film_new(rx.adc.n_time, rx.adc.n_freq, 1, device=dev)
    adc[..., 0] = out
    return adc, n


def develop_signal(adc: torch.Tensor, total_samples: int,
                   cfg: ADCConfig) -> torch.Tensor:
    """Normalize the raw ADC accumulation to the mean received power
    density on the fast-time axis (each uniform time sample has pdf
    1/window, so E[sum]/N * n_time estimates the per-bin mean power): the
    JAX package's 'density' mode."""
    c = adc.shape[-1] - 2
    return adc[..., :c] * (cfg.n_time / max(total_samples, 1))
