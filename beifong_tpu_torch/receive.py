"""receive(): the radar-side entry point (counterpart of
`beifong_tpu/receive.py`).

A scene inside the receive kernel's scope (`integrators.receive_kernel.
supported`: rectangles and diffuse triangle meshes, one resampling Wigner
transmitter, raw power receive on a fast-time ADC, a static scene) runs
the CUDA megakernel on a card, or its plain PyTorch version on the CPU.
Every other scene runs the eager wavefront (`integrators/radar_path.py`)
in passes of `lanes_per_pass` lanes, its triangle tests on the
hand-written ray / triangle and BVH kernels.  `use_kernel` picks the
route: 'auto' as above, True the kernel (raising outside its scope),
False the wavefront.  Nothing falls back on its own: a failing build or
launch raises, and a scene outside both scopes raises
`NotImplementedError` naming the ROADMAP item that lifts it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import film as film_mod
from ._device import resolve_device
from .core.rng import make_stream
from .integrators import receive_kernel as rk
from .integrators.radar_path import radar_receive_trace
from .radar.endpoints import (ADCConfig, rx_aperture_weight, rx_sample_ray,
                              rx_sample_frequency)


def _receive_pass(scene_data, rx, shape_idx: int, lo_wf, stream, adc,
                  n_lanes: int, max_depth: int, coherent: bool = False,
                  time_sampling: str = 'fixed'):
    """One wavefront of `n_lanes` receive lanes drawing from `stream`,
    splatted into `adc` in place; returns it."""
    cfg = rx.adc
    n = n_lanes
    dev = adc.device
    if time_sampling == 'gate':
        # emission times are drawn at the connections; t_rx only seeds the
        # frequency draw
        t_rx = torch.zeros(n, dtype=torch.float32, device=dev)
        t_for_freq = torch.full((n,), cfg.sampling_start
                                + 0.5 * cfg.sampling_time, device=dev)
    elif time_sampling == 'fixed':
        u_t, stream = stream.next_1d()
        t_rx = cfg.sampling_start + u_t * cfg.sampling_time
        t_for_freq = t_rx
    else:
        raise ValueError(f'time_sampling {time_sampling!r}: fixed or gate')
    u_f, stream = stream.next_1d()
    f_rx, f_w = rx_sample_frequency(rx.receive_type, lo_wf, scene_data.band,
                                    t_for_freq, u_f, cfg)
    u_pos, stream = stream.next_2d()
    u_dir, stream = stream.next_2d()
    wl_rx = scene_data.band.c / torch.clamp(f_rx, min=1e-6)
    o, d, w = rx_sample_ray(scene_data, rx, shape_idx, t_rx, u_pos, u_dir,
                            wavelength=wl_rx)
    # the receiver aperture's WDF directivity (signed)
    w = w * rx_aperture_weight(scene_data, rx, shape_idx, o, d, wl_rx)
    adc, _ = radar_receive_trace(
        scene_data, stream, o, d, t_rx, f_rx, w * f_w, adc, cfg,
        rx.receive_type, lo_wf, rx.velocity, max_depth=max_depth,
        coherent=coherent, time_sampling=time_sampling)
    return adc


def scene_mono(scene_data):
    """The colour tables sliced to one channel (the radar path is mono)."""
    b = scene_data.bsdfs
    t = scene_data.textures
    return dataclasses.replace(
        scene_data,
        bsdfs=dataclasses.replace(b, reflectance=b.reflectance[:, :1],
                                  eta=b.eta[:, :1], k=b.k[:, :1]),
        textures=dataclasses.replace(t, color0=t.color0[:, :1],
                                     color1=t.color1[:, :1],
                                     atlas=t.atlas[..., :1]))


def _kernel_scope(scene, scene_data, rx, dev, coherent: bool,
                  polarized: bool, why: list) -> bool:
    if coherent or polarized:
        why.append('coherent I/Q and polarized receive are outside the '
                   'receive kernel (ROADMAP B3 / B7)')
        return False
    return rk.in_scope(scene, scene_data, rx, dev, why)


def receive(scene, scene_data=None, receiver=None, seed: int = 0,
            spp: int = 4096, max_depth: int = 3, coherent: bool = False,
            lanes_per_pass: int = 1 << 17, sampler: str = 'independent',
            time_sampling: str = 'fixed', use_kernel: str | bool = 'auto',
            polarized: bool = False, device=None):
    """Simulate the received signal; returns (adc_grid, total_samples).

    adc_grid: (n_time, n_freq, C + 2) float32, C = 1 (power) or 2 (I / Q
    with `coherent=True`), then the weight and count channels (left at
    zero by the kernel, as in the JAX package).  total_samples: on the
    kernel `spp` (rounded down to whole 1024-lane tiles for meshes); on
    the wavefront lanes x passes, lanes = min(spp, lanes_per_pass).
    `time_sampling`: 'fixed' or 'gate' (deferred time-gated sampling;
    needs window <= PRI).  `sampler`: 'independent' (the others are
    ROADMAP A2).  Both routes draw Philox keyed by `seed`, so one seed
    gives one answer on the CPU and on a card (up to the order of the
    card's atomic adds).  Runs on `device` (`cuda` by default; raises
    without a card)."""
    dev = resolve_device(device)
    if scene_data is None:
        scene_data = scene.compile(device=dev)
    rx = receiver or scene.receivers[0]
    if use_kernel not in ('auto', True, False):
        raise ValueError(f'use_kernel {use_kernel!r}: auto, True or False')
    why: list = []
    if use_kernel and _kernel_scope(scene, scene_data, rx, dev, coherent,
                                    polarized, why):
        out, n = rk.receive_kernel(scene, scene_data, rx, spp=spp, seed=seed,
                                   max_depth=max_depth,
                                   time_sampling=time_sampling, device=dev)
        adc = film_mod.film_new(rx.adc.n_time, rx.adc.n_freq, 1, device=dev)
        adc[..., 0] = out
        return adc, n
    if use_kernel is True:
        raise NotImplementedError("scene outside the receive kernel's "
                                  'scope: ' + '; '.join(why))
    if polarized:
        raise NotImplementedError('polarized (Stokes) receive (ROADMAP A10)')

    sd = scene_mono(scene_data)
    shape_idx = scene.shape_index_of_endpoint('receiver', rx.id)
    cfg = rx.adc
    adc = film_mod.film_new(cfg.n_time, cfg.n_freq, 2 if coherent else 1,
                            device=dev)
    n_pass = max(1, (spp + lanes_per_pass - 1) // lanes_per_pass)
    lanes = min(spp, lanes_per_pass)
    lo = None if rx.lo_waveform is None else rx.lo_waveform.to(dev)
    for p in range(n_pass):
        stream = make_stream(sampler, seed, lanes, p, device=dev)
        _receive_pass(sd, rx, shape_idx, lo, stream, adc, lanes, max_depth,
                      coherent, time_sampling)
    return adc, lanes * n_pass


def develop_signal(adc: torch.Tensor, total_samples: int, cfg: ADCConfig,
                   mode: str = 'density') -> torch.Tensor:
    """Normalize the raw ADC accumulation.  'density': the mean received
    power density on the fast-time axis (each uniform time sample has pdf
    1 / window, so E[sum] / N x n_time estimates the per-bin mean power);
    'sum': the raw accumulated values."""
    c = adc.shape[-1] - 2
    if mode == 'sum':
        return adc[..., :c]
    if mode != 'density':
        raise ValueError(f'mode {mode!r}: density or sum')
    return adc[..., :c] * (cfg.n_time / max(total_samples, 1))
