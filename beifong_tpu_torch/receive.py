"""receive(): the radar-side entry point (counterpart of
`beifong_tpu/receive.py`).

A scene inside the receive kernel's scope (`integrators.receive_kernel.
supported`: rectangles and triangle meshes with diffuse, smooth-conductor
or GGX rough-conductor BSDFs, moving or not, one resampling Wigner
transmitter, raw, raw_resample, mix_resample or mixer receive, power or
coherent I / Q, on a fast-time or time x frequency ADC) runs the CUDA
megakernel on a card, or its plain PyTorch version on the CPU.  Every
other scene runs the eager wavefront (`integrators/radar_path.py`) in
passes of `lanes_per_pass` lanes, its triangle tests on the hand-written
ray / triangle and BVH kernels.  `use_kernel` picks the route: 'auto' as
above, True the kernel (raising outside its scope), False the wavefront.
Nothing falls back on its own: a failing build or launch raises, and a
scene outside both scopes raises `NotImplementedError` naming the
ROADMAP item that lifts it.

`receive_cpi` runs a coherent processing interval (CPI) of an animated
scene: a snapshot per pulse (`Scene.at_time`), every pulse in one launch
of the kernel when the scene is in its scope, else one `receive()` a
pulse.

`receive_mimo` runs a phased receive array as one coherent I / Q channel
an element (MIMO receive), through the kernel's MIMO configuration when
the scene is in its scope (`supported(..., mimo=True)`), else through
the wavefront; `develop_mimo` makes the channel cube `dsp.beamform`
takes.
"""

from __future__ import annotations

import dataclasses

import torch

from . import film as film_mod
from ._device import resolve_device
from .core import transform as tfm, warp
from .core.math import Pi
from .core.rng import make_stream
from .integrators import receive_kernel as rk
from .integrators.radar_path import radar_receive_trace
from .radar.endpoints import (ADCConfig, rx_aperture_weight, rx_array_frame,
                              rx_elem_offsets, rx_elem_pattern_gain,
                              rx_sample_ray, rx_sample_frequency)


def _time_and_frequency(scene_data, rx, lo_wf, stream, n: int, dev,
                        time_sampling: str):
    """A lane's receive time and frequency draws: (t_rx, f_rx, the
    frequency's pdf weight, stream)."""
    cfg = rx.adc
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
    return t_rx, f_rx, f_w, stream


def _receive_pass(scene_data, rx, shape_idx: int, lo_wf, stream, adc,
                  n_lanes: int, max_depth: int, coherent: bool = False,
                  time_sampling: str = 'fixed'):
    """One wavefront of `n_lanes` receive lanes drawing from `stream`,
    splatted into `adc` in place; returns it."""
    cfg = rx.adc
    t_rx, f_rx, f_w, stream = _time_and_frequency(
        scene_data, rx, lo_wf, stream, n_lanes, adc.device, time_sampling)
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


def _kernel_scope(scene, scene_data, rx, dev, polarized: bool,
                  why: list) -> bool:
    if polarized:
        why.append('polarized receive is outside the receive kernel '
                   '(ROADMAP B7)')
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
    if use_kernel and _kernel_scope(scene, scene_data, rx, dev, polarized,
                                    why):
        out, n = rk.receive_kernel(scene, scene_data, rx, spp=spp, seed=seed,
                                   max_depth=max_depth,
                                   time_sampling=time_sampling,
                                   coherent=coherent, device=dev)
        n_ch = 2 if coherent else 1
        adc = film_mod.film_new(rx.adc.n_time, rx.adc.n_freq, n_ch,
                                device=dev)
        adc[..., :n_ch] = out.reshape(rx.adc.n_time, rx.adc.n_freq, n_ch)
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


# receive() options the CPI launch takes; any other sends engine='scan' to
# the per-pulse loop
_CPI_KW = {'spp', 'max_depth', 'time_sampling'}


def receive_cpi(scene, receiver_id: str | None = None, n_pulses: int = 16,
                prf: float = 1000.0, t0: float = 0.0, seed: int = 0,
                coherent: bool = True, common_random_numbers: bool = True,
                engine: str = 'scan', device=None, **receive_kw):
    """Coherent processing interval over an animated scene: the scene at
    t = t0 + p / prf (`Scene.at_time`, quasistatic slow time) for each
    pulse p.  Returns (cube (n_pulses, n_time, n_freq, C + 2), samples a
    pulse), the film layout of `receive` with a leading pulse axis, ready
    for `dsp.rangedoppler.doppler_fft`.

    engine='pallas' runs every pulse in one launch of the receive kernel
    (`receive_kernel.receive_kernel_cpi`; on the CPU its plain version) and
    raises `NotImplementedError` outside the kernel's scope; its
    time_sampling defaults to 'gate'.  'scan' (the default) does the same
    when the first snapshot is in the kernel's scope and `receive_kw`
    holds only spp, max_depth and time_sampling (default 'fixed'), else
    runs the loop.  'loop' runs one `receive()` per pulse, routed by
    scope.  `common_random_numbers` (default True) gives every pulse the
    same sample stream, so the Monte Carlo noise cancels in slow-time
    differences; False seeds pulse p with seed + 7919 p.  Runs on
    `device` (`cuda` by default; raises without a card)."""
    dev = resolve_device(device)
    if engine not in ('scan', 'pallas', 'loop'):
        raise ValueError(f'engine {engine!r}: scan, pallas or loop')
    if engine == 'pallas' and not set(receive_kw) <= _CPI_KW:
        raise ValueError(f"engine='pallas' takes {sorted(_CPI_KW)}, not "
                         f'{sorted(set(receive_kw) - _CPI_KW)}')
    kernel = False
    if engine != 'loop' and set(receive_kw) <= _CPI_KW:
        try:   # the scope check and the pack, cached on the scene
            rk.pack_cpi(scene, n_pulses, prf, t0, receiver_id)
            kernel = True
        except NotImplementedError:
            if engine == 'pallas':
                raise
    if kernel:
        sig, n = rk.receive_kernel_cpi(
            scene, n_pulses=n_pulses, prf=prf, t0=t0, seed=seed,
            spp=receive_kw.get('spp', 4096),
            max_depth=receive_kw.get('max_depth', 3),
            time_sampling=receive_kw.get(
                'time_sampling', 'gate' if engine == 'pallas' else 'fixed'),
            coherent=coherent, common_random_numbers=common_random_numbers,
            receiver_id=receiver_id, device=dev)
        if not coherent:
            sig = sig[..., None]
        pad = torch.zeros(sig.shape[:-1] + (2,), dtype=sig.dtype,
                          device=dev)
        return torch.cat([sig, pad], dim=-1), n
    seeds, _ = rk.cpi_seeds(seed, n_pulses, common_random_numbers)
    cube, n = [], 0
    for p in range(n_pulses):
        snap = scene.at_time(t0 + p / prf)
        rx = rk.cpi_receiver(snap, receiver_id)
        adc, n = receive(snap, snap.compile(device=dev), rx, seed=seeds[p],
                         coherent=coherent, device=dev, **receive_kw)
        cube.append(adc)
    return torch.stack(cube), n


# ---------------------------------------------------------------------------
# MIMO receive: one coherent I / Q channel a receive-array element
# ---------------------------------------------------------------------------


def _receive_mimo_pass(scene_data, rx, shape_idx: int, lo_wf, stream, adc,
                       elem_off, n_lanes: int, max_depth: int,
                       time_sampling: str = 'fixed'):
    """One wavefront of MIMO receive lanes, splatted into `adc` (n_time,
    n_freq, 2E + 2) in place; returns it.  The rays leave the array's
    origin (each element's position enters through its phase) over the
    cosine hemisphere about the array's normal, weighted by one element's
    pattern gain.  The stream keeps `_receive_pass`'s layout: its
    position draw is taken and not used."""
    cfg = rx.adc
    n = n_lanes
    t_rx, f_rx, f_w, stream = _time_and_frequency(
        scene_data, rx, lo_wf, stream, n, adc.device, time_sampling)
    _, stream = stream.next_2d()
    u_dir, stream = stream.next_2d()
    wl_rx = scene_data.band.c / torch.clamp(f_rx, min=1e-6)
    origin, sn, tn, nrm = rx_array_frame(scene_data, rx, shape_idx)
    o = (origin + 1e-4 * nrm).expand(n, 3)
    frame = tfm.frame_from_normal(nrm.expand(n, 3))
    d = tfm.to_world(frame, warp.square_to_cosine_hemisphere(u_dir))
    w = Pi * rx_elem_pattern_gain(rx, sn, tn, d, wl_rx) * rx.gain
    radar_receive_trace(
        scene_data, stream, o, d, t_rx, f_rx, w * f_w, adc, cfg,
        rx.receive_type, lo_wf, rx.velocity, max_depth=max_depth,
        coherent=True, time_sampling=time_sampling, elem_offsets=elem_off)
    return adc


def receive_mimo(scene, scene_data=None, receiver=None, seed: int = 0,
                 spp: int = 4096, max_depth: int = 3,
                 lanes_per_pass: int = 1 << 17, sampler: str = 'independent',
                 time_sampling: str = 'fixed', elem_offsets=None,
                 use_kernel: str | bool = 'auto', device=None):
    """MIMO receive of a phased receive array: returns (adc (n_time,
    n_freq, 2E + 2), total_samples), the 2E channels interleaved I / Q a
    receive element [I_0, Q_0, I_1, Q_1, ...], then the weight and count
    channels.  Every connection splats into each element's pair with the
    exact spherical phase of the element's position.  Feed `develop_mimo`,
    then `dsp.beamform`.

    `elem_offsets` (E, 3) overrides the world offsets of the elements from
    the array origin (default: the receiver spec's element grid,
    `rx_elem_offsets`).  `use_kernel`: 'auto' runs the kernel's MIMO
    configuration (K1 on a card, its plain version on the CPU) when
    `receive_kernel.supported(..., mimo=True)` holds, else the wavefront;
    True the kernel, raising `NotImplementedError` with the reasons
    outside its scope; False the wavefront.  Samples as in `receive`.
    Runs on `device` (`cuda` by default; raises without a card)."""
    dev = resolve_device(device)
    if scene_data is None:
        scene_data = scene.compile(device=dev)
    rx = receiver or scene.receivers[0]
    if use_kernel not in ('auto', True, False):
        raise ValueError(f'use_kernel {use_kernel!r}: auto, True or False')
    why: list = []
    if use_kernel and rk.in_scope(scene, scene_data, rx, dev, why,
                                  mimo=True):
        out, n = rk.receive_kernel(scene, scene_data, rx, spp=spp, seed=seed,
                                   max_depth=max_depth,
                                   time_sampling=time_sampling, mimo=True,
                                   elem_offsets=elem_offsets, device=dev)
        n_ch = int(out.shape[-1])
        adc = film_mod.film_new(rx.adc.n_time, rx.adc.n_freq, n_ch,
                                device=dev)
        adc[..., :n_ch] = out
        return adc, n
    if use_kernel is True:
        raise NotImplementedError("scene outside the receive kernel's MIMO "
                                  'scope: ' + '; '.join(why))
    sd = scene_mono(scene_data)
    shape_idx = scene.shape_index_of_endpoint('receiver', rx.id)
    eoff = rx_elem_offsets(sd, rx, shape_idx) if elem_offsets is None \
        else torch.as_tensor(elem_offsets, dtype=torch.float32, device=dev)
    cfg = rx.adc
    adc = film_mod.film_new(cfg.n_time, cfg.n_freq, 2 * int(eoff.shape[0]),
                            device=dev)
    n_pass = max(1, (spp + lanes_per_pass - 1) // lanes_per_pass)
    lanes = min(spp, lanes_per_pass)
    lo = None if rx.lo_waveform is None else rx.lo_waveform.to(dev)
    for p in range(n_pass):
        stream = make_stream(sampler, seed, lanes, p, device=dev)
        _receive_mimo_pass(sd, rx, shape_idx, lo, stream, adc, eoff, lanes,
                           max_depth, time_sampling)
    return adc, lanes * n_pass


def develop_mimo(adc: torch.Tensor, total_samples: int,
                 cfg: ADCConfig) -> torch.Tensor:
    """Normalise a MIMO accumulation into the complex channel cube (E,
    n_time, n_freq) that `dsp.beamform` takes."""
    n_e = (adc.shape[-1] - 2) // 2
    iq = adc[..., :2 * n_e] * (cfg.n_time / max(int(total_samples), 1))
    cube = torch.complex(iq[..., 0::2], iq[..., 1::2])
    return torch.movedim(cube, -1, 0)
