"""Ready-made scenes.

`flagship_scene` is the scene the JAX package's `__graft_entry__`
builds for its benchmark and entry point: a 40 kHz sonar band, Wigner
transmitter and receiver apertures 0.6 m apart, a diffuse 1 m target
plate R metres out, a 40 m ground plane, a 2 ms pulse and a raw
64-bin ADC over 60 ms.

`mesh_scene` is the JAX package's mesh benchmark scene
(`benchmarks/mesh_megakernel.py::build`): the same endpoints and ADC,
no ground, and for the target a crumpled 1.2 m grid of 2 n_side^2
triangles (9,800 at n_side = 71) R metres out.

`multi_body_scene` is the JAX package's `examples/multi_body.py`: a
40 kHz sonar with 25 mm apertures staring down-range at two crumpled
162-triangle meshes, a stationary diffuse one at 3 m and a GGX rough
conductor at 5.5 m (1.5 m up) closing at 3 m/s, on a 16 x 32 time x
Doppler ADC.  Its 324 faces stay below the BVH threshold: the example
compiles with `use_bvh=False`, and its triangle tests are dense.

`range_doppler_scene` is one pulse of the JAX package's
`examples/range_doppler.py`: a CW 40 kHz sonar, the flagship's apertures,
a diffuse 1 m plate closing at 5 m/s from 4 m, on an 8 x 128 time x
Doppler ADC over 38-42 kHz.
"""

from __future__ import annotations

import numpy as np

from . import scene as sc
from .bsdf.tables import diffuse, rough_conductor
from .core import transform as tf
from .core.config import Band
from .geometry import shapes as sh
from .geometry.mesh import MeshSpec, make_grid
from .radar import (ADCConfig, cw, omni_receiver, pulse, wigner_receiver,
                    wigner_transmitter)


def flagship_scene(R: float = 4.0, ground: bool = True,
                   rx_kind: str = 'wigner'):
    """Returns (scene, receiver spec)."""
    band = Band.from_freq(340.0, 40e3, 10e3)
    s = sc.Scene(band=band)
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    if rx_kind == 'omni':
        rx = omni_receiver('rx', adc, position=(-0.3, 0, 0),
                           receive_type='raw')
        s.add(rx)
    else:
        rx = wigner_receiver('rx', adc, receive_type='raw')
        s.add(rx)
        aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0],
                                                  [-0.3, -1, 0]),
                                       tf.scale([0.05, 0.05, 1.0])))
        s.add(sh.rectangle(to_world=aim_rx, receiver='rx'))
    tgt = np.asarray(tf.compose(tf.look_at([0, -R, 0], [0, 0, 0]),
                                tf.scale(0.5)))
    s.add(sh.rectangle(to_world=tgt, bsdf='mat'))
    if ground:
        gnd = np.asarray(tf.compose(tf.translate([0, 0, -0.5]),
                                    tf.scale(20.0)))
        s.add(sh.rectangle(to_world=gnd, bsdf='mat'))
    return s, rx


def mesh_scene(R: float = 4.0, n_side: int = 71):
    """Returns (scene, receiver spec)."""
    band = Band.from_freq(340.0, 40e3, 10e3)
    s = sc.Scene(band=band)
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                                   tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim_rx, receiver='rx'))
    v, f = make_grid(n_side, n_side)
    v[:, 2] = 0.05 * np.sin(6 * v[:, 0]) * np.cos(5 * v[:, 1])
    m = np.asarray(tf.compose(tf.look_at([0, -R, 0], [0, 0, 0]),
                              tf.scale(0.6)))
    s.add(MeshSpec(v, f, bsdf='mat', to_world=m))
    return s, rx


MULTI_BODY = dict(R1=3.0, R2=5.5, v2=3.0, lift2=1.5)


def multi_body_scene():
    """Returns (scene, receiver spec); the bodies' parameters are
    MULTI_BODY (ranges R1, R2 [m], closing speed v2 [m/s], lift2 [m])."""
    fc, c = 40e3, 340.0
    r1, r2, v2 = MULTI_BODY['R1'], MULTI_BODY['R2'], MULTI_BODY['v2']
    s = sc.Scene(band=Band.from_freq(c, fc, 10e3))
    s.add(diffuse('hull', reflectance=1.0, twosided=True))
    s.add(rough_conductor('metal', specular_reflectance=1.0, alpha=0.3,
                          eta=1.5, k=3.0, twosided=True))
    wf = pulse(f_centre=fc, prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    # small apertures: a wide beam covering both bodies
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.0125, 0.0125, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=16, n_freq=32, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=fc - 1e3, freq_hi=fc + 3e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                                   tf.scale([0.0125, 0.0125, 1.0])))
    s.add(sh.rectangle(to_world=aim_rx, receiver='rx'))
    v, f = make_grid(9, 9)
    v[:, 2] = 0.05 * np.sin(4 * v[:, 0]) * np.cos(3 * v[:, 1])
    m1 = np.asarray(tf.compose(tf.look_at([0, -r1, 0], [0, 0, 0]),
                               tf.scale(0.6)))
    s.add(MeshSpec(v, f, bsdf='hull', to_world=m1))
    m2 = np.asarray(tf.compose(tf.look_at([0.0, -r2, MULTI_BODY['lift2']],
                                          [0, 0, 0]), tf.scale(0.6)))
    s.add(MeshSpec(v, f, bsdf='metal', to_world=m2,
                   velocity=np.asarray([0.0, v2, 0.0], np.float32)))
    return s, rx


RANGE_DOPPLER = dict(R0=4.0, v=5.0, prf=20.0)


def range_doppler_scene(p: int = 0):
    """Returns (scene, receiver spec) of pulse `p`: the plate at
    R0 - v p / prf metres, closing at v m/s (RANGE_DOPPLER)."""
    fc = 40e3
    r0, v, prf = (RANGE_DOPPLER[k] for k in ('R0', 'v', 'prf'))
    rp = r0 - v * p / prf
    s = sc.Scene(band=Band.from_freq(340.0, fc, 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    s.add(wigner_transmitter('tx', cw(f_centre=fc), resample_freq=True))
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=8, n_freq=128, sampling_start=0.0,
                    sampling_time=0.04, freq_lo=fc - 2e3, freq_hi=fc + 2e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                                   tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim_rx, receiver='rx'))
    tgt = np.asarray(tf.compose(tf.look_at([0, -rp, 0], [0, 0, 0]),
                                tf.scale(0.5)))
    s.add(sh.rectangle(to_world=tgt, bsdf='mat',
                       velocity=np.array([0, v, 0], np.float32)))
    return s, rx


def round_trip_bin(scene, rx, target=(0.0, -4.0, 0.0)) -> float:
    """Fast-time bin (continuous, bin centres at integers) of the
    transmitter -> target -> receiver delay: the 2R/c anchor a range
    profile must peak at."""
    tx_pos = _endpoint_position(scene, 'transmitter', scene.transmitters[0])
    rx_pos = _endpoint_position(scene, 'receiver', rx)
    tgt = np.asarray(target, np.float64)
    path = np.linalg.norm(tx_pos - tgt) + np.linalg.norm(tgt - rx_pos)
    a = rx.adc
    return ((path / scene.band.c - a.sampling_start) / a.sampling_time
            * a.n_time - 0.5)


def _endpoint_position(scene, kind, spec) -> np.ndarray:
    i = scene.shape_index_of_endpoint(kind, spec.id)
    m = scene.shapes[i].to_world if i >= 0 else spec.to_world
    return np.asarray(m, np.float64)[:3, 3]
