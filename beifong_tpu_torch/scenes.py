"""Ready-made scenes.

`flagship_scene` is the scene the JAX package's `__graft_entry__`
builds for its benchmark and entry point: a 40 kHz sonar band, Wigner
transmitter and receiver apertures 0.6 m apart, a diffuse 1 m target
plate R metres out, a 40 m ground plane, a 2 ms pulse and a raw
64-bin ADC over 60 ms.
"""

from __future__ import annotations

import numpy as np

from . import scene as sc
from .bsdf.tables import diffuse
from .core import transform as tf
from .core.config import Band
from .geometry import shapes as sh
from .radar import (ADCConfig, omni_receiver, pulse, wigner_receiver,
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
