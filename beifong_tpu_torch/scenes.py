"""Ready-made scenes.

`flagship_scene` is the scene the JAX package's `__graft_entry__`
builds for its benchmark and entry point: a 40 kHz sonar band, Wigner
transmitter and receiver apertures 0.6 m apart, a diffuse 1 m target
plate R metres out, a 40 m ground plane, a 2 ms pulse and a raw
64-bin ADC over 60 ms.  `ground_texture` puts a texture on the ground's
own diffuse BSDF: a checkerboard of 1 m cells (0.8 / 0.3), or a 128 x 128
reflectance bitmap (the JAX kernel's largest) drawn from
`GROUND_BITMAP_SEED`.

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

The FMCW and pulse-train scenes are the repository's golden ladder
(`tests/golden/configs.py`): `fmcw_sonar_scene` is config 2 (and
`examples/fmcw_sonar.py`), `pulse_train_scene(p)` pulse p of config 3,
`corner_scene` config 4 (a trihedral of mirrors on keyframes, 64 pulses)
and `micro_doppler_scene` config 5 (an orbiting plate, 64 pulses), both
for `receive_cpi`, with their anchors and signal chains;
`fmcw_dechirp_scene` is a single-pulse dechirp with a diffuse plate for
the target; `fmcw_scene` is the FMCW point-target scene of the JAX
package's receive-type tests (`tests/test_radar.py`).
`mimo_beamform_scene` is config 6, an 8-element receive array for
`receive_mimo` and digital beamforming, with its azimuth scan
(`mimo_azimuth_scan`).

`phased_tx_scene`, `phased_rx_scene` and `four_tx_scene` are the JAX
package's kernel tests of the endpoints (`tests/test_pallas_receive.py`):
a steered phased transmitter, a steered analog phased receiver between
two targets at different ranges, and four transmitters of three kinds at
staggered ranges, with their anchors (`round_trip_bin`, `steer_toward`).

`window_corner_scene`, `plastic_scene`, `rough_dielectric_scene` and
`composite_scene` are the JAX package's kernel tests of its lobes
(`tests/test_pallas_receive.py:1669-2043`): a radome (a thin or smooth
dielectric window) in front of a trihedral corner, plastic and rough
plastic plates, GGX glass in backscatter and in transmission between
the transmitter and the receiver, and blend and mask composites, with
their anchors (`thin_window_transmittance`, `lobe_bin`);
`mesh_scene(material='rough_plastic')` is the mesh scene with the
rough plastic on its triangles.

`stratified_medium_scene(med)` is the JAX package's
`examples/stratified_medium.py`: a sonar looking down through an
absorbing slab (`stratified_layers`) at a target on the floor, with the
closed-form echo attenuation (`two_leg_transmittance`) and the
example's own reading of it (`echo_attenuation`); `stratified_homogeneous`
and `medium_grid` give the other two media over the same scene.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene as sc
from .bsdf.tables import (blend, conductor, dielectric, diffuse, mask,
                          plastic, rough_conductor, rough_dielectric,
                          rough_plastic, thin_dielectric)
from .core import transform as tf
from .core.config import Band
from .geometry import shapes as sh
from .geometry.mesh import MeshSpec, make_grid
from .media import HeterogeneousMedium, HomogeneousMedium, LayeredMedium
from .radar import (ADCConfig, area_transmitter, cw, linfmcw, omni_receiver,
                    phased_receiver, phased_transmitter, pulse,
                    wigner_receiver, wigner_transmitter)
from .textures import bitmap, checkerboard

GROUND_BITMAP_SEED = 0      # flagship_scene(ground_texture='bitmap')'s image


TARGETS = ('plate', 'sphere', 'disk', 'cylinder')
MATERIALS = ('diffuse', 'conductor', 'rough_conductor')
# the target's metal (`flagship_scene(material=...)`): multi_body's
METAL = dict(eta=1.5, k=3.0, alpha=0.3)


def target_range(target: str = 'plate', R: float = 4.0) -> float:
    """The distance from the apertures' line to the near surface of
    `flagship_scene`'s target."""
    return R - 0.3 if target == 'cylinder' else R


def _add_target(s, target: str, R: float, bsdf: str, velocity=None):
    """`target` (one of TARGETS) at range R on the boresight, as
    `flagship_scene` places it, with BSDF `bsdf`, moving at `velocity`."""
    if target not in TARGETS:
        raise ValueError(f'target {target!r}: one of {TARGETS}')
    kw = dict(bsdf=bsdf)
    if velocity is not None:
        kw['velocity'] = np.asarray(velocity, np.float32)
    facing = np.asarray(tf.compose(tf.look_at([0, -R, 0], [0, 0, 0]),
                                   tf.scale(0.5)))
    if target == 'plate':
        s.add(sh.rectangle(to_world=facing, **kw))
    elif target == 'sphere':
        s.add(sh.sphere(center=(0.0, -(R + 0.4), 0.0), radius=0.4, **kw))
    elif target == 'disk':
        s.add(sh.disk(to_world=facing, **kw))
    else:
        s.add(sh.cylinder(to_world=np.asarray(tf.compose(
            tf.translate([0.0, -R, -0.6]), tf.scale([0.3, 0.3, 1.2]))),
            **kw))


def add_ground(s, ground_texture: str | None = None, bsdf: str = 'mat'):
    """Adds `flagship_scene`'s 40 m ground 0.5 m below the apertures to
    the scene `s`, static: BSDF `bsdf`, or with `ground_texture`
    ('checkerboard' or 'bitmap') a textured diffuse BSDF 'gnd' of its
    own."""
    if ground_texture not in (None, 'checkerboard', 'bitmap'):
        raise ValueError(f'ground_texture {ground_texture!r}: None, '
                         "'checkerboard' or 'bitmap'")
    gnd = np.asarray(tf.compose(tf.translate([0, 0, -0.5]), tf.scale(20.0)))
    if ground_texture == 'checkerboard':
        s.add(checkerboard('gnd_tex', 0.8, 0.3, scale_uv=(40.0, 40.0)))
    elif ground_texture == 'bitmap':
        img = np.random.default_rng(GROUND_BITMAP_SEED).uniform(
            0.2, 1.0, (128, 128)).astype(np.float32)
        s.add(bitmap('gnd_tex', img))
    if ground_texture is not None:
        s.add(diffuse('gnd', reflectance=1.0, twosided=True,
                      texture='gnd_tex'))
        bsdf = 'gnd'
    s.add(sh.rectangle(to_world=gnd, bsdf=bsdf))


def _add_material(s, material: str) -> str:
    """The target's BSDF of `material` (one of MATERIALS): the scene's
    diffuse 'mat', or a smooth or GGX rough conductor 'metal' (METAL) of
    its own.  Returns its id."""
    if material not in MATERIALS:
        raise ValueError(f'material {material!r}: one of {MATERIALS}')
    if material == 'conductor':
        s.add(conductor('metal', eta=METAL['eta'], k=METAL['k'],
                        twosided=True))
    elif material == 'rough_conductor':
        s.add(rough_conductor('metal', alpha=METAL['alpha'],
                              eta=METAL['eta'], k=METAL['k'],
                              twosided=True))
    return 'mat' if material == 'diffuse' else 'metal'


def flagship_scene(R: float = 4.0, ground: bool = True,
                   rx_kind: str = 'wigner', ground_texture: str | None = None,
                   target: str = 'plate', material: str = 'diffuse'):
    """Returns (scene, receiver spec).  `ground_texture` None leaves the
    scene as it is; 'checkerboard' or 'bitmap' gives the ground a diffuse
    BSDF of its own ('gnd', the target keeps 'mat') textured with 0.8 /
    0.3 checks of 1 m (scale_uv 40 on the 40 m plane) or with a 128 x 128
    map uniform in [0.2, 1.0] from
    numpy.random.default_rng(GROUND_BITMAP_SEED).  `target` is the shape
    at range R: 'plate' the 1 m square facing the apertures; 'sphere' a
    sphere of radius 0.4 m, its near surface at R; 'disk' a disk of radius
    0.5 m facing the apertures; 'cylinder' a vertical cylinder of radius
    0.3 m and height 1.2 m centred on the boresight at R, its near surface
    at R - 0.3 (`target_range`).  `material` is the target's: 'diffuse'
    (the scene's 'mat'), or 'conductor' / 'rough_conductor', a smooth or
    GGX rough metal of its own (METAL): the conducting sphere is radar's
    calibration target, whose echo does not depend on aspect.  A metal
    target puts the scene into the Doppler configuration (the mirror
    chains, the GGX lobe)."""
    if ground_texture not in (None, 'checkerboard', 'bitmap'):
        raise ValueError(f'ground_texture {ground_texture!r}: None, '
                         "'checkerboard' or 'bitmap'")
    if target not in TARGETS:
        raise ValueError(f'target {target!r}: one of {TARGETS}')
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
    _add_target(s, target, R, _add_material(s, material))
    if ground:
        add_ground(s, ground_texture)
    return s, rx


def mesh_scene(R: float = 4.0, n_side: int = 71, material: str = 'diffuse'):
    """Returns (scene, receiver spec); `material` 'rough_plastic' puts
    `plastic_scene`'s rough plastic on the mesh."""
    band = Band.from_freq(340.0, 40e3, 10e3)
    s = sc.Scene(band=band)
    s.add(_lobe_material('mat', material))
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


def range_doppler_scene(p: int = 0, target: str = 'plate',
                        ground_texture: str | None = None):
    """Returns (scene, receiver spec) of pulse `p`: the plate at
    R0 - v p / prf metres, closing at v m/s (RANGE_DOPPLER).  `target`
    puts another of TARGETS there, placed as `flagship_scene` places it
    (a sphere's near surface at that range, a cylinder's 0.3 m nearer),
    closing at v too; `ground_texture` ('checkerboard' or 'bitmap') adds
    `flagship_scene`'s textured ground, static (its clutter at 0 Hz)."""
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
    _add_target(s, target, rp, 'mat', (0.0, v, 0.0))
    if ground_texture is not None:
        add_ground(s, ground_texture)
    return s, rx


C_SOUND = 340.0
# the LFMCW sonar of the golden ladder's configs 2 and 4: 40 kHz, a 2 kHz
# sweep over a 90 ms chirp
FMCW = dict(fc=40e3, sweep=2e3, chirp=90e-3)


def _plate(s, center, size, look_to=(0.0, 0.0, 0.0), **kw):
    """A diffuse 'mat' plate of half-width `size` at `center`, facing
    `look_to`."""
    m = np.asarray(tf.compose(tf.look_at(list(center), list(look_to)),
                              tf.scale(size)))
    s.add(sh.rectangle(to_world=m, bsdf='mat', **kw))


def _aperture(s, pos, aim, scale, **endpoint):
    m = np.asarray(tf.compose(tf.look_at(list(pos), list(aim)),
                              tf.scale(list(scale))))
    s.add(sh.rectangle(to_world=m, **endpoint))


def _lfmcw():
    return linfmcw(f_centre=FMCW['fc'], crf=1.0 / FMCW['chirp'],
                   chirp_len=FMCW['chirp'], freq_sweep=FMCW['sweep'],
                   is_delta=True)


def fmcw_beat_hz(r: float) -> float:
    """The LFMCW's beat frequency slope 2R / c of a target R metres out."""
    return FMCW['sweep'] / FMCW['chirp'] * 2.0 * r / C_SOUND


FMCW_SONAR_R = 6.0


def fmcw_sonar_scene(target: str = 'plate'):
    """Golden config 2, `fmcw_sonar` (= examples/fmcw_sonar.py): the LFMCW
    sonar, 20 x 50 mm apertures 0.2 m apart, a mix_resample receiver
    dechirping against the transmitted chirp on a 16 x 256 time x beat
    ADC over [0, 4 f_beat], a diffuse 1 m plate FMCW_SONAR_R metres out;
    `target` 'sphere' puts the sonar's calibration sphere (0.4 m) there in
    its place, its near surface at FMCW_SONAR_R.  Returns (scene, receiver
    spec)."""
    if target not in ('plate', 'sphere'):
        raise ValueError(f"target {target!r}: 'plate' or 'sphere'")
    s = sc.Scene(band=Band.from_freq(C_SOUND, FMCW['fc'],
                                     2 * FMCW['sweep']))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = _lfmcw()
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.1, 0, 0), (0.1, -1, 0), (0.01, 0.025, 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=16, n_freq=256, sampling_start=0.02,
                    sampling_time=0.06, freq_lo=0.0,
                    freq_hi=4 * fmcw_beat_hz(FMCW_SONAR_R))
    rx = wigner_receiver('rx', adc, receive_type='mix_resample',
                         lo_waveform=wf)
    s.add(rx)
    _aperture(s, (-0.1, 0, 0), (-0.1, -1, 0), (0.01, 0.025, 1.0),
              receiver='rx')
    _add_target(s, target, FMCW_SONAR_R, 'mat')
    return s, rx


def fmcw_scene(receive_type: str, dR: float = 0.0):
    """The FMCW point-target scene of the JAX package's receive-type tests
    (tests/test_radar.py `_fmcw_scene`): the LFMCW with the flagship's
    apertures, a receiver of `receive_type` with the chirp as its LO, a
    diffuse 1 m plate 6 + dR metres out, an 8 x 128 time x beat ADC over
    [0, 4 f_beat].  raw_resample bins the received frequency, so it takes
    the raw window of that file's raw_resample test instead (8 x 64 over
    38-42 kHz).  Returns (scene, receiver spec)."""
    r = 6.0 + dR
    s = sc.Scene(band=Band.from_freq(C_SOUND, FMCW['fc'], 4e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = _lfmcw()
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.3, 0, 0), (0.3, -1, 0), (0.05, 0.05, 1.0),
              transmitter='tx')
    if receive_type == 'raw_resample':
        adc = ADCConfig(n_time=8, n_freq=64, sampling_start=0.03,
                        sampling_time=0.05, freq_lo=38e3, freq_hi=42e3)
    else:
        adc = ADCConfig(n_time=8, n_freq=128, sampling_start=0.03,
                        sampling_time=0.05, freq_lo=0.0,
                        freq_hi=4 * fmcw_beat_hz(r))
    rx = wigner_receiver('rx', adc, receive_type=receive_type,
                         lo_waveform=wf)
    s.add(rx)
    _aperture(s, (-0.3, 0, 0), (-0.3, -1, 0), (0.05, 0.05, 1.0),
              receiver='rx')
    _plate(s, (0, -r, 0), 0.5)
    return s, rx


# golden config 3: 8 CW pulses at 400 Hz PRF, a plate closing from 4 m at
# 1.0625 m/s, so that the aliased Doppler lands on slow-time bin 5
PULSE_TRAIN = dict(R0=4.0, v=1.0625, prf=400.0, n_pulses=8, fc=40e3)


def pulse_train_scene(p: int = 0):
    """Pulse `p` of golden config 3, `pulse_train_range_doppler`: a CW
    40 kHz sonar, the flagship's apertures, a raw 8-bin fast-time ADC over
    2 ms, a diffuse 1 m plate at R0 - v p / prf metres closing at v m/s
    (PULSE_TRAIN).  Returns (scene, receiver spec)."""
    pt = PULSE_TRAIN
    rp = pt['R0'] - pt['v'] * p / pt['prf']
    s = sc.Scene(band=Band.from_freq(C_SOUND, pt['fc'], 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    s.add(wigner_transmitter('tx', cw(f_centre=pt['fc']),
                             resample_freq=True))
    _aperture(s, (0.3, 0, 0), (0.3, -1, 0), (0.05, 0.05, 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=8, n_freq=1, sampling_start=0.0,
                    sampling_time=2e-3, freq_lo=pt['fc'] - 2e3,
                    freq_hi=pt['fc'] + 2e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    _aperture(s, (-0.3, 0, 0), (-0.3, -1, 0), (0.05, 0.05, 1.0),
              receiver='rx')
    _plate(s, (0, -rp, 0), 0.5,
           velocity=np.array([0, pt['v'], 0], np.float32))
    return s, rx


# golden config 4's fast time: 1024 bins over 50 ms from 30 ms, decimated
# by 8 to the ADC rate; its corner apex 4 m out, the receiver 0.1 m in front
# of the transmitter
DECHIRP = dict(n_fast=1024, window=50e-3, t0=30e-3, q=8, R=4.0,
               rx_pos=(0.0, -0.1, 0.0), plate=0.25, tx=0.05)


def fmcw_dechirp_scene():
    """A single-pulse dechirp scene after golden config 4's receive: the
    LFMCW, a 40 mm mix_resample receiver 0.1 m in front of the transmitter
    looking at a point 4 m out, a 1024 x 1 fast-time ADC over 30-80 ms
    whose coherent I / Q is the dechirped beat signal, and for the target
    a diffuse 0.5 m plate (DECHIRP['plate'] is its half-width) there,
    facing the receiver.  Its transmitter aperture is 0.1 m: a diffuse
    echo's NEE samples the aperture, and across the config's 1.6 m at 4 m
    the paths spread over ~19 Fresnel zones, so its I / Q would average
    away (no beat line at 2^22 samples, where 0.1 m gives one at 2^18).
    The config itself, its trihedral and its 64-pulse CPI, is
    `corner_scene`.  Returns (scene, receiver spec)."""
    d = DECHIRP
    s = sc.Scene(band=Band.from_freq(C_SOUND, FMCW['fc'], 4 * FMCW['sweep']))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = _lfmcw()
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.0, 0, 0), (0.0, -1, 0), (d['tx'], d['tx'], 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=d['n_fast'], n_freq=1, sampling_start=d['t0'],
                    sampling_time=d['window'], freq_lo=0.0, freq_hi=1.5e3)
    rx = wigner_receiver('rx', adc, receive_type='mix_resample',
                         lo_waveform=wf)
    s.add(rx)
    apex = (0.0, -d['R'], 0.0)
    _aperture(s, d['rx_pos'], apex, (0.02, 0.02, 1.0), receiver='rx')
    _plate(s, apex, d['plate'], look_to=d['rx_pos'])
    return s, rx


# golden config 4 (`fmcw_dechirp_chain`): 64 pulses, one a chirp; the
# corner closes so that its aliased Doppler lands on slow-time bin 20 of 64
CORNER = dict(n_pulses=64, prf=1.0 / FMCW['chirp'], R=4.0,
              rx_pos=(0.0, -0.1, 0.0), tx=0.8, rx=0.02, seed=13,
              spp=1 << 16, max_depth=4)
CORNER['v'] = (20.0 / 64.0) * CORNER['prf'] * C_SOUND / (2 * FMCW['fc'])


def corner_scene():
    """Golden config 4, `fmcw_dechirp_chain` (`tests/golden/configs.py`
    `_corner_scene`): the LFMCW with a 1.6 m transmitter aperture, a 40 mm
    mix_resample receiver 0.1 m in front of it (the chirp as its LO) on
    DECHIRP's 1024-bin fast-time ADC, and a trihedral corner reflector of
    smooth-conductor plates (eta 0.2, k 3) with its apex CORNER['R'] m
    out, pointed at the receiver.  The corner translates rigidly at
    (0, v, 0): `AnimatedTransform` keyframes at every pulse time plus the
    matching per-shape velocity, so one scene serves the whole CPI
    through `receive_cpi`.  Its echo is the triple mirror bounce ending in
    a direct transmitter hit.  Returns (scene, receiver spec)."""
    d, c = DECHIRP, CORNER
    s = sc.Scene(band=Band.from_freq(C_SOUND, FMCW['fc'], 4 * FMCW['sweep']))
    s.add(conductor('m', eta=0.2, k=3.0, twosided=True))
    wf = _lfmcw()
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.0, 0, 0), (0.0, -1, 0), (c['tx'], c['tx'], 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=d['n_fast'], n_freq=1, sampling_start=d['t0'],
                    sampling_time=d['window'], freq_lo=0.0, freq_hi=1.5e3)
    rx = wigner_receiver('rx', adc, receive_type='mix_resample',
                         lo_waveform=wf)
    s.add(rx)
    rx_pos = np.asarray(c['rx_pos'])
    apex = np.array([0.0, -c['R'], 0.0])
    _aperture(s, rx_pos, apex, (c['rx'], c['rx'], 1.0), receiver='rx')
    v, prf = c['v'], c['prf']
    faces = sh.trihedral(apex, rx_pos - apex, bsdf='m',
                         velocity=np.array([0.0, v, 0.0], np.float32))
    for f in faces:
        base = np.asarray(f.to_world)
        f.to_world = tf.AnimatedTransform.from_keyframes(
            [(p / prf, np.asarray(tf.compose(
                tf.translate([0.0, v * p / prf, 0.0]), base)))
             for p in range(c['n_pulses'] + 1)])
        s.add(f)
    return s, rx


def corner_anchors() -> dict:
    """Config 4's analytic range-Doppler cell from the geometry alone
    (`configs.py:274-284`): the beat slope x the two-way delay on the
    decimated range axis, and the slow-time bin of the closing apex's
    phase progression (fftshifted)."""
    d, c = DECHIRP, CORNER
    rx_pos = np.asarray(c['rx_pos'])
    apex0 = np.array([0.0, -c['R'], 0.0])
    n_adc = d['n_fast'] // d['q']
    fs_adc = d['n_fast'] / d['window'] / d['q']
    tau = 2 * np.linalg.norm(apex0 - rx_pos) / C_SOUND
    f_beat = FMCW['sweep'] / FMCW['chirp'] * tau
    taus = [2 * np.linalg.norm(apex0 + [0, c['v'] * p / c['prf'], 0]
                               - rx_pos) / C_SOUND
            for p in range(c['n_pulses'])]
    ph = np.exp(2j * np.pi * FMCW['fc'] * np.asarray(taus))
    return dict(range_bin=int(round(f_beat / fs_adc * n_adc)) % n_adc,
                doppler_bin=int(np.abs(np.fft.fftshift(np.fft.fft(ph)))
                                .argmax()))


def corner_rd_map(cube, n: int):
    """Config 4's signal chain on a CPI cube (n_pulses, 1024, 1, 4) of n
    samples a pulse: the dechirped beat I / Q, conjugated (the echo's beat
    rotates at -slope x tau), decimated by 8 to the ADC rate, then Hann
    range and Doppler FFTs.  Returns the (Doppler, range) complex map."""
    from .dsp import rangedoppler as rd
    from .dsp import resample, windows
    d = DECHIRP
    iq = torch.complex(cube[:, :, 0, 0], cube[:, :, 0, 1]) \
        * (d['n_fast'] / max(n, 1))
    dec = resample.decimate(torch.conj(iq), d['q'])
    rc = rd.range_fft(dec, window=windows.hann(dec.shape[-1],
                                               device=cube.device))
    return rd.doppler_fft(rc, window=windows.hann(dec.shape[-2],
                                                  device=cube.device))


# golden config 5 (`micro_doppler_cpi`): a scatterer on a 25 Hz orbit of
# modulation index 3 (its range swing r = 3 lambda / (4 pi)), 64 CW pulses
# at 400 Hz, the rotation rate on slow-time bin 4
MICRO_DOPPLER = dict(n_pulses=64, prf=400.0, m_rot=4, a_mod=3.0, R0=4.0,
                     fc=40e3, seed=11, spp=1 << 13, max_depth=1)


def micro_doppler_scene():
    """Golden config 5, `micro_doppler_cpi` (`configs.py:291-350`): a CW
    40 kHz sonar with the flagship's apertures, a raw 8-bin fast-time ADC
    over 2 ms, and a diffuse 0.6 m plate R0 m out on `AnimatedTransform`
    keyframes at every pulse time, orbiting so that its range swings by
    r sin(2 pi f_rot t).  Returns (scene, receiver spec)."""
    md = MICRO_DOPPLER
    fc, n_pulses, prf = md['fc'], md['n_pulses'], md['prf']
    f_rot = prf * md['m_rot'] / n_pulses
    r_orb = md['a_mod'] * (C_SOUND / fc) / (4 * np.pi)
    s = sc.Scene(band=Band.from_freq(C_SOUND, fc, 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    s.add(wigner_transmitter('tx', cw(f_centre=fc), resample_freq=True))
    _aperture(s, (0.3, 0, 0), (0.3, -1, 0), (0.05, 0.05, 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=8, n_freq=1, sampling_start=0.0,
                    sampling_time=2e-3, freq_lo=fc - 2e3, freq_hi=fc + 2e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    _aperture(s, (-0.3, 0, 0), (-0.3, -1, 0), (0.05, 0.05, 1.0),
              receiver='rx')
    frames = []
    for p in range(n_pulses + 1):
        t_p = p / prf
        psi = 2 * np.pi * f_rot * t_p
        pos = [r_orb * np.cos(psi), -(md['R0'] + r_orb * np.sin(psi)), 0.0]
        frames.append((t_p, np.asarray(tf.compose(
            tf.look_at(pos, [0.0, 0.0, 0.0]), tf.scale(0.3)))))
    tgt = sh.rectangle(bsdf='mat')
    tgt.to_world = tf.AnimatedTransform.from_keyframes(frames)
    s.add(tgt)
    return s, rx


def micro_doppler_spectrum(cube, n: int):
    """Config 5's slow-time spectrum: |FFT|^2 (fftshifted) of each pulse's
    I / Q summed over the ADC, over n samples a pulse."""
    iq = torch.complex(cube[..., 0], cube[..., 1]).sum(dim=(1, 2)) / max(n, 1)
    return torch.fft.fftshift(torch.fft.fft(iq)).abs() ** 2


def micro_doppler_comb_bins() -> list:
    """The Bessel comb's bins: n_pulses / 2 + m_rot k, k = -4 .. 4."""
    md = MICRO_DOPPLER
    return sorted({(md['n_pulses'] // 2 + md['m_rot'] * k) % md['n_pulses']
                   for k in range(-4, 5)})


# golden config 6 (`mimo_beamform`): an 8-element lambda / 2 receive array
# and one target at azimuth az_deg, R metres out; the azimuth scan of its
# beamformers
MIMO = dict(az_deg=15.0, R=4.0, n_elems=8, fc=40e3, seed=3, spp=1 << 13,
            max_depth=2, az_lo=-40.0, az_hi=40.0, n_az=81)


def mimo_beamform_scene(az_deg: float = MIMO['az_deg'],
                        r: float = MIMO['R']):
    """Golden config 6, `mimo_beamform` (`configs.py:377-419`): a 40 kHz
    pulse from an 8 x 8 mm transmitter 0.1 m off the array, a phased
    receive array of 8 elements lambda / 2 apart along x (each lambda / 4
    a side) on a 0.2 mm rectangle at the origin facing -y, a raw 64-bin
    ADC over 60 ms, and a diffuse 0.4 m plate `r` metres out at azimuth
    `az_deg` (from broadside toward +x), facing the array.  Returns
    (scene, receiver spec)."""
    fc = MIMO['fc']
    band = Band.from_freq(C_SOUND, fc, 1e3)
    wl = band.wavelength_centre
    s = sc.Scene(band=band)
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = pulse(f_centre=fc, prf=10.0, pulse_len=2e-3, f_ext=1e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.1, 0, 0), (0.1, -1, 0), (0.004, 0.004, 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=39.5e3, freq_hi=40.5e3)
    rx = phased_receiver('rx', adc, n_elems=MIMO['n_elems'],
                         elem_spacing=wl / 2, elem_wid=(wl / 4, wl / 4),
                         receive_type='raw')
    s.add(rx)
    _aperture(s, (0.0, 0, 0), (0.0, -1, 0), (1e-4, 1e-4, 1.0),
              receiver='rx')
    az = np.radians(az_deg)
    _plate(s, (r * np.sin(az), -r * np.cos(az), 0), 0.2)
    return s, rx


def mimo_azimuth_scan(az_deg: float = MIMO['az_deg'], device='cpu'):
    """Config 6's azimuth scan: (azimuths [rad] (81,) over -40..40 deg,
    the ULA look directions (81, 3) about broadside -y toward +x, the
    grid bin nearest `az_deg`: the anchor both beamformers must peak
    on)."""
    from .dsp.beamform import ula_directions
    az = np.radians(np.linspace(MIMO['az_lo'], MIMO['az_hi'], MIMO['n_az']))
    dirs = ula_directions(az, axis=(1, 0, 0), normal=(0, -1, 0),
                          device=device)
    return az, dirs, int(np.abs(np.degrees(az) - az_deg).argmin())


def mixer_receiver(scene, rx, beat_hi: float = 2e3, n_time: int | None = None):
    """The scene's receiver as a mixer: the first transmitter's waveform
    as its LO (params[33:42]), a beat window [0, beat_hi] Hz drawn a lane
    (the receive frequency is the LO's less the beat), and optionally
    n_time fast-time bins; the scene's receiver is replaced.  Returns
    (scene, receiver spec)."""
    import dataclasses as dc
    adc = dc.replace(rx.adc, freq_lo=0.0, freq_hi=beat_hi,
                     n_time=rx.adc.n_time if n_time is None else n_time)
    rx = dc.replace(rx, receive_type='mixer', adc=adc,
                    lo_waveform=scene.transmitters[0].waveform)
    scene.receivers[0] = rx
    return scene, rx


def round_trip_bin(scene, rx, target=(0.0, -4.0, 0.0), tx=None) -> float:
    """Fast-time bin (continuous, bin centres at integers) of the
    transmitter (`tx`, a spec; the first by default) -> target ->
    receiver delay: the 2R/c anchor a range profile must peak at."""
    tx_pos = _endpoint_position(scene, 'transmitter',
                                tx or scene.transmitters[0])
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


# the endpoint scenes: a 40 kHz pulse in a 1 kHz band (a steered array's
# phases are baked at its centre wavelength), 64 raw bins over 60 ms
PHASED = dict(fc=40e3, n_elems=8, R=4.0, tx=(0.3, 0.0, 0.0),
              tgt_off=1.2, rx_az=16.7, rx_ranges=(4.0, 5.0))


def _endpoint_base(band_hz: float):
    """A scene with the band, the diffuse 'mat', the 2 ms pulse and the raw
    64-bin ADC of the endpoint scenes: (scene, waveform, ADC)."""
    s = sc.Scene(band=Band.from_freq(C_SOUND, PHASED['fc'], band_hz))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = pulse(f_centre=PHASED['fc'], prf=10.0, pulse_len=2e-3,
               f_ext=min(band_hz, 2e3), is_delta=True)
    f_lo, f_hi = PHASED['fc'] - 0.5 * band_hz, PHASED['fc'] + 0.5 * band_hz
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=f_lo, freq_hi=f_hi)
    return s, wf, adc


def steer_toward(array_pos, target) -> float:
    """The steer angle [deg] that points an array at `array_pos`, its
    normal -y and its element axis along +x, at `target` (positive toward
    +x)."""
    v = np.asarray(target, np.float64) - np.asarray(array_pos, np.float64)
    return float(np.degrees(np.arcsin(v[0] / np.linalg.norm(v))))


# the moving GGX target of `phased_tx_scene(moving_ggx=True)`: a rough
# conductor (multi_body's metal) closing along +y
PHASED_GGX = dict(alpha=0.3, eta=1.5, k=3.0, v=5.0)


def phased_tx_scene(steer_deg: float, n_elems: int = PHASED['n_elems'],
                    moving_ggx: bool = False):
    """The JAX package's phased-transmitter kernel test
    (`tests/test_pallas_receive.py:1137-1178`) with `n_elems` elements:
    a phased transmitter at (0.3, 0, 0) facing -y, elements lambda / 2
    apart along x, each lambda / 4 a side, steered `steer_deg` (the
    target's angle: `steer_toward(PHASED['tx'], phased_tx_target())`),
    on a rectangle that spans the array (2 lambda a side at least); a
    20 mm Wigner receiver at (-0.3, 0, 0) aimed at the target, a diffuse
    0.8 m plate 4 m out and 1.2 m to +x, facing the transmitter.
    `moving_ggx` makes the plate a GGX rough conductor closing at
    PHASED_GGX['v'] m/s along +y (the Doppler chain and the GGX lobe of
    the endpoint twins).  Returns (scene, receiver spec)."""
    s, wf, adc = _endpoint_base(1e3)
    if moving_ggx:
        g = PHASED_GGX
        s.bsdfs[0] = rough_conductor('mat', specular_reflectance=1.0,
                                     alpha=g['alpha'], eta=g['eta'],
                                     k=g['k'], twosided=True)
    wl = s.band.wavelength_centre
    p = PHASED
    s.add(phased_transmitter('tx', wf, n_elems=n_elems, elem_spacing=wl / 2,
                             elem_wid=(wl / 4, wl / 4), steer_deg=steer_deg,
                             resample_freq=True))
    half = max(2.0, 0.25 * (n_elems + 1)) * wl
    tx = p['tx']
    _aperture(s, tx, (tx[0], -1.0, 0.0), (half, half, 1.0),
              transmitter='tx')
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    tgt = phased_tx_target()
    _aperture(s, (-0.3, 0.0, 0.0), tgt, (0.02, 0.02, 1.0), receiver='rx')
    vel = {} if not moving_ggx else dict(
        velocity=np.array([0.0, PHASED_GGX['v'], 0.0], np.float32))
    _plate(s, tgt, 0.4, look_to=tx, **vel)
    return s, rx


def phased_tx_target():
    return (PHASED['tgt_off'], -PHASED['R'], 0.0)


def phased_rx_targets():
    """The two targets of `phased_rx_scene`: at azimuth +rx_az from -y
    toward +x, rx_ranges[0] out, and at -rx_az, rx_ranges[1] out."""
    az = np.radians(PHASED['rx_az'])
    return [(sg * r * np.sin(az), -r * np.cos(az), 0.0)
            for sg, r in zip((1.0, -1.0), PHASED['rx_ranges'])]


def phased_rx_scene(steer_deg: float, n_elems: int = PHASED['n_elems']):
    """The JAX package's analog phased-receiver kernel test
    (`tests/test_pallas_receive.py:1222-1268`) with `n_elems` elements:
    a small (8 mm, wide-beam) Wigner transmitter at (0.3, 0, 0) facing
    -y lights two diffuse 0.8 m plates (`phased_rx_targets`: 4 m out at
    +16.7 degrees, 5 m out at -16.7), a phased receiver at the origin
    facing -y, elements lambda / 2 apart along x, each lambda / 4 a side,
    steered `steer_deg`, on a 0.2 mm rectangle.  Steered at one target,
    its echo's bin peaks.  Returns (scene, receiver spec)."""
    s, wf, adc = _endpoint_base(1e3)
    wl = s.band.wavelength_centre
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    tx = PHASED['tx']
    _aperture(s, tx, (tx[0], -1.0, 0.0), (0.004, 0.004, 1.0),
              transmitter='tx')
    rx = phased_receiver('rx', adc, n_elems=n_elems, elem_spacing=wl / 2,
                         elem_wid=(wl / 4, wl / 4), steer_deg=steer_deg,
                         receive_type='raw')
    s.add(rx)
    _aperture(s, (0.0, 0.0, 0.0), (0.0, -1.0, 0.0), (1e-4, 1e-4, 1.0),
              receiver='rx')
    for tgt in phased_rx_targets():
        _plate(s, tgt, 0.4)
    return s, rx


# four transmitters of three kinds, each further behind the receiver's
# plane than the last, so that each echo off the one target falls in its
# own fast-time bins (~4.7 bins apart); the phased one has 5 elements (K =
# 25 pairs, 4 x 25 = 100 <= 128) and stands nearest, its 22 mm array the
# size of the others' 20 mm apertures
FOUR_TX = (('phased', (0.3, 0.0, 0.0)), ('wigner', (0.6, 1.5, 0.3)),
           ('area', (0.9, 3.0, -0.3)), ('wigner', (1.2, 4.5, 0.0)))


def four_tx_scene():
    """After the JAX package's two-transmitter kernel test
    (`tests/test_pallas_receive.py:368-400`): the transmitters of
    `FOUR_TX` (a 5-element lambda / 2 phased array at broadside, two 20 mm
    Wigner apertures and a 20 mm area transmitter), each facing -y, one
    2 ms pulse, a 0.1 m Wigner receiver at (-0.3, 0, 0), a diffuse 1 m
    plate 4 m out facing the origin, raw 64 bins over 60 ms in a 10 kHz
    band.  Returns (scene, receiver spec)."""
    s, wf, adc = _endpoint_base(10e3)
    wl = s.band.wavelength_centre
    for i, (kind, pos) in enumerate(FOUR_TX):
        tid = f'tx{i + 1}'
        if kind == 'phased':
            # its cross-WDF carries its elements' area 4 w_s w_t (the JAX
            # package's pair term); a gain of its inverse levels its echo
            # with the others'
            s.add(phased_transmitter(tid, wf, n_elems=5, elem_spacing=wl / 2,
                                     elem_wid=(wl / 4, wl / 4),
                                     gain=1.0 / (4.0 * (wl / 4) ** 2),
                                     resample_freq=True))
            size = 1.25 * wl
        elif kind == 'area':
            s.add(area_transmitter(tid, wf, resample_freq=True))
            size = 0.01
        else:
            s.add(wigner_transmitter(tid, wf, resample_freq=True))
            size = 0.01
        _aperture(s, pos, (pos[0], pos[1] - 1.0, pos[2]), (size, size, 1.0),
                  transmitter=tid)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    _aperture(s, (-0.3, 0.0, 0.0), (-0.3, -1.0, 0.0), (0.05, 0.05, 1.0),
              receiver='rx')
    _plate(s, (0.0, -4.0, 0.0), 0.5)
    return s, rx


# examples/stratified_medium.py: a 40 kHz sonar 3 m up, a diffuse 1 m
# target on the floor 4 m out, a 1 m absorbing slab (sigma_t 0.4 / m for z
# in [1, 2]) between; the grids span the box the scene's paths stay in
STRATIFIED = dict(target=(0.0, -4.0, 0.0), slab=(1.0, 2.0), sigma=0.4,
                  z_min=0.0, z_max=4.0, sigma_t=0.05,
                  box_min=(-1.0, -5.0, -1.0), box_max=(1.0, 1.0, 4.0),
                  spp=1 << 14, max_depth=2, seed=1)


def stratified_medium_scene(med=None):
    """`examples/stratified_medium.py`'s scene, built as its `build(med)`
    builds it: a 2 ms, 40 kHz pulse from a 0.1 x 0.1 m Wigner transmitter
    at (0.3, 0, 3) aimed at the target, an omni receiver at (-0.3, 0, 3),
    raw 64 bins over 60 ms, a diffuse 1 m plate at (0, -4, 0) facing the
    sonar, and `med` (a `media.py` medium, or None) as the scene's
    ambient medium.  Returns (scene, receiver spec)."""
    s = sc.Scene(band=Band.from_freq(C_SOUND, 40e3, 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    tgt_pos = list(STRATIFIED['target'])
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 3], tgt_pos),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = omni_receiver('rx', adc, position=(-0.3, 0, 3), receive_type='raw')
    s.add(rx)
    tgt = np.asarray(tf.compose(tf.look_at(tgt_pos, [0, 0, 3]),
                                tf.scale(0.5)))
    s.add(sh.rectangle(to_world=tgt, bsdf='mat'))
    s.medium = med
    return s, rx


def stratified_layers(k: int = 4):
    """The example's absorbing slab as a `LayeredMedium` of k equal layers
    over [z_min, z_max] = [0, 4]: k = 4 is the example's
    `LayeredMedium.make([0, 0.4, 0, 0], 0, 4)`; k a multiple of 4 the same
    slab in finer layers (k = 32, the kernel's cap)."""
    st = STRATIFIED
    z = st['z_min'] + (np.arange(k) + 0.5) * (st['z_max'] - st['z_min']) / k
    lo, hi = st['slab']
    sigma = np.where((z > lo) & (z < hi), st['sigma'], 0.0)
    return LayeredMedium.make(sigma, st['z_min'], st['z_max'])


def stratified_homogeneous():
    """A homogeneous water column of extinction sigma_t 0.05 / m."""
    return HomogeneousMedium.make(sigma_t=STRATIFIED['sigma_t'])


def medium_grid(half: bool = False):
    """An 8 x 8 x 128 `HeterogeneousMedium` over the scene's box, sigma_t
    0.05 / m in every cell, or with `half` only in the half-space below
    the box's mid-height (the lower four layers of cells)."""
    cells = np.full((8, 8, 128), STRATIFIED['sigma_t'], np.float32)
    if half:
        cells[4:] = 0.0
    return HeterogeneousMedium.make(cells, box_min=STRATIFIED['box_min'],
                                    box_max=STRATIFIED['box_max'])


def seeded_medium(kind: str):
    """A medium of each kind at its full size that the port's other scenes
    cross too (they lie about z = 0): homogeneous sigma_t 0.05; 32 layers
    of seeded sigma_t in [0, 0.5] over z in [-1, 4]; an 8 x 8 x 128 grid
    of seeded cells in [0, 0.2] over x in [-2, 2], y in [-7, 1], z in
    [-1, 2]."""
    g = np.random.default_rng(8)
    if kind == 'homogeneous':
        return stratified_homogeneous()
    if kind == 'layered':
        return LayeredMedium.make(g.uniform(0.0, 0.5, 32), -1.0, 4.0)
    if kind == 'grid':
        return HeterogeneousMedium.make(g.uniform(0.0, 0.2, (8, 8, 128)),
                                        box_min=(-2.0, -7.0, -1.0),
                                        box_max=(2.0, 1.0, 2.0))
    raise ValueError(f'kind {kind!r}: homogeneous, layered or grid')


def two_leg_transmittance(scene, rx, med) -> float:
    """exp(-tau) of the transmitter -> target -> receiver path through
    the target's centre in `med`: the echo attenuation a range profile
    shows against vacuum (0.263 for the example's slab, 1 m crossed at
    |d_z| = 3 / 5.009 on each leg)."""
    tgt = np.asarray(STRATIFIED['target'], np.float64)
    tau = 0.0
    for end in (_endpoint_position(scene, 'transmitter',
                                   scene.transmitters[0]),
                _endpoint_position(scene, 'receiver', rx)):
        v = end - tgt
        dist = float(np.linalg.norm(v))
        o = torch.tensor(tgt[None], dtype=torch.float32)
        d = torch.tensor((v / dist)[None], dtype=torch.float32)
        med_cpu = med.to('cpu')
        if isinstance(med_cpu, HomogeneousMedium):
            tau += float(med_cpu.sigma_t) * dist
        else:
            tau += float(med_cpu.optical_depth(
                o, d, torch.tensor([dist], dtype=torch.float32))[0])
    return float(np.exp(-tau))


def echo_attenuation(vac, lay) -> float:
    """The example's reading of two range profiles (vacuum, medium): the
    echo's energy in 5 bins about the vacuum profile's peak past bin 10
    (the direct blast comes first), medium over vacuum."""
    vac = np.asarray(vac, np.float64)
    lay = np.asarray(lay, np.float64)
    pk = 10 + int(vac[10:].argmax())
    return float(lay[pk - 2:pk + 3].sum() / vac[pk - 2:pk + 3].sum())


# ---------------------------------------------------------------------------
# the lobes: the JAX package's kernel tests of its dielectric, plastic,
# GGX glass and composite lobes (tests/test_pallas_receive.py:1669-2043),
# the flagship's 40 kHz pulse and 64 raw bins over 60 ms
# ---------------------------------------------------------------------------

LOBES = dict(fc=40e3, R=4.0, ior=1.5, window_at=2.0, window=2.0,
             blend_weight=0.6)


def _lobe_material(mid: str, material: str):
    """The lobe tests' materials: 'diffuse' (the flagship's), 'plastic' and
    'rough_plastic' (diffuse reflectance 0.8, n = 1.49, alpha 0.4)."""
    if material == 'plastic':
        return plastic(mid, diffuse_reflectance=0.8, int_ior=1.49,
                       twosided=True)
    if material == 'rough_plastic':
        return rough_plastic(mid, diffuse_reflectance=0.8, alpha=0.4,
                             int_ior=1.49, twosided=True)
    if material != 'diffuse':
        raise ValueError(f'material {material!r}')
    return diffuse(mid, reflectance=1.0, twosided=True)


def _lobe_base(tx_pos=(0.3, 0.0, 0.0), rx_pos=(-0.3, 0.0, 0.0)):
    """The lobe tests' sonar: the band, the pulse on a Wigner transmitter of
    half-width 0.05 m at `tx_pos` facing -y, and an omni receiver at
    `rx_pos` on the 64-bin ADC.  Returns (scene, receiver spec)."""
    s = sc.Scene(band=Band.from_freq(C_SOUND, LOBES['fc'], 10e3))
    wf = pulse(f_centre=LOBES['fc'], prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, tx_pos, (tx_pos[0], tx_pos[1] - 1.0, tx_pos[2]),
              (0.05, 0.05, 1.0), transmitter='tx')
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = omni_receiver('rx', adc, position=rx_pos, receive_type='raw')
    s.add(rx)
    return s, rx


def window_corner_scene(window: str | None = None):
    """The radome (`test_megakernel_dielectric_window`): golden config 4's
    corner geometry with a pulse, a trihedral of smooth conductors (eta
    0.2, k 3) with its apex 4 m out, pointed at a 20 mm Wigner receiver
    0.1 m in front of a 1.6 m transmitter, and `window` None, 'thin' (a
    thin dielectric, n = 1.5) or 'dielectric' (a smooth one, transmittance
    1) on a 4 m square 2 m out, between them and the corner.  Its echo is
    a delta chain: through the window, three mirror bounces, back through
    the window and a direct transmitter hit; run it at depth
    LOBES['corner_depth'].  Returns (scene, receiver spec)."""
    s = sc.Scene(band=Band.from_freq(C_SOUND, LOBES['fc'], 10e3))
    s.add(conductor('m', eta=0.2, k=3.0, twosided=True))
    wf = pulse(f_centre=LOBES['fc'], prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    _aperture(s, (0.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.8, 0.8, 1.0),
              transmitter='tx')
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    rx_pos = np.array([0.0, -0.1, 0.0])
    apex = np.array([0.0, -LOBES['R'], 0.0])
    _aperture(s, rx_pos, apex, (0.02, 0.02, 1.0), receiver='rx')
    for f in sh.trihedral(apex, rx_pos - apex, bsdf='m'):
        s.add(f)
    if window is not None:
        if window == 'thin':
            s.add(thin_dielectric('win', int_ior=LOBES['ior']))
        elif window == 'dielectric':
            s.add(dielectric('win', int_ior=LOBES['ior'],
                             specular_transmittance=1.0))
        else:
            raise ValueError(f'window {window!r}')
        m = np.asarray(tf.compose(tf.look_at([0.0, -LOBES['window_at'], 0],
                                             [0.0, 0.0, 0.0]),
                                  tf.scale(LOBES['window'])))
        s.add(sh.rectangle(to_world=m, bsdf='win'))
    return s, rx


def thin_window_transmittance() -> float:
    """The closed form of the thin window's round trip at normal
    incidence: with n = LOBES['ior'], R = ((n - 1) / (n + 1))^2, the
    internal series R' = 2R / (1 + R), T = 1 - R', and the echo crosses
    it twice: T^2 (0.852 at n = 1.5)."""
    n = LOBES['ior']
    r = ((n - 1.0) / (n + 1.0)) ** 2
    return (1.0 - 2.0 * r / (1.0 + r)) ** 2


def plastic_scene(kind: str = 'plastic'):
    """`test_megakernel_plastic`: a 1 m `kind` ('plastic' or
    'rough_plastic') plate 4 m out before the lobe tests' sonar (omni
    receiver 0.6 m from the transmitter).  Returns (scene, receiver
    spec)."""
    if kind not in ('plastic', 'rough_plastic'):
        raise ValueError(f'kind {kind!r}')
    s, rx = _lobe_base()
    s.add(_lobe_material('mat', kind))
    _plate(s, (0.0, -LOBES['R'], 0.0), 0.5)
    return s, rx


def rough_dielectric_scene(case: str = 'target'):
    """`test_megakernel_rough_dielectric`: GGX glass (alpha 0.4, n = 1.5).
    'target': a 1 m plate 4 m out in backscatter; 'through': a 2 m sheet
    2 m out between the transmitter (at the origin) and the omni receiver
    4 m out on its far side, whose only echo is the transmission lobe's,
    at the one-way delay.  Returns (scene, receiver spec)."""
    if case == 'target':
        s, rx = _lobe_base()
        size, at = 0.5, LOBES['R']
    elif case == 'through':
        s, rx = _lobe_base(tx_pos=(0.0, 0.0, 0.0),
                           rx_pos=(0.0, -LOBES['R'], 0.0))
        size, at = 1.0, 0.5 * LOBES['R']
    else:
        raise ValueError(f'case {case!r}')
    s.add(rough_dielectric('mat', alpha=0.4, int_ior=LOBES['ior']))
    _plate(s, (0.0, -at, 0.0), size)
    return s, rx


def composite_scene(kind: str = 'blend', opacity: float = 0.8):
    """`test_megakernel_blend_mask`: a 1 m plate 4 m out of a blend of the
    diffuse 'd0' (weight 0.6) and a GGX rough conductor 'm1' (alpha 0.3),
    or ('mask') 'd0' under a mask of `opacity`.  Returns (scene, receiver
    spec)."""
    s, rx = _lobe_base()
    s.add(diffuse('d0', reflectance=1.0, twosided=True))
    if kind == 'blend':
        s.add(rough_conductor('m1', alpha=0.3, eta=0.2, k=3.0,
                              twosided=True),
              blend('mat', 'd0', 'm1', weight=LOBES['blend_weight']))
    elif kind == 'mask':
        s.add(mask('mat', 'd0', opacity=opacity))
    else:
        raise ValueError(f'kind {kind!r}')
    _plate(s, (0.0, -LOBES['R'], 0.0), 0.5)
    return s, rx


def lobe_bin(scene, rx, case: str = 'target') -> float:
    """The fast-time bin a lobe scene's echo must peak at: the round trip
    to the plate 4 m out, or ('through') the one-way transmitter ->
    receiver delay across the sheet."""
    if case != 'through':
        return round_trip_bin(scene, rx, (0.0, -LOBES['R'], 0.0))
    a = rx.adc
    return ((LOBES['R'] / scene.band.c - a.sampling_start)
            / a.sampling_time * a.n_time - 0.5)
