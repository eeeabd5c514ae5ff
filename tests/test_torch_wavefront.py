"""The port's eager receive wavefront against the JAX package's.

`radar_receive_trace` runs on identical uniforms: a replay stream hands
both packages the same numpy table (`next_1d` / `next_2d` consume it by
dimension, in the JAX package's order), and both trace the same scene
tables (the JAX `SceneData` carried over with `interop`).  The grids must
agree within 1e-4 x max|acc| per cell and channel: the same float32
arithmetic, summed in another order.  `receive()` itself draws Philox in
the port and threefry in JAX, so it is held statistically (peak bins and
peak-window energy, the bound of tests/test_pallas_receive.py:30-35).
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.integrators import radar_path as rp_j
from beifong_tpu.radar import endpoints as ep_j

import beifong_tpu_torch as bt
from beifong_tpu_torch.integrators import radar_path as rp_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar import endpoints as ep_t
from beifong_tpu_torch.radar.waveform import Waveform as WaveformT

from test_torch_mesh import jax_leaves, port_band

# the packages export their `receive` functions under the module's name
receive_j = importlib.import_module('beifong_tpu.receive')
receive_t = importlib.import_module('beifong_tpu_torch.receive')

torch.set_num_threads(1)

N_LANES = 4096
TOL = 1e-4


def _pkg(pkg: str):
    """The scene-building modules of one package."""
    if pkg == 'jax':
        from beifong_tpu import scene as sc, bsdf
        from beifong_tpu.core import transform as tf
        from beifong_tpu.core.config import Band
        from beifong_tpu.geometry import shapes as sh
        from beifong_tpu.geometry.mesh import MeshSpec, make_grid
        from beifong_tpu import radar
    else:
        from beifong_tpu_torch import scene as sc
        from beifong_tpu_torch.bsdf import tables as bsdf
        from beifong_tpu_torch.core import transform as tf
        from beifong_tpu_torch.core.config import Band
        from beifong_tpu_torch.geometry import shapes as sh
        from beifong_tpu_torch.geometry.mesh import MeshSpec, make_grid
        from beifong_tpu_torch import radar
    return types.SimpleNamespace(sc=sc, bsdf=bsdf, tf=tf, Band=Band, sh=sh,
                                 MeshSpec=MeshSpec, make_grid=make_grid,
                                 radar=radar)


def multi_body(pkg: str):
    """`examples/multi_body.py`'s scene, built as the example builds it;
    the port's copy is `scenes.multi_body_scene`."""
    if pkg == 'port':
        return bt.multi_body_scene()
    p = _pkg(pkg)
    fc, c = 40e3, 340.0
    s = p.sc.Scene(band=p.Band.from_freq(c, fc, 10e3))
    s.add(p.bsdf.diffuse('hull', reflectance=1.0, twosided=True))
    s.add(p.bsdf.rough_conductor('metal', specular_reflectance=1.0,
                                 alpha=0.3, eta=1.5, k=3.0, twosided=True))
    wf = p.radar.pulse(f_centre=fc, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
    s.add(p.radar.wigner_transmitter('tx', wf, resample_freq=True))
    aim = np.asarray(p.tf.compose(p.tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                  p.tf.scale([0.0125, 0.0125, 1.0])))
    s.add(p.sh.rectangle(to_world=aim, transmitter='tx'))
    adc = p.radar.ADCConfig(n_time=16, n_freq=32, sampling_start=0.0,
                            sampling_time=0.06, freq_lo=fc - 1e3,
                            freq_hi=fc + 3e3)
    rx = p.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(p.tf.compose(
        p.tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
        p.tf.scale([0.0125, 0.0125, 1.0])))
    s.add(p.sh.rectangle(to_world=aim_rx, receiver='rx'))
    v, f = p.make_grid(9, 9)
    v = np.asarray(v, np.float32)
    v[:, 2] = 0.05 * np.sin(4 * v[:, 0]) * np.cos(3 * v[:, 1])
    m1 = np.asarray(p.tf.compose(p.tf.look_at([0, -3.0, 0], [0, 0, 0]),
                                 p.tf.scale(0.6)))
    s.add(p.MeshSpec(v, np.asarray(f), bsdf='hull', to_world=m1))
    m2 = np.asarray(p.tf.compose(p.tf.look_at([0.0, -5.5, 1.5], [0, 0, 0]),
                                 p.tf.scale(0.6)))
    mover = p.MeshSpec(v, np.asarray(f), bsdf='metal', to_world=m2)
    mover.velocity = np.asarray([0.0, 3.0, 0.0], np.float32)
    s.add(mover)
    return s, rx


def analytic_zoo(pkg: str):
    """Every analytic shape kind under every BSDF family: a dielectric
    sphere, a mirror rectangle, a blend disk, a rough-glass cylinder, a
    masked plastic plate and a rough-plastic ground, moving ones among
    them, seen by a pulsed 40 kHz sonar."""
    p = _pkg(pkg)
    b = p.bsdf
    s = p.sc.Scene(band=p.Band.from_freq(340.0, 40e3, 10e3))
    s.add(b.diffuse('mat', reflectance=0.8, twosided=True),
          b.rough_conductor('rough', alpha=0.2, eta=0.3, k=2.5),
          b.conductor('mirror', eta=0.2, k=3.0, twosided=True),
          b.dielectric('glass', int_ior=1.45),
          b.rough_dielectric('frost', alpha=0.3, int_ior=1.3),
          b.plastic('shell', diffuse_reflectance=0.6, twosided=True),
          b.rough_plastic('coat', diffuse_reflectance=0.4, alpha=0.25),
          b.thin_dielectric('film'),
          b.blend('mix', 'mat', 'rough', weight=0.3),
          b.mask('holes', 'shell', opacity=0.7))
    wf = p.radar.pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
    s.add(p.radar.wigner_transmitter('tx', wf, resample_freq=True))
    tf = p.tf
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(p.sh.rectangle(to_world=aim, transmitter='tx'))
    adc = p.radar.ADCConfig(n_time=32, n_freq=4, sampling_start=0.0,
                            sampling_time=0.06, freq_lo=39e3, freq_hi=41e3)
    rx = p.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                                   tf.scale([0.05, 0.05, 1.0])))
    s.add(p.sh.rectangle(to_world=aim_rx, receiver='rx'))
    s.add(p.sh.sphere(center=[0.0, -2.5, 0.0], radius=0.4, bsdf='glass'))
    mirror = p.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.9, -3.5, 0.2], [0, 0, 0]), tf.scale(0.4))),
        bsdf='mirror')
    mirror.velocity = np.asarray([0.0, 1.5, 0.0], np.float32)
    s.add(mirror)
    s.add(p.sh.disk(to_world=np.asarray(tf.compose(
        tf.look_at([-0.9, -3.0, 0.3], [0, 0, 0]), tf.scale(0.5))),
        bsdf='mix'))
    s.add(p.sh.cylinder(to_world=np.asarray(tf.compose(
        tf.translate([0.5, -4.5, -1.0]), tf.scale([0.3, 0.3, 2.0]))),
        bsdf='frost'))
    s.add(p.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([-0.4, -5.0, -0.2], [0, 0, 0]), tf.scale(0.6))),
        bsdf='holes'))
    s.add(p.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.2, -6.0, 0.8], [0, 0, 0]), tf.scale(0.4))),
        bsdf='film'))
    s.add(p.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.translate([0, 0, -0.6]), tf.scale(20.0))), bsdf='coat'))
    return s, rx


def fmcw_sonar(pkg: str):
    """`examples/fmcw_sonar.py`'s scene: a 40 kHz LFMCW sonar (2 kHz over
    90 ms) with a mix_resample receiver dechirping against the
    transmitted chirp, a plate 6 m out."""
    p = _pkg(pkg)
    tf = p.tf
    fc, bw, chirp, c, r = 40e3, 2e3, 90e-3, 340.0, 6.0
    f_beat = bw / chirp * 2 * r / c
    s = p.sc.Scene(band=p.Band.from_freq(c, fc, 2 * bw))
    s.add(p.bsdf.diffuse('mat', reflectance=1.0, twosided=True))
    wf = p.radar.linfmcw(f_centre=fc, crf=1.0 / chirp, chirp_len=chirp,
                         freq_sweep=bw, is_delta=True)
    s.add(p.radar.wigner_transmitter('tx', wf, resample_freq=True))
    aim = np.asarray(tf.compose(tf.look_at([0.1, 0, 0], [0.1, -1, 0]),
                                tf.scale([0.01, 0.025, 1.0])))
    s.add(p.sh.rectangle(to_world=aim, transmitter='tx'))
    adc = p.radar.ADCConfig(n_time=16, n_freq=256, sampling_start=0.02,
                            sampling_time=0.06, freq_lo=0.0,
                            freq_hi=4 * f_beat)
    rx = p.radar.wigner_receiver('rx', adc, receive_type='mix_resample',
                                 lo_waveform=wf)
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.1, 0, 0], [-0.1, -1, 0]),
                                   tf.scale([0.01, 0.025, 1.0])))
    s.add(p.sh.rectangle(to_world=aim_rx, receiver='rx'))
    tgt = np.asarray(tf.compose(tf.look_at([0, -r, 0], [0, 0, 0]),
                                tf.scale(0.5)))
    s.add(p.sh.rectangle(to_world=tgt, bsdf='mat'))
    return s, rx


def flagship(pkg: str):
    """The flagship scene (`__graft_entry__._build_scene`, the port's
    `scenes.flagship_scene`)."""
    if pkg == 'port':
        return bt.flagship_scene()
    import __graft_entry__ as ge
    return ge._build_scene()


def flagship_textured(texture: str):
    """The flagship scene with a checkerboard or bitmap ground
    (`scenes.flagship_scene(ground_texture=...)`)."""
    def build(pkg: str):
        # imported here: that module imports this one
        from test_torch_receive_kernel_textures import textured_flagship
        return textured_flagship(pkg, texture)
    return build


def multi_body_attr(pkg: str):
    """multi_body with a mesh-attribute texture on the stationary body:
    one seeded reflectance a face of the scene's 324 (the hit triangle's
    row)."""
    s, rx = multi_body(pkg)
    tex = importlib.import_module(
        'beifong_tpu.textures' if pkg == 'jax'
        else 'beifong_tpu_torch.textures')
    s.add(tex.mesh_attribute('attr', np.random.default_rng(6).uniform(
        0.1, 1.0, 324).astype(np.float32)))
    next(b for b in s.bsdfs if b.id == 'hull').texture = 'attr'
    return s, rx


SCENES = {'multi_body': multi_body, 'analytic_zoo': analytic_zoo,
          'fmcw_sonar': fmcw_sonar, 'flagship': flagship,
          'flagship_checker': flagship_textured('checkerboard'),
          'flagship_bitmap': flagship_textured('bitmap'),
          'multi_body_attr': multi_body_attr}


# ---------------------------------------------------------------------------
# replay streams: both packages draw the same numpy table
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class JaxReplay:
    table: jax.Array
    dim: int = dataclasses.field(metadata=dict(static=True), default=0)

    def next_1d(self):
        return self.table[self.dim], JaxReplay(self.table, self.dim + 1)

    def next_2d(self):
        u = jnp.stack([self.table[self.dim], self.table[self.dim + 1]], -1)
        return u, JaxReplay(self.table, self.dim + 2)


@dataclasses.dataclass
class PortReplay:
    table: torch.Tensor
    dim: int = 0

    def next_1d(self):
        return self.table[self.dim], PortReplay(self.table, self.dim + 1)

    def next_2d(self):
        u = torch.stack([self.table[self.dim], self.table[self.dim + 1]], -1)
        return u, PortReplay(self.table, self.dim + 2)


def jax_pass(s_j, sd_j, rx, stream, max_depth, coherent, time_sampling):
    """The JAX package's `_receive_pass` with `stream` in place of its
    threefry stream (its body, unjitted)."""
    cfg = rx.adc
    n = stream.table.shape[1]
    if time_sampling == 'gate':
        t_rx = jnp.zeros((n,), jnp.float32)
        t_for_freq = jnp.full((n,), cfg.sampling_start
                              + 0.5 * cfg.sampling_time, jnp.float32)
    else:
        u_t, stream = stream.next_1d()
        t_rx = cfg.sampling_start + u_t * cfg.sampling_time
        t_for_freq = t_rx
    u_f, stream = stream.next_1d()
    f_rx, f_w = ep_j.rx_sample_frequency(rx.receive_type, rx.lo_waveform,
                                         sd_j.band, t_for_freq, u_f, cfg)
    u_pos, stream = stream.next_2d()
    u_dir, stream = stream.next_2d()
    wl = sd_j.band.c / jnp.maximum(f_rx, 1e-6)
    si = s_j.shape_index_of_endpoint('receiver', rx.id)
    o, d, w = ep_j.rx_sample_ray(sd_j, rx, si, t_rx, u_pos, u_dir,
                                 wavelength=wl)
    w = w * ep_j.rx_aperture_weight(sd_j, rx, si, o, d, wl)
    n_ch = 2 if coherent else 1
    adc = jnp.zeros((cfg.n_time, cfg.n_freq, n_ch + 2), jnp.float32)
    adc, _ = rp_j.radar_receive_trace(
        sd_j, stream, o, d, t_rx, f_rx, w * f_w, adc, cfg, rx.receive_type,
        rx.lo_waveform, jnp.asarray(rx.velocity), max_depth=max_depth,
        coherent=coherent, time_sampling=time_sampling)
    return np.asarray(adc)


def port_waveform(wf_j):
    return WaveformT(**{f.name: torch.tensor(np.asarray(getattr(wf_j,
                                                                f.name)))
                        for f in dataclasses.fields(WaveformT)})


def port_pass(s_j, sd_j, rx_t, table, max_depth, coherent, time_sampling):
    """The port's `_receive_pass` on the JAX scene's tables."""
    sd = receive_t.scene_mono(scene_data_from_numpy(
        jax_leaves(sd_j), port_band(sd_j.band), device='cpu'))
    cfg = rx_t.adc
    adc = torch.zeros((cfg.n_time, cfg.n_freq, (2 if coherent else 1) + 2))
    lo = None if rx_t.lo_waveform is None else rx_t.lo_waveform
    si = s_j.shape_index_of_endpoint('receiver', rx_t.id)
    receive_t._receive_pass(sd, rx_t, si, lo, PortReplay(
        torch.from_numpy(table)), adc, table.shape[1], max_depth, coherent,
        time_sampling)
    return adc.numpy()


CASES = [
    ('multi_body', 1, False, 'gate'),
    ('multi_body', 2, False, 'gate'),
    ('multi_body', 2, True, 'gate'),
    ('analytic_zoo', 2, False, 'fixed'),
    ('analytic_zoo', 2, True, 'gate'),
    ('fmcw_sonar', 2, False, 'fixed'),
    ('fmcw_sonar', 2, True, 'fixed'),
    ('flagship', 2, False, 'gate'),
    ('flagship_checker', 2, False, 'gate'),
    ('flagship_bitmap', 2, True, 'gate'),
    ('multi_body_attr', 2, False, 'gate'),
]


def _phase_slack(s_j, rx) -> float:
    """Phase error [rad] allowed per connection in coherent mode: 4 ulps
    of the longest path that lands in the ADC window, over the shortest
    wavelength.  The two packages' path lengths differ in their last bits
    (XLA fuses and contracts the hit arithmetic: even the JAX package's
    own `triangle_ts` and `closest_hit` give different t on a third of
    the rays), and phase is 2 pi L / lambda."""
    cfg = rx.adc
    l_max = s_j.band.c * (cfg.sampling_start + cfg.sampling_time)
    return 2 * np.pi * 4 * float(np.spacing(np.float32(l_max))) \
        / s_j.band.wavelength_min


@pytest.mark.parametrize('name, depth, coherent, ts', CASES,
                         ids=[f'{c[0]}-d{c[1]}-{"iq" if c[2] else "pow"}-'
                              f'{c[3]}' for c in CASES])
def test_trace_matches_jax_on_identical_uniforms(name, depth, coherent, ts,
                                                 monkeypatch):
    """Power: every cell within 1e-4 x max|acc|.  Coherent I / Q: within
    1e-4 x max|acc| plus the phase slack times the cell's sum of
    amplitudes (the JAX trace with its phase set to 0 gives that sum in
    its I channel); `_echo_phase` itself is held exactly below."""
    s_j, rx_j = SCENES[name]('jax')
    _, rx_t = SCENES[name]('port')
    sd_j = receive_j.scene_mono(s_j.compile(use_bvh=False))
    table = np.random.default_rng(depth + 10 * coherent).random(
        (40, N_LANES), dtype=np.float32)
    got = port_pass(s_j, sd_j, rx_t, table, depth, coherent, ts)
    ref = jax_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)), depth,
                   coherent, ts)
    assert got.shape == ref.shape
    n_val = got.shape[-1] - 2
    scale = np.abs(ref[..., :n_val]).max()
    assert scale > 0 and np.isfinite(got).all()
    bound = TOL * scale
    if coherent:
        monkeypatch.setattr(rp_j, '_echo_phase',
                            lambda *a, **k: jnp.zeros_like(a[5]))
        amp = jax_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)),
                       depth, coherent, ts)[..., :1]
        bound = bound + _phase_slack(s_j, rx_j) * amp
    err = np.abs(got[..., :n_val] - ref[..., :n_val])
    assert (err <= bound).all(), (err.max(), scale)
    # weight and count channels: tent weights and connection counts
    for ch in (n_val, n_val + 1):
        ch_scale = np.abs(ref[..., ch]).max()
        assert ch_scale > 0
        assert np.abs(got[..., ch] - ref[..., ch]).max() <= TOL * ch_scale


@pytest.mark.parametrize('lo', [False, True], ids=['tx', 'tx-lo'])
def test_echo_phase_matches_jax(lo):
    """The coherent phase of a connection from identical path lengths,
    emission and receive times: double-single arithmetic on both sides,
    so equal to float32 rounding of the final cycle count."""
    s_j, _ = fmcw_sonar('jax')
    sd_j = s_j.compile()
    sd_t = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    g = np.random.default_rng(3)
    n = 4096
    hi = g.uniform(1.0, 20.0, n).astype(np.float32)
    lo_w = (g.uniform(-0.5, 0.5, n) * np.spacing(hi)).astype(np.float32)
    extra = g.uniform(0.5, 8.0, n).astype(np.float32)
    t_emit = g.uniform(0.0, 0.2, n).astype(np.float32)
    t_recv = (t_emit + (hi + extra) / 340.0).astype(np.float32)
    k_pri = g.integers(0, 3, n).astype(np.float32)
    rows = np.zeros(n, np.int32)
    lo_j = s_j.receivers[0].lo_waveform if lo else None
    ref = np.asarray(rp_j._echo_phase(
        sd_j, jnp.asarray(rows), lo_j, (jnp.asarray(hi), jnp.asarray(lo_w)),
        jnp.asarray(extra), jnp.asarray(t_emit), jnp.asarray(k_pri),
        jnp.asarray(t_recv), 2, np.pi))
    got = rp_t._echo_phase(
        sd_t, torch.from_numpy(rows).long(),
        port_waveform(lo_j) if lo else None,
        (torch.from_numpy(hi), torch.from_numpy(lo_w)),
        torch.from_numpy(extra), torch.from_numpy(t_emit),
        torch.from_numpy(k_pri), torch.from_numpy(t_recv), 2,
        np.pi).numpy()
    d = np.abs(got - ref)
    d = np.minimum(d, 2 * np.pi - d)     # the same angle across 0 / 2 pi
    assert d.max() <= 1e-5


# ---------------------------------------------------------------------------
# the endpoints' sampling and evaluation on fixed uniforms
# ---------------------------------------------------------------------------


def _close(got, ref, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize('name', ['multi_body', 'analytic_zoo', 'fmcw_sonar'])
def test_endpoint_ops_match_jax(name):
    s_j, rx_j = SCENES[name]('jax')
    _, rx_t = SCENES[name]('port')
    sd_j = s_j.compile(use_bvh=False)
    sd_t = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    g = np.random.default_rng(8)
    n = N_LANES
    u1, u2 = g.random(n, dtype=np.float32), g.random((n, 2), dtype=np.float32)
    u3 = g.random((n, 2), dtype=np.float32)
    ref_p = g.normal(0, 1.0, (n, 3)).astype(np.float32) + [0, -3, 0]
    ref_p = ref_p.astype(np.float32)
    t = g.uniform(0.0, 0.1, n).astype(np.float32)
    f = g.uniform(38e3, 42e3, n).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy

    ds_j, e_j, c_j = ep_j.tx_sample_geom(sd_j, J(ref_p), J(u1), J(u2))
    ds_t, e_t, c_t = ep_t.tx_sample_geom(sd_t, T(ref_p), T(u1), T(u2))
    for fld in ('p', 'n', 'd', 'dist', 'pdf'):
        _close(getattr(ds_t, fld), getattr(ds_j, fld), fld)
    _close(c_t, c_j, 'cos_tx')
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    for over in (None, t):
        out_j = ep_j.tx_sample_direction(
            sd_j, J(ref_p), J(t), J(f), J(u1), J(u2),
            t_emit_override=None if over is None else J(over + 1e-3))
        out_t = ep_t.tx_sample_direction(
            sd_t, T(ref_p), T(t), T(f), T(u1), T(u2),
            t_emit_override=None if over is None else T(over + 1e-3))
        for what, a, b in zip(('weight', 'f_emit', 't_emit', 'row'),
                              out_t[1:], out_j[1:]):
            _close(a, b, what, rtol=1e-4 if what == 'weight' else 1e-5,
                   atol=1e-6 * float(np.abs(np.asarray(b)).max() or 1.0))
    pdf_j = ep_j.tx_pdf_direction(sd_j, e_j, ds_j.dist, c_j)
    _close(ep_t.tx_pdf_direction(sd_t, e_t.int(), ds_t.dist, c_t), pdf_j,
           'pdf_direction')
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    for wl in (None, 340.0 / f):
        o_j, d_j, w_j = ep_j.rx_sample_ray(
            sd_j, rx_j, si, J(t), J(u2), J(u3),
            wavelength=None if wl is None else J(wl))
        o_t, d_t, w_t = ep_t.rx_sample_ray(
            sd_t, rx_t, si, T(t), T(u2), T(u3),
            wavelength=None if wl is None else T(wl))
        _close(o_t, o_j, 'o')
        _close(d_t, d_j, 'd', atol=1e-5)
        _close(w_t, w_j, 'ray weight', rtol=1e-4)
    ap_j = ep_j.rx_aperture_weight(sd_j, rx_j, si, o_j, d_j, J(340.0 / f))
    ap_t = ep_t.rx_aperture_weight(sd_t, rx_t, si, o_t, d_t, T(340.0 / f))
    _close(ap_t, ap_j, 'aperture', rtol=1e-4, atol=1e-5)
    w_j, fe_j = ep_j.tx_eval(sd_j, e_j, ds_j.p, -ds_j.d, c_j, J(t), J(f),
                             340.0 / J(f))
    w_t, fe_t = ep_t.tx_eval(sd_t, e_t, ds_t.p, -ds_t.d, c_t, T(t), T(f),
                             340.0 / T(f))
    _close(w_t, w_j, 'tx_eval', rtol=1e-4,
           atol=1e-6 * float(np.abs(np.asarray(w_j)).max()))
    _close(fe_t, fe_j, 'f_emit')


@pytest.mark.parametrize('rtype', ['raw', 'raw_resample', 'mix_resample',
                                   'mixer'])
def test_rx_sample_frequency_and_waveforms_match_jax(rtype):
    s_j, rx_j = fmcw_sonar('jax')
    _, rx_t = fmcw_sonar('port')
    g = np.random.default_rng(2)
    t = g.uniform(0.0, 0.3, N_LANES).astype(np.float32)
    u = g.random(N_LANES, dtype=np.float32)
    lo_j, lo_t = rx_j.lo_waveform, rx_t.lo_waveform
    a = ep_j.rx_sample_frequency(rtype, lo_j, s_j.band, jnp.asarray(t),
                                 jnp.asarray(u), rx_j.adc)
    b = ep_t.rx_sample_frequency(rtype, lo_t, s_j.band, torch.from_numpy(t),
                                 torch.from_numpy(u), rx_t.adc)
    for x, y in zip(b, a):
        _close(x, y, rtype)
    for wf_j, wf_t in ((lo_j, lo_t), (multi_body('jax')[0].transmitters[0]
                                      .waveform, multi_body('port')[0]
                                      .transmitters[0].waveform)):
        _close(wf_t.phase(torch.from_numpy(t)), wf_j.phase(jnp.asarray(t)),
               'phase', rtol=1e-4, atol=1e-2)
        for x, y in zip(wf_t.sample_frequency(torch.from_numpy(t),
                                              torch.from_numpy(u)),
                        wf_j.sample_frequency(jnp.asarray(t),
                                              jnp.asarray(u))):
            _close(x, y, 'sample_frequency', atol=1e-8)


# ---------------------------------------------------------------------------
# receive(): statistics over seeds, and the routing
# ---------------------------------------------------------------------------

SEEDS = 4


def test_receive_matches_jax_wavefront_over_seeds():
    """The multi_body scene: peak bins within one and peak-window energy
    within the bound of tests/test_pallas_receive.py:30-35, averaged over
    seeds (the port draws Philox, the JAX package threefry), on the
    fast-time profile summed over the Doppler axis; and each body's
    Doppler peak within one bin."""
    s_j, rx_j = multi_body('jax')
    s_t, rx_t = multi_body('port')
    sd_j = s_j.compile(use_bvh=False)
    sd_t = s_t.compile(use_bvh=False, device='cpu')
    kw = dict(spp=N_LANES, max_depth=2, time_sampling='gate')
    tp = tj = 0.0
    for seed in range(SEEDS):
        a, n = bt.receive(s_t, sd_t, rx_t, seed=seed, use_kernel=False,
                          device='cpu', **kw)
        assert n == N_LANES and tuple(a.shape) == (
            rx_t.adc.n_time, rx_t.adc.n_freq, 3)
        tp = tp + bt.develop_signal(a, n, rx_t.adc)[..., 0].numpy() / SEEDS
        a, n = receive_j.receive(s_j, sd_j, rx_j, seed=100 + seed,
                                 use_pallas=False, **kw)
        tj = tj + np.asarray(receive_j.develop_signal(a, n, rx_j.adc))[
            ..., 0] / SEEDS
    assert np.isfinite(tp).all() and tp.sum() > 0
    pt, pj = tp.sum(1), tj.sum(1)
    assert abs(int(pt.argmax()) - int(pj.argmax())) <= 1
    pk = int(pj.argmax())
    lo, hi = max(pk - 3, 0), pk + 4
    assert pt[lo:hi].sum() == pytest.approx(pj[lo:hi].sum(), rel=0.6)
    for gate in (slice(3, 7), slice(7, 11)):    # body 1, body 2
        assert abs(int(tp[gate].sum(0).argmax())
                   - int(tj[gate].sum(0).argmax())) <= 1


def _count_routes(monkeypatch):
    calls = {'kernel': 0, 'wavefront': 0}
    k, w = rk.receive_kernel, receive_t._receive_pass

    def kern(*a, **kw):
        calls['kernel'] += 1
        return k(*a, **kw)

    def wave(*a, **kw):
        calls['wavefront'] += 1
        return w(*a, **kw)

    monkeypatch.setattr(rk, 'receive_kernel', kern)
    monkeypatch.setattr(receive_t, '_receive_pass', wave)
    return calls


@pytest.mark.parametrize('scene, use, route', [
    ('flagship', 'auto', 'kernel'), ('mesh', 'auto', 'kernel'),
    ('multi_body', 'auto', 'kernel'), ('multi_body', False, 'wavefront'),
    ('flagship', False, 'wavefront')])
def test_receive_routes_scenes(monkeypatch, scene, use, route):
    calls = _count_routes(monkeypatch)
    s, rx = {'flagship': bt.flagship_scene,
             'mesh': lambda: bt.mesh_scene(n_side=3),
             'multi_body': bt.multi_body_scene}[scene]()
    a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1024,
                      max_depth=1, time_sampling='gate', use_kernel=use,
                      device='cpu')
    assert calls == {'kernel': int(route == 'kernel'),
                     'wavefront': int(route == 'wavefront')}
    assert bool(torch.isfinite(a).all())


def test_receive_kernel_route_is_unchanged():
    """'auto' on the flagship is the kernel's plain version, bit for bit,
    as before the wavefront existed."""
    s, rx = bt.flagship_scene()
    sd = s.compile(device='cpu')
    kw = dict(seed=3, spp=2048, max_depth=2, time_sampling='gate',
              device='cpu')
    a, n = bt.receive(s, sd, rx, **kw)
    b, m = bt.receive(s, sd, rx, use_kernel=True, **kw)
    out, n_k = rk.receive_kernel(s, sd, rx, spp=2048, seed=3, max_depth=2,
                                 time_sampling='gate', device='cpu')
    assert n == m == n_k and torch.equal(a, b)
    assert torch.equal(a[..., 0], out) and not a[..., 1:].any()


@pytest.mark.parametrize('kw, needle', [
    (dict(polarized=True), 'ROADMAP A10'),
    # coherent calls are in the kernel's scope: the sphere rejects this one
    pytest.param(dict(coherent=True, use_kernel=True), 'ROADMAP B1',
                 id='kw1-ROADMAP B3'),
    pytest.param(dict(use_kernel=True), 'ROADMAP B1', id='kw2-ROADMAP B5'),
    (dict(sampler='stratified'), 'ROADMAP A2'),
])
def test_out_of_scope_receive_raises(kw, needle):
    """The multi_body scene with a sphere, which the receive kernel does
    not take (ROADMAP B1) and the wavefront does."""
    from beifong_tpu_torch.geometry import shapes as sh
    s, rx = bt.multi_body_scene()
    s.add(sh.sphere(center=(2.0, -6.0, 0.0), radius=0.3, bsdf='hull'))
    with pytest.raises(NotImplementedError, match=needle):
        bt.receive(s, s.compile(device='cpu'), rx, spp=256, max_depth=1,
                   device='cpu', **kw)


def test_media_carried_across():
    """A JAX scene's medium reaches the wavefront: `SceneData.medium` is
    the port's medium of the same kind and values, which the trace
    applies (tests/test_torch_media.py holds the trace against JAX)."""
    from beifong_tpu.media import HomogeneousMedium, LayeredMedium
    from beifong_tpu_torch import media as mt
    s_j, _ = multi_body('jax')
    for med_j, cls in ((HomogeneousMedium.make(sigma_t=0.01),
                        mt.HomogeneousMedium),
                       (LayeredMedium.make([0.0, 0.2, 0.1], -1.0, 2.0),
                        mt.LayeredMedium)):
        s_j.medium = med_j
        sd_j = s_j.compile(use_bvh=False)
        sd = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                   device='cpu')
        assert type(sd.medium) is cls and sd.medium.kind == cls.kind
        for f in ('sigma_t', 'sigma', 'z_min', 'z_max', 'albedo', 'g'):
            if hasattr(med_j, f):
                np.testing.assert_array_equal(
                    getattr(sd.medium, f).numpy(), np.asarray(getattr(med_j,
                                                                       f)))


def test_sample_stream_is_keyed_philox():
    """Dimension k of lane l in pass p under seed s is word k % 4 of
    Philox4x32-10(counter (l, p, k // 4, 0), key s): drawn in batches,
    consumed in order, one stream per (seed, pass)."""
    from beifong_tpu_torch.core import rng
    st = rng.make_stream('independent', 7, 300, 5)
    u, st2 = st.next_1d()
    v, st3 = st2.next_2d()
    assert st3.dim == 3
    lane = torch.arange(300)
    for k, got in ((0, u), (1, v[:, 0]), (2, v[:, 1])):
        w = rng.philox4x32_10(lane, torch.full_like(lane, 5),
                              torch.full_like(lane, k // 4),
                              torch.zeros_like(lane), 7, 0)[k % 4]
        assert torch.equal(got, rng.word_to_uniform(w))
    far = rng.make_stream('independent', 7, 300, 5).uniform(17)
    w = rng.philox4x32_10(lane, torch.full_like(lane, 5),
                          torch.full_like(lane, 4), torch.zeros_like(lane),
                          7, 0)[1]
    assert torch.equal(far, rng.word_to_uniform(w))
    other = rng.make_stream('independent', 7, 300, 6).uniform(0)
    assert not torch.equal(other, u) and 0.45 < float(u.mean()) < 0.55
