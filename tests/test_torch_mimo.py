"""MIMO receive and digital beamforming in the port against the JAX
package: the phased receive array's endpoint helpers, `dsp.beamform`,
the wavefront's per-element channels (`radar_receive_trace` with
`elem_offsets`) on identical uniforms (the replay stream of
tests/test_torch_wavefront.py), the receive kernel's MIMO configuration
(its plain version against `pr._run(interpret=True, mimo_e=E)` on
identical uniforms), the packed tables bit for bit, the scope and the
routing of `receive_mimo`, and golden config 6's anchors on the CPU.
The CUDA kernel is held against the plain version on a card by
tests/test_torch_gpu.py."""

import dataclasses as dc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.dsp import beamform as bf_j
from beifong_tpu.integrators import pallas_receive as pr
from beifong_tpu.integrators import radar_path as rp_j
from beifong_tpu.radar import endpoints as ep_j

import beifong_tpu_torch as bt
from beifong_tpu_torch import scenes
from beifong_tpu_torch.dsp import beamform as bf_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar import endpoints as ep_t

from test_torch_mesh import jax_leaves, port_band
from test_torch_wavefront import (JaxReplay, PortReplay, _pkg,
                                  port_waveform)

receive_j = importlib.import_module('beifong_tpu.receive')
receive_t = importlib.import_module('beifong_tpu_torch.receive')

torch.set_num_threads(1)

TOL = 1e-4      # x max|acc| per cell and channel, plus the phase slack
C = 340.0
GOLDEN = 'tests/golden/mimo_beamform.npz'


def config6(pkg: str, az_deg: float = 15.0, r: float = 4.0):
    """Golden config 6's scene (tests/golden/configs.py `mimo_beamform`,
    = tests/test_mimo.py `_mimo_scene`); the port's copy is
    `scenes.mimo_beamform_scene`."""
    if pkg == 'port':
        return bt.mimo_beamform_scene(az_deg, r)
    from test_mimo import _mimo_scene
    return _mimo_scene(az_deg, r)


def mixer_cube(pkg: str):
    """tests/test_mimo.py:104-131: config 6's array with a mixer receiver
    dechirping a matched 20 Hz/ms LFMCW on an 8-bin beat axis, the target
    3 m out at broadside (a scene outside the kernel's MIMO scope)."""
    k = _pkg(pkg)
    s, rx = config6(pkg, 0.0, 3.0)
    lo = k.radar.linfmcw(40e3, 10.0, 0.05, 1e3)
    rx2 = dc.replace(rx, receive_type='mixer', lo_waveform=lo,
                     adc=dc.replace(rx.adc, freq_lo=0.0, freq_hi=500.0,
                                    n_freq=8))
    s.receivers[0] = rx2
    s.transmitters[0] = dc.replace(s.transmitters[0], waveform=lo)
    return s, rx2


def odd_tilted(pkg: str):
    """An odd (E = 5) array, its axis and its rectangle tilted off the
    world axes, steered 20 degrees, attached to a 3 x 5 mm rectangle."""
    k = _pkg(pkg)
    s, _ = config6(pkg)
    rx = k.radar.phased_receiver(
        'rx5', s.receivers[0].adc, n_elems=5, elem_spacing=0.004,
        elem_wid=(0.002, 0.0015), steer_deg=20.0, elem_axis=(1.0, 0.3, 0.2))
    s.add(rx)
    s.add(k.sh.rectangle(to_world=np.asarray(k.tf.compose(
        k.tf.look_at([0.2, 0.1, -0.3], [1.0, -2.0, 0.5]),
        k.tf.scale([0.003, 0.005, 1.0]))), receiver='rx5'))
    return s, rx


ARRAYS = {'config6': config6, 'odd_tilted': odd_tilted}


def port_rx(rx_j):
    """The port's spec of a JAX receiver spec."""
    kw = {f.name: getattr(rx_j, f.name) for f in dc.fields(ep_t.ReceiverSpec)
          if f.init}
    kw['adc'] = ep_t.ADCConfig(**{f.name: getattr(rx_j.adc, f.name)
                                  for f in dc.fields(ep_t.ADCConfig)})
    if rx_j.lo_waveform is not None:
        kw['lo_waveform'] = port_waveform(rx_j.lo_waveform)
    return ep_t.ReceiverSpec(**kw)


def carried(s_j):
    """(JAX SceneData, the port's SceneData of the same tables)."""
    sd_j = s_j.compile(use_bvh=False)
    return sd_j, scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                       device='cpu')


# ---------------------------------------------------------------------------
# 1. the phased receive array's endpoint helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('array', list(ARRAYS))
def test_endpoint_helpers_match_jax(array):
    """_elem_locs, _phased_pairs, rx_array_frame, rx_elem_offsets and
    rx_elem_pattern_gain to 1e-6."""
    s_j, rx_j = ARRAYS[array]('jax')
    rx_t = port_rx(rx_j)
    sd_j, sd_t = carried(s_j)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    assert si >= 0
    np.testing.assert_allclose(ep_t._elem_locs(rx_t), ep_j._elem_locs(rx_j),
                               rtol=0, atol=1e-6)
    wl = sd_j.band.wavelength_centre
    for got, ref in zip(ep_t._phased_pairs(rx_t, wl),
                        ep_j._phased_pairs(rx_j, wl)):
        assert got.shape == np.asarray(ref).shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for got, ref in zip(ep_t.rx_array_frame(sd_t, rx_t, si),
                        ep_j.rx_array_frame(sd_j, rx_j, si)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    offs_t = ep_t.rx_elem_offsets(sd_t, rx_t, si)
    offs_j = np.asarray(ep_j.rx_elem_offsets(sd_j, rx_j, si))
    assert offs_t.shape == (rx_j.n_elems, 3)
    np.testing.assert_allclose(offs_t.numpy(), offs_j, rtol=0, atol=1e-6)
    g = np.random.default_rng(4)
    d = g.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lam = g.uniform(0.8, 1.2, 512).astype(np.float32) * np.float32(wl)
    _, sn_t, tn_t, _ = ep_t.rx_array_frame(sd_t, rx_t, si)
    _, sn_j, tn_j, _ = ep_j.rx_array_frame(sd_j, rx_j, si)
    got = ep_t.rx_elem_pattern_gain(rx_t, sn_t, tn_t, torch.from_numpy(d),
                                    torch.from_numpy(lam)).numpy()
    ref = np.asarray(ep_j.rx_elem_pattern_gain(rx_j, sn_j, tn_j,
                                               jnp.asarray(d),
                                               jnp.asarray(lam)))
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# 2. digital beamforming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('n_time, n_freq', [(64, 1), (16, 8)])
def test_beamform_matches_jax(n_time, n_freq):
    """All seven functions on a seeded complex cube (E = 8), to 1e-5 of
    each output's largest magnitude."""
    g = np.random.default_rng(n_time + n_freq)
    e = 8
    cube = (g.normal(size=(e, n_time, n_freq))
            + 1j * g.normal(size=(e, n_time, n_freq))).astype(np.complex64)
    offs = np.zeros((e, 3), np.float32)
    offs[:, 0] = (np.arange(e) - 3.5) * 0.00425
    offs[:, 2] = g.normal(size=e).astype(np.float32) * 1e-4
    az = np.radians(np.linspace(-40.0, 40.0, 81))
    taper = np.hanning(e + 2)[1:-1].astype(np.float32)

    def close(got, ref, what):
        ref = np.asarray(ref)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.shape == ref.shape, what
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=what)

    dirs_j = bf_j.ula_directions(az, 0.1, axis=(1, 0, 0), normal=(0, -1, 0))
    dirs_t = bf_t.ula_directions(az, 0.1, axis=(1, 0, 0), normal=(0, -1, 0))
    close(dirs_t, dirs_j, 'ula_directions')
    dirs = np.asarray(dirs_j)
    cj, ct = jnp.asarray(cube), torch.from_numpy(cube)
    close(bf_t.steering_matrix(offs, dirs, 40e3, C),
          bf_j.steering_matrix(offs, dirs, 40e3, C), 'steering_matrix')
    close(bf_t.delay_and_sum(ct, offs, dirs, 40e3, C),
          bf_j.delay_and_sum(cj, offs, dirs, 40e3, C), 'delay_and_sum')
    close(bf_t.delay_and_sum(ct, offs, dirs, 40e3, C, weights=taper),
          bf_j.delay_and_sum(cj, offs, dirs, 40e3, C, weights=taper),
          'delay_and_sum, tapered')
    r_j = bf_j.sample_covariance(cj)
    close(bf_t.sample_covariance(ct), r_j, 'sample_covariance')
    a_j = bf_j.steering_matrix(offs, dirs, 40e3, C)
    close(bf_t.mvdr_weights(torch.from_numpy(np.asarray(r_j)),
                            torch.from_numpy(np.asarray(a_j))),
          bf_j.mvdr_weights(r_j, a_j), 'mvdr_weights')
    close(bf_t.mvdr_spectrum(ct, offs, dirs, 40e3, C),
          bf_j.mvdr_spectrum(cj, offs, dirs, 40e3, C), 'mvdr_spectrum')
    close(bf_t.mvdr_beamform(ct, offs, dirs, 40e3, C),
          bf_j.mvdr_beamform(cj, offs, dirs, 40e3, C), 'mvdr_beamform')


# ---------------------------------------------------------------------------
# 3. the wavefront's MIMO channels on identical uniforms
# ---------------------------------------------------------------------------


def jax_mimo_pass(s_j, sd_j, rx, stream, max_depth, time_sampling,
                  elem_off):
    """The JAX package's `_receive_mimo_pass` with `stream` in place of its
    threefry stream (its body, unjitted); `elem_off` None traces the two
    coherent channels of the same rays instead."""
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
    _, stream = stream.next_2d()
    u_dir, stream = stream.next_2d()
    wl = sd_j.band.c / jnp.maximum(f_rx, 1e-6)
    si = s_j.shape_index_of_endpoint('receiver', rx.id)
    from beifong_tpu.core import transform as tfm_j, warp as warp_j
    origin, sn, tn, nrm = ep_j.rx_array_frame(sd_j, rx, si)
    o = jnp.broadcast_to(origin + 1e-4 * nrm, (n, 3))
    frame = tfm_j.frame_from_normal(jnp.broadcast_to(nrm, (n, 3)))
    d = tfm_j.to_world(frame, warp_j.square_to_cosine_hemisphere(u_dir))
    w = np.pi * ep_j.rx_elem_pattern_gain(rx, sn, tn, d, wl) * rx.gain
    n_ch = 2 if elem_off is None else 2 * elem_off.shape[0]
    adc = jnp.zeros((cfg.n_time, cfg.n_freq, n_ch + 2), jnp.float32)
    adc, _ = rp_j.radar_receive_trace(
        sd_j, stream, o, d, t_rx, f_rx, w * f_w, adc, cfg, rx.receive_type,
        rx.lo_waveform, jnp.asarray(rx.velocity), max_depth=max_depth,
        coherent=True, time_sampling=time_sampling, elem_offsets=elem_off)
    return np.asarray(adc)


WF_CASES = [('config6', config6, 2, 'gate'),
            ('mixer_cube', mixer_cube, 2, 'fixed')]


@pytest.mark.parametrize('name, fn, depth, ts', WF_CASES,
                         ids=[c[0] for c in WF_CASES])
def test_wavefront_mimo_matches_jax(name, fn, depth, ts, monkeypatch):
    """Every cell of all 2E channels within 1e-4 x max|acc| plus the MIMO
    phase slack times the cell's amplitude sum (the JAX trace of the same
    rays with its phase set to 0 gives it in its I channel)."""
    s_j, rx_j = fn('jax')
    rx_t = port_rx(rx_j)
    sd_j = receive_j.scene_mono(s_j.compile(use_bvh=False))
    sd_t = receive_t.scene_mono(scene_data_from_numpy(
        jax_leaves(sd_j), port_band(sd_j.band), device='cpu'))
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    eoff = np.asarray(ep_j.rx_elem_offsets(sd_j, rx_j, si))
    n_lanes = 1 << 14
    table = np.random.default_rng(depth + 7).random((40, n_lanes),
                                                    dtype=np.float32)
    cfg = rx_t.adc
    got = torch.zeros((cfg.n_time, cfg.n_freq, 2 * eoff.shape[0] + 2))
    lo = rx_t.lo_waveform
    receive_t._receive_mimo_pass(sd_t, rx_t, si, lo, PortReplay(
        torch.from_numpy(table)), got, torch.from_numpy(eoff), n_lanes,
        depth, ts)
    got = got.numpy()
    ref = jax_mimo_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)), depth,
                        ts, jnp.asarray(eoff))
    assert got.shape == ref.shape == (cfg.n_time, cfg.n_freq, 18)
    n_val = 16
    scale = np.abs(ref[..., :n_val]).max()
    assert scale > 0 and np.isfinite(got).all()
    monkeypatch.setattr(rp_j, '_echo_phase',
                        lambda *a, **k: jnp.zeros_like(a[5]))
    amp = jax_mimo_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)),
                        depth, ts, None)[..., :1]
    bound = TOL * scale + rk.phase_slack(sd_t.band, cfg, mimo=True) * amp
    err = np.abs(got[..., :n_val] - ref[..., :n_val])
    assert (err <= bound).all(), (err.max(), scale)
    for ch in (n_val, n_val + 1):     # tent weights, connection counts
        ch_scale = np.abs(ref[..., ch]).max()
        assert ch_scale > 0
        assert np.abs(got[..., ch] - ref[..., ch]).max() <= TOL * ch_scale


# ---------------------------------------------------------------------------
# 4. the kernel's MIMO configuration: plain version against _run
# ---------------------------------------------------------------------------


def _kernel_parity(ts: str, depth: int, n_lanes: int, n_time: int = 64,
                   seed: int = 5):
    """The plain version's MIMO configuration against `pr._run(interpret=
    True, mimo_e=8)` on config 6 (on `n_time` fast-time bins) in time
    sampling `ts` at `depth`, identical uniforms: all 16 channels within
    1e-4 x max|acc| plus the MIMO phase slack times the cell's amplitude
    sum; the same events."""
    s_j, rx_j = config6('jax')
    if n_time != rx_j.adc.n_time:
        rx_j = dc.replace(rx_j, adc=dc.replace(rx_j.adc, n_time=n_time))
        s_j.receivers[0] = rx_j
    sd_j = s_j.compile(use_bvh=False)
    why = []
    assert pr.supported(sd_j, rx_j, why, mimo=True), why
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     _) = pr._pack_scene(sd_j, rx_j, si)
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    eoff = np.asarray(ep_j.rx_elem_offsets(sd_j, rx_j, si), np.float32)
    out, _, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx_j.adc, rx_j.receive_type, ts, depth, 'phased', n_lanes, True,
        False, has_mesh=False, mesh_types=mesh_types, moving=False,
        absorbing=False, tx_kinds=tuple(int(f) for f in txp[:, 27]),
        has_lo=False, polarized=False, bmp_meta=bmp_meta, layered=0,
        tex=jnp.asarray(tex), msh=jnp.asarray(msh), mimo_e=8,
        eoff=jnp.asarray(eoff), grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]))
    out, cnt = np.asarray(out), float(np.asarray(cnt)[0, 0])
    nd = pr.n_draws(depth)
    assert nd == rk.n_draws(depth)
    u = jax.random.uniform(jax.random.key(seed), (n_lanes // 1024, nd, 8, 128),
                           dtype=jnp.float32)
    u = torch.tensor(np.asarray(u).transpose(1, 0, 2, 3).reshape(nd, n_lanes))
    rx_t = port_rx(rx_j)
    amp = torch.zeros((n_time, 1), dtype=torch.float64)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(
        torch.tensor(params), torch.tensor(prim), torch.tensor(txp), u,
        adc=rx_t.adc, max_depth=depth, time_sampling=ts,
        rx_kind='phased', doppler=True, rxph=torch.tensor(rxph),
        eoff=torch.from_numpy(eoff), amp_out=amp, stats=stats)
    assert acc.shape == (n_time, 1, 16) and out.shape == (n_time, 16)
    ref = out[:, None, :]
    scale = np.abs(ref).max()
    assert scale > 0 and cnt > 0
    bound = TOL * scale \
        + rk.phase_slack(s_j.band, rx_t.adc, mimo=True) * amp.numpy()[..., None]
    err = np.abs(acc.numpy() - ref)
    assert (err <= bound).all(), (err.max(), scale)
    assert int(n_ev) == int(cnt)
    assert stats['phased_ray'] == n_lanes and stats['mimo_vertex'] > 0
    assert stats['mimo_elem'] == 8 * stats['phase'] > 0
    return rx_t, stats


def test_kernel_plain_version_matches_jax_megakernel():
    """Config 6, depth 2, gate, 2,048 lanes (`_kernel_parity`)."""
    _kernel_parity('gate', 2, 2048)


# the card's other two MIMO cases (tests/test_torch_gpu.py MIMO_SCENES):
# (time sampling, depth, fast-time bins, lanes, seed): fixed time sampling
# at depth 3, and 1,024 fast-time bins, whose 1,024 x 16 values lie past
# the block's 8,192-value shared grid (mode 2).  Fixed sampling connects
# about one lane in 2,048 on config 6 (seed 5's connect none there): seed 4
# is one whose lanes connect
MORE_CASES = {'config6_fixed_d3': ('fixed', 3, 64, 2048, 4),
              'global_grid': ('gate', 2, 1024, 1024, 5)}


@pytest.mark.parametrize('case', list(MORE_CASES))
def test_kernel_plain_version_matches_jax_megakernel_more(case):
    """Config 6 in fixed sampling at depth 3, and on 1,024 bins (the global
    grid's case), 1,024-2,048 lanes (`_kernel_parity`)."""
    ts, depth, n_time, n_lanes, seed = MORE_CASES[case]
    rx_t, stats = _kernel_parity(ts, depth, n_lanes, n_time, seed)
    n_elem = 8
    assert rk.grid_mode(n_time, True, True, n_elem) == \
        (2 if case == 'global_grid' else 1)
    if depth == 3:
        # the bounce's second vertex is traced
        assert stats['trace'] > stats['phased_ray']


# ---------------------------------------------------------------------------
# 5. pack, scope, routing
# ---------------------------------------------------------------------------


def test_pack_bit_identical_to_jax():
    """`pack_scene` equals `_pack_scene` bit for bit on config 6: the
    phased receiver row rxph (1, 2 + 6 x 64) and the array's half-extents
    params[30:32] included."""
    s_j, rx_j = config6('jax')
    sd_j, sd_t = carried(s_j)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    params, prim, txp, php, rxph, msh, *_ = pr._pack_scene(sd_j, rx_j, si)
    got = rk.pack_scene(sd_t, port_rx(rx_j), si)
    assert got.rxph.shape == (1, 2 + 6 * 64) and got.params[30] > 0
    for name, a, b in [('params', got.params, params), ('prim', got.prim, prim),
                       ('txp', got.txp, txp), ('php', got.php, php),
                       ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)


def _config6_with(**rx_fields):
    s, rx = bt.mimo_beamform_scene()
    for k, v in rx_fields.items():
        setattr(rx, k, v)
    return s, rx


def _mesh():
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry.mesh import MeshSpec, make_grid
    s, rx = bt.mimo_beamform_scene()
    v, f = make_grid(3, 3)
    s.add(MeshSpec(np.asarray(v, np.float32), np.asarray(f), bsdf='mat',
                   to_world=np.asarray(tf.compose(
                       tf.look_at([0, -3.0, 0], [0, 0, 0]), tf.scale(0.3)))))
    return s, rx


@pytest.mark.parametrize('make, needle', [
    (lambda: _config6_with(n_elems=1), '>= 2 elements'),
    (lambda: _config6_with(n_elems=9), '9 MIMO elements > 8'),
    (lambda: _config6_with(adc=ep_t.ADCConfig(n_time=64, n_freq=2,
                                              freq_lo=39e3, freq_hi=41e3)),
     'n_freq == 1'),
    (bt.flagship_scene, 'phased receiver'), (_mesh, 'ROADMAP B6')],
    ids=['E1', 'E9', 'n_freq2', 'wigner', 'mesh'])
def test_mimo_scope_rejects_with_reason(make, needle):
    s, rx = make()
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why, mimo=True)
    assert len(why) == 1 and needle in why[0], why


def test_mimo_scope_admits_config6_and_power_scope_refuses_it():
    """Config 6's array in the MIMO scope; in the power scope (its analog
    cross-WDF receive, ROADMAP B6's endpoints) up to the JAX package's cap
    of 64 pairs: an 8-element array is in it, a 9-element one is refused
    and receive() runs it on the wavefront."""
    s, rx = bt.mimo_beamform_scene()
    sd = s.compile(device='cpu')
    why = []
    assert rk.supported(sd, rx, why, mimo=True), why
    assert rk.supported(sd, rx, why), why
    rx9 = dc.replace(rx, n_elems=9)
    assert not rk.supported(sd, rx9, why)
    assert 'phased rx pair unroll 81 > 64' in why[0]
    with pytest.raises(NotImplementedError, match='81 > 64'):
        bt.receive(s, sd, rx9, spp=256, max_depth=1, use_kernel=True,
                   device='cpu')
    a, n = bt.receive(s, sd, rx9, spp=256, max_depth=1, device='cpu')
    assert n == 256 and bool(torch.isfinite(a).all())


def test_receive_mimo_routes_by_scope(monkeypatch):
    """'auto': config 6 to the kernel (its plain version here), the mixer
    cube (n_freq 8) to the wavefront; use_kernel=True out of scope
    raises with the reasons; without a card the default device raises."""
    calls = {'kernel': 0, 'wavefront': 0}
    k_orig, w_orig = rk.receive_kernel, receive_t._receive_mimo_pass

    def kernel(*a, **k):
        calls['kernel'] += 1
        return k_orig(*a, **k)

    def wave(*a, **k):
        calls['wavefront'] += 1
        return w_orig(*a, **k)
    monkeypatch.setattr(rk, 'receive_kernel', kernel)
    monkeypatch.setattr(receive_t, '_receive_mimo_pass', wave)
    s, rx = bt.mimo_beamform_scene()
    adc, n = bt.receive_mimo(s, spp=1024, max_depth=1, time_sampling='gate',
                             device='cpu')
    assert calls == {'kernel': 1, 'wavefront': 0}
    assert adc.shape == (64, 1, 18) and n == 1024
    s2, rx2 = mixer_cube('port')
    sd2 = s2.compile(device='cpu')
    adc2, n2 = bt.receive_mimo(s2, sd2, rx2, spp=1024, max_depth=1,
                               device='cpu')
    assert calls == {'kernel': 1, 'wavefront': 1}
    assert adc2.shape == (64, 8, 18) and n2 == 1024
    with pytest.raises(NotImplementedError, match='n_freq == 1'):
        bt.receive_mimo(s2, sd2, rx2, spp=1024, max_depth=1, use_kernel=True,
                        device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bt.receive_mimo(s, spp=1024)


def test_develop_mimo_layout():
    """Channels (2e, 2e + 1) are element e's I and Q; the cube is (E,
    n_time, n_freq), scaled by n_time / samples."""
    adc = torch.arange(4 * 2 * 10, dtype=torch.float32).reshape(4, 2, 10)
    cube = bt.develop_mimo(adc, 8, ep_t.ADCConfig(n_time=4, n_freq=2))
    assert cube.shape == (4, 4, 2) and cube.dtype == torch.complex64
    assert torch.equal(cube[1].real, adc[..., 2] * 0.5)
    assert torch.equal(cube[1].imag, adc[..., 3] * 0.5)


# ---------------------------------------------------------------------------
# 6. golden config 6 end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_das():
    """The JAX package's receive_mimo -> develop_mimo -> delay-and-sum
    azimuth spectrum of config 6 (spp 2^13, depth 2, gate, seed 3)."""
    s, rx = config6('jax')
    sd = s.compile()
    adc, n = receive_j.receive_mimo(s, sd, rx, spp=1 << 13, max_depth=2,
                                    seed=3, time_sampling='gate')
    cube = receive_j.develop_mimo(adc, n, rx.adc)
    offs = np.asarray(ep_j.rx_elem_offsets(
        sd, rx, s.shape_index_of_endpoint('receiver', rx.id)))
    _, dirs, _ = scenes.mimo_azimuth_scan()
    B = bf_j.delay_and_sum(cube, offs, dirs.numpy(), 40e3, C)
    return np.asarray(jnp.sum(jnp.abs(B) ** 2, axis=(1, 2)))


@pytest.mark.parametrize('use_kernel', [True, False],
                         ids=['kernel', 'wavefront'])
def test_config6_anchors_on_cpu(use_kernel, jax_das):
    """receive_mimo at spp 2^13, depth 2, gate: DAS and MVDR peak within 2
    bins of the golden file's expected azimuth bin, the DAS mainlobe over
    5x its median and MVDR sharper, the beamformed profile at 2R / c
    within 2 bins, the DAS spectrum correlated with the JAX package's at
    > 0.9."""
    m = scenes.MIMO
    s, rx = bt.mimo_beamform_scene()
    sd = s.compile(device='cpu')
    adc, n = bt.receive_mimo(s, sd, rx, spp=m['spp'],
                             max_depth=m['max_depth'], seed=m['seed'],
                             time_sampling='gate', use_kernel=use_kernel,
                             device='cpu')
    cube = bt.develop_mimo(adc, n, rx.adc)
    assert cube.shape == (8, 64, 1)
    az, dirs, want = scenes.mimo_azimuth_scan()
    assert want == int(np.load(GOLDEN)['meta_expected_az_bin'])
    offs = rk.array_offsets(s, sd, rx, torch.device('cpu'))
    B = bf_t.delay_and_sum(cube, offs, dirs, m['fc'], s.band.c)
    das = (B.abs() ** 2).sum(dim=(1, 2))
    mvdr = bf_t.mvdr_spectrum(cube, offs, dirs, m['fc'], s.band.c)
    assert abs(int(das.argmax()) - want) <= 2
    assert abs(int(mvdr.argmax()) - want) <= 2
    sharp = float(das.max() / das.median())
    assert sharp > 5.0
    assert float(mvdr.max() / mvdr.median()) > sharp
    y = B[int(das.argmax()), :, 0].abs() ** 2
    cfg = rx.adc
    t_pk = (int(y.argmax()) + 0.5) / cfg.n_time * cfg.sampling_time
    assert abs(t_pk - 2 * m['R'] / s.band.c) <= 2 * cfg.sampling_time \
        / cfg.n_time
    p = das.numpy()
    cn = np.corrcoef(p / p.max(), jax_das / jax_das.max())[0, 1]
    assert cn > 0.9, cn
