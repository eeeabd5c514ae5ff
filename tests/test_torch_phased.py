"""The endpoint configuration of the port against the JAX package: phased
transmitters and analog phased receivers (the cross-WDF pair sums), area
transmitters and several transmitters, in the wavefront's endpoint ops,
the receive kernel's tables, scope and draw layout, its plain version
against `pr._run(interpret=True)` on identical uniforms, the wavefront
trace on identical uniforms, and the physics anchors of the JAX package's
own tests (the steering pattern of tests/test_radar.py:380-441, the
steering contrast of tests/test_pallas_receive.py:1137-1219).  The CUDA
kernel's endpoint twins are held against the plain version on a card by
tests/test_torch_gpu.py."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr
from beifong_tpu.radar import endpoints as ep_j
from beifong_tpu.radar import wigner as wig_j

import beifong_tpu_torch as bt
from beifong_tpu_torch import scenes
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar import endpoints as ep_t
from beifong_tpu_torch.radar import wigner as wig_t

from test_torch_mesh import jax_leaves, port_band
from test_torch_mimo import port_rx
from test_torch_wavefront import (JaxReplay, _pkg, jax_pass, port_pass)

torch.set_num_threads(1)

TOL = 1e-4      # x max|acc| per cell: the plain version against the JAX one
C = 340.0


# ---------------------------------------------------------------------------
# the scenes, built with either package's modules
# ---------------------------------------------------------------------------


def endpoint_scene(pkg: str, name: str, *args):
    """`scenes.py`'s endpoint scenes built with package `pkg`'s modules:
    'phased_tx' (steer_deg, n_elems), 'phased_rx' (steer_deg, n_elems),
    'four_tx' (n: the first n of `scenes.FOUR_TX`), and the JAX package's
    'area' and 'two_tx' kernel-test scenes
    (tests/test_pallas_receive.py:368-400, 914-945).  Returns (scene,
    receiver spec)."""
    k = _pkg(pkg)
    P = scenes.PHASED

    def base(band_hz):
        s = k.sc.Scene(band=k.Band.from_freq(C, P['fc'], band_hz))
        s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True))
        wf = k.radar.pulse(f_centre=P['fc'], prf=10.0, pulse_len=2e-3,
                           f_ext=min(band_hz, 2e3), is_delta=True)
        adc = k.radar.ADCConfig(
            n_time=64, n_freq=1, sampling_start=0.0, sampling_time=0.06,
            freq_lo=P['fc'] - 0.5 * band_hz, freq_hi=P['fc'] + 0.5 * band_hz)
        return s, wf, adc

    def rect(s, pos, aim, scale, **ep):
        s.add(k.sh.rectangle(to_world=np.asarray(k.tf.compose(
            k.tf.look_at(list(pos), list(aim)), k.tf.scale(scale))), **ep))

    if name in ('phased_tx', 'phased_tx_ggx'):
        steer, n_e = args
        s, wf, adc = base(1e3)
        g = scenes.PHASED_GGX
        if name == 'phased_tx_ggx':
            s.bsdfs[0] = k.bsdf.rough_conductor(
                'mat', specular_reflectance=1.0, alpha=g['alpha'],
                eta=g['eta'], k=g['k'], twosided=True)
        wl = s.band.wavelength_centre
        s.add(k.radar.phased_transmitter(
            'tx', wf, n_elems=n_e, elem_spacing=wl / 2,
            elem_wid=(wl / 4, wl / 4), steer_deg=steer, resample_freq=True))
        half = max(2.0, 0.25 * (n_e + 1)) * wl
        tx = P['tx']
        rect(s, tx, (tx[0], -1.0, 0.0), [half, half, 1.0], transmitter='tx')
        rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
        s.add(rx)
        tgt = scenes.phased_tx_target()
        rect(s, (-0.3, 0.0, 0.0), tgt, [0.02, 0.02, 1.0], receiver='rx')
        vel = {} if name == 'phased_tx' else dict(
            velocity=np.array([0.0, g['v'], 0.0], np.float32))
        rect(s, tgt, tx, 0.4, bsdf='mat', **vel)
        return s, rx
    if name == 'phased_rx':
        steer, n_e = args
        s, wf, adc = base(1e3)
        wl = s.band.wavelength_centre
        s.add(k.radar.wigner_transmitter('tx', wf, resample_freq=True))
        tx = P['tx']
        rect(s, tx, (tx[0], -1.0, 0.0), [0.004, 0.004, 1.0],
             transmitter='tx')
        rx = k.radar.phased_receiver(
            'rx', adc, n_elems=n_e, elem_spacing=wl / 2,
            elem_wid=(wl / 4, wl / 4), steer_deg=steer, receive_type='raw')
        s.add(rx)
        rect(s, (0.0, 0.0, 0.0), (0.0, -1.0, 0.0), [1e-4, 1e-4, 1.0],
             receiver='rx')
        for tgt in scenes.phased_rx_targets():
            rect(s, tgt, (0.0, 0.0, 0.0), 0.4, bsdf='mat')
        return s, rx
    if name == 'four_tx':
        n, = args
        s, wf, adc = base(10e3)
        wl = s.band.wavelength_centre
        for i, (kind, pos) in enumerate(scenes.FOUR_TX[:n]):
            tid = f'tx{i + 1}'
            if kind == 'phased':
                s.add(k.radar.phased_transmitter(
                    tid, wf, n_elems=5, elem_spacing=wl / 2,
                    elem_wid=(wl / 4, wl / 4),
                    gain=1.0 / (4.0 * (wl / 4) ** 2), resample_freq=True))
                size = 1.25 * wl
            else:
                make = (k.radar.area_transmitter if kind == 'area'
                        else k.radar.wigner_transmitter)
                s.add(make(tid, wf, resample_freq=True))
                size = 0.01
            rect(s, pos, (pos[0], pos[1] - 1.0, pos[2]), [size, size, 1.0],
                 transmitter=tid)
        rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
        s.add(rx)
        rect(s, (-0.3, 0.0, 0.0), (-0.3, -1.0, 0.0), [0.05, 0.05, 1.0],
             receiver='rx')
        rect(s, (0.0, -4.0, 0.0), (0.0, 0.0, 0.0), 0.5, bsdf='mat')
        return s, rx
    if name == 'area':
        s, wf, adc = base(10e3)
        s.add(k.radar.area_transmitter('tx', wf, resample_freq=True))
        rect(s, (0.3, 0, 0), (0.3, -1, 0), [0.05, 0.05, 1.0],
             transmitter='tx')
        rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
        s.add(rx)
        rect(s, (-0.3, 0, 0), (-0.3, -1, 0), [0.05, 0.05, 1.0],
             receiver='rx')
        rect(s, (0, -4.0, 0), (0, 0, 0), 0.5, bsdf='mat')
        return s, rx
    if name == 'two_tx':
        assert pkg == 'jax'
        from test_pallas_receive import _two_tx_scene
        return _two_tx_scene()
    raise ValueError(name)


def carried(s_j):
    """(JAX SceneData, the port's SceneData of the same tables)."""
    sd_j = s_j.compile(use_bvh=False)
    return sd_j, scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                       device='cpu')


def _close(got, ref, what, rtol=1e-5, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# 1. the cross-WDF and the endpoint ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('lanes_axis', [False, True],
                         ids=['one-array', 'per-lane'])
def test_phased_aperture_gain_matches_jax(lanes_axis):
    """Random pairs (K = 36, a few masked), points and directions: the
    signed sum to 1e-5 of its largest magnitude (the terms cancel)."""
    g = np.random.default_rng(21)
    n, k = 512, 36
    f32 = np.float32

    def arr(*shape, lo=-1.0, hi=1.0):
        return g.uniform(lo, hi, shape).astype(f32)
    mid, base = arr(k, 3, lo=-0.02, hi=0.02), arr(k, 3, lo=-0.03, hi=0.03)
    psi, mask = arr(k, lo=-3, hi=3), g.random(k) > 0.1
    fs = np.array([1.0, 0.2, 0.1], f32)
    fs /= np.linalg.norm(fs)
    ft = np.cross([0.0, 0.0, 1.0], fs).astype(f32)
    ft /= np.linalg.norm(ft)
    wid, org = np.array([0.004, 0.003], f32), arr(3, lo=-0.1, hi=0.1)
    p = (org + arr(n, 1, lo=-0.03, hi=0.03) * fs
         + arr(n, 1, lo=-0.01, hi=0.01) * ft).astype(f32)
    d = arr(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lam = arr(n, lo=0.0075, hi=0.0095)
    ref = np.asarray(jax.vmap(lambda *a: wig_j.phased_aperture_gain(
        *a[:8], a[8][None], a[9][None], a[10][None])[0],
        in_axes=(None,) * 8 + (0, 0, 0))(
        *(jnp.asarray(x) for x in (mid, base, psi, mask, fs, ft, wid, org,
                                   p, d, lam))))
    tabs = [mid, base, psi, mask, fs, ft, wid, org]
    if lanes_axis:
        tabs = [np.broadcast_to(x, (n,) + x.shape).copy() for x in tabs]
    got = wig_t.phased_aperture_gain(*(torch.from_numpy(np.asarray(x))
                                       for x in tabs + [p, d, lam]))
    assert np.abs(ref).max() > 0 and (ref != 0).mean() > 0.3
    _close(got, ref, 'phased_aperture_gain', rtol=0,
           atol=1e-5 * np.abs(ref).max())


def test_transmitter_table_pair_leaves_bit_exact():
    """A phased, a Wigner, an area and a Wigner transmitter together: the
    port's own `TransmitterTable.build` equals the JAX package's leaf for
    leaf (K = 25, the pairs steered at the band centre)."""
    s_j, _ = endpoint_scene('jax', 'four_tx', 4)
    s_t, _ = endpoint_scene('port', 'four_tx', 4)
    tj = s_j.compile(use_bvh=False).transmitters
    tt = s_t.compile(device='cpu').transmitters
    assert tuple(tt.pair_mask.shape) == (4, 25)
    for f in ('kind', 'shape_idx', 'gain', 'resample', 'velocity',
              'elem_mid', 'elem_baseline', 'psi', 'pair_mask', 'elem_wid'):
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(tj, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tt.pair_mask[0].all() and not tt.pair_mask[1:].any()


def test_tx_aperture_gain_matches_jax():
    """Each transmitter of the four-transmitter scene at random points on
    its rectangle toward random directions: Wigner WDF, cross-WDF and 1,
    to 1e-5 of the largest magnitude of each kind."""
    s_j, _ = endpoint_scene('jax', 'four_tx', 4)
    sd_j, sd_t = carried(s_j)
    g = np.random.default_rng(5)
    n = 2048
    rows = np.repeat(np.arange(4, dtype=np.int32), n // 4)
    tw = np.asarray(sd_j.shapes.to_world)[np.asarray(
        sd_j.transmitters.shape_idx)[rows]]
    loc = np.concatenate([g.uniform(-1, 1, (n, 2)), np.zeros((n, 1)),
                          np.ones((n, 1))], 1)
    p = np.einsum('nij,nj->ni', tw[:, :3, :], loc).astype(np.float32)
    d = g.normal(size=(n, 3)) + [0.0, -3.0, 0.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    lam = g.uniform(0.0076, 0.0097, n).astype(np.float32)
    ref = np.asarray(ep_j.tx_aperture_gain(sd_j, jnp.asarray(rows),
                                           jnp.asarray(p), jnp.asarray(d),
                                           jnp.asarray(lam)))
    got = ep_t.tx_aperture_gain(sd_t, torch.from_numpy(rows),
                                torch.from_numpy(p), torch.from_numpy(d),
                                torch.from_numpy(lam)).numpy()
    for t in range(4):
        sel = rows == t
        scale = np.abs(ref[sel]).max()
        assert scale > 0
        _close(got[sel], ref[sel], f'tx {t}', rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(got[rows == 2], 1.0)     # the area one


@pytest.mark.parametrize('n_elems', [4, 8])
def test_phased_rx_ray_and_weight_match_jax(n_elems):
    """The analog phased receiver's `rx_sample_ray` (a point over the
    array's bounding rectangle, the cosine hemisphere) and
    `rx_aperture_weight` (its cross-WDF) on the same uniforms."""
    s_j, rx_j = endpoint_scene('jax', 'phased_rx', 10.0, n_elems)
    rx_t = port_rx(rx_j)
    sd_j, sd_t = carried(s_j)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    g = np.random.default_rng(n_elems)
    n = 4096
    u_pos = g.random((n, 2), dtype=np.float32)
    u_dir = g.random((n, 2), dtype=np.float32)
    lam = np.full(n, sd_j.band.wavelength_centre, np.float32)
    o_j, d_j, w_j = ep_j.rx_sample_ray(sd_j, rx_j, si, jnp.zeros(n),
                                       jnp.asarray(u_pos),
                                       jnp.asarray(u_dir), jnp.asarray(lam))
    o_t, d_t, w_t = ep_t.rx_sample_ray(sd_t, rx_t, si, torch.zeros(n),
                                       torch.from_numpy(u_pos),
                                       torch.from_numpy(u_dir),
                                       torch.from_numpy(lam))
    _close(o_t, o_j, 'o', atol=1e-7)
    _close(d_t, d_j, 'd', atol=1e-6)
    _close(w_t, w_j, 'weight')
    ap_j = np.asarray(ep_j.rx_aperture_weight(sd_j, rx_j, si, o_j, d_j,
                                              jnp.asarray(lam)))
    ap_t = ep_t.rx_aperture_weight(sd_t, rx_t, si, o_t, d_t,
                                   torch.from_numpy(lam))
    assert np.abs(ap_j).max() > 0
    _close(ap_t, ap_j, 'cross-WDF', rtol=0, atol=1e-5 * np.abs(ap_j).max())


# ---------------------------------------------------------------------------
# 2. the kernel's tables, draws and scope
# ---------------------------------------------------------------------------


PACKS = [('four_tx', (1,)), ('four_tx', (2,)), ('four_tx', (3,)),
         ('four_tx', (4,)), ('phased_rx', (10.0, 8)),
         ('phased_tx', (-12.0, 8))]


@pytest.mark.parametrize('name, args', PACKS,
                         ids=['n_tx1', 'n_tx2', 'n_tx3', 'n_tx4', 'phased_rx',
                              'phased_tx'])
def test_pack_bit_identical_to_jax(name, args):
    """`pack_scene`'s params, prim, txp, php and rxph equal
    `_pack_scene`'s bit for bit for one to four transmitters of mixed
    kinds and for a phased receiver."""
    s_j, rx_j = endpoint_scene('jax', name, *args)
    sd_j, sd_t = carried(s_j)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    params, prim, txp, php, rxph, msh, *_ = pr._pack_scene(sd_j, rx_j, si)
    got = rk.pack_scene(sd_t, port_rx(rx_j), si)
    for what, a, b in [('params', got.params, params), ('prim', got.prim, prim),
                       ('txp', got.txp, txp), ('php', got.php, php),
                       ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=what)
    if name == 'four_tx':
        assert got.txp.shape == (args[0], 32)
        assert got.php.shape == (args[0], 2 + 6 * 25)


@pytest.mark.parametrize('name, args', [
    ('phased_tx', (-12.0, 8)), ('phased_rx', (16.7, 8)), ('four_tx', (4,))])
def test_port_scenes_pack_as_the_jax_mirrors(name, args):
    """`scenes.phased_tx_scene`, `phased_rx_scene` and `four_tx_scene`
    pack to the tables of the same scenes built with the JAX package (the
    prim rows' to_object to 1e-6)."""
    s_j, rx_j = endpoint_scene('jax', name, *args)
    s_t, rx_t = getattr(scenes, name + '_scene')(*args[:-1] if name
                                                   == 'four_tx' else args)
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    ref = pr._pack_scene(sd_j, rx_j, si)
    got = rk.pack_scene(s_t.compile(device='cpu'), rx_t,
                        s_t.shape_index_of_endpoint('receiver', rx_t.id))
    for what, a, b in [('params', got.params, ref[0]),
                       ('txp', got.txp, ref[2]), ('php', got.php, ref[3]),
                       ('rxph', got.rxph, ref[4])]:
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)
    # each package inverts to_world in its own float32 arithmetic
    np.testing.assert_allclose(got.prim, ref[1], rtol=1e-6, atol=1e-6)


def test_n_draws_matches_jax():
    for d in range(1, 5):
        for n_tx in range(1, 5):
            assert rk.n_draws(d, n_tx) == pr.n_draws(d, n_tx)
    assert rk.n_draws(3) == rk.n_draws(3, 1) == 8 + 6 * 3


def _with(name, args, change):
    """An endpoint scene past one of the JAX kernel's caps, built with
    either package."""
    def make(pkg):
        k = _pkg(pkg)
        s, rx = endpoint_scene(pkg, name, *args)
        wl = s.band.wavelength_centre
        if change == 'five_tx':
            wf = s.transmitters[0].waveform
            s.add(k.radar.wigner_transmitter('tx5', wf, resample_freq=True))
            s.add(k.sh.rectangle(to_world=np.diag([0.01, 0.01, 1.0, 1.0]),
                                 transmitter='tx5'))
        elif change == 'three_7_elem':
            for i, tid in enumerate(('tx2', 'tx3')):
                s.add(k.radar.phased_transmitter(
                    tid, s.transmitters[0].waveform, n_elems=7,
                    elem_spacing=wl / 2, elem_wid=(wl / 4, wl / 4),
                    resample_freq=True))
                s.add(k.sh.rectangle(to_world=np.asarray(k.tf.compose(
                    k.tf.translate([1.0 + i, 0.5, 0.0]),
                    k.tf.scale([0.03, 0.03, 1.0]))), transmitter=tid))
        elif change == 'mix_resample':
            rx = dc.replace(rx, receive_type='mix_resample')
            s.receivers[0] = rx
        return s, rx
    return make


CAPS = [
    ('five_tx', _with('four_tx', (4,), 'five_tx'), '5 transmitters > 4'),
    ('three_7_elem', _with('phased_tx', (0.0, 7), 'three_7_elem'),
     'phased pair unroll 3x49 > 128'),
    ('rx_9_elem', _with('phased_rx', (0.0, 9), None),
     'phased rx pair unroll 81 > 64'),
    ('mix_two_tx', _with('four_tx', (2,), 'mix_resample'),
     'mix_resample with multiple transmitters'),
    ('four_tx', _with('four_tx', (4,), None), None),
    ('phased_rx_8', _with('phased_rx', (16.7, 8), None), None),
    ('area', _with('area', (), None), None),
]


@pytest.mark.parametrize('name, make, needle', CAPS,
                         ids=[c[0] for c in CAPS])
def test_scope_gives_the_jax_verdict(name, make, needle):
    """The JAX kernel's caps: five transmitters, 3 x 7-element phased
    arrays (147 pairs > 128), a 9-element phased receiver (81 > 64),
    mix_resample with two transmitters; the scenes within them in
    scope."""
    s_j, rx_j = make('jax')
    s_t, rx_t = make('port')
    why_j, why_t = [], []
    ok_j = pr.supported(s_j.compile(use_bvh=False), rx_j, why_j)
    ok_t = rk.supported(s_t.compile(device='cpu'), rx_t, why_t)
    assert ok_t == ok_j == (needle is None), (why_j, why_t)
    if needle:
        assert needle in why_t[0], why_t


def test_endpoints_through_a_medium_stay_on_the_wavefront():
    """The endpoint configuration has no media twin: such a scene is out
    of the kernel's scope naming ROADMAP B6, and 'auto' runs it on the
    wavefront."""
    s, rx = scenes.four_tx_scene()
    s.medium = scenes.stratified_homogeneous()
    sd = s.compile(device='cpu')
    why = []
    assert not rk.supported(sd, rx, why) and 'ROADMAP B6' in why[0]
    with pytest.raises(NotImplementedError, match='ROADMAP B6'):
        bt.receive(s, sd, rx, spp=256, max_depth=1, use_kernel=True,
                   device='cpu')
    a, n = bt.receive(s, sd, rx, spp=1024, max_depth=1, device='cpu')
    assert n == 1024 and bool(torch.isfinite(a).all())


# ---------------------------------------------------------------------------
# 3. the plain version against the JAX kernel on identical uniforms
# ---------------------------------------------------------------------------


def jax_kernel(s, rx, depth: int, n_lanes: int, seed: int,
               coherent: bool = False):
    """`_run(interpret=True)` as `receive_pallas` calls it on a static
    analytic scene, gate sampling, plus the uniforms it drew as (n_draws,
    n_lanes) and its tables; the output is power, or with `coherent` I and
    Q stacked on a last axis."""
    sd = s.compile(use_bvh=False)
    why = []
    assert pr.supported(sd, rx, why), why
    si = s.shape_index_of_endpoint('receiver', rx.id)
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     mesh_pack) = pr._pack_scene(sd, rx, si)
    assert mesh_pack is None
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    rx_kind = ('phased' if rx.kind == ep_j.PHASED and rx.n_elems > 1
               else 'wigner')
    # `receive_pallas`'s flag: any velocity in the tables
    moving = bool(np.abs(prim[:, 19:22]).max() > 0.0
                  or np.abs(txp[:, 24:27]).max() > 0.0
                  or np.abs(params[23:26]).max() > 0.0)
    out, out_q, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx.adc, rx.receive_type, 'gate', depth, rx_kind, n_lanes, True,
        coherent, has_mesh=False, mesh_types=mesh_types, moving=moving,
        absorbing=False, tx_kinds=tuple(int(f) for f in txp[:, 27]),
        has_lo=rx.lo_waveform is not None, polarized=False,
        bmp_meta=bmp_meta, layered=0,
        tex=jnp.asarray(tex), msh=jnp.asarray(msh), mimo_e=0, eoff=None,
        grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]))
    nd = pr.n_draws(depth, int(txp.shape[0]))
    u = jax.random.uniform(jax.random.key(seed),
                           (n_lanes // 1024, nd, 8, 128), dtype=jnp.float32)
    u = np.asarray(u).transpose(1, 0, 2, 3).reshape(nd, n_lanes)
    out = np.stack([out, out_q], -1) if coherent else np.asarray(out)
    return (out[:, 0], float(np.asarray(cnt)[0, 0]), rx_kind,
            (params, prim, txp, php, rxph, u))


KERNEL_CASES = [('phased_tx', (12.7, 4)), ('two_tx', ()), ('area', ()),
                ('phased_rx', (16.7, 4))]


@pytest.mark.parametrize('name, args', KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_plain_version_matches_jax_megakernel(name, args):
    """Depth 2, 1,024 lanes, gate, identical uniforms, on 16 fast-time
    bins (the interpret program unrolls its splat over every cell, for
    every transmitter and depth): every cell within 1e-4 x max|acc|, the
    same events; the wrapper on the CPU is the plain version."""
    s_j, rx_j = endpoint_scene('jax', name, *args)
    rx_j = dc.replace(rx_j, adc=dc.replace(rx_j.adc, n_time=16))
    s_j.receivers[0] = rx_j
    n_lanes, depth = 1024, 2
    out_j, cnt_j, rx_kind, (params, prim, txp, php, rxph, u) = jax_kernel(
        s_j, rx_j, depth, n_lanes, seed=4)
    t = torch.tensor
    adc = port_rx(rx_j).adc
    kw = dict(adc=adc, max_depth=depth, time_sampling='gate',
              rx_kind=rx_kind,
              php=t(php), rxph=t(rxph) if rx_kind == 'phased' else None)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(t(params), t(prim), t(txp), t(u),
                                          stats=stats, **kw)
    scale = np.abs(out_j).max()
    assert scale > 0 and cnt_j > 0
    np.testing.assert_allclose(acc[:, 0].numpy(), out_j, rtol=0,
                               atol=TOL * scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    if name.startswith('phased'):
        assert stats['pair_terms'] > 0
    acc_w, n_w = rk.receive_megakernel(t(params), t(prim), t(txp),
                                       n_lanes=n_lanes, uniforms=t(u), **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)


def assert_iq_matches_jax(s_j, rx_j, depth: int, n_lanes: int, seed: int):
    """The plain version's endpoint I / Q against the JAX kernel's on
    identical uniforms: I and Q of each cell within TOL x max(|I|, |Q|)
    plus `phase_slack` (4 ulps of the longest path in the ADC window over
    the shortest wavelength) times the cell's sum of amplitudes, as the
    coherent parity tests hold them (the frameworks' path lengths differ
    in their last bits); events within 1e-3; the CPU wrapper is the plain
    version."""
    out_j, cnt_j, rx_kind, (params, prim, txp, php, rxph, u) = jax_kernel(
        s_j, rx_j, depth, n_lanes, seed, coherent=True)
    t = torch.tensor
    rx_t = port_rx(rx_j)
    kw = dict(adc=rx_t.adc, max_depth=depth, time_sampling='gate',
              rx_kind=rx_kind, doppler=True, coherent=True,
              receive_type=rx_t.receive_type,
              has_lo=rx_t.lo_waveform is not None, php=t(php),
              rxph=t(rxph) if rx_kind == 'phased' else None)
    amp = torch.zeros((rx_t.adc.n_time, 1), dtype=torch.float64)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(t(params), t(prim), t(txp), t(u),
                                          stats=stats, amp_out=amp, **kw)
    assert acc.shape == (rx_t.adc.n_time, 1, 2) and out_j.shape == (
        rx_t.adc.n_time, 2)
    scale = np.abs(out_j).max()
    assert scale > 0 and cnt_j > 0 and stats['phase'] > 0
    bound = TOL * scale + rk.phase_slack(s_j.band, rx_j.adc) \
        * amp.numpy()[:, 0, None]
    err = np.abs(acc[:, 0].numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    acc_w, n_w = rk.receive_megakernel(t(params), t(prim), t(txp),
                                       n_lanes=n_lanes, uniforms=t(u), **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)
    return stats


IQ_CASES = [('phased_tx', (12.7, 4)), ('phased_rx', (16.7, 4))]


def test_plain_version_iq_on_a_moving_ggx_target_matches_jax_megakernel():
    """The coherent endpoint kernel's moving GGX path (its plain
    version): the phased transmitter's target a GGX rough conductor
    closing at 5 m/s (`scenes.phased_tx_scene(moving_ggx=True)`), depth 2,
    1,024 lanes, gate, 16 fast-time bins, held to the JAX kernel with
    `coherent=True` and `moving=True` as `assert_iq_matches_jax` holds the
    static cases; the lanes take the GGX lobe's NEE and bounce and the
    target's Doppler factor."""
    s_j, rx_j = endpoint_scene('jax', 'phased_tx_ggx', 12.7, 4)
    rx_j = dc.replace(rx_j, adc=dc.replace(rx_j.adc, n_time=16))
    s_j.receivers[0] = rx_j
    stats = assert_iq_matches_jax(s_j, rx_j, 2, 1024, seed=4)
    assert stats['pair_terms'] > 0
    assert stats['ggx_nee'] > 0 and stats['ggx_bounce'] > 0


@pytest.mark.parametrize('name, args', IQ_CASES,
                         ids=[c[0] for c in IQ_CASES])
def test_plain_version_iq_matches_jax_megakernel(name, args):
    """Depth 2, 1,024 lanes, gate, 16 fast-time bins: the endpoint
    configuration's I / Q (the coherent endpoint kernel's plain version)
    on a phased transmitter and an analog phased receiver, held to the
    JAX kernel with `coherent=True` (assert_iq_matches_jax)."""
    s_j, rx_j = endpoint_scene('jax', name, *args)
    rx_j = dc.replace(rx_j, adc=dc.replace(rx_j.adc, n_time=16))
    s_j.receivers[0] = rx_j
    stats = assert_iq_matches_jax(s_j, rx_j, 2, 1024, seed=4)
    assert stats['pair_terms'] > 0


# ---------------------------------------------------------------------------
# 4. the wavefront on identical uniforms, and the physics anchors
# ---------------------------------------------------------------------------


WF_CASES = [('phased_tx', (12.7, 4)), ('phased_rx', (16.7, 8)),
            ('four_tx', (4,))]


@pytest.mark.parametrize('name, args', WF_CASES,
                         ids=[c[0] for c in WF_CASES])
def test_wavefront_trace_matches_jax(name, args):
    """`radar_receive_trace` of the port and of the JAX package on one
    table of uniforms, depth 2, gate: every cell within 1e-4 x max|acc|
    (the wavefront draws one transmitter a lane and evaluates it through
    `tx_eval`, an analog phased receiver through `rx_sample_ray` and
    `rx_aperture_weight`)."""
    s_j, rx_j = endpoint_scene('jax', name, *args)
    import importlib
    receive_j = importlib.import_module('beifong_tpu.receive')
    sd_j = receive_j.scene_mono(s_j.compile(use_bvh=False))
    table = np.random.default_rng(7).random((40, 1 << 13), dtype=np.float32)
    got = port_pass(s_j, sd_j, port_rx(rx_j), table, 2, False, 'gate')
    ref = jax_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)), 2, False,
                   'gate')
    scale = np.abs(ref[..., 0]).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=0,
                               atol=TOL * scale)


def _array_factor(u, locs_x, wl, steer_deg):
    """Closed-form power array factor |sum_e exp(i k x_e (u - u0))|^2."""
    ph = 2.0 * np.pi * locs_x[None, :] * (u[:, None]
                                          - np.sin(np.radians(steer_deg))) / wl
    return np.abs(np.exp(1j * ph).sum(axis=1)) ** 2


def test_wavefront_rx_steering_pattern():
    """tests/test_radar.py:380-441 on the port: an 8-element phased
    receiver steered 15 degrees on a 0.1 mm rectangle; positions sampled
    over the array, the aperture-integrated cross-WDF over 241 directions
    peaks within 2 degrees of the steer, its first null is deep and the
    pattern correlates with the closed-form array factor > 0.95."""
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry import shapes as sh
    from beifong_tpu_torch import scene as sc
    from beifong_tpu_torch.radar import phased_receiver
    band = bt.Band.from_freq(C, 40e3, 1e3)
    wl = band.wavelength_centre
    e, steer = 8, 15.0
    adc = ep_t.ADCConfig(n_time=16, n_freq=1, sampling_time=0.05,
                         freq_lo=39e3, freq_hi=41e3)
    rx = phased_receiver('rx', adc, n_elems=e, elem_spacing=wl / 2,
                         elem_wid=(wl / 4, wl / 4), steer_deg=steer)
    s = sc.Scene(band=band)
    s.add(rx)
    s.add(sh.rectangle(to_world=np.asarray(tf.scale(1e-4)), receiver='rx'))
    sd = s.compile(device='cpu')
    si = s.shape_index_of_endpoint('receiver', rx.id)
    n = 1 << 13
    g = torch.Generator().manual_seed(0)
    o, _, w0 = ep_t.rx_sample_ray(sd, rx, si, torch.zeros(n),
                                  torch.rand(n, 2, generator=g),
                                  torch.rand(n, 2, generator=g))
    locs = ep_t._elem_locs(rx)
    span = np.abs(locs[:, 0]).max() + wl / 4
    assert o[:, 0].max() > 0.8 * span and o[:, 0].min() < -0.8 * span
    thetas = np.radians(np.linspace(-60, 60, 241))
    lam = torch.full((n,), wl)
    pat = np.array([float((w0 * ep_t.rx_aperture_weight(
        sd, rx, si, o, torch.tensor([np.sin(th), 0.0, np.cos(th)],
                                    dtype=torch.float32).expand(n, 3),
        lam)).mean()) for th in thetas])
    assert abs(np.degrees(thetas[pat.argmax()]) - steer) < 2.0
    u_null = np.sin(np.radians(steer)) + wl / (e * wl / 2)
    assert pat[np.argmin(np.abs(np.sin(thetas) - u_null))] < 0.05 * pat.max()
    assert np.corrcoef(pat, _array_factor(np.sin(thetas), locs[:, 0], wl,
                                          steer))[0, 1] > 0.95


def _energy(s, rx, use_kernel, seed, lo_hi=None):
    a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1 << 14,
                      max_depth=2, seed=seed, time_sampling='gate',
                      use_kernel=use_kernel, device='cpu')
    return bt.develop_signal(a, n, rx.adc)[:, 0, 0].numpy()


@pytest.mark.parametrize('use_kernel', [True, False],
                         ids=['kernel', 'wavefront'])
def test_steering_contrast(use_kernel):
    """tests/test_pallas_receive.py:1202-1219 on the port (8 elements):
    steered at the target the echo peaks within 2 bins of its round trip;
    steered the other way its window holds < 0.5 of the energy."""
    st = scenes.steer_toward(scenes.PHASED['tx'], scenes.phased_tx_target())
    prof = {}
    for sg in (1.0, -1.0):
        s, rx = scenes.phased_tx_scene(sg * st)
        prof[sg] = sum(_energy(s, rx, use_kernel, seed) for seed in (1, 2))
    want = scenes.round_trip_bin(s, rx, scenes.phased_tx_target())
    pk = int(np.abs(prof[1.0]).argmax())
    assert abs(pk - want) <= 2, (pk, want)
    lo, hi = max(pk - 3, 0), pk + 4
    on = np.abs(prof[1.0][lo:hi]).sum()
    assert on > 0 and np.abs(prof[-1.0][lo:hi]).sum() < 0.5 * on


@pytest.mark.parametrize('use_kernel', [True, False],
                         ids=['kernel', 'wavefront'])
def test_phased_receiver_picks_its_target(use_kernel):
    """The analog phased receiver steered at either target: that target's
    echo bin peaks, and the other target's window holds < 0.5 of it."""
    tgts = scenes.phased_rx_targets()
    for i, sg in enumerate((1.0, -1.0)):
        s, rx = scenes.phased_rx_scene(sg * scenes.PHASED['rx_az'])
        p = sum(_energy(s, rx, use_kernel, seed) for seed in (1, 2))
        want = [scenes.round_trip_bin(s, rx, t) for t in tgts]
        pk = int(np.abs(p).argmax())
        assert abs(pk - want[i]) <= 2, (pk, want)
        other = int(round(want[1 - i])) + 1
        assert np.abs(p[other - 2:other + 3]).sum() \
            < 0.5 * np.abs(p[pk - 2:pk + 3]).sum()


def test_four_transmitters_echo_at_their_round_trips():
    """`four_tx_scene` through the kernel's plain version: each
    transmitter's echo peaks within 2 bins of its own round trip, in its
    own window (the echoes lie ~4.7 bins apart)."""
    s, rx = scenes.four_tx_scene()
    p = sum(_energy(s, rx, True, seed) for seed in (1, 2))
    assert np.isfinite(p).all()
    for tx in s.transmitters:
        want = scenes.round_trip_bin(s, rx, (0.0, -4.0, 0.0), tx)
        lo = int(round(want)) - 2
        pk = lo + int(np.abs(p[lo:lo + 5]).argmax())
        assert abs(pk - want) <= 2 and np.abs(p[lo:lo + 5]).sum() \
            > 0.05 * np.abs(p).max(), (tx.id, pk, want)


# ---------------------------------------------------------------------------
# 5. routing: receive(), receive_cpi(), receive_mimo()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', ['phased_tx', 'phased_rx', 'four_tx',
                                  'area'])
def test_receive_runs_the_endpoint_scenes_on_the_kernel(name, monkeypatch):
    """receive() ('auto') runs each scene through the kernel (its plain
    version here), not the wavefront, and equals the kernel's call."""
    import importlib
    receive_t = importlib.import_module('beifong_tpu_torch.receive')
    calls = []
    orig = receive_t._receive_pass
    monkeypatch.setattr(receive_t, '_receive_pass',
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    if name == 'area':
        s, rx = endpoint_scene('port', 'area')
    elif name == 'four_tx':
        s, rx = scenes.four_tx_scene()
    else:
        s, rx = getattr(scenes, name + '_scene')(10.0)
    sd = s.compile(device='cpu')
    a, n = bt.receive(s, sd, rx, spp=2048, max_depth=2, seed=3,
                      time_sampling='gate', device='cpu')
    out, n_k = rk.receive_kernel(s, sd, rx, spp=2048, seed=3, max_depth=2,
                                 time_sampling='gate', device='cpu')
    assert not calls and n == n_k == 2048
    assert torch.equal(a[..., 0], out) and float(out.abs().max()) > 0


def test_receive_cpi_of_a_phased_transmitter():
    """A CPI of the phased-transmitter scene in one launch (the plain
    version pulse by pulse here) equals one receive() a pulse."""
    s, rx = scenes.phased_tx_scene(12.7, 4)
    kw = dict(n_pulses=3, prf=10.0, seed=2, spp=1024, max_depth=2,
              time_sampling='gate', coherent=True, device='cpu')
    cube, n = bt.receive_cpi(s, engine='pallas', **kw)
    loop, m = bt.receive_cpi(s, engine='loop', **kw)
    assert cube.shape == (3, 64, 1, 4) and n == m == 1024
    assert torch.equal(cube[..., :2], loop[..., :2])
    assert float(cube[..., :2].abs().max()) > 0


@pytest.mark.parametrize('use_kernel', [True, False],
                         ids=['kernel', 'wavefront'])
def test_receive_mimo_with_two_transmitters(use_kernel):
    """Config 6's array with a second (area) transmitter: the MIMO
    configuration takes several transmitters (its endpoint twin; its
    plain version here), the wavefront's element channels too; finite,
    and the element channels nonzero."""
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry import shapes as sh
    from beifong_tpu_torch.radar import area_transmitter
    s, rx = bt.mimo_beamform_scene()
    s.add(area_transmitter('tx2', s.transmitters[0].waveform,
                           resample_freq=True))
    s.add(sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([-0.1, 0, 0], [-0.1, -1, 0]), tf.scale([0.004, 0.004,
                                                           1.0]))),
        transmitter='tx2'))
    sd = s.compile(device='cpu')
    why = []
    assert rk.supported(sd, rx, why, mimo=True), why
    adc, n = bt.receive_mimo(s, sd, rx, spp=2048, max_depth=2, seed=3,
                             time_sampling='gate', use_kernel=use_kernel,
                             device='cpu')
    assert adc.shape == (64, 1, 18) and bool(torch.isfinite(adc).all())
    assert float(adc[..., :16].abs().max()) > 0
