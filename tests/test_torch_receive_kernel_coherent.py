"""The receive kernel's coherent configuration and its LO receive types
(mix_resample, mixer, raw_resample): the plain PyTorch version against
the JAX package's Pallas megakernel (interpret mode) on identical
uniforms, on golden config 2 (`fmcw_sonar`, power), the FMCW mixer scene
of tests/test_radar.py (I / Q), a pulse of golden config 3 (I / Q, a
moving plate), the flagship (I / Q), the mesh benchmark scene (I / Q: the
coherent mesh, its BVH walks) and multi_body (I / Q: a moving GGX mesh on
a 16 x 32 time x Doppler grid); the packed tables, LO rows and mesh
tables included, bit for bit; the scope; and physics anchors of `receive()` on
the CPU.  The CUDA kernel is held against the plain version on a card by
tests/test_torch_gpu.py."""

import dataclasses as dc

import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.bsdf.tables import plastic
from beifong_tpu_torch.geometry import shapes as sh_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar.endpoints import ADCConfig

from test_torch_mesh import jax_leaves, port_band, twin_scene
from test_torch_receive_kernel_doppler import _jax_run
from test_torch_wavefront import _pkg, fmcw_sonar, multi_body

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell (power; I / Q add the phase slack)
GOLDEN = 'tests/golden/'


def fmcw_mixer(pkg: str, dR: float = 0.0):
    """tests/test_radar.py's FMCW point-target scene with a mixer receiver;
    the port's copy is `scenes.fmcw_scene('mixer')`."""
    if pkg == 'port':
        return bt.fmcw_scene('mixer', dR)
    from test_radar import _fmcw_scene
    s, rx, _ = _fmcw_scene('mixer', dR=dR)
    return s, rx


def pulse_train(pkg: str, p: int = 0):
    """Pulse `p` of golden config 3 (tests/golden/configs.py
    `pulse_train_range_doppler`), built as the config builds it; the
    port's copy is `scenes.pulse_train_scene`."""
    if pkg == 'port':
        return bt.pulse_train_scene(p)
    k = _pkg(pkg)
    r0, v, fc, prf = 4.0, 1.0625, 40e3, 400.0
    rp = r0 - v * p / prf
    s = k.sc.Scene(band=k.Band.from_freq(340.0, fc, 10e3))
    s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True))
    s.add(k.radar.wigner_transmitter('tx', k.radar.cw(f_centre=fc),
                                     resample_freq=True))
    aim = np.asarray(k.tf.compose(k.tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                  k.tf.scale([0.05, 0.05, 1.0])))
    s.add(k.sh.rectangle(to_world=aim, transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=8, n_freq=1, sampling_start=0.0,
                            sampling_time=2e-3, freq_lo=fc - 2e3,
                            freq_hi=fc + 2e3)
    rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(k.tf.compose(
        k.tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
        k.tf.scale([0.05, 0.05, 1.0])))
    s.add(k.sh.rectangle(to_world=aim_rx, receiver='rx'))
    tgt = np.asarray(k.tf.compose(k.tf.look_at([0, -rp, 0], [0, 0, 0]),
                                  k.tf.scale(0.5)))
    s.add(k.sh.rectangle(to_world=tgt, bsdf='mat',
                         velocity=np.array([0, v, 0], np.float32)))
    return s, rx


def flagship(pkg: str):
    if pkg == 'port':
        return bt.flagship_scene()
    import __graft_entry__ as g
    return g._build_scene(rx_kind='wigner')


def fmcw_sonar_scene(pkg: str):
    if pkg == 'port':
        return bt.fmcw_sonar_scene()
    return fmcw_sonar(pkg)


def mesh(pkg: str):
    """The mesh benchmark scene at n_side 9 (162 triangles), diffuse: the
    port's `scenes.mesh_scene(n_side=9)`."""
    return twin_scene(pkg)


SCENES = {'fmcw_sonar': fmcw_sonar_scene, 'mixer': fmcw_mixer,
          'pulse_train': pulse_train, 'flagship': flagship, 'mesh': mesh,
          'multi_body': multi_body}


CASES = [('fmcw_sonar', 2048, 2, 'fixed', False),
         ('mixer', 2048, 2, 'fixed', True),
         ('pulse_train', 4096, 1, 'gate', True),
         ('flagship', 2048, 2, 'gate', True),
         ('mesh', 1024, 2, 'gate', True),
         ('multi_body', 1024, 2, 'gate', True)]


@pytest.mark.parametrize('scene, n_lanes, depth, ts, coherent', CASES,
                         ids=[c[0] for c in CASES])
def test_plain_version_matches_jax_megakernel(scene, n_lanes, depth, ts,
                                              coherent):
    """Identical uniforms.  Power: 1e-4 x max|acc| per cell.  I / Q: 1e-4 x
    max(|I|, |Q|) plus, per cell, `phase_slack` (4 ulps of the longest
    path in the ADC window over the shortest wavelength, as in
    tests/test_torch_wavefront.py) times the cell's sum of amplitudes: the
    frameworks' path lengths differ in their last bits.
    Events within 1e-3."""
    s, rx = SCENES[scene]('jax')
    out_j, cnt_j, u, tab = _jax_run(s, rx, n_lanes, depth, 5, ts, coherent)
    _, rx_t = SCENES[scene]('port')
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling=ts,
              rx_kind=tab['rx_kind'], mesh=tab['mesh'], msh=tab['msh'],
              doppler=True, receive_type=rx_t.receive_type,
              has_lo=rx_t.lo_waveform is not None, coherent=coherent)
    stats = {}
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64)
    acc, n_ev = rk.receive_megakernel_ref(
        tab['params'], tab['prim'], tab['txp'], u, stats=stats,
        amp_out=amp if coherent else None, **kw)
    assert acc.shape == out_j.shape and cnt_j > 0
    scale = np.abs(out_j).max()
    assert scale > 0
    bound = TOL * scale
    if coherent:
        bound = bound + rk.phase_slack(s.band, rx.adc) \
            * amp.numpy()[..., None]
        assert stats['phase'] > 0
    err = np.abs(acc.numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the stage counts see the receive type's work
    if scene == 'fmcw_sonar':
        assert stats['lo_freq'] == n_lanes and stats['freq_draw'] == 0
        assert stats['lo_bin'] == stats['splat_2d'] > 0
    elif scene == 'mixer':
        assert stats['lo_freq'] == stats['freq_draw'] == n_lanes
        assert stats['phase_lo'] == stats['phase']
    else:
        assert stats['lo_freq'] == stats['phase_lo'] == 0
    if scene in ('mesh', 'multi_body'):
        # the walks hit the mesh; multi_body's GGX body and 2-D splat
        assert stats['mesh_hits'] > 0
        assert (stats['ggx_nee'] > 0 and stats['splat_2d'] > 0) \
            == (scene == 'multi_body')
    # the CPU wrapper is the plain version, fed the same uniforms
    acc_w, n_w = rk.receive_megakernel(tab['params'], tab['prim'],
                                       tab['txp'], n_lanes=n_lanes,
                                       uniforms=u, **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)


@pytest.mark.parametrize('scene', list(SCENES))
def test_pack_bit_identical_to_jax(scene):
    """`pack_scene` equals `_pack_scene` bit for bit, the LO rows
    params[33:42] and their float64 pivots included."""
    s_j, rx_j = SCENES[scene]('jax')
    _, rx_t = SCENES[scene]('port')
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    params, prim, txp, php, rxph, msh, *_ = pr._pack_scene(sd_j, rx_j, si)
    sd_i = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    got = rk.pack_scene(sd_i, rx_t, si)
    for name, a, b in [('params', got.params, params), ('prim', got.prim, prim),
                       ('txp', got.txp, txp), ('php', got.php, php),
                       ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    has_lo = rx_t.lo_waveform is not None
    assert bool(np.any(got.params[33:42])) == has_lo
    assert got.rx_rule == rk.rx_rule(rx_t.receive_type, has_lo)


@pytest.mark.parametrize('receive_type, has_lo, rule', [
    ('raw', False, rk.RX_RAW), ('raw', True, rk.RX_RAW),
    ('raw_resample', False, rk.RX_RAW), ('raw_resample', True, rk.RX_RAW_LO),
    ('mix_resample', True, rk.RX_MIX), ('mixer', True, rk.RX_MIXER)])
def test_scope_admits_the_receive_types(receive_type, has_lo, rule):
    s, rx = bt.fmcw_scene('mixer')
    rx = dc.replace(rx, receive_type=receive_type,
                    lo_waveform=rx.lo_waveform if has_lo else None)
    s.receivers[0] = rx
    sd = s.compile(device='cpu')
    why = []
    assert rk.supported(sd, rx, why), why
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert p.rx_rule == rule and p.doppler(rx.adc)


def _two_tx(s):
    from beifong_tpu_torch.radar import pulse, wigner_transmitter
    s.add(wigner_transmitter('tx2', pulse(f_centre=40e3, prf=10.0,
                                          pulse_len=2e-3),
                             resample_freq=True))
    s.add(sh_t.rectangle(to_world=np.diag([0.01, 0.01, 1.0, 1.0]),
                         transmitter='tx2'))


@pytest.mark.parametrize('change, needle', [
    ('polarized', 'ROADMAP B7'), ('two_tx', 'ROADMAP B6'),
    pytest.param('sphere', 'ROADMAP B1', id='sphere-ROADMAP B5'),
    ('grid', 'ROADMAP A5'),
    ('mixer_without_lo', 'without an LO')])
def test_scope_still_rejects(change, needle):
    """Coherent calls of scenes the kernel does not take raise on
    `use_kernel=True` with the ROADMAP item that lifts them: polarized
    receive, a second transmitter through an ambient medium, a plastic
    sphere (the kinds have no lobe twin; a diffuse sphere beside the
    closing plate runs the coherent prims twin), a coherent grid past the
    global accumulator's 2^20 cells, and a mixer without an LO."""
    s, rx = bt.pulse_train_scene(0)
    kw = {}
    if change == 'polarized':
        kw = dict(polarized=True)
    elif change == 'two_tx':
        # a second transmitter is in the kernel's scope since its endpoint
        # configuration; through an ambient medium it is not (no media
        # twin of that configuration)
        _two_tx(s)
        s.medium = bt.scenes.stratified_homogeneous()
    elif change == 'sphere':
        s.add(plastic('pl', twosided=True))
        s.add(sh_t.sphere(center=(2.0, -6.0, 0.0), radius=0.3, bsdf='pl'))
    elif change == 'grid':
        rx = dc.replace(rx, adc=dc.replace(rx.adc, n_time=1024,
                                           n_freq=rk.MAX_ADC_CELLS // 1024
                                           + 1))
    else:
        rx = dc.replace(rx, receive_type='mixer')
    s.receivers[0] = rx
    sd = s.compile(use_bvh=False, device='cpu')
    if change != 'polarized':
        why = []
        assert not rk.supported(sd, rx, why) and needle in why[0]
    with pytest.raises(NotImplementedError, match=needle):
        bt.receive(s, sd, rx, spp=1024, max_depth=1, use_kernel=True,
                   coherent=True, device='cpu', **kw)


def test_coherent_grid_caps():
    """I / Q cells take two floats: half the power grid's cells fit the
    block-shared grid, the global grid takes the same 2^20 cells."""
    assert rk.grid_mode(rk.MAX_SMEM_COH_CELLS, True, True) == 1
    assert rk.grid_mode(rk.MAX_SMEM_COH_CELLS + 1, True, True) == 2
    assert rk.grid_mode(rk.MAX_SMEM_COH_CELLS + 1, True) == 1
    assert 2 * rk.MAX_SMEM_COH_CELLS == rk.MAX_SMEM_CELLS


def test_raw_resample_reads_the_lo():
    """raw_resample with an LO draws no frequency: it reads the LO's chirp
    (and bins the received frequency inside its 38-42 kHz window)."""
    s, rx = bt.fmcw_scene('raw_resample')
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    t = torch.from_numpy
    stats = {}
    u = rk.philox_uniforms(2, rk.n_draws(2), 4096)
    acc, n = rk.receive_megakernel_ref(
        t(p.params), t(p.prim), t(p.txp), u, adc=rx.adc, max_depth=2,
        time_sampling='fixed', rx_kind='wigner', doppler=True,
        receive_type='raw_resample', has_lo=True, stats=stats)
    assert stats['lo_freq'] == 4096 and stats['freq_draw'] == 0
    spec = acc.sum(0).double().numpy()
    f_axis = 38e3 + (np.arange(64) + 0.5) / 64 * 4e3
    inband = (f_axis >= 39e3 - 100) & (f_axis <= 41e3 + 100)
    assert spec.sum() > 0 and spec[inband].sum() > 0.99 * spec.sum()


def _omni_cw(R):
    """tests/test_pallas_receive.py's coherent phase scene: a CW omni
    receiver at the transmitter, a 0.6 m plate R metres out."""
    from beifong_tpu_torch import scene as sc
    from beifong_tpu_torch.bsdf.tables import diffuse
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.radar import (cw, omni_receiver,
                                         wigner_transmitter)
    s = sc.Scene(band=bt.Band.from_freq(340.0, 40e3, 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    s.add(wigner_transmitter('tx', cw(f_centre=40e3), resample_freq=True))
    s.add(sh_t.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.0, 0, 0], [0.0, -1, 0]), tf.scale([0.05, 0.05, 1.0]))),
        transmitter='tx'))
    adc = ADCConfig(n_time=4, n_freq=1, sampling_start=0.0,
                    sampling_time=0.05, freq_lo=35e3, freq_hi=45e3)
    rx = omni_receiver('rx', adc, position=(0.0, 0.0, 0.0),
                       receive_type='raw')
    s.add(rx)
    s.add(sh_t.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0, -R, 0], [0, 0, 0]), tf.scale(0.3))), bsdf='mat'))
    return s, rx


def test_quarter_wavelength_shift_flips_the_phase():
    """A quarter-wavelength target shift flips the summed I / Q by pi
    (tests/test_pallas_receive.py:249-291, there in interpret mode)."""
    lam = 340.0 / 40e3
    phases = []
    for R in (4.0, 4.0 + lam / 4):
        s, rx = _omni_cw(R)
        a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1 << 14,
                          seed=3, max_depth=2, time_sampling='gate',
                          coherent=True, device='cpu')
        iq = complex(float(a[..., 0].sum()), float(a[..., 1].sum()))
        assert abs(iq) > 0
        phases.append(np.angle(iq))
    dphi = (phases[1] - phases[0]) % (2 * np.pi)
    assert dphi == pytest.approx(np.pi, abs=0.5)


def test_fmcw_sonar_beat_on_the_golden_bin():
    """Golden config 2 through the kernel's plain version: the beat
    spectrum peaks within 2 bins of the committed golden's anchor
    (slope 2R / c)."""
    meta = int(np.load(GOLDEN + 'fmcw_sonar.npz')['meta_expected_beat_bin'])
    s, rx = bt.fmcw_sonar_scene()
    a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1 << 14,
                      max_depth=2, seed=5, device='cpu')
    spec = bt.develop_signal(a, n, rx.adc).sum(0)[:, 0]
    assert bool(torch.isfinite(spec).all()) and float(spec.sum()) > 0
    assert abs(int(spec.argmax()) - meta) <= 2


def test_pulse_train_doppler_on_the_golden_bin():
    """Golden config 3: eight coherent pulses with one seed (frozen
    speckle); the slow-time FFT of the summed I / Q peaks on the golden's
    Doppler bin."""
    meta = int(np.load(GOLDEN + 'pulse_train_range_doppler.npz')[
        'meta_expected_doppler_bin'])
    iq = []
    for p in range(bt.scenes.PULSE_TRAIN['n_pulses']):
        s, rx = bt.pulse_train_scene(p)
        a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1 << 12,
                          max_depth=1, seed=11, coherent=True,
                          time_sampling='gate', device='cpu')
        assert tuple(a.shape) == (8, 1, 4)
        iq.append(complex(float(a[:, 0, 0].sum()),
                          float(a[:, 0, 1].sum())) / n)
    dop = np.abs(np.fft.fft(np.asarray(iq))) ** 2
    assert int(dop.argmax()) == meta


def test_receive_routes_coherent_and_lo_calls_to_the_kernel(monkeypatch):
    calls = []
    k = rk.receive_megakernel

    def counted(*a, **kw):
        calls.append((kw['doppler'], kw['coherent'], kw['receive_type']))
        return k(*a, **kw)
    monkeypatch.setattr(rk, 'receive_megakernel', counted)
    for fn, coh in ((bt.fmcw_sonar_scene, False),
                    (lambda: bt.fmcw_scene('mixer'), True),
                    (bt.flagship_scene, True)):
        s, rx = fn()
        a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1024,
                          max_depth=1, coherent=coh, time_sampling='gate',
                          device='cpu')
        assert a.shape == (rx.adc.n_time, rx.adc.n_freq, 4 if coh else 3)
        assert bool(torch.isfinite(a).all()) and float(a[..., 0].abs().sum()) > 0
    assert calls == [(True, False, 'mix_resample'), (True, True, 'mixer'),
                     (True, True, 'raw')]
