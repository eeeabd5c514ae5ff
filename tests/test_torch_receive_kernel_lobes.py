"""The receive kernel's lobe twins (the JAX kernel's `diel`, `thin`, `plas`,
`rplas`, `rdiel`, `has_blend` and `has_mask` configurations): its plain
PyTorch version against the JAX package's Pallas megakernel (interpret
mode) on identical uniforms, on a smooth and a thin dielectric sheet
beside a conductor plate (the delta chains through the sheet, power and
I / Q) and a rough-plastic mesh; the pack of every lobe scene bit for
bit, composites included; the draw stride; the scope and the routing.
Plastic, rough dielectric, blend and mask parity is in
tests/test_torch_receive_kernel_glass.py; the CUDA kernel is held against
the plain version on a card by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import scenes
from beifong_tpu_torch.bsdf.tables import (BLEND, DIELECTRIC, MASK,
                                           ROUGH_PLASTIC, THIN_DIELECTRIC)
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy

from test_torch_mesh import jax_leaves, port_band, twin_scene
from test_torch_receive_kernel_doppler import _jax_run
from test_torch_wavefront import _pkg

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell; I / Q add the phase slack


def _endpoints(k, s, tx_pos=(0.3, 0.0, 0.0), rx_pos=(-0.3, 0.0, 0.0),
               tx=0.05, wigner_rx=False, tx_aim=None):
    """The lobe tests' sonar in package `k`'s modules: the 2 ms pulse on a
    Wigner transmitter of half-width `tx` at tx_pos facing -y (or
    `tx_aim`), an omni (or a 50 mm Wigner) receiver at rx_pos facing -y,
    64 raw bins over 60 ms."""
    tf = k.tf
    wf = k.radar.pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
    s.add(k.radar.wigner_transmitter('tx', wf, resample_freq=True))
    aim = tx_aim or [tx_pos[0], tx_pos[1] - 1.0, tx_pos[2]]
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at(list(tx_pos), list(aim)), tf.scale([tx, tx, 1.0]))),
        transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                            sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    if wigner_rx:
        rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
        s.add(rx)
        s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
            tf.look_at(list(rx_pos), [rx_pos[0], rx_pos[1] - 1.0,
                                      rx_pos[2]]),
            tf.scale([0.05, 0.05, 1.0]))), receiver='rx'))
    else:
        rx = k.radar.omni_receiver('rx', adc, position=rx_pos,
                                   receive_type='raw')
        s.add(rx)
    return rx


def _plate(k, s, at, size, bsdf):
    s.add(k.sh.rectangle(to_world=np.asarray(k.tf.compose(
        k.tf.look_at(list(at), [0.0, 0.0, 0.0]), k.tf.scale(size))),
        bsdf=bsdf))


def sheet_plate(pkg: str, sheet: str = 'dielectric'):
    """A smooth (or thin) dielectric sheet, n = 1.5, 6 m wide and 2 m out,
    its normal facing away from the receiver (rays cross it from its dense
    side: total internal reflection past 41.8 degrees), and beyond it the
    transmitter, 4 m out and 0.5 m wide, facing the receiver: a receive ray
    refracts (thin: passes) through the sheet, leaving by its back face,
    and hits the transmitter directly at depth 1; beyond the sheet a 1.2 m
    smooth-conductor plate (a delta lobe: no NEE) and a diffuse plate
    (NEE through the sheet's refraction) take the other rays."""
    k = _pkg(pkg)
    tf = k.tf
    s = k.sc.Scene(band=k.Band.from_freq(340.0, 40e3, 10e3))
    s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True),
          k.bsdf.conductor('m', eta=0.2, k=3.0, twosided=True))
    if sheet == 'thin':
        s.add(k.bsdf.thin_dielectric('win', int_ior=1.5))
    else:
        s.add(k.bsdf.dielectric('win', int_ior=1.5,
                                specular_transmittance=1.0))
    rx = _endpoints(k, s, tx_pos=(0.3, -4.0, 0.0), tx=0.25, wigner_rx=True,
                    tx_aim=[0.3, 0.0, 0.0])
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.0, -2.0, 0.0], [0.0, -3.0, 0.0]), tf.scale(3.0))),
        bsdf='win'))
    _plate(k, s, (-1.2, -4.0, 0.5), 0.6, 'm')
    _plate(k, s, (1.5, -3.0, 0.5), 0.4, 'mat')
    return s, rx


def _window_corner(k, s, window):
    """The JAX package's test_megakernel_dielectric_window scene in
    package `k`'s modules (`scenes.window_corner_scene`)."""
    tf = k.tf
    s.add(k.bsdf.conductor('m', eta=0.2, k=3.0, twosided=True))
    wf = k.radar.pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
    s.add(k.radar.wigner_transmitter('tx', wf, resample_freq=True))
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.0, 0, 0], [0.0, -1, 0]), tf.scale([0.8, 0.8, 1.0]))),
        transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                            sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    rx_pos = np.array([0.0, -0.1, 0.0])
    apex = np.array([0.0, -4.0, 0.0])
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at(rx_pos, apex), tf.scale([0.02, 0.02, 1.0]))),
        receiver='rx'))
    for f in k.sh.trihedral(apex, rx_pos - apex, bsdf='m'):
        s.add(f)
    s.add(k.bsdf.thin_dielectric('win', int_ior=1.5) if window == 'thin'
          else k.bsdf.dielectric('win', int_ior=1.5,
                                 specular_transmittance=1.0))
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.0, -2.0, 0], [0, 0, 0]), tf.scale(2.0))), bsdf='win'))
    return s, rx


def lobe_scene(pkg: str, name: str):
    """The JAX package's lobe kernel tests' scenes (`scenes.py` holds the
    port's copies): 'window_thin', 'window_dielectric', 'plastic',
    'rough_plastic', 'target' and 'through' (GGX glass), 'blend',
    'mask_0.8' and 'mask_0.4', built with either package."""
    if pkg == 'port':
        if name.startswith('window_'):
            return scenes.window_corner_scene(name[len('window_'):])
        if name in ('plastic', 'rough_plastic'):
            return scenes.plastic_scene(name)
        if name in ('target', 'through'):
            return scenes.rough_dielectric_scene(name)
        if name == 'blend':
            return scenes.composite_scene('blend')
        return scenes.composite_scene('mask', float(name[len('mask_'):]))
    k = _pkg(pkg)
    b = k.bsdf
    s = k.sc.Scene(band=k.Band.from_freq(340.0, 40e3, 10e3))
    if name.startswith('window_'):
        return _window_corner(k, s, name[len('window_'):])
    if name in ('plastic', 'rough_plastic'):
        s.add(b.plastic('mat', diffuse_reflectance=0.8, int_ior=1.49,
                        twosided=True) if name == 'plastic'
              else b.rough_plastic('mat', diffuse_reflectance=0.8,
                                   alpha=0.4, int_ior=1.49, twosided=True))
        rx = _endpoints(k, s)
        _plate(k, s, (0.0, -4.0, 0.0), 0.5, 'mat')
    elif name == 'target':
        s.add(b.rough_dielectric('mat', alpha=0.4, int_ior=1.5))
        rx = _endpoints(k, s)
        _plate(k, s, (0.0, -4.0, 0.0), 0.5, 'mat')
    elif name == 'through':
        s.add(b.rough_dielectric('mat', alpha=0.4, int_ior=1.5))
        rx = _endpoints(k, s, tx_pos=(0.0, 0.0, 0.0),
                        rx_pos=(0.0, -4.0, 0.0))
        _plate(k, s, (0.0, -2.0, 0.0), 1.0, 'mat')
    else:
        s.add(b.diffuse('d0', reflectance=1.0, twosided=True))
        if name == 'blend':
            s.add(b.rough_conductor('m1', alpha=0.3, eta=0.2, k=3.0,
                                    twosided=True),
                  b.blend('mat', 'd0', 'm1', weight=0.6))
        else:
            s.add(b.mask('mat', 'd0', opacity=float(name[len('mask_'):])))
        rx = _endpoints(k, s)
        _plate(k, s, (0.0, -4.0, 0.0), 0.5, 'mat')
    return s, rx


def rough_plastic_mesh(pkg: str):
    """The mesh benchmark scene with the rough plastic on its wavy mesh
    (`scenes.mesh_scene(material='rough_plastic')` at n_side 71)."""
    return twin_scene(pkg, mesh_bsdf='rough_plastic')


def parity(s, rx, n_lanes, depth, coherent=False):
    """The plain version against `_run(interpret=True)` on the uniforms it
    drew (of the lobe draw stride): power to TOL x max|acc| per cell, I /
    Q plus the phase slack times the cell's amplitude sum, events within
    1e-3; the CPU wrapper is the plain version.  Returns the stage
    counts."""
    out_j, cnt_j, u, tab = _jax_run(s, rx, n_lanes, depth, 3, 'gate',
                                    coherent)
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling='gate',
              rx_kind=tab['rx_kind'], mesh=tab['mesh'], msh=tab['msh'],
              doppler=True, coherent=coherent)
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
    err = np.abs(acc.numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    acc_w, n_w = rk.receive_megakernel(tab['params'], tab['prim'],
                                       tab['txp'], n_lanes=n_lanes,
                                       uniforms=u, **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)
    return stats


@pytest.mark.parametrize('sheet, coherent', [
    ('dielectric', False), ('dielectric', True), ('thin', False)],
    ids=['dielectric-power', 'dielectric-iq', 'thin-power'])
def test_sheet_over_plate_matches_jax_megakernel(sheet, coherent):
    """The delta chains through a dielectric sheet at depth 2: refracted
    (thin: passed) rays leave through the back face and hit the
    transmitter directly or reflect off the conductor; the sheet's
    Fresnel picks by the bounce draw u8."""
    s, rx = sheet_plate('jax', sheet)
    stats = parity(s, rx, 4096, 2, coherent)
    assert stats['diel_bounce'] > 0 and stats['direct'] > 0
    assert stats['nee_splat'] > 0


def _rough_plastic_mesh_parity(coherent: bool):
    s, rx = rough_plastic_mesh('jax')
    stats = parity(s, rx, 1024, 2, coherent)
    assert stats['rplas_nee'] > 0 and stats['rplas_bounce'] > 0
    assert stats['mesh_hits'] > 0
    assert (stats['phase'] > 0) == coherent


def test_rough_plastic_mesh_matches_jax_megakernel():
    """The rough plastic on the mesh's shape rows: the lobe twin's mesh
    form, its type and parameters read from the mesh-shape row."""
    _rough_plastic_mesh_parity(False)


def test_rough_plastic_mesh_iq_matches_jax_megakernel():
    """The same mesh lobe twin in I / Q: the echo phase of each connection
    through the mesh's rough plastic."""
    _rough_plastic_mesh_parity(True)


PACK_SCENES = ('window_thin', 'window_dielectric', 'plastic',
               'rough_plastic', 'target', 'through', 'blend', 'mask_0.4',
               'mesh')


@pytest.mark.parametrize('name', PACK_SCENES)
def test_pack_bit_identical_to_jax(name):
    """`interop` carries the JAX scene over; the port's pack of its own
    scene (`scenes.py`) and of the carried one equal `_pack_scene` bit for
    bit, the composites' columns 27-33 and the mesh-shape rows
    included."""
    if name == 'mesh':
        s_j, rx_j = rough_plastic_mesh('jax')
        s_t, rx_t = scenes.mesh_scene(n_side=9, material='rough_plastic')
    else:
        s_j, rx_j = lobe_scene('jax', name)
        s_t, rx_t = lobe_scene('port', name)
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    (params, prim, txp, php, rxph, msh, mesh_types, _, _,
     mesh_pack) = pr._pack_scene(sd_j, rx_j, si)
    sd_i = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    assert pr.supported(sd_j, rx_j) and rk.supported(sd_i, rx_t)
    # the carried scene bit for bit; the port's own within 4 ulps (both
    # packages round look_at, compose and the inverse in float32)
    for sd, ulps in ((sd_i, 0), (s_t.compile(device='cpu'), 4)):
        got = rk.pack_scene(sd, rx_t, si)
        pairs = [('params', got.params, params), ('prim', got.prim, prim),
                 ('txp', got.txp, txp), ('php', got.php, php),
                 ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]
        if mesh_pack is not None:
            pairs.append(('leaves', got.mesh.leaves.numpy(),
                          mesh_pack.leaves))
            assert mesh_types == tuple(int(r[6]) for r in got.msh)
        for what, a, b in pairs:
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, what
            if ulps:
                np.testing.assert_array_max_ulp(a, b, maxulp=ulps)
            else:
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32),
                                              err_msg=what)
        # the lobe columns (types, mix codes, lobe parameters) exactly
        np.testing.assert_array_equal(got.prim[:, 13:34], prim[:, 13:34])
        assert got.lobes and got.doppler(rx_t.adc)
    types = set(prim[:, [18, 28]].reshape(-1).tolist()) | set(mesh_types)
    if name == 'blend':
        assert prim[-1, 27] == 1.0 and prim[-1, 33] == np.float32(0.6)
    elif name == 'mask_0.4':
        assert prim[-1, 27] == 2.0 and prim[-1, 29] == 0.0
    elif name.startswith('window'):
        assert {DIELECTRIC, THIN_DIELECTRIC} & types
    elif name == 'mesh':
        assert ROUGH_PLASTIC in mesh_types


@pytest.mark.parametrize('lobe_mix', [False, True])
@pytest.mark.parametrize('blend_mix', [False, True])
def test_draws_follow_the_jax_layout(lobe_mix, blend_mix):
    """n_draws = 8 + ((4 if lobe_mix else 3) + blend_mix + 3 n_tx) depth,
    the JAX package's count (pallas_receive.py:2893-2899), and the flags of
    the tables pick the pair."""
    for depth in (1, 2, 6):
        for n_tx in (1, 2, 4):
            assert rk.n_draws(depth, n_tx, lobe_mix, blend_mix) \
                == pr.n_draws(depth, n_tx, lobe_mix, blend_mix)
    flags = (rk.LOBE_RPLAS if lobe_mix else 0) \
        | (rk.LOBE_BLEND if blend_mix else 0)
    assert rk.lobe_draws(flags) == dict(lobe_mix=lobe_mix,
                                        blend_mix=blend_mix)


def test_lobe_flags_of_the_tables():
    """Each lobe scene's pack raises its own flags: the window's delta
    lobes draw no lobe pick, the plastics and GGX glass one, a composite a
    mix pick; a mask also marks the pass."""
    want = {'window_thin': rk.LOBE_THIN, 'window_dielectric': rk.LOBE_DIEL,
            'plastic': rk.LOBE_PLAS, 'rough_plastic': rk.LOBE_RPLAS,
            'through': rk.LOBE_RDIEL, 'blend': rk.LOBE_BLEND,
            'mask_0.8': rk.LOBE_BLEND | rk.LOBE_MASK}
    for name, flags in want.items():
        s, rx = lobe_scene('port', name)
        p = rk.pack_scene(s.compile(device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
        assert p.lobes == flags, name
    s, rx = scenes.mesh_scene(n_side=3, material='rough_plastic')
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    assert p.lobes == rk.LOBE_RPLAS and not p.mirror
    # a flagship scene packs none, and the rows keep their second-lobe
    # columns a plain copy of the first
    s, rx = bt.flagship_scene()
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    assert p.lobes == 0 and not (p.prim[:, 27] != 0).any()


def test_receive_routes_lobe_scenes_to_the_lobe_twins(monkeypatch):
    """A static lobe scene runs K1's Doppler family with its lobe flags
    (the coherent one with coherent=True), the rough-plastic mesh its
    mesh form, and the windowed corner's CPI the CPI launch: the flags
    come from the host's pack, never from the card."""
    calls = []
    k, kc = rk.receive_megakernel, rk.receive_megakernel_cpi

    def counted(*a, **kw):
        calls.append((kw['doppler'], kw['coherent'], kw['lobes'],
                      kw['mesh'] is not None))
        return k(*a, **kw)

    def counted_cpi(*a, **kw):
        calls.append(('cpi', kw['coherent'], kw['lobes']))
        return kc(*a, **kw)
    monkeypatch.setattr(rk, 'receive_megakernel', counted)
    monkeypatch.setattr(rk, 'receive_megakernel_cpi', counted_cpi)
    for coh in (False, True):
        s, rx = lobe_scene('port', 'plastic')
        a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1024,
                          max_depth=2, coherent=coh, time_sampling='gate',
                          device='cpu')
        assert bool(torch.isfinite(a).all())
    s, rx = scenes.mesh_scene(n_side=3, material='rough_plastic')
    bt.receive(s, s.compile(device='cpu'), rx, spp=1024, max_depth=2,
               device='cpu')
    s, rx = scenes.window_corner_scene('thin')
    cube, _ = bt.receive_cpi(s, n_pulses=2, prf=10.0, spp=256, max_depth=6,
                             device='cpu')
    assert cube.shape == (2, 64, 1, 4)
    assert calls == [(True, False, rk.LOBE_PLAS, False),
                     (True, True, rk.LOBE_PLAS, False),
                     (True, False, rk.LOBE_RPLAS, True),
                     ('cpi', True, rk.LOBE_THIN)]


@pytest.mark.parametrize('change', ['medium', 'two_tx', 'phased_tx',
                                    'mimo'])
def test_lobes_with_media_endpoints_or_mimo_run_the_wavefront(change):
    """The lobe twins run in vacuum with one Wigner transmitter and no
    MIMO: a plastic plate through a medium, beside a second or a phased
    transmitter, or under MIMO receive is outside the kernel's scope with
    a reason naming B5, and receive() runs the wavefront."""
    from beifong_tpu_torch import media
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry import shapes as sh
    from beifong_tpu_torch.radar import (phased_receiver,
                                         phased_transmitter, pulse,
                                         wigner_transmitter)
    s, rx = lobe_scene('port', 'plastic')
    mimo = change == 'mimo'
    if change == 'medium':
        s.medium = media.HomogeneousMedium.make(sigma_t=0.01)
    elif change in ('two_tx', 'phased_tx'):
        wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                   is_delta=True)
        s.add(phased_transmitter('tx2', wf, n_elems=2, elem_spacing=0.0043,
                                 elem_wid=(0.002, 0.002), resample_freq=True)
              if change == 'phased_tx'
              else wigner_transmitter('tx2', wf, resample_freq=True))
        s.add(sh.rectangle(to_world=np.asarray(tf.compose(
            tf.look_at([0.6, 0, 0], [0.6, -1, 0]),
            tf.scale([0.05, 0.05, 1.0]))), transmitter='tx2'))
    else:
        rx = phased_receiver('rxa', rx.adc, n_elems=2, elem_spacing=0.0043,
                             elem_wid=(0.002, 0.002), receive_type='raw')
        s.receivers = [rx]
        s.add(sh.rectangle(to_world=np.asarray(tf.compose(
            tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
            tf.scale([0.01, 0.01, 1.0]))), receiver='rxa'))
    sd = s.compile(device='cpu')
    why = []
    assert not rk.supported(sd, rx, why, mimo=mimo)
    assert 'B5' in why[0] and 'wavefront' in why[0]
    with pytest.raises(NotImplementedError, match='B5'):
        (bt.receive_mimo if mimo else bt.receive)(
            s, sd, rx, spp=256, max_depth=1, use_kernel=True, device='cpu')
    calls = []
    import importlib
    rv = importlib.import_module('beifong_tpu_torch.receive')
    name = '_receive_mimo_pass' if mimo else '_receive_pass'
    orig = getattr(rv, name)

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    try:
        setattr(rv, name, counted)
        a, n = (bt.receive_mimo if mimo else bt.receive)(
            s, sd, rx, spp=256, max_depth=1, device='cpu')
    finally:
        setattr(rv, name, orig)
    assert calls and bool(torch.isfinite(a).all())


def test_composite_and_lobe_mesh_scope():
    """One level of blend / mask over the base lobes on rectangles is in
    scope; a blend of a composite, or a composite on a mesh, is not, in
    either package."""
    s, rx = lobe_scene('port', 'blend')
    assert rk.supported(s.compile(device='cpu'), rx)
    from beifong_tpu_torch.bsdf.tables import mask
    s.add(mask('m2', 'mat', opacity=0.5))
    s.shapes[-1].bsdf = 'm2'
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why)
    assert 'one level' in why[0]
    sd = s.compile(device='cpu')
    assert int(sd.bsdfs.type[sd.shapes.bsdf_idx[-1]]) == MASK
    assert BLEND in set(sd.bsdfs.present)
    s, rx = twin_scene('port', mesh_bsdf='masked')
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why)
    assert 'triangle-mesh' in why[0]
