"""The receive kernel's mirror chains (smooth conductors, the JAX kernel's
`mirror` / `delta_any` flags): its plain PyTorch version against the JAX
package's Pallas megakernel (interpret mode) on identical uniforms, on a
smooth-conductor plate that folds the transmitter onto the receiver (a
direct transmitter hit at depth 1 on a lane the mirror continued), power
and I / Q, and on a wavy conductor mesh; the conductor rows of the pack
bit for bit (golden config 4's trihedral of mirrors among them); the
scope and the routing.  The CUDA kernel is held against the plain version
on a card by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.bsdf.tables import CONDUCTOR
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy

from test_torch_cpi import corner
from test_torch_mesh import jax_leaves, port_band, twin_scene
from test_torch_receive_kernel_doppler import _jax_run
from test_torch_wavefront import _pkg

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell; I / Q add the phase slack


def mirror_plate(pkg: str, coherent: bool = False):
    """The flagship's apertures (the transmitter's widened to 0.5 m, so
    that many mirrored rays land on it) and a 1.2 m smooth-conductor plate
    4 m out facing them: a receive ray that meets the plate reflects onto
    the transmitter, a direct hit at depth 1 after a mirror bounce.  A
    diffuse plate beside it keeps NEE in the picture."""
    k = _pkg(pkg)
    tf = k.tf
    s = k.sc.Scene(band=k.Band.from_freq(340.0, 40e3, 10e3))
    s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True),
          k.bsdf.conductor('m', eta=0.2, k=3.0, twosided=True))
    wf = k.radar.pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
    s.add(k.radar.wigner_transmitter('tx', wf, resample_freq=True))
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.3, 0, 0], [0.3, -1, 0]), tf.scale([0.25, 0.25, 1.0]))),
        transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                            sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
        tf.scale([0.05, 0.05, 1.0]))), receiver='rx'))
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([0.0, -4.0, 0.0], [0.0, 0.0, 0.0]), tf.scale(0.6))),
        bsdf='m'))
    s.add(k.sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([1.5, -3.0, 0.5], [0.0, 0.0, 0.0]), tf.scale(0.4))),
        bsdf='mat'))
    return s, rx


def mirror_mesh(pkg: str):
    """The mesh benchmark scene with a smooth conductor on its wavy mesh."""
    return twin_scene(pkg, mesh_bsdf='metal')


SCENES = {'plate': mirror_plate, 'mesh': mirror_mesh, 'corner': corner}

CASES = [('plate', 1024, 2, False), ('plate', 2048, 2, True),
         ('mesh', 1024, 2, False)]


@pytest.mark.parametrize('scene, n_lanes, depth, coherent', CASES,
                         ids=['plate-power', 'plate-iq', 'mesh-power'])
def test_plain_version_matches_jax_megakernel(scene, n_lanes, depth,
                                              coherent):
    """Gate sampling, identical uniforms.  Power: 1e-4 x max|acc| per
    cell; I / Q add the phase slack times the cell's sum of amplitudes;
    events within 1e-3.  The stage counts show the mirror bounces and the
    direct hits they lead to."""
    s, rx = SCENES[scene]('jax')
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
    assert stats['mirror_bounce'] > 0
    if scene == 'plate':
        # the receiver does not see the transmitter: every direct hit
        # follows a mirror bounce; the diffuse plate still connects by NEE
        assert stats['direct'] > 0 and stats['nee_splat'] > 0
    # the CPU wrapper is the plain version, fed the same uniforms
    acc_w, n_w = rk.receive_megakernel(tab['params'], tab['prim'],
                                       tab['txp'], n_lanes=n_lanes,
                                       uniforms=u, **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)


def test_mirror_chain_is_the_only_echo_of_a_lone_mirror():
    """Without the mirror chains the plate's echo is lost: no NEE leaves a
    mirror, so every power in the grid comes from direct hits after mirror
    bounces, and a diffuse lobe in the mirror's place gives another
    answer."""
    s, rx = mirror_plate('port')
    del s.shapes[-1]                       # the diffuse plate
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert p.mirror and not p.moving and p.doppler(rx.adc)
    t = torch.from_numpy
    u = rk.philox_uniforms(9, rk.n_draws(2), 4096)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=True)
    stats = {}
    acc, n = rk.receive_megakernel_ref(t(p.params), t(p.prim), t(p.txp), u,
                                       stats=stats, **kw)
    assert float(acc.sum()) > 0 and stats['nee_splat'] == 0
    assert stats['direct'] == int(n) > 0
    # the round trip by the mirror: 8 m at c = 340 m/s, bin ~8.5 of 64
    prof = acc[:, 0].double().numpy()
    assert abs(int(prof.argmax()) - (8.0 / 340.0 / 0.06 * 64 - 0.5)) <= 2
    # the flagship configuration reads no lobe: the plate turns diffuse
    a2, _ = rk.receive_megakernel_ref(t(p.params), t(p.prim), t(p.txp), u,
                                      **dict(kw, doppler=False))
    assert not torch.equal(a2, acc)


@pytest.mark.parametrize('scene', list(SCENES))
def test_pack_bit_identical_to_jax(scene):
    """`interop` carries the JAX scene over; the port's pack, with the
    conductor's type, eta and k in its prim rows (and mesh-shape rows),
    equals `_pack_scene` bit for bit."""
    s_j, rx_j = SCENES[scene]('jax')
    _, rx_t = SCENES[scene]('port')
    if scene == 'corner':
        s_j = s_j.at_time(0.09)
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    (params, prim, txp, php, rxph, msh, mesh_types, _, _,
     mesh_pack) = pr._pack_scene(sd_j, rx_j, si)
    sd_i = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    assert pr.supported(sd_j, rx_j) and rk.supported(sd_i, rx_t)
    got = rk.pack_scene(sd_i, rx_t, si)
    pairs = [('params', got.params, params), ('prim', got.prim, prim),
             ('txp', got.txp, txp), ('php', got.php, php),
             ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]
    if mesh_pack is not None:
        pairs.append(('leaves', got.mesh.leaves.numpy(), mesh_pack.leaves))
        assert mesh_types == tuple(int(r[6]) for r in got.msh)
    for name, a, b in pairs:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert got.mirror
    rows = got.msh if scene == 'mesh' else got.prim
    col = 6 if scene == 'mesh' else 18
    m = rows[rows[:, col] == CONDUCTOR]
    assert len(m) == (3 if scene == 'corner' else 1)
    e, k = (4, 5) if scene == 'mesh' else (16, 17)
    np.testing.assert_array_equal(m[:, [e, k]], np.float32([[0.2, 3.0]])
                                  .repeat(len(m), 0))


def test_draws_stay_eight_plus_six_per_depth():
    """A smooth conductor is no lobe mixture: it draws nothing of its own
    (the JAX package's count, pallas_receive.py:2893-2899)."""
    assert all(rk.n_draws(d) == pr.n_draws(d) == 8 + 6 * d
               for d in range(1, 6))


def test_receive_routes_mirrors_to_the_doppler_family(monkeypatch):
    """A static scene with a mirror runs K1's Doppler configuration (its
    coherent one with coherent=True), told that the tables hold a mirror;
    golden config 4's corner does too."""
    calls = []
    k = rk.receive_megakernel

    def counted(*a, **kw):
        calls.append((kw['doppler'], kw['coherent'], kw['mirror']))
        return k(*a, **kw)
    monkeypatch.setattr(rk, 'receive_megakernel', counted)
    s, rx = mirror_plate('port')
    for coh in (False, True):
        a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1024,
                          max_depth=2, coherent=coh, time_sampling='gate',
                          device='cpu')
        assert bool(torch.isfinite(a).all())
        assert float(a[..., 0].abs().sum()) > 0
    s, rx = bt.corner_scene()
    snap = s.at_time(0.0)
    bt.receive(snap, snap.compile(device='cpu'), rx, spp=256, max_depth=4,
               coherent=True, device='cpu')
    assert calls == [(True, False, True), (True, True, True),
                     (True, True, True)]
