"""The receive kernel's Doppler configuration (the Doppler chain, time x
frequency and wide fast-time grids, the GGX rough conductor): its plain
PyTorch version against the JAX package's Pallas megakernel (interpret
mode) on identical uniforms, on the multi_body scene (meshes, one of them
a moving rough conductor), on a pulse of the range-Doppler example (a
moving rectangle) and on a 1024-bin fast-time grid; the packed tables
bit for bit; the scope; and the Doppler anchors of `receive()` on the
CPU.  The CUDA kernel is held against the plain version on a card by
tests/test_torch_gpu.py."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.geometry import shapes as sh_t
from beifong_tpu_torch.geometry.bvh_kernel import PackedBVH
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar.endpoints import ADCConfig

from test_torch_mesh import jax_leaves, port_band
from test_torch_wavefront import _pkg, multi_body

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell; relative 1e-3 on the event counts


def range_doppler(pkg: str, p: int = 0):
    """Pulse `p` of `examples/range_doppler.py`, built as the example
    builds it; the port's copy is `scenes.range_doppler_scene`."""
    if pkg == 'port':
        return bt.range_doppler_scene(p)
    k = _pkg(pkg)
    r0, v, prf, fc = 4.0, 5.0, 20.0, 40e3
    rp = r0 - v * p / prf
    s = k.sc.Scene(band=k.Band.from_freq(340.0, fc, 10e3))
    s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True))
    s.add(k.radar.wigner_transmitter('tx', k.radar.cw(f_centre=fc),
                                     resample_freq=True))
    aim = np.asarray(k.tf.compose(k.tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                  k.tf.scale([0.05, 0.05, 1.0])))
    s.add(k.sh.rectangle(to_world=aim, transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=8, n_freq=128, sampling_start=0.0,
                            sampling_time=0.04, freq_lo=fc - 2e3,
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


def wide_flagship(pkg: str):
    """The flagship scene on a 1024-bin fast-time ADC (the JAX kernel's
    factorized wide splat; the port's block-shared grid)."""
    if pkg == 'port':
        s, rx = bt.flagship_scene()
    else:
        import __graft_entry__ as g
        s, rx = g._build_scene(rx_kind='wigner')
    rx = dc.replace(rx, adc=dc.replace(rx.adc, n_time=1024))
    s.receivers[0] = rx
    return s, rx


SCENES = {'multi_body': multi_body, 'range_doppler': range_doppler,
          'wide_1d': wide_flagship}


def _jax_run(s, rx, n_lanes, max_depth, seed, time_sampling='gate',
             coherent=False):
    """`_run(interpret=True)` called as `receive_pallas` calls it, plus
    the uniforms it drew as (n_draws, n_lanes) with lane = (tile * 8 +
    row) * 128 + col, and its tables as the port's tensors.  The output
    is power, or (n_time, n_freq, 2) I / Q with `coherent`."""
    sd = s.compile(use_bvh=False)
    why = []
    assert pr.supported(sd, rx, why), why
    si = s.shape_index_of_endpoint('receiver', rx.id)
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     mesh_pack) = pr._pack_scene(sd, rx, si)
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    moving = bool(np.abs(prim[:, 19:22]).max() > 0.0
                  or np.abs(txp[:, 24:27]).max() > 0.0
                  or np.abs(params[23:26]).max() > 0.0
                  or np.abs(msh[:, 0:3]).max() > 0.0)
    mesh_kw = {} if mesh_pack is None else dict(
        bvh_bbox=mesh_pack.bbox, bvh_links=mesh_pack.links,
        bvh_leaves=mesh_pack.leaves)
    rx_kind = 'omni' if si < 0 else 'wigner'
    out, out_q, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx.adc, rx.receive_type, time_sampling, max_depth, rx_kind, n_lanes,
        True, coherent, has_mesh=mesh_pack is not None,
        mesh_types=mesh_types, moving=moving, absorbing=False,
        tx_kinds=tuple(int(f) for f in txp[:, 27]),
        has_lo=rx.lo_waveform is not None,
        polarized=False, bmp_meta=bmp_meta, layered=0, tex=jnp.asarray(tex),
        msh=jnp.asarray(msh), mimo_e=0, eoff=None,
        grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]), **mesh_kw)
    # the draw stride of the table's lobes (plastics and GGX glass draw a
    # lobe pick a bounce, composites a lobe-mix pick)
    lobes = rk.lobe_flags(prim, msh if mesh_pack is not None else None)
    nd = pr.n_draws(max_depth, **rk.lobe_draws(lobes))
    assert nd == rk.n_draws(max_depth, **rk.lobe_draws(lobes))
    n_tiles = n_lanes // (8 * 128)
    u = jax.random.uniform(jax.random.key(seed), (n_tiles, nd, 8, 128),
                           dtype=jnp.float32)
    u = np.asarray(u).transpose(1, 0, 2, 3).reshape(nd, n_lanes)
    mesh = None if mesh_pack is None else PackedBVH(
        *(torch.tensor(np.asarray(x)) for x in (
            mesh_pack.bbox, mesh_pack.links, mesh_pack.leaves)),
        n_nodes=mesh_pack.n_nodes, n_leaves=mesh_pack.n_leaves,
        stride=mesh_pack.stride)
    adc = ADCConfig(**{f.name: getattr(rx.adc, f.name)
                       for f in dc.fields(ADCConfig)})
    t = torch.tensor
    tables = dict(params=t(params), prim=t(prim), txp=t(txp),
                  msh=None if mesh is None else t(msh), mesh=mesh,
                  rx_kind=rx_kind, adc=adc)
    out = np.stack([out, out_q], -1) if coherent else np.asarray(out)
    return out, float(np.asarray(cnt)[0, 0]), t(u), tables


@pytest.mark.parametrize('scene, n_lanes, seed', [
    ('multi_body', 1024, 3), ('range_doppler', 2048, 5),
    ('wide_1d', 1024, 2)])
def test_plain_version_matches_jax_megakernel(scene, n_lanes, seed):
    """Depth 2, gate sampling, identical uniforms.  The frameworks sum in
    another order and XLA-CPU's exp / log / rsqrt may differ from torch's
    by an ulp: hence 1e-4 x max|acc| per cell and 0.1% on the events (as
    for the flagship and mesh configurations)."""
    s, rx = SCENES[scene]('jax')
    out_j, cnt_j, u, tab = _jax_run(s, rx, n_lanes, 2, seed)
    assert out_j.shape == (rx.adc.n_time, rx.adc.n_freq)
    stats = {}
    kw = dict(adc=tab['adc'], max_depth=2, time_sampling='gate',
              rx_kind=tab['rx_kind'], mesh=tab['mesh'], msh=tab['msh'],
              doppler=True)
    acc, n_ev = rk.receive_megakernel_ref(tab['params'], tab['prim'],
                                          tab['txp'], u, stats=stats, **kw)
    assert acc.shape == out_j.shape and cnt_j > 0
    scale = np.abs(out_j).max()
    assert scale > 0
    np.testing.assert_allclose(acc.numpy(), out_j, rtol=0, atol=TOL * scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the stage counts see the configuration's work
    if scene == 'multi_body':
        assert stats['mesh_hits'] > 0 and stats['ggx_nee'] > 0
        assert stats['ggx_bounce'] > 0 and stats['dop_nee'] > 0
        assert stats['freq_draw'] == n_lanes and stats['splat_2d'] > 0
    elif scene == 'range_doppler':
        assert stats['dop_nee'] > 0 and stats['ggx_nee'] == 0
    else:
        assert stats['freq_draw'] == stats['splat_2d'] == 0
        assert stats['dop_nee'] == stats['ggx_nee'] == 0
    # the CPU wrapper is the plain version, fed the same uniforms
    lane = torch.empty(n_lanes)
    acc_w, n_w = rk.receive_megakernel(tab['params'], tab['prim'],
                                       tab['txp'], n_lanes=n_lanes,
                                       uniforms=u, lane_out=lane, **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)
    assert float(lane.sum()) > 0


def test_static_scene_is_unchanged_by_the_doppler_configuration():
    """A static diffuse scene gives the flagship configuration's answer,
    bit for bit, through the Doppler configuration's plain version."""
    s, rx = bt.flagship_scene()
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert not p.doppler(rx.adc)
    t = torch.from_numpy
    u = rk.philox_uniforms(4, rk.n_draws(2), 2048)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner')
    a, n = rk.receive_megakernel_ref(t(p.params), t(p.prim), t(p.txp), u,
                                     **kw)
    b, m = rk.receive_megakernel_ref(t(p.params), t(p.prim), t(p.txp), u,
                                     doppler=True, **kw)
    assert torch.equal(a, b) and int(n) == int(m) and a.shape == (64, 1)


@pytest.mark.parametrize('scene', ['multi_body', 'range_doppler'])
def test_pack_bit_identical_to_jax(scene):
    """`interop` carries the JAX scene over; the port's pack (GGX and
    velocity prim columns, transmitter and receiver velocities, mesh-shape
    rows, the BVH with its payloads) equals `_pack_scene` bit for bit, and
    the port's own scene packs to the same prim, transmitter and shape
    rows."""
    s_j, rx_j = SCENES[scene]('jax')
    s_t, rx_t = SCENES[scene]('port')
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    assert si == s_t.shape_index_of_endpoint('receiver', rx_t.id)
    (params, prim, txp, php, rxph, msh, mesh_types, _, _,
     mesh_pack) = pr._pack_scene(sd_j, rx_j, si)
    sd_i = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    got = rk.pack_scene(sd_i, rx_t, si)
    pairs = [('params', got.params, params), ('prim', got.prim, prim),
             ('txp', got.txp, txp), ('php', got.php, php),
             ('rxph', got.rxph, rxph), ('msh', got.msh, msh)]
    if mesh_pack is not None:
        pairs += [('bbox', got.mesh.bbox.numpy(), mesh_pack.bbox),
                  ('links', got.mesh.links.numpy(), mesh_pack.links),
                  ('leaves', got.mesh.leaves.numpy(), mesh_pack.leaves)]
        assert mesh_types == tuple(int(r[6]) for r in got.msh)
    for name, a, b in pairs:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert got.moving and got.doppler(rx_t.adc)
    assert got.ggx == (scene == 'multi_body')
    own = rk.pack_scene(s_t.compile(use_bvh=False, device='cpu'), rx_t, si)
    np.testing.assert_array_equal(own.msh, got.msh)
    np.testing.assert_array_equal(own.txp, got.txp)
    np.testing.assert_array_equal(own.prim[:, 13:22], got.prim[:, 13:22])


def test_scope_admits_both_scenes():
    for fn in (bt.multi_body_scene, bt.range_doppler_scene):
        s, rx = fn()
        why = []
        assert rk.supported(s.compile(device='cpu'), rx, why), why


def _with_sphere(s):
    s.add(sh_t.sphere(center=(2.0, -6.0, 0.0), radius=0.3, bsdf='hull'))
    return s


@pytest.mark.parametrize('change, needle', [
    # coherent I / Q is in the kernel's scope: the case holds a coherent
    # grid past the global accumulator's cells (the ids are the cases')
    pytest.param('coherent', 'ROADMAP A5', id='coherent-ROADMAP B3'),
    ('two_tx', 'ROADMAP B6'),
    pytest.param('sphere', 'ROADMAP B1', id='sphere-ROADMAP B5'),
    ('n_freq', 'n_freq')])
def test_scope_still_rejects(change, needle):
    """A coherent grid past the caps, a second transmitter through an
    ambient medium, a sphere in K1 and a grid past the bin caps stay
    outside the kernel, and
    `use_kernel=True` raises with the ROADMAP item that lifts them."""
    s, rx = bt.multi_body_scene()
    kw = {}
    if change == 'coherent':
        kw = dict(coherent=True)
        rx = dc.replace(rx, adc=dc.replace(
            rx.adc, n_time=1024, n_freq=rk.MAX_ADC_CELLS // 1024 + 1))
        s.receivers[0] = rx
    elif change == 'two_tx':
        # a second transmitter is in the kernel's scope since its endpoint
        # configuration; through an ambient medium it is not (no media
        # twin of that configuration)
        from beifong_tpu_torch.radar import pulse, wigner_transmitter
        s.add(wigner_transmitter('tx2', pulse(f_centre=40e3, prf=10.0,
                                              pulse_len=2e-3),
                                 resample_freq=True))
        s.add(sh_t.rectangle(to_world=np.diag([0.01, 0.01, 1.0, 1.0]),
                             transmitter='tx2'))
        s.medium = bt.scenes.stratified_homogeneous()
    elif change == 'sphere':
        _with_sphere(s)
    else:
        rx = dc.replace(rx, adc=dc.replace(rx.adc,
                                           n_freq=rk.MAX_N_FREQ + 1))
        s.receivers[0] = rx
    sd = s.compile(use_bvh=False, device='cpu')
    why = []
    assert not rk.supported(sd, rx, why) and needle in why[0]
    with pytest.raises(NotImplementedError, match=needle):
        bt.receive(s, sd, rx, spp=1024, max_depth=1, use_kernel=True,
                   device='cpu', **kw)


def _grid(scene_fn, spp, seed, depth=1):
    s, rx = scene_fn()
    sd = s.compile(use_bvh=False, device='cpu')
    a, n = bt.receive(s, sd, rx, seed=seed, spp=spp, max_depth=depth,
                      time_sampling='gate', device='cpu')
    return bt.develop_signal(a, n, rx.adc)[..., 0].double().numpy(), rx.adc


def test_range_doppler_shift_on_the_cpu():
    """The closing plate's echo sits at fc (1 + 2v/c) within 1.5 bins, as
    tests/test_pallas_receive.py holds the TPU kernel; the static plate's
    at the carrier."""
    grid, adc = _grid(bt.range_doppler_scene, 1 << 14, 2)
    bw = (adc.freq_hi - adc.freq_lo) / adc.n_freq
    fc, v, c = 40e3, 5.0, 340.0
    want = (fc * 2 * v / c + fc - adc.freq_lo) / bw - 0.5
    assert abs(int(grid.sum(0).argmax()) - want) <= 1.5

    def static():
        s, rx = bt.range_doppler_scene()
        s.shapes[-1].velocity = np.zeros(3, np.float32)
        return s, rx
    grid0, _ = _grid(static, 1 << 14, 2)
    assert abs(int(grid0.sum(0).argmax()) - ((fc - adc.freq_lo) / bw
                                             - 0.5)) <= 1.5


def test_multi_body_bodies_at_their_doppler_on_the_cpu():
    """The static body's echo stays at the carrier, the closing rough
    conductor's moves by 2 v_r / c fc (tests/test_pallas_receive.py:
    717-748), each in its range gate."""
    grid, adc = _grid(bt.multi_body_scene, 1 << 15, 1)
    bw = (adc.freq_hi - adc.freq_lo) / adc.n_freq
    c, fc = 340.0, 40e3
    f0 = (fc - adc.freq_lo) / bw - 0.5
    p2 = np.array([0.0, -5.5, 1.5])
    tb1 = int(round(2 * 3.0 / c / adc.sampling_time * adc.n_time - 0.5))
    tb2 = int(round(2 * np.linalg.norm(p2) / c / adc.sampling_time
                    * adc.n_time - 0.5))
    spec1 = grid[max(tb1 - 1, 0):tb1 + 3].sum(0)
    spec2 = grid[max(tb2 - 1, 0):tb2 + 3].sum(0)
    assert spec1.sum() > 0 and spec2.sum() > 0
    assert abs(int(spec1.argmax()) - f0) <= 1.5
    v_rad = 3.0 * abs(p2[1]) / np.linalg.norm(p2)
    assert int(spec2.argmax()) - int(spec1.argmax()) == pytest.approx(
        2 * v_rad / c * fc / bw, abs=1.5)


def test_receive_routes_both_scenes_to_the_kernel_on_the_cpu(monkeypatch):
    calls = []
    k = rk.receive_megakernel

    def counted(*a, **kw):
        calls.append(kw['doppler'])
        return k(*a, **kw)
    monkeypatch.setattr(rk, 'receive_megakernel', counted)
    for fn in (bt.multi_body_scene, bt.range_doppler_scene):
        s, rx = fn()
        a, n = bt.receive(s, s.compile(use_bvh=False, device='cpu'), rx,
                          spp=1024, max_depth=1, time_sampling='gate',
                          device='cpu')
        assert a.shape == (rx.adc.n_time, rx.adc.n_freq, 3)
        assert bool(torch.isfinite(a).all()) and float(a[..., 0].sum()) > 0
    assert calls == [True, True]
