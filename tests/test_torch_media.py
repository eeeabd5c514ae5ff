"""Ambient media in the port against the JAX package.

`media.py` on seeded segments; the medium carried across from the JAX
`SceneData` and packed for the receive kernel bit for bit as the JAX
package's `_pack_scene` packs it; the eager wavefront against JAX's
`radar_receive_trace` on one replay table (tests/test_torch_wavefront.py),
and the kernel's plain version against the JAX megakernel in interpret
mode on its own uniforms, each within 1e-4 x max|acc| per cell; scope and
routing; the example's echo attenuation (`examples/stratified_medium.py`)
and the media anchors of golden configs 5 and 6 on the CPU.  The CUDA
kernel is held against the plain version on a card by
tests/test_torch_gpu.py.
"""

import dataclasses as dc
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from beifong_tpu import media as mj
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import media as mt
from beifong_tpu_torch import scenes
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar.endpoints import ADCConfig

from test_torch_mesh import jax_leaves, port_band
from test_torch_wavefront import JaxReplay, jax_pass, port_pass

torch.set_num_threads(1)

TOL = 1e-4      # x max|acc| per cell
ANCHOR = 0.10   # the example's attenuation against its closed form
ST = scenes.STRATIFIED

_spec = importlib.util.spec_from_file_location(
    'stratified_medium', os.path.join(os.path.dirname(__file__), '..',
                                      'examples', 'stratified_medium.py'))
example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(example)

HALF_CELLS = np.full((4, 4, 8), 0.05, np.float32)
HALF_CELLS[..., 4:] = 0.0      # absorbing for x < 0: the receiver's leg
FLAG_BOX = dict(box_min=(-1.0, -5.0, -1.0), box_max=(1.0, 1.0, 1.0))
# a K = 8 profile whose fifth step, params[49], is 1.0: the JAX package's
# `_grid_meta` reads that slot as a grid's depth (ROADMAP C4)
SIGMA8 = [0.0, 0.0, 0.4, 0.4, 1.4, 0.0, 0.0, 0.0]


def media(pkg: str, name: str):
    """One medium of either package by name."""
    m = mj if pkg == 'jax' else mt
    if name == 'hom':
        return m.HomogeneousMedium.make(sigma_t=ST['sigma_t'])
    if name == 'lay4':
        return m.LayeredMedium.make([0.0, 0.4, 0.0, 0.0], ST['z_min'],
                                    ST['z_max'])
    if name == 'lay8':
        return m.LayeredMedium.make(SIGMA8, ST['z_min'], ST['z_max'])
    if name == 'lay32':
        sig = np.random.default_rng(32).uniform(0.0, 0.5, 32)
        return m.LayeredMedium.make(sig, -1.0, 4.0)
    if name == 'grid':
        return m.HeterogeneousMedium.make(HALF_CELLS, **FLAG_BOX)
    if name == 'grid_full':
        return m.HeterogeneousMedium.make(
            np.full((8, 8, 128), ST['sigma_t'], np.float32),
            box_min=ST['box_min'], box_max=ST['box_max'])
    raise KeyError(name)


# ---------------------------------------------------------------------------
# 1. media.py against the JAX package
# ---------------------------------------------------------------------------


def _segments(n=4096, seed=5):
    """Seeded segments: points in and around the layers' z range and the
    grid's box, steep directions and near-horizontal ones with |d_z| just
    above and below 1e-5, lengths from 0 to 8 m."""
    g = np.random.default_rng(seed)
    o = g.uniform([-1.5, -6.0, -2.0], [1.5, 2.0, 5.0], (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:1024, 2] = g.choice([1.01e-5, 0.99e-5, -1.01e-5, -0.99e-5, 0.0, 1e-4],
                           1024)
    dist = g.uniform(0.0, 8.0, n)
    dist[:16] = 0.0
    return (o.astype(np.float32), d.astype(np.float32),
            dist.astype(np.float32))


@pytest.mark.parametrize('name', ['hom', 'lay4', 'lay8', 'lay32', 'grid',
                                  'grid_full'])
def test_media_match_jax(name):
    o, d, dist = _segments()
    mj_, mt_ = media('jax', name), media('port', name)
    J, T = jnp.asarray, torch.from_numpy
    fns = [('attenuation', (o, d, dist))]
    if name != 'hom':
        fns += [('optical_depth', (o, d, dist)), ('sigma_at', (o,))]
    if name.startswith('lay'):
        fns += [('tau_z', (o[:, 2],))]
    for fn, args in fns:
        ref = np.asarray(getattr(mj_, fn)(*map(J, args)))
        got = getattr(mt_, fn)(*map(T, args)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=f'{name}.{fn}')
    assert mt_.kind == {'hom': mt.HOMOGENEOUS, 'grid': mt.GRID,
                        'grid_full': mt.GRID}.get(name, mt.LAYERED)


def test_homogeneous_transmittance_and_majorants():
    h = media('port', 'hom')
    x = torch.linspace(0.0, 10.0, 11)
    assert torch.equal(h.transmittance(x), torch.exp(-h.sigma_t * x))
    assert float(media('port', 'lay8').majorant) == pytest.approx(1.4)
    assert float(media('port', 'grid').majorant) == pytest.approx(0.05)


def test_atmospheric_attenuation_matches_jax():
    f = np.concatenate([[0.2e9, 1e9, 60e9, 220e9, 400e9],
                        np.linspace(0.5e9, 250e9, 997)]).astype(np.float32)
    ref = np.asarray(mj.atmospheric_attenuation_db_per_km(jnp.asarray(f)))
    got = mt.atmospheric_attenuation_db_per_km(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# 2. interop and the kernel's pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', ['hom', 'lay4', 'lay8', 'grid'])
def test_interop_carries_each_medium(name):
    s_j, _ = example.build(media('jax', name))
    sd_j = s_j.compile()
    sd = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                               device='cpu')
    ref = media('port', name)
    assert type(sd.medium) is type(ref) and sd.medium.kind == ref.kind
    for f in dc.fields(ref):
        np.testing.assert_array_equal(getattr(sd.medium, f.name).numpy(),
                                      getattr(ref, f.name).numpy(), f.name)


@pytest.mark.parametrize('name', ['hom', 'lay4', 'lay8', 'lay32', 'grid',
                                  'grid_full'])
def test_pack_bit_identical_to_jax(name):
    """params as the JAX package's `_pack_scene` writes them; the grid
    tensor is the block it appends to its texture table."""
    s_j, rx_j = example.build(media('jax', name))
    s_t, rx_t = bt.stratified_medium_scene(media('port', name))
    (params_j, _, _, _, _, _, _, tex, _, _) = pr._pack_scene(
        s_j.compile(), rx_j, -1)
    got = rk.pack_scene(s_t.compile(device='cpu'), rx_t, -1)
    assert got.params.dtype == params_j.dtype == np.float32
    np.testing.assert_array_equal(got.params.view(np.uint32),
                                  params_j.view(np.uint32))
    assert got.medium == media('port', name).kind
    if got.medium == mt.GRID:
        gd, gh, gw = got.grid.shape
        off = rk.GRID3_TEX_ROW
        assert int(params_j[52]) == off
        np.testing.assert_array_equal(
            tex[off:off + gd * gh, :gw].reshape(gd, gh, gw), got.grid)
        assert not tex[off:, gw:].any() and not tex[off + gd * gh:].any()
    else:
        assert got.grid is None


def test_layered_medium_with_a_step_at_the_grid_slot_runs_layered():
    """K = 8 with params[49] = 1: the JAX package's `_grid_meta` takes it
    for a grid (ROADMAP C4); the port packs its kind apart and its kernel
    runs it as layered: the example's echo attenuation meets the
    profile's closed form."""
    s_t, rx = bt.stratified_medium_scene(media('port', 'lay8'))
    p = rk.pack_scene(s_t.compile(device='cpu'), rx, -1)
    assert p.params[49] == 1.0 and pr._grid_meta(p.params)[1] == 1
    assert p.medium == mt.LAYERED and p.grid is None
    att = _attenuation(media('port', 'lay8'), use_kernel=True,
                       time_sampling='gate')
    want = scenes.two_leg_transmittance(s_t, rx, media('port', 'lay8'))
    assert want < 0.5 and abs(att / want - 1.0) < ANCHOR, (att, want)


# ---------------------------------------------------------------------------
# 3. the wavefront against JAX on identical uniforms
# ---------------------------------------------------------------------------


def _flagship(pkg, name):
    """The flagship's point target without the ground, in a medium."""
    if pkg == 'jax':
        s, rx = ge._build_scene(ground=False)
    else:
        s, rx = bt.flagship_scene(ground=False)
    s.medium = media(pkg, name)
    return s, rx


WF_CASES = [('example', 'lay4', 'gate', 1 << 14),
            ('example', 'lay32', 'gate', 1 << 14),
            ('flagship', 'grid', 'gate', 4096),
            ('flagship', 'hom', 'fixed', 4096)]


@pytest.mark.parametrize('scene, name, ts, n_lanes', WF_CASES,
                         ids=[f'{c[0]}-{c[1]}-{c[2]}' for c in WF_CASES])
def test_wavefront_matches_jax_on_identical_uniforms(scene, name, ts,
                                                     n_lanes):
    if scene == 'example':
        s_j, rx_j = example.build(media('jax', name))
        _, rx_t = bt.stratified_medium_scene()
    else:
        s_j, rx_j = _flagship('jax', name)
        _, rx_t = _flagship('port', name)
    sd_j = s_j.compile(use_bvh=False)
    table = np.random.default_rng(17).random((40, n_lanes),
                                             dtype=np.float32)
    got = port_pass(s_j, sd_j, rx_t, table, 2, False, ts)
    ref = jax_pass(s_j, sd_j, rx_j, JaxReplay(jnp.asarray(table)), 2, False,
                   ts)
    vac = None
    if scene == 'example':
        s_v, rx_v = example.build(None)
        vac = jax_pass(s_v, s_v.compile(use_bvh=False), rx_v,
                       JaxReplay(jnp.asarray(table)), 2, False, ts)
    scale = np.abs(ref[..., 0]).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=0,
                               atol=TOL * scale)
    # the connections splatted (count channel) are the same ones
    np.testing.assert_allclose(got[..., 2], ref[..., 2], rtol=0,
                               atol=TOL * np.abs(ref[..., 2]).max())
    if vac is not None:
        # the medium attenuated the echo (past the direct blast in bins
        # 0-9, whose path stays above the slab) against the same lanes in
        # vacuum
        echo, echo_vac = ref[10:, 0, 0].sum(), vac[10:, 0, 0].sum()
        assert echo_vac > 0 and 0.05 < echo / echo_vac < 0.9


# ---------------------------------------------------------------------------
# 4. the kernel's plain version against the JAX megakernel
# ---------------------------------------------------------------------------


def _jax_kernel(s, rx, ts, depth, n_lanes, seed):
    """JAX `_run(interpret=True)` with its medium flags, called as
    `receive_pallas` calls it, plus the uniforms it drew as (n_draws,
    n_lanes) and its tables."""
    sd = s.compile()
    assert pr.supported(sd, rx)
    si = s.shape_index_of_endpoint('receiver', rx.id)
    rx_kind = 'omni' if si < 0 else 'wigner'
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     mesh_pack) = pr._pack_scene(sd, rx, si)
    assert mesh_pack is None
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    out, _, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx.adc, rx.receive_type, ts, depth, rx_kind, n_lanes, True, False,
        has_mesh=False, mesh_types=mesh_types, moving=False,
        absorbing=bool(params[29] > 0.0),
        tx_kinds=tuple(int(f) for f in txp[:, 27]), has_lo=False,
        polarized=False, bmp_meta=bmp_meta, layered=int(params[42]),
        tex=jnp.asarray(tex), msh=jnp.asarray(msh), mimo_e=0, eoff=None,
        grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]))
    nd = pr.n_draws(depth)
    u = jax.random.uniform(jax.random.key(seed),
                           (n_lanes // 1024, nd, 8, 128), dtype=jnp.float32)
    u = np.asarray(u).transpose(1, 0, 2, 3).reshape(nd, n_lanes)
    adc = ADCConfig(**{f.name: getattr(rx.adc, f.name)
                       for f in dc.fields(ADCConfig)})
    return (np.asarray(out)[:, 0], float(np.asarray(cnt)[0, 0]), params,
            prim, txp, u, adc, rx_kind)


K1_CASES = [('example', 'lay4', 'gate', 4096, 0),
            ('flagship', 'grid', 'fixed', 1024, 1),
            ('flagship', 'hom', 'gate', 1024, 1)]


@pytest.mark.parametrize('scene, name, ts, n_lanes, seed', K1_CASES,
                         ids=[f'{c[0]}-{c[1]}-{c[2]}' for c in K1_CASES])
def test_plain_version_matches_jax_megakernel(scene, name, ts, n_lanes,
                                              seed):
    if scene == 'example':
        s, rx = example.build(media('jax', name))
    else:
        s, rx = _flagship('jax', name)
    out_j, cnt_j, params, prim, txp, u, adc, rx_kind = _jax_kernel(
        s, rx, ts, 2, n_lanes, seed)
    med = media('port', name)
    grid = med.sigma_grid if med.kind == mt.GRID else None
    t = torch.tensor
    stats = {}
    ill = torch.zeros(n_lanes, dtype=torch.bool)
    acc, n_ev = rk.receive_megakernel_ref(
        t(params), t(prim), t(txp), t(u), adc=adc, max_depth=2,
        time_sampling=ts, rx_kind=rx_kind, medium=med.kind, grid=grid,
        stats=stats, ill_out=ill)
    assert cnt_j > 0 and np.abs(out_j).max() > 0
    assert stats['med_seg'] > 0 and stats['med_conn'] > 0
    np.testing.assert_allclose(acc[:, 0].numpy(), out_j, rtol=0,
                               atol=TOL * np.abs(out_j).max())
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the CPU wrapper is the plain version (the ill mask changes nothing);
    # vacuum differs
    acc_w, n_w = rk.receive_megakernel(
        t(params), t(prim), t(txp), adc=adc, max_depth=2, time_sampling=ts,
        rx_kind=rx_kind, n_lanes=n_lanes, uniforms=t(u), medium=med.kind,
        grid=grid)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)
    vac, _ = rk.receive_megakernel_ref(
        t(params), t(prim), t(txp), t(u), adc=adc, max_depth=2,
        time_sampling=ts, rx_kind=rx_kind)
    assert float(vac.abs().sum()) > 1.01 * float(acc.abs().sum())


@pytest.mark.parametrize('kind', ['homogeneous', 'layered', 'grid'])
def test_medium_tau_marks_ill_conditioned_depths(kind):
    """`medium_tau`'s `ill` takes the live lanes whose optical depth an
    ulp of its inputs moves by more than 1e-4 (the card tests let only
    those, beyond 1e-4 of all lanes, leave the plain version's path): a
    steep layered segment with a small d_z, a grid sample on a cell's
    edge; never a homogeneous depth, a flat or steep layered segment, a
    sample inside a cell or outside the box, or a dead lane."""
    s, rx = bt.stratified_medium_scene(scenes.seeded_medium(kind))
    p = rk.pack_scene(s.compile(device='cpu'), rx, -1)
    marked = []
    tau = rk.medium_tau(torch.from_numpy(p.params), p.medium,
                        None if p.grid is None else torch.from_numpy(p.grid),
                        marked.append)

    def f(*v):
        return torch.tensor(v, dtype=torch.float32)
    live = torch.tensor([True, True, True, False])
    if kind == 'grid':
        # x cell coordinate 32 (x + 2): 64 on an edge, 64.32 inside a
        # cell, outside the box; the dead lane on the edge
        o = (f(0.0, 0.01, 3.0, 0.0), f(-2.5, -2.5, -2.5, -2.5),
             f(0.25, 0.25, 0.25, 0.25))
        d = (f(1, 1, 1, 1), f(0, 0, 0, 0), f(0, 0, 0, 0))
        ln = f(0, 0, 0, 0)
    else:
        # d_z 1e-4 (steep, ill), 0.6 (steep), 1e-6 (flat), 1e-4 dead
        o = (f(0, 0, 0, 0), f(0, 0, 0, 0), f(0.3, 0.3, 0.3, 0.3))
        d = (f(0, 0, 0, 0), f(1, 0.8, 1, 1), f(1e-4, 0.6, 1e-6, 1e-4))
        ln = f(1, 1, 1, 1)
    got = tau(*o, *d, ln, live)
    assert bool(torch.isfinite(got).all())
    ill = torch.stack(marked).any(0) if marked else torch.zeros(4, dtype=torch.bool)
    want = [False] * 4 if kind == 'homogeneous' else [True, False, False,
                                                      False]
    assert ill.tolist() == want


def test_kernel_medium_arguments_are_checked():
    s, rx = bt.stratified_medium_scene(media('port', 'grid_full'))
    p = rk.pack_scene(s.compile(device='cpu'), rx, -1)
    t = torch.from_numpy
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate', rx_kind='omni',
              n_lanes=256)
    with pytest.raises(ValueError, match='grid'):
        rk.receive_megakernel(t(p.params), t(p.prim), t(p.txp),
                              medium=mt.GRID, **kw)
    with pytest.raises(ValueError, match='grid'):
        rk.receive_megakernel(t(p.params), t(p.prim), t(p.txp),
                              medium=mt.LAYERED, grid=t(p.grid), **kw)
    with pytest.raises(ValueError, match='medium'):
        rk.receive_megakernel(t(p.params), t(p.prim), t(p.txp), medium=4,
                              **kw)


# ---------------------------------------------------------------------------
# 5. scope and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('med, needle', [
    (lambda: mt.LayeredMedium.make(np.full(33, 0.1), 0.0, 4.0),
     '33 medium layers > 32'),
    (lambda: mt.HeterogeneousMedium.make(np.zeros((5, 13, 8))),
     'grid 5x13x8'),
    (lambda: mt.HeterogeneousMedium.make(np.zeros((2, 2, 129))),
     'grid 2x2x129'),
])
def test_scope_rejects_media_past_the_caps(med, needle):
    s, rx = bt.stratified_medium_scene(med())
    sd = s.compile(device='cpu')
    why: list = []
    assert not rk.supported(sd, rx, why)
    assert needle in why[0] and 'ROADMAP B7' in why[0]
    with pytest.raises(NotImplementedError, match='ROADMAP B7'):
        bt.receive(s, sd, rx, spp=256, max_depth=1, use_kernel=True,
                   device='cpu')
    # 'auto' runs the wavefront
    adc, n = bt.receive(s, sd, rx, spp=256, max_depth=1, device='cpu')
    assert n == 256 and bool(torch.isfinite(adc).all())


def test_scope_rejects_an_unknown_medium():
    s, rx = bt.stratified_medium_scene()
    sd = dc.replace(s.compile(device='cpu'), medium=object())
    why: list = []
    assert not rk.supported(sd, rx, why)
    assert 'unknown ambient medium' in why[0]


@pytest.mark.parametrize('name', ['hom', 'lay4', 'lay32', 'grid_full'])
def test_receive_routes_media_to_the_kernel(name):
    """'auto' sends the example's scene in every medium to the kernel (its
    plain version here): the same grid as `receive_kernel`."""
    med = scenes.stratified_layers(32) if name == 'lay32' \
        else media('port', name)
    s, rx = bt.stratified_medium_scene(med)
    sd = s.compile(device='cpu')
    assert rk.supported(sd, rx)
    kw = dict(spp=4096, max_depth=2, seed=1, time_sampling='gate')
    a, n = bt.receive(s, sd, rx, device='cpu', **kw)
    out, n_k = rk.receive_kernel(s, sd, rx, device='cpu', **kw)
    assert n == n_k and torch.equal(a[..., 0], out)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    s, rx = bt.stratified_medium_scene(scenes.stratified_layers())
    with pytest.raises(RuntimeError, match='cuda'):
        bt.receive(s, receiver=rx, spp=256, max_depth=2)
    with pytest.raises(RuntimeError, match='cuda'):
        s.compile()


def test_at_time_and_compile_carry_the_medium():
    med = scenes.stratified_layers()
    s, _ = bt.stratified_medium_scene(med)
    assert s.at_time(0.3).medium is med
    sd = s.compile(device='cpu')
    assert isinstance(sd.medium, mt.LayeredMedium)
    assert torch.equal(sd.medium.sigma, med.sigma)


# ---------------------------------------------------------------------------
# 6. anchors on the CPU
# ---------------------------------------------------------------------------


def _attenuation(med, use_kernel, time_sampling='fixed', spp=ST['spp'],
                 seed=ST['seed']):
    """The example's `main` on the port: the range profile with `med`
    over the one in vacuum, one seed."""
    prof = []
    for m in (None, med):
        s, rx = bt.stratified_medium_scene(m)
        a, n = bt.receive(s, receiver=rx, spp=spp, max_depth=ST['max_depth'],
                          seed=seed, time_sampling=time_sampling,
                          use_kernel=use_kernel, device='cpu')
        prof.append(bt.develop_signal(a, n, rx.adc)[:, 0, 0].numpy())
    return scenes.echo_attenuation(*prof)


@pytest.mark.parametrize('use_kernel, ts', [(True, 'fixed'), (True, 'gate'),
                                            (False, 'gate')],
                         ids=['kernel-fixed', 'kernel-gate',
                              'wavefront-gate'])
def test_example_attenuation_on_cpu(use_kernel, ts):
    """The example's echo attenuation at its spp and seed within 10% of
    the closed form exp(-tau) through the target's centre (0.263), and
    inside the example's own 0.05 < att < 0.9.  Fixed sampling connects
    ~3% of the lanes that reach the plate (the pulse's share of the
    window): the kernel's 2^14 lanes give it three connections, the
    wavefront's none (the JAX package's own run of the example has one),
    so the wavefront is read under gate sampling, where every connection
    counts."""
    s, rx = bt.stratified_medium_scene()
    want = scenes.two_leg_transmittance(s, rx, scenes.stratified_layers())
    assert want == pytest.approx(0.263, abs=5e-4)
    att = _attenuation(scenes.stratified_layers(), use_kernel, ts)
    assert 0.05 < att < 0.9
    assert abs(att / want - 1.0) < ANCHOR, (att, want)


@pytest.mark.parametrize('use_kernel', [True, False],
                         ids=['kernel', 'wavefront'])
def test_uniform_grid_equals_homogeneous(use_kernel):
    """An 8 x 8 x 128 grid of sigma_t over a box that holds every path
    gives the homogeneous medium's grid to the quadrature's exactness
    (tests/test_hetero_medium.py's rtol 1e-3)."""
    out = []
    for med in (scenes.stratified_homogeneous(), scenes.medium_grid()):
        s, rx = bt.stratified_medium_scene(med)
        a, _ = bt.receive(s, receiver=rx, spp=1 << 14, max_depth=2, seed=1,
                          time_sampling='gate', use_kernel=use_kernel,
                          device='cpu')
        out.append(a[..., 0])
    scale = float(out[0].abs().max())
    assert scale > 0
    assert float((out[1] - out[0]).abs().max()) <= 1e-3 * scale


def test_micro_doppler_comb_through_a_medium():
    """Config 5 (`receive_cpi`, the kernel's CPI form) in a homogeneous
    medium: the nine strongest slow-time bins stay on the comb, and the
    comb's power scales by exp(-sigma_t 2 R0) within 10%."""
    md = scenes.MICRO_DOPPLER
    comb = scenes.micro_doppler_comb_bins()
    spec = []
    for med in (None, scenes.stratified_homogeneous()):
        s, _ = bt.micro_doppler_scene()
        s.medium = med
        cube, n = bt.receive_cpi(s, n_pulses=md['n_pulses'], prf=md['prf'],
                                 seed=md['seed'], spp=1 << 11,
                                 max_depth=md['max_depth'],
                                 time_sampling='gate', device='cpu')
        spec.append(scenes.micro_doppler_spectrum(cube, n).double().numpy())
    assert sorted(np.argsort(spec[1])[::-1][:len(comb)].tolist()) == comb
    ratio = spec[1][comb].sum() / spec[0][comb].sum()
    want = np.exp(-ST['sigma_t'] * 2 * md['R0'])
    assert abs(ratio / want - 1.0) < 0.10, (ratio, want)


def test_cpi_pack_follows_the_scene_medium():
    """`pack_cpi` keeps the CPI's tables on the scene; a medium set on the
    scene after a call is packed anew, as on a new scene."""
    md = scenes.MICRO_DOPPLER
    kw = dict(n_pulses=4, prf=md['prf'], seed=md['seed'], spp=1 << 10,
              max_depth=md['max_depth'], time_sampling='gate', device='cpu')
    s, _ = bt.micro_doppler_scene()
    vac, _ = bt.receive_cpi(s, **kw)
    s.medium = scenes.stratified_homogeneous()
    med, _ = bt.receive_cpi(s, **kw)
    s2, _ = bt.micro_doppler_scene()
    s2.medium = scenes.stratified_homogeneous()
    fresh, _ = bt.receive_cpi(s2, **kw)
    assert torch.equal(med, fresh)
    assert float(med.abs().sum()) < 0.99 * float(vac.abs().sum())


def test_config6_azimuth_through_a_medium():
    """Config 6 (`receive_mimo`, the kernel's MIMO form) in a homogeneous
    medium: the delay-and-sum azimuth peak within 2 bins of the golden
    file's expected bin."""
    from beifong_tpu_torch.dsp import beamform as bf
    m = scenes.MIMO
    s, rx = bt.mimo_beamform_scene()
    s.medium = scenes.stratified_homogeneous()
    sd = s.compile(device='cpu')
    assert rk.supported(sd, rx, mimo=True)
    adc, n = bt.receive_mimo(s, sd, rx, spp=m['spp'],
                             max_depth=m['max_depth'], seed=m['seed'],
                             time_sampling='gate', device='cpu')
    cube = bt.develop_mimo(adc, n, rx.adc)
    az, dirs, want = scenes.mimo_azimuth_scan()
    offs = rk.array_offsets(s, sd, rx, torch.device('cpu'))
    das = (bf.delay_and_sum(cube, offs, dirs, m['fc'], s.band.c).abs() ** 2
           ).sum(dim=(1, 2))
    assert abs(int(das.argmax()) - want) <= 2
