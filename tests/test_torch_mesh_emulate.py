"""K1's mesh Doppler kernel (`receive_mesh_doppler_kernel<COH, LOB>` in
`csrc/receive_megakernel.cu`: the Doppler mesh and the coherent mesh, the
mesh lobe twins in power and in I / Q) on the CPU: the source compiled
once by g++ against the CUDA runtime stub `tools/emu/cuda_runtime.h` (each
block as std::threads; `tools/k1_emulate.py`) and held against the plain
version lane by lane with the card's gates on multi_body (with the main
path's direction strata and without, and in I / Q on its 2-D grid), the
rough-plastic mesh in I / Q and in power, the diffuse mesh in I / Q with
strata and without, both on a global grid, and the 4-pulse CPIs of
multi_body and the coherent mesh; the launch record shows the
configuration's instantiation ran, its warp rows repeat bit for bit, and
the media twins keep the grid-stride kernel.  The mesh kernel
(`receive_mesh_kernel`: the mesh configuration in power on the flagship
kernel's turns) the same way on the diffuse mesh with strata and without
and on its 4-pulse CPI, and its media twin keeps the grid-stride kernel.
Skips where g++ is absent."""

import contextlib
import os
import shutil
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card's gates)
import k1_emulate  # noqa: E402
from beifong_tpu_torch import scenes  # noqa: E402
from beifong_tpu_torch.integrators import receive_kernel as rk  # noqa: E402

LANES = 4096
SCENES = ('mesh_multi_body', 'mesh_multi_body_p0', 'mesh_rough_plastic_iq',
          'mesh_rough_plastic_power', 'mesh_coherent', 'mesh_coherent_p0',
          'mesh_multi_body_iq', 'mesh_coherent_global',
          'mesh_rough_plastic_global')


def _record(coherent, lobes):
    """The launch record shows receive_mesh_doppler_kernel<coherent,
    lobes> and none of its three other instantiations."""
    for c in (False, True):
        for lob in (False, True):
            assert rk.launched_mesh_doppler_kernel(lob, c) \
                == ((c, lob) == (coherent, lobes)), (c, lob)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to compile the CUDA source against the stub')
    out = str(tmp_path_factory.mktemp('k1_emulate') / 'k1.so')
    return k1_emulate._library(k1_emulate.emulate(ROOT, out, '-O1'))


@pytest.fixture
def emulated(lib, monkeypatch):
    """The wrapper's launch path on CPU tensors, through the emulation."""
    monkeypatch.setattr(rk, 'LIBRARY', lib)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _kernel(params, prim, txp, msh, mesh, kw, u, lane, n_pulses=1,
            **extra):
    return rk._launch(params, prim, txp, msh, u, mesh, lane,
                      n_pulses=n_pulses, n_lanes=LANES, seed=13,
                      seed_step=7919 if n_pulses > 1 else 0,
                      **k1_emulate.launch_kw(kw), **extra)


def _parity(acc, ev, lane, ref, n_ref, lane_ref, amp, kw, band, what):
    adc = kw['adc']
    if kw['coherent']:
        chip_smoke.compare_coherent(
            torch, acc.view(adc.n_time, adc.n_freq, 2), ev, ref, n_ref, amp,
            rk.phase_slack(band, adc), what, lane, lane_ref,
            depth=kw['max_depth'], quiet=True)
    else:
        chip_smoke.compare_lanes(acc.view(adc.n_time, adc.n_freq), ev, lane,
                                 ref, n_ref, lane_ref, kw['max_depth'], what)


@pytest.mark.parametrize('name', SCENES)
def test_mesh_doppler_kernel_matches_plain_version(emulated, name):
    """Injected uniforms of the lobe draw stride: every lane's sum against
    the plain version's (lane by lane), each cell within 1e-4 x max|acc|
    (I / Q with the phase slack), the same events, the launch record of
    the configuration's instantiation; a repeat bit for bit on the warp
    rows, within REPEAT_TOL on the block's and the global grid's
    atomics."""
    params, prim, txp, msh, mesh, kw, _, band = k1_emulate.mesh_tables(name)
    coh = kw['coherent']
    gen = torch.Generator().manual_seed(29)
    nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
    u = torch.rand((nd, LANES), generator=gen)
    lane = torch.zeros(LANES)
    acc, ev = _kernel(params, prim, txp, msh, mesh, kw, u, lane)
    lob = bool(kw['lobes'])
    _record(coh, lob)
    adc = kw['adc']
    lane_ref = torch.zeros(LANES)
    amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, mesh=mesh,
                                           msh=msh, lane_out=lane_ref,
                                           amp_out=amp, stats=stats, **kw)
    assert int(ev[0]) > 0 and stats['mesh_hits'] > 0
    assert (stats['strata'] > 0) == (kw['patch_p'] > 0)
    _parity(acc, ev[0], lane, ref, n_ref, lane_ref, amp, kw, band, name)
    assert (stats['phase'] > 0) == coh
    assert (stats['rplas_bounce'] > 0) == lob
    assert (stats['ggx_nee'] > 0) == ('multi_body' in name)
    assert (stats['splat_2d'] > 0) \
        == ('multi_body' in name or name.endswith('_global'))
    # a 1-D grid of at most 512 values sums in warp rows
    assert rk.coherent_warp_rows(adc, coh) \
        == (adc.n_freq == 1 and kw['adc'].n_time * (1 + coh) <= 512)
    lane2 = torch.zeros(LANES)
    acc2, ev2 = _kernel(params, prim, txp, msh, mesh, kw, u, lane2)
    assert torch.equal(ev, ev2) and torch.equal(lane, lane2)
    if rk.coherent_warp_rows(adc, coh):
        assert torch.equal(acc, acc2)
    assert float((acc - acc2).abs().max()) \
        <= chip_smoke.REPEAT_TOL * float(acc.abs().max())


def test_mesh_doppler_cpi_matches_plain_version(emulated):
    """multi_body's 4-pulse CPI in one launch: each pulse lane by lane
    against the plain version on its own tables and uniforms."""
    _cpi_parity('mesh_multi_body_cpi')


def test_coherent_mesh_cpi_matches_plain_version(emulated):
    """The coherent mesh's 4-pulse CPI in one launch of <true, false>:
    each pulse lane by lane against the plain version (I / Q with the
    phase slack)."""
    _cpi_parity('mesh_coherent_cpi')


def _cpi_parity(name):
    params, prim, txp, msh, mesh, kw, n_p, band = \
        k1_emulate.mesh_tables(name)
    gen = torch.Generator().manual_seed(31)
    nd = rk.n_draws(kw['max_depth'])
    u = torch.rand((n_p, nd, LANES), generator=gen)
    lane = torch.zeros((n_p, LANES))
    acc, ev = _kernel(params, prim, txp, msh, mesh, kw, u, lane,
                      n_pulses=n_p)
    _record(kw['coherent'], False)
    for p in range(n_p):
        lane_ref = torch.zeros(LANES)
        amp = torch.zeros((kw['adc'].n_time, kw['adc'].n_freq),
                          dtype=torch.float64)
        ref, n_ref = rk.receive_megakernel_ref(
            params[p], prim[p], txp[p], u[p], mesh=rk.pulse_mesh(mesh, p),
            msh=msh[p], lane_out=lane_ref, amp_out=amp, **kw)
        assert int(ev[p]) > 0
        _parity(acc[p], ev[p], lane[p], ref, n_ref, lane_ref, amp, kw, band,
                f'{name} pulse {p}')


@pytest.mark.parametrize('name', ['mesh_power', 'mesh_power_p0'])
def test_mesh_kernel_matches_plain_version(emulated, name):
    """The mesh configuration in power (the diffuse mesh, mode 0) on
    receive_mesh_kernel, with the main path's direction strata and
    without: injected uniforms, every lane's sum against the plain
    version's (lane by lane), each cell within 1e-4 x max|acc|, the same
    events, the launch record; a repeat bit for bit (warp rows), and on
    Philox the plain version's stream."""
    params, prim, txp, mesh, kw, _ = k1_emulate.mesh_power_tables(name)
    gen = torch.Generator().manual_seed(37)
    u = torch.rand((rk.n_draws(kw['max_depth']), LANES), generator=gen)
    for mode in ('injected', 'philox'):
        lane = torch.zeros(LANES)
        acc, ev = _kernel(params, prim, txp, None, mesh, kw,
                          u if mode == 'injected' else None, lane)
        assert rk.launched_mesh_kernel() and not rk.launched_mimo_kernel()
        _record(None, None)
        uu = u if mode == 'injected' else rk.philox_uniforms(
            13, rk.n_draws(kw['max_depth']), LANES)
        lane_ref = torch.zeros(LANES)
        stats = {}
        ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, uu,
                                               mesh=mesh, lane_out=lane_ref,
                                               stats=stats, **kw)
        assert int(ev[0]) > 0 and stats['mesh_hits'] > 0
        assert (stats['strata'] > 0) == (kw['patch_p'] > 0)
        chip_smoke.compare_lanes(acc.view(kw['adc'].n_time, 1), ev[0], lane,
                                 ref, n_ref, lane_ref, kw['max_depth'],
                                 f'{name} {mode}')
        lane2 = torch.zeros(LANES)
        acc2, ev2 = _kernel(params, prim, txp, None, mesh, kw,
                            u if mode == 'injected' else None, lane2)
        assert torch.equal(acc, acc2) and torch.equal(ev, ev2)
        assert torch.equal(lane, lane2)


def test_mesh_kernel_cpi_matches_plain_version(emulated):
    """The mesh scene's 4-pulse CPI in power in one launch of
    receive_mesh_kernel (the pulse a grid axis): each pulse lane by lane
    against the plain version on its own tables and uniforms."""
    params, prim, txp, mesh, kw, n_p = \
        k1_emulate.mesh_power_tables('mesh_power_cpi')
    gen = torch.Generator().manual_seed(41)
    nd = rk.n_draws(kw['max_depth'])
    u = torch.rand((n_p, nd, LANES), generator=gen)
    lane = torch.zeros((n_p, LANES))
    acc, ev = _kernel(params, prim, txp, None, mesh, kw, u, lane,
                      n_pulses=n_p)
    assert rk.launched_mesh_kernel()
    for p in range(n_p):
        lane_ref = torch.zeros(LANES)
        ref, n_ref = rk.receive_megakernel_ref(
            params[p], prim[p], txp[p], u[p], mesh=rk.pulse_mesh(mesh, p),
            lane_out=lane_ref, **kw)
        assert int(ev[p]) > 0
        chip_smoke.compare_lanes(acc[p].view(kw['adc'].n_time, 1), ev[p],
                                 lane[p], ref, n_ref, lane_ref,
                                 kw['max_depth'], f'mesh CPI pulse {p}')


def test_mesh_power_media_twin_keeps_the_grid_stride_kernel(emulated):
    """The mesh scene in power through a homogeneous medium (the mesh
    configuration's media twin) launches receive_trace_kernel<true, true>
    (the launch record): not the mesh kernel."""
    s, rx = scenes.mesh_scene(n_side=9)
    s.medium = scenes.stratified_homogeneous()
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    assert p.medium > 0
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=False, coherent=False,
              receive_type='raw', has_lo=False, mirror=False, patch_p=0)
    acc, ev = _kernel(torch.tensor(p.params), torch.tensor(p.prim),
                      torch.tensor(p.txp), None, p.mesh, kw, None, None,
                      medium=p.medium)
    assert not rk.launched_mesh_kernel()
    _record(None, None)
    assert bool(torch.isfinite(acc).all())


def test_mesh_twins_keep_the_grid_stride_kernel(emulated):
    """The media twins of the Doppler mesh (multi_body) and of the
    coherent mesh (the diffuse mesh) through a homogeneous medium launch
    receive_doppler_kernel<true, ...> (the launch record): none of the
    mesh Doppler kernel's instantiations."""
    base = dict(max_depth=2, time_sampling='gate', rx_kind='wigner',
                doppler=True, receive_type='raw', has_lo=False,
                mirror=False, patch_p=0)
    runs = []
    for coh, (s, rx) in ((False, scenes.multi_body_scene()),
                         (True, scenes.mesh_scene(n_side=9))):
        s.medium = scenes.stratified_homogeneous()
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
        assert p.medium > 0
        t = [torch.tensor(a) for a in (p.params, p.prim, p.txp, p.msh)]
        runs.append((*t, p.mesh, dict(base, adc=rx.adc, coherent=coh),
                     {'medium': p.medium}))
    for params, prim, txp, msh, mesh, kw, extra in runs:
        acc, ev = _kernel(params, prim, txp, msh, mesh, kw, None, None,
                          **extra)
        _record(None, None)
        assert bool(torch.isfinite(acc).all())
