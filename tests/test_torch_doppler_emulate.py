"""K1's analytic Doppler power kernel (`receive_doppler_power_kernel` in
`csrc/receive_megakernel.cu`) on the CPU: the source compiled once by g++
against the CUDA runtime stub `tools/emu/cuda_runtime.h` (each block as
std::threads; `tools/k1_emulate.py`) and held against the plain version
with the card's gates on the range-Doppler pulse, golden config 2's
mix_resample grid, a wide 1-D grid and a global grid; the launch record
shows the new kernel ran, and that the configuration's media and endpoint
twins keep the grid-stride kernel.  Skips where g++ is absent."""

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

LANES = 2048
SCENES = ('dop_range_doppler', 'dop_fmcw_sonar', 'dop_wide', 'dop_global')


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


def _kernel(params, prim, txp, kw, u, lane, **extra):
    return rk._launch(params, prim, txp, None, u, None, lane, n_pulses=1,
                      n_lanes=LANES, seed=13, seed_step=0, patch_p=0,
                      **k1_emulate.launch_kw(kw), **extra)


@pytest.mark.parametrize('name', SCENES)
def test_doppler_power_kernel_matches_plain_version(emulated, name):
    """Injected uniforms: every lane's sum within TOL of the plain
    version's (lane by lane), each cell within 1e-4 x max|acc| (the large
    grid also within `coord_slack` of its |power| sum, chip_smoke.py's
    gate there), the same events; a repeat within REPEAT_TOL (the block's
    and the global grid's atomics add in arrival order)."""
    params, prim, txp, kw, _ = k1_emulate.doppler_tables(name)
    adc = kw['adc']
    gen = torch.Generator().manual_seed(23)
    u = torch.rand((rk.n_draws(kw['max_depth']), LANES), generator=gen)
    lane = torch.zeros(LANES)
    acc, ev = _kernel(params, prim, txp, kw, u, lane)
    assert rk.launched_doppler_power_kernel()
    acc = acc.view(adc.n_time, adc.n_freq)
    lane_ref = torch.zeros(LANES)
    amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           stats=stats, **kw)
    slack = rk.coord_slack(adc) * amp.float() if name == 'dop_global' \
        else 0.0
    chip_smoke.compare_lanes(acc, ev[0], lane, ref, n_ref, lane_ref,
                             kw['max_depth'], name, slack)
    assert int(ev[0]) > 0 and int(ev[0]) == int(n_ref)
    mode = rk.grid_mode(adc.n_time * adc.n_freq, True)
    assert mode == (2 if name == 'dop_global' else 1)
    if name == 'dop_fmcw_sonar':
        assert stats['lo_bin'] == stats['splat_2d'] > 0
    acc2, ev2 = _kernel(params, prim, txp, kw, u, torch.zeros(LANES))
    scale = float(acc.abs().max())
    assert float((acc.flatten() - acc2.flatten()).abs().max()) \
        <= chip_smoke.REPEAT_TOL * scale
    assert torch.equal(ev, ev2)


def test_twins_keep_the_grid_stride_kernel(emulated):
    """The range-Doppler pulse through a homogeneous medium runs the
    media twin, and a phased transmitter's Doppler power call the
    endpoint twin: receive_doppler_kernel<false, false, MED, EP> (the
    launch record), not the new kernel."""
    s, rx = scenes.range_doppler_scene(0)
    s.medium = scenes.stratified_homogeneous()
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    assert p.medium > 0 and p.doppler(rx.adc)
    kw = dict(adc=rx.adc, max_depth=1, time_sampling='gate',
              rx_kind='wigner', doppler=True, coherent=False,
              receive_type='raw', has_lo=False, mirror=False)
    t = torch.tensor
    _, ev = _kernel(t(p.params), t(p.prim), t(p.txp), kw, None, None,
                    medium=p.medium)
    assert rk.launched_doppler_power_kernel('media')
    assert not rk.launched_doppler_power_kernel()
    params, prim, txp, kw, _, _ = k1_emulate.endpoint_tables('ep_phased_tx')
    kw = dict(kw, doppler=True)
    _kernel(params, prim, txp, kw, None, None, ep=True)
    assert rk.launched_doppler_power_kernel('ep')
    assert not rk.launched_doppler_power_kernel('media')
