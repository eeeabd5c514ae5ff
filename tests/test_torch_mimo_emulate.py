"""K1's MIMO array kernel (`receive_mimo_array_kernel` in
`csrc/receive_megakernel.cu`: the MIMO configuration on the coherent
kernel's turns) on the CPU: the source compiled once by g++ against the
CUDA runtime stub `tools/emu/cuda_runtime.h` (each block as std::threads;
`tools/k1_emulate.py`) and held against the plain version lane by lane
with the card's gate on golden config 6 (the block's grid of doubles), in
fixed sampling at depth 3, and on 1,024 fast-time bins (the global grid);
the launch record shows the kernel ran, and the MIMO media and endpoint
twins keep the grid-stride kernel.  Skips where g++ is absent."""

import contextlib
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card's gates)
import k1_emulate  # noqa: E402
from beifong_tpu_torch import scenes  # noqa: E402
from beifong_tpu_torch.integrators import receive_kernel as rk  # noqa: E402

LANES = 1 << 16


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


@pytest.mark.parametrize('name', list(k1_emulate.MIMO_CASES))
def test_mimo_array_kernel_matches_plain_version(emulated, name):
    """Injected uniforms: every lane's amplitude sum against the plain
    version's, all 16 channels of each cell within 1e-4 x max(|I|, |Q|)
    plus the MIMO phase slack times the cell's amplitude sum, the same
    events, the launch record of the MIMO array kernel; a repeat within
    REPEAT_TOL (float64 atomics add in arrival order)."""
    params, prim, txp, kw, band = k1_emulate.mimo_tables(name)
    adc = kw['adc']
    gen = torch.Generator().manual_seed(17)
    u = torch.rand((rk.n_draws(kw['max_depth']), LANES), generator=gen)
    lane = torch.zeros(LANES)
    acc, ev = _kernel(params, prim, txp, kw, u, lane)
    assert rk.launched_mimo_kernel() and not rk.launched_mesh_kernel()
    n_ch = 2 * int(kw['eoff'].shape[0])
    acc = acc.view(adc.n_time, 1, n_ch)
    lane_ref = torch.zeros(LANES)
    amp = torch.zeros((adc.n_time, 1), dtype=torch.float64)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           stats=stats, **kw)
    assert int(ev[0]) > 0 and stats['mimo_elem'] == 8 * stats['phase']
    assert (stats['trace'] > stats['phased_ray']) \
        == (kw['max_depth'] > 1)
    assert rk.grid_mode(adc.n_time, True, True, n_ch // 2) \
        == (2 if name == 'mimo_global_grid' else 1)
    chip_smoke.compare_coherent(
        torch, acc, ev[0], ref, n_ref, amp,
        rk.phase_slack(band, adc, mimo=True), name, lane, lane_ref,
        depth=kw['max_depth'], quiet=True)
    lane2 = torch.zeros(LANES)
    acc2, ev2 = _kernel(params, prim, txp, kw, u, lane2)
    assert torch.equal(ev, ev2) and torch.equal(lane, lane2)
    assert float((acc.flatten() - acc2).abs().max()) \
        <= chip_smoke.REPEAT_TOL * float(amp.max())


def test_mimo_array_kernel_philox_matches_plain_version(emulated):
    """Philox: config 6 against the plain version on the same stream,
    lane by lane."""
    params, prim, txp, kw, band = k1_emulate.mimo_tables('mimo_config6')
    adc = kw['adc']
    lane = torch.zeros(LANES)
    acc, ev = _kernel(params, prim, txp, kw, None, lane)
    assert rk.launched_mimo_kernel()
    u = rk.philox_uniforms(13, rk.n_draws(kw['max_depth']), LANES)
    lane_ref = torch.zeros(LANES)
    amp = torch.zeros((adc.n_time, 1), dtype=torch.float64)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    chip_smoke.compare_coherent(
        torch, acc.view(adc.n_time, 1, -1), ev[0], ref, n_ref, amp,
        rk.phase_slack(band, adc, mimo=True), 'config 6 philox', lane,
        lane_ref, depth=kw['max_depth'], quiet=True)


def test_mimo_twins_keep_the_grid_stride_kernel(emulated):
    """Config 6 through a homogeneous medium (the media twin) and with a
    second, area transmitter (the endpoint twin) launch
    receive_mimo_kernel<MED, EP> (the launch record): not the MIMO array
    kernel."""
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry import shapes as sh
    from beifong_tpu_torch.radar import area_transmitter
    runs = []
    for twin in ('media', 'ep'):
        s, rx = scenes.mimo_beamform_scene()
        if twin == 'media':
            s.medium = scenes.stratified_homogeneous()
        else:
            s.add(area_transmitter('tx2', s.transmitters[0].waveform,
                                   resample_freq=True))
            s.add(sh.rectangle(to_world=np.asarray(tf.compose(
                tf.look_at([-0.1, 0, 0], [-0.1, -1, 0]),
                tf.scale([0.004, 0.004, 1.0]))), transmitter='tx2'))
        sd = s.compile(use_bvh=False, device='cpu')
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                            rx.id))
        assert (p.medium > 0) == (twin == 'media')
        kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
                  rx_kind='phased', doppler=True, coherent=False,
                  receive_type='raw', has_lo=False, mirror=False,
                  rxph=torch.tensor(p.rxph),
                  eoff=rk.array_offsets(s, sd, rx, 'cpu'))
        extra = {'medium': p.medium} if twin == 'media' else \
            {'ep': True, 'php': torch.tensor(p.php)}
        runs.append((p, kw, extra))
    for p, kw, extra in runs:
        acc, ev = rk._launch(torch.tensor(p.params), torch.tensor(p.prim),
                             torch.tensor(p.txp), None, None, None, None,
                             n_pulses=1, n_lanes=1 << 12, seed=3,
                             seed_step=0, patch_p=0,
                             **k1_emulate.launch_kw(kw), **extra)
        assert not rk.launched_mimo_kernel()
        assert bool(torch.isfinite(acc).all())
