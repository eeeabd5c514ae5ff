"""K1's Doppler power twins of textures and of spheres, disks and
cylinders (`receive_doppler_power_kernel<true>`, `<false, true>` and
`<true, true>` in `csrc/receive_megakernel.cu`), and the coherent prims
twin under motion, a mirror and an LO, on the CPU: the source compiled
once by g++ against the CUDA runtime stub `tools/emu/cuda_runtime.h`
(each block as std::threads; `tools/k1_emulate.py`) and held against the
plain version with the card's gates (`chip_smoke.compare_lanes`, lane by
lane in power; `compare_coherent` with each ill-conditioned connection's
own phase slack in I / Q), on injected uniforms and on Philox, with the
launch record: the range-Doppler pulse with a sphere, a disk or a
cylinder closing, on its 8 x 128 grid (the block's grid) and on 256 x 128
(the global one), over a checkerboard or a bitmap ground; a GGX sphere
on the flagship's 64 bins (warp rows); golden config 2's mix_resample
with the calibration sphere.  The prims twin on a rectangle-only pulse
gives the rectangle kernel's grid, events and lane sums bit for bit, and
a path fault planted on a sphere's connections fails the I / Q gate
(the mirror chains and the rectangle-test mutation:
`test_torch_doppler_prims_chains_emulate.py`).  Skips where g++ is
absent."""

import contextlib
import dataclasses as dc
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

LANES = 1 << 12

# case: (scene, depth, time sampling, the twin's launch record, the kind
# its lanes must hit)
CASES = {
    'rd_sphere': (lambda: scenes.range_doppler_scene(target='sphere'), 2,
                  'gate', 'prims', 'sphere_hit'),
    'rd_disk': (lambda: scenes.range_doppler_scene(target='disk'), 2,
                'gate', 'prims', 'disk_hit'),
    'rd_cylinder': (lambda: scenes.range_doppler_scene(target='cylinder'),
                    2, 'gate', 'prims', 'cylinder_hit'),
    'rd_sphere_global': (lambda: _wide(scenes.range_doppler_scene(
        target='sphere')), 2, 'gate', 'prims', 'sphere_hit'),
    'ggx_sphere': (lambda: scenes.flagship_scene(
        target='sphere', material='rough_conductor'), 2, 'gate', 'prims',
        'sphere_hit'),
    'sonar_sphere': (lambda: scenes.fmcw_sonar_scene(target='sphere'), 2,
                     'fixed', 'prims', 'sphere_hit'),
    'rd_checker': (lambda: scenes.range_doppler_scene(
        ground_texture='checkerboard'), 2, 'gate', 'tex', 'tex_hit'),
    'rd_bitmap': (lambda: scenes.range_doppler_scene(
        ground_texture='bitmap'), 2, 'gate', 'tex', 'tex_hit'),
    'rd_cylinder_checker': (lambda: scenes.range_doppler_scene(
        target='cylinder', ground_texture='checkerboard'), 2, 'gate',
        'tex_prims', 'cylinder_hit'),
}
# the coherent prims twin under the Doppler conditions
COH_CASES = ('rd_sphere', 'ggx_sphere', 'sonar_sphere')


def _wide(scene):
    """A scene on a 256 x 128 grid: more cells than the block's grid
    holds, so the twin splats into the global float64 grid."""
    s, rx = scene
    rx = dc.replace(rx, adc=dc.replace(rx.adc, n_time=256))
    s.receivers[0] = rx
    return s, rx


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


def _tables(s, rx, depth, ts, coherent):
    """The scene's tables and `_launch`'s keywords (the plain version's
    with `receive_type` for `rule`)."""
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    assert tab.doppler or coherent
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind='wigner', doppler=True, coherent=coherent,
              mirror=tab.mirror, has_lo=rx.lo_waveform is not None,
              receive_type=rx.receive_type)
    if tab.textured:
        kw.update(tex=tab.tex, bmp_meta=tab.bmp_meta)
    return tab, kw


def _kernel(tab, kw, u, lane, n, prims=None):
    return rk._launch(tab.params, tab.prim, tab.txp, None, u, None, lane,
                      n_pulses=1, n_lanes=n, seed=13, seed_step=0,
                      patch_p=0, prims=tab.prims if prims is None else prims,
                      **k1_emulate.launch_kw(kw))


def _held(s, tab, kw, acc, ev, lane, u, n, stats=None, what=''):
    """The launch against the plain version on the same draws: power lane
    by lane within TOL of itself or PRIM_LANE_FLOOR of the largest lane
    (the global grid within `coord_slack` of each cell's |power| sum,
    chip_smoke.py's gate there); I / Q with the phase
    slack and each ill-conditioned connection's own, lanes in amplitude."""
    adc, depth = kw['adc'], kw['max_depth']
    coh = kw['coherent']
    uu = u if u is not None else rk.philox_uniforms(13, rk.n_draws(depth), n)
    lane_ref = torch.zeros(n)
    amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64)
    cond = torch.zeros_like(amp) if coh else None
    ref, n_ref = rk.receive_megakernel_ref(
        tab.params, tab.prim, tab.txp, uu, lane_out=lane_ref, amp_out=amp,
        cond_out=cond, stats=stats, **kw)
    if coh:
        chip_smoke.compare_coherent(
            torch, acc.view(ref.shape), ev[0], ref, n_ref, amp,
            rk.phase_slack(s.band, adc), what, lane, lane_ref, depth=depth,
            cond=cond)
    else:
        mode = rk.grid_mode(adc.n_time * adc.n_freq, True)
        slack = rk.coord_slack(adc) * amp.float() if mode == 2 else 0.0
        chip_smoke.compare_lanes(acc.view(ref.shape), ev[0], lane, ref,
                                 n_ref, lane_ref, depth, what, slack,
                                 floor=chip_smoke.PRIM_LANE_FLOOR)
    assert int(ev[0]) > 0


@pytest.mark.parametrize('name', list(CASES))
def test_doppler_power_twin_matches_plain_version(emulated, name):
    """Each Doppler power twin, on injected uniforms and on Philox, lane
    by lane against the plain version, with its launch record; the plain
    version's lanes hit the kind (or the textured ground)."""
    scene, depth, ts, twin, hit_key = CASES[name]
    s, rx = scene()
    tab, kw = _tables(s, rx, depth, ts, False)
    assert tab.prims == ('prims' in twin) and tab.textured == ('tex' in twin)
    gen = torch.Generator().manual_seed(23)
    for u in (torch.rand((rk.n_draws(depth), LANES), generator=gen), None):
        lane = torch.zeros(LANES)
        acc, ev = _kernel(tab, kw, u, lane, LANES)
        assert rk.launched_doppler_power_kernel(twin)
        assert not rk.launched_doppler_power_kernel()
        assert not rk.launched_prim_kernel(False, tab.textured)
        stats = {}
        _held(s, tab, kw, acc, ev, lane, u, LANES, stats,
              f'{name} {"injected" if u is not None else "philox"}')
        assert stats[hit_key] > 0, stats
        if name == 'ggx_sphere':
            assert stats['ggx_nee'] > 0 and stats['ggx_bounce'] > 0
        if name == 'sonar_sphere':
            assert stats['lo_bin'] == stats['splat_2d'] > 0


@pytest.mark.parametrize('name', COH_CASES)
def test_coherent_prims_twin_under_doppler_conditions(emulated, name):
    """The coherent prims twin (`receive_coherent_kernel<false, true>`)
    on a closing sphere's 2-D I / Q grid, a GGX sphere and the sonar's
    mix_resample, on injected uniforms and on Philox."""
    scene, depth, ts, _, hit_key = CASES[name]
    s, rx = scene()
    tab, kw = _tables(s, rx, depth, ts, True)
    gen = torch.Generator().manual_seed(29)
    for u in (torch.rand((rk.n_draws(depth), LANES), generator=gen), None):
        lane = torch.zeros(LANES)
        acc, ev = _kernel(tab, kw, u, lane, LANES)
        assert rk.launched_prim_kernel(True)
        stats = {}
        _held(s, tab, kw, acc, ev, lane, u, LANES, stats, f'{name} iq')
        assert stats[hit_key] > 0, stats


def test_prims_twin_on_rectangles_is_the_doppler_power_kernel(emulated):
    """The prims twin on a rectangle-only pulse of golden config 3 (a
    closing plate; its 8 bins in warp rows, which sum in a fixed order)
    gives the Doppler power kernel's grid, events and lane sums bit for
    bit, in Philox mode."""
    s, rx = scenes.pulse_train_scene(0)
    tab, kw = _tables(s, rx, 2, 'gate', False)
    assert rk.coherent_warp_rows(rx.adc, False)
    runs = []
    for prims in (True, False):
        lane = torch.zeros(LANES)
        acc, ev = _kernel(tab, kw, None, lane, LANES, prims)
        assert rk.launched_doppler_power_kernel('prims' if prims else '')
        runs.append((acc, ev, lane))
    (a0, e0, l0), (a1, e1, l1) = runs
    assert torch.equal(a0, a1) and torch.equal(e0, e1) and torch.equal(l0,
                                                                       l1)


# the path fault, in u, that each coherent cell's gate must catch
FAULT_CASES = {
    'sonar_sphere': (CASES['sonar_sphere'][0], 'fixed', 4),
    'rd_sphere': (CASES['rd_sphere'][0], 'gate', 16),
    'flagship_sphere': (lambda: scenes.flagship_scene(target='sphere'),
                        'gate', 64),
}


@pytest.mark.parametrize('name', list(FAULT_CASES))
def test_iq_gate_catches_a_curved_path_fault(emulated, name):
    """The coherent prims twin's I / Q gate, which carries a curved
    root's own rounding where it exceeds CURVED_ROOT_U u, still catches a
    wrong phase: with the target moved k u / 2 further from the receiver
    in the kernel's tables alone (each connection off it k u longer) the
    worst cell reads beyond its bound, and at least half what it reads
    against the gate of 1 u a hit (CURVED_ROOT_U infinite); on the true
    tables it reads within its bound (Philox lanes; golden config 2's
    sonar sphere, the closing sphere, PR 22's flagship sphere)."""
    import numpy as np
    import cond_gate
    scene, ts, k = FAULT_CASES[name]
    s, rx = scene()
    tab, kw = _tables(s, rx, 2, ts, True)
    slack = rk.phase_slack(s.band, rx.adc)
    l_max = s.band.c * (rx.adc.sampling_start + rx.adc.sampling_time)
    u_len = 4 * float(np.spacing(np.float32(l_max)))
    u = rk.philox_uniforms(13, rk.n_draws(2), LANES)
    runs = {r: cond_gate.plain(rk, torch, tab, kw, tab.prim, u, LANES, r)
            for r in (rk.CURVED_ROOT_U, float('inf'))}
    idx = int((tab.prim[:, 0] == rk.SPHERE).nonzero()[0])
    worst = {}
    for fault in (0, k):
        lane = torch.zeros(LANES)
        acc, ev = _kernel(dc.replace(tab, prim=cond_gate.moved(
            torch, tab.prim, idx, fault, u_len)), kw, None, lane, LANES)
        assert rk.launched_prim_kernel(True)
        for r, (ref, n_ref, amp, cond, lane_ref) in runs.items():
            worst[(fault, r)] = chip_smoke.compare_coherent(
                torch, acc.view(ref.shape), ev[0], ref, n_ref, amp, slack,
                f'{name} fault {fault} u', lane, lane_ref, depth=2,
                cond=cond, check=fault == 0 and r == rk.CURVED_ROOT_U
                )['worst']
    assert worst[(k, rk.CURVED_ROOT_U)] > 1.0, worst
    assert worst[(k, rk.CURVED_ROOT_U)] >= 0.5 * worst[(k, float('inf'))], \
        worst
