"""K1's prims twins (`receive_flagship_kernel<false, true>` and
`receive_coherent_kernel<false, true>` in `csrc/receive_megakernel.cu`) on
the CPU: the source compiled once by g++ against the CUDA runtime stub
`tools/emu/cuda_runtime.h` (each block as std::threads;
`tools/k1_emulate.py`) and held against the plain version with the card's
gates (`chip_smoke.compare`, `compare_coherent`) on the flagship scene
with a sphere, a disk or a cylinder for its target (and the twins that
carry the texture codes, `<true, true>`, on the sphere over a
checkerboard ground), on injected uniforms and on Philox, with the
launch record; the twin on the all-rectangle
flagship scene gives the untextured kernel's grid bit for bit.  Skips
where g++ is absent."""

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

LANES = 1 << 12


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


def _tables(target, coherent):
    """The flagship scene with `target` for its target ('sphere_checker':
    the sphere over a checkerboard ground), its tables and keywords."""
    ground = 'checkerboard' if target == 'sphere_checker' else None
    s, rx = scenes.flagship_scene(target=target.split('_')[0],
                                  ground_texture=ground)
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    kw = dict(adc=rx.adc, max_depth=2 if coherent else 3,
              time_sampling='gate', rx_kind='wigner', doppler=coherent,
              coherent=coherent, mirror=False, rule=0, has_lo=False)
    if tab.textured:
        kw.update(tex=tab.tex, bmp_meta=tab.bmp_meta)
    return s, rx, tab, kw


def _kernel(tab, kw, u, lane, prims=True):
    return rk._launch(tab.params, tab.prim, tab.txp, None, u, None, lane,
                      n_pulses=1, n_lanes=LANES, seed=13, seed_step=0,
                      patch_p=0, prims=prims, **kw)


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
@pytest.mark.parametrize('target', ['sphere', 'disk', 'cylinder',
                                    'sphere_checker'])
def test_prims_twin_matches_plain_version(emulated, target, coherent):
    """Injected uniforms and Philox: power per cell within TOL x max|acc|
    with equal events, I / Q with the phase slack and each ill-conditioned
    connection's own (`cond_out`) and lane by lane in amplitude; the
    launch record; the plain version's lanes hit the target."""
    s, rx, tab, kw = _tables(target, coherent)
    textured = target == 'sphere_checker'
    assert tab.prims and tab.textured == textured
    nd = rk.n_draws(kw['max_depth'])
    for u in (torch.rand((nd, LANES), generator=torch.Generator()
                         .manual_seed(3)), None):
        lane = torch.zeros(LANES) if coherent else None
        acc, ev = _kernel(tab, kw, u, lane)
        assert rk.launched_prim_kernel(coherent, textured)
        assert not rk.launched_prim_kernel(coherent, not textured)
        assert not rk.launched_prim_kernel(not coherent, textured)
        assert not rk.launched_tex_kernel(coherent)
        uu = u if u is not None else rk.philox_uniforms(13, nd, LANES)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64)
        cond = torch.zeros_like(amp)
        lane_ref = torch.zeros(LANES) if coherent else None
        stats = {}
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, uu, stats=stats,
            amp_out=amp if coherent else None,
            cond_out=cond if coherent else None, lane_out=lane_ref,
            **{k: v for k, v in kw.items() if k != 'rule'})
        assert stats[f'{target.split("_")[0]}_hit'] > 0
        assert (stats['tex_hit'] > 0) == textured
        what = f'{target} {"iq" if coherent else "power"}'
        if coherent:
            chip_smoke.compare_coherent(
                torch, acc.view(ref.shape), ev[0], ref, n_ref, amp,
                rk.phase_slack(s.band, rx.adc), what, lane, lane_ref,
                depth=2, cond=cond)
        else:
            chip_smoke.compare(acc.view(ref.shape), ev[0], ref, n_ref, what)


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_prims_twin_on_rectangles_is_the_flagship_kernel(emulated, coherent):
    """The prims twin on the all-rectangle flagship scene gives the
    rectangle-only kernel's grid, events and lane sums bit for bit, in
    Philox mode."""
    _, _, tab, kw = _tables('plate', coherent)
    runs = []
    for prims in (True, False):
        lane = torch.zeros(LANES) if coherent else None
        acc, ev = _kernel(tab, kw, None, lane, prims)
        assert rk.launched_prim_kernel(coherent) == prims
        runs.append((acc, ev, lane))
    (a0, e0, l0), (a1, e1, l1) = runs
    assert torch.equal(a0, a1) and torch.equal(e0, e1)
    assert l0 is None or torch.equal(l0, l1)
