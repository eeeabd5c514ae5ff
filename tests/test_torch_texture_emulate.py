"""K1's texture twins (`receive_flagship_kernel<true>` and
`receive_coherent_kernel<true>` in `csrc/receive_megakernel.cu`) on the
CPU: the source compiled once by g++ against the CUDA runtime stub
`tools/emu/cuda_runtime.h` (each block as std::threads;
`tools/k1_emulate.py`) and held against the plain version with the card's
gates (`chip_smoke.compare`, `compare_coherent`) on the flagship scene's
checkerboard and bitmap grounds, on injected uniforms and on Philox; a
uniform checkerboard through the twin equals the untextured scene through
its kernel bit for bit; the launch record shows which ran.  Skips where
g++ is absent."""

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

from test_torch_receive_kernel_textures import textured_flagship  # noqa: E402

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


def _tables(scene, coherent):
    s, rx = scene
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    kw = dict(adc=rx.adc, max_depth=2 if coherent else 3,
              time_sampling='gate', rx_kind='wigner', doppler=coherent,
              coherent=coherent, mirror=False, rule=0, has_lo=False)
    return s, rx, tab, kw


def _kernel(tab, kw, u, lane, tex=True):
    return rk._launch(tab.params, tab.prim, tab.txp, None, u, None, lane,
                      n_pulses=1, n_lanes=LANES, seed=13, seed_step=0,
                      patch_p=0, tex=tab.tex if tex else None,
                      bmp_meta=tab.bmp_meta if tex else None, **kw)


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
@pytest.mark.parametrize('texture', ['checkerboard', 'bitmap'])
def test_texture_twin_matches_plain_version(emulated, texture, coherent):
    """Injected uniforms and Philox: power per cell within TOL x max|acc|
    with equal events, I / Q with the phase slack; the launch record."""
    s, rx, tab, kw = _tables(scenes.flagship_scene(ground_texture=texture),
                             coherent)
    nd = rk.n_draws(kw['max_depth'])
    for u in (torch.rand((nd, LANES), generator=torch.Generator()
                         .manual_seed(3)), None):
        lane = torch.zeros(LANES) if coherent else None
        acc, ev = _kernel(tab, kw, u, lane)
        assert rk.launched_tex_kernel(coherent)
        assert not rk.launched_tex_kernel(not coherent)
        uu = u if u is not None else rk.philox_uniforms(13, nd, LANES)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64)
        stats = {}
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, uu, stats=stats,
            amp_out=amp if coherent else None, tex=tab.tex,
            bmp_meta=tab.bmp_meta, **{k: v for k, v in kw.items()
                                      if k != 'rule'})
        assert stats['tex_hit'] > 0
        what = f'{texture} {"iq" if coherent else "power"}'
        if coherent:
            chip_smoke.compare_coherent(
                torch, acc.view(ref.shape), ev[0], ref, n_ref, amp,
                rk.phase_slack(s.band, rx.adc), what, depth=2, quiet=True)
        else:
            chip_smoke.compare(acc.view(ref.shape), ev[0], ref, n_ref, what)


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_uniform_checkerboard_is_the_untextured_kernel(emulated, coherent):
    """The texture twin on a checkerboard of 1.0 / 1.0 gives the
    untextured kernel's grid and lane sums on the untextured scene, bit
    for bit, in Philox mode."""
    runs = []
    for scene, tex in ((textured_flagship('port', 'uniform'), True),
                       (scenes.flagship_scene(), False)):
        _, _, tab, kw = _tables(scene, coherent)
        lane = torch.zeros(LANES) if coherent else None
        acc, ev = _kernel(tab, kw, None, lane, tex)
        assert rk.launched_tex_kernel(coherent) == tex
        runs.append((acc, ev, lane))
    (a0, e0, l0), (a1, e1, l1) = runs
    assert torch.equal(a0, a1) and torch.equal(e0, e1)
    assert l0 is None or torch.equal(l0, l1)
