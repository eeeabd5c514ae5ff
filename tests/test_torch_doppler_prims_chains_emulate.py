"""K1's Doppler twins in the g++ emulation (`tools/k1_emulate.py`; the
fixtures and helpers of `test_torch_doppler_prims_emulate.py`), at the
widths that take longest: a smooth conductor sphere (the metal
calibration target) closes mirror chains on the transmitter at 2^18
lanes, in power and in I / Q, and matches the plain version lane by lane
there; and the Doppler power twin testing a curved record as a
rectangle moves the range-Doppler anchor.  Skips where g++ is absent."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the fixtures and helpers (their module puts the repository and its
# tools on the path)
from test_torch_doppler_prims_emulate import (  # noqa: E402,F401
    _held, _kernel, _tables, emulated, lib)
import chip_smoke  # noqa: E402  (the card's gates)
import k1_emulate  # noqa: E402
from beifong_tpu_torch import scenes  # noqa: E402
from beifong_tpu_torch.integrators import receive_kernel as rk  # noqa: E402

MIRROR_LANES = 1 << 18


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_mirror_sphere_chains_close(emulated, coherent):
    """A smooth conductor sphere (the metal calibration target): at
    MIRROR_LANES lanes some receive rays bounce off it straight into the
    transmitter's aperture (direct hits after the mirror bounce: those of
    depth 2 less those of depth 1), and the twin matches the plain
    version lane by lane there too."""
    s, rx = scenes.flagship_scene(target='sphere', material='conductor')
    n = MIRROR_LANES
    tab, kw = _tables(s, rx, 2, 'gate', coherent)
    assert tab.mirror and tab.prims
    lane = torch.zeros(n)
    acc, ev = _kernel(tab, kw, None, lane, n)
    stats = {}
    _held(s, tab, kw, acc, ev, lane, None, n, stats,
          f'mirror sphere {"iq" if coherent else "power"}')
    first = {}
    rk.receive_megakernel_ref(
        tab.params, tab.prim, tab.txp,
        rk.philox_uniforms(13, rk.n_draws(1), n), stats=first,
        **dict(kw, max_depth=1))
    closed = stats['direct'] - first['direct']
    assert stats['mirror_bounce'] > 0 and closed > 0, (stats, first)


def _doppler_peak(acc):
    """The Doppler bin of the spectrum summed over the (CW) time bins."""
    return int(acc.double().sum(0).argmax())


@pytest.mark.parametrize('target', ['sphere', 'cylinder'])
def test_rectangle_test_of_a_curved_record_moves_the_anchor(emulated,
                                                           target):
    """The Doppler power twin (<true, true>) on the closing target over
    the checkerboard ground: its echo puts the spectrum's peak on the
    target's Doppler bin (range_doppler's anchor, `chip_smoke.
    check_range_doppler`'s arithmetic), and the target moves the grid by
    more than 100 x the parity bound against the ground alone.  With the
    target's record tested as a rectangle (column 0 set to RECTANGLE: the
    unit square of its object frame, edge-on to the apertures or under
    the ground) its echo all but vanishes, and the peak moves to the
    static ground's ridge at 0 Hz: the anchor catches it."""
    import numpy as np
    n = 1 << 16
    s, rx = scenes.range_doppler_scene(0, target, 'checkerboard')
    tab, kw = _tables(s, rx, 2, 'gate', False)
    p = np.array([0.0, -scenes.RANGE_DOPPLER['R0'], 0.0])
    vel = np.array([0.0, scenes.RANGE_DOPPLER['v'], 0.0])
    f_dop = sum(40e3 * (vel @ ((e - p) / np.linalg.norm(e - p)))
                / s.band.c for e in (np.array([0.3, 0, 0]),
                                     np.array([-0.3, 0, 0])))
    cfg = rx.adc
    f_bin = (40e3 + f_dop - cfg.freq_lo) / (cfg.freq_hi - cfg.freq_lo) \
        * cfg.n_freq - 0.5
    f_0 = (40e3 - cfg.freq_lo) / (cfg.freq_hi - cfg.freq_lo) * cfg.n_freq \
        - 0.5
    s0, rx0 = scenes.range_doppler_scene(0, 'plate', 'checkerboard')
    del s0.shapes[2]
    tab0, kw0 = _tables(s0, rx0, 2, 'gate', False)
    base = _kernel(tab0, kw0, None, None, n)[0].view(cfg.n_time, cfg.n_freq)
    wrong = tab.prim.clone()
    wrong[2, 0] = float(rk.RECTANGLE)
    peaks, floors = {}, {}
    for which, prim in (('right', tab.prim), ('wrong', wrong)):
        acc, _ = rk._launch(tab.params, prim, tab.txp, None, None, None,
                            None, n_pulses=1, n_lanes=n, seed=13,
                            seed_step=0, patch_p=0, prims=True,
                            **k1_emulate.launch_kw(kw))
        assert rk.launched_doppler_power_kernel('tex_prims')
        acc = acc.view(cfg.n_time, cfg.n_freq)
        peaks[which] = _doppler_peak(acc)
        floors[which] = float((acc - base).abs().max()) \
            / (chip_smoke.TOL * float(base.abs().max()))
    assert abs(peaks['right'] - f_bin) <= 1 and floors['right'] > 100, \
        (peaks, floors)
    assert abs(peaks['wrong'] - f_bin) > 1, (peaks, floors)
    assert abs(peaks['wrong'] - f_0) <= 1, (peaks, f_0)
