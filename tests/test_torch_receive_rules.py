"""The receive rules on the analytic endpoint and lobe scenes: the plain
PyTorch version against the JAX package's Pallas megakernel (interpret
mode) on identical uniforms, for a phased transmitter under a mixer with
an LO (I / Q: the coherent endpoint kernel's plain version) and a rough
plastic plate under a mixer with an LO (power and I / Q: the lobe twins'
plain version).  A mixer draws its beat a lane before the ray's draws, so
every draw index moves by one, and the lobe mixture of the receive ray is
a lane's own.  The CUDA kernels are held against the plain version on
these scenes by tests/test_torch_endpoint_emulate.py (g++ emulation) and
tests/test_torch_gpu.py (the card)."""

import dataclasses as dc

import numpy as np
import pytest
import torch

from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_phased import assert_iq_matches_jax, endpoint_scene
from test_torch_receive_kernel_doppler import _jax_run
from test_torch_receive_kernel_lobes import lobe_scene

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell; I / Q add the phase slack


def mixer(s, rx, n_time=16):
    """The JAX scene's receiver as `scenes.mixer_receiver` makes the
    port's: a mixer with the transmitter's waveform as its LO over a beat
    window [0, 2 kHz], on n_time bins."""
    rx = dc.replace(rx, receive_type='mixer',
                    lo_waveform=s.transmitters[0].waveform,
                    adc=dc.replace(rx.adc, freq_lo=0.0, freq_hi=2e3,
                                   n_time=n_time))
    s.receivers[0] = rx
    return s, rx


def test_phased_tx_mixer_iq_matches_jax_megakernel():
    """A phased transmitter steered at its target, depth 2, 1,024 lanes,
    gate, a mixer with an LO (has_lo): I and Q of each cell within the
    coherent parity's bound (`assert_iq_matches_jax`: TOL x max(|I|, |Q|)
    plus `phase_slack` times the cell's amplitude sum)."""
    s, rx = mixer(*endpoint_scene('jax', 'phased_tx', 12.7, 4))
    stats = assert_iq_matches_jax(s, rx, 2, 1024, seed=6)
    assert stats['freq_draw'] == stats['lo_freq'] == 1024
    assert stats['phase_lo'] == stats['phase'] > 0
    assert stats['pair_terms'] > 0


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_rough_plastic_mixer_matches_jax_megakernel(coherent):
    """The rough plastic plate (a lobe pick a bounce) under a mixer with
    an LO, depth 2, 2,048 lanes, gate: power within TOL x max|acc| per
    cell, I / Q plus the phase slack times the cell's amplitude sum,
    events within 1e-3; the CPU wrapper is the plain version."""
    s, rx = mixer(*lobe_scene('jax', 'rough_plastic'))
    n_lanes, depth = 2048, 2
    out_j, cnt_j, u, tab = _jax_run(s, rx, n_lanes, depth, 3, 'gate',
                                    coherent)
    lobes = rk.lobe_flags(tab['prim'].numpy())
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling='gate',
              rx_kind=tab['rx_kind'], doppler=True, coherent=coherent,
              receive_type='mixer', has_lo=True, lobes=lobes)
    stats = {}
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64)
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
    assert stats['rplas_nee'] > 0 and stats['rplas_bounce'] > 0
    assert stats['freq_draw'] == stats['lo_freq'] == n_lanes
    acc_w, n_w = rk.receive_megakernel(tab['params'], tab['prim'],
                                       tab['txp'], n_lanes=n_lanes,
                                       uniforms=u, **kw)
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)
