"""End to end on the CPU: the port's receive() -> develop_signal ->
pulse_compress range profile against the JAX package's jnp wavefront on
the flagship scene and the mesh scene, and against the 2R/c anchor."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from beifong_tpu.dsp import pulse as pulse_j
from beifong_tpu.receive import receive as receive_j
from beifong_tpu.receive import develop_signal as develop_j

import beifong_tpu_torch as bt
from beifong_tpu_torch.dsp import pulse as pulse_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.scenes import flagship_scene, mesh_scene, \
    round_trip_bin

from test_torch_mesh import twin_scene

torch.set_num_threads(1)

SEEDS = 3
SPP = 1 << 14


def _replica(adc):
    """Unit pulse envelope of the flagship's 2 ms pulse at the ADC rate."""
    n = max(2, int(round(2e-3 / (adc.sampling_time / adc.n_time))))
    return np.ones(n, np.complex64)


@pytest.fixture(scope='module')
def profiles():
    s_t, rx_t = flagship_scene()
    sd_t = s_t.compile(device='cpu')
    s_j, rx_j = g._build_scene()
    sd_j = s_j.compile()
    tp = np.zeros(rx_t.adc.n_time)
    tj = np.zeros(rx_t.adc.n_time)
    for seed in range(SEEDS):
        a, n = bt.receive(s_t, sd_t, rx_t, seed=seed, spp=SPP, max_depth=2,
                          time_sampling='gate', device='cpu')
        assert a.shape == (64, 1, 3) and n == SPP
        tp += bt.develop_signal(a, n, rx_t.adc)[:, 0, 0].numpy() / SEEDS
        a, n = receive_j(s_j, sd_j, rx_j, seed=100 + seed, spp=SPP,
                         max_depth=2, time_sampling='gate', use_pallas=False)
        tj += np.asarray(develop_j(a, n, rx_j.adc))[:, 0, 0] / SEEDS
    rep = _replica(rx_t.adc)
    cp = np.abs(pulse_t.pulse_compress(
        torch.from_numpy(tp.astype(np.complex64)),
        torch.from_numpy(rep)).numpy())
    cj = np.abs(np.asarray(pulse_j.pulse_compress(
        jnp.asarray(tj.astype(np.complex64)), jnp.asarray(rep))))
    return tp, tj, cp, cj, round_trip_bin(s_t, rx_t)


def test_developed_profile_matches_jax(profiles):
    tp, tj, _, _, _ = profiles
    assert np.isfinite(tp).all() and tp.sum() > 0
    assert abs(int(tp.argmax()) - int(tj.argmax())) <= 1
    # signed aperture weights make totals heavy-tailed: compare the energy
    # in the peak window with the bound of tests/test_pallas_receive.py
    pk = int(tj.argmax())
    lo, hi = max(pk - 3, 0), pk + 4
    assert tp[lo:hi].sum() == pytest.approx(tj[lo:hi].sum(), rel=0.6)


def test_compressed_profile_matches_jax(profiles):
    _, _, cp, cj, _ = profiles
    assert abs(int(cp.argmax()) - int(cj.argmax())) <= 1


def test_profile_peaks_at_round_trip_delay(profiles):
    tp, _, cp, _, anchor = profiles
    assert anchor == pytest.approx(24.67, abs=0.01)
    assert abs(int(tp.argmax()) - anchor) <= 2
    assert abs(int(cp.argmax()) - anchor) <= 2


def test_omni_receiver_profile_peaks_at_anchor():
    s, rx = flagship_scene(rx_kind='omni', ground=False)
    sd = s.compile(device='cpu')
    a, n = bt.receive(s, sd, rx, seed=4, spp=SPP, max_depth=2,
                      time_sampling='gate', device='cpu')
    prof = bt.develop_signal(a, n, rx.adc)[:, 0, 0].numpy()
    assert prof.sum() > 0
    assert abs(int(prof.argmax()) - round_trip_bin(s, rx)) <= 2


def test_receive_is_deterministic_per_seed():
    s, rx = flagship_scene()
    sd = s.compile(device='cpu')
    kw = dict(spp=2048, max_depth=3, time_sampling='gate', device='cpu')
    a1, _ = bt.receive(s, sd, rx, seed=9, **kw)
    a2, _ = bt.receive(s, sd, rx, seed=9, **kw)
    a3, _ = bt.receive(s, sd, rx, seed=10, **kw)
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)


def test_receive_draws_the_kernels_philox_stream():
    # one seed, one stream: the CPU feeds the plain version the uniforms
    # that the kernel's generator draws on a card
    s, rx = flagship_scene()
    sd = s.compile(device='cpu')
    a, n = bt.receive(s, sd, rx, seed=3, spp=2048, max_depth=2,
                      time_sampling='gate', device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    ref, _ = rk.receive_megakernel_ref(
        torch.from_numpy(p.params), torch.from_numpy(p.prim),
        torch.from_numpy(p.txp), rk.philox_uniforms(3, rk.n_draws(2), n),
        adc=rx.adc, max_depth=2, time_sampling='gate', rx_kind='wigner')
    assert torch.equal(a[..., 0], ref) and ref.shape == (64, 1)


def test_receive_packs_tables_once_per_scene_data(monkeypatch):
    """The pack and the scope check (both read tables back from a card)
    run once per SceneData, whatever the route asks."""
    calls, checks = [], []
    pack, supported = rk.pack_scene, rk.supported
    monkeypatch.setattr(rk, 'pack_scene',
                        lambda *a: calls.append(1) or pack(*a))
    monkeypatch.setattr(rk, 'supported',
                        lambda *a: checks.append(1) or supported(*a))
    s, rx = flagship_scene()
    sd = s.compile(device='cpu')
    kw = dict(spp=256, max_depth=1, device='cpu')
    bt.receive(s, sd, rx, seed=1, **kw)
    bt.receive(s, sd, rx, seed=2, **kw)
    bt.receive(s, sd, rx, seed=2, use_kernel=True, **kw)
    assert len(calls) == 1 and len(checks) == 1
    bt.receive(s, s.compile(device='cpu'), rx, seed=1, **kw)
    assert len(calls) == 2 and len(checks) == 2


def test_mesh_profile_matches_jax_wavefront():
    """The mesh scene at n_side 9: the port's receive() (plain version of
    the mesh kernel, direction strata at 256 tiles) against the JAX jnp
    wavefront, averaged over seeds; the peak bins agree within one, as
    tests/test_pallas_receive.py holds the TPU kernel on this scene."""
    s_t, rx_t = mesh_scene(n_side=9)
    sd_t = s_t.compile(device='cpu')
    s_j, rx_j = twin_scene('jax', n_side=9)
    sd_j = s_j.compile(use_bvh=False)
    tp = np.zeros(rx_t.adc.n_time)
    tj = np.zeros(rx_t.adc.n_time)
    for seed in range(SEEDS):
        a, n = bt.receive(s_t, sd_t, rx_t, seed=seed, spp=1 << 18,
                          max_depth=2, time_sampling='gate', device='cpu')
        assert n == 1 << 18
        tp += bt.develop_signal(a, n, rx_t.adc)[:, 0, 0].numpy() / SEEDS
        a, n = receive_j(s_j, sd_j, rx_j, seed=100 + seed, spp=1 << 13,
                         max_depth=2, time_sampling='gate', use_pallas=False)
        tj += np.asarray(develop_j(a, n, rx_j.adc))[:, 0, 0] / SEEDS
    assert np.isfinite(tp).all() and tp.sum() > 0
    assert abs(int(tp.argmax()) - int(tj.argmax())) <= 1
    assert abs(int(tp.argmax()) - round_trip_bin(s_t, rx_t)) <= 2
