"""K1's analytic endpoint kernels (`receive_endpoint_kernel`, power, and
`receive_endpoint_coherent_kernel`, I / Q, in `csrc/receive_megakernel.cu`)
on the CPU: the source compiled once by g++ against the CUDA runtime stub
`tools/emu/cuda_runtime.h` (each block as std::threads; `tools/k1_emulate.py`)
and held against the plain version with the card's gates on the endpoint
scenes (the I / Q kernel also on the analog phased receiver, under a
mixer with an LO and with its target a moving GGX rough conductor),
bit-identical on a repeat; their footprint index held
to the full pair loop bit for bit on points built to break it; and the
analytic lobe kernel (`receive_lobe_kernel`, power and I / Q) under a
mixer with an LO.  Skips where g++ is absent."""

import contextlib
import ctypes
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
from beifong_tpu_torch.integrators import receive_kernel as rk  # noqa: E402

LANES = 4096
DEPTH = 2
SCENES = ('ep_phased_tx', 'ep_phased_rx', 'ep_four_tx', 'ep_phased_tx_coh',
          'ep_phased_rx_coh', 'ep_phased_tx_mixer', 'ep_phased_tx_ggx')


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to compile the CUDA source against the stub')
    out = str(tmp_path_factory.mktemp('k1_emulate') / 'k1.so')
    return k1_emulate._library(k1_emulate.emulate(ROOT, out))


@pytest.fixture
def emulated(lib, monkeypatch):
    """The wrapper's launch path on CPU tensors, through the emulation."""
    monkeypatch.setattr(rk, 'LIBRARY', lib)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _kernel(name, u, lane):
    params, prim, txp, kw, n_p, _ = k1_emulate.endpoint_tables(name)
    return rk._launch(params, prim, txp, None, u, None, lane, n_pulses=n_p,
                      n_lanes=LANES, seed=13, seed_step=0, patch_p=0,
                      ep=True, **k1_emulate.launch_kw(kw))


@pytest.mark.parametrize('name', SCENES)
def test_endpoint_kernel_matches_plain_version(emulated, name):
    params, prim, txp, kw, _, band = k1_emulate.endpoint_tables(name)
    coh = kw['coherent']
    gen = torch.Generator().manual_seed(21)
    u = torch.rand((rk.n_draws(DEPTH, int(txp.shape[0])), LANES),
                   generator=gen)
    lane = torch.zeros(LANES) if coh else None
    acc, ev = _kernel(name, u, lane)
    shape = (kw['adc'].n_time, 1) + ((2,) if coh else ())
    acc = acc.view(shape)
    lane_ref = torch.zeros(LANES) if coh else None
    amp = torch.zeros((kw['adc'].n_time, 1), dtype=torch.float64)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref,
        amp_out=amp if coh else None, stats=stats, **kw)
    if name.endswith('_ggx'):
        # the moving GGX target: its lobe's NEE and bounce, its Doppler
        assert stats['ggx_nee'] > 0 and stats['ggx_bounce'] > 0
        assert stats['dop_nee'] > 0
    if coh:
        chip_smoke.compare_coherent(
            torch, acc, ev[0], ref, n_ref, amp,
            rk.phase_slack(band, kw['adc']), name, lane, lane_ref,
            depth=DEPTH, quiet=True)
    else:
        chip_smoke.compare(acc, ev[0], ref, n_ref, name)
    assert int(ev[0]) > 0
    assert rk.launched_endpoint_kernel(coh)
    # a repeat gives the same bits: private rows summed in thread order
    lane2 = torch.zeros(LANES) if coh else None
    acc2, ev2 = _kernel(name, u, lane2)
    assert torch.equal(acc.flatten(), acc2.flatten())
    assert torch.equal(ev, ev2)
    if coh:
        assert torch.equal(lane, lane2)


@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_lobe_kernel_under_a_mixer_matches_plain_version(emulated,
                                                         coherent):
    """The rough plastic plate under a mixer with an LO (a beat drawn a
    lane before the ray's draws; `scenes.mixer_receiver`), depth 2, on
    injected uniforms of the lobe draw stride: the lobe kernel lane by
    lane against the plain version (power: each cell within 1e-4 x
    max|acc|; I / Q: with the phase slack), the same events, and a repeat
    bit for bit (warp rows)."""
    from beifong_tpu_torch import scenes
    s, rx = scenes.mixer_receiver(*scenes.plastic_scene('rough_plastic'))
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    kw = dict(adc=rx.adc, max_depth=DEPTH, time_sampling='gate',
              rx_kind=rk.rx_kind_of(rx), doppler=True, coherent=coherent,
              receive_type='mixer', has_lo=True, mirror=bool(p.mirror),
              lobes=p.lobes)
    gen = torch.Generator().manual_seed(17)
    u = torch.rand((rk.n_draws(DEPTH, 1, **rk.lobe_draws(p.lobes)), LANES),
                   generator=gen)

    def kernel():
        lane = torch.zeros(LANES)
        acc, ev = rk._launch(params, prim, txp, None, u, None, lane,
                             n_pulses=1, n_lanes=LANES, seed=13,
                             seed_step=0, patch_p=0,
                             **k1_emulate.launch_kw(kw))
        return acc, ev, lane
    acc, ev, lane = kernel()
    assert rk.launched_lobe_kernel(coherent)
    shape = (rx.adc.n_time, 1) + ((2,) if coherent else ())
    acc = acc.view(shape)
    lane_ref = torch.zeros(LANES)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           stats=stats, **kw)
    if coherent:
        chip_smoke.compare_coherent(
            torch, acc, ev[0], ref, n_ref, amp,
            rk.phase_slack(s.band, rx.adc), 'rough plastic mixer iq', lane,
            lane_ref, depth=DEPTH, quiet=True)
    else:
        chip_smoke.compare_lanes(acc, ev[0], lane, ref, n_ref, lane_ref,
                                 DEPTH, 'rough plastic mixer power')
    assert stats['freq_draw'] == stats['lo_freq'] == LANES
    assert stats['rplas_bounce'] > 0 and int(ev[0]) > 0
    acc2, ev2, lane2 = kernel()
    assert torch.equal(acc.flatten(), acc2.flatten())
    assert torch.equal(ev, ev2) and torch.equal(lane, lane2)


def _frame(rng, wx, wy):
    """A tilted array's to_world rows (12 floats: its axes over the
    half-widths wx, wy in columns 0 and 1, its centre in column 3)."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.zeros((3, 4))
    m[:, 0] = q[:, 0] * wx
    m[:, 1] = q[:, 1] * wy
    m[:, 2] = q[:, 2]
    m[:, 3] = (31.3, -42.1, 7.7)   # far out: the test rounds coarsely
    return m.astype(np.float32).reshape(-1), q.astype(np.float32)


def _pair_row(rng, locs, wid, n_invalid):
    """A pair row over element locations `locs` (E, 2): every ordered
    pair (E^2, midpoints shared), `n_invalid` of them with valid 0."""
    e = len(locs)
    row = [wid, wid]
    bad = set(rng.choice(e * e, size=n_invalid, replace=False).tolist())
    for i in range(e):
        for j in range(e):
            mid = 0.5 * (locs[i] + locs[j])
            base = locs[i] - locs[j]
            row += [mid[0], mid[1], base[0], base[1], rng.uniform(-3, 3),
                    0.0 if i * e + j in bad else 1.0]
    return np.asarray(row, np.float32)


def _edge_points(rng, row, m, q, n_k):
    """Points on and up to eight float steps (of one coordinate) about
    each pair's footprint edges, in the array's plane and 1e-4 off it,
    plus random ones."""
    wid = float(row[0])
    o = m.reshape(3, 4)[:, 3].astype(np.float64)
    pts = []
    mids = row[2:2 + 6 * n_k].reshape(n_k, 6)[:, 0:2].astype(np.float64)
    for ms, mt in np.unique(mids, axis=0):
        for es, et in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1)):
            p = o + (ms + es * wid) * q[:, 0] + (mt + et * wid) * q[:, 1]
            for off in (0.0, 1e-4):
                p0 = (p + off * q[:, 2]).astype(np.float32)
                for i in range(3):
                    for k in range(-8, 9):
                        # coordinate i moved by k of its float steps
                        p1 = p0.copy()
                        p1[i] = p0[i] + np.float32(k) * np.spacing(p0[i])
                        pts.append(p1)
    span = float(np.abs(mids).max()) + 2 * wid
    for _ in range(200):
        a, b = rng.uniform(-span, span, size=2)
        pts.append((o + a * q[:, 0] + b * q[:, 1]).astype(np.float32))
    pts = np.asarray(pts, np.float32)
    d = rng.normal(size=(len(pts), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([pts, d.astype(np.float32),
                           np.full((len(pts), 1), 8.5e-3, np.float32)], 1)


ARRAYS = {'E1': (1, 1, 0), 'E5': (5, 1, 3), 'E8': (8, 1, 5),
          'E8_2d': (4, 2, 4)}


@pytest.mark.parametrize('name', ARRAYS)
def test_indexed_pair_sum_equals_full_loop(lib, name):
    """pair_sum_epx (the indexed loop) against pair_sum's full loop, bit
    for bit, on an E-element array's points about its footprints' edges;
    the index's visits equal the plain version's count."""
    nx, ny, n_invalid = ARRAYS[name]
    rng = np.random.default_rng(nx * 10 + ny)
    wl = 8.5e-3
    locs = np.array([(wl / 2 * (i - (nx - 1) / 2), wl / 2 * (j - (ny - 1) / 2))
                     for i in range(nx) for j in range(ny)])
    wid = wl / 8
    row = _pair_row(rng, locs, wid, n_invalid)
    n_k = (len(row) - 2) // 6
    hx = max(float(np.abs(locs[:, 0]).max()) + wid, 2 * wl)
    hy = max(float(np.abs(locs[:, 1]).max()) + wid, 2 * wl)
    m, q = _frame(rng, hx, hy)
    pts = _edge_points(rng, row, m, q, n_k)
    n = len(pts)
    out = np.zeros(2 * n, np.float32)
    visits = np.zeros(n, np.int32)
    c = lib.get()
    c.rk_epx_check.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_float,
                               ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p]
    err = c.rk_epx_check(row.ctypes.data, n_k, m.ctypes.data, hx, hy,
                         pts.ctypes.data, n, out.ctypes.data,
                         visits.ctypes.data, None)
    assert err == 0
    idx, full = out[0::2], out[1::2]
    # bit for bit, and the edge points do reach footprints
    assert np.array_equal(idx.view(np.int32), full.view(np.int32))
    assert (full != 0).sum() > n // 4
    # the index visits few pairs, and the plain version counts the same
    assert (visits <= n_k).all()
    if n_k >= 25:
        assert visits.mean() < 0.5 * n_k
    mm = torch.from_numpy(m)
    iwx = 1.0 / torch.clamp(torch.tensor(hx, dtype=torch.float32),
                            min=1e-20)
    iwy = 1.0 / torch.clamp(torch.tensor(hy, dtype=torch.float32),
                            min=1e-20)
    ix = rk.pair_index(row, n_k, (mm[0] * iwx, mm[4] * iwx, mm[8] * iwx),
                       (mm[1] * iwy, mm[5] * iwy, mm[9] * iwy),
                       (mm[3], mm[7], mm[11]),
                       float(np.float32(abs(np.float32(hx)))
                             + np.float32(abs(np.float32(hy)))))
    assert ix is not None
    t = torch.from_numpy(pts)
    got = rk.pair_visits(ix, n_k, t[:, 0], t[:, 1], t[:, 2])
    assert np.array_equal(got.numpy(), visits)


def test_plain_version_counts_visited_pairs():
    """The plain version's `pair_visits` / `pair_sums` stats on the
    analog phased receiver: every accepted pair is visited, far fewer than
    all are, and counting leaves its results as they were."""
    params, prim, txp, kw, _, _ = k1_emulate.endpoint_tables('ep_phased_rx')
    u = rk.philox_uniforms(5, rk.n_draws(DEPTH, int(txp.shape[0])), 2048)
    st = {}
    a1, n1 = rk.receive_megakernel_ref(params, prim, txp, u, stats=st, **kw)
    a0, n0 = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
    assert torch.equal(a0, a1) and int(n0) == int(n1)
    assert st['pair_sums'] == 2048   # one cross-WDF a lane, at its ray
    assert st['pair_terms'] <= st['pair_visits'] < st['pair_tests'] / 4
    assert st['pair_tests'] == 64 * st['pair_sums']
