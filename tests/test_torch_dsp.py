"""The port's matched filter (torch.fft) against beifong_tpu.dsp.pulse on
seeded complex input."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.dsp import pulse as pj
from beifong_tpu_torch.dsp import pulse as pt

torch.set_num_threads(1)

SHAPES = [((64,), 3), ((4, 256), 17), ((2, 3, 100), 8)]


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want):
    # complex64 FFTs of two libraries: agree to 1e-5 relative, with the
    # absolute slack scaled to the output's magnitude (near-zero outputs)
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('shape, m', SHAPES)
def test_correlate_full(shape, m):
    rng = np.random.default_rng(m)
    x, rep = _cplx(rng, shape), _cplx(rng, (m,))
    got = pt.correlate_full(torch.from_numpy(x), torch.from_numpy(rep))
    _close(got.numpy(), pj.correlate_full(jnp.asarray(x), jnp.asarray(rep)))


@pytest.mark.parametrize('shape, m', SHAPES)
def test_pulse_compress_with_window(shape, m):
    rng = np.random.default_rng(100 + m)
    x, rep = _cplx(rng, shape), _cplx(rng, (m,))
    w = np.hanning(m + 2).astype(np.float32)
    got = pt.pulse_compress(torch.from_numpy(x), torch.from_numpy(rep),
                            window=torch.from_numpy(w))
    _close(got.numpy(), pj.pulse_compress(jnp.asarray(x), jnp.asarray(rep),
                                          window=jnp.asarray(w)))
    got = pt.pulse_compress(torch.from_numpy(x), torch.from_numpy(rep))
    _close(got.numpy(), pj.pulse_compress(jnp.asarray(x), jnp.asarray(rep)))


@pytest.mark.parametrize('n, n_fft, n_taps, hist', [
    (256, 64, 9, False), (300, 128, 17, True), (64, 32, 5, True)])
def test_overlap_save(n, n_fft, n_taps, hist):
    rng = np.random.default_rng(n)
    x, rep = _cplx(rng, (3, n)), _cplx(rng, (n_taps,))
    h = _cplx(rng, (3, n_taps - 1)) if hist else None
    hf_t = pt.matched_filter_freq(torch.from_numpy(rep), n_fft)
    hf_j = pj.matched_filter_freq(jnp.asarray(rep), n_fft)
    _close(hf_t.numpy(), hf_j)
    got = pt.overlap_save(torch.from_numpy(x), hf_t, n_fft, n_taps,
                          None if h is None else torch.from_numpy(h))
    _close(got.numpy(), pj.overlap_save(jnp.asarray(x), hf_j, n_fft, n_taps,
                                        None if h is None else jnp.asarray(h)))


def test_compression_gain():
    rng = np.random.default_rng(7)
    rep = _cplx(rng, (33,))
    got = float(pt.compression_gain(torch.from_numpy(rep)))
    assert got == pytest.approx(float(pj.compression_gain(jnp.asarray(rep))),
                                rel=1e-5)


# ---------------------------------------------------------------------------
# windows, FIR, resampling and range-Doppler processing (ROADMAP A6)
# ---------------------------------------------------------------------------

from beifong_tpu.dsp import fir as fj  # noqa: E402
from beifong_tpu.dsp import rangedoppler as rdj  # noqa: E402
from beifong_tpu.dsp import resample as rsj  # noqa: E402
from beifong_tpu.dsp import windows as wj  # noqa: E402
from beifong_tpu_torch.dsp import fir as ft  # noqa: E402
from beifong_tpu_torch.dsp import rangedoppler as rdt  # noqa: E402
from beifong_tpu_torch.dsp import resample as rst  # noqa: E402
from beifong_tpu_torch.dsp import windows as wt  # noqa: E402


@pytest.mark.parametrize('name', ['rect', 'hann', 'hamming', 'blackman',
                                  'blackman_harris', 'taylor'])
@pytest.mark.parametrize('n', [1, 16, 129])
def test_windows(name, n):
    got = wt.get(name, n, device='cpu')
    assert got.dtype == torch.float32
    _close(got.numpy(), wj.get(name, n))


def test_taylor_options():
    _close(wt.taylor(64, nbar=6, sll_db=-40.0, device='cpu').numpy(),
           wj.taylor(64, nbar=6, sll_db=-40.0))


@pytest.mark.parametrize('n_taps, cutoff, window', [
    (32, 0.25, 'hamming'), (17, 0.5, 'hann'), (64, 0.125, 'blackman')])
def test_design_lowpass(n_taps, cutoff, window):
    _close(ft.design_lowpass(n_taps, cutoff, window, device='cpu').numpy(),
           fj.design_lowpass(n_taps, cutoff, window))


@pytest.mark.parametrize('complex_baseband', [True, False])
def test_lfm_chirp(complex_baseband):
    args = (256, 20e3, 500.0, 4e3, 8e-3, complex_baseband)
    _close(ft.lfm_chirp(*args, device='cpu').numpy(), fj.lfm_chirp(*args))


@pytest.mark.parametrize('up, down, shape, cplx', [
    (1, 8, (1024,), True), (3, 2, (2, 100), False), (4, 1, (3, 37), True),
    (6, 4, (50,), False)])
def test_resample_poly(up, down, shape, cplx):
    rng = np.random.default_rng(up * 10 + down)
    x = _cplx(rng, shape) if cplx else \
        rng.standard_normal(shape).astype(np.float32)
    got = rst.resample_poly(torch.from_numpy(x), up, down)
    _close(got.numpy(), rsj.resample_poly(jnp.asarray(x), up, down))


@pytest.mark.parametrize('fn', ['decimate', 'interpolate'])
def test_decimate_interpolate(fn):
    rng = np.random.default_rng(5)
    x = _cplx(rng, (4, 96))
    got = getattr(rst, fn)(torch.from_numpy(x), 4, taps_per_phase=8)
    _close(got.numpy(), getattr(rsj, fn)(jnp.asarray(x), 4, 8))


def test_dechirp_and_ffts():
    rng = np.random.default_rng(11)
    x, ref = _cplx(rng, (8, 64)), _cplx(rng, (64,))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(rdt.dechirp(xt, torch.from_numpy(ref)).numpy(),
           rdj.dechirp(xj, jnp.asarray(ref)))
    w64, w8 = np.hanning(64).astype(np.float32), \
        np.hamming(8).astype(np.float32)
    for kw in ({}, {'n_fft': 128}):
        _close(rdt.range_fft(xt, torch.from_numpy(w64), **kw).numpy(),
               rdj.range_fft(xj, jnp.asarray(w64), **kw))
        _close(rdt.doppler_fft(xt, torch.from_numpy(w8), **kw).numpy(),
               rdj.doppler_fft(xj, jnp.asarray(w8), **kw))
    _close(rdt.range_fft(xt).numpy(), rdj.range_fft(xj))
    _close(rdt.doppler_fft(xt).numpy(), rdj.doppler_fft(xj))


@pytest.mark.parametrize('mode', ['pulse', 'fmcw'])
def test_range_doppler_map(mode):
    rng = np.random.default_rng(12)
    x, rep = _cplx(rng, (16, 64)), _cplx(rng, (9,))
    w64, w16 = np.hanning(64).astype(np.float32), \
        np.hanning(16).astype(np.float32)
    got = rdt.range_doppler_map(torch.from_numpy(x), torch.from_numpy(rep),
                                torch.from_numpy(w64), torch.from_numpy(w16),
                                mode=mode)
    _close(got.numpy(), rdj.range_doppler_map(
        jnp.asarray(x), jnp.asarray(rep), jnp.asarray(w64), jnp.asarray(w16),
        mode=mode))


def test_axes():
    _close(rdt.doppler_axis(16, 400.0, device='cpu').numpy(),
           rdj.doppler_axis(16, 400.0))
    _close(rdt.range_axis_pulse(64, 20e3, 340.0, device='cpu').numpy(),
           rdj.range_axis_pulse(64, 20e3, 340.0))
    _close(rdt.range_axis_fmcw(128, 2560.0, 2e3 / 90e-3, 340.0,
                               device='cpu').numpy(),
           rdj.range_axis_fmcw(128, 2560.0, 2e3 / 90e-3, 340.0))


def test_dechirp_chain_finds_the_range_bin():
    """Golden config 4's chain on `scenes.fmcw_dechirp_scene` through the
    kernel's plain version: coherent receive, conjugate, decimate by 8,
    Hann-windowed range FFT.  The beat lands within one bin of the
    config's analytic range bin (slope x the two-way apex delay)."""
    import beifong_tpu_torch as bt
    from beifong_tpu_torch.scenes import DECHIRP, FMCW
    meta = int(np.load('tests/golden/fmcw_dechirp_chain.npz')[
        'meta_expected_range_bin'])
    s, rx = bt.fmcw_dechirp_scene()
    a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=1 << 18,
                      max_depth=2, seed=13, coherent=True,
                      time_sampling='gate', device='cpu')
    iq = torch.complex(a[:, 0, 0], a[:, 0, 1]) * (DECHIRP['n_fast'] / n)
    dec = rst.decimate(torch.conj(iq), DECHIRP['q'])
    rc = rdt.range_fft(dec, window=wt.hann(dec.shape[-1], device='cpu'))
    n_adc = dec.shape[-1]
    tau = 2 * (DECHIRP['R'] - abs(DECHIRP['rx_pos'][1])) / 340.0
    fs_adc = DECHIRP['n_fast'] / DECHIRP['window'] / DECHIRP['q']
    want = int(round(FMCW['sweep'] / FMCW['chirp'] * tau / fs_adc * n_adc))
    assert want == meta and n_adc == 128
    assert abs(int(rc.abs().argmax()) - want) <= 1
