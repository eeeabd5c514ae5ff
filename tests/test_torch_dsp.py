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
