"""Waveforms in the port against the JAX package: the `Waveform` closed
forms, and the receive kernel's plain version on CW and LFMCW
transmitters against the Pallas megakernel (interpret mode) on identical
uniforms."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu import scene as sc_j
from beifong_tpu.bsdf import diffuse as diffuse_j
from beifong_tpu.core import transform as tf_j
from beifong_tpu.core.config import Band as BandJ
from beifong_tpu.geometry import shapes as sh_j
from beifong_tpu.integrators import pallas_receive as pr
from beifong_tpu.radar import waveform as wf_j
from beifong_tpu.radar import (ADCConfig as ADCJ, omni_receiver as omni_j,
                               wigner_transmitter as wtx_j)

from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.radar import waveform as wf_t
from beifong_tpu_torch.radar.endpoints import ADCConfig

torch.set_num_threads(1)

WAVEFORMS = {
    'cw': (dict(f_centre=40e3, amplitude=1.3),),
    'pulse': (dict(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                   is_delta=True),),
    'linfmcw': (dict(f_centre=40e3, crf=50.0, chirp_len=4e-3,
                     freq_sweep=4e3),),
}


@pytest.mark.parametrize('kind', sorted(WAVEFORMS))
def test_waveform_matches_jax(kind):
    kw = WAVEFORMS[kind][0]
    w_j = getattr(wf_j, kind)(**kw)
    w_t = getattr(wf_t, kind)(**kw)
    rng = np.random.default_rng(len(kind))
    t = rng.uniform(0.0, 0.25, 4096).astype(np.float32)
    f = rng.uniform(36e3, 44e3, 4096).astype(np.float32)
    np.testing.assert_allclose(
        w_t.inst_freq(torch.from_numpy(t)).numpy(),
        np.asarray(w_j.inst_freq(jnp.asarray(t))), rtol=1e-6)
    want = np.asarray(w_j.eval_wdf(jnp.asarray(t), jnp.asarray(f)))
    got = w_t.eval_wdf(torch.from_numpy(t), torch.from_numpy(f)).numpy()
    # XLA and torch sin may differ by an ulp; the WDF is O(amp^2 * t_ext)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    stacked = wf_t.stack([w_t, w_t])
    assert stacked.f_centre.shape == (2,) and stacked.kind.dtype == \
        torch.int32


def _scene_j(wave):
    """Flagship geometry with an omni receiver and another waveform."""
    s = sc_j.Scene(band=BandJ.from_freq(340.0, 40e3, 10e3))
    s.add(diffuse_j('mat', reflectance=1.0, twosided=True))
    s.add(wtx_j('tx', wave, resample_freq=True))
    aim = np.asarray(tf_j.compose(tf_j.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                  tf_j.scale([0.05, 0.05, 1.0])))
    s.add(sh_j.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCJ(n_time=16, n_freq=1, sampling_start=0.0, sampling_time=0.06,
               freq_lo=35e3, freq_hi=45e3)
    rx = omni_j('rx', adc, position=(-0.3, 0, 0), receive_type='raw')
    s.add(rx)
    tgt = np.asarray(tf_j.compose(tf_j.look_at([0, -4.0, 0], [0, 0, 0]),
                                  tf_j.scale(0.5)))
    s.add(sh_j.rectangle(to_world=tgt, bsdf='mat'))
    return s, rx


@pytest.mark.parametrize('kind, ts', [('cw', 'fixed'), ('linfmcw', 'gate')])
def test_plain_version_matches_jax_megakernel_waveforms(kind, ts):
    s, rx = _scene_j(getattr(wf_j, kind)(**WAVEFORMS[kind][0]))
    sd = s.compile()
    assert pr.supported(sd, rx)
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     _) = pr._pack_scene(sd, rx, -1)
    seed, depth, n_lanes = 4, 1, 1024
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    out, _, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx.adc, rx.receive_type, ts, depth, 'omni', n_lanes, True, False,
        mesh_types=mesh_types, tx_kinds=tuple(int(f) for f in txp[:, 27]),
        bmp_meta=bmp_meta, tex=jnp.asarray(tex), msh=jnp.asarray(msh),
        grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]))
    nd = pr.n_draws(depth)
    u = np.asarray(jax.random.uniform(jax.random.key(seed), (1, nd, 8, 128),
                                      dtype=jnp.float32))
    u = u.transpose(1, 0, 2, 3).reshape(nd, n_lanes)
    adc = ADCConfig(**{f.name: getattr(rx.adc, f.name)
                       for f in dc.fields(ADCConfig)})
    t = torch.tensor
    acc, n_ev = rk.receive_megakernel_ref(
        t(params), t(prim), t(txp), t(u), adc=adc, max_depth=depth,
        time_sampling=ts, rx_kind='omni')
    out, cnt = np.asarray(out)[:, 0], float(np.asarray(cnt)[0, 0])
    assert cnt > 0 and np.abs(out).max() > 0
    # tolerances and their reasons: tests/test_torch_receive_kernel.py
    np.testing.assert_allclose(acc.numpy(), out, rtol=0,
                               atol=1e-4 * np.abs(out).max())
    assert abs(int(n_ev) - cnt) <= 1e-3 * cnt
