"""The port's receive kernel: its plain PyTorch version against the JAX
package's Pallas megakernel (interpret mode) on identical uniforms, and
the Philox generator.  The CUDA kernel itself is held against the plain
version on a card by tests/test_torch_gpu.py."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from beifong_tpu.integrators import pallas_receive as pr

from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.radar.endpoints import ADCConfig
from beifong_tpu_torch.scenes import flagship_scene

torch.set_num_threads(1)

# (rx_kind, time_sampling, max_depth, n_time, interpret lanes, seed)
CASES = [('wigner', 'gate', 2, 64, 1024, 0),
         ('omni', 'fixed', 2, 16, 1024, 1)]


def _jax_run(rx_kind, time_sampling, max_depth, n_time, n_lanes, seed):
    """JAX `_run(interpret=True)` called as `receive_pallas` calls it, plus
    the uniforms it drew, as (n_draws, n_lanes) with
    lane = (tile * 8 + row) * 128 + col."""
    s, rx = g._build_scene(rx_kind=rx_kind)
    rx = dc.replace(rx, adc=dc.replace(rx.adc, n_time=n_time))
    sd = s.compile()
    assert pr.supported(sd, rx)
    si = s.shape_index_of_endpoint('receiver', rx.id)
    (params, prim, txp, php, rxph, msh, mesh_types, tex, bmp_meta,
     mesh_pack) = pr._pack_scene(sd, rx, si)
    assert mesh_pack is None
    params = params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    out, _, _, _, cnt = pr._run(
        jnp.asarray(params), jnp.asarray(prim), jnp.asarray(txp),
        jnp.asarray(php), jnp.asarray(rxph), jax.random.key(seed),
        tuple(int(k) for k in prim[:, 0]), tuple(int(f) for f in prim[:, 14]),
        tuple(int(f) for f in prim[:, 18]), tuple(int(f) for f in prim[:, 26]),
        rx.adc, rx.receive_type, time_sampling, max_depth, rx_kind, n_lanes,
        True, False, has_mesh=False, mesh_types=mesh_types, moving=False,
        absorbing=False, tx_kinds=tuple(int(f) for f in txp[:, 27]),
        has_lo=False, polarized=False, bmp_meta=bmp_meta, layered=0,
        tex=jnp.asarray(tex), msh=jnp.asarray(msh), mimo_e=0, eoff=None,
        grid_meta=pr._grid_meta(params),
        prim_bsdf1=tuple(int(f) for f in prim[:, 28]),
        prim_mix=tuple(int(f) for f in prim[:, 27]))
    nd = pr.n_draws(max_depth)
    n_tiles = n_lanes // (8 * 128)
    u = jax.random.uniform(jax.random.key(seed), (n_tiles, nd, 8, 128),
                           dtype=jnp.float32)
    u = np.asarray(u).transpose(1, 0, 2, 3).reshape(nd, n_lanes)
    adc = ADCConfig(**{f.name: getattr(rx.adc, f.name)
                       for f in dc.fields(ADCConfig)})
    return (np.asarray(out)[:, 0], float(np.asarray(cnt)[0, 0]),
            (params, prim, txp, u, adc))


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}-{c[1]}')
def test_plain_version_matches_jax_megakernel(case):
    rx_kind, ts, depth = case[:3]
    out_j, cnt_j, (params, prim, txp, u, adc) = _jax_run(*case)
    t = torch.tensor
    acc, n_ev = rk.receive_megakernel_ref(
        t(params), t(prim), t(txp), t(u), adc=adc, max_depth=depth,
        time_sampling=ts, rx_kind=rx_kind)
    assert n_ev.dtype == torch.int64 and n_ev.ndim == 0
    assert cnt_j > 0 and np.abs(out_j).max() > 0
    # the frameworks sum in another order, and XLA-CPU and torch exp / log /
    # rsqrt may differ by an ulp: hence per-bin slack of 1e-4 x max|acc|
    # and 0.1% on the event count (the observed gap is ~2e-6 and 0 events)
    np.testing.assert_allclose(acc.numpy(), out_j, rtol=0,
                               atol=1e-4 * np.abs(out_j).max())
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the CPU wrapper is the plain version, fed the same uniforms
    acc_w, n_w = rk.receive_megakernel(
        t(params), t(prim), t(txp), adc=adc, max_depth=depth,
        time_sampling=ts, rx_kind=rx_kind, n_lanes=u.shape[1],
        uniforms=t(u))
    assert torch.equal(acc_w, acc) and int(n_w) == int(n_ev)


def _flagship_tables(seed=0, rx_kind='wigner'):
    s, rx = flagship_scene(rx_kind=rx_kind)
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params = p.params.copy()
    params[0] = float(seed * 1_000_003 % (1 << 30))
    return (torch.from_numpy(params), torch.from_numpy(p.prim),
            torch.from_numpy(p.txp), rx.adc)


def test_prng_mode_on_cpu_is_the_philox_stream():
    params, prim, txp, adc = _flagship_tables()
    kw = dict(adc=adc, max_depth=3, time_sampling='gate', rx_kind='wigner',
              n_lanes=4096)
    a1, n1 = rk.receive_megakernel(params, prim, txp, seed=5, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, seed=5, **kw)
    assert torch.equal(a1, a2) and int(n1) == int(n2) > 0
    u = rk.philox_uniforms(5, rk.n_draws(3), 4096)
    a3, n3 = rk.receive_megakernel_ref(params, prim, txp, u, adc=adc,
                                       max_depth=3, time_sampling='gate',
                                       rx_kind='wigner')
    assert torch.equal(a1, a3) and int(n3) == int(n1)
    a4, _ = rk.receive_megakernel(params, prim, txp, seed=6, **kw)
    assert not torch.equal(a1, a4)


@pytest.mark.parametrize('ctr, key, expect', [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Random123's known-answer vectors for Philox4x32-10."""
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = rk.philox4x32_10(*c, *key)
    assert tuple(int(x) for x in got) == expect


def test_philox_uniforms_layout_and_moments():
    u = rk.philox_uniforms(123, 10, 1 << 14)
    assert u.shape == (10, 1 << 14) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 1.0 / 12.0) < 0.005
    # a lane's stream does not depend on how many lanes were drawn
    assert torch.equal(rk.philox_uniforms(123, 10, 100), u[:, :100])
    # rows 4g..4g+3 are the four words of counter block g
    w = rk.philox4x32_10(torch.tensor([7]), torch.tensor([0]),
                         torch.tensor([1]), torch.tensor([0]), 123, 0)
    assert [float(u[4 + i, 7]) for i in range(4)] == \
        [float(int(x) >> 8) / (1 << 24) for x in w]


def test_wrapper_rejects_bad_tables():
    params, prim, txp, adc = _flagship_tables()
    kw = dict(adc=adc, max_depth=2, time_sampling='gate', rx_kind='wigner',
              n_lanes=256)
    with pytest.raises(ValueError, match='prim'):
        rk.receive_megakernel(params, prim[:, :30].contiguous(), txp, **kw)
    with pytest.raises(ValueError, match='uniforms'):
        rk.receive_megakernel(params, prim, txp,
                              uniforms=torch.zeros(3, 256), **kw)
    with pytest.raises(ValueError, match='time_sampling'):
        rk.receive_megakernel(params, prim, txp,
                              **{**kw, 'time_sampling': 'stratified'})
