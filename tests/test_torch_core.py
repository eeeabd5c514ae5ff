"""The port's core helpers against the JAX package on the same float32
inputs: the double-single (error-free) arithmetic of the coherent phase,
the clamped roots and the MIS weight, the shading frames, uniform-area
position sampling per shape kind, aperture extents and the interaction's
spawn origin.

Tolerance: the double-single helpers are exact on both sides (every op
rounded on its own, no contraction), so they must agree bit for bit; the
others within rtol 1e-6, atol 1e-7 (sin / cos / sqrt of two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu import interaction as inter_j
from beifong_tpu.core import math as m_j
from beifong_tpu.core import transform as tf_j
from beifong_tpu.geometry import sample as sample_j
from beifong_tpu.geometry import shapes as shapes_j

from beifong_tpu_torch import interaction as inter_t
from beifong_tpu_torch.core import math as m_t
from beifong_tpu_torch.core import transform as tf_t
from beifong_tpu_torch.geometry import sample as sample_t
from beifong_tpu_torch.geometry import shapes as shapes_t
from beifong_tpu_torch.radar import wigner as wigner_t

from test_torch_bsdf import _dirs

torch.set_num_threads(1)

N = 2048


def _floats(seed, lo=-1e3, hi=1e3):
    """Values spread over many binades, with both signs."""
    g = np.random.default_rng(seed)
    mag = np.exp(g.uniform(np.log(1e-3), np.log(hi), N))
    return (mag * g.choice([-1.0, 1.0], N)).astype(np.float32).clip(lo, hi)


def _pair(seed):
    """A double-single value (hi, lo) with |lo| below half an ulp of hi."""
    hi = _floats(seed)
    lo = (hi * np.float32(2.0 ** -30)
          * np.random.default_rng(seed + 1).uniform(-1, 1, N)).astype(
              np.float32)
    return hi, lo


def _exact(got, ref, what):
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.broadcast_to(r, g.shape),
                                      err_msg=what)


DS_CASES = ['two_sum', 'two_prod', 'ds_add', 'ds_add_f', 'ds_mul', 'ds_inv',
            'wlfrac_add_dist', 'wlfrac_phase', 'wlfrac_add_phase',
            'cyc_frac_prod']


@pytest.mark.parametrize('name', DS_CASES)
def test_double_single_helpers_match_jax_bit_for_bit(name):
    a, b = _floats(1), _floats(2)
    x, y = _pair(3), _pair(5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tx = tuple(torch.from_numpy(v) for v in x)
    ty = tuple(torch.from_numpy(v) for v in y)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jx = tuple(jnp.asarray(v) for v in x)
    jy = tuple(jnp.asarray(v) for v in y)
    if name in ('two_sum', 'two_prod'):
        _exact(getattr(m_t, name)(ta, tb), getattr(m_j, name)(ja, jb), name)
    elif name in ('ds_add', 'ds_mul'):
        _exact(getattr(m_t, name)(tx, ty), getattr(m_j, name)(jx, jy), name)
    elif name == 'ds_add_f':
        _exact(m_t.ds_add_f(tx, tb), m_j.ds_add_f(jx, jb), name)
    elif name == 'ds_inv':
        _exact(m_t.ds_inv(ta), m_j.ds_inv(ja), name)
        # ~2^-46 relative against float64
        hi, lo = (v.double().numpy() for v in m_t.ds_inv(ta))
        np.testing.assert_allclose(hi + lo, 1.0 / a.astype(np.float64),
                                   rtol=1e-13)
    elif name == 'cyc_frac_prod':
        c = m_t.ds_const(40e3 / 3.0)
        _exact(m_t.cyc_frac_prod(c, tb.abs()),
               m_j.cyc_frac_prod(m_j.ds_const(40e3 / 3.0), jnp.abs(jb)), name)
        assert c == tuple(float(v) for v in m_j.ds_const(40e3 / 3.0))
    else:
        inv_t, inv_j = m_t.ds_const(1.0 / 0.0085), m_j.ds_const(1.0 / 0.0085)
        dist = np.abs(a)
        acc_t = m_t.wlfrac_add_dist(m_t.wlfrac_zero((N,)),
                                    torch.from_numpy(dist), inv_t)
        acc_j = m_j.wlfrac_add_dist(m_j.wlfrac_zero((N,)), jnp.asarray(dist),
                                    inv_j)
        if name == 'wlfrac_add_dist':
            _exact(acc_t, acc_j, name)
        elif name == 'wlfrac_phase':
            _exact(m_t.wlfrac_phase(acc_t), m_j.wlfrac_phase(acc_j), name)
        else:
            ph = np.random.default_rng(7).uniform(0, 7, N).astype(np.float32)
            _exact(m_t.wlfrac_add_phase(acc_t, torch.from_numpy(ph)),
                   m_j.wlfrac_add_phase(acc_j, jnp.asarray(ph)), name)


def test_roots_mis_and_normalize_match_jax():
    g = np.random.default_rng(11)
    x = g.uniform(-2, 2, N).astype(np.float32)
    pa, pb = (g.uniform(0, 3, N).astype(np.float32) for _ in range(2))
    pa[:16] = 0.0
    v = g.normal(size=(N, 3)).astype(np.float32)
    v[0] = 0.0
    for name, got, ref in (
            ('safe_sqrt', m_t.safe_sqrt(torch.from_numpy(x)),
             m_j.safe_sqrt(jnp.asarray(x))),
            ('safe_rsqrt', m_t.safe_rsqrt(torch.from_numpy(x)),
             m_j.safe_rsqrt(jnp.asarray(x))),
            ('safe_acos', m_t.safe_acos(torch.from_numpy(x)),
             m_j.safe_acos(jnp.asarray(x))),
            ('mis_weight', m_t.mis_weight(*map(torch.from_numpy, (pa, pb))),
             m_j.mis_weight(*map(jnp.asarray, (pa, pb)))),
            ('normalize', m_t.normalize(torch.from_numpy(v)),
             m_j.normalize(jnp.asarray(v)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_shading_frames_match_jax():
    g = np.random.default_rng(12)
    n = _dirs(g, N)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    v = g.normal(size=(N, 3)).astype(np.float32)
    fr_t = tf_t.frame_from_normal(torch.from_numpy(n))
    fr_j = tf_j.frame_from_normal(jnp.asarray(n))
    np.testing.assert_allclose(fr_t.numpy(), np.asarray(fr_j), rtol=1e-6,
                               atol=1e-7)
    for f in ('to_local', 'to_world'):
        np.testing.assert_allclose(
            getattr(tf_t, f)(fr_t, torch.from_numpy(v)).numpy(),
            np.asarray(getattr(tf_j, f)(fr_j, jnp.asarray(v))), rtol=1e-5,
            atol=1e-6, err_msg=f)


@pytest.mark.parametrize('kind', ['rectangle', 'sphere', 'disk', 'cylinder'])
def test_sample_position_and_extents_match_jax(kind):
    from test_torch_intersect import _kind_scene
    sd_j, sd_t = _kind_scene('jax', kind), _kind_scene('port', kind)
    g = np.random.default_rng(13)
    idx = g.integers(0, 3, N).astype(np.int32)
    u = g.random((N, 2), dtype=np.float32)
    got = sample_t.sample_position(sd_t.shapes, torch.from_numpy(idx).long(),
                                   torch.from_numpy(u))
    ref = sample_j.sample_position(sd_j.shapes, jnp.asarray(idx),
                                   jnp.asarray(u))
    for what, a, b in zip(('p', 'n', 'pdf', 'uv'), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6, err_msg=what)
    for a, b in zip(shapes_t.aperture_extents(sd_t.shapes,
                                              torch.from_numpy(idx).long()),
                    shapes_j.aperture_extents(sd_j.shapes, jnp.asarray(idx))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_spawn_origin_matches_jax():
    g = np.random.default_rng(14)
    p = (g.normal(size=(N, 3)) * np.exp(g.uniform(-3, 4, (N, 1)))).astype(
        np.float32)
    n = _dirs(g, N)
    d = _dirs(g, N)
    fr = tf_j.frame_from_normal(jnp.asarray(n))
    si_j = inter_j.SurfaceInteraction(
        valid=jnp.ones(N, bool), t=jnp.ones(N), p=jnp.asarray(p),
        n=jnp.asarray(n), sh_frame=fr, uv=jnp.zeros((N, 2)),
        wi=jnp.zeros((N, 3)), wi_world=jnp.zeros((N, 3)),
        shape_idx=jnp.zeros(N, jnp.int32), prim_idx=jnp.zeros(N, jnp.int32))
    si_t = inter_t.SurfaceInteraction(
        valid=torch.ones(N, dtype=torch.bool), t=torch.ones(N),
        p=torch.from_numpy(p), n=torch.from_numpy(n),
        sh_frame=torch.from_numpy(np.array(fr)), uv=torch.zeros(N, 2),
        wi=torch.zeros(N, 3), wi_world=torch.zeros(N, 3),
        shape_idx=torch.zeros(N, dtype=torch.int32),
        prim_idx=torch.zeros(N, dtype=torch.int32))
    np.testing.assert_allclose(si_t.spawn_origin(torch.from_numpy(d)).numpy(),
                               np.asarray(si_j.spawn_origin(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(si_t.to_world(si_t.to_local(
        torch.from_numpy(d))).numpy(), d, atol=1e-5)


def test_phased_aperture_gain_names_its_roadmap_item():
    """ROADMAP B6's cross-WDF is ported: a two-element array's gain on its
    pair midpoints, toward broadside, equals the JAX package's."""
    from beifong_tpu.radar import wigner as wigner_j
    g = np.random.default_rng(2)
    mid = np.array([[0.01, 0, 0], [0, 0, 0], [0, 0, 0], [-0.01, 0, 0]],
                   np.float32)
    base = np.array([[0, 0, 0], [0.02, 0, 0], [-0.02, 0, 0], [0, 0, 0]],
                    np.float32)
    psi = np.array([0.0, 0.3, -0.3, 0.0], np.float32)
    tabs = [mid, base, psi, np.ones(4, bool),
            np.array([1, 0, 0], np.float32), np.array([0, 1, 0], np.float32),
            np.array([0.005, 0.005], np.float32), np.zeros(3, np.float32)]
    p = np.stack([g.uniform(-0.015, 0.015, N), g.uniform(-0.004, 0.004, N),
                  np.zeros(N)], -1).astype(np.float32)
    d = _dirs(g, N)
    lam = np.full(N, 0.0085, np.float32)
    ref = np.asarray(wigner_j.phased_aperture_gain(
        *(jnp.asarray(x) for x in tabs + [p, d, lam])))
    got = wigner_t.phased_aperture_gain(
        *(torch.from_numpy(x) for x in tabs + [p, d, lam])).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_wchirp_matches_jax():
    """The chirp's Wigner distribution (negative lobes included) on seeded
    offsets, extents and amplitudes."""
    g = np.random.default_rng(13)
    t, f = g.uniform(-0.6, 0.6, N), g.uniform(-3e3, 3e3, N)
    w, a = g.uniform(1e-3, 0.1, N), g.uniform(0.1, 2.0, N)
    args = [x.astype(np.float32) for x in (t, f, w, a)]
    got = m_t.wchirp(*map(torch.from_numpy, args))
    ref = np.asarray(m_j.wchirp(*map(jnp.asarray, args)))
    assert (ref < 0).any() and (ref > 0).any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
