"""Slow time and the coherent processing interval (CPI): the port's
keyframed motion (`core.transform.AnimatedTransform`, `rotate`),
`Scene.at_time` and `shapes.trihedral` against the JAX package's; the
receive kernel's plain CPI (every pulse of a train in one call, the
pulse a leading axis of the tables) against the JAX package's
`receive_cpi_pallas` (interpret mode) on identical per-pulse uniforms,
with common random numbers on and off; `receive_cpi`'s engines against
each other; and the anchors of golden configs 4 and 5 on the CPU.  The
CUDA kernel's pulse axis is held against the plain version on a card by
tests/test_torch_gpu.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.core import transform as tf_j
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import scenes
from beifong_tpu_torch.bsdf.tables import plastic
from beifong_tpu_torch.core import transform as tf_t
from beifong_tpu_torch.geometry import shapes as sh_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import cpi_tables_from_numpy
from beifong_tpu_torch.radar.endpoints import ADCConfig

from test_torch_mesh import jax_leaves, port_band
from test_torch_wavefront import _pkg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), 'golden'))
import configs as golden_configs  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell; I / Q add the phase slack
GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')


# ---------------------------------------------------------------------------
# the golden ladder's CPI scenes, built in either package
# ---------------------------------------------------------------------------


def micro_doppler(pkg: str):
    """Golden config 5's scene (tests/golden/configs.py
    `micro_doppler_cpi`), built as the config builds it; the port's copy
    is `scenes.micro_doppler_scene`."""
    if pkg == 'port':
        return bt.micro_doppler_scene()
    k = _pkg(pkg)
    md = scenes.MICRO_DOPPLER
    fc, n_pulses, prf = md['fc'], md['n_pulses'], md['prf']
    f_rot = prf * md['m_rot'] / n_pulses
    r_orb = md['a_mod'] * (340.0 / fc) / (4 * np.pi)
    s = k.sc.Scene(band=k.Band.from_freq(340.0, fc, 10e3))
    s.add(k.bsdf.diffuse('mat', reflectance=1.0, twosided=True))
    s.add(k.radar.wigner_transmitter('tx', k.radar.cw(f_centre=fc),
                                     resample_freq=True))
    s.add(k.sh.rectangle(to_world=np.asarray(
        k.tf.compose(k.tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                     k.tf.scale([0.05, 0.05, 1.0]))), transmitter='tx'))
    adc = k.radar.ADCConfig(n_time=8, n_freq=1, sampling_start=0.0,
                            sampling_time=2e-3, freq_lo=fc - 2e3,
                            freq_hi=fc + 2e3)
    rx = k.radar.wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    s.add(k.sh.rectangle(to_world=np.asarray(
        k.tf.compose(k.tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                     k.tf.scale([0.05, 0.05, 1.0]))), receiver='rx'))
    tgt = k.sh.rectangle(bsdf='mat')
    frames = []
    for p in range(n_pulses + 1):
        t_p = p / prf
        psi = 2 * np.pi * f_rot * t_p
        pos = [r_orb * np.cos(psi), -(md['R0'] + r_orb * np.sin(psi)), 0.0]
        frames.append((t_p, np.asarray(k.tf.compose(
            k.tf.look_at(pos, [0.0, 0.0, 0.0]), k.tf.scale(0.3)))))
    tgt.to_world = tf_j.AnimatedTransform.from_keyframes(frames)
    s.add(tgt)
    return s, rx


def corner(pkg: str):
    """Golden config 4's scene (configs.py `_corner_scene`, keyframed over
    its 64 pulses); the port's copy is `scenes.corner_scene`."""
    if pkg == 'port':
        return bt.corner_scene()
    from beifong_tpu.radar import ADCConfig as ADCj
    d, c, f = scenes.DECHIRP, scenes.CORNER, scenes.FMCW
    adc = ADCj(n_time=d['n_fast'], n_freq=1, sampling_start=d['t0'],
               sampling_time=d['window'], freq_lo=0.0, freq_hi=1.5e3)
    s, rx, _ = golden_configs._corner_scene(
        v=c['v'], fc=f['fc'], B=f['sweep'], T=f['chirp'], adc=adc,
        n_pulses=c['n_pulses'], prf=c['prf'])
    return s, rx


def carried(pkg: str):
    """Config 5's scene with the receiver's rectangle on keyframes too: the
    receiver spec then takes its shape's velocity."""
    s, rx = micro_doppler(pkg)
    at = tf_j.AnimatedTransform if pkg == 'jax' else tf_t.AnimatedTransform
    i = s.shape_index_of_endpoint('receiver', rx.id)
    base = np.asarray(s.shapes[i].to_world, np.float64)
    frames = []
    for t in (0.0, 0.05, 0.1, 0.2):
        m = np.eye(4)
        m[:3, :3] = _rotation((0.0, 0.0, 1.0), 40.0 * t)
        m[:3, 3] = (0.3 * t, 0.5 * t, 0.0)
        frames.append((t, m @ base))
    s.shapes[i].to_world = at.from_keyframes(frames)
    return s, rx


SCENES = {'micro_doppler': micro_doppler, 'corner': corner,
          'carried': carried}


# ---------------------------------------------------------------------------
# keyframes, rotate, at_time, trihedral
# ---------------------------------------------------------------------------


def _rotation(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(deg)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _keyframes(seed: int):
    """Four to six keyframes with rotation, a symmetric stretch and a
    translation; keyframes 1 and 2 turn 170 and -170 degrees about one
    axis, whose quaternions take the short-arc flip."""
    rng = np.random.default_rng(seed)
    n = 4 + seed % 3
    times = np.sort(rng.uniform(0.0, 2.0, n))
    pairs = []
    axis = rng.normal(size=3)
    for k, t in enumerate(times):
        deg = {1: 170.0, 2: -170.0}.get(k, rng.uniform(-160, 160))
        ax = axis if k in (1, 2) else rng.normal(size=3)
        a = rng.normal(size=(3, 3)) * 0.1
        stretch = np.diag(rng.uniform(0.5, 2.0, 3)) + (a + a.T) / 2
        m = np.eye(4)
        m[:3, :3] = _rotation(ax, deg) @ stretch
        m[:3, 3] = rng.normal(size=3)
        pairs.append((t, m))
    return pairs


@pytest.mark.parametrize('seed', range(6))
def test_animated_transform_matches_jax(seed):
    """eval and velocity agree to 1e-6 (the same float64 numpy on both
    sides) at and between the knots and past both ends, where eval
    clamps."""
    pairs = _keyframes(seed)
    a_j = tf_j.AnimatedTransform.from_keyframes(pairs)
    a_t = tf_t.AnimatedTransform.from_keyframes(pairs)
    for f in ('times', 'trans', 'quats', 'stretch'):
        np.testing.assert_allclose(getattr(a_t, f), getattr(a_j, f),
                                   rtol=0, atol=1e-6)
    assert np.dot(a_t.quats[1], a_t.quats[2]) >= 0.0   # the short arc
    rng = np.random.default_rng(100 + seed)
    ts = np.concatenate([a_j.times, rng.uniform(-0.5, 2.5, 12)])
    for t in ts:
        m_j, m_t = a_j.eval(t), a_t.eval(t)
        assert m_t.dtype == m_j.dtype == np.float32
        np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-6)
        p = rng.normal(size=3)
        v_j, v_t = a_j.velocity(t, p), a_t.velocity(t, p)
        np.testing.assert_allclose(v_t, v_j, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(v_j).max()))
    one = tf_t.AnimatedTransform.from_keyframes(pairs[:1])
    np.testing.assert_array_equal(one.eval(5.0), pairs[0][1].astype(
        np.float32))
    assert not one.velocity(1.0).any()


@pytest.mark.parametrize('axis, deg', [((0, 0, 1), 30.0), ((1, 2, -0.5),
                                                            -123.0),
                                       ((0.3, -1, 0.2), 181.0)])
def test_rotate_matches_jax(axis, deg):
    np.testing.assert_allclose(tf_t.rotate(axis, deg).numpy(),
                               np.asarray(tf_j.rotate(axis, deg)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('scene', list(SCENES))
def test_at_time_matches_jax(scene):
    """Each shape's to_world and velocity, and the endpoints' velocities,
    at pulse times and between them."""
    s_j, _ = SCENES[scene]('jax')
    s_t, _ = SCENES[scene]('port')
    for t in (0.0, 0.0125, 0.0371, 0.1, 3.0):
        a, b = s_j.at_time(t), s_t.at_time(t)
        assert len(a.shapes) == len(b.shapes)
        for x, y in zip(a.shapes, b.shapes):
            np.testing.assert_allclose(np.asarray(y.to_world),
                                       np.asarray(x.to_world), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(y.velocity, x.velocity, rtol=0,
                                       atol=1e-6)
        for x, y in zip(a.transmitters + a.receivers,
                        b.transmitters + b.receivers):
            assert x.id == y.id
            np.testing.assert_allclose(np.asarray(y.velocity, np.float32),
                                       np.asarray(x.velocity, np.float32),
                                       rtol=0, atol=1e-6)
    if scene == 'carried':
        v = s_t.at_time(0.07).receivers[0].velocity
        assert np.abs(v).max() > 0.1
    # the base scene keeps its keyframes
    assert any(isinstance(sh.to_world, tf_t.AnimatedTransform)
               for sh in s_t.shapes)


@pytest.mark.parametrize('apex, toward, size', [
    ((0.0, -4.0, 0.0), (0.0, 3.9, 0.0), 1.0),
    ((1.0, 2.0, -3.0), (0.3, -0.2, 1.0), 0.6),
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 1.0),      # the symmetry axis itself
    ((0.0, 0.0, 0.0), (-1.0, -1.0, -1.0), 2.0)])  # and its opposite
def test_trihedral_matches_jax(apex, toward, size):
    from beifong_tpu.geometry import shapes as sh_j
    f_j = sh_j.trihedral(apex, toward, size, bsdf='m')
    f_t = sh_t.trihedral(apex, toward, size, bsdf='m')
    assert len(f_t) == 3
    for a, b in zip(f_j, f_t):
        assert a.kind == b.kind and b.bsdf == 'm'
        np.testing.assert_allclose(np.asarray(b.to_world),
                                   np.asarray(a.to_world), rtol=0, atol=1e-6)
    # three mutually perpendicular faces meeting at the apex
    n = [np.asarray(b.to_world)[:3, 2] for b in f_t]
    assert abs(np.dot(n[0], n[1])) < 1e-5 and abs(np.dot(n[1], n[2])) < 1e-5


# ---------------------------------------------------------------------------
# the CPI: plain version against receive_cpi_pallas (interpret mode)
# ---------------------------------------------------------------------------


def _uniforms(key_seed: int, nd: int, n_lanes: int) -> torch.Tensor:
    """What `_run` draws under jax.random.key(key_seed), as (nd, n_lanes)
    with lane = (tile * 8 + row) * 128 + col."""
    u = jax.random.uniform(jax.random.key(key_seed),
                           (n_lanes // 1024, nd, 8, 128), dtype=jnp.float32)
    return torch.tensor(np.asarray(u).transpose(1, 0, 2, 3)
                        .reshape(nd, n_lanes))


@pytest.mark.parametrize('crn', [True, False], ids=['crn', 'independent'])
def test_plain_cpi_matches_jax_receive_cpi_pallas(crn):
    """Three pulses of config 5 (coherent, gate, depth 1, 2048 lanes): the
    JAX package packs each snapshot and scans its megakernel; the port
    packs the same snapshots (carried over by `interop`) and runs its
    plain CPI on the uniforms each JAX pulse drew (key seed, or seed +
    7919 p without common random numbers).  Per cell: 1e-4 x max(|I|,
    |Q|) plus the phase slack times the cell's sum of amplitudes."""
    n_pulses, prf, t0, seed, n_lanes, depth = 3, 400.0, 0.0125, 4, 2048, 1
    s_j, rx_j = micro_doppler('jax')
    _, rx_t = micro_doppler('port')
    cube_j, n_j = pr.receive_cpi_pallas(
        s_j, n_pulses=n_pulses, prf=prf, t0=t0, seed=seed, spp=n_lanes,
        max_depth=depth, time_sampling='gate', coherent=True,
        common_random_numbers=crn, interpret=True)
    cube_j = np.asarray(cube_j)
    assert n_j == n_lanes and cube_j.shape == (n_pulses, 8, 1, 2)
    snaps = [s_j.at_time(t0 + p / prf) for p in range(n_pulses)]
    si = snaps[0].shape_index_of_endpoint('receiver', rx_j.id)
    sds = [sn.compile(use_bvh=False) for sn in snaps]
    packed = cpi_tables_from_numpy([jax_leaves(sd) for sd in sds],
                                   port_band(sds[0].band), rx_t, si)
    # the stacked tables are the JAX package's per-pulse packs, bit for bit
    for p, sd in enumerate(sds):
        params, prim, txp, *_ = pr._pack_scene(sd, rx_j, si)
        for a, b in ((packed.params[p, 1:], params[1:]),
                     (packed.prim[p], prim), (packed.txp[p], txp)):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          np.asarray(b).view(np.uint32))
    assert packed.moving and packed.n_pulses == n_pulses
    seeds, step = rk.cpi_seeds(seed, n_pulses, crn)
    assert step == (0 if crn else 7919)
    nd = rk.n_draws(depth)
    u = torch.stack([_uniforms(sp, nd, n_lanes) for sp in seeds])
    t = torch.tensor
    params = t(packed.params)
    params[:, 0] = t([rk.seed_slot(sp) for sp in seeds])
    adc = ADCConfig(n_time=8, n_freq=1, sampling_start=0.0,
                    sampling_time=2e-3, freq_lo=38e3, freq_hi=42e3)
    kw = dict(adc=adc, max_depth=depth, time_sampling='gate',
              rx_kind='wigner', n_lanes=n_lanes, doppler=True,
              coherent=True)
    acc, n_ev = rk.receive_megakernel_cpi(params, t(packed.prim),
                                          t(packed.txp), uniforms=u, **kw)
    assert acc.shape == cube_j.shape and n_ev.shape == (n_pulses,)
    slack = rk.phase_slack(s_j.band, adc)
    for p in range(n_pulses):
        amp = torch.zeros((8, 1), dtype=torch.float64)
        ref, n_ref = rk.receive_megakernel_ref(
            params[p], t(packed.prim[p]), t(packed.txp[p]), u[p],
            amp_out=amp, **{k: v for k, v in kw.items() if k != 'n_lanes'})
        # the plain CPI is the plain version pulse by pulse
        assert torch.equal(acc[p], ref) and int(n_ev[p]) == int(n_ref)
        scale = np.abs(cube_j[p]).max()
        assert scale > 0
        bound = TOL * scale + slack * amp.numpy()[..., None]
        assert (np.abs(acc[p].numpy() - cube_j[p]) <= bound).all()
    # common random numbers: one stream, so the pulses differ only by the
    # target's motion; independent pulses draw apart
    assert torch.equal(u[0], u[1]) == crn


def test_cpi_engines_agree_on_the_cpu():
    """'scan' (one CPI call of the kernel's plain version), 'pallas' and
    'loop' (one receive() per pulse) give one cube, bit for bit, with
    common random numbers and without; 'pallas' samples the gate."""
    s, _ = bt.micro_doppler_scene()
    kw = dict(n_pulses=4, prf=400.0, t0=0.01, seed=3, spp=1024,
              max_depth=1, device='cpu')
    for crn in (True, False):
        a, n = bt.receive_cpi(s, common_random_numbers=crn, **kw)
        b, m = bt.receive_cpi(s, common_random_numbers=crn, engine='loop',
                              **kw)
        assert n == m == 1024 and a.shape == b.shape == (4, 8, 1, 4)
        assert torch.equal(a, b) and float(a[..., :2].abs().sum()) > 0
        assert not a[..., 2:].any()
    g, _ = bt.receive_cpi(s, engine='pallas', **kw)
    h, _ = bt.receive_cpi(s, engine='loop', time_sampling='gate', **kw)
    assert torch.equal(g, h)
    p, _ = bt.receive_cpi(s, coherent=False, **kw)
    assert p.shape == (4, 8, 1, 3) and float(p[..., 0].sum()) > 0


def test_cpi_launch_counts_and_scope(monkeypatch):
    """The kernel routes run one plain CPI call for the train; a scene
    outside the kernel's scope (a plastic sphere: the kinds have no lobe
    twin) runs the loop under 'scan' and raises under 'pallas', naming the
    ROADMAP item."""
    calls = []
    k = rk.receive_megakernel_cpi

    def counted(*a, **kw):
        calls.append(int(a[0].shape[0]))
        return k(*a, **kw)
    monkeypatch.setattr(rk, 'receive_megakernel_cpi', counted)
    s, _ = bt.micro_doppler_scene()
    bt.receive_cpi(s, n_pulses=3, spp=1024, max_depth=1, device='cpu')
    assert calls == [3]
    s.add(plastic('pl', twosided=True))
    s.add(sh_t.sphere(center=(2.0, -6.0, 0.0), radius=0.3, bsdf='pl'))
    with pytest.raises(NotImplementedError, match='ROADMAP B1'):
        bt.receive_cpi(s, n_pulses=2, spp=256, max_depth=1, engine='pallas',
                       device='cpu')
    cube, n = bt.receive_cpi(s, n_pulses=2, spp=256, max_depth=1,
                             device='cpu')
    assert calls == [3] and cube.shape == (2, 8, 1, 4) and n == 256
    with pytest.raises(ValueError, match='engine'):
        bt.receive_cpi(s, engine='fast', device='cpu')


# ---------------------------------------------------------------------------
# anchors of golden configs 4 and 5, through receive_cpi on the CPU
# ---------------------------------------------------------------------------


def test_micro_doppler_comb_on_the_golden_bins():
    """Config 5 at 2^11 samples a pulse (the config takes 2^13): the nine
    strongest slow-time bins are the Bessel comb's `comb_bins`, the rest
    at least 12 dB below the peak (tests/test_golden.py)."""
    g = np.load(os.path.join(GOLDEN, 'micro_doppler_cpi.npz'))
    comb = sorted(int(b) for b in g['meta_comb_bins'])
    assert scenes.micro_doppler_comb_bins() == comb
    s, _ = bt.micro_doppler_scene()
    md = scenes.MICRO_DOPPLER
    cube, n = bt.receive_cpi(s, n_pulses=md['n_pulses'], prf=md['prf'],
                             seed=md['seed'], spp=1 << 11,
                             max_depth=md['max_depth'], time_sampling='gate',
                             device='cpu')
    spec = scenes.micro_doppler_spectrum(cube, n).double().numpy()
    assert np.isfinite(spec).all() and spec.shape == (md['n_pulses'],)
    assert sorted(np.argsort(spec)[::-1][:len(comb)].tolist()) == comb
    off = [b for b in range(len(spec)) if b not in comb]
    assert spec[off].max() < spec.max() * 10 ** (-12 / 10)


def test_corner_reflector_in_its_range_doppler_cell():
    """Config 4 in full on the CPU (64 pulses x 2^16 samples, depth 4: the
    triple mirror bounce and the direct hit need all four vertices; 2^14
    samples leave the peak in the noise): the dechirped, decimated
    range-Doppler map peaks within 1 Doppler and 2 range bins of the
    analytic cell (configs.py:274-284), as the golden does."""
    g = np.load(os.path.join(GOLDEN, 'fmcw_dechirp_chain.npz'))
    want = scenes.corner_anchors()
    assert want == {'range_bin': int(g['meta_expected_range_bin']),
                    'doppler_bin': int(g['meta_expected_doppler_bin'])}
    s, _ = bt.corner_scene()
    c = scenes.CORNER
    torch.set_num_threads(4)
    try:
        cube, n = bt.receive_cpi(s, n_pulses=c['n_pulses'], prf=c['prf'],
                                 seed=c['seed'], spp=c['spp'],
                                 max_depth=c['max_depth'], device='cpu')
    finally:
        torch.set_num_threads(1)
    assert cube.shape == (64, 1024, 1, 4) and n == c['spp']
    rdm = scenes.corner_rd_map(cube, n).abs().numpy()
    assert rdm.shape == (64, 128) and np.isfinite(rdm).all()
    pk = np.unravel_index(rdm.argmax(), rdm.shape)
    assert abs(int(pk[0]) - want['doppler_bin']) <= 1
    assert abs(int(pk[1]) - want['range_bin']) <= 2
