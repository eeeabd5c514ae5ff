"""The port's ray queries against the JAX package: K4's plain version
(`geometry/intersect_kernel.py`, which CPU tensors run) against the Pallas
kernel in interpret mode and against the chunked dense test, the analytic
intersectors per shape kind, and `closest_hit` / `any_hit` on the dense,
chunked and BVH branches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.geometry import intersect as isect_j
from beifong_tpu.geometry import pallas_intersect as pi_j

from beifong_tpu_torch.geometry import intersect as isect_t
from beifong_tpu_torch.geometry import intersect_kernel as ik
from beifong_tpu_torch.interop import scene_data_from_numpy

from test_torch_mesh import jax_leaves, port_band

torch.set_num_threads(1)


def _soup(n_tris, seed=0):
    """test_accel.py's random triangle soup."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    a = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    b = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    return c, a, b


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = rng.uniform(0.5, 6.0, n).astype(np.float32)
    return o, d, maxt


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize('n_tris, n_rays', [(300, 513), (1100, 257)])
def test_k4_plain_version_matches_pallas_interpret(n_tris, n_rays):
    """Equal faces on hits, -1 on misses, t within 2e-5 relative (the
    tolerance of tests/test_accel.py), u and v within 1e-5."""
    tris = _soup(n_tris)
    o, d, maxt = _rays(n_rays)
    t_j, i_j, u_j, v_j = (np.asarray(x) for x in pi_j.ray_triangle_closest(
        *(jnp.asarray(x) for x in (o, d, *tris)), interpret=True))
    occ_j = np.asarray(pi_j.ray_triangle_any(
        *(jnp.asarray(x) for x in (o, d, *tris, maxt)), interpret=True))
    t_t, i_t, u_t, v_t = (x.numpy() for x in ik.ray_triangle_closest(
        *_t(o, d, *tris)))
    occ_t = ik.ray_triangle_any(*_t(o, d, *tris, maxt)).numpy()
    hit = i_j >= 0
    assert 20 < hit.sum() < n_rays
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=2e-5)
    assert np.isinf(t_t[~hit]).all()
    np.testing.assert_allclose(u_t[hit], u_j[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v_t[hit], v_j[hit], rtol=0, atol=1e-5)
    assert (u_t[~hit] == 0).all() and (v_t[~hit] == 0).all()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0 < occ_t.sum() < n_rays


def test_k4_plain_version_ties_match_pallas_interpret():
    """Duplicate faces inside a TPU tile, across its 512-face boundary and
    across two: the lowest index wins in the Pallas kernel (jnp.argmin in
    a tile, the strict `better` across tiles) and in the plain version."""
    v0, e1, e2 = _soup(1100, seed=4)
    copies = ((300, 301), (10, 520), (511, 512), (600, 1030), (40, 1099))
    for src, dst in copies:
        v0[dst], e1[dst], e2[dst] = v0[src], e1[src], e2[src]
    rng = np.random.default_rng(5)
    faces = rng.choice([s for s, _ in copies], 384)
    a, b = rng.uniform(0.1, 0.45, (2, 384))
    tgt = v0[faces] + a[:, None] * e1[faces] + b[:, None] * e2[faces]
    o = rng.uniform(-3, 3, (384, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_j, i_j, _, _ = (np.asarray(x) for x in pi_j.ray_triangle_closest(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2)), interpret=True))
    t_t, i_t, _, _ = (x.numpy() for x in ik.ray_triangle_closest(
        *_t(o, d, v0, e1, e2)))
    np.testing.assert_array_equal(i_t, i_j)
    hit = i_j >= 0
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=2e-5)
    assert not set(i_t.tolist()) & {d for _, d in copies}
    assert {s for s, _ in copies} <= set(i_t.tolist())


def test_k4_plain_version_matches_chunked_dense_test():
    """Above CHUNK_F faces: the JAX package's `_triangle_closest_chunked`
    gives the same faces; its dense `any_hit` the same flags."""
    n_tris = 2 * isect_j.CHUNK_F + 300
    assert ik.CHUNK_F == isect_j.CHUNK_F
    tris = _soup(n_tris, seed=2)
    o, d, maxt = _rays(384, seed=3)
    tri_j = isect_j.TriData(*(jnp.asarray(x) for x in tris),
                            n=jnp.zeros((n_tris, 3)),
                            shape_idx=jnp.zeros(n_tris, jnp.int32))
    t_j, i_j, u_j, v_j = (np.asarray(x) for x in
                          isect_j._triangle_closest_chunked(
                              tri_j, jnp.asarray(o), jnp.asarray(d)))
    t_t, i_t, u_t, v_t = (x.numpy() for x in ik.ray_triangle_closest(
        *_t(o, d, *tris)))
    hit = np.isfinite(t_j)
    assert 100 < hit.sum() < len(o)
    np.testing.assert_array_equal(i_t[hit], i_j[hit])
    assert (i_t[~hit] == -1).all()
    np.testing.assert_allclose(t_t[hit], t_j[hit], rtol=2e-5)
    np.testing.assert_allclose(u_t[hit], u_j[hit], rtol=0, atol=1e-5)
    occ_j = np.asarray(jnp.any(jnp.isfinite(isect_j.triangle_ts(
        tri_j, jnp.asarray(o), jnp.asarray(d),
        tmax=jnp.asarray(maxt)[:, None] * (1.0 - 1e-3))[0]), axis=1))
    np.testing.assert_array_equal(
        ik.ray_triangle_any(*_t(o, d, *tris, maxt)).numpy(), occ_j)


def test_k4_wrappers_check_their_inputs():
    tris = _t(*_soup(8))
    o, d, maxt = _t(*_rays(4))
    with pytest.raises(ValueError, match='v0'):
        ik.ray_triangle_closest(o, d, tris[0][:, :2].contiguous(), *tris[1:])
    with pytest.raises(ValueError, match='maxt'):
        ik.ray_triangle_any(o, d, *tris, maxt.double())
    with pytest.raises(ValueError, match='d:'):
        ik.ray_triangle_closest(o, d.t().contiguous().t(), *tris)
    ik.ray_triangle_closest.launches = 0
    ik.ray_triangle_closest(o, d, *tris)     # the CPU runs the plain version
    assert ik.ray_triangle_closest.launches == 0


# ---------------------------------------------------------------------------
# analytic shapes, and the full queries
# ---------------------------------------------------------------------------


def _kind_scene(pkg, kind):
    """Three shapes of one kind, one with flipped normals, around the
    origin; compiled SceneData of that package."""
    from test_torch_wavefront import _pkg
    p = _pkg(pkg)
    tf = p.tf
    make = getattr(p.sh, kind)
    s = p.sc.Scene(band=p.Band.from_freq(340.0, 40e3, 10e3))
    s.add(p.bsdf.diffuse('mat'))
    poses = [tf.compose(tf.look_at([0, -3, 0], [0, 0, 0]), tf.scale(0.8)),
             tf.compose(tf.look_at([1.5, -2, 0.5], [0, 0, 0]),
                        tf.scale([0.5, 0.9, 0.7])),
             tf.compose(tf.translate([-1.0, -2.5, -0.5]), tf.scale(0.6))]
    for i, m in enumerate(poses):
        s.add(make(to_world=np.asarray(m), bsdf='mat',
                   flip_normals=(i == 1)))
    return s.compile() if pkg == 'jax' else s.compile(device='cpu')


def _toward(targets, n, seed):
    """n rays from around the origin toward points near `targets`."""
    g = np.random.default_rng(seed)
    o = g.normal(0, 0.3, (n, 3)).astype(np.float32)
    tgt = targets[g.integers(0, len(targets), n)] \
        + g.normal(0, 0.7, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
    return o, d.astype(np.float32), maxt


@pytest.mark.parametrize('kind', ['rectangle', 'sphere', 'disk', 'cylinder'])
def test_analytic_ts_and_attrs_match_jax(kind):
    sd_j = _kind_scene('jax', kind)
    sd_t = _kind_scene('port', kind)
    centres = np.asarray(sd_j.shapes.to_world)[:, :3, 3]
    o, d, _ = _toward(centres, 2048, seed=4)
    ts_j = np.asarray(isect_j.analytic_ts(sd_j.shapes, jnp.asarray(o),
                                          jnp.asarray(d)))
    ts_t = isect_t.analytic_ts(sd_t.shapes, *_t(o, d)).numpy()
    fin = np.isfinite(ts_j)
    assert 200 < fin.any(1).sum() < len(o)
    np.testing.assert_array_equal(np.isfinite(ts_t), fin)
    np.testing.assert_allclose(ts_t[fin], ts_j[fin], rtol=1e-5)
    best = ts_j.argmin(1)
    t = np.where(fin.any(1), ts_j.min(1), 1.0).astype(np.float32)
    a_j = isect_j.analytic_attrs(sd_j.shapes, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t), jnp.asarray(best))
    a_t = isect_t.analytic_attrs(sd_t.shapes, *_t(o, d, t),
                                 torch.from_numpy(best))
    for x_j, x_t in zip(a_j, a_t):
        np.testing.assert_allclose(x_t.numpy()[fin.any(1)],
                                   np.asarray(x_j)[fin.any(1)], rtol=1e-5,
                                   atol=2e-5)


def _mesh_sd(n_side, use_bvh):
    from test_torch_mesh import twin_scene
    s_j, _ = twin_scene('jax', n_side=n_side, clutter=3)
    sd_j = s_j.compile(use_bvh=use_bvh)
    sd_t = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    return sd_j, sd_t


@pytest.mark.parametrize('branch, n_side, use_bvh', [
    ('dense', 9, False), ('chunked', 33, False), ('bvh', 23, True)])
def test_closest_hit_and_any_hit_match_jax(branch, n_side, use_bvh):
    """The full queries on the JAX scene's tables (the BVH carried over by
    `interop`): the same prims, faces, distances and shading frames."""
    sd_j, sd_t = _mesh_sd(n_side, use_bvh)
    assert (sd_t.bvh is not None) == use_bvh
    assert (sd_t.tris.n_faces > ik.CHUNK_F) == (branch == 'chunked')
    centres = np.concatenate([np.asarray(sd_j.shapes.to_world)[:, :3, 3],
                              np.asarray(sd_j.tris.v0)[::97]])
    o, d, maxt = _toward(centres, 2048, seed=5)
    si_j = isect_j.closest_hit(sd_j.shapes, sd_j.tris, jnp.asarray(o),
                               jnp.asarray(d), bvh=sd_j.bvh)
    si_t = isect_t.closest_hit(sd_t.shapes, sd_t.tris, *_t(o, d),
                               bvh=sd_t.bvh)
    valid = np.asarray(si_j.valid)
    assert 200 < valid.sum() < len(o)
    np.testing.assert_array_equal(si_t.valid.numpy(), valid)
    np.testing.assert_array_equal(si_t.shape_idx.numpy(),
                                  np.asarray(si_j.shape_idx))
    np.testing.assert_array_equal(si_t.prim_idx.numpy(),
                                  np.asarray(si_j.prim_idx))
    assert (si_t.prim_idx.numpy() >= 0).sum() > 100
    np.testing.assert_allclose(si_t.t.numpy()[valid],
                               np.asarray(si_j.t)[valid], rtol=2e-5)
    for f in ('p', 'n', 'uv', 'sh_frame', 'wi'):
        np.testing.assert_allclose(getattr(si_t, f).numpy()[valid],
                                   np.asarray(getattr(si_j, f))[valid],
                                   rtol=1e-5, atol=2e-5, err_msg=f)
    occ_j = np.asarray(isect_j.any_hit(sd_j.shapes, sd_j.tris,
                                       jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(maxt), bvh=sd_j.bvh))
    occ_t = isect_t.any_hit(sd_t.shapes, sd_t.tris, *_t(o, d, maxt),
                            bvh=sd_t.bvh).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0 < occ_t.sum() < len(o)
