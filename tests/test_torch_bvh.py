"""The port's BVH against the JAX package: the host build array for array,
the packed tables bit for bit, and the plain versions of the BVH kernels
(`bvh_closest`, `bvh_any`, which CPU tensors run) against the Pallas
kernels in interpret mode and against the lock-step wavefront walks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu.geometry import bvh as bvh_j
from beifong_tpu.geometry import pallas_bvh as pbvh

from beifong_tpu_torch.geometry import bvh as bvh_t
from beifong_tpu_torch.geometry import bvh_kernel as bk
from beifong_tpu_torch.geometry.mesh import make_grid

torch.set_num_threads(1)

N_RAYS = 2048


def crumpled(nx, ny, seed=0):
    """World-space faces (v0, e1, e2) of a crumpled make_grid(nx, ny)
    plate 4 m out, like the mesh benchmark's target, jittered by seed."""
    v, f = make_grid(nx, ny)
    g = np.random.default_rng(seed)
    v[:, 2] = 0.05 * np.sin(6 * v[:, 0]) * np.cos(5 * v[:, 1]) \
        + 0.01 * g.standard_normal(len(v)).astype(np.float32)
    m = np.asarray([[0.6, 0, 0, 0], [0, 0, -0.6, -4.0], [0, 0.6, 0, 0],
                    [0, 0, 0, 1]], np.float32)
    w = v @ m[:3, :3].T + m[:3, 3]
    a, b, c = w[f[:, 0]], w[f[:, 1]], w[f[:, 2]]
    return a, b - a, c - a


MESHES = [(9, 9, 0), (5, 3, 1), (13, 11, 2), (1, 1, 0)]


@pytest.mark.parametrize('align', [True, False])
@pytest.mark.parametrize('mesh', MESHES, ids=lambda m: f'{m[0]}x{m[1]}')
def test_build_matches_jax_array_for_array(mesh, align):
    tris = crumpled(*mesh)
    bj = bvh_j.build(*tris, align=align, use_native=False)
    bt_ = bvh_t.build(*tris, align=align)
    assert bt_.n_nodes == bj.n_nodes
    for f in ('bb_min', 'bb_max', 'hit_link', 'miss_link', 'leaf_offset',
              'leaf_count', 'v0', 'e1', 'e2', 'perm'):
        a, b = getattr(bt_, f), np.asarray(getattr(bj, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize('payloads', [0, 1, 2], ids=['80', '88', '96'])
@pytest.mark.parametrize('mesh', MESHES[:3], ids=lambda m: f'{m[0]}x{m[1]}')
def test_pack_bit_identical_to_jax(mesh, payloads):
    tris = crumpled(*mesh)
    n = len(tris[0])
    g = np.random.default_rng(mesh[2])
    p1 = g.uniform(0, 1, n).astype(np.float32) if payloads >= 1 else None
    p2 = g.integers(0, 4, n).astype(np.float32) if payloads == 2 else None
    pj = pbvh.pack(bvh_j.build(*tris, align=True), payload=p1, payload2=p2)
    pt = bk.pack(bvh_t.build(*tris, align=True), payload=p1, payload2=p2)
    assert (pt.n_nodes, pt.n_leaves, pt.stride) == \
        (pj.n_nodes, pj.n_leaves, pj.stride) == \
        (pj.n_nodes, pj.n_leaves, 80 + 8 * payloads)
    for f in ('bbox', 'links', 'leaves'):
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f)


@pytest.fixture(scope='module')
def queries():
    """2048 seeded rays from around a crumpled make_grid(9, 9) toward
    points of its bounding box, maxt leaving some blocked and some free;
    the JAX interpret-mode kernels' answers."""
    tris = crumpled(9, 9)
    g = np.random.default_rng(5)
    lo = tris[0].min(0) - 0.05
    hi = tris[0].max(0) + 0.05
    tgt = g.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    org = ((lo + hi) / 2 + g.uniform(-1.0, 1.0, (N_RAYS, 3))).astype(
        np.float32)
    d = tgt - org
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    maxt = (dist * g.uniform(0.8, 1.2, N_RAYS)).astype(np.float32)
    pj = pbvh.pack(bvh_j.build(*tris, align=True))
    o_j, d_j = jnp.asarray(org), jnp.asarray(d)
    closest = [np.asarray(x) for x in pbvh.bvh_closest(pj, o_j, d_j,
                                                       interpret=True)]
    occ = np.asarray(pbvh.bvh_any(pj, o_j, d_j, jnp.asarray(maxt),
                                  interpret=True))
    pt = bk.pack(bvh_t.build(*tris, align=True))
    return pt, bvh_t.build(*tris, align=True), torch.from_numpy(org), \
        torch.from_numpy(d), torch.from_numpy(maxt), closest, occ


def _check_closest(got, want):
    t, idx, u, v = (x.numpy() for x in got)
    tj, ij, uj, vj = want
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(t), np.isinf(tj))
    np.testing.assert_array_equal(idx, ij)
    hit = ij >= 0
    np.testing.assert_allclose(t[hit], tj[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(u[hit], uj[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(v[hit], vj[hit], rtol=0, atol=1e-5)
    assert 0.2 * N_RAYS < hit.sum() < N_RAYS


def test_bvh_closest_matches_jax_kernel(queries):
    pt, _, o, d, _, closest, _ = queries
    _check_closest(bk.bvh_closest(pt, o, d), closest)


def test_bvh_any_matches_jax_kernel(queries):
    pt, _, o, d, maxt, _, occ = queries
    got = bk.bvh_any(pt, o, d, maxt)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), occ)
    # both blocked and free rays occur
    assert 0 < occ.sum() < N_RAYS


def test_plain_walks_match_the_wavefront_walks(queries):
    pt, b, o, d, maxt, closest, occ = queries
    _check_closest(bvh_t.traverse_closest(b, o, d), closest)
    np.testing.assert_array_equal(bvh_t.traverse_any(b, o, d, maxt).numpy(),
                                  occ)


def test_walk_counts_and_wrapper_checks(queries):
    pt, _, o, d, maxt, _, _ = queries
    stats = {}
    bk.bvh_closest_ref(pt, o, d, stats=stats)
    assert stats['walks'] == N_RAYS
    assert N_RAYS <= stats['node_tests'] <= N_RAYS * pt.n_nodes
    assert 0 < stats['leaf_tests'] <= N_RAYS * pt.n_leaves
    with pytest.raises(ValueError, match='maxt'):
        bk.bvh_any(pt, o, d, maxt[:10])
    with pytest.raises(ValueError, match='o:'):
        bk.bvh_closest(pt, o.double(), d)
    with pytest.raises(ValueError, match='payload2'):
        bk.pack(bvh_t.build(*crumpled(1, 1)), payload2=np.zeros(2))
