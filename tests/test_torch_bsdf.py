"""The port's BSDF tables, evaluation and sampling, warps and texture
lookup against the JAX package, on the same directions and uniforms.

Tolerance: rtol 1e-5, atol 1e-6 (the same float32 formulas, evaluated in
another order, with other sin / cos / sqrt implementations) on all but
1e-3 of the values; those few, and every other, within rtol 1e-3, atol
1e-4.  The exceptions are directions at the rim of a hemisphere: z =
sqrt(1 - r^2) turns a 1-ulp difference in r into ~1e-5 in z there, and
the pdfs and weights computed from that z follow it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu import bsdf as bsdf_j
from beifong_tpu import textures as tex_j
from beifong_tpu.core import warp as warp_j

from beifong_tpu_torch.bsdf import eval as eval_t
from beifong_tpu_torch.bsdf import tables as bsdf_t
from beifong_tpu_torch.core import warp as warp_t
from beifong_tpu_torch import textures as tex_t

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _specs(b, with_nested=True, with_measured=True):
    """One BSDF of every type (in package module `b`)."""
    grid = np.random.default_rng(9).uniform(0.05, 1.0, (6, 6, 8)).astype(
        np.float32)
    specs = [b.diffuse('mat', reflectance=[0.8, 0.5, 0.3], twosided=True),
             b.diffuse('one', reflectance=0.6),
             b.conductor('mirror', eta=0.2, k=3.0, twosided=True),
             b.rough_conductor('rough', alpha=0.25, eta=[0.2, 0.9, 1.1],
                               k=[3.0, 2.5, 2.2]),
             b.dielectric('glass', int_ior=1.45),
             b.thin_dielectric('film', int_ior=1.33),
             b.plastic('shell', diffuse_reflectance=0.6, twosided=True),
             b.rough_plastic('coat', diffuse_reflectance=0.4, alpha=0.3),
             b.rough_dielectric('frost', alpha=0.35, int_ior=1.3),
             b.null('pass')]
    if with_measured:
        specs.append((bsdf_j.tables if b is bsdf_j else b).measured(
            'meas', grid, twosided=True))
    if with_nested:
        specs += [b.blend('mix', 'mat', 'rough', weight=0.3),
                  b.mask('holes', 'shell', opacity=0.7)]
    return specs


def _tables(**kw):
    tj = bsdf_j.BSDFTable.build(_specs(bsdf_j, **kw), lambda _id: -1)
    tt = bsdf_t.BSDFTable.build(_specs(bsdf_t, **kw), 'cpu')
    return tj, tt


def _dirs(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=100 * RTOL, atol=100 * ATOL,
                               err_msg=what)
    off = ~np.isclose(got, ref, rtol=RTOL, atol=ATOL)
    assert off.sum() <= 1e-3 * off.size, (what, int(off.sum()))


def test_tables_match_jax():
    tj, tt = _tables()
    for f in dataclasses.fields(bsdf_t.BSDFTable):
        a = getattr(tt, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(tj, f.name)),
                                          err_msg=f.name)
    assert tt.present == tuple(tj.present)
    # the normal and bump maps build the JAX package's spec: a blend of
    # weight 1 over the nested BSDF, carrying the map's texture id
    import beifong_tpu.bsdf as bsdf_j
    for name in ('normalmap', 'bumpmap'):
        a = getattr(bsdf_t, name)('x', 'mat', 'tex')
        b = getattr(bsdf_j, name)('x', 'mat', 'tex')
        for f in ('type', 'nested0', 'nested1', 'weight', 'alpha',
                  'normalmap', 'bumpmap'):
            assert getattr(a, f) == getattr(b, f), (name, f)
        np.testing.assert_array_equal(a.reflectance, b.reflectance)


@pytest.mark.parametrize('kw', [dict(), dict(with_nested=False),
                                dict(with_nested=False,
                                     with_measured=False)],
                         ids=['all', 'no-nested', 'no-nested-measured'])
@pytest.mark.parametrize('scaled', [False, True], ids=['const', 'scaled'])
def test_eval_pdf_and_sample_match_jax(kw, scaled):
    tj, tt = _tables(**kw)
    g = np.random.default_rng(3 + scaled)
    n_b = int(tt.type.shape[0])
    idx = g.integers(0, n_b, N).astype(np.int32)
    idx[:8] = -1      # no BSDF
    wi, wo = _dirs(g, N), _dirs(g, N)
    u_lobe = g.random(N, dtype=np.float32)
    u_dir = g.random((N, 2), dtype=np.float32)
    rs = g.uniform(0.2, 1.0, (N, 3)).astype(np.float32) if scaled else None
    rs_j = None if rs is None else jnp.asarray(rs)
    rs_t = None if rs is None else torch.from_numpy(rs)
    f_j, pdf_j = bsdf_j.bsdf_eval_pdf(tj, jnp.asarray(idx), jnp.asarray(wi),
                                      jnp.asarray(wo), rs_j)
    f_t, pdf_t = eval_t.bsdf_eval_pdf(tt, torch.from_numpy(idx),
                                      torch.from_numpy(wi),
                                      torch.from_numpy(wo), rs_t)
    assert float(np.abs(np.asarray(f_j)).max()) > 0
    _close(f_t, f_j, 'f')
    _close(pdf_t, pdf_j, 'pdf')
    out_j = bsdf_j.bsdf_sample(tj, jnp.asarray(idx), jnp.asarray(wi),
                               jnp.asarray(u_lobe), jnp.asarray(u_dir), rs_j)
    out_t = eval_t.bsdf_sample(tt, torch.from_numpy(idx),
                               torch.from_numpy(wi),
                               torch.from_numpy(u_lobe),
                               torch.from_numpy(u_dir), rs_t)
    for name, a, b in zip(('wo', 'weight', 'pdf', 'is_delta', 'eta_scale'),
                          out_t, out_j):
        if name == 'is_delta':
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, name)


def test_diffuse_only_fast_path_matches_jax():
    specs_j = [bsdf_j.diffuse('a', 0.7, twosided=True),
               bsdf_j.diffuse('b', 0.3)]
    specs_t = [bsdf_t.diffuse('a', 0.7, twosided=True),
               bsdf_t.diffuse('b', 0.3)]
    tj = bsdf_j.BSDFTable.build(specs_j, lambda _id: -1)
    tt = bsdf_t.BSDFTable.build(specs_t, 'cpu')
    g = np.random.default_rng(1)
    idx = g.integers(-1, 2, N).astype(np.int32)
    wi, wo = _dirs(g, N), _dirs(g, N)
    u = g.random((N, 2), dtype=np.float32)
    for a, b in zip(eval_t.bsdf_eval_pdf(tt, *(torch.from_numpy(x) for x in
                                               (idx, wi, wo))),
                    bsdf_j.bsdf_eval_pdf(tj, *(jnp.asarray(x) for x in
                                               (idx, wi, wo)))):
        _close(a, b, 'eval')
    out_t = eval_t.bsdf_sample(tt, *(torch.from_numpy(x) for x in
                                     (idx, wi, u[:, 0], u)))
    out_j = bsdf_j.bsdf_sample(tj, *(jnp.asarray(x) for x in
                                     (idx, wi, u[:, 0], u)))
    for a, b in zip(out_t, out_j):
        _close(a.float(), jnp.asarray(b, jnp.float32), 'sample')


WARPS = ['square_to_uniform_disk_concentric', 'square_to_cosine_hemisphere',
         'square_to_uniform_hemisphere', 'square_to_uniform_sphere',
         'square_to_uniform_triangle', 'square_to_tent']
PDFS = ['square_to_uniform_disk_concentric_pdf',
        'square_to_cosine_hemisphere_pdf', 'square_to_uniform_hemisphere_pdf',
        'square_to_uniform_sphere_pdf', 'square_to_tent_pdf']


@pytest.mark.parametrize('name', WARPS + PDFS)
def test_warps_match_jax(name):
    g = np.random.default_rng(len(name))
    u = g.random((N, 2), dtype=np.float32)
    u[0] = (0.5, 0.5)                      # the disk's centre
    x = _dirs(g, N) if name.endswith('_pdf') and 'disk' not in name \
        and 'tent' not in name else u * 2 - 1 if name.endswith('_pdf') else u
    _close(getattr(warp_t, name)(torch.from_numpy(np.ascontiguousarray(x))),
           getattr(warp_j, name)(jnp.asarray(x)), name)


@pytest.mark.parametrize('name', ['square_to_ggx', 'square_to_beckmann',
                                  'square_to_uniform_cone'])
def test_parametric_warps_match_jax(name):
    g = np.random.default_rng(5)
    u = g.random((N, 2), dtype=np.float32)
    a = g.uniform(0.05, 0.9, N).astype(np.float32)
    if name == 'square_to_uniform_cone':
        for cc in (0.3, 0.9):
            d_t = warp_t.square_to_uniform_cone(torch.from_numpy(u), cc)
            _close(d_t, warp_j.square_to_uniform_cone(jnp.asarray(u), cc),
                   name)
            _close(warp_t.square_to_uniform_cone_pdf(d_t, cc),
                   warp_j.square_to_uniform_cone_pdf(jnp.asarray(d_t.numpy()),
                                                     cc), name)
        return
    d_t = getattr(warp_t, name)(torch.from_numpy(u), torch.from_numpy(a))
    _close(d_t, getattr(warp_j, name)(jnp.asarray(u), jnp.asarray(a)), name)
    _close(getattr(warp_t, name + '_pdf')(d_t, torch.from_numpy(a)),
           getattr(warp_j, name + '_pdf')(jnp.asarray(d_t.numpy()),
                                          jnp.asarray(a)), name + '_pdf')
    _close(warp_t.interval_to_tent(torch.from_numpy(u[:, 0])),
           warp_j.interval_to_tent(jnp.asarray(u[:, 0])), 'tent')


def test_texture_eval_matches_jax():
    """The lookup over a JAX texture table, carried over field by field
    (its unset mesh-attribute fields stay None): constant, checkerboard,
    bitmap and spectral-curve rows, and -1."""
    specs = [tex_j.constant('c', [0.2, 0.4, 0.6]),
             tex_j.checkerboard('k', 0.9, 0.1, scale_uv=(4.0, 3.0)),
             tex_j.bitmap('b', np.random.default_rng(2).random(
                 (5, 7, 3)).astype(np.float32), scale_uv=(1.5, 2.0)),
             tex_j.spectrum_curve('s', wavelengths=[0.007, 0.008, 0.009,
                                                    0.010],
                                  values=[0.1, 0.9, 0.4, 0.2])]
    tj = tex_j.TextureTable.build(specs)
    tt = tex_t.TextureTable(**{f.name: torch.tensor(np.asarray(
        getattr(tj, f.name))) for f in dataclasses.fields(tex_t.TextureTable)
        if getattr(tj, f.name) is not None})
    g = np.random.default_rng(4)
    idx = g.integers(-1, len(specs), N).astype(np.int32)
    uv = g.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    wl = g.uniform(0.0065, 0.0105, N).astype(np.float32)
    for w in (None, wl):
        ref = tex_j.texture_eval(tj, jnp.asarray(idx), jnp.asarray(uv),
                                 wl=None if w is None else jnp.asarray(w))
        got = tex_t.texture_eval(tt, torch.from_numpy(idx),
                                 torch.from_numpy(uv),
                                 wl=None if w is None else torch.from_numpy(w))
        _close(got, ref, 'texture')
