"""The port's textures and CA-CFAR against the JAX package: each texture
constructor, the texture table `Scene.compile` builds (leaf for leaf, a
mesh-attribute texture's per-face values included), `texture_eval` with
a hit triangle and a wavelength, `interop` carrying a mesh-attribute
texture over, and `ca_cfar_2d` on seeded maps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beifong_tpu import bsdf as bsdf_j
from beifong_tpu import scene as scene_j
from beifong_tpu import textures as tex_j
from beifong_tpu.core.config import Band as BandJ
from beifong_tpu.dsp import cfar as cfar_j
from beifong_tpu.geometry import shapes as shapes_j
from beifong_tpu.geometry.mesh import MeshSpec as MeshJ, make_grid

from beifong_tpu_torch import scene as scene_t
from beifong_tpu_torch import textures as tex_t
from beifong_tpu_torch.bsdf import tables as bsdf_t
from beifong_tpu_torch.core.config import Band as BandT
from beifong_tpu_torch.dsp import ca_cfar_2d
from beifong_tpu_torch.geometry import shapes as shapes_t
from beifong_tpu_torch.geometry.mesh import MeshSpec as MeshT
from beifong_tpu_torch.interop import scene_data_from_numpy

from test_torch_mesh import jax_leaves, port_band, port_leaves

torch.set_num_threads(1)

WL = [0.007, 0.008, 0.0085, 0.010]
VALS = [0.1, 0.9, 0.4, 0.2]


def _specs(tx, band):
    """One texture of each constructor, the same in both packages."""
    g = np.random.default_rng(5)
    return [tx.constant('c', [0.2, 0.4, 0.6]),
            tx.checkerboard('k', 0.9, 0.1, scale_uv=(4.0, 3.0)),
            tx.bitmap('b', g.random((5, 7, 3)).astype(np.float32),
                      scale_uv=(1.5, 2.0)),
            tx.bitmap('b2', g.random((3, 9)).astype(np.float32)),
            tx.spectrum_curve('s', wavelengths=WL, values=VALS, band=band),
            tx.spectrum_curve('r', values=VALS, lambda_min=0.0075,
                              lambda_max=0.0095),
            tx.spectrum_curve('p', wavelengths=[0.008], values=[0.5]),
            tx.mesh_attribute('m', g.random(2 * 4 * 4).astype(np.float32))]


FIELDS = ('type', 'color0', 'color1', 'scale_uv', 'data', 'curve_lo',
          'curve_hi', 'curve', 'face_values')


def test_constructors_match_jax():
    """Every field of every spec, the band mean of a curve among them
    (bands inside, across and outside its extent)."""
    specs_j = _specs(tex_j, BandJ.from_freq(340.0, 40e3, 10e3))
    specs_t = _specs(tex_t, BandT.from_freq(340.0, 40e3, 10e3))
    for sj, st in zip(specs_j, specs_t):
        for f in FIELDS:
            a, b = getattr(st, f), getattr(sj, f, None)
            assert (a is None) == (b is None), (sj.id, f)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f'{sj.id}.{f}')
                assert np.asarray(a).dtype == np.asarray(b).dtype
    for f_c in (20e3, 39e3, 48e3, 120e3):
        a = tex_t.spectrum_curve('s', wavelengths=WL, values=VALS,
                                 band=BandT.from_freq(340.0, f_c, 10e3))
        b = tex_j.spectrum_curve('s', wavelengths=WL, values=VALS,
                                 band=BandJ.from_freq(340.0, f_c, 10e3))
        np.testing.assert_array_equal(a.color0, b.color0)


def _scene(pkg):
    """A mesh under the mesh-attribute texture, rectangles under the
    others, diffuse and plastic BSDFs referencing them by id."""
    sc, bs, sh, tx, Band, Mesh = (
        (scene_j, bsdf_j, shapes_j, tex_j, BandJ, MeshJ) if pkg == 'jax'
        else (scene_t, bsdf_t, shapes_t, tex_t, BandT, MeshT))
    band = Band.from_freq(340.0, 40e3, 10e3)
    s = sc.Scene(band=band)
    for t in _specs(tx, band):
        s.add(t)
    ids = ('c', 'k', 'b', 'b2', 's', 'r', 'p')
    for i, t in enumerate(ids):
        s.add(bs.diffuse(f'd{t}', reflectance=0.5 + 0.05 * i, texture=t))
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (i, -3.0, 0.0)
        s.add(sh.rectangle(to_world=m, bsdf=f'd{t}'))
    s.add(bs.plastic('pm', diffuse_reflectance=0.7, texture='m'),
          bs.rough_plastic('rp', texture='k'), bs.diffuse('plain'))
    v, f = make_grid(4, 4)
    s.add(Mesh(np.asarray(v, np.float32), np.asarray(f), bsdf='pm'))
    return s


def test_compile_matches_jax_leaf_for_leaf():
    """The texture table and the BSDFs' texture rows, `face_attr` and its
    row included; `at_time` keeps the textures."""
    s_j, s_t = _scene('jax'), _scene('port')
    sd_j = s_j.compile(use_bvh=False)
    sd_t = s_t.compile(device='cpu')
    lj, lt = jax_leaves(sd_j), port_leaves(sd_t)
    keys = {k for k in lt if k.startswith(('.textures', '.bsdfs'))}
    assert '.textures.face_attr' in keys and '.bsdfs.texture_idx' in keys
    for k in sorted(keys):
        assert lt[k].dtype == lj[k].dtype and lt[k].shape == lj[k].shape, k
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    assert sd_t.textures.face_attr_row == int(lj['.textures.face_attr_row'])
    assert sd_t.bsdfs.texture_idx.tolist()[-3:] == [7, 1, -1]
    snap = s_t.at_time(0.25)
    assert snap.textures == s_t.textures
    assert torch.equal(snap.compile(device='cpu').textures.atlas,
                       sd_t.textures.atlas)


def test_unknown_texture_raises():
    for pkg, bs, sc in (('jax', bsdf_j, scene_j), ('port', bsdf_t, scene_t)):
        s = sc.Scene()
        s.add(bs.diffuse('d', texture='nowhere'))
        with pytest.raises(KeyError, match='nowhere'):
            s.compile() if pkg == 'jax' else s.compile(device='cpu')
    # a normal map's texture is resolved as the others are
    s = scene_t.Scene()
    s.add(bsdf_t.diffuse('d'), bsdf_t.normalmap('n', 'd', 'nowhere'))
    with pytest.raises(KeyError, match='nowhere'):
        s.compile(device='cpu')


@pytest.mark.parametrize('with_wl', [False, True], ids=['no-wl', 'wl'])
def test_texture_eval_matches_jax(with_wl):
    """Random rows (and -1), uv, hit triangles (and -1) and wavelengths
    over the compiled table, to 1e-6."""
    sd_j = _scene('jax').compile(use_bvh=False)
    sd_t = _scene('port').compile(device='cpu')
    g = np.random.default_rng(9)
    n = 4096
    n_rows = int(sd_t.textures.type.shape[0])
    idx = g.integers(-1, n_rows, n).astype(np.int32)
    uv = g.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    prim = g.integers(-1, 40, n).astype(np.int32)
    wl = g.uniform(0.0065, 0.0105, n).astype(np.float32) if with_wl \
        else None
    ref = tex_j.texture_eval(sd_j.textures, jnp.asarray(idx),
                             jnp.asarray(uv), jnp.asarray(prim),
                             wl=None if wl is None else jnp.asarray(wl))
    got = tex_t.texture_eval(sd_t.textures, torch.from_numpy(idx),
                             torch.from_numpy(uv), torch.from_numpy(prim),
                             wl=None if wl is None else torch.from_numpy(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # without prim_idx a mesh-attribute row reads its color0
    got0 = tex_t.texture_eval(sd_t.textures, torch.from_numpy(idx),
                              torch.from_numpy(uv))
    ref0 = tex_j.texture_eval(sd_j.textures, jnp.asarray(idx),
                              jnp.asarray(uv))
    np.testing.assert_allclose(got0.numpy(), np.asarray(ref0), atol=1e-6)


def test_interop_carries_the_mesh_attribute():
    """A JAX scene with a mesh-attribute texture reaches the port: its
    per-face values and their row come across."""
    sd_j = _scene('jax').compile(use_bvh=False)
    sd = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                               device='cpu')
    np.testing.assert_array_equal(sd.textures.face_attr.numpy(),
                                  np.asarray(sd_j.textures.face_attr))
    assert sd.textures.face_attr_row == sd_j.textures.face_attr_row == 7
    for f in dataclasses.fields(tex_t.TextureTable):
        a = getattr(sd.textures, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(getattr(sd_j.textures, f.name)))


# (shape, guard, train, seed)
CFAR_CASES = [((64, 128), (2, 2), (8, 8), 0), ((16, 64), (1, 2), (4, 6), 1),
              ((128, 256), (2, 3), (8, 8), 2), ((8, 8), (2, 2), (8, 8), 3)]


@pytest.mark.parametrize('shape, guard, train, seed', CFAR_CASES)
def test_ca_cfar_matches_jax(shape, guard, train, seed):
    """Thresholds to 1e-5 relative plus the rounding of the float32
    cumulative sums the box sums difference: each package sums its
    prefixes in its own order (XLA's scan against torch's sequential
    cumsum), and a box sum of a few hundred cells out of prefixes of up to
    the whole map's sum keeps an absolute error of a few ulps of that sum
    (on a 128 x 256 map ~3e-5 of a threshold).  So the slack per cell adds
    8 ulps of the map's total over the cell's training count, times alpha
    (the largest error seen is 2.6 of those ulps); the detections are equal wherever power and threshold differ
    by more than the slack."""
    g = np.random.default_rng(seed)
    p = g.exponential(1.0, shape).astype(np.float32)
    p[shape[0] // 3, shape[1] // 4] += 200.0
    p[-1, -1] += 50.0
    det_j, th_j = cfar_j.ca_cfar_2d(jnp.asarray(p), guard, train, 1e-4)
    det_t, th_t = ca_cfar_2d(torch.from_numpy(p), guard, train, 1e-4)
    th_j, det_j = np.asarray(th_j), np.asarray(det_j)
    assert det_t.dtype == torch.bool and th_t.dtype == torch.float32
    assert th_t.shape == th_j.shape == shape
    # each cell's alpha: its threshold over a map of ones (noise 1)
    alpha = ca_cfar_2d(torch.ones(shape), guard, train, 1e-4)[1].numpy()
    eps = np.finfo(np.float32).eps

    def count(n, h):      # in-bounds cells of each index's window
        i = np.arange(n)
        return np.minimum(i + h, n - 1) - np.maximum(i - h, 0) + 1

    n_train = np.maximum(
        np.outer(count(shape[0], guard[0] + train[0]),
                 count(shape[1], guard[1] + train[1]))
        - np.outer(count(shape[0], guard[0]), count(shape[1], guard[1])), 1)
    slack = 1e-5 * np.abs(th_j) + 8 * eps * float(p.sum()) \
        * alpha / n_train
    err = np.abs(th_t.numpy() - th_j)
    assert (err <= slack).all(), (err / np.abs(th_j)).max()
    far = np.abs(p - th_j) > slack
    np.testing.assert_array_equal(det_t.numpy()[far], det_j[far])
    assert det_t[shape[0] // 3, shape[1] // 4]
