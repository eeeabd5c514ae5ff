"""The PyTorch port's scene model against the JAX package: compile parity,
bit-exact scene packing, import isolation and device selection."""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from beifong_tpu.integrators import pallas_receive as pr

from beifong_tpu_torch import Band, receive
from beifong_tpu_torch.film import film_new
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy
from beifong_tpu_torch.radar.endpoints import ADCConfig
from beifong_tpu_torch.scenes import flagship_scene

torch.set_num_threads(1)

SCENES = [dict(), dict(ground=False), dict(rx_kind='omni'),
          dict(R=6.0, ground=False, rx_kind='omni')]


def jax_leaves(sd):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(sd)[0]}


def port_leaves(obj, prefix=''):
    """Tensor leaves of the port's SceneData keyed like JAX pytree paths."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f'{prefix}.{f.name}'] = v.numpy()
        elif dataclasses.is_dataclass(v):
            out.update(port_leaves(v, f'{prefix}.{f.name}'))
    return out


def port_band(band):
    return Band(c=band.c, wavelength_min=band.wavelength_min,
                wavelength_max=band.wavelength_max,
                boundary_phase=band.boundary_phase)


@pytest.mark.parametrize('kw', SCENES)
def test_compile_matches_jax_leaf_for_leaf(kw):
    s_j, _ = g._build_scene(**kw)
    s_t, _ = flagship_scene(**kw)
    sd_j, sd_t = s_j.compile(), s_t.compile(device='cpu')
    assert sd_t.band == port_band(sd_j.band)
    lj, lt = jax_leaves(sd_j), port_leaves(sd_t)
    assert set(lt) <= set(lj), set(lt) - set(lj)
    # every leaf the receive path reads is held by the port
    assert {'.shapes.to_object', '.shapes.surface_area', '.bsdfs.reflectance',
            '.transmitters.wf.t_ext', '.receivers.shape_idx'} <= set(lt)
    for k, v in lt.items():
        assert v.dtype == lj[k].dtype and v.shape == lj[k].shape, k
        # transforms are float32 in both; normalisation may differ by an ulp
        np.testing.assert_allclose(v, lj[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert sd_t.bsdfs.present == tuple(sd_j.bsdfs.present)
    assert sd_t.tris is None and sd_t.medium is None and sd_t.bvh is None


@pytest.mark.parametrize('kw', SCENES)
def test_pack_scene_bit_identical(kw):
    s_j, rx_j = g._build_scene(**kw)
    _, rx_t = flagship_scene(**kw)
    sd_j = s_j.compile()
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    ref = pr._pack_scene(sd_j, rx_j, si)
    sd_t = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    assert rk.supported(sd_t, rx_t) and pr.supported(sd_j, rx_j)
    got = rk.pack_scene(sd_t, rx_t, si)
    for name, a, b in (('params', got.params, ref[0]),
                       ('prim', got.prim, ref[1]), ('txp', got.txp, ref[2]),
                       ('php', got.php, ref[3]), ('rxph', got.rxph, ref[4])):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert rk.n_draws(3) == pr.n_draws(3) and rk.n_draws(2) == pr.n_draws(2)


def test_import_loads_no_jax():
    code = ('import sys, beifong_tpu_torch, beifong_tpu_torch.interop, '
            'beifong_tpu_torch.dsp.pulse, beifong_tpu_torch.geometry.bvh, '
            'beifong_tpu_torch.geometry.bvh_kernel, '
            'beifong_tpu_torch.geometry.mesh, '
            'beifong_tpu_torch.geometry.intersect_kernel, '
            'beifong_tpu_torch.integrators.radar_path, '
            'beifong_tpu_torch.core.rng; '
            'from beifong_tpu_torch.geometry.shapes import shapegroup, '
            'instance; '
            'from beifong_tpu_torch.bsdf.tables import normalmap, bumpmap; '
            'from beifong_tpu_torch.scenes import flagship_scene, '
            'target_range; '
            'from beifong_tpu_torch.integrators.receive_kernel import '
            'launched_prim_kernel; '
            'bad = [m for m in sys.modules if m == "jax" '
            'or m.startswith("jax.") or m == "beifong_tpu" '
            'or m.startswith("beifong_tpu.")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_receive_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is usable')
    s, rx = flagship_scene()
    sd = s.compile(device='cpu')
    with pytest.raises(RuntimeError, match='cuda'):
        receive(s, sd, rx, spp=64, max_depth=1)
    with pytest.raises(RuntimeError, match='cuda'):
        s.compile()
    with pytest.raises(RuntimeError, match='cuda'):
        film_new(rx.adc.n_time, rx.adc.n_freq, 1)


@pytest.mark.parametrize('change, needle', [
    (dict(n_freq=rk.MAX_N_FREQ + 1), 'n_freq'),
    (dict(n_time=rk.MAX_N_TIME + 1), 'n_time'),
])
def test_out_of_scope_scene_raises(change, needle):
    s, rx = flagship_scene()
    rx = dataclasses.replace(rx, adc=dataclasses.replace(rx.adc, **change))
    sd = s.compile(device='cpu')
    why = []
    assert not rk.supported(sd, rx, why) and needle in why[0]
    assert 'ROADMAP' in why[0]
    with pytest.raises(NotImplementedError, match=needle):
        receive(s, sd, rx, spp=64, max_depth=1, use_kernel=True,
                device='cpu')


def test_out_of_scope_receive_type_raises():
    # mix_resample, raw_resample and mixer with an LO are in the kernel's
    # scope; a mixer without an LO has no beat to sample
    s, rx = flagship_scene()
    rx = dataclasses.replace(rx, receive_type='mixer')
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why)
    assert 'without an LO' in why[0]


def test_adc_config_fields_match():
    from beifong_tpu.radar.endpoints import ADCConfig as JaxADC
    assert [f.name for f in dataclasses.fields(ADCConfig)] == \
        [f.name for f in dataclasses.fields(JaxADC)]
    assert ADCConfig() == ADCConfig(**dataclasses.asdict(JaxADC()))


def test_multi_body_compiles_like_jax_leaf_for_leaf():
    """`scenes.multi_body_scene` against the JAX package's
    examples/multi_body.py scene: every table, the rough conductor and the
    moving mesh's velocity included."""
    from test_torch_wavefront import multi_body
    s_j, _ = multi_body('jax')
    s_t, _ = multi_body('port')
    lj = jax_leaves(s_j.compile(use_bvh=False))
    sd_t = s_t.compile(use_bvh=False, device='cpu')
    lt = port_leaves(sd_t)
    assert {'.tris.v0', '.shapes.velocity', '.bsdfs.alpha', '.bsdfs.k'} \
        <= set(lt) <= set(lj)
    for k, v in lt.items():
        assert v.dtype == lj[k].dtype and v.shape == lj[k].shape, k
        # the look_at of the lifted body rounds differently in the two
        # packages: world vertices up to 6 m out differ by an ulp (4.8e-7),
        # and so do the edges between them; over a 0.13 m edge that tilts
        # a face normal by ~4e-6
        atol = {'.tris.n': 1e-5, '.tris.v0': 1e-6, '.tris.e1': 1e-6,
                '.tris.e2': 1e-6}.get(k, 1e-7)
        np.testing.assert_allclose(v, lj[k], rtol=1e-6, atol=atol,
                                   err_msg=k)
    assert sd_t.tris.n_faces == 324 and sd_t.bvh is None
    assert sd_t.bsdfs.present == tuple(s_j.compile().bsdfs.present)


BVH_FIELDS = ('bb_min', 'bb_max', 'hit_link', 'miss_link', 'leaf_offset',
              'leaf_count', 'v0', 'e1', 'e2', 'perm')


def test_bvh_scene_compiles_like_jax_leaf_for_leaf():
    """`compile(use_bvh=True)`: the tables leaf for leaf, and `.bvh` array
    for array against the JAX package's Python builder (its native C++
    builder, which the JAX compile takes when the library is built,
    orders the faces of a leaf by std::nth_element and is not ported:
    ROADMAP A7); `interop` carries the JAX BVH over as it is."""
    from beifong_tpu.geometry import bvh as bvh_j
    from test_torch_mesh import twin_scene
    s_j, _ = twin_scene('jax', n_side=23)
    s_t, _ = twin_scene('port', n_side=23)
    sd_j = s_j.compile(use_bvh=True)
    sd_t = s_t.compile(use_bvh=True, device='cpu')
    lj, lt = jax_leaves(sd_j), port_leaves(sd_t)
    assert set(lt) <= set(lj) and any(k.startswith('.bvh.') for k in lj)
    for k, v in lt.items():
        np.testing.assert_allclose(v, lj[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    ref = bvh_j.build(*(np.asarray(getattr(sd_j.tris, f))
                        for f in ('v0', 'e1', 'e2')), use_native=False)
    assert sd_t.bvh.n_nodes == ref.n_nodes
    for f in BVH_FIELDS:
        a, b = getattr(sd_t.bvh, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    sd_i = scene_data_from_numpy(lj, port_band(sd_j.band), device='cpu')
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(sd_i.bvh, f),
                                      np.asarray(getattr(sd_j.bvh, f)),
                                      err_msg=f)
    # 'auto' builds it above bvh_threshold faces only
    assert s_t.compile(device='cpu').bvh is not None
    assert s_t.compile(bvh_threshold=5000, device='cpu').bvh is None
