"""Triangle-mesh scenes in the PyTorch port against the JAX package:
`MeshSpec` / `make_grid`, `compile()` with the triangle table, `interop`
carrying `.tris` over, the mesh part of the packed kernel tables (bit for
bit, rectangle demotion included) and the scope of the receive kernel."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from beifong_tpu.geometry import mesh as mesh_j
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import Band, receive
from beifong_tpu_torch.geometry import mesh as mesh_t
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.interop import scene_data_from_numpy

torch.set_num_threads(1)


def twin_scene(pkg: str, R=4.0, n_side=9, clutter=0, second_mesh=False,
               mesh_bsdf='mat', mesh_velocity=None):
    """The mesh benchmark scene (`benchmarks/mesh_megakernel.py::build`)
    built with the JAX package (`pkg='jax'`) or the port, plus optional
    clutter plates (more than 64 rectangles: the kernel demotes the plain
    ones into the BVH) and a second mesh with another reflectance.
    Returns (scene, receiver spec)."""
    if pkg == 'jax':
        from beifong_tpu import scene as sc
        from beifong_tpu.bsdf import (conductor, dielectric, diffuse, mask,
                                      rough_plastic)
        from beifong_tpu.core import transform as tf
        from beifong_tpu.core.config import Band as B
        from beifong_tpu.geometry import shapes as sh
        from beifong_tpu.geometry.mesh import MeshSpec, make_grid
        from beifong_tpu.radar import (ADCConfig, pulse, wigner_receiver,
                                       wigner_transmitter)
    else:
        from beifong_tpu_torch import scene as sc
        from beifong_tpu_torch.bsdf.tables import (conductor, dielectric,
                                                   diffuse, mask,
                                                   rough_plastic)
        from beifong_tpu_torch.core import transform as tf
        from beifong_tpu_torch.core.config import Band as B
        from beifong_tpu_torch.geometry import shapes as sh
        from beifong_tpu_torch.geometry.mesh import MeshSpec, make_grid
        from beifong_tpu_torch.radar import (ADCConfig, pulse,
                                             wigner_receiver,
                                             wigner_transmitter)
    s = sc.Scene(band=B.from_freq(340.0, 40e3, 10e3))
    s.add(diffuse('mat', reflectance=1.0, twosided=True))
    s.add(diffuse('half', reflectance=0.5, twosided=True))
    if mesh_bsdf == 'metal':
        s.add(conductor('metal'))
    elif mesh_bsdf == 'glass':
        s.add(dielectric('glass'))
    elif mesh_bsdf == 'masked':
        s.add(mask('masked', 'mat', opacity=0.5))
    elif mesh_bsdf == 'rough_plastic':
        # the rough plastic of the JAX package's plastic kernel test
        s.add(rough_plastic('rough_plastic', diffuse_reflectance=0.8,
                            alpha=0.4, int_ior=1.49, twosided=True))
    wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
               is_delta=True)
    s.add(wigner_transmitter('tx', wf, resample_freq=True))
    aim = np.asarray(tf.compose(tf.look_at([0.3, 0, 0], [0.3, -1, 0]),
                                tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim, transmitter='tx'))
    adc = ADCConfig(n_time=64, n_freq=1, sampling_start=0.0,
                    sampling_time=0.06, freq_lo=35e3, freq_hi=45e3)
    rx = wigner_receiver('rx', adc, receive_type='raw')
    s.add(rx)
    aim_rx = np.asarray(tf.compose(tf.look_at([-0.3, 0, 0], [-0.3, -1, 0]),
                                   tf.scale([0.05, 0.05, 1.0])))
    s.add(sh.rectangle(to_world=aim_rx, receiver='rx'))
    v, f = make_grid(n_side, n_side)
    v = np.asarray(v, np.float32)
    v[:, 2] = 0.05 * np.sin(6 * v[:, 0]) * np.cos(5 * v[:, 1])
    m = np.asarray(tf.compose(tf.look_at([0, -R, 0], [0, 0, 0]),
                              tf.scale(0.6)))
    kw = {} if mesh_velocity is None else dict(
        velocity=np.asarray(mesh_velocity, np.float32))
    s.add(MeshSpec(v, np.asarray(f), bsdf=mesh_bsdf, to_world=m, **kw))
    if second_mesh:
        m2 = np.asarray(tf.compose(tf.look_at([1.5, -R - 1.0, 0.5],
                                              [0, 0, 0]), tf.scale(0.3)))
        s.add(MeshSpec(v, np.asarray(f), bsdf='half', to_world=m2))
    for k in range(clutter):
        x = -2.0 + 0.06 * k
        c = np.asarray(tf.compose(tf.look_at([x, -7.0, 1.0], [x, 0, 1.0]),
                                  tf.scale(0.025)))
        s.add(sh.rectangle(to_world=c, bsdf='half' if k % 2 else 'mat'))
    return s, rx


def jax_leaves(sd):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(sd)[0]}


def port_leaves(obj, prefix=''):
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


@pytest.mark.parametrize('nx, ny', [(1, 1), (9, 9), (4, 7)])
def test_make_grid_and_mesh_spec_match_jax(nx, ny):
    vj, fj = mesh_j.make_grid(nx, ny)
    vt, ft = mesh_t.make_grid(nx, ny)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert vt.dtype == vj.dtype and ft.dtype == fj.dtype
    m = np.asarray([[0.6, 0, 0, 1.0], [0, 0, -0.6, -4.0], [0, 0.6, 0, 0.5],
                    [0, 0, 0, 1]], np.float32)
    sj = mesh_j.MeshSpec(vj, fj, to_world=m, bsdf='mat')
    st = mesh_t.MeshSpec(vt, ft, to_world=m, bsdf='mat')
    assert st.kind == sj.kind == 4
    np.testing.assert_array_equal(st.world_vertices(), sj.world_vertices())
    assert st.surface_area_world() == sj.surface_area_world()


@pytest.mark.parametrize('kw', [dict(), dict(second_mesh=True),
                                dict(clutter=70)],
                         ids=['one-mesh', 'two-meshes', 'clutter'])
def test_compile_with_meshes_matches_jax_leaf_for_leaf(kw):
    s_j, _ = twin_scene('jax', **kw)
    s_t, _ = twin_scene('port', **kw)
    lj = jax_leaves(s_j.compile(use_bvh=False))
    sd_t = s_t.compile(device='cpu')
    lt = port_leaves(sd_t)
    assert {'.tris.v0', '.tris.e1', '.tris.e2', '.tris.n',
            '.tris.shape_idx'} <= set(lt) <= set(lj)
    for k, v in lt.items():
        assert v.dtype == lj[k].dtype and v.shape == lj[k].shape, k
        np.testing.assert_allclose(v, lj[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert sd_t.tris.n_faces == lj['.tris.v0'].shape[0]
    assert sd_t.bvh is None


@pytest.mark.parametrize('kw', [dict(), dict(second_mesh=True),
                                dict(clutter=70)],
                         ids=['one-mesh', 'two-meshes', 'clutter'])
def test_pack_with_meshes_bit_identical_to_jax(kw):
    """`interop` carries `.tris` over; the packed tables of the mesh
    configuration (BVH, reflectance and shape-row payloads, mesh-shape
    rows, demoted rectangles) equal the JAX package's bit for bit."""
    s_j, rx_j = twin_scene('jax', **kw)
    s_t, rx_t = twin_scene('port', **kw)
    sd_j = s_j.compile(use_bvh=False)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    assert si == s_t.shape_index_of_endpoint('receiver', rx_t.id)
    (params, prim, txp, php, rxph, msh, mesh_types, _, _,
     mesh_pack) = pr._pack_scene(sd_j, rx_j, si)
    sd_i = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    for f in ('v0', 'e1', 'e2', 'n', 'shape_idx'):
        np.testing.assert_array_equal(getattr(sd_i.tris, f).numpy(),
                                      np.asarray(getattr(sd_j.tris, f)))
    assert pr.supported(sd_j, rx_j)
    for sd in (sd_i, s_t.compile(device='cpu')):
        assert rk.supported(sd, rx_t)
        got = rk.pack_scene(sd, rx_t, si)
        for name, a, b in (('params', got.params, params),
                           ('prim', got.prim, prim), ('txp', got.txp, txp),
                           ('php', got.php, php), ('rxph', got.rxph, rxph),
                           ('msh', got.msh, msh),
                           ('bbox', got.mesh.bbox.numpy(), mesh_pack.bbox),
                           ('links', got.mesh.links.numpy(),
                            mesh_pack.links),
                           ('leaves', got.mesh.leaves.numpy(),
                            mesh_pack.leaves)):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32), err_msg=name)
        assert (got.mesh.n_nodes, got.mesh.n_leaves, got.mesh.stride) == \
            (mesh_pack.n_nodes, mesh_pack.n_leaves, mesh_pack.stride) \
            and got.mesh.stride == rk.MESH_STRIDE
        assert mesh_types == tuple(int(r[6]) for r in got.msh)


def test_interop_carries_bvh_and_medium():
    """`.bvh` is carried over (the eager wavefront walks it), and so is an
    ambient medium: `SceneData.medium` is the port's medium of the JAX
    medium's kind, with its values."""
    from beifong_tpu.media import HomogeneousMedium
    from beifong_tpu_torch import media as mt
    s_j, _ = twin_scene('jax')
    sd_j = s_j.compile(use_bvh=True)
    leaves = jax_leaves(sd_j)
    assert any(k.startswith('.bvh') for k in leaves)
    sd = scene_data_from_numpy(leaves, port_band(sd_j.band), device='cpu')
    assert sd.bvh.n_nodes == int(np.asarray(sd_j.bvh.bb_min).shape[0])
    assert sd.medium is None
    s_j.medium = HomogeneousMedium.make(sigma_t=0.01)
    sd_j = s_j.compile(use_bvh=False)
    sd = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                               device='cpu')
    assert isinstance(sd.medium, mt.HomogeneousMedium)
    assert sd.medium.kind == mt.HOMOGENEOUS
    assert sd.medium.sigma_t.dtype == torch.float32
    assert float(sd.medium.sigma_t) == float(np.float32(0.01))


@pytest.mark.parametrize('kw, needle', [
    (dict(texture_idx=0), 'ROADMAP B7'),
])
def test_out_of_scope_mesh_raises(kw, needle):
    """A textured BSDF on the mesh stays outside the kernel; a moving mesh
    is inside (the Doppler configuration)."""
    s, rx = twin_scene('port', mesh_velocity=(0.0, 1.0, 0.0))
    sd = s.compile(device='cpu')
    assert rk.supported(sd, rx)
    b = sd.bsdfs
    sd = dataclasses.replace(sd, bsdfs=dataclasses.replace(
        b, texture_idx=torch.full_like(b.texture_idx, kw['texture_idx'])))
    why = []
    assert not rk.supported(sd, rx, why) and needle in why[0]
    with pytest.raises(NotImplementedError, match=needle):
        receive(s, sd, rx, spp=1024, max_depth=1, use_kernel=True,
                device='cpu')


def test_non_diffuse_mesh_is_out_of_scope():
    """A smooth dielectric on the mesh (the lobe twins) and a smooth
    conductor (the mirror chains), carried over by `interop` or built by
    the port, are inside the port kernel's scope, as inside the JAX
    package's kernel; a mask on the mesh is outside both (composites ride
    rectangles only)."""
    for bsdf, inside in (('glass', True), ('metal', True),
                         ('masked', False)):
        s_j, rx_j = twin_scene('jax', mesh_bsdf=bsdf)
        s_t, rx_t = twin_scene('port', mesh_bsdf=bsdf)
        sd_j = s_j.compile(use_bvh=False)
        sd = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                   device='cpu')
        why = []
        assert pr.supported(sd_j, rx_j) == inside
        assert rk.supported(sd, rx_t, why) == inside
        assert rk.supported(s_t.compile(device='cpu'), rx_t) == inside
        if not inside:
            assert 'triangle-mesh' in why[0]


@pytest.mark.parametrize('spp, n', [(500, 1024), (3000, 2048), (4096, 4096)])
def test_mesh_receive_rounds_to_whole_tiles(spp, n):
    s, rx = bt.mesh_scene(n_side=3)
    a, n_got = receive(s, s.compile(device='cpu'), rx, spp=spp, seed=1,
                       max_depth=1, time_sampling='gate', device='cpu')
    assert n_got == n and a.shape == (64, 1, 3)
    assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize('n_tiles', [1, 4, 255, 256, 512, 768, 1024, 2048,
                                     3072, 16384])
def test_strata_rule_matches_jax(n_tiles):
    jax_p = next((pp for pp in (32, 16) if n_tiles % (pp * pp) == 0),
                 pr.PATCH_P)
    stratified = n_tiles % (jax_p * jax_p) == 0
    assert rk.patch_p_for(n_tiles * rk.TILE) == (jax_p if stratified else 0)
    assert rk.TILE == pr.MESH_SUB * pr.MESH_STREAMS * pr.LANE
