"""Spheres, disks and cylinders in the receive kernel's scope, shape groups
and instances, and normal and bump maps, against the JAX package on the
CPU: the packs bit for bit (each kind, and a sphere among more than
MAX_PRIMS analytic rows, which demotes rectangles as the JAX package
does), `supported` against the JAX package's with the reasons that name
ROADMAP B1 (rest) and C11, the routing, the range anchors and the floor
of each target in the plain version (and a prim test that takes a
sphere's or cylinder's record for a rectangle failing them), the
instanced tables leaf for leaf and their hits, and the shading-mapped
frames of `ray_intersect`."""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from beifong_tpu import scene as scene_j
from beifong_tpu import textures as tex_j
from beifong_tpu.bsdf import (bumpmap as bumpmap_j, diffuse as diffuse_j,
                              normalmap as normalmap_j)
from beifong_tpu.core import transform as tf_j
from beifong_tpu.geometry import shapes as sh_j
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import scene as scene_t
from beifong_tpu_torch import scenes
from beifong_tpu_torch import textures as tex_t
from beifong_tpu_torch.bsdf.tables import (bumpmap as bumpmap_t,
                                           diffuse as diffuse_t,
                                           normalmap as normalmap_t)
from beifong_tpu_torch.core import transform as tf_t
from beifong_tpu_torch.core.config import Band
from beifong_tpu_torch.geometry import shapes as sh_t
from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_interop import jax_leaves, port_leaves
from test_torch_wavefront import _pkg

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell
KINDS = ('sphere', 'disk', 'cylinder')


def target_shape(pkg: str, target: str, R: float = 4.0):
    """`scenes.flagship_scene`'s target shape in either package."""
    sh, tf = (sh_j, tf_j) if pkg == 'jax' else (sh_t, tf_t)
    if target == 'sphere':
        return sh.sphere(center=(0.0, -(R + 0.4), 0.0), radius=0.4,
                         bsdf='mat')
    if target == 'disk':
        return sh.disk(to_world=np.asarray(tf.compose(
            tf.look_at([0, -R, 0], [0, 0, 0]), tf.scale(0.5))), bsdf='mat')
    return sh.cylinder(to_world=np.asarray(tf.compose(
        tf.translate([0.0, -R, -0.6]), tf.scale([0.3, 0.3, 1.2]))),
        bsdf='mat')


def flagship(pkg: str, target: str, clutter: int = 0):
    """`scenes.flagship_scene(target=target)` in either package (the JAX
    one from `__graft_entry__._build_scene` with its plate replaced), with
    `clutter` plain 0.1 m plates behind it."""
    if pkg == 'jax':
        s, rx = ge._build_scene()
        s.shapes[2] = target_shape('jax', target)
        sh, tf = sh_j, tf_j
    else:
        s, rx = scenes.flagship_scene(target=target)
        sh, tf = sh_t, tf_t
    for k in range(clutter):
        s.add(sh.rectangle(to_world=np.asarray(tf.compose(
            tf.translate([0.3 * (k % 8) - 1.0, -8.0, 0.3 * (k // 8) - 1.0]),
            tf.scale(0.1))), bsdf='mat'))
    return s, rx


def test_flagship_scene_keeps_its_plate():
    """target='plate' (the default) compiles to the tables it did."""
    a = bt.flagship_scene()[0].compile(device='cpu')
    b = bt.flagship_scene(target='plate')[0].compile(device='cpu')
    for f in ('to_world', 'bsdf_idx', 'kind'):
        assert torch.equal(getattr(a.shapes, f), getattr(b.shapes, f))
    with pytest.raises(ValueError, match='target'):
        bt.flagship_scene(target='cone')


@pytest.mark.parametrize('target, clutter', [
    ('sphere', 0), ('disk', 0), ('cylinder', 0), ('sphere', 61)])
def test_pack_bit_identical_to_jax(target, clutter):
    """prim, params and txp equal `_pack_scene`'s bit for bit; with 61
    plates the sphere makes 65 analytic rows (64 rectangles), so both
    packages demote the plain rectangles into the BVH and count the same
    leaves."""
    _assert_pack_bit_identical(*flagship('jax', target, clutter),
                               *flagship('port', target, clutter), clutter)


@pytest.mark.parametrize('target', KINDS)
@pytest.mark.parametrize('change', ['moving', 'mirror', 'ggx'])
def test_doppler_pack_bit_identical_to_jax(target, change):
    """A moving target, and a smooth or GGX rough conductor one, of each
    kind pack as the JAX package's `_pack_scene` does, bit for bit (the
    velocity in columns 19-21, the conductor's lobe and constants), and
    the pack asks for the Doppler configuration."""
    s_j, rx_j = doppler_change('jax', *flagship('jax', target), change)
    s_t, rx_t = doppler_change('port', *flagship('port', target), change)
    got = _assert_pack_bit_identical(s_j, rx_j, s_t, rx_t, 0)
    assert got.doppler(rx_t.adc)
    assert got.moving == (change == 'moving')
    assert (got.mirror, got.ggx) == (change == 'mirror', change == 'ggx')


def _assert_pack_bit_identical(s_j, rx_j, s_t, rx_t, clutter):
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    sd_j, sd_t = s_j.compile(use_bvh=False), s_t.compile(device='cpu')
    ref = pr._pack_scene(sd_j, rx_j, si)
    got = rk.pack_scene(sd_t, rx_t, si)
    for name, a, b in (('params', got.params, ref[0]),
                       ('prim', got.prim, ref[1]), ('txp', got.txp, ref[2]),
                       ('msh', got.msh, ref[5])):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert rk._demoted_rects(sd_t) == pr._demoted_rects(sd_j)
    assert got.prims and not got.textured
    if clutter:
        assert len(rk._demoted_rects(sd_t)) == 62   # the ground and plates
        np.testing.assert_array_equal(got.mesh.leaves.numpy(),
                                      np.asarray(ref[9].leaves))
    else:
        assert got.mesh is None and ref[9] is None
    return got


# the Doppler conditions (`receive_kernel.needs_doppler`): each puts a
# scene into the Doppler configuration, whose power and coherent twins
# take the kinds and the textures as the JAX package's kernel does
DOPPLER_CHANGES = ('moving', 'tx_moving', 'rx_moving', 'mirror', 'ggx',
                   'mix_resample', 'mixer', 'raw_resample', 'n_freq',
                   'wide')


def doppler_change(pkg, s, rx, change, target=2):
    """The scene (s, rx) of either package under one of DOPPLER_CHANGES:
    its target (shape `target`) closing at 2 m/s, the transmitter or the
    receiver moving, the target a smooth or a GGX rough conductor, the
    receiver of an LO receive type (the transmitter's waveform its LO; a
    mixer's beat window 0-2 kHz), 8 frequency bins or 1,024 time bins.
    Returns (s, rx)."""
    p = _pkg(pkg)
    vel = np.asarray((0.0, 2.0, 0.0), np.float32)
    if change == 'moving':
        s.shapes[target].velocity = vel
    elif change == 'tx_moving':
        s.transmitters[0] = dc.replace(s.transmitters[0], velocity=-vel)
    elif change == 'rx_moving':
        rx = dc.replace(rx, velocity=vel)
    elif change in ('mirror', 'ggx'):
        metal = dict(eta=1.5, k=3.0, twosided=True)
        s.add(p.bsdf.conductor('metal', **metal) if change == 'mirror'
              else p.bsdf.rough_conductor('metal', alpha=0.3, **metal))
        s.shapes[target].bsdf = 'metal'
    elif change in ('mix_resample', 'mixer', 'raw_resample'):
        adc = dc.replace(rx.adc, freq_lo=0.0, freq_hi=2e3) \
            if change == 'mixer' else rx.adc
        rx = dc.replace(rx, receive_type=change, adc=adc,
                        lo_waveform=s.transmitters[0].waveform)
    elif change == 'n_freq':
        rx = dc.replace(rx, adc=dc.replace(rx.adc, n_freq=8))
    elif change == 'wide':
        rx = dc.replace(rx, adc=dc.replace(rx.adc, n_time=1024))
    else:
        raise ValueError(change)
    s.receivers[0] = rx
    return s, rx


def _changed(pkg, target, change):
    s, rx = flagship(pkg, target)
    sh, tf = (sh_j, tf_j) if pkg == 'jax' else (sh_t, tf_t)
    if change == 'plastic':
        s.bsdfs[0] = dc.replace(s.bsdfs[0], type=5)   # PLASTIC
    elif change == 'two_tx':
        mod = __import__('beifong_tpu.radar' if pkg == 'jax'
                         else 'beifong_tpu_torch.radar',
                         fromlist=['pulse', 'wigner_transmitter'])
        wf = mod.pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
        s.add(mod.wigner_transmitter('tx2', wf, resample_freq=True))
        s.add(sh.rectangle(to_world=np.asarray(s.shapes[0].to_world).copy(),
                           transmitter='tx2'))
    elif change == 'maps':
        s.add((tex_j if pkg == 'jax' else tex_t).constant(
            'nm', value=np.asarray([0.7, 0.5, 0.9], np.float32)))
        s.add((normalmap_j if pkg == 'jax' else normalmap_t)(
            'mapped', 'mat', 'nm'))
        s.shapes[-1].bsdf = 'mapped'
    elif change is not None:
        s, rx = doppler_change(pkg, s, rx, change)
    return s, rx


@pytest.mark.parametrize('target', KINDS)
@pytest.mark.parametrize('change, needle', [(None, None)] + [
    pytest.param(c, None, id=f'{c}-Doppler configuration')
    for c in DOPPLER_CHANGES] + [
    ('plastic', 'lobe twins'), ('two_tx', 'endpoint twins'),
    ('maps', 'ROADMAP C11')])
def test_scope_against_jax(target, change, needle):
    """The JAX package's kernel takes every case; the port's takes the
    static flagship scene of each kind and the scene under each Doppler
    condition (the Doppler power and coherent configurations' prims
    twins), and refuses the kind in the lobe and endpoint configurations
    naming ROADMAP B1 (rest), and a shading-mapped scene naming C11, which
    the JAX kernel would run without the maps."""
    s_j, rx_j = _changed('jax', target, change)
    s_t, rx_t = _changed('port', target, change)
    why_j, why_t = [], []
    assert pr.supported(s_j.compile(use_bvh=False), rx_j, why_j), why_j
    sd_t = s_t.compile(device='cpu')
    ok = rk.supported(sd_t, rx_t, why_t)
    assert ok == (needle is None), why_t
    if change in DOPPLER_CHANGES:
        si = s_t.shape_index_of_endpoint('receiver', rx_t.id)
        assert rk.pack_scene(sd_t, rx_t, si).doppler(rx_t.adc)
    if needle is not None:
        assert needle in why_t[0], why_t
        if change != 'maps':
            assert 'ROADMAP B1 (rest)' in why_t[0]
            assert 'spheres, disks or cylinders' in why_t[0]
        with pytest.raises(NotImplementedError, match=needle):
            bt.receive(s_t, sd_t, rx_t, spp=256, max_depth=1,
                       use_kernel=True, device='cpu')


def test_scope_refuses_media_meshes_and_mimo():
    """A sphere through an ambient medium, beside a mesh, or in MIMO
    receive names ROADMAP B1 (rest)."""
    s, rx = flagship('port', 'sphere')
    s.medium = bt.scenes.stratified_homogeneous()
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why)
    assert 'ambient medium' in why[0] and 'B1 (rest)' in why[0]
    s, rx = bt.mesh_scene(n_side=5)
    s.add(target_shape('port', 'sphere', 6.0))
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why)
    assert 'mesh scene' in why[0] and 'B1 (rest)' in why[0]
    s, rx = bt.mimo_beamform_scene()
    s.add(sh_t.sphere(center=(0.0, -6.0, 0.0), radius=0.3,
                      bsdf=s.bsdfs[0].id))
    why = []
    assert not rk.supported(s.compile(device='cpu'), rx, why, mimo=True)
    assert 'MIMO' in why[0] and 'B1 (rest)' in why[0]


def test_routing(monkeypatch):
    """`use_kernel='auto'` runs each target on the kernel (its plain
    version on the CPU), in power and in I / Q, and a moving sphere too
    (the Doppler power twin); a static sphere's coherent CPI takes the
    kernel's CPI (one call), and so do a moving one's power and coherent
    CPIs; the wrapper refuses the prims outside their twins."""
    calls = []
    real = rk.receive_kernel
    monkeypatch.setattr(rk, 'receive_kernel',
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    for target in KINDS:
        s, rx = bt.flagship_scene(target=target)
        for coh in (False, True):
            adc, n = bt.receive(s, receiver=rx, spp=1 << 10, max_depth=2,
                                coherent=coh, time_sampling='gate',
                                device='cpu')
            assert n == 1 << 10 and bool(adc[..., 0].abs().sum() > 0)
    assert len(calls) == 6
    sm, rxm = _changed('port', 'sphere', 'moving')
    bt.receive(sm, receiver=rxm, spp=1 << 10, max_depth=1, device='cpu')
    assert len(calls) == 7
    cpi = []
    k = rk.receive_megakernel_cpi
    monkeypatch.setattr(rk, 'receive_megakernel_cpi',
                        lambda *a, **kw: cpi.append(1) or k(*a, **kw))
    s, rx = bt.flagship_scene(target='sphere')
    cube, n = bt.receive_cpi(s, n_pulses=2, prf=100.0, spp=256,
                             max_depth=1, engine='pallas', device='cpu')
    assert cube.shape[0] == 2 and cpi == [1]
    for coh in (False, True):
        cube, n = bt.receive_cpi(sm, n_pulses=2, prf=100.0, spp=256,
                                 max_depth=1, coherent=coh, engine='pallas',
                                 device='cpu')
        assert cube.shape[0] == 2 and bool(torch.isfinite(cube).all())
    assert cpi == [1, 1, 1]
    # an untextured scene's tables carry no texel buffer: its prims twin
    # is the one without the texture codes
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    assert tab.prims and not tab.textured and tab.tex is None
    with pytest.raises(ValueError, match='ROADMAP B1'):
        rk.receive_megakernel(tab.params, tab.prim, tab.txp, adc=rx.adc,
                              max_depth=1, time_sampling='gate',
                              rx_kind='wigner', n_lanes=256, doppler=True,
                              lobes=rk.LOBE_PLAS)
    assert rk.config_name(False, False, prims=True) == 'flagship_prims'
    assert rk.config_name(False, True, True, tex=True, prims=True) \
        == 'coherent_tex_prims'
    assert rk.config_name(False, True, tex=True, prims=True) \
        == 'doppler_tex_prims'
    assert {'coherent_prims', 'flagship_tex_prims', 'doppler_prims',
            'doppler_tex', 'doppler_tex_prims'} <= set(rk.CONFIGS)


def _grid(s, rx, prim=None, seed=7, n_lanes=1 << 14):
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    return rk.receive_megakernel(
        tab.params, tab.prim if prim is None else prim, tab.txp, adc=rx.adc,
        max_depth=3, time_sampling='gate', rx_kind='wigner', n_lanes=n_lanes,
        seed=seed)[0][:, 0]


def _anchor(s, rx, target):
    return int(round(scenes.round_trip_bin(
        s, rx, (0.0, -scenes.target_range(target), 0.0))))


def _floor(grid, base):
    return float((grid - base).abs().max()) / (TOL * float(base.abs().max()))


@pytest.mark.parametrize('target', KINDS)
def test_anchor_and_floor(target):
    """The plain version's range profile peaks within bins [b - 1, b + 3]
    of the round trip b to the target's near surface, and the target moves
    the grid by more than 100 x the parity bound against the scene without
    it."""
    s, rx = bt.flagship_scene(target=target)
    got = _grid(s, rx)
    b = _anchor(s, rx, target)
    assert b - 1 <= int(got.argmax()) <= b + 3, (int(got.argmax()), b)
    s0, _ = bt.flagship_scene(target=target)
    del s0.shapes[2]
    assert _floor(got, _grid(s0, rx)) > 100


@pytest.mark.parametrize('target', ['sphere', 'cylinder'])
def test_rectangle_test_of_a_curved_record_fails(target):
    """A prim test that takes the sphere's or cylinder's record for a
    rectangle (column 0 set to RECTANGLE: the unit square of its object
    frame) fails the anchor or the floor.  The sphere's square is a
    horizontal 0.8 m square through its centre: the grid still moves
    (~5e3 x the parity bound) but its peak leaves the anchor, so the
    anchor catches it; the cylinder's square lies at its foot, under the
    ground, so the grid is the scene without a target and both catch it
    (the floor at 0)."""
    s, rx = bt.flagship_scene(target=target)
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    wrong = tab.prim.clone()
    wrong[2, 0] = float(rk.RECTANGLE)
    got = _grid(s, rx, prim=wrong)
    b = _anchor(s, rx, target)
    s0, _ = bt.flagship_scene(target=target)
    del s0.shapes[2]
    anchor_ok = b - 1 <= int(got.argmax()) <= b + 3
    floor_ok = _floor(got, _grid(s0, rx)) > 100
    assert not (anchor_ok and floor_ok), (int(got.argmax()), b)


def _group_scene(pkg):
    if pkg == 'jax':
        s = scene_j.Scene(band=ge._build_scene()[0].band)
        sh, tf, dif = sh_j, tf_j, diffuse_j
    else:
        s = scene_t.Scene(band=Band.from_freq(340.0, 40e3, 10e3))
        sh, tf, dif = sh_t, tf_t, diffuse_t
    s.add(dif('d', reflectance=0.5))
    s.add(sh.shapegroup('twin', [
        sh.sphere(to_world=np.asarray(tf.translate([0, 0, 0])), bsdf='d'),
        sh.disk(to_world=np.asarray(tf.compose(tf.translate([0, 0, 2]),
                                               tf.scale(0.5))), bsdf='d')]))
    s.add(sh.instance('twin', to_world=np.asarray(tf.translate([-3, 0, 0]))))
    s.add(sh.instance('twin', to_world=np.asarray(tf.compose(
        tf.translate([3, 0, 0]), tf.rotate([0, 0, 1], 30.0)))))
    return s


def test_instances_compile_as_jax():
    """Two instances of a group of a sphere and a disk: four shape rows,
    every shape leaf equal to the JAX package's (to_world bit for bit, the
    inverse to 1e-6); rays hit the two spheres at their translated
    positions and miss between them, as in the JAX package."""
    sd_j = _group_scene('jax').compile()
    sd_t = _group_scene('port').compile(device='cpu')
    lj = jax_leaves(sd_j)
    lt = {k: v for k, v in port_leaves(sd_t).items()
          if k.startswith('.shapes.')}
    assert sd_t.shapes.n == 4 and '.shapes.to_world' in lt
    for k, v in lt.items():
        assert v.dtype == lj[k].dtype and v.shape == lj[k].shape, k
        if k == '.shapes.to_object':
            np.testing.assert_allclose(v, lj[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, lj[k], err_msg=k)
    o = np.array([[-3.0, -5, 0], [3.0, -5, 0], [0.0, -5, 0]], np.float32)
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (3, 1))
    si_j = sd_j.ray_intersect(jnp.asarray(o), jnp.asarray(d))
    si_t = sd_t.ray_intersect(torch.tensor(o), torch.tensor(d))
    assert si_t.valid.tolist() == [True, True, False] \
        == np.asarray(si_j.valid).tolist()
    np.testing.assert_allclose(si_t.t[:2].numpy(), np.asarray(si_j.t)[:2],
                               rtol=1e-6)
    np.testing.assert_allclose(si_t.t[:2].numpy(), 4.0, rtol=1e-5)


def _mapped_scene(pkg, which):
    """A 10 m diffuse square in z = 0 under a normal map (a constant tilt)
    or a bump map (a checkerboard of heights 0.2 / 0.8, scale 0.5)."""
    if pkg == 'jax':
        s = scene_j.Scene(band=ge._build_scene()[0].band)
        sh, tf, dif, tx = sh_j, tf_j, diffuse_j, tex_j
        nmap, bmap = normalmap_j, bumpmap_j
    else:
        s = scene_t.Scene(band=Band.from_freq(340.0, 40e3, 10e3))
        sh, tf, dif, tx = sh_t, tf_t, diffuse_t, tex_t
        nmap, bmap = normalmap_t, bumpmap_t
    s.add(dif('base', reflectance=0.6))
    if which == 'normal':
        s.add(tx.constant('t', value=np.asarray([0.7, 0.5, 0.9],
                                                np.float32)))
        s.add(nmap('m', 'base', 't'))
    else:
        s.add(tx.checkerboard('t', 0.2, 0.8, scale_uv=(7.0, 7.0)))
        s.add(bmap('m', 'base', 't', scale=0.5))
    s.add(sh.rectangle(to_world=np.asarray(tf.scale(10.0)), bsdf='m'))
    s.add(sh.sphere(center=(0.0, 0.0, 3.0), radius=0.5, bsdf='base'))
    return s


@pytest.mark.parametrize('which', ['normal', 'bump'])
def test_shading_maps_match_jax(which):
    """`ray_intersect` on the mapped square (and on an unmapped sphere):
    the perturbed shading frames and `wi` equal the JAX package's to
    1e-6; the map moves the square's frames and leaves the sphere's."""
    sd_j = _mapped_scene('jax', which).compile()
    sd_t = _mapped_scene('port', which).compile(device='cpu')
    assert sd_j.has_shading_maps and sd_t.has_shading_maps
    for f in ('normalmap_idx', 'bumpmap_idx', 'alpha', 'type', 'nested0',
              'nested1', 'weight'):
        np.testing.assert_array_equal(getattr(sd_t.bsdfs, f).numpy(),
                                      np.asarray(getattr(sd_j.bsdfs, f)))
    rng = np.random.default_rng(11)
    n = 256
    o = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                  np.full(n, 6.0)], -1).astype(np.float32)
    tgt = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                    np.zeros(n)], -1).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    si_j = sd_j.ray_intersect(jnp.asarray(o), jnp.asarray(d))
    si_t = sd_t.ray_intersect(torch.tensor(o), torch.tensor(d))
    np.testing.assert_array_equal(si_t.shape_idx.numpy(),
                                  np.asarray(si_j.shape_idx))
    for f in ('sh_frame', 'wi'):
        np.testing.assert_allclose(getattr(si_t, f).numpy(),
                                   np.asarray(getattr(si_j, f)), atol=1e-6,
                                   err_msg=f)
    sq = si_t.shape_idx == 0
    assert int(sq.sum()) > 100 and int((~sq & si_t.valid).sum()) > 0
    flat = dc.replace(sd_t, has_shading_maps=False).ray_intersect(
        torch.tensor(o), torch.tensor(d))
    moved = (si_t.sh_frame - flat.sh_frame).abs().amax((1, 2))
    assert bool((moved[sq] > 1e-3).any())
    assert torch.equal(si_t.sh_frame[~sq], flat.sh_frame[~sq])


def test_shading_maps_are_c11():
    """ROADMAP C11: on a normal-mapped flagship scene the JAX package's
    `supported` says True (its kernel would drop the map); the port's
    says False naming C11, and `receive` runs the wavefront, which applies
    the map; the interop carries the map columns and the flag."""
    from beifong_tpu_torch.interop import scene_data_from_numpy
    from test_torch_interop import port_band
    s_j, rx_j = _changed('jax', 'sphere', 'maps')
    s_t, rx_t = _changed('port', 'sphere', 'maps')
    sd_j = s_j.compile(use_bvh=False)
    assert sd_j.has_shading_maps and pr.supported(sd_j, rx_j)
    sd_t = s_t.compile(device='cpu')
    why = []
    assert not rk.supported(sd_t, rx_t, why) and 'C11' in why[0]
    sd_x = scene_data_from_numpy(jax_leaves(sd_j), port_band(sd_j.band),
                                 device='cpu')
    assert sd_x.has_shading_maps
    assert torch.equal(sd_x.bsdfs.normalmap_idx, sd_t.bsdfs.normalmap_idx)
    adc, n = bt.receive(s_t, sd_t, rx_t, spp=1 << 10, max_depth=1,
                        time_sampling='gate', device='cpu')
    assert n == 1 << 10 and bool(torch.isfinite(adc).all())
