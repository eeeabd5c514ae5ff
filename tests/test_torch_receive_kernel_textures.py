"""The receive kernel's texture twins on the CPU: the flagship scene with a
checkerboard or bitmap ground, built by both packages from the same spec.
The pack (`prim`, the texel rows `tex`, `bmp_meta`, the sigma grid's row
params[52]) equals the JAX package's `_pack_scene` bit for bit; the plain
version matches `_run(interpret=True)` on identical uniforms in power
and in I / Q; the exact anchors (a uniform checkerboard is the untextured
scene, a constant bitmap the uniform checkerboard of its value); the
scope's reasons against the JAX package's `supported`, and the routing.
The CUDA twins are held to the plain version on a card by
tests/test_torch_gpu.py and chip_smoke.py."""

import dataclasses as dc

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from beifong_tpu import textures as tex_j
from beifong_tpu.bsdf import diffuse as diffuse_j
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch import media as mt
from beifong_tpu_torch import textures as tex_t
from beifong_tpu_torch.bsdf.tables import diffuse as diffuse_t
from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_mesh import twin_scene
from test_torch_prims import DOPPLER_CHANGES, doppler_change
from test_torch_receive_kernel_doppler import _jax_run

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell (I / Q add the phase slack)
IMG_SEED = bt.scenes.GROUND_BITMAP_SEED   # the port's ground bitmap


def textured_flagship(pkg: str, texture: str, img=None, velocity=None,
                      medium=False):
    """`scenes.flagship_scene(ground_texture=texture)` in either package
    (the JAX one from `__graft_entry__._build_scene` with the ground moved
    onto its own textured diffuse BSDF); 'uniform' is a checkerboard of
    1.0 / 1.0, 'uniform07' one of 0.7 / 0.7, 'constant' a bitmap of 0.7
    everywhere, 'plain07' an untextured ground of reflectance 0.7, `img` a
    bitmap's own image.  `velocity` moves the target, `medium` adds a sigma grid."""
    if pkg == 'port' and texture in ('checkerboard', 'bitmap') \
            and img is None:
        s, rx = bt.flagship_scene(ground_texture=texture)
    else:
        s, rx = (ge._build_scene() if pkg == 'jax' else bt.flagship_scene())
        tx, dif = (tex_j, diffuse_j) if pkg == 'jax' else (tex_t, diffuse_t)
        if texture == 'checkerboard':
            t = tx.checkerboard('gnd_tex', 0.8, 0.3, scale_uv=(40.0, 40.0))
        elif texture == 'uniform':
            t = tx.checkerboard('gnd_tex', 1.0, 1.0, scale_uv=(40.0, 40.0))
        elif texture == 'uniform07':
            t = tx.checkerboard('gnd_tex', 0.7, 0.7)
        elif texture == 'constant':
            t = tx.bitmap('gnd_tex', np.full((8, 8), 0.7, np.float32))
        elif texture == 'plain07':
            t = None
        else:
            t = tx.bitmap('gnd_tex', img if img is not None
                          else np.random.default_rng(IMG_SEED).uniform(
                              0.2, 1.0, (128, 128)).astype(np.float32))
        if t is None:
            s.add(dif('gnd', reflectance=0.7, twosided=True))
        else:
            s.add(t)
            s.add(dif('gnd', reflectance=1.0, twosided=True,
                      texture='gnd_tex'))
        s.shapes[-1].bsdf = 'gnd'
    if velocity is not None:
        s.shapes[-2].velocity = np.asarray(velocity, np.float32)
    if medium:
        cells = np.random.default_rng(4).uniform(
            0.0, 0.2, (4, 4, 16)).astype(np.float32)
        if pkg == 'jax':
            from beifong_tpu.media import HeterogeneousMedium
            s.medium = HeterogeneousMedium.make(cells, box_min=(-2, -7, -1),
                                                box_max=(2, 1, 2))
        else:
            s.medium = mt.HeterogeneousMedium.make(
                cells, box_min=(-2, -7, -1), box_max=(2, 1, 2))
    return s, rx


def test_flagship_scene_keeps_the_untextured_scene():
    """ground_texture=None compiles to the tables it did."""
    a = bt.flagship_scene()[0].compile(device='cpu')
    b = bt.flagship_scene(ground_texture=None)[0].compile(device='cpu')
    for f in ('to_world', 'bsdf_idx', 'kind'):
        assert torch.equal(getattr(a.shapes, f), getattr(b.shapes, f))
    assert torch.equal(a.bsdfs.texture_idx, b.bsdfs.texture_idx)
    assert int(a.textures.type.shape[0]) == 1


@pytest.mark.parametrize('texture, medium', [
    ('checkerboard', False), ('bitmap', False), ('bitmap', True),
    ('checkerboard', True)])
def test_pack_bit_identical_to_jax(texture, medium):
    """prim (the texture payload in columns 22-26), the texel rows, the
    bitmap rectangles' rows and, with a sigma grid, params[52] (its row
    after the bitmaps') equal `_pack_scene`'s."""
    s_j, rx_j = textured_flagship('jax', texture, medium=medium)
    s_t, rx_t = textured_flagship('port', texture, medium=medium)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    (params, prim, txp, _, _, _, _, tex, bmp_meta, _) = pr._pack_scene(
        s_j.compile(use_bvh=False), rx_j, si)
    got = rk.pack_scene(s_t.compile(device='cpu'), rx_t, si)
    for name, a, b in (('params', got.params, params),
                       ('prim', got.prim, prim), ('txp', got.txp, txp),
                       ('tex', got.tex, tex)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert tuple(map(tuple, got.bmp_meta.tolist())) == tuple(bmp_meta)
    assert got.textured and got.prim[:, 26].tolist().count(
        1.0 if texture == 'checkerboard' else 2.0) == 1
    if medium:
        # the 4 x 4 x 16 grid's 16 rows follow the bitmaps' (or 8 zeros)
        assert int(params[52]) == tex.shape[0] - 16 \
            == (8 if texture == 'checkerboard' else 128)


@pytest.mark.parametrize('texture', ['checkerboard', 'bitmap'])
@pytest.mark.parametrize('change', ['moving', 'mirror', 'ggx'])
def test_doppler_pack_bit_identical_to_jax(texture, change):
    """The textured flagship scene with a moving target, or a smooth or
    GGX rough conductor one, packs as the JAX package's `_pack_scene`
    does, bit for bit (prim, the texel rows, `bmp_meta`), and asks for the
    Doppler configuration."""
    s_j, rx_j = doppler_change('jax', *textured_flagship('jax', texture),
                               change)
    s_t, rx_t = doppler_change('port', *textured_flagship('port', texture),
                               change)
    si = s_j.shape_index_of_endpoint('receiver', rx_j.id)
    (params, prim, txp, _, _, _, _, tex, bmp_meta, _) = pr._pack_scene(
        s_j.compile(use_bvh=False), rx_j, si)
    got = rk.pack_scene(s_t.compile(device='cpu'), rx_t, si)
    for name, a, b in (('params', got.params, params),
                       ('prim', got.prim, prim), ('txp', got.txp, txp),
                       ('tex', got.tex, tex)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)
    assert tuple(map(tuple, got.bmp_meta.tolist())) == tuple(bmp_meta)
    assert got.textured and got.doppler(rx_t.adc)


@pytest.mark.parametrize('texture', ['checkerboard', 'bitmap'])
@pytest.mark.parametrize('change', DOPPLER_CHANGES)
def test_scope_takes_the_doppler_conditions(texture, change):
    """Under each Doppler condition (motion of the target, the
    transmitter or the receiver, a mirror, GGX, each LO rule, n_freq > 1,
    n_time > 512) the textured scene is in the JAX package's kernel's
    scope and in the port's (the Doppler power and coherent texture
    twins), and the port's pack asks for the Doppler configuration."""
    s_j, rx_j = doppler_change('jax', *textured_flagship('jax', texture),
                               change)
    s_t, rx_t = doppler_change('port', *textured_flagship('port', texture),
                               change)
    why_j, why_t = [], []
    assert pr.supported(s_j.compile(use_bvh=False), rx_j, why_j), why_j
    sd_t = s_t.compile(device='cpu')
    assert rk.supported(sd_t, rx_t, why_t), why_t
    si = s_t.shape_index_of_endpoint('receiver', rx_t.id)
    p = rk.pack_scene(sd_t, rx_t, si)
    assert p.textured and p.doppler(rx_t.adc)


@pytest.mark.parametrize('texture, coherent', [
    ('checkerboard', False), ('bitmap', False), ('checkerboard', True),
    ('bitmap', True)], ids=['checker-pow', 'bitmap-pow', 'checker-iq',
                            'bitmap-iq'])
def test_plain_version_matches_jax_megakernel(texture, coherent):
    """Identical uniforms, depth 2, 2,048 lanes.  Power: 1e-4 x max|acc|
    per cell; I / Q: plus the phase slack times the cell's sum of
    amplitudes (tests/test_torch_receive_kernel_coherent.py).  Events
    within 1e-3."""
    s, rx = textured_flagship('jax', texture)
    _, rx_t = textured_flagship('port', texture)
    out_j, cnt_j, u, tab = _jax_run(s, rx, 2048, 2, 5, 'gate', coherent)
    si = s.shape_index_of_endpoint('receiver', rx.id)
    (_, _, _, _, _, _, _, tex, bmp_meta, _) = pr._pack_scene(
        s.compile(use_bvh=False), rx, si)
    kw = dict(adc=tab['adc'], max_depth=2, time_sampling='gate',
              rx_kind=tab['rx_kind'], doppler=coherent, coherent=coherent,
              tex=torch.tensor(tex),
              bmp_meta=torch.tensor(np.asarray(bmp_meta, np.int32)))
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64)
    acc, n_ev = rk.receive_megakernel_ref(
        tab['params'], tab['prim'], tab['txp'], u,
        amp_out=amp if coherent else None, **kw)
    assert acc.shape == out_j.shape and cnt_j > 0
    scale = np.abs(out_j).max()
    assert scale > 0
    bound = TOL * scale
    if coherent:
        bound = bound + rk.phase_slack(s.band, rx.adc) \
            * amp.numpy()[..., None]
    else:
        out_j = out_j[:, 0]
        acc = acc[:, 0]
    err = np.abs(acc.numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the CPU wrapper is the plain version, fed the same uniforms
    acc_w, n_w = rk.receive_megakernel(
        tab['params'], tab['prim'], tab['txp'], n_lanes=2048, uniforms=u,
        **kw)
    assert torch.equal(acc_w.reshape(acc.shape), acc) \
        and int(n_w) == int(n_ev)


def _ref(texture, coherent, seed=7, n_lanes=1 << 13, img=None):
    s, rx = textured_flagship('port', texture, img=img) if texture \
        else bt.flagship_scene()
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    return rk.receive_megakernel(
        tab.params, tab.prim, tab.txp, adc=rx.adc, max_depth=3,
        time_sampling='gate', rx_kind='wigner', n_lanes=n_lanes, seed=seed,
        doppler=coherent, coherent=coherent, tex=tab.tex,
        bmp_meta=tab.bmp_meta)[0]


@pytest.mark.parametrize('coherent', [False, True], ids=['pow', 'iq'])
def test_anchors(coherent):
    """A uniform checkerboard (1.0 / 1.0) is the untextured scene bit for
    bit; a constant bitmap of 0.7, the uniform checkerboard of 0.7 and an
    untextured ground of reflectance 0.7 agree to 1e-5 (a twin that left
    the texture out would give the ground 1.0); the checkerboard and the
    bitmap move the grid by more than 100 x the parity bound (TOL x
    max|acc|) and keep the target's peak on bin 26."""
    base = _ref(None, coherent)
    assert torch.equal(_ref('uniform', coherent), base)
    const, unif07, plain07 = (_ref(t, coherent) for t in
                              ('constant', 'uniform07', 'plain07'))
    for a, b in ((const, unif07), (const, plain07), (unif07, plain07)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    for texture in ('checkerboard', 'bitmap'):
        got = _ref(texture, coherent)
        moved = float((got - base).abs().max())
        assert moved > 100 * TOL * float(base.abs().max()), texture
        power = got[:, 0] if not coherent else got[:, 0].square().sum(-1)
        assert int(power.argmax()) == 26, texture


def _two_rect_bitmaps(pkg, imgs, share):
    """The flagship scene with its ground split into two rectangles; each
    gets a bitmap of `imgs` (both the first with `share`)."""
    s, rx = ge._build_scene() if pkg == 'jax' else bt.flagship_scene()
    tx, dif = (tex_j, diffuse_j) if pkg == 'jax' else (tex_t, diffuse_t)
    for k, img in enumerate(imgs):
        s.add(tx.bitmap(f'b{k}', img))
        s.add(dif(f'g{k}', texture=f'b{0 if share else k}'))
    s.shapes[-1].bsdf = 'g0'
    gnd = s.shapes[-1]
    second = dc.replace(gnd, bsdf='g1')
    second.to_world = np.asarray(gnd.to_world, np.float32).copy()
    second.to_world[2, 3] -= 0.1
    s.add(second)
    return s, rx


@pytest.mark.parametrize('case, needle', [
    ('big', 'bitmap texture 129x128 > 16384'),
    ('rows', '520 packed bitmap rows > 512'),
    ('shared', None),
    ('mesh_tex', 'non-rectangle'),
])
def test_scope_follows_jax(case, needle):
    """The JAX kernel's texture rules: a bitmap's texels, the packed rows
    of the distinct bitmaps (a shared one counted once), rectangles
    only."""
    if case == 'mesh_tex':
        scenes = [twin_scene(pkg) for pkg in ('jax', 'port')]
        for (s, _), tx in zip(scenes, (tex_j, tex_t)):
            s.add(tx.checkerboard('chk', 0.8, 0.3))
            s.bsdfs[0].texture = 'chk'
    elif case == 'big':
        img = np.ones((129, 128), np.float32)
        scenes = [textured_flagship(pkg, 'bitmap', img=img)
                  for pkg in ('jax', 'port')]
    else:
        imgs = [np.ones((256, 64), np.float32),
                np.ones((264, 62), np.float32)]
        scenes = [_two_rect_bitmaps(pkg, imgs, case == 'shared')
                  for pkg in ('jax', 'port')]
    (s_j, rx_j), (s_t, rx_t) = scenes
    why_j, why_t = [], []
    ok_j = pr.supported(s_j.compile(use_bvh=False), rx_j, why_j)
    ok_t = rk.supported(s_t.compile(device='cpu'), rx_t, why_t)
    assert ok_j == ok_t == (needle is None), (why_j, why_t)
    if needle is not None:
        assert needle in why_j[0] and needle in why_t[0]


@pytest.mark.parametrize('change, needle', [
    pytest.param('moving', None, id='moving-Doppler configuration'),
    ('medium', 'ambient medium'),
    ('two_tx', 'endpoint twins'), ('plastic', 'lobe twins'),
    ('mesh', 'mesh scene')])
def test_scope_refuses_configurations_without_a_texture_twin(change,
                                                             needle):
    """Textures in a configuration this port has no texture twin of go to
    the wavefront with a reason naming ROADMAP B7; a moving target puts
    the scene in the Doppler configuration, whose power twin takes it
    (the kernel's plain version on the CPU)."""
    if change == 'mesh':
        s, rx = twin_scene('port')
        s.add(tex_t.checkerboard('chk', 0.8, 0.3))
        s.bsdfs[1].texture = 'chk'      # 'half': the clutter plates'
        from beifong_tpu_torch.core import transform as tf
        from beifong_tpu_torch.geometry import shapes as sh
        s.add(sh.rectangle(to_world=np.asarray(tf.compose(
            tf.translate([0.0, -6.0, 0.0]), tf.scale(0.3))), bsdf='half'))
    else:
        s, rx = textured_flagship(
            'port', 'checkerboard',
            velocity=(0.0, 2.0, 0.0) if change == 'moving' else None,
            medium=change == 'medium')
        if change == 'two_tx':
            from beifong_tpu_torch.radar import wigner_transmitter, pulse
            from beifong_tpu_torch.geometry import shapes as sh
            wf = pulse(f_centre=40e3, prf=10.0, pulse_len=2e-3, f_ext=2e3,
                       is_delta=True)
            s.add(wigner_transmitter('tx2', wf, resample_freq=True))
            s.add(sh.rectangle(to_world=np.asarray(
                s.shapes[0].to_world).copy(), transmitter='tx2'))
        elif change == 'plastic':
            s.bsdfs[1] = dc.replace(s.bsdfs[1], type=5)   # PLASTIC
    sd = s.compile(device='cpu')
    why = []
    if needle is None:
        assert rk.supported(sd, rx, why), why
        adc, n = bt.receive(s, sd, rx, spp=256, max_depth=1,
                            use_kernel=True, device='cpu')
        assert n == 256 and bool(torch.isfinite(adc).all())
        return
    assert not rk.supported(sd, rx, why)
    assert needle in why[0] and 'ROADMAP B7' in why[0], why
    with pytest.raises(NotImplementedError, match='ROADMAP B7'):
        bt.receive(s, sd, rx, spp=256, max_depth=1, use_kernel=True,
                   device='cpu')


def test_routing(monkeypatch):
    """`use_kernel='auto'` runs a textured flagship scene on the kernel
    (its plain version on the CPU), in power and in I / Q, and with a
    moving target too (the Doppler power twin); a textured CPI runs the
    per-pulse loop under 'scan' and raises under 'pallas'."""
    calls = []
    real = rk.receive_kernel
    monkeypatch.setattr(rk, 'receive_kernel',
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    s, rx = bt.flagship_scene(ground_texture='bitmap')
    for coh in (False, True):
        adc, n = bt.receive(s, receiver=rx, spp=1 << 12, max_depth=2,
                            coherent=coh, time_sampling='gate',
                            device='cpu')
        assert n == 1 << 12 and bool(adc[..., 0].abs().sum() > 0)
    assert len(calls) == 2
    sm, rxm = textured_flagship('port', 'checkerboard',
                                velocity=(0.0, 2.0, 0.0))
    bt.receive(sm, receiver=rxm, spp=1 << 10, max_depth=1, device='cpu')
    assert len(calls) == 3
    with pytest.raises(NotImplementedError, match='ROADMAP B7'):
        rk.pack_cpi(s, 2, 100.0)
    with pytest.raises(NotImplementedError, match='ROADMAP B7'):
        bt.receive_cpi(s, n_pulses=2, prf=100.0, spp=256, max_depth=1,
                       engine='pallas', device='cpu')
    cube, n = bt.receive_cpi(s, n_pulses=2, prf=100.0, spp=256,
                             max_depth=1, device='cpu')
    assert cube.shape[0] == 2 and len(calls) == 5
    # the wrapper refuses textured tables outside the texture twins
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
    with pytest.raises(ValueError, match='ROADMAP B7'):
        rk.receive_megakernel(tab.params, tab.prim, tab.txp, adc=rx.adc,
                              max_depth=1, time_sampling='gate',
                              rx_kind='wigner', n_lanes=256, doppler=True,
                              lobes=rk.LOBE_PLAS, tex=tab.tex,
                              bmp_meta=tab.bmp_meta)
    with pytest.raises(ValueError, match='texel rows'):
        rk.receive_megakernel(tab.params, tab.prim, tab.txp, adc=rx.adc,
                              max_depth=1, time_sampling='gate',
                              rx_kind='wigner', n_lanes=256)
