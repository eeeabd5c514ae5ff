"""The receive kernel's lobe twins on plastics, GGX glass and composites:
its plain PyTorch version against the JAX package's Pallas megakernel
(interpret mode) on identical uniforms, on the JAX package's plastic
kernel test scenes (a plastic and a rough-plastic plate), its
rough-dielectric ones (backscatter off a slab, and transmission through
a sheet between the transmitter and the receiver, power and I / Q) and
its blend and mask scenes (a mask at two opacities); and the scenes'
anchors on the CPU (the echo on its round-trip or one-way bin, a mask's
echo in proportion to its opacity).  The scenes, the pack and the
routing are in tests/test_torch_receive_kernel_lobes.py."""

import numpy as np
import pytest
import torch

import beifong_tpu_torch as bt
from beifong_tpu_torch import scenes

from test_torch_receive_kernel_lobes import lobe_scene, parity

torch.set_num_threads(1)


@pytest.mark.parametrize('kind', ['plastic', 'rough_plastic'])
def test_plastic_plates_match_jax_megakernel(kind):
    """Plastic and rough-plastic plates (the JAX package's
    test_megakernel_plastic scene): the coat / base pick by the lobe draw,
    the two-lobe NEE."""
    s, rx = lobe_scene('jax', kind)
    stats = parity(s, rx, 8192, 2)
    key = 'plas' if kind == 'plastic' else 'rplas'
    assert stats[key + '_nee'] > 0 and stats[key + '_bounce'] > 0


@pytest.mark.parametrize('case, coherent', [('target', False),
                                            ('through', True)])
def test_rough_dielectric_matches_jax_megakernel(case, coherent):
    """GGX glass: Walter's reflection and transmission lobes in NEE, the
    Fresnel pick of a reflection or a refraction through the sampled half
    vector in the bounce; 'through' connects only by transmission."""
    s, rx = lobe_scene('jax', case)
    stats = parity(s, rx, 8192, 2, coherent)
    assert stats['rdiel_nee'] > 0 and stats['rdiel_bounce'] > 0
    assert stats['nee_splat'] > 0


@pytest.mark.parametrize('name', ['blend', 'mask_0.8', 'mask_0.4'])
def test_composites_match_jax_megakernel(name):
    """Blend (diffuse 0.6 + GGX rough conductor 0.4) and mask: NEE
    evaluates w f0 + (1 - w) f1, the bounce picks a lobe by the lobe-mix
    draw, a mask's other lobe passes the ray on."""
    s, rx = lobe_scene('jax', name)
    stats = parity(s, rx, 8192, 2)
    assert stats['blend_nee'] > 0 and stats['blend_pick'] > 0
    if name == 'blend':
        assert stats['ggx_bounce'] > 0 and stats['bounce'] > 0
    else:
        assert stats['pass_bounce'] > 0


def _profile(s, rx, seed, spp=1 << 16, depth=2, coherent=False):
    a, n = bt.receive(s, s.compile(device='cpu'), rx, spp=spp,
                      max_depth=depth, seed=seed, time_sampling='gate',
                      coherent=coherent, device='cpu')
    p = bt.develop_signal(a, n, rx.adc)[:, 0]
    return ((p[:, 0] ** 2 + p[:, 1] ** 2) if coherent else p[:, 0]).numpy()


def test_lobe_scenes_meet_their_anchors_on_the_cpu():
    """receive() of each lobe scene (the lobe twins' plain version): the
    plastics and GGX glass peak on their round-trip bin (the one-way bin
    through the sheet), within the JAX tests' window of -1 / +3 bins; a
    mask's window energy at opacity 0.4 is 0.5 +- 30% of its energy at
    0.8; the thin window's echo keeps the corner's peak bin."""
    for name, case in (('plastic', 'target'), ('rough_plastic', 'target'),
                       ('target', 'target'), ('through', 'through')):
        s, rx = lobe_scene('port', name)
        p = _profile(s, rx, seed=1)
        want = scenes.lobe_bin(s, rx, case)
        pk = int(np.abs(p).argmax())
        assert round(want) - 1 <= pk <= round(want) + 3, (name, pk, want)
    e = {}
    for op in (0.8, 0.4):
        s, rx = scenes.composite_scene('mask', op)
        p = _profile(s, rx, seed=2)
        pk = int(p.argmax())
        e[op] = float(p[max(pk - 3, 0):pk + 4].sum())
    assert e[0.4] / e[0.8] == pytest.approx(0.5, rel=0.3)
    pk = []
    for window in (None, 'thin'):
        s, rx = scenes.window_corner_scene(window)
        pk.append(int(np.abs(_profile(s, rx, seed=3, depth=6)).argmax()))
    assert abs(pk[1] - pk[0]) <= 1
    assert 0.5 < scenes.thin_window_transmittance() < 1.0
