"""The receive kernel's checkerboard and bitmap rectangles in its Doppler
configurations on the CPU: the plain version against the JAX package's
`_run(interpret=True)` on identical uniforms, in power on the
range-Doppler pulse (its plate closing over `flagship_scene`'s
checkerboard ground, the port's `scenes.range_doppler_scene(
ground_texture=...)`) and in I / Q on the flagship scene over the bitmap
ground under an LO receive type (raw_resample with the transmitter's
waveform for its LO), each built by both packages from one spec, its
tables bit for bit.  The CUDA twins (`receive_doppler_power_kernel<
true>`, `receive_coherent_kernel<true>`) are held to the plain version in
the g++ emulation by tests/test_torch_doppler_prims_emulate.py and on a
card by tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_prims import doppler_change
from test_torch_receive_kernel_doppler import _jax_run, range_doppler
from test_torch_receive_kernel_textures import textured_flagship
from test_torch_wavefront import _pkg

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell (I / Q add the phase slack)


def closing_plate_over(pkg: str, texture: str):
    """Pulse 0 of the range-Doppler example over `flagship_scene`'s 40 m
    ground 0.5 m below the apertures, textured (a checkerboard of 1 m
    cells, 0.8 / 0.3, or the seeded 128 x 128 bitmap) on a diffuse BSDF of
    its own, static."""
    if pkg == 'port':
        return bt.range_doppler_scene(0, ground_texture=texture)
    p = _pkg(pkg)
    from beifong_tpu import textures as tex_j
    s, rx = range_doppler(pkg)
    if texture == 'checkerboard':
        s.add(tex_j.checkerboard('gnd_tex', 0.8, 0.3,
                                 scale_uv=(40.0, 40.0)))
    else:
        s.add(tex_j.bitmap('gnd_tex', np.random.default_rng(
            bt.scenes.GROUND_BITMAP_SEED).uniform(0.2, 1.0, (128, 128))
            .astype(np.float32)))
    s.add(p.bsdf.diffuse('gnd', reflectance=1.0, twosided=True,
                         texture='gnd_tex'))
    s.add(p.sh.rectangle(to_world=np.asarray(p.tf.compose(
        p.tf.translate([0, 0, -0.5]), p.tf.scale(20.0))), bsdf='gnd'))
    return s, rx


def bitmap_under_lo(pkg: str):
    """The flagship scene over the bitmap ground, its receiver raw_resample
    with the transmitter's waveform for its LO."""
    return doppler_change(pkg, *textured_flagship(pkg, 'bitmap'),
                          'raw_resample')


# case: (scene, coherent, depth)
CASES = {'closing_plate_checker': (
    lambda pkg: closing_plate_over(pkg, 'checkerboard'), False, 2),
    'bitmap_raw_resample_iq': (bitmap_under_lo, True, 1)}


@pytest.mark.parametrize('name', list(CASES))
def test_plain_version_matches_jax_megakernel(name):
    """Identical uniforms, 2,048 lanes, gate sampling, depth 2 (I / Q:
    1).  Power: 1e-4 x max|acc| per cell; I / Q: plus the phase slack
    times the cell's amplitude sum (plane rectangles: no connection needs
    its own slack).
    Events within 1e-3.  The lanes hit the textured ground; the port's
    tables equal the JAX package's bit for bit, and its `supported` takes
    the scene in the Doppler configuration."""
    make, coherent, depth = CASES[name]
    s, rx = make('jax')
    out_j, cnt_j, u, tab = _jax_run(s, rx, 2048, depth, 5, 'gate',
                                    coherent)
    si = s.shape_index_of_endpoint('receiver', rx.id)
    ref_pack = pr._pack_scene(s.compile(use_bvh=False), rx, si)
    tex, bmp_meta = ref_pack[7], ref_pack[8]
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling='gate',
              rx_kind=tab['rx_kind'], doppler=True, coherent=coherent,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, tex=torch.tensor(tex),
              bmp_meta=torch.tensor(np.asarray(bmp_meta, np.int32)))
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(
        tab['params'], tab['prim'], tab['txp'], u, stats=stats,
        amp_out=amp if coherent else None, **kw)
    assert stats['tex_hit'] > 0, stats
    assert acc.shape == out_j.shape and cnt_j > 0
    scale = np.abs(out_j).max()
    assert scale > 0
    bound = TOL * scale
    if coherent:
        bound = bound + rk.phase_slack(s.band, rx.adc) \
            * amp.numpy()[..., None]
    err = np.abs(acc.numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the port's builder packs the same tables, and both scopes take it
    s_t, rx_t = make('port')
    sd_t = s_t.compile(device='cpu')
    got = rk.pack_scene(sd_t, rx_t, si)
    for key, a, b in (('params', got.params, ref_pack[0]),
                      ('prim', got.prim, ref_pack[1]),
                      ('txp', got.txp, ref_pack[2]), ('tex', got.tex, tex)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=key)
    assert got.textured and got.doppler(rx_t.adc)
    assert rk.supported(sd_t, rx_t)
