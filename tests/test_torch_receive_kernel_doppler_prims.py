"""The receive kernel's spheres, disks and cylinders in its Doppler
configurations on the CPU: the plain version against the JAX package's
`_run(interpret=True)` on identical uniforms, in power on the
range-Doppler pulse with a closing sphere (its 8 x 128 time x Doppler
grid) and a closing disk at depth 2, and on golden config 2's
mix_resample with a GGX cylinder for its target, and in I / Q on a
closing GGX sphere and the GGX cylinder under mix_resample; each scene
built by both packages from one spec (the port's
`scenes.range_doppler_scene(target=)` and `fmcw_sonar_scene`), its tables
bit for bit.  One prim a scene, depth 1 or 2, 2,048 lanes: the interpret
program unrolls every prim's test at every depth.  The CUDA twins
(`receive_doppler_power_kernel<false, true>`,
`receive_coherent_kernel<false, true>`) are held to the plain version in
the g++ emulation by tests/test_torch_doppler_prims_emulate.py and on a
card by tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_receive_kernel_doppler import _jax_run, range_doppler
from test_torch_wavefront import _pkg, fmcw_sonar

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell (I / Q add the phase slack)
METAL = dict(alpha=0.3, eta=1.5, k=3.0, twosided=True)


def closing_sphere(pkg: str, ggx: bool = False, target: str = 'sphere'):
    """Pulse 0 of the range-Doppler example with a 0.4 m sphere in place
    of its plate (the near surface at 4 m, closing at 5 m/s), or with
    `target` 'disk' a 0.5 m disk facing the apertures, diffuse or (`ggx`)
    a GGX rough conductor; the port's copy is
    `scenes.range_doppler_scene(0, target)`."""
    p = _pkg(pkg)
    if pkg == 'port':
        s, rx = bt.range_doppler_scene(0, target)
    else:
        s, rx = range_doppler(pkg)
        vel = np.asarray((0.0, 5.0, 0.0), np.float32)
        s.shapes[-1] = p.sh.sphere(
            center=(0.0, -4.4, 0.0), radius=0.4, bsdf='mat',
            velocity=vel) if target == 'sphere' else p.sh.disk(
            to_world=np.asarray(p.tf.compose(
                p.tf.look_at([0, -4.0, 0], [0, 0, 0]), p.tf.scale(0.5))),
            bsdf='mat', velocity=vel)
    if ggx:
        s.add(p.bsdf.rough_conductor('metal', **METAL))
        s.shapes[-1].bsdf = 'metal'
    return s, rx


def sonar_ggx_cylinder(pkg: str):
    """Golden config 2 (mix_resample, 16 x 256 time x beat) with a GGX
    rough conductor cylinder of radius 0.3 m and height 1.2 m for its
    target, its axis vertical 6 m out."""
    p = _pkg(pkg)
    s, rx = bt.fmcw_sonar_scene() if pkg == 'port' else fmcw_sonar(pkg)
    s.add(p.bsdf.rough_conductor('metal', **METAL))
    s.shapes[-1] = p.sh.cylinder(to_world=np.asarray(p.tf.compose(
        p.tf.translate([0.0, -6.0, -0.6]), p.tf.scale([0.3, 0.3, 1.2]))),
        bsdf='metal')
    return s, rx


# case: (scene, coherent, time sampling, depth, the kind its lanes hit)
CASES = {'closing_sphere': (closing_sphere, False, 'gate', 1, 'sphere_hit'),
         'sonar_ggx_cylinder': (sonar_ggx_cylinder, False, 'fixed', 1,
                                'cylinder_hit'),
         'closing_ggx_sphere_iq': (lambda pkg: closing_sphere(pkg, True),
                                   True, 'gate', 1, 'sphere_hit'),
         'closing_disk_depth2': (lambda pkg: closing_sphere(
             pkg, target='disk'), False, 'gate', 2, 'disk_hit'),
         'sonar_ggx_cylinder_iq': (sonar_ggx_cylinder, True, 'fixed', 1,
                                   'cylinder_hit')}


@pytest.mark.parametrize('name', list(CASES))
def test_plain_version_matches_jax_megakernel(name):
    """Identical uniforms, 2,048 lanes, depth 1 (the disk's 2: its
    bounces).  Power: 1e-4 x max|acc| per cell; I / Q: plus the phase
    slack times the cell's amplitude sum and each ill-conditioned
    connection's own (`cond_out`).  Events within 1e-3.  The lanes hit
    the kind, with the Doppler chain and (GGX) the rough lobe; the port's
    tables equal the JAX package's bit for bit and its `supported`
    agrees."""
    make, coherent, ts, depth, hit = CASES[name]
    s, rx = make('jax')
    out_j, cnt_j, u, tab = _jax_run(s, rx, 2048, depth, 5, ts, coherent)
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling=ts,
              rx_kind=tab['rx_kind'], doppler=True, coherent=coherent,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None)
    n_t, n_f = rx.adc.n_time, rx.adc.n_freq
    amp = torch.zeros((n_t, n_f), dtype=torch.float64)
    cond = torch.zeros_like(amp)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(
        tab['params'], tab['prim'], tab['txp'], u, stats=stats,
        amp_out=amp if coherent else None,
        cond_out=cond if coherent else None, **kw)
    assert stats[hit] > 0 and stats['dop_nee'] + stats['lo_freq'] > 0, stats
    if 'ggx' in name:
        assert stats['ggx_nee'] > 0, stats
    assert acc.shape == out_j.shape and cnt_j > 0
    scale = np.abs(out_j).max()
    assert scale > 0
    bound = TOL * scale
    if coherent:
        bound = bound + rk.phase_slack(s.band, rx.adc) \
            * (amp + cond).numpy()[..., None]
    err = np.abs(acc.numpy() - out_j)
    assert (err <= bound).all(), (err.max(), scale)
    assert abs(int(n_ev) - cnt_j) <= 1e-3 * cnt_j
    # the port's builder packs the same tables, and both scopes take it
    s_t, rx_t = make('port')
    sd_t = s_t.compile(device='cpu')
    si = s_t.shape_index_of_endpoint('receiver', rx_t.id)
    got = rk.pack_scene(sd_t, rx_t, si)
    ref = pr._pack_scene(s.compile(use_bvh=False), rx, si)
    for key, a, b in (('params', got.params[1:], ref[0][1:]),
                      ('prim', got.prim, ref[1]), ('txp', got.txp, ref[2])):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=key)
    assert got.prims and got.doppler(rx_t.adc)
    assert rk.supported(sd_t, rx_t)
