"""The receive kernel's prims twins on the CPU: the flagship scene with a
sphere, a disk and a cylinder beside its plate, built by both packages
from the same spec.  The plain version matches the JAX package's
`_run(interpret=True)` on identical uniforms in power (depth 2) and in
I / Q (depth 1), and its lanes hit each of the three prims.  The two
interpret cases sit in a file of their own (~45-85 s each: the interpret
program unrolls every prim's test at every depth).  The CUDA twins are
held to the plain version on a card by tests/test_torch_gpu.py and
chip_smoke.py, and in the g++ emulation by
tests/test_torch_prims_emulate.py."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from beifong_tpu.core import transform as tf_j
from beifong_tpu.geometry import shapes as sh_j
from beifong_tpu.integrators import pallas_receive as pr

import beifong_tpu_torch as bt
from beifong_tpu_torch.core import transform as tf_t
from beifong_tpu_torch.geometry import shapes as sh_t
from beifong_tpu_torch.integrators import receive_kernel as rk

from test_torch_receive_kernel_doppler import _jax_run

torch.set_num_threads(1)

TOL = 1e-4   # x max|acc| per cell (I / Q add the phase slack)


def prims_flagship(pkg: str):
    """The flagship scene (plate at 4 m, ground) with a sphere of radius
    0.4 m at (1.2, -3, 0), a disk of radius 0.5 m at (-1.2, -3, 0) facing
    the apertures and a vertical cylinder of radius 0.2 m at (0, -2.5),
    z in [-0.6, 0.6], in either package."""
    if pkg == 'jax':
        s, rx = ge._build_scene()
        sh, tf = sh_j, tf_j
    else:
        s, rx = bt.flagship_scene()
        sh, tf = sh_t, tf_t
    s.add(sh.sphere(center=(1.2, -3.0, 0.0), radius=0.4, bsdf='mat'))
    s.add(sh.disk(to_world=np.asarray(tf.compose(
        tf.look_at([-1.2, -3.0, 0.0], [0.0, 0.0, 0.0]), tf.scale(0.5))),
        bsdf='mat'))
    s.add(sh.cylinder(to_world=np.asarray(tf.compose(
        tf.translate([0.0, -2.5, -0.6]), tf.scale([0.2, 0.2, 1.2]))),
        bsdf='mat'))
    return s, rx


@pytest.mark.parametrize('coherent, depth', [(False, 2), (True, 1)],
                         ids=['pow', 'iq'])
def test_plain_version_matches_jax_megakernel(coherent, depth):
    """Identical uniforms, 2,048 lanes.  Power: 1e-4 x max|acc| per
    cell; I / Q: plus the phase slack times the cell's sum of
    amplitudes.  Events within 1e-3.  The plain version's lanes
    hit the sphere, the disk and the cylinder, and its shadow rays test
    them."""
    s, rx = prims_flagship('jax')
    out_j, cnt_j, u, tab = _jax_run(s, rx, 2048, depth, 5, 'gate',
                                    coherent)
    kw = dict(adc=tab['adc'], max_depth=depth, time_sampling='gate',
              rx_kind=tab['rx_kind'], doppler=coherent, coherent=coherent)
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64)
    stats = {}
    acc, n_ev = rk.receive_megakernel_ref(
        tab['params'], tab['prim'], tab['txp'], u, stats=stats,
        amp_out=amp if coherent else None, **kw)
    for key in ('sphere_hit', 'disk_hit', 'cylinder_hit', 'sphere_occ',
                'disk_occ', 'cylinder_occ'):
        assert stats[key] > 0, (key, stats)
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
    # and the JAX package's kernel takes the scene: its supported() and
    # the port's agree
    s_t, rx_t = prims_flagship('port')
    assert rk.supported(s_t.compile(device='cpu'), rx_t)
    assert pr.supported(s.compile(use_bvh=False), rx)
