"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Marked `gpu`: each test decides in the `cuda` fixture whether a
card is present and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch.  There, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -o addopts= -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from beifong_tpu_torch import receive, develop_signal
from beifong_tpu_torch.geometry import bvh as bvh_mod
from beifong_tpu_torch.geometry import bvh_kernel as bk
from beifong_tpu_torch.geometry import intersect_kernel as ik
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch import develop_mimo, receive_cpi, receive_mimo, \
    scenes
from beifong_tpu_torch.dsp import beamform as bf
from beifong_tpu_torch.scenes import corner_scene, flagship_scene, \
    fmcw_dechirp_scene, fmcw_scene, fmcw_sonar_scene, mesh_scene, \
    micro_doppler_scene, mimo_beamform_scene, multi_body_scene, \
    pulse_train_scene, range_doppler_scene, round_trip_bin

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    return torch.device('cuda')


def _flagship_tables(device, rx_kind='wigner'):
    s, rx = flagship_scene(rx_kind=rx_kind)
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    return (torch.tensor(p.params, device=device),
            torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), rx.adc)


@pytest.mark.gpu
@pytest.mark.parametrize('n_time', [16, 64, 512])
@pytest.mark.parametrize('rx_kind, ts', [('wigner', 'gate'),
                                         ('wigner', 'fixed'),
                                         ('omni', 'gate'),
                                         ('omni', 'fixed')])
def test_cuda_kernel_matches_plain_version(cuda, rx_kind, ts, n_time):
    """The flagship kernel (a wavefront in each warp, fixed-order warp
    rows) against the plain version: every cell within 1e-4 of max|acc|,
    the event counts within 1e-4 (FMA contraction can move a lane across
    a test: on these uniforms one lane of wigner / gate loses its NEE
    event in this kernel and in the grid-stride kernel before it)."""
    params, prim, txp, adc = _flagship_tables(cuda, rx_kind=rx_kind)
    adc = dataclasses.replace(adc, n_time=n_time)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(3), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    kw = dict(adc=adc, max_depth=3, time_sampling=ts, rx_kind=rx_kind)
    before = rk.receive_megakernel.launches
    flagship_before = rk.receive_megakernel.by_config['flagship']
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.launches == before + 1
    assert rk.receive_megakernel.by_config['flagship'] == flagship_before + 1
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    # same float32 operations in the same order; only FMA contraction and
    # the order of the sums across lanes differ
    assert float((acc - ref).abs().max()) <= 1e-4 * scale
    assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


@pytest.mark.gpu
def test_cuda_prng_mode_is_deterministic_philox(cuda):
    params, prim, txp, adc = _flagship_tables(cuda)
    kw = dict(adc=adc, max_depth=3, time_sampling='gate', rx_kind='wigner',
              n_lanes=(1 << 16) + 77, seed=11)
    a1, n1 = rk.receive_megakernel(params, prim, txp, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, **kw)
    assert torch.equal(a1, a2) and int(n1) == int(n2)
    u = rk.philox_uniforms(11, rk.n_draws(3), kw['n_lanes'], device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, adc=adc, max_depth=3, time_sampling='gate',
        rx_kind='wigner')
    assert float((a1 - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert abs(int(n1) - int(n_ref)) <= 1e-4 * int(n_ref)


def _injected(device, n_rows, n_lanes, seed, lead=()):
    g = np.random.default_rng(seed)
    return torch.tensor(g.random(lead + (n_rows, n_lanes), dtype=np.float32),
                        device=device)


@pytest.mark.gpu
@pytest.mark.parametrize('n_lanes', [1, 31, 128 * 37 + 45])
def test_flagship_kernel_ragged_tail(cuda, n_lanes):
    """Lane counts that fill no warp or block: the lanes past n_lanes add
    nothing, the ones before it all count."""
    params, prim, txp, adc = _flagship_tables(cuda)
    u = _injected(cuda, rk.n_draws(3), n_lanes, n_lanes)
    kw = dict(adc=adc, max_depth=3, time_sampling='gate', rx_kind='wigner')
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, **kw)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
    assert int(n_ev) == int(n_ref)
    assert float((acc - ref).abs().max()) <= 1e-4 * max(
        float(ref.abs().max()), 1e-30)


@pytest.mark.gpu
def test_flagship_cpi_of_four_pulses_is_four_calls(cuda):
    """A CPI of four pulses, each with its own uniforms, equals four
    single calls pulse by pulse, bit for bit, and each the plain
    version."""
    params, prim, txp, adc = _flagship_tables(cuda)
    n_pulses, n_lanes = 4, (1 << 14) + 5
    u = _injected(cuda, rk.n_draws(3), n_lanes, 4, lead=(n_pulses,))

    def stack(x):
        return x.unsqueeze(0).expand(n_pulses, *x.shape).contiguous()
    kw = dict(adc=adc, max_depth=3, time_sampling='gate', rx_kind='wigner')
    acc, n_ev = rk.receive_megakernel_cpi(stack(params), stack(prim),
                                          stack(txp), n_lanes=n_lanes,
                                          uniforms=u, **kw)
    for p in range(n_pulses):
        one, n_one = rk.receive_megakernel(params, prim, txp,
                                           n_lanes=n_lanes, uniforms=u[p],
                                           **kw)
        assert torch.equal(acc[p], one) and int(n_ev[p]) == int(n_one)
        ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u[p], **kw)
        assert float((one - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max())
        assert int(n_one) == int(n_ref)


@pytest.mark.gpu
def test_receive_on_card_peaks_at_round_trip(cuda):
    s, rx = flagship_scene()
    before = rk.receive_megakernel.launches
    adc, n = receive(s, spp=1 << 20, max_depth=3, time_sampling='gate')
    assert adc.device.type == 'cuda' and n == 1 << 20
    assert rk.receive_megakernel.launches == before + 1
    prof = develop_signal(adc, n, rx.adc)[:, 0, 0]
    assert bool(torch.isfinite(prof).all())
    assert abs(int(prof.argmax()) - round_trip_bin(s, rx)) <= 2


@pytest.mark.gpu
def test_receive_on_card_matches_cpu_for_one_seed(cuda):
    # the CPU draws the kernel's Philox stream: one seed, one answer
    s, rx = flagship_scene()
    kw = dict(seed=5, spp=1 << 16, max_depth=3, time_sampling='gate')
    a_gpu, _ = receive(s, **kw)
    a_cpu, _ = receive(s, s.compile(device='cpu'), rx, device='cpu', **kw)
    ref = a_cpu[:, 0, 0]
    assert float(ref.abs().max()) > 0
    assert float((a_gpu[:, 0, 0].cpu() - ref).abs().max()) \
        <= 1e-4 * float(ref.abs().max())


def _mesh_tables(device, n_side=71, seed=0):
    s, rx = mesh_scene(n_side=n_side)
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), p.mesh.to(device), rx.adc,
            sd)


def _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref, depth=2,
                        cell_slack=0.0, floor=1e-6, ill=None):
    """Lane by lane: a lane whose sum differs by more than 1e-4 of itself
    (and `floor` of the largest lane) took another path (a ray at a
    triangle edge, under FMA contraction); at most 1e-4 of the lanes may,
    besides lanes of the mask `ill` (ill-conditioned optical depths, see
    `_assert_media_parity`), and they bound how far the bins and event
    counts may move beyond 1e-4 (plus `cell_slack` a cell)."""
    flipped = (lane - lane_ref).abs() > \
        1e-4 * lane_ref.abs() + floor * float(lane_ref.abs().max())
    n_flip = int(flipped.sum())
    n_out = n_flip if ill is None else int((flipped & ~ill).sum())
    assert n_out <= 1e-4 * lane.numel(), (n_out, n_flip)
    slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    assert bool(((acc - ref).abs()
                 <= 1e-4 * scale + slack + cell_slack).all())
    assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref) \
        + 2 * depth * n_flip


def _query_rays(sd, n, device, seed=0):
    """Rays from around the mesh toward random points of its bounding box,
    and shadow lengths that leave some rays blocked and some free."""
    g = torch.Generator().manual_seed(seed)
    v = sd.tris.v0
    lo, hi = v.min(0).values - 0.05, v.max(0).values + 0.05
    tgt = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    org = (lo + hi) / 2 + 2.0 * (torch.rand((n, 3), generator=g) - 0.5)
    d = tgt - org
    dist = d.norm(dim=1)
    d = d / dist[:, None]
    maxt = dist * (0.8 + 0.4 * torch.rand(n, generator=g))
    return (org.to(device).contiguous(), d.to(device).contiguous(),
            maxt.to(device).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize('n_side, align', [(71, True), (201, False)])
def test_bvh_kernels_match_plain_versions(cuda, n_side, align):
    """K2 / K3 on the mesh scene's tree (10,082 faces, aligned leaves), and
    on a second tree: 80,802 faces, the wavefront's unaligned build (leaves
    of 1-8 faces), 855 KB of node pairs."""
    sd = mesh_scene(n_side=n_side)[0].compile(use_bvh=False, device='cpu')
    b = bvh_mod.build(sd.tris.v0.numpy(), sd.tris.e1.numpy(),
                      sd.tris.e2.numpy(), align=align)
    pb = bk.pack(b).to(cuda)
    o, d, maxt = _query_rays(sd, 1 << 16, cuda)
    before = (bk.bvh_closest.launches, bk.bvh_any.launches)
    t, idx, u, v = bk.bvh_closest(pb, o, d)
    occ = bk.bvh_any(pb, o, d, maxt)
    torch.cuda.synchronize()
    assert (bk.bvh_closest.launches, bk.bvh_any.launches) == \
        (before[0] + 1, before[1] + 1)
    rt, ri, ru, rv = bk.bvh_closest_ref(pb, o, d)
    ro = bk.bvh_any_ref(pb, o, d, maxt)
    # FMA contraction may flip a ray at a shared edge: allow 1e-4 of them
    flips = int((idx != ri).sum())
    assert flips <= 1e-4 * idx.numel()
    same = (idx == ri) & (ri >= 0)
    assert int(same.sum()) > 0.1 * idx.numel()
    assert torch.allclose(t[same], rt[same], rtol=1e-5, atol=0)
    # u, v: |du| ~ ulp(terms) / |det|, which grazing rays make large
    assert torch.allclose(u[same], ru[same], rtol=0, atol=1e-3)
    assert torch.allclose(v[same], rv[same], rtol=0, atol=1e-3)
    assert int((occ != ro).sum()) <= 1e-4 * occ.numel()
    assert 0 < int(ro.sum()) < ro.numel()


@pytest.mark.gpu
@pytest.mark.parametrize('n_lanes, patch_p', [(1 << 16, 0), (1 << 18, 16)])
def test_mesh_kernel_matches_plain_version(cuda, n_lanes, patch_p):
    params, prim, txp, mesh, adc, _ = _mesh_tables(cuda, seed=3)
    u = torch.rand((rk.n_draws(2), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    kw = dict(adc=adc, max_depth=2, time_sampling='gate', rx_kind='wigner',
              mesh=mesh, patch_p=patch_p)
    before = rk.receive_megakernel.launches
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.launches == before + 1
    assert rk.launched_mesh_kernel()
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, **kw)
    _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref)


@pytest.mark.gpu
def test_mesh_kernel_philox_mode_matches_plain_version(cuda):
    params, prim, txp, mesh, adc, _ = _mesh_tables(cuda, seed=11)
    n_lanes = 1 << 18
    kw = dict(adc=adc, max_depth=2, time_sampling='gate', rx_kind='wigner',
              mesh=mesh, patch_p=rk.patch_p_for(n_lanes))
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    a1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, lane_out=lane, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    assert torch.equal(a1, a2) and int(n1) == int(n2)
    u = rk.philox_uniforms(11, rk.n_draws(2), n_lanes, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, **kw)
    _assert_mesh_parity(a1, n1, lane, ref, n_ref, lane_ref)


@pytest.mark.gpu
def test_mesh_receive_on_card_matches_cpu_for_one_seed(cuda):
    s, rx = mesh_scene()
    kw = dict(seed=5, spp=1 << 18, max_depth=2, time_sampling='gate')
    before = rk.receive_megakernel.launches
    a_gpu, n = receive(s, **kw)
    assert rk.receive_megakernel.launches == before + 1 and n == 1 << 18
    a_cpu, n_cpu = receive(s, s.compile(device='cpu'), rx, device='cpu',
                           **kw)
    assert n_cpu == n
    ref = a_cpu[:, 0, 0]
    assert float(ref.abs().max()) > 0
    assert float((a_gpu[:, 0, 0].cpu() - ref).abs().max()) \
        <= 1e-4 * float(ref.abs().max())
    prof = develop_signal(a_gpu, n, rx.adc)[:, 0, 0]
    assert bool(torch.isfinite(prof).all())
    assert abs(int(prof.argmax()) - round_trip_bin(s, rx)) <= 2


def _launches():
    return (ik.ray_triangle_closest.launches, ik.ray_triangle_any.launches,
            bk.bvh_closest.launches, bk.bvh_any.launches,
            rk.receive_megakernel.launches)


def _k4_bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _k4_equal(o, d, v0, e1, e2, maxt):
    """K4 on the card against its plain version, bit for bit (t, face, u,
    v, shadow flags; one launch each); the plain version's answers."""
    before = _launches()
    got = (*ik.ray_triangle_closest(o, d, v0, e1, e2),
           ik.ray_triangle_any(o, d, v0, e1, e2, maxt))
    torch.cuda.synchronize()
    assert _launches()[:2] == (before[0] + 1, before[1] + 1)
    ref = (*ik.ray_triangle_closest_ref(o, d, v0, e1, e2),
           ik.ray_triangle_any_ref(o, d, v0, e1, e2, maxt))
    for name, a, b in zip(('t', 'idx', 'u', 'v', 'any'), got, ref):
        assert torch.equal(_k4_bits(a), _k4_bits(b)), name
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize('n_side', [9, 22, 23, 71])
def test_ray_triangle_kernels_match_plain_versions(cuda, n_side):
    # 162, 968 (the largest soup use_bvh='auto' leaves to K4), 1058 (a
    # ragged last tile of 34) and 10,082 faces; 5000 rays (a ragged last
    # block); every operation rounded as in the plain version, so the
    # answers are equal bit for bit
    s, _ = mesh_scene(n_side=n_side)
    sd = s.compile(use_bvh=False, device='cpu')
    v0, e1, e2 = (x.to(cuda).contiguous()
                  for x in (sd.tris.v0, sd.tris.e1, sd.tris.e2))
    o, d, maxt = _query_rays(sd, 5000, cuda, seed=n_side)
    rt, ri, ru, rv, ro = _k4_equal(o, d, v0, e1, e2, maxt)
    assert 0.1 * ri.numel() < int((ri >= 0).sum()) < ri.numel()
    assert bool(torch.isinf(rt[ri < 0]).all())
    assert bool((ru[ri < 0] == 0).all())
    assert 0 < int(ro.sum()) < ro.numel()


def _k4_emulate():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import k4_emulate
    return k4_emulate


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['duplicates', 'vertices_edges', 'grazing',
                                  'tiny_far', 'on_face', 'maxt_edges',
                                  'all_miss'])
def test_ray_triangle_kernels_on_edge_soups(cuda, case):
    """The soups of tools/k4_emulate.py, built to break a cull or the tie
    rule (duplicate faces inside a tile and across the 512-face tile
    boundary, rays through vertices and along edges, grazing rays, tiny
    faces far away, origins on a face, maxt at the first hit, a ragged
    last tile, all-miss rays), bit for bit on the card."""
    ke = _k4_emulate()
    assert case in ke.CASES
    tensors = [torch.from_numpy(x).to(cuda) for x in ke.cases()[case]]
    _k4_equal(*tensors)


@pytest.mark.gpu
def test_wavefront_triangle_tests_run_k4(cuda):
    s, rx = multi_body_scene()
    sd = s.compile(use_bvh=False)
    before = _launches()
    # multi_body is in the receive kernel's scope: use_kernel=False keeps
    # it on the wavefront
    adc, n = receive(s, sd, rx, seed=3, spp=1 << 15, max_depth=2,
                     time_sampling='gate', use_kernel=False)
    torch.cuda.synchronize()
    after = _launches()
    # one pass, depth 2: two closest-hit and two shadow tests
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    assert after[2:] == before[2:]
    grid = develop_signal(adc, n, rx.adc)[..., 0]
    assert adc.device.type == 'cuda' and bool(torch.isfinite(grid).all())
    # body 1 (3 m, static) fills range gate 4 / 5 at 0 Hz (bins 7 / 8)
    assert int(grid[3:7].sum(0).argmax()) in (7, 8)


@pytest.mark.gpu
def test_wavefront_bvh_queries_run_k2_k3(cuda):
    s, rx = mesh_scene(n_side=23)     # 1058 faces: compile builds a BVH
    sd = s.compile()
    assert sd.bvh is not None
    before = _launches()
    adc, n = receive(s, sd, rx, seed=3, spp=1 << 16, max_depth=2,
                     time_sampling='gate', use_kernel=False)
    torch.cuda.synchronize()
    after = _launches()
    assert (after[2] - before[2], after[3] - before[3]) == (2, 2)
    assert after[:2] == before[:2] and after[4] == before[4]
    prof = develop_signal(adc, n, rx.adc)[:, 0, 0]
    assert bool(torch.isfinite(prof).all())
    assert abs(int(prof.argmax()) - round_trip_bin(s, rx)) <= 2


@pytest.mark.gpu
def test_wavefront_on_card_matches_cpu_for_one_seed(cuda):
    # both draw the port's Philox stream; the splat's atomic order and the
    # devices' sin / exp differ in the last bits
    s, rx = multi_body_scene()
    kw = dict(seed=7, spp=1 << 14, max_depth=2, time_sampling='gate',
              use_kernel=False)
    a_gpu, _ = receive(s, s.compile(use_bvh=False), rx, **kw)
    a_cpu, _ = receive(s, s.compile(use_bvh=False, device='cpu'), rx,
                       device='cpu', **kw)
    ref = a_cpu[..., 0]
    assert float(ref.abs().max()) > 0
    assert float((a_gpu[..., 0].cpu() - ref).abs().max()) \
        <= 1e-4 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# the receive kernel's Doppler configuration
# ---------------------------------------------------------------------------


def _variant(scene_fn, **adc):
    s, rx = scene_fn()
    if adc:
        rx = dataclasses.replace(rx, adc=dataclasses.replace(rx.adc, **adc))
        s.receivers[0] = rx
    return s, rx


DOPPLER_SCENES = {
    'multi_body': lambda: _variant(multi_body_scene),
    'range_doppler': lambda: _variant(range_doppler_scene),
    'wide_1d': lambda: _variant(flagship_scene, n_time=1024),
    # past the shared-memory grid's cap: the global accumulator
    'global_grid': lambda: _variant(range_doppler_scene, n_time=256,
                                    n_freq=128),
    # 2^19 cells: most hold a few lanes' taps, so ulps of a tap's
    # coordinate move a cell past 1e-4 of max|acc|: each cell is bound by
    # `coord_slack` of its sum of |power|, and held lane by lane
    'large_grid': lambda: _variant(range_doppler_scene, n_time=4096,
                                   n_freq=128),
}


def _doppler_tables(device, scene, seed=0):
    s, rx = DOPPLER_SCENES[scene]()
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert p.doppler(rx.adc)
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    mesh = None if p.mesh is None else p.mesh.to(device)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', mesh=mesh, doppler=True,
              msh=None if mesh is None else torch.tensor(p.msh,
                                                         device=device))
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw)


def _assert_doppler_parity(acc, n_ev, lane, ref, n_ref, lane_ref, mesh):
    """`mesh` (or a sparse grid): lane by lane, as the mesh parity."""
    if mesh:
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref)
        return
    # same float32 operations; FMA contraction, rsqrtf and the order of
    # the atomic sums differ
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    assert float((acc - ref).abs().max()) <= 1e-4 * scale
    assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', list(DOPPLER_SCENES))
def test_doppler_kernel_matches_plain_version(cuda, scene):
    params, prim, txp, kw = _doppler_tables(cuda, scene, seed=3)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(2), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    before = dict(rk.receive_megakernel.by_config)
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    name = rk.config_name(kw['mesh'] is not None, True)
    assert rk.receive_megakernel.by_config[name] == before[name] + 1
    # the analytic scenes run the Doppler power kernel, multi_body the
    # mesh Doppler kernel (the launch record)
    assert rk.launched_doppler_power_kernel() == (kw['mesh'] is None)
    assert rk.launched_mesh_doppler_kernel() == (kw['mesh'] is not None)
    adc = kw['adc']
    amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64,
                      device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    assert acc.shape == ref.shape == (adc.n_time, adc.n_freq)
    if scene == 'large_grid':
        assert adc.n_time * adc.n_freq >= 1 << 19
        assert rk.grid_mode(adc.n_time * adc.n_freq, True) == 2
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref,
                            cell_slack=rk.coord_slack(adc) * amp.float())
        return
    _assert_doppler_parity(acc, n_ev, lane, ref, n_ref, lane_ref,
                           kw['mesh'] is not None)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['multi_body', 'range_doppler'])
def test_doppler_kernel_philox_mode(cuda, scene):
    """Two calls with one seed agree per cell to 1e-6 of max|acc| (the
    configuration adds with atomics, in arrival order) and with the plain
    version on the same Philox stream."""
    params, prim, txp, kw = _doppler_tables(cuda, scene, seed=11)
    n_lanes = 1 << 18
    if kw['mesh'] is not None:
        kw['patch_p'] = rk.patch_p_for(n_lanes)
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    a1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, lane_out=lane, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    scale = float(a1.abs().max())
    assert scale > 0 and int(n1) == int(n2)
    assert float((a1 - a2).abs().max()) <= 1e-6 * scale
    u = rk.philox_uniforms(11, rk.n_draws(2), n_lanes, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, **kw)
    _assert_doppler_parity(a1, n1, lane, ref, n_ref, lane_ref,
                           kw['mesh'] is not None)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['multi_body', 'range_doppler'])
def test_doppler_receive_on_card_matches_cpu_for_one_seed(cuda, scene):
    """receive() launches the Doppler configuration once and no K4; the
    card's grid matches the CPU's (one Philox stream) within 1e-3 of
    max|acc| per cell: beyond the kernel parity's 1e-4, a lane at a
    triangle edge may take another face under FMA contraction and move
    its contribution, which `lane_out` shows in the tests above."""
    s, rx = DOPPLER_SCENES[scene]()
    kw = dict(seed=5, spp=1 << 16, max_depth=2, time_sampling='gate')
    before = _launches()
    by_cfg = dict(rk.receive_megakernel.by_config)
    a_gpu, n = receive(s, s.compile(use_bvh=False), rx, **kw)
    torch.cuda.synchronize()
    after = _launches()
    name = 'doppler_mesh' if scene == 'multi_body' else 'doppler'
    assert after[4] == before[4] + 1 and after[:4] == before[:4]
    assert rk.receive_megakernel.by_config[name] == by_cfg[name] + 1
    a_cpu, n_cpu = receive(s, s.compile(use_bvh=False, device='cpu'), rx,
                           device='cpu', **kw)
    assert n == n_cpu == 1 << 16
    ref = a_cpu[..., 0]
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((a_gpu[..., 0].cpu() - ref).abs().max()) <= 1e-3 * scale
    grid = develop_signal(a_gpu, n, rx.adc)[..., 0]
    assert bool(torch.isfinite(grid).all())
    if scene == 'multi_body':
        # body 1 (3 m, static) in range gate 4 / 5 at 0 Hz (bins 7 / 8),
        # body 2 (5.7 m, closing) in gate 8 / 9 at +680 Hz (bin 12.9)
        assert int(grid[3:7].sum(0).argmax()) in (7, 8)
        assert int(grid[8:11].sum(0).argmax()) in (12, 13, 14)
    else:
        # the plate closing at 5 m/s: +1173 Hz, bin 101.0
        assert int(grid.sum(0).argmax()) in (100, 101, 102)


def _k1_emulate():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import k1_emulate
    return k1_emulate


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['dop_fmcw_sonar', 'dop_mixer', 'dop_ggx',
                                  'dop_rows'])
def test_doppler_power_kernel_on_its_scenes(cuda, name):
    """The analytic Doppler power kernel on the scenes of
    tools/k1_emulate.py: golden config 2 (mix_resample, 16 x 256, fixed
    sampling), the FMCW mixer in power (an LO, a beat drawn a lane), the
    range-Doppler pulse with a GGX plate, and a pulse of config 3 on warp
    rows; injected uniforms, lane by lane against the plain version, each
    cell within 1e-4 x max|acc|, and a repeat within 1e-6 (bit for bit on
    warp rows)."""
    params, prim, txp, kw, _ = _k1_emulate().doppler_tables(name, cuda)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(kw['max_depth']), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(5),
                   device=cuda)
    lane = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.launched_doppler_power_kernel()
    lane_ref = torch.empty(n_lanes, device=cuda)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, stats=stats,
                                           **kw)
    _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref,
                        depth=kw['max_depth'])
    if name == 'dop_ggx':
        assert stats['ggx_nee'] > 0 and stats['ggx_bounce'] > 0
    if name == 'dop_mixer':
        assert stats['freq_draw'] == stats['lo_freq'] == n_lanes
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                     uniforms=u, **kw)
    if rk.coherent_warp_rows(kw['adc'], False):
        assert torch.equal(acc, acc2)
    assert float((acc - acc2).abs().max()) <= 1e-6 * float(acc.abs().max())
    assert int(n_ev) == int(n2)


# the mesh Doppler kernel's scenes (tools/k1_emulate.py MESH_CASES):
# multi_body in power with the main path's strata and without and in I /
# Q, the rough-plastic mesh in I / Q and in power, the diffuse mesh in I /
# Q (the coherent mesh) with strata and without, and the coherent mesh and
# the power mesh lobe twin on a global grid
MDK_CASES = ('mesh_multi_body', 'mesh_multi_body_p0',
             'mesh_rough_plastic_iq', 'mesh_rough_plastic_power',
             'mesh_coherent', 'mesh_coherent_p0', 'mesh_multi_body_iq',
             'mesh_coherent_global', 'mesh_rough_plastic_global')


def _mdk_record(coherent, lobes):
    """The launch record shows receive_mesh_doppler_kernel<coherent,
    lobes> and none of its three other instantiations."""
    for c in (False, True):
        for lob in (False, True):
            assert rk.launched_mesh_doppler_kernel(lob, c) \
                == ((c, lob) == (coherent, lobes)), (c, lob)


@pytest.mark.gpu
@pytest.mark.parametrize('name', MDK_CASES)
def test_mesh_doppler_kernel_matches_plain_version(cuda, name):
    """The mesh Doppler kernel (receive_mesh_doppler_kernel<COH, LOB>: the
    Doppler mesh in power and in I / Q, the mesh lobe twins in I / Q and in
    power) on injected uniforms, lane by lane against the plain version
    (power to 1e-4 x max|acc|, I / Q with the phase slack), the launch
    record, and a repeat: bit for bit on the warp rows, within 1e-6 of
    max|acc| on the block's and the global grid's atomics."""
    params, prim, txp, msh, mesh, kw, _, band = \
        _k1_emulate().mesh_tables(name, cuda)
    n_lanes = 1 << 16
    coh = kw['coherent']
    nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
    u = torch.rand((nd, n_lanes),
                   generator=torch.Generator(cuda).manual_seed(9),
                   device=cuda)
    lane = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, mesh=mesh,
                                      msh=msh, **kw)
    torch.cuda.synchronize()
    lob = bool(kw['lobes'])
    _mdk_record(coh, lob)
    adc = kw['adc']
    lane_ref = torch.empty(n_lanes, device=cuda)
    amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64,
                      device=cuda)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           stats=stats, mesh=mesh, msh=msh,
                                           **kw)
    assert stats['mesh_hits'] > 0 and stats['nee_splat'] > 0
    assert (stats['rplas_bounce'] > 0) == lob
    assert (stats['ggx_nee'] > 0) == ('multi_body' in name)
    if coh:
        _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                rk.phase_slack(band, adc), lane, lane_ref)
    else:
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref)
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                     uniforms=u, mesh=mesh, msh=msh, **kw)
    if rk.coherent_warp_rows(adc, coh):
        assert torch.equal(acc, acc2)
    assert float((acc - acc2).abs().max()) <= 1e-6 * float(acc.abs().max())
    assert int(n_ev) == int(n2)


@pytest.mark.gpu
def test_mesh_doppler_cpi_is_launches_per_pulse(cuda):
    """multi_body's 4-pulse CPI (the GGX body moving between pulses) in one
    launch of the mesh Doppler kernel, the pulse its grid's y axis: each
    pulse within 1e-6 of max|acc| of one launch on the pulse's key and
    tables, and lane by lane against the plain version on its Philox
    stream."""
    _mdk_cpi(cuda, 'mesh_multi_body_cpi')


@pytest.mark.gpu
def test_coherent_mesh_cpi_is_launches_per_pulse(cuda):
    """The coherent mesh's 4-pulse CPI in one launch of <true, false>, as
    multi_body's (I / Q against the plain version with the phase
    slack)."""
    _mdk_cpi(cuda, 'mesh_coherent_cpi')


def _mdk_cpi(cuda, name):
    params, prim, txp, msh, mesh, kw, n_p, band = \
        _k1_emulate().mesh_tables(name, cuda)
    coh = kw['coherent']
    n_lanes, step = 1 << 16, 7919
    lane = torch.empty((n_p, n_lanes), device=cuda)
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, n_lanes=n_lanes,
                                          seed=11, seed_step=step,
                                          lane_out=lane, mesh=mesh, msh=msh,
                                          **kw)
    torch.cuda.synchronize()
    _mdk_record(coh, False)
    for p in range(n_p):
        m_p = rk.pulse_mesh(mesh, p)
        one, n_one = rk.receive_megakernel(params[p], prim[p], txp[p],
                                           n_lanes=n_lanes,
                                           seed=11 + step * p, mesh=m_p,
                                           msh=msh[p], **kw)
        assert int(n_one) == int(n_ev[p]) > 0
        assert float((acc[p] - one).abs().max()) \
            <= 1e-6 * float(one.abs().max())
        u = rk.philox_uniforms(11 + step * p, rk.n_draws(kw['max_depth']),
                               n_lanes, device=cuda)
        lane_ref = torch.empty(n_lanes, device=cuda)
        amp = torch.zeros((kw['adc'].n_time, kw['adc'].n_freq),
                          dtype=torch.float64, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(params[p], prim[p], txp[p],
                                               u, lane_out=lane_ref,
                                               amp_out=amp, mesh=m_p,
                                               msh=msh[p], **kw)
        if coh:
            _assert_coherent_parity(acc[p], n_ev[p], ref, n_ref, amp,
                                    rk.phase_slack(band, kw['adc']),
                                    lane[p], lane_ref)
        else:
            _assert_mesh_parity(acc[p], n_ev[p], lane[p], ref, n_ref,
                                lane_ref)


@pytest.mark.gpu
def test_mesh_twins_keep_the_grid_stride_kernel(cuda):
    """The media and endpoint twins of the mesh configurations keep
    receive_doppler_kernel<true, ...>: the Doppler mesh and the coherent
    mesh through a homogeneous medium, and the Doppler mesh endpoint twin;
    none launches the mesh Doppler kernel (the launch record; their parity
    is held by the tests of their configurations)."""
    cases = []
    for coh, (s, rx) in ((False, multi_body_scene()),
                         (True, mesh_scene(n_side=23))):
        s.medium = scenes.stratified_homogeneous()
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
        assert p.medium > 0
        cases.append((f'{"coherent" if coh else "doppler"} mesh media',
                      *(torch.tensor(a, device=cuda)
                        for a in (p.params, p.prim, p.txp)),
                      dict(adc=rx.adc, max_depth=2, time_sampling='gate',
                           rx_kind='wigner', doppler=True, coherent=coh,
                           medium=p.medium, mesh=p.mesh.to(cuda),
                           msh=torch.tensor(p.msh, device=cuda))))
    _, _, params, prim, txp, kw = _ep_tables(cuda, 'phased_tx',
                                             'doppler_mesh')
    cases.append(('doppler mesh endpoints', params, prim, txp, kw))
    for what, params, prim, txp, kw in cases:
        acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=1 << 16,
                                          seed=7, **kw)
        torch.cuda.synchronize()
        for coh in (False, True):
            for lob in (False, True):
                assert not rk.launched_mesh_doppler_kernel(lob, coh), what
        assert bool(torch.isfinite(acc).all()) and int(n_ev) > 0, what


@pytest.mark.gpu
def test_doppler_power_twins_keep_the_grid_stride_kernel(cuda):
    """The range-Doppler pulse through a homogeneous medium launches the
    media twin receive_doppler_kernel<0,0,1,0,0> and a phased
    transmitter's Doppler power call the endpoint twin <0,0,0,1,0> (the
    launch record), each within 1e-4 x max|acc| of the plain version."""
    s, rx = range_doppler_scene()
    s.medium = scenes.stratified_homogeneous()
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x, device=cuda)
                         for x in (p.params, p.prim, p.txp))
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=True, medium=p.medium)
    u = torch.rand((rk.n_draws(2), 1 << 16),
                   generator=torch.Generator(cuda).manual_seed(7),
                   device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=1 << 16,
                                      uniforms=u, **kw)
    torch.cuda.synchronize()
    assert rk.launched_doppler_power_kernel('media')
    assert not rk.launched_doppler_power_kernel()
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
    assert float((acc - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    params, prim, txp, kw, _, _ = _k1_emulate().endpoint_tables(
        'ep_phased_tx', cuda)
    kw = dict(kw, doppler=True)
    u = torch.rand((rk.n_draws(2), 1 << 16),
                   generator=torch.Generator(cuda).manual_seed(7),
                   device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=1 << 16,
                                      uniforms=u, **kw)
    torch.cuda.synchronize()
    assert rk.launched_doppler_power_kernel('ep')
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
    assert float((acc - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert int(n_ev) == int(n_ref) > 0


# ---------------------------------------------------------------------------
# the coherent configuration and the LO receive types
# ---------------------------------------------------------------------------


COHERENT_SCENES = {
    # (scene, time sampling, coherent, depth)
    'fmcw_sonar': (fmcw_sonar_scene, 'fixed', False, 2),
    'mixer': (lambda: fmcw_scene('mixer'), 'fixed', True, 2),
    'raw_resample': (lambda: fmcw_scene('raw_resample'), 'fixed', False, 2),
    'pulse_train': (lambda: pulse_train_scene(0), 'gate', True, 2),
    'flagship': (flagship_scene, 'gate', True, 2),
    'dechirp': (fmcw_dechirp_scene, 'gate', True, 2),
    'mesh': (lambda: mesh_scene(n_side=23), 'gate', True, 2),
    # past the shared-memory grid's coherent cap: the global accumulator
    'global_grid': (lambda: _variant(lambda: pulse_train_scene(0),
                                     n_time=128, n_freq=128),
                    'gate', True, 2),
    # golden config 4's trihedral of mirrors: the mirror chains, I / Q and
    # power (the triple bounce and the direct hit take depth 4)
    'corner': (lambda: _snapshot(corner_scene), 'fixed', True, 4),
    'corner_power': (lambda: _snapshot(corner_scene), 'fixed', False, 4),
}


def _snapshot(scene_fn, t=0.0):
    s, rx = scene_fn()
    return s.at_time(t), rx


def _coherent_tables(device, scene, seed=0):
    fn, ts, coherent, depth = COHERENT_SCENES[scene]
    s, rx = fn()
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    mesh = None if p.mesh is None else p.mesh.to(device)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind='wigner', mesh=mesh, doppler=True,
              msh=None if mesh is None else torch.tensor(p.msh,
                                                         device=device),
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, coherent=coherent)
    return (s, rx, params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw)


def _assert_coherent_parity(acc, n_ev, ref, n_ref, amp, slack, lane=None,
                            lane_ref=None, depth=2, ill=None, cond=None):
    """Per cell and channel: 1e-4 x max(|I|, |Q|) plus the phase slack
    times the cell's sum of amplitudes (the kernel's contracted path
    lengths move each phase by a few ulps of the path over the
    wavelength).  Lane by lane (meshes), the amplitude is the square root
    of a power, so the power test's 1e-6 of the largest lane becomes 1e-3;
    lanes beyond it took another path and bound the cells by their
    amplitude sums; lanes of the mask `ill` may take another path besides
    them (`_assert_mesh_parity`).  `cond` (the plain version's
    `cond_out`) adds the phase slack times each ill-conditioned
    connection's amplitude times its own slack gain."""
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    bound = 1e-4 * scale + slack * amp.float()[..., None]
    if cond is not None:
        bound = bound + slack * cond.float()[..., None]
    flip_slack, n_flip = 0.0, 0
    if lane is not None:
        flipped = (lane - lane_ref).abs() > \
            1e-4 * lane_ref.abs() + 1e-3 * float(lane_ref.abs().max())
        n_flip = int(flipped.sum())
        n_out = n_flip if ill is None else int((flipped & ~ill).sum())
        assert n_out <= 1e-4 * lane.numel(), (n_out, n_flip)
        flip_slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    assert bool(((acc - ref).abs() <= bound + flip_slack).all())
    assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref) \
        + 2 * depth * n_flip


@pytest.mark.gpu
@pytest.mark.parametrize('scene', list(COHERENT_SCENES))
def test_coherent_and_lo_kernels_match_plain_version(cuda, scene):
    """Each receive type, power and I / Q, on injected uniforms: the
    kernel against its plain version (power to 1e-4 x max|acc|)."""
    s, rx, params, prim, txp, kw = _coherent_tables(cuda, scene, seed=3)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(kw['max_depth']), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    before = dict(rk.receive_megakernel.by_config)
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    name = rk.config_name(kw['mesh'] is not None, True, kw['coherent'])
    assert rk.receive_megakernel.by_config[name] == before[name] + 1
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64,
                      device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref,
        amp_out=amp if kw['coherent'] else None, **kw)
    assert acc.shape == ref.shape
    # the mirror chains reflect d - 2 (d.n) n, which contraction moves by
    # ulps: over three bounces a lane may cross the transmitter's edge
    lanes = kw['mesh'] is not None or scene.startswith('corner')
    if not kw['coherent']:
        if lanes:
            # the 1.6 m transmitter's aperture WDF, a sinc of the mirrored
            # direction over the wavelength, moves near its zeros by more
            # than 1e-4 of itself: lanes are flagged, as for I / Q, past
            # 1e-3 of the largest lane
            _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref,
                                depth=kw['max_depth'], floor=1e-3)
            return
        scale = float(ref.abs().max())
        assert scale > 0 and int(n_ref) > 0
        assert float((acc - ref).abs().max()) <= 1e-4 * scale
        assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)
        return
    _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                            rk.phase_slack(s.band, rx.adc),
                            lane if lanes else None,
                            lane_ref if lanes else None,
                            depth=kw['max_depth'])
    if scene == 'global_grid':
        assert rk.grid_mode(rx.adc.n_time * rx.adc.n_freq, True, True) == 2


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['pulse_train', 'mixer'])
def test_coherent_kernel_philox_mode(cuda, scene):
    """Two Philox calls with one seed agree bit for bit where the coherent
    kernel sums warp rows (the pulse train's 8 bins), else per cell within
    1e-6 of the largest cell's sum of amplitudes (the mixer's 2-D grid:
    atomics add in arrival order, and I / Q partial sums reach the
    amplitudes' scale before they cancel); and with the plain version on
    the same stream."""
    s, rx, params, prim, txp, kw = _coherent_tables(cuda, scene, seed=11)
    n_lanes = 1 << 18
    a1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    u = rk.philox_uniforms(11, rk.n_draws(kw['max_depth']), n_lanes,
                           device=cuda)
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64,
                      device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, amp_out=amp,
                                           **kw)
    assert int(n1) == int(n2)
    assert rk.coherent_warp_rows(rx.adc) == (scene == 'pulse_train')
    if rk.coherent_warp_rows(rx.adc):
        assert torch.equal(a1, a2)
    assert float((a1 - a2).abs().max()) <= 1e-6 * float(amp.max())
    _assert_coherent_parity(a1, n1, ref, n_ref, amp,
                            rk.phase_slack(s.band, rx.adc))


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['pulse_train', 'dechirp'])
@pytest.mark.parametrize('n_lanes', [1, 31, 4781])
def test_coherent_kernel_ragged_tail(cuda, scene, n_lanes):
    """Lane counts that fill no warp or block, on injected uniforms: the
    coherent kernel's events equal the plain version's, each lane's sum of
    amplitudes within 1e-4 of itself plus 1e-3 of the largest lane (the
    coherent lane gate: an amplitude is the square root of a power, which
    FMA contraction moves by ulps where the aperture WDF cancels), and
    every cell within the coherent bound (of at least 1e-30)."""
    s, rx, params, prim, txp, kw = _coherent_tables(cuda, scene, seed=3)
    u = _injected(cuda, rk.n_draws(kw['max_depth']), n_lanes, n_lanes)
    lane = torch.full((n_lanes,), float('nan'), device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64,
                      device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    assert int(n_ev) == int(n_ref)
    assert bool(torch.isfinite(lane).all())
    assert bool(((lane - lane_ref).abs()
                 <= 1e-4 * lane_ref.abs()
                 + 1e-3 * float(lane_ref.abs().max())).all())
    bound = 1e-4 * max(float(ref.abs().max()), 1e-30) \
        + rk.phase_slack(s.band, rx.adc) * amp.float()[..., None]
    assert bool(((acc - ref).abs() <= bound).all())


@pytest.mark.gpu
def test_coherent_receive_on_card_launches_k1(cuda):
    """receive(coherent=True) and the LO receivers launch K1 (its coherent
    and Doppler configurations) and no wavefront kernel."""
    for fn, coherent, name in ((lambda: pulse_train_scene(0), True,
                                'coherent'),
                               (fmcw_sonar_scene, False, 'doppler'),
                               (lambda: mesh_scene(n_side=23), True,
                                'coherent_mesh')):
        s, rx = fn()
        before = _launches()
        by_cfg = dict(rk.receive_megakernel.by_config)
        a, n = receive(s, seed=5, spp=1 << 16, max_depth=2,
                       time_sampling='gate', coherent=coherent)
        torch.cuda.synchronize()
        after = _launches()
        assert after[4] == before[4] + 1 and after[:4] == before[:4]
        assert rk.receive_megakernel.by_config[name] == by_cfg[name] + 1
        assert a.shape == (rx.adc.n_time, rx.adc.n_freq,
                           4 if coherent else 3)
        assert bool(torch.isfinite(a).all())


# ---------------------------------------------------------------------------
# the coherent processing interval (CPI): every pulse in one launch
# ---------------------------------------------------------------------------


CPI_SCENES = {
    # (scene, pulses, prf, time sampling, depth): golden configs 5 and 4
    'micro_doppler': (micro_doppler_scene, 8, scenes.MICRO_DOPPLER['prf'],
                      'gate', 1),
    'corner': (corner_scene, 4, scenes.CORNER['prf'], 'fixed', 4),
}


def _cpi_tables(device, scene, seed, crn):
    fn, n_pulses, prf, ts, depth = CPI_SCENES[scene]
    s, _ = fn()
    packed, rx, _ = rk.pack_cpi(s, n_pulses, prf)
    seeds, step = rk.cpi_seeds(seed, n_pulses, crn)
    params = torch.tensor(packed.params, device=device)
    params[:, 0] = torch.tensor([rk.seed_slot(x) for x in seeds],
                                device=device)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind='wigner', doppler=True, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, coherent=True)
    return (s, rx, seeds, step, params,
            torch.tensor(packed.prim, device=device),
            torch.tensor(packed.txp, device=device), kw)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', list(CPI_SCENES))
@pytest.mark.parametrize('crn', [True, False], ids=['crn', 'independent'])
def test_cpi_launch_matches_launches_per_pulse_and_plain(cuda, scene, crn):
    """One launch of the CPI (the pulse a grid axis) against one launch a
    pulse on the same Philox key (seed, or seed + 7919 p without common
    random numbers): per cell within 1e-6 of the largest amplitude sum,
    the atomics adding in arrival order; and against the plain version on
    each pulse's Philox stream, lane by lane (the corner's mirror chains
    may move a lane across the transmitter's edge)."""
    s, rx, seeds, step, params, prim, txp, kw = _cpi_tables(cuda, scene, 11,
                                                            crn)
    n_pulses, n_lanes = int(params.shape[0]), 1 << 16
    before = (rk.receive_megakernel_cpi.launches,
              rk.receive_megakernel.launches)
    lane = torch.empty((n_pulses, n_lanes), device=cuda)
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, n_lanes=n_lanes,
                                          seed=11, seed_step=step,
                                          lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert (rk.receive_megakernel_cpi.launches,
            rk.receive_megakernel.launches) == (before[0] + 1, before[1])
    assert acc.shape == (n_pulses, rx.adc.n_time, rx.adc.n_freq, 2)
    assert n_ev.shape == (n_pulses,)
    slack = rk.phase_slack(s.band, rx.adc)
    for p in range(n_pulses):
        one, n_one = rk.receive_megakernel(params[p], prim[p], txp[p],
                                           n_lanes=n_lanes, seed=seeds[p],
                                           **kw)
        u = rk.philox_uniforms(seeds[p], rk.n_draws(kw['max_depth']),
                               n_lanes, device=cuda)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=cuda)
        lane_ref = torch.empty(n_lanes, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(params[p], prim[p], txp[p], u,
                                               lane_out=lane_ref,
                                               amp_out=amp, **kw)
        assert int(n_one) == int(n_ev[p])
        assert float((acc[p] - one).abs().max()) <= 1e-6 * float(amp.max())
        _assert_coherent_parity(acc[p], n_ev[p], ref, n_ref, amp, slack,
                                lane[p], lane_ref, depth=kw['max_depth'])
    if crn:
        # one stream: the pulses differ by the target's motion alone
        assert float((acc[0] - acc[1]).abs().max()) > 0


@pytest.mark.gpu
def test_coherent_cpi_of_four_pulses_is_four_calls(cuda):
    """A coherent CPI of four pulses, each with its own injected uniforms,
    against four single calls: each lane's sum of amplitudes and each
    pulse's events bit for bit (they do not depend on the launch
    geometry), each cell within 1e-6 of the pulse's largest amplitude sum
    (the CPI shares the resident blocks among its pulses, so a pulse's
    warp rows sum its lanes in another grouping), and each pulse against
    the plain version."""
    s, rx, seeds, step, params, prim, txp, kw = _cpi_tables(
        cuda, 'micro_doppler', 11, False)
    params, prim, txp = params[:4], prim[:4], txp[:4]
    n_pulses, n_lanes = 4, (1 << 14) + 5
    u = _injected(cuda, rk.n_draws(kw['max_depth']), n_lanes, 9,
                  lead=(n_pulses,))
    lane = torch.empty((n_pulses, n_lanes), device=cuda)
    before = rk.receive_megakernel_cpi.by_config['coherent']
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, n_lanes=n_lanes,
                                          uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel_cpi.by_config['coherent'] == before + 1
    slack = rk.phase_slack(s.band, rx.adc)
    for p in range(n_pulses):
        lane1 = torch.empty(n_lanes, device=cuda)
        one, n_one = rk.receive_megakernel(params[p], prim[p], txp[p],
                                           n_lanes=n_lanes, uniforms=u[p],
                                           lane_out=lane1, **kw)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(params[p], prim[p], txp[p],
                                               u[p], amp_out=amp, **kw)
        assert torch.equal(lane[p], lane1) and int(n_ev[p]) == int(n_one)
        assert float((acc[p] - one).abs().max()) <= 1e-6 * float(amp.max())
        _assert_coherent_parity(acc[p], n_ev[p], ref, n_ref, amp, slack)


@pytest.mark.gpu
@pytest.mark.parametrize('mesh', [False, True], ids=['flagship', 'mesh'])
def test_cpi_launch_is_launches_per_pulse_bit_for_bit(cuda, mesh):
    """The flagship and mesh configurations give each pulse of a CPI the
    grid of one call and sum fixed rows: three pulses of one scene at
    three seeds equal three launches bit for bit."""
    if mesh:
        params, prim, txp, m, adc, _ = _mesh_tables(cuda, n_side=23)
    else:
        (params, prim, txp, adc), m = _flagship_tables(cuda), None
    n_pulses, n_lanes, seed, step = 3, 1 << 16, 5, 7919

    def stack(x):
        return x.unsqueeze(0).expand(n_pulses, *x.shape).contiguous()
    params_p = stack(params)
    params_p[:, 0] = torch.tensor([rk.seed_slot(seed + step * p)
                                   for p in range(n_pulses)], device=cuda)
    kw = dict(adc=adc, max_depth=2, time_sampling='gate', rx_kind='wigner',
              patch_p=rk.patch_p_for(n_lanes) if mesh else 0)
    acc, n_ev = rk.receive_megakernel_cpi(
        params_p, stack(prim), stack(txp), n_lanes=n_lanes, seed=seed,
        seed_step=step, mesh=None if m is None else rk.stack_meshes([m] * 3),
        **kw)
    assert rk.launched_mesh_kernel() == mesh
    assert float(acc.abs().max()) > 0
    for p in range(n_pulses):
        one, n_one = rk.receive_megakernel(params_p[p], prim, txp,
                                           n_lanes=n_lanes,
                                           seed=seed + step * p, mesh=m, **kw)
        assert torch.equal(acc[p], one) and int(n_ev[p]) == int(n_one)


@pytest.mark.gpu
def test_receive_cpi_on_card_is_one_launch_and_matches_cpu(cuda):
    """receive_cpi runs config 5's 8-pulse train as one K1 launch and no
    receive() call; each pulse of its cube matches the plain version on
    the CPU (the same Philox stream a pulse) within the coherent bound;
    'loop' launches K1 once a pulse and gives the same cube within the
    atomics' 1e-6 of the largest amplitude sum."""
    s, rx = micro_doppler_scene()
    kw = dict(n_pulses=8, prf=scenes.MICRO_DOPPLER['prf'], seed=11,
              spp=1 << 16, max_depth=1, time_sampling='gate')
    before = (rk.receive_megakernel_cpi.launches,
              rk.receive_megakernel.launches)
    cube, n = receive_cpi(s, **kw)
    torch.cuda.synchronize()
    assert (rk.receive_megakernel_cpi.launches,
            rk.receive_megakernel.launches) == (before[0] + 1, before[1])
    assert cube.device.type == 'cuda' and cube.shape == (8, 8, 1, 4)
    assert n == 1 << 16 and bool(torch.isfinite(cube).all())
    packed, rx, _ = rk.pack_cpi(s, 8, kw['prf'])
    u = rk.philox_uniforms(11, rk.n_draws(1), n)
    slack = rk.phase_slack(s.band, rx.adc)
    amp_max = 0.0
    for p in range(8):
        amp = torch.zeros((8, 1), dtype=torch.float64)
        params = torch.tensor(packed.params[p])
        params[0] = rk.seed_slot(11)
        ref, _ = rk.receive_megakernel_ref(
            params, torch.tensor(packed.prim[p]), torch.tensor(packed.txp[p]),
            u, adc=rx.adc, max_depth=1, time_sampling='gate',
            rx_kind='wigner', doppler=True, coherent=True, amp_out=amp)
        amp_max = max(amp_max, float(amp.max()))
        bound = 1e-4 * float(ref.abs().max()) + slack * amp.float()[..., None]
        assert bool(((cube[p, ..., :2].cpu() - ref).abs() <= bound).all())
    loop, _ = receive_cpi(s, engine='loop', **kw)
    assert rk.receive_megakernel.launches == before[1] + 8
    assert float((loop - cube).abs().max()) <= 1e-6 * amp_max


@pytest.mark.gpu
@pytest.mark.parametrize('scene', list(CPI_SCENES))
def test_doppler_power_cpi_is_launches_per_pulse(cuda, scene):
    """A power CPI of four pulses (configs 5 and 4 without their I / Q) in
    one launch of the Doppler power kernel, the pulse its grid's y axis:
    each pulse within 1e-6 of max|acc| of one launch on the pulse's key
    (the pulses share the resident blocks, so a pulse's grid sums its
    lanes in another grouping), and lane by lane against the plain
    version on the pulse's Philox stream.  The corner's mirror chains end
    on the transmitter's aperture sinc near its zeros, where FMA
    contraction moves a lane by more than 1e-4 of itself: there, as for
    the lobe twins' chains (`_assert_lobe_parity`) and chip_smoke.py's
    corner gate, a lane may move by 1e-4 of the largest lane and a cell
    by 1e-4 of its sum of |power|."""
    s, rx, seeds, step, params, prim, txp, kw = _cpi_tables(cuda, scene, 11,
                                                            False)
    params, prim, txp = params[:4], prim[:4], txp[:4]
    kw = dict(kw, coherent=False)
    n_pulses, n_lanes = 4, 1 << 16
    lane = torch.empty((n_pulses, n_lanes), device=cuda)
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, n_lanes=n_lanes,
                                          seed=11, seed_step=step,
                                          lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.launched_doppler_power_kernel()
    assert acc.shape == (n_pulses, rx.adc.n_time, rx.adc.n_freq)
    for p in range(n_pulses):
        one, n_one = rk.receive_megakernel(params[p], prim[p], txp[p],
                                           n_lanes=n_lanes, seed=seeds[p],
                                           **kw)
        assert int(n_one) == int(n_ev[p])
        assert float((acc[p] - one).abs().max()) \
            <= 1e-6 * float(one.abs().max())
        u = rk.philox_uniforms(seeds[p], rk.n_draws(kw['max_depth']),
                               n_lanes, device=cuda)
        lane_ref = torch.empty(n_lanes, device=cuda)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(params[p], prim[p], txp[p], u,
                                               lane_out=lane_ref,
                                               amp_out=amp, **kw)
        chain = scene == 'corner'
        _assert_mesh_parity(acc[p], n_ev[p], lane[p], ref, n_ref, lane_ref,
                            depth=kw['max_depth'],
                            floor=1e-4 if chain else 1e-6,
                            cell_slack=1e-4 * amp.float() if chain else 0.0)



# ---------------------------------------------------------------------------
# MIMO receive: golden config 6 through K1's MIMO configuration
# ---------------------------------------------------------------------------


def _mimo_config6(**adc):
    s, rx = mimo_beamform_scene()
    if adc:
        rx.adc = dataclasses.replace(rx.adc, **adc)
    return s, rx


MIMO_SCENES = {
    # (scene, time sampling, depth): config 6 (the shared grid), in fixed
    # sampling at depth 3, and on 1,024 bins (the global grid)
    'config6': (_mimo_config6, 'gate', 2),
    'config6_fixed_d3': (_mimo_config6, 'fixed', 3),
    'global_grid': (lambda: _mimo_config6(n_time=1024), 'gate', 2),
}


def _mimo_tables(device, scene, seed=0):
    fn, ts, depth = MIMO_SCENES[scene]
    s, rx = fn()
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind='phased', doppler=True,
              rxph=torch.tensor(p.rxph, device=device),
              eoff=rk.array_offsets(s, sd, rx, device))
    return (s, rx, params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', list(MIMO_SCENES))
def test_mimo_kernel_matches_plain_version(cuda, scene):
    """Injected uniforms: all 2E channels per cell within 1e-4 x max|I, Q|
    plus the MIMO phase slack (the echo phase's and the element term's)
    times the cell's amplitude sum; lanes whose amplitude sums differ
    (another path) at most 1e-4 of all, each bounding its cells."""
    s, rx, params, prim, txp, kw = _mimo_tables(cuda, scene, seed=3)
    n_lanes = 1 << 18
    u = torch.rand((rk.n_draws(kw['max_depth']), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    before = rk.receive_megakernel.by_config['mimo']
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config['mimo'] == before + 1
    assert rk.launched_mimo_kernel()
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    assert acc.shape == ref.shape == (rx.adc.n_time, 1, 16)
    assert rk.grid_mode(rx.adc.n_time, True, True, 8) == \
        (2 if scene == 'global_grid' else 1)
    _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                            rk.phase_slack(s.band, rx.adc, mimo=True),
                            lane, lane_ref, depth=kw['max_depth'])


@pytest.mark.gpu
def test_mimo_kernel_philox_mode(cuda):
    """Two Philox calls with one seed agree per cell within 1e-6 of the
    largest amplitude sum (float64 atomics add in arrival order), and
    with the plain version on the same stream."""
    s, rx, params, prim, txp, kw = _mimo_tables(cuda, 'config6', seed=11)
    n_lanes = 1 << 18
    a1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=11, **kw)
    u = rk.philox_uniforms(11, rk.n_draws(kw['max_depth']), n_lanes,
                           device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, amp_out=amp,
                                           **kw)
    assert int(n1) == int(n2)
    assert float((a1 - a2).abs().max()) <= 1e-6 * float(amp.max())
    _assert_coherent_parity(a1, n1, ref, n_ref, amp,
                            rk.phase_slack(s.band, rx.adc, mimo=True))


@pytest.mark.gpu
def test_mimo_and_mesh_kernels_replace_their_grid_stride_bodies(cuda):
    """The library holds the MIMO array kernel and the mesh kernel and no
    longer the grid-stride instantiations they replaced
    (receive_mimo_kernel<false, false>, receive_trace_kernel<true, false,
    false>: its functions, as `tools/tree_ab.py --sass` reads them); the
    MIMO and mesh media twins keep the grid-stride bodies (the launch
    record)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import tree_ab
    names = set(tree_ab.sass_of(rk.build_library().path))
    assert {'receive_mimo_array_kernel<>', 'receive_mesh_kernel<>',
            'receive_mimo_kernel<1,0>', 'receive_mimo_kernel<0,1>',
            'receive_trace_kernel<1,1,0>',
            'receive_trace_kernel<1,0,1>'} <= names, sorted(names)
    assert 'receive_mimo_kernel<0,0>' not in names
    assert 'receive_trace_kernel<1,0,0>' not in names
    for what in ('mimo', 'mesh'):
        s, rx = mimo_beamform_scene() if what == 'mimo' else \
            mesh_scene(n_side=9)
        s.medium = scenes.stratified_homogeneous()
        sd = s.compile(device='cpu')
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                            rx.id))
        t = lambda a: torch.tensor(a, device=cuda)   # noqa: E731
        kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
                  medium=p.medium)
        if what == 'mimo':
            kw.update(rx_kind='phased', doppler=True, rxph=t(p.rxph),
                      eoff=rk.array_offsets(s, sd, rx, cuda))
        else:
            kw.update(rx_kind='wigner', mesh=p.mesh.to(cuda))
        acc, _ = rk.receive_megakernel(t(p.params), t(p.prim), t(p.txp),
                                       n_lanes=1 << 12, seed=3, **kw)
        torch.cuda.synchronize()
        assert not rk.launched_mimo_kernel() and \
            not rk.launched_mesh_kernel(), what
        assert bool(torch.isfinite(acc).all())


@pytest.mark.gpu
def test_receive_mimo_on_card_meets_config6_anchors(cuda, monkeypatch):
    """receive_mimo on golden config 6 launches K1's MIMO configuration
    once and no wavefront pass; delay-and-sum and MVDR peak within 2 bins
    of the target's azimuth, the DAS mainlobe over 5x its median and
    MVDR sharper, the beamformed profile at 2R / c within 2 bins."""
    import importlib
    recv = importlib.import_module('beifong_tpu_torch.receive')
    passes = []
    orig = recv._receive_mimo_pass
    monkeypatch.setattr(recv, '_receive_mimo_pass',
                        lambda *a, **k: passes.append(1) or orig(*a, **k))
    s, rx = mimo_beamform_scene()
    m = scenes.MIMO
    before = rk.receive_megakernel.by_config['mimo']
    adc, n = receive_mimo(s, spp=m['spp'], max_depth=m['max_depth'],
                          seed=m['seed'], time_sampling='gate')
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config['mimo'] == before + 1
    assert not passes
    assert adc.device.type == 'cuda' and adc.shape == (64, 1, 18)
    cube = develop_mimo(adc, n, rx.adc)
    assert cube.shape == (8, 64, 1) and bool(torch.isfinite(
        torch.view_as_real(cube)).all())
    az, dirs, want = scenes.mimo_azimuth_scan(device=cuda)
    offs = rk.array_offsets(s, s.compile(device=cuda), rx, cuda)
    B = bf.delay_and_sum(cube, offs, dirs, m['fc'], s.band.c)
    das = (B.abs() ** 2).sum(dim=(1, 2))
    mvdr = bf.mvdr_spectrum(cube, offs, dirs, m['fc'], s.band.c)
    assert abs(int(das.argmax()) - want) <= 2
    assert abs(int(mvdr.argmax()) - want) <= 2
    sharp_das = float(das.max() / das.median())
    assert sharp_das > 5.0
    assert float(mvdr.max() / mvdr.median()) > sharp_das
    y = B[int(das.argmax()), :, 0].abs() ** 2
    cfg = rx.adc
    t_pk = (int(y.argmax()) + 0.5) / cfg.n_time * cfg.sampling_time
    assert abs(t_pk - 2 * m['R'] / s.band.c) <= 2 * cfg.sampling_time \
        / cfg.n_time


# ---------------------------------------------------------------------------
# ambient media: the media twin of every K1 configuration
# ---------------------------------------------------------------------------


MEDIA_KINDS = ('homogeneous', 'layered', 'grid')
# configuration: (scene, doppler, coherent)
MEDIA_CONFIGS = {
    'flagship': (lambda: flagship_scene(ground=False), False, False),
    'mesh': (lambda: mesh_scene(n_side=23), False, False),
    'doppler': (range_doppler_scene, True, False),
    'doppler_mesh': (multi_body_scene, True, False),
    'coherent': (lambda: flagship_scene(ground=False), True, True),
    'coherent_mesh': (lambda: mesh_scene(n_side=23), True, True),
    'mimo': (mimo_beamform_scene, True, False),
}


def _media_tables(device, config, kind, seed=3):
    fn, doppler, coherent = MEDIA_CONFIGS[config]
    s, rx = fn()
    s.medium = scenes.seeded_medium(kind)
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert p.medium == s.medium.kind
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    mesh = None if p.mesh is None else p.mesh.to(device)
    mimo = config == 'mimo'
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='phased' if mimo else 'wigner', mesh=mesh,
              doppler=doppler,
              msh=torch.tensor(p.msh, device=device)
              if mesh is not None and doppler else None,
              coherent=coherent, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, medium=p.medium,
              grid=None if p.grid is None
              else torch.tensor(p.grid, device=device))
    if mimo:
        kw.update(rxph=torch.tensor(p.rxph, device=device),
                  eoff=rk.array_offsets(s, sd, rx, device))
    return (s, rx, params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw)


def _assert_media_parity(config, s, rx, acc, n_ev, ref, n_ref, amp, lane,
                         lane_ref, ill=None):
    """The configuration's own parity; lane by lane, the lanes of the
    mask `ill` (the plain version's `ill_out`: lanes with an
    ill-conditioned optical depth, a near-horizontal layered segment or a
    grid sample on a cell's edge, which an ulp of their inputs moves by
    more than 1e-4 and FMA contraction moves those inputs) may take
    another path beside the 1e-4 of the lanes that any lane may be; every
    lane that does bounds its cells as edge flips do."""
    mimo = config == 'mimo'
    if MEDIA_CONFIGS[config][2] or mimo:
        _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                rk.phase_slack(s.band, rx.adc, mimo=mimo),
                                lane, lane_ref, ill=ill)
    elif lane is not None:
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref, ill=ill)
    else:
        scale = float(ref.abs().max())
        assert scale > 0 and int(n_ref) > 0
        assert float((acc - ref).abs().max()) <= 1e-4 * scale
        assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', MEDIA_KINDS)
@pytest.mark.parametrize('config', list(MEDIA_CONFIGS))
def test_media_kernels_match_plain_version(cuda, config, kind):
    """Each configuration's media twin on injected uniforms against the
    plain version, with the configuration's own bound (lane by lane where
    the kernel reports lane sums)."""
    s, rx, params, prim, txp, kw = _media_tables(cuda, config, kind)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(2), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(5),
                   device=cuda)
    lanes = kw['doppler'] or kw['mesh'] is not None
    lane = torch.empty(n_lanes, device=cuda) if lanes else None
    lane_ref = torch.empty(n_lanes, device=cuda) if lanes else None
    ill = torch.zeros(n_lanes, dtype=torch.bool, device=cuda) \
        if lanes else None
    name = rk.config_name(kw['mesh'] is not None, kw['doppler'],
                          kw['coherent'], config == 'mimo', medium=True)
    assert name == config + '_media'
    before = rk.receive_megakernel.by_config[name]
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config[name] == before + 1
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64,
                      device=cuda)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, stats=stats, ill_out=ill,
        amp_out=amp if kw['coherent'] or config == 'mimo' else None, **kw)
    assert stats['med_seg'] > 0 and stats['med_conn'] > 0
    _assert_media_parity(config, s, rx, acc, n_ev, ref, n_ref, amp, lane,
                         lane_ref, ill=ill)


@pytest.mark.gpu
@pytest.mark.parametrize('config', ['flagship', 'coherent'])
@pytest.mark.parametrize('kind', MEDIA_KINDS)
def test_media_kernels_philox_mode(cuda, config, kind):
    """The media twins on the Philox stream against the plain version on
    the same stream."""
    s, rx, params, prim, txp, kw = _media_tables(cuda, config, kind)
    n_lanes = 1 << 18
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      seed=13, **kw)
    u = rk.philox_uniforms(13, rk.n_draws(2), n_lanes, device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, amp_out=amp if kw['coherent'] else None, **kw)
    _assert_media_parity(config, s, rx, acc, n_ev, ref, n_ref, amp, None,
                         None)


@pytest.mark.gpu
def test_example_attenuation_on_card(cuda):
    """examples/stratified_medium.py on the card: receive() through K1's
    media twin (one launch) and its vacuum configuration; the echo
    attenuation within 10% of the closed form 0.263."""
    prof = []
    for med in (None, scenes.stratified_layers()):
        s, rx = scenes.stratified_medium_scene(med)
        name = 'flagship' + ('_media' if med is not None else '')
        before = rk.receive_megakernel.by_config[name]
        a, n = receive(s, receiver=rx, spp=1 << 20, max_depth=2, seed=1)
        torch.cuda.synchronize()
        assert rk.receive_megakernel.by_config[name] == before + 1
        assert a.device.type == 'cuda' and bool(torch.isfinite(a).all())
        prof.append(develop_signal(a, n, rx.adc)[:, 0, 0].cpu().numpy())
    s, rx = scenes.stratified_medium_scene()
    want = scenes.two_leg_transmittance(s, rx, scenes.stratified_layers())
    att = scenes.echo_attenuation(*prof)
    assert abs(att / want - 1.0) < 0.10, (att, want)


# ---------------------------------------------------------------------------
# the endpoint twins: several transmitters, phased and area transmitters,
# an analog phased receiver
# ---------------------------------------------------------------------------


def _ep_scene(name, mesh=False):
    """The endpoint scenes (`scenes.py`; phased_tx_mixer under a mixer
    with an LO, `scenes.mixer_receiver`), with a crumpled 5 x 5 grid of
    triangles added beside the target for the mesh twins."""
    if name.startswith('phased_tx'):
        s, rx = scenes.phased_tx_scene(scenes.steer_toward(
            scenes.PHASED['tx'], scenes.phased_tx_target()),
            moving_ggx=name == 'phased_tx_ggx')
        if name == 'phased_tx_mixer':
            s, rx = scenes.mixer_receiver(s, rx)
    elif name == 'phased_rx':
        s, rx = scenes.phased_rx_scene(scenes.PHASED['rx_az'])
    else:
        s, rx = scenes.four_tx_scene()
    if mesh:
        import numpy as np
        from beifong_tpu_torch.core import transform as tf
        from beifong_tpu_torch.geometry.mesh import MeshSpec, make_grid
        v, f = make_grid(5, 5)
        v = np.asarray(v, np.float32)
        v[:, 2] += 0.05 * np.sin(7.0 * v[:, 0] + 3.0 * v[:, 1])
        s.add(MeshSpec(v, np.asarray(f), bsdf='mat', to_world=np.asarray(
            tf.compose(tf.look_at([-0.6, -3.5, 0.2], [0.0, 0.0, 0.0]),
                       tf.scale(0.4)))))
    return s, rx


# configuration: (mesh, doppler, coherent)
EP_CONFIGS = {'flagship': (False, False, False), 'mesh': (True, False, False),
              'doppler': (False, True, False),
              'doppler_mesh': (True, True, False),
              'coherent': (False, True, True),
              'coherent_mesh': (True, True, True)}


def _ep_tables(device, scene, config, seed=3):
    mesh, doppler, coherent = EP_CONFIGS[config]
    s, rx = _ep_scene(scene, mesh)
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert (p.mesh is not None) == mesh
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    m = None if p.mesh is None else p.mesh.to(device)
    rx_kind = rk.rx_kind_of(rx)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate', rx_kind=rx_kind,
              mesh=m, doppler=doppler,
              msh=torch.tensor(p.msh, device=device)
              if m is not None and doppler else None, coherent=coherent,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None,
              php=torch.tensor(p.php, device=device),
              rxph=torch.tensor(p.rxph, device=device)
              if rx_kind == 'phased' else None)
    return (s, rx, params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw)


def _assert_ep_parity(s, rx, kw, acc, n_ev, ref, n_ref, amp, lane, lane_ref):
    """The configuration's own bound: I / Q with the phase slack, lane by
    lane where the kernel reports lane sums, power to 1e-4 x max|acc|."""
    if kw['coherent']:
        _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                rk.phase_slack(s.band, rx.adc), lane,
                                lane_ref)
    elif lane is not None:
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref)
    else:
        scale = float(ref.abs().max())
        assert scale > 0 and int(n_ref) > 0
        assert float((acc - ref).abs().max()) <= 1e-4 * scale
        assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


EP_SCENES = ('phased_tx', 'four_tx', 'phased_rx')


@pytest.mark.gpu
@pytest.mark.parametrize('config', list(EP_CONFIGS))
@pytest.mark.parametrize('scene', EP_SCENES)
def test_endpoint_kernels_match_plain_version(cuda, scene, config):
    """Each configuration's endpoint twin on injected uniforms (n_draws of
    the scene's transmitters) against the plain version, with the
    configuration's own bound (lane by lane where the kernel reports lane
    sums)."""
    s, rx, params, prim, txp, kw = _ep_tables(cuda, scene, config)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(2, int(txp.shape[0])), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(5),
                   device=cuda)
    lanes = kw['doppler'] or kw['mesh'] is not None
    lane = torch.empty(n_lanes, device=cuda) if lanes else None
    lane_ref = torch.empty(n_lanes, device=cuda) if lanes else None
    name = rk.config_name(kw['mesh'] is not None, kw['doppler'],
                          kw['coherent'], ep=True)
    assert name == config + '_ep'
    before = rk.receive_megakernel.by_config[name]
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config[name] == before + 1
    # the analytic power and I / Q twins run the endpoint kernels, whose
    # repeats are bit-identical (private rows summed in thread order)
    ep_kernel = config in ('flagship', 'coherent')
    assert rk.launched_endpoint_kernel(kw['coherent']) == ep_kernel
    assert rk.launched_endpoint_kernel(not kw['coherent']) is False
    if ep_kernel:
        lane2 = torch.empty(n_lanes, device=cuda) if lanes else None
        acc2, n_ev2 = rk.receive_megakernel(params, prim, txp,
                                            n_lanes=n_lanes, uniforms=u,
                                            lane_out=lane2, **kw)
        assert torch.equal(acc, acc2) and int(n_ev) == int(n_ev2)
        if lanes:
            assert torch.equal(lane, lane2)
    amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq), dtype=torch.float64,
                      device=cuda)
    stats = {}
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, stats=stats,
        amp_out=amp if kw['coherent'] else None, **kw)
    assert stats['nee'] > 0
    if scene != 'four_tx':
        assert stats['pair_terms'] > 0
    _assert_ep_parity(s, rx, kw, acc, n_ev, ref, n_ref, amp, lane, lane_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('config', ['coherent', 'doppler'])
def test_endpoint_kernels_under_a_mixer(cuda, config):
    """The phased transmitter under a mixer with an LO (a beat drawn a
    lane; `scenes.mixer_receiver`): the coherent endpoint kernel and the
    Doppler power endpoint twin against the plain version, as
    test_endpoint_kernels_match_plain_version holds the raw scenes."""
    test_endpoint_kernels_match_plain_version(cuda, 'phased_tx_mixer',
                                              config)


@pytest.mark.gpu
@pytest.mark.parametrize('config', ['coherent', 'doppler'])
def test_endpoint_kernels_on_a_moving_ggx_target(cuda, config):
    """The phased transmitter with its target a GGX rough conductor
    closing at 5 m/s (`scenes.phased_tx_scene(moving_ggx=True)`): the
    coherent endpoint kernel (I / Q) and the Doppler power endpoint twin
    against the plain version, as test_endpoint_kernels_match_plain_version
    holds the static scenes; the lanes take the GGX lobe and the
    target's Doppler factor."""
    test_endpoint_kernels_match_plain_version(cuda, 'phased_tx_ggx', config)
    s, rx, params, prim, txp, kw = _ep_tables(cuda, 'phased_tx_ggx', config)
    u = torch.rand((rk.n_draws(2, int(txp.shape[0])), 1 << 12),
                   generator=torch.Generator(cuda).manual_seed(5),
                   device=cuda)
    stats = {}
    rk.receive_megakernel_ref(params, prim, txp, u, stats=stats, **kw)
    assert stats['ggx_nee'] > 0 and stats['ggx_bounce'] > 0
    assert stats['dop_nee'] > 0


@pytest.mark.gpu
@pytest.mark.parametrize('scene', EP_SCENES)
def test_endpoint_kernels_philox_mode(cuda, scene):
    """The coherent endpoint twin on the Philox stream (its stride of
    n_draws(depth, n_tx) rows) against the plain version on the same
    stream, lane by lane."""
    s, rx, params, prim, txp, kw = _ep_tables(cuda, scene, 'coherent')
    n_lanes = 1 << 18
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      seed=13, lane_out=lane, **kw)
    assert rk.launched_endpoint_kernel(True)
    u = rk.philox_uniforms(13, rk.n_draws(2, int(txp.shape[0])), n_lanes,
                           device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    _assert_ep_parity(s, rx, kw, acc, n_ev, ref, n_ref, amp, lane, lane_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', (False, True))
def test_endpoint_cpi_runs_the_endpoint_kernel(cuda, coherent):
    """A 4-pulse CPI of the phased transmitter through
    receive_megakernel_cpi: one launch of the endpoint kernel (the pulse a
    grid axis) against the plain version pulse by pulse."""
    s, rx = _ep_scene('phased_tx')
    pc, rx, _ = rk.pack_cpi(s, 4, 10.0)
    t = lambda a: torch.tensor(a, device=cuda)   # noqa: E731
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind=rk.rx_kind_of(rx), doppler=coherent,
              coherent=coherent, php=t(pc.php))
    n_lanes = 1 << 16
    u = torch.rand((4, rk.n_draws(2, int(pc.txp.shape[1])), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(9),
                   device=cuda)
    name = rk.config_name(False, coherent, coherent, ep=True)
    before = rk.receive_megakernel_cpi.by_config[name]
    acc, n_ev = rk.receive_megakernel_cpi(t(pc.params), t(pc.prim),
                                          t(pc.txp), n_lanes=n_lanes,
                                          uniforms=u, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel_cpi.by_config[name] == before + 1
    assert rk.launched_endpoint_kernel(coherent)
    for p in range(4):
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(
            t(pc.params[p]), t(pc.prim[p]), t(pc.txp[p]), u[p],
            amp_out=amp if coherent else None, **kw)
        _assert_ep_parity(s, rx, kw, acc[p], n_ev[p], ref, n_ref, amp,
                          None, None)


@pytest.mark.gpu
def test_endpoint_mimo_kernel_matches_plain_version(cuda):
    """Config 6's array with a second (area) transmitter: the MIMO
    configuration's endpoint twin against the plain version, all 16
    channels, lane by lane."""
    import numpy as np
    from beifong_tpu_torch.core import transform as tf
    from beifong_tpu_torch.geometry import shapes as sh
    from beifong_tpu_torch.radar import area_transmitter
    s, rx = mimo_beamform_scene()
    s.add(area_transmitter('tx2', s.transmitters[0].waveform,
                           resample_freq=True))
    s.add(sh.rectangle(to_world=np.asarray(tf.compose(
        tf.look_at([-0.1, 0, 0], [-0.1, -1, 0]),
        tf.scale([0.004, 0.004, 1.0]))), transmitter='tx2'))
    sd = s.compile(device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    t = lambda a: torch.tensor(a, device=cuda)   # noqa: E731
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='phased', doppler=True, rxph=t(p.rxph),
              eoff=rk.array_offsets(s, sd, rx, cuda), php=t(p.php))
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(2, 2), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(7),
                   device=cuda)
    lane = torch.empty(n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    before = rk.receive_megakernel.by_config['mimo_ep']
    acc, n_ev = rk.receive_megakernel(t(p.params), t(p.prim), t(p.txp),
                                      n_lanes=n_lanes, uniforms=u,
                                      lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config['mimo_ep'] == before + 1
    assert not rk.launched_mimo_kernel()
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(t(p.params), t(p.prim), t(p.txp),
                                           u, lane_out=lane_ref, amp_out=amp,
                                           **kw)
    _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                            rk.phase_slack(s.band, rx.adc, mimo=True), lane,
                            lane_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', EP_SCENES)
def test_receive_of_endpoint_scenes_on_card_launches_k1(cuda, scene):
    """receive() on the card runs the endpoint twin once and no wavefront
    pass, and agrees with the CPU's plain version on one seed (peak bin,
    window energy within 1e-3)."""
    s, rx = _ep_scene(scene)
    before = dict(rk.receive_megakernel.by_config)
    a, n = receive(s, s.compile(device=cuda), rx, spp=1 << 16, max_depth=2,
                   seed=4, time_sampling='gate', device=cuda)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config['flagship_ep'] \
        == before['flagship_ep'] + 1
    assert rk.launched_endpoint_kernel(False)
    b, m = receive(s, s.compile(device='cpu'), rx, spp=1 << 16,
                   max_depth=2, seed=4, time_sampling='gate', device='cpu')
    p_gpu = develop_signal(a, n, rx.adc)[:, 0, 0].cpu()
    p_cpu = develop_signal(b, m, rx.adc)[:, 0, 0]
    assert int(p_gpu.abs().argmax()) == int(p_cpu.abs().argmax())
    assert float((p_gpu - p_cpu).abs().max()) \
        <= 1e-3 * float(p_cpu.abs().max())


# ---------------------------------------------------------------------------
# the lobe twins: smooth and thin dielectric, plastic, rough plastic, GGX
# glass, blend and mask in the Doppler family
# ---------------------------------------------------------------------------


# scene, depth, and whether its echo is the corner's delta chain (whose
# lanes are flagged past 1e-3 of the largest, as the mirror corner's)
LOBE_SCENES = {
    'window_thin': (lambda: scenes.window_corner_scene('thin'), 6, True),
    'window_dielectric': (lambda: scenes.window_corner_scene('dielectric'),
                          6, True),
    'plastic': (lambda: scenes.plastic_scene('plastic'), 2, False),
    'rough_plastic': (lambda: scenes.plastic_scene('rough_plastic'), 2,
                      False),
    'rough_dielectric': (lambda: scenes.rough_dielectric_scene('target'), 2,
                         False),
    'through': (lambda: scenes.rough_dielectric_scene('through'), 2, False),
    'blend': (lambda: scenes.composite_scene('blend'), 2, False),
    'mask': (lambda: scenes.composite_scene('mask', 0.4), 2, False),
    'mesh': (lambda: mesh_scene(n_side=23, material='rough_plastic'), 2,
             False),
    # under a mixer with an LO: a beat drawn a lane before the ray's draws
    'rough_plastic_mixer': (lambda: scenes.mixer_receiver(
        *scenes.plastic_scene('rough_plastic')), 2, False),
}


def _lobe_tables(device, scene, coherent, seed=3):
    fn, depth, chain = LOBE_SCENES[scene]
    s, rx = fn()
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    assert p.lobes and p.doppler(rx.adc)
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(seed)
    mesh = None if p.mesh is None else p.mesh.to(device)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
              rx_kind=rk.rx_kind_of(rx), mesh=mesh, doppler=True,
              msh=None if mesh is None else torch.tensor(p.msh,
                                                         device=device),
              coherent=coherent, mirror=p.mirror, lobes=p.lobes,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None)
    return (s, rx, params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw, chain)


def _assert_lobe_parity(s, rx, kw, chain, acc, n_ev, ref, n_ref, amp, lane,
                        lane_ref, ill):
    """Lane by lane: a lane beyond 1e-4 of itself (and 1e-6 of the largest
    lane; 1e-4 on the corner's delta chains, whose transmitter aperture
    sinc moves near its zeros; 1e-3 for I / Q) took another path; lanes
    of `ill` (a Fresnel pick, total internal reflection or a cosine's
    sign within LOBE_TIE) may besides the 1e-4 of the lanes any lane may,
    and every such lane bounds its cells.  A corner's power cell sums
    signed WDF contributions that cancel to 1/8-1/80 of their magnitudes,
    so each cell may also move by 1e-4 of its own sum of |power| (`amp`,
    the plain version's), the share each contribution may move by
    (chip_smoke.py's corner_readings reads this bound on both sides)."""
    if kw['coherent']:
        _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                rk.phase_slack(s.band, rx.adc), lane,
                                lane_ref, depth=kw['max_depth'], ill=ill)
    else:
        _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref,
                            depth=kw['max_depth'],
                            floor=1e-4 if chain else 1e-6, ill=ill,
                            cell_slack=1e-4 * amp.float() if chain else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
@pytest.mark.parametrize('scene', list(LOBE_SCENES))
def test_lobe_kernels_match_plain_version(cuda, scene, coherent):
    """Each lobe scene through its lobe twin (doppler / coherent, analytic
    or mesh) on injected uniforms of the lobe draw stride, against the
    plain version, lane by lane."""
    s, rx, params, prim, txp, kw, chain = _lobe_tables(cuda, scene,
                                                       coherent)
    n_lanes = 1 << 16
    nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
    u = torch.rand((nd, n_lanes),
                   generator=torch.Generator(cuda).manual_seed(5),
                   device=cuda)
    name = rk.config_name(kw['mesh'] is not None, True, coherent,
                          lobes=True)
    before = rk.receive_megakernel.by_config[name]
    lane = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config[name] == before + 1
    lane_ref = torch.empty(n_lanes, device=cuda)
    ill = torch.zeros(n_lanes, dtype=torch.bool, device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, ill_out=ill, amp_out=amp,
        **kw)
    _assert_lobe_parity(s, rx, kw, chain, acc, n_ev, ref, n_ref, amp, lane,
                        lane_ref, ill)


@pytest.mark.gpu
@pytest.mark.parametrize('scene, coherent', [
    ('window_dielectric', False), ('through', True), ('mesh', False),
    ('mesh', True)])
def test_lobe_kernels_philox_mode(cuda, scene, coherent):
    """The four lobe twins on the Philox stream at 2^20 lanes (its stride
    of the lobe draws) against the plain version on the same stream, lane
    by lane."""
    s, rx, params, prim, txp, kw, chain = _lobe_tables(cuda, scene,
                                                       coherent, seed=13)
    n_lanes = 1 << 20
    if kw['mesh'] is not None:
        kw['patch_p'] = rk.patch_p_for(n_lanes)
    lane = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      seed=13, lane_out=lane, **kw)
    nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
    u = rk.philox_uniforms(13, nd, n_lanes, device=cuda)
    lane_ref = torch.empty(n_lanes, device=cuda)
    ill = torch.zeros(n_lanes, dtype=torch.bool, device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, ill_out=ill, amp_out=amp,
        **kw)
    _assert_lobe_parity(s, rx, kw, chain, acc, n_ev, ref, n_ref, amp, lane,
                        lane_ref, ill)


@pytest.mark.gpu
@pytest.mark.parametrize('scene', ['window_thin', 'plastic', 'through',
                                   'mask'])
def test_receive_of_lobe_scenes_on_card_launches_k1(cuda, scene):
    """receive() on the card runs the lobe twin once and no wavefront
    pass, and agrees with the CPU's plain version on one seed: the peak
    bin, and each bin within 1e-3 of the largest (the windowed corner:
    its peak window's energy within 1e-2)."""
    fn, depth, _ = LOBE_SCENES[scene]
    s, rx = fn()
    before = dict(rk.receive_megakernel.by_config)
    a, n = receive(s, s.compile(device=cuda), rx, spp=1 << 16,
                   max_depth=depth, seed=4, time_sampling='gate',
                   device=cuda)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.by_config['doppler_lobes'] \
        == before['doppler_lobes'] + 1
    b, m = receive(s, s.compile(device='cpu'), rx, spp=1 << 16,
                   max_depth=depth, seed=4, time_sampling='gate',
                   device='cpu')
    p_gpu = develop_signal(a, n, rx.adc)[:, 0, 0].cpu()
    p_cpu = develop_signal(b, m, rx.adc)[:, 0, 0]
    pk = int(p_cpu.abs().argmax())
    assert int(p_gpu.abs().argmax()) == pk
    if LOBE_SCENES[scene][2]:
        # the corner's bins sum signed WDF contributions that cancel to
        # 1/8-1/80 of their magnitudes (test_lobe_kernels_match_plain_
        # version holds them lane by lane): its peak window's energy
        e_gpu = float(p_gpu[max(pk - 3, 0):pk + 4].abs().sum())
        e_cpu = float(p_cpu[max(pk - 3, 0):pk + 4].abs().sum())
        bins = float((p_gpu - p_cpu).abs().max()) \
            / float(p_cpu.abs().max())
        print(f'{scene}: card against CPU, peak window energy '
              f'{abs(e_gpu - e_cpu) / e_cpu:.3e} of itself, bins '
              f'{bins:.3e} of the largest')
        assert abs(e_gpu - e_cpu) <= 1e-2 * e_cpu
        return
    assert float((p_gpu - p_cpu).abs().max()) \
        <= 1e-3 * float(p_cpu.abs().max())


@pytest.mark.gpu
def test_windowed_corner_cpi_is_one_lobe_launch(cuda):
    """A CPI of the windowed corner through receive_cpi on the card: one
    launch of the coherent lobe twin, equal to the plain version's CPI
    within the coherent bound, its peak on the unwindowed corner's."""
    s, rx = scenes.window_corner_scene('thin')
    before = rk.receive_megakernel_cpi.by_config['coherent_lobes']
    kw = dict(n_pulses=4, prf=10.0, seed=9, spp=1 << 16, max_depth=6,
              time_sampling='gate')
    cube, n = receive_cpi(s, device=cuda, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel_cpi.by_config['coherent_lobes'] \
        == before + 1
    ref, m = receive_cpi(s, device='cpu', **kw)
    assert n == m and cube.shape == ref.shape == (4, 64, 1, 4)
    e_gpu = (cube[..., 0] ** 2 + cube[..., 1] ** 2).sum(0)[:, 0].cpu()
    e_cpu = (ref[..., 0] ** 2 + ref[..., 1] ** 2).sum(0)[:, 0]
    assert int(e_gpu.argmax()) == int(e_cpu.argmax())
    s0, rx0 = scenes.window_corner_scene()
    a, n0 = receive(s0, s0.compile(device=cuda), rx0, spp=1 << 16,
                    max_depth=6, seed=9, time_sampling='gate', device=cuda)
    assert abs(int(e_gpu.argmax())
               - int(develop_signal(a, n0, rx0.adc)[:, 0, 0].argmax())) <= 1


# the analytic lobe twins' kernel of their own (receive_lobe_kernel<COH>):
# its warp rows, its launch record, its grids


@pytest.mark.gpu
@pytest.mark.parametrize('scene, coherent', [
    ('window_thin', False), ('window_dielectric', True), ('plastic', False)])
def test_lobe_kernel_philox_repeats_are_bit_identical(cuda, scene, coherent):
    """Two Philox calls of an analytic lobe twin with one seed give the
    same bits and events: the 1-D grid sums in warp rows, each bin's taps
    in lane order."""
    s, rx, params, prim, txp, kw, _ = _lobe_tables(cuda, scene, coherent,
                                                   seed=17)
    assert rk.coherent_warp_rows(rx.adc, coherent)
    n_lanes = 1 << 20
    a1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=17, **kw)
    a2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                   seed=17, **kw)
    torch.cuda.synchronize()
    assert rk.launched_lobe_kernel(coherent)
    assert int(n1) == int(n2) > 0
    assert torch.equal(a1, a2)


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_lobe_scenes_launch_the_lobe_kernel(cuda, coherent):
    """Analytic lobe scenes launch receive_lobe_kernel<COH> (the library's
    launch record), a mesh lobe scene the mesh Doppler kernel <COH, true>;
    the library holds the lobe kernel and the mesh Doppler kernel's
    instantiation, and no grid-stride lobe twin, analytic or mesh (its
    functions, as `tools/tree_ab.py --sass` reads them)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import tree_ab
    for scene, analytic in (('window_thin', True), ('blend', True),
                            ('mesh', False)):
        s, rx, params, prim, txp, kw, _ = _lobe_tables(cuda, scene,
                                                       coherent)
        rk.receive_megakernel(params, prim, txp, n_lanes=1 << 12, seed=3,
                              **kw)
        torch.cuda.synchronize()
        assert rk.launched_lobe_kernel(coherent) == analytic, scene
        assert rk.launched_lobe_kernel(not coherent) is False
        assert rk.launched_mesh_doppler_kernel(True, coherent) \
            == (not analytic), scene
    names = set(tree_ab.sass_of(rk.build_library().path))
    c = int(coherent)
    # the coherent kernel (its untextured, rectangle-only instantiation,
    # <false, false>)
    assert 'receive_coherent_kernel<0,0>' in names, sorted(names)
    assert f'receive_lobe_kernel<{c}>' in names
    assert f'receive_doppler_kernel<0,{c},0,0,1>' not in names
    assert f'receive_doppler_kernel<1,{c},0,0,1>' not in names
    assert f'receive_mesh_doppler_kernel<{c},1>' in names


@pytest.mark.gpu
@pytest.mark.parametrize('n_freq, coherent', [(8, False), (8, True),
                                              (300, False)])
def test_lobe_kernel_grids_match_plain_version(cuda, n_freq, coherent):
    """The thin windowed corner on a 2-D grid (n_freq 8: the block's grid
    of atomics) and on a global one (n_freq 300: mode 2), against the
    plain version on injected uniforms, lane by lane."""
    s, rx, params, prim, txp, kw, chain = _lobe_tables(cuda, 'window_thin',
                                                       coherent)
    adc = dataclasses.replace(rx.adc, n_freq=n_freq)
    kw['adc'] = adc
    mode = rk.grid_mode(adc.n_time * n_freq, True, coherent)
    assert mode == (2 if n_freq == 300 else 1)
    n_lanes = 1 << 16
    nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
    u = torch.rand((nd, n_lanes),
                   generator=torch.Generator(cuda).manual_seed(11),
                   device=cuda)
    lane = torch.empty(n_lanes, device=cuda)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, lane_out=lane, **kw)
    torch.cuda.synchronize()
    assert rk.launched_lobe_kernel(coherent)
    lane_ref = torch.empty(n_lanes, device=cuda)
    ill = torch.zeros(n_lanes, dtype=torch.bool, device=cuda)
    amp = torch.zeros((adc.n_time, n_freq), dtype=torch.float64,
                      device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, ill_out=ill, amp_out=amp,
        **kw)
    _assert_lobe_parity(s, types.SimpleNamespace(adc=adc), kw, chain, acc,
                        n_ev, ref, n_ref, amp, lane, lane_ref, ill)


# ---- the texture twins: checkerboard and bitmap rectangles ----


def _tex_tables(device, texture, coherent, seed=0):
    """The flagship scene with a textured ground (`ground_texture`), its
    tables and texel rows on `device`, and the call's keywords: the
    flagship configuration at depth 3, or the coherent one at depth 2."""
    s, rx = flagship_scene(ground_texture=texture)
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, device)
    kw = dict(adc=rx.adc, max_depth=2 if coherent else 3,
              time_sampling='gate', rx_kind='wigner', doppler=coherent,
              coherent=coherent, tex=tab.tex, bmp_meta=tab.bmp_meta)
    return s, rx, tab, kw


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
@pytest.mark.parametrize('texture', ['checkerboard', 'bitmap'])
def test_texture_twins_match_plain_version(cuda, texture, coherent):
    """receive_flagship_kernel<true> (power) and receive_coherent_kernel<
    true> (I / Q) on injected uniforms and on Philox against the plain
    version: power per cell within 1e-4 x max|acc|, I / Q within 1e-4 x
    max(|I|, |Q|) plus the phase slack times the cell's amplitude sum; the
    launch record and the configuration's count."""
    s, rx, tab, kw = _tex_tables(cuda, texture, coherent)
    name = 'coherent_tex' if coherent else 'flagship_tex'
    for n_lanes, u in ((1 << 16, torch.rand(
            (rk.n_draws(kw['max_depth']), 1 << 16),
            generator=torch.Generator(cuda).manual_seed(5), device=cuda)),
            ((1 << 20) + 77, None)):
        before = rk.receive_megakernel.by_config[name]
        acc, n_ev = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                          n_lanes=n_lanes, uniforms=u,
                                          seed=11, **kw)
        torch.cuda.synchronize()
        assert rk.launched_tex_kernel(coherent)
        assert not rk.launched_tex_kernel(not coherent)
        assert rk.receive_megakernel.by_config[name] == before + 1
        if u is None:
            u = rk.philox_uniforms(11, rk.n_draws(kw['max_depth']), n_lanes,
                                   device=cuda)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, u,
            amp_out=amp if coherent else None, **kw)
        assert acc.shape == ref.shape
        if coherent:
            _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                    rk.phase_slack(s.band, rx.adc))
        else:
            scale = float(ref.abs().max())
            assert scale > 0 and int(n_ref) > 0
            assert float((acc - ref).abs().max()) <= 1e-4 * scale
            assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_texture_twin_anchors(cuda, coherent):
    """On the card: a uniform checkerboard (1.0 / 1.0) through the
    texture twin is the untextured scene through its kernel, bit for bit
    (warp rows in a fixed order, the same draws); a constant bitmap of
    0.7 and the uniform checkerboard of 0.7 through the twin, and an
    untextured ground of reflectance 0.7 through the untextured kernel,
    agree to 1e-5 (a twin that left the texture out would give the ground
    1.0); the checkerboard and the bitmap move the grid by more than 100 x
    the parity bound (1e-4 x max|acc|) and keep the target's peak on bin
    26."""
    from beifong_tpu_torch import textures as tx
    from beifong_tpu_torch.bsdf.tables import diffuse

    def grid(texture):
        if texture in ('checkerboard', 'bitmap', None):
            s, rx = flagship_scene(ground_texture=texture)
        else:
            s, rx = flagship_scene()
            if texture == 'plain07':
                s.add(diffuse('gnd', reflectance=0.7, twosided=True))
            else:
                s.add({'uniform': tx.checkerboard('t', 1.0, 1.0),
                       'uniform07': tx.checkerboard('t', 0.7, 0.7),
                       'constant': tx.bitmap('t', np.full(
                           (8, 8), 0.7, np.float32))}[texture])
                s.add(diffuse('gnd', reflectance=1.0, twosided=True,
                              texture='t'))
            s.shapes[-1].bsdf = 'gnd'
        tab = rk._device_tables(s, s.compile(device='cpu'), rx, cuda)
        acc, _ = rk.receive_megakernel(
            tab.params, tab.prim, tab.txp, adc=rx.adc,
            max_depth=2 if coherent else 3, time_sampling='gate',
            rx_kind='wigner', n_lanes=1 << 22, seed=7, doppler=coherent,
            coherent=coherent, tex=tab.tex, bmp_meta=tab.bmp_meta)
        torch.cuda.synchronize()
        assert rk.launched_tex_kernel(coherent) == (
            texture not in (None, 'plain07'))
        return acc

    base = grid(None)
    assert torch.equal(grid('uniform'), base)
    const, unif07, plain07 = (grid(t) for t in
                              ('constant', 'uniform07', 'plain07'))
    for a, b in ((const, unif07), (const, plain07), (unif07, plain07)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for texture in ('checkerboard', 'bitmap'):
        got = grid(texture)
        moved = float((got - base).abs().max())
        assert moved > 100 * 1e-4 * float(base.abs().max()), texture
        power = got[:, 0] if not coherent else got[:, 0].square().sum(-1)
        assert int(power.argmax()) == 26, texture


@pytest.mark.gpu
def test_textured_receive_launches_the_texture_twins(cuda):
    """receive() of a textured flagship scene launches the texture twins,
    in power and in I / Q, and the untextured one its kernels; the
    library holds both instantiations of each kernel (its functions, as
    `tools/tree_ab.py --sass` reads them)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import tree_ab
    for texture in ('bitmap', None):
        s, rx = flagship_scene(ground_texture=texture)
        for coherent in (False, True):
            adc, n = receive(s, receiver=rx, spp=1 << 16, max_depth=2,
                             coherent=coherent, time_sampling='gate',
                             device=cuda)
            torch.cuda.synchronize()
            assert rk.launched_tex_kernel(coherent) == (texture is not None)
            assert bool(torch.isfinite(adc).all()) and n == 1 << 16
    names = set(tree_ab.sass_of(rk.build_library().path))
    assert {'receive_flagship_kernel<0,0>', 'receive_flagship_kernel<1,0>',
            'receive_coherent_kernel<0,0>',
            'receive_coherent_kernel<1,0>'} <= names, sorted(names)


def _prim_tables(device, target, coherent):
    """The flagship scene with `target` ('plate', 'sphere', 'disk',
    'cylinder'; 'sphere_checker' the sphere over a checkerboard ground;
    None: no target) at 4 m, its tables on `device`, and the call's
    keywords: the flagship configuration at depth 3, or the coherent one
    at depth 2."""
    ground = 'checkerboard' if target == 'sphere_checker' else None
    s, rx = flagship_scene(target=(target or 'plate').split('_')[0],
                           ground_texture=ground)
    if target is None:
        del s.shapes[2]
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, device)
    kw = dict(adc=rx.adc, max_depth=2 if coherent else 3,
              time_sampling='gate', rx_kind='wigner', doppler=coherent,
              coherent=coherent)
    if tab.textured:
        kw.update(tex=tab.tex, bmp_meta=tab.bmp_meta)
    return s, rx, tab, kw


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
@pytest.mark.parametrize('target', ['sphere', 'disk', 'cylinder',
                                    'sphere_checker'])
def test_prims_twins_match_plain_version(cuda, target, coherent):
    """receive_flagship_kernel<false, true> (power) and
    receive_coherent_kernel<false, true> (I / Q), and over the
    checkerboard the twins that also carry the texture codes (<true,
    true>), on injected uniforms and on Philox against the plain version:
    power per cell within 1e-4 x
    max|acc|, I / Q within 1e-4 x max(|I|, |Q|) plus the phase slack
    times the cell's amplitude sum and the ill-conditioned connections'
    own slack (`cond_out`), lane by lane in amplitude; the launch record
    and the configuration's count."""
    s, rx, tab, kw = _prim_tables(cuda, target, coherent)
    textured = target == 'sphere_checker'
    name = rk.config_name(False, coherent, coherent, tex=textured,
                          prims=True)
    for n_lanes, u in ((1 << 16, torch.rand(
            (rk.n_draws(kw['max_depth']), 1 << 16),
            generator=torch.Generator(cuda).manual_seed(5), device=cuda)),
            ((1 << 20) + 77, None)):
        before = rk.receive_megakernel.by_config[name]
        lane = torch.empty(n_lanes, device=cuda) if coherent else None
        lane_ref = torch.empty(n_lanes, device=cuda) if coherent else None
        acc, n_ev = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                          n_lanes=n_lanes, uniforms=u,
                                          seed=11, lane_out=lane, **kw)
        torch.cuda.synchronize()
        assert rk.launched_prim_kernel(coherent, textured)
        assert not rk.launched_prim_kernel(not coherent, textured)
        assert not rk.launched_prim_kernel(coherent, not textured)
        assert rk.receive_megakernel.by_config[name] == before + 1
        if u is None:
            u = rk.philox_uniforms(11, rk.n_draws(kw['max_depth']), n_lanes,
                                   device=cuda)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=cuda)
        cond = torch.zeros_like(amp)
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, u,
            amp_out=amp if coherent else None,
            cond_out=cond if coherent else None, lane_out=lane_ref, **kw)
        assert acc.shape == ref.shape
        if coherent:
            _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                    rk.phase_slack(s.band, rx.adc), lane,
                                    lane_ref, cond=cond)
        else:
            scale = float(ref.abs().max())
            assert scale > 0 and int(n_ref) > 0
            assert float((acc - ref).abs().max()) <= 1e-4 * scale
            assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)


@pytest.mark.gpu
@pytest.mark.parametrize('coherent', [False, True], ids=['power', 'iq'])
def test_prims_twin_anchors(cuda, coherent):
    """On the card: each target's peak lies within bins [b - 1, b + 3] of
    the round trip b to its near surface, and each moves the grid by more
    than 100 x the parity bound (1e-4 x max|acc|) against the scene
    without it; receive() launches the twin.  The prims twin on the
    all-rectangle flagship scene is held to the plain version as the
    rectangle kernel is (FMA contraction may differ between the two
    instantiations; the g++ emulation, which contracts nothing, gives
    them bit for bit: tests/test_torch_prims_emulate.py)."""
    from beifong_tpu_torch.scenes import round_trip_bin, target_range

    def grid(target, prims=None):
        s, rx, tab, kw = _prim_tables(cuda, target, coherent)
        acc, _ = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                       n_lanes=1 << 22, seed=7, prims=prims,
                                       **kw)
        torch.cuda.synchronize()
        return s, rx, acc

    _, _, base = grid(None)
    for target in ('sphere', 'disk', 'cylinder'):
        s, rx, got = grid(target)
        assert rk.launched_prim_kernel(coherent)
        power = got[:, 0] if not coherent else got[:, 0].square().sum(-1)
        b = round(round_trip_bin(s, rx, (0.0, -target_range(target), 0.0)))
        assert b - 1 <= int(power.argmax()) <= b + 3, (target, b)
        moved = float((got - base).abs().max())
        assert moved > 100 * 1e-4 * float(base.abs().max()), target
        adc, n = receive(s, receiver=rx, spp=1 << 16, max_depth=2,
                         coherent=coherent, time_sampling='gate',
                         device=cuda)
        torch.cuda.synchronize()
        assert rk.launched_prim_kernel(coherent)
        assert bool(torch.isfinite(adc).all()) and n == 1 << 16
    s, rx, twin = grid('plate', prims=True)
    assert rk.launched_prim_kernel(coherent)
    _, _, rect = grid('plate', prims=False)
    assert not rk.launched_prim_kernel(coherent)
    _, _, tab, kw = _prim_tables(cuda, 'plate', coherent)
    u = rk.philox_uniforms(7, rk.n_draws(kw['max_depth']), 1 << 22,
                           device=cuda)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=cuda)
    cond = torch.zeros_like(amp)
    ref, n_ref = rk.receive_megakernel_ref(
        tab.params, tab.prim, tab.txp, u, amp_out=amp if coherent else None,
        cond_out=cond if coherent else None, **kw)
    for got in (twin, rect):
        if coherent:
            bound = 1e-4 * float(ref.abs().max()) \
                + rk.phase_slack(s.band, rx.adc) \
                * (amp + cond).float()[..., None]
            assert bool(((got - ref).abs() <= bound).all())
        else:
            assert float((got - ref).abs().max()) \
                <= 1e-4 * float(ref.abs().max())


@pytest.mark.gpu
def test_prims_cpi_takes_the_coherent_twin(cuda):
    """A coherent CPI of the sphere scene runs in one launch of the
    coherent prims twin (its pulse axis), finite, its target on the
    near surface's round trip in every pulse; the launch, held pulse by
    pulse against the plain version on each pulse's Philox stream (the
    phase slack with the connections' own, lane by lane in amplitude)."""
    from beifong_tpu_torch.scenes import round_trip_bin, target_range
    s, rx = flagship_scene(target='sphere')
    before = rk.receive_megakernel_cpi.by_config['coherent_prims']
    cube, n = receive_cpi(s, n_pulses=4, prf=100.0, spp=1 << 18,
                          max_depth=2, time_sampling='gate',
                          engine='pallas', device=cuda)
    torch.cuda.synchronize()
    assert rk.launched_prim_kernel(True)
    assert rk.receive_megakernel_cpi.by_config['coherent_prims'] \
        == before + 1
    assert bool(torch.isfinite(cube).all()) and cube.shape[0] == 4
    b = round(round_trip_bin(s, rx, (0.0, -target_range('sphere'), 0.0)))
    power = cube[:, :, 0, 0].square() + cube[:, :, 0, 1].square()
    for p in range(4):
        assert b - 1 <= int(power[p].argmax()) <= b + 3, (p, b)
    packed, rx, _ = rk.pack_cpi(s, 4, 100.0)
    params, prim, txp = (torch.tensor(a, device=cuda) for a in
                         (packed.params, packed.prim, packed.txp))
    params[:, 0] = rk.seed_slot(5)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=True, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, coherent=True,
              mirror=packed.mirror)
    lane = torch.empty((4, 1 << 18), device=cuda)
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, seed=5,
                                          seed_step=7919, n_lanes=1 << 18,
                                          lane_out=lane, **kw)
    assert rk.launched_prim_kernel(True)
    for p in range(4):
        u = rk.philox_uniforms(5 + 7919 * p, rk.n_draws(2), 1 << 18,
                               device=cuda)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=cuda)
        cond = torch.zeros_like(amp)
        lane_ref = torch.empty(1 << 18, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(
            params[p], prim[p], txp[p], u, amp_out=amp, cond_out=cond,
            lane_out=lane_ref, **kw)
        _assert_coherent_parity(acc[p], n_ev[p], ref, n_ref, amp,
                                rk.phase_slack(s.band, rx.adc), lane[p],
                                lane_ref, cond=cond)


# the Doppler configuration's twins: (scene, time sampling, the Doppler
# power twin's launch record)
DOPPLER_TWIN_SCENES = {
    'sphere': (lambda: range_doppler_scene(0, 'sphere'), 'gate', 'prims'),
    'disk': (lambda: range_doppler_scene(0, 'disk'), 'gate', 'prims'),
    'cylinder': (lambda: range_doppler_scene(0, 'cylinder'), 'gate',
                 'prims'),
    'checker': (lambda: range_doppler_scene(0, 'plate', 'checkerboard'),
                'gate', 'tex'),
    'bitmap': (lambda: range_doppler_scene(0, 'plate', 'bitmap'), 'gate',
               'tex'),
    'sphere_checker': (lambda: range_doppler_scene(0, 'sphere',
                                                   'checkerboard'),
                       'gate', 'tex_prims'),
    'metal_sphere': (lambda: flagship_scene(target='sphere',
                                            material='conductor'), 'gate',
                     'prims'),
    'ggx_sphere': (lambda: flagship_scene(target='sphere',
                                          material='rough_conductor'),
                   'gate', 'prims'),
    'sonar_sphere': (lambda: fmcw_sonar_scene(target='sphere'), 'fixed',
                     'prims'),
    'sphere_global': (lambda: _wide_pulse(range_doppler_scene(0, 'sphere')),
                      'gate', 'prims'),
}


def _wide_pulse(scene):
    """The range-Doppler pulse on 256 x 128 cells: past the block's grid,
    so the twin splats into the global float64 grid."""
    s, rx = scene
    rx = dataclasses.replace(rx, adc=dataclasses.replace(rx.adc,
                                                         n_time=256))
    s.receivers[0] = rx
    return s, rx


def _doppler_twin_tables(device, name, coherent):
    scene, ts, twin = DOPPLER_TWIN_SCENES[name]
    s, rx = scene()
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, device)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling=ts, rx_kind='wigner',
              doppler=True, coherent=coherent, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=tab.mirror)
    if tab.textured:
        kw.update(tex=tab.tex, bmp_meta=tab.bmp_meta)
    return s, rx, tab, kw, twin


def _assert_power_lanes(acc, n_ev, ref, n_ref, lane, lane_ref, depth=2,
                        cell_slack=0.0):
    """Power lane by lane: each lane within 1e-4 of itself or 1e-5 of the
    largest lane (a quadratic root's rounding slides a hit along a sphere
    or cylinder further than along a plane; chip_smoke.PRIM_LANE_FLOOR);
    lanes beyond it took another path, at most 1e-4 of them, and bound
    the cells by their sums beyond 1e-4 x max|acc| (and `cell_slack`, a
    tensor of the grid's shape)."""
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    flipped = (lane - lane_ref).abs() > \
        1e-4 * lane_ref.abs() + 1e-5 * float(lane_ref.abs().max())
    n_flip = int(flipped.sum())
    assert n_flip <= 1e-4 * lane.numel(), n_flip
    slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    assert bool(((acc - ref).abs() <= 1e-4 * scale + slack + cell_slack)
                .all())
    assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref) \
        + 2 * depth * n_flip


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(DOPPLER_TWIN_SCENES))
def test_doppler_power_twins_match_plain_version(cuda, name):
    """receive_doppler_power_kernel<true> (textured grounds), <false,
    true> (spheres, disks, cylinders: closing, a mirror, GGX, the sonar's
    mix_resample) and <true, true> (both) on injected uniforms and on
    Philox against the plain version, lane by lane (on the global grid each
    cell also within `coord_slack` of its |power| sum, its bins' float
    coordinates); the launch record and the configuration's count."""
    s, rx, tab, kw, twin = _doppler_twin_tables(cuda, name, False)
    cfg = rk.config_name(False, True, tex=tab.textured, prims=tab.prims)
    assert cfg == 'doppler_' + twin
    for n_lanes, u in ((1 << 16, torch.rand(
            (rk.n_draws(2), 1 << 16),
            generator=torch.Generator(cuda).manual_seed(5), device=cuda)),
            ((1 << 20) + 77, None)):
        before = rk.receive_megakernel.by_config[cfg]
        lane = torch.empty(n_lanes, device=cuda)
        acc, n_ev = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                          n_lanes=n_lanes, uniforms=u,
                                          seed=11, lane_out=lane, **kw)
        torch.cuda.synchronize()
        assert rk.launched_doppler_power_kernel(twin)
        assert not rk.launched_doppler_power_kernel()
        assert rk.receive_megakernel.by_config[cfg] == before + 1
        if u is None:
            u = rk.philox_uniforms(11, rk.n_draws(2), n_lanes, device=cuda)
        lane_ref = torch.empty(n_lanes, device=cuda)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, u, lane_out=lane_ref,
            amp_out=amp, **kw)
        assert acc.shape == ref.shape
        glob = rk.grid_mode(rx.adc.n_time * rx.adc.n_freq, True) == 2
        assert glob == (name == 'sphere_global')
        _assert_power_lanes(acc, n_ev, ref, n_ref, lane, lane_ref,
                            cell_slack=rk.coord_slack(rx.adc) * amp.float()
                            if glob else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['sphere', 'metal_sphere', 'ggx_sphere',
                                  'sonar_sphere'])
def test_coherent_prims_twin_under_doppler_conditions(cuda, name):
    """receive_coherent_kernel<false, true> on a closing sphere's 2-D
    I / Q grid, the metal sphere's mirror chains, a GGX sphere and the
    sonar's mix_resample, on injected uniforms and on Philox: the phase
    slack with each ill-conditioned connection's own, lane by lane in
    amplitude."""
    s, rx, tab, kw, _ = _doppler_twin_tables(cuda, name, True)
    for n_lanes, u in ((1 << 16, torch.rand(
            (rk.n_draws(2), 1 << 16),
            generator=torch.Generator(cuda).manual_seed(6), device=cuda)),
            ((1 << 20) + 77, None)):
        lane = torch.empty(n_lanes, device=cuda)
        acc, n_ev = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                          n_lanes=n_lanes, uniforms=u,
                                          seed=12, lane_out=lane, **kw)
        torch.cuda.synchronize()
        assert rk.launched_prim_kernel(True)
        if u is None:
            u = rk.philox_uniforms(12, rk.n_draws(2), n_lanes, device=cuda)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=cuda)
        cond = torch.zeros_like(amp)
        lane_ref = torch.empty(n_lanes, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, u, amp_out=amp, cond_out=cond,
            lane_out=lane_ref, **kw)
        _assert_coherent_parity(acc, n_ev, ref, n_ref, amp,
                                rk.phase_slack(s.band, rx.adc), lane,
                                lane_ref, cond=cond)


@pytest.mark.gpu
def test_doppler_twins_on_the_main_path(cuda):
    """receive() of each Doppler twin scene launches its twin (no
    wavefront pass), finite; the prims twin on the rectangle-only pulse is
    held to the plain version as the Doppler power kernel is; a closing
    sphere's power CPI runs in one launch of the prims twin, held pulse by
    pulse."""
    for name in DOPPLER_TWIN_SCENES:
        s, rx, tab, kw, twin = _doppler_twin_tables(cuda, name, False)
        adc, n = receive(s, receiver=rx, spp=1 << 18, max_depth=2,
                         time_sampling=kw['time_sampling'], device=cuda)
        torch.cuda.synchronize()
        assert rk.launched_doppler_power_kernel(twin), name
        assert bool(torch.isfinite(adc).all()) and n == 1 << 18
    s, rx = range_doppler_scene(0)
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, cuda)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=True)
    u = rk.philox_uniforms(7, rk.n_draws(2), 1 << 20, device=cuda)
    ref, n_ref = rk.receive_megakernel_ref(tab.params, tab.prim, tab.txp, u,
                                           **kw)
    for prims in (True, False):
        acc, n_ev = rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                          n_lanes=1 << 20, seed=7,
                                          prims=prims, **kw)
        torch.cuda.synchronize()
        assert rk.launched_doppler_power_kernel('prims' if prims else '')
        assert float((acc - ref).abs().max()) \
            <= 1e-4 * float(ref.abs().max())
        assert abs(int(n_ev) - int(n_ref)) <= 1e-4 * int(n_ref)
    s, rx = range_doppler_scene(0, 'sphere')
    before = rk.receive_megakernel_cpi.by_config['doppler_prims']
    cube, n = receive_cpi(s, n_pulses=4, prf=20.0, spp=1 << 18,
                          max_depth=2, time_sampling='gate', coherent=False,
                          engine='pallas', device=cuda)
    torch.cuda.synchronize()
    assert rk.launched_doppler_power_kernel('prims')
    assert rk.receive_megakernel_cpi.by_config['doppler_prims'] \
        == before + 1
    assert bool(torch.isfinite(cube).all()) and cube.shape[0] == 4
    packed, rx, _ = rk.pack_cpi(s, 4, 20.0)
    params, prim, txp = (torch.tensor(a, device=cuda) for a in
                         (packed.params, packed.prim, packed.txp))
    params[:, 0] = rk.seed_slot(5)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind='wigner', doppler=True, mirror=packed.mirror)
    lane = torch.empty((4, 1 << 18), device=cuda)
    acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, seed=5,
                                          seed_step=7919, n_lanes=1 << 18,
                                          lane_out=lane, **kw)
    assert rk.launched_doppler_power_kernel('prims')
    for p in range(4):
        u = rk.philox_uniforms(5 + 7919 * p, rk.n_draws(2), 1 << 18,
                               device=cuda)
        lane_ref = torch.empty(1 << 18, device=cuda)
        ref, n_ref = rk.receive_megakernel_ref(params[p], prim[p], txp[p], u,
                                               lane_out=lane_ref, **kw)
        _assert_power_lanes(acc[p], n_ev[p], ref, n_ref, lane[p], lane_ref)
