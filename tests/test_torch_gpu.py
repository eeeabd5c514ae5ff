"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Marked `gpu`: each test decides in the `cuda` fixture whether a
card is present and skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch.  There, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -o addopts= -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import pytest
import torch

from beifong_tpu_torch import receive, develop_signal
from beifong_tpu_torch.geometry import bvh as bvh_mod
from beifong_tpu_torch.geometry import bvh_kernel as bk
from beifong_tpu_torch.geometry import intersect_kernel as ik
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.scenes import flagship_scene, mesh_scene, \
    multi_body_scene, round_trip_bin

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
@pytest.mark.parametrize('rx_kind, ts', [('wigner', 'gate'),
                                         ('wigner', 'fixed'),
                                         ('omni', 'gate'),
                                         ('omni', 'fixed')])
def test_cuda_kernel_matches_plain_version(cuda, rx_kind, ts):
    params, prim, txp, adc = _flagship_tables(cuda, rx_kind=rx_kind)
    n_lanes = 1 << 16
    u = torch.rand((rk.n_draws(3), n_lanes),
                   generator=torch.Generator(cuda).manual_seed(3),
                   device=cuda)
    kw = dict(adc=adc, max_depth=3, time_sampling=ts, rx_kind=rx_kind)
    before = rk.receive_megakernel.launches
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                      uniforms=u, **kw)
    torch.cuda.synchronize()
    assert rk.receive_megakernel.launches == before + 1
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


def _assert_mesh_parity(acc, n_ev, lane, ref, n_ref, lane_ref, depth=2):
    """Lane by lane: a lane whose sum differs by more than 1e-4 of itself
    took another path (a ray at a triangle edge, under FMA contraction);
    at most 1e-4 of the lanes may, and they bound how far the bins and
    event counts may move beyond 1e-4."""
    flipped = (lane - lane_ref).abs() > \
        1e-4 * lane_ref.abs() + 1e-6 * float(lane_ref.abs().max())
    n_flip = int(flipped.sum())
    assert n_flip <= 1e-4 * lane.numel()
    slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    scale = float(ref.abs().max())
    assert scale > 0 and int(n_ref) > 0
    assert float((acc - ref).abs().max()) <= 1e-4 * scale + slack
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
def test_bvh_kernels_match_plain_versions(cuda):
    *_, sd = _mesh_tables('cpu')
    b = bvh_mod.build(sd.tris.v0.numpy(), sd.tris.e1.numpy(),
                      sd.tris.e2.numpy(), align=True)
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


@pytest.mark.gpu
@pytest.mark.parametrize('n_side', [9, 23])
def test_ray_triangle_kernels_match_plain_versions(cuda, n_side):
    # 162 and 1058 faces (a ragged last tile of 34); 5000 rays (a ragged
    # last block); every operation rounded as in the plain version
    s, _ = mesh_scene(n_side=n_side)
    sd = s.compile(use_bvh=False, device='cpu')
    v0, e1, e2 = (x.to(cuda).contiguous()
                  for x in (sd.tris.v0, sd.tris.e1, sd.tris.e2))
    o, d, maxt = _query_rays(sd, 5000, cuda, seed=n_side)
    before = _launches()
    t, idx, u, v = ik.ray_triangle_closest(o, d, v0, e1, e2)
    occ = ik.ray_triangle_any(o, d, v0, e1, e2, maxt)
    torch.cuda.synchronize()
    assert _launches()[:2] == (before[0] + 1, before[1] + 1)
    rt, ri, ru, rv = ik.ray_triangle_closest_ref(o, d, v0, e1, e2)
    ro = ik.ray_triangle_any_ref(o, d, v0, e1, e2, maxt)
    assert torch.equal((idx >= 0), (ri >= 0))
    assert int((idx != ri).sum()) <= 1e-4 * idx.numel()
    same = (idx == ri) & (ri >= 0)
    assert 0.1 * idx.numel() < int(same.sum()) < idx.numel()
    assert torch.allclose(t[same], rt[same], rtol=2e-5, atol=0)
    assert torch.allclose(u[same], ru[same], rtol=0, atol=1e-4)
    assert torch.allclose(v[same], rv[same], rtol=0, atol=1e-4)
    assert bool(torch.isinf(t[ri < 0]).all()) and bool((u[ri < 0] == 0).all())
    assert int((occ != ro).sum()) <= 1e-4 * occ.numel()
    assert 0 < int(ro.sum()) < ro.numel()


@pytest.mark.gpu
def test_wavefront_triangle_tests_run_k4(cuda):
    s, rx = multi_body_scene()
    sd = s.compile(use_bvh=False)
    before = _launches()
    adc, n = receive(s, sd, rx, seed=3, spp=1 << 15, max_depth=2,
                     time_sampling='gate')
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
    kw = dict(seed=7, spp=1 << 14, max_depth=2, time_sampling='gate')
    a_gpu, _ = receive(s, s.compile(use_bvh=False), rx, **kw)
    a_cpu, _ = receive(s, s.compile(use_bvh=False, device='cpu'), rx,
                       device='cpu', **kw)
    ref = a_cpu[..., 0]
    assert float(ref.abs().max()) > 0
    assert float((a_gpu[..., 0].cpu() - ref).abs().max()) \
        <= 1e-4 * float(ref.abs().max())
