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
from beifong_tpu_torch.integrators import receive_kernel as rk
from beifong_tpu_torch.scenes import flagship_scene, round_trip_bin

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
