#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`beifong_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device  - a CUDA card must be present; prints its name and power limit;
2. build   - compiles every CUDA kernel of the main path from `csrc/`
             (one nvcc per source, all started together) and prints the
             build time and ptxas' registers and spills;
3. parity  - each kernel against its plain PyTorch version on the card:
             the receive megakernel on one seeded (n_draws, 2^18) uniform
             tensor at depth 3 in gate and fixed time sampling, its Philox
             mode at the main path's 2^28 lanes against the plain version
             fed the same Philox stream, and two Philox-mode calls with one
             seed, which must be bit-identical;
4. main    - the flagship receive at 2^28 samples and depth 3 through
             `receive()` on the card (one warm-up, five timed calls), then
             `develop_signal` and `pulse_compress`: finite output of the
             expected shape whose range profile peaks at the 2R/c delay, and
             every kernel of the path launched during those calls;
5. report  - one JSON line per kernel ({"kernels": [...]}), then the last
             line {"ok": true, "device": {...}}.

Every time printed is measured in this run on the card named beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

N_LANES = 1 << 28          # flagship samples per receive() call
PARITY_LANES = 1 << 18     # injected-uniform comparison
PLAIN_CHUNK = 1 << 22      # the plain version runs the 2^28 lanes in chunks
MAX_DEPTH = 3
SEED = 7
TOL = 1e-4                 # x max|acc| per bin; relative on event counts
H100_FP32_FLOPS = 67e12    # dense FP32 outside the tensor cores, 700 W
H100_BYTES_PER_S = 3.35e12

# FP32 arithmetic instructions (add, sub, mul, div, sqrt, rsqrt, exp, log,
# min, max, abs, floor, ceil, rint, fmod) per lane and stage, counted by
# hand from csrc/receive_megakernel.cu; compares, selects and the integer
# Philox work are not counted, so the bound is a lower bound.
FP32_OPS = {
    'ray_wigner': 193,   # aperture point, MIS lobe direction, WDF weight
    'ray_omni': 33,
    'time_fixed': 2,
    'rect_test': 41,     # one ray / rectangle test (closest hit, shadow)
    'hit': 17,           # normal, path length, hit point
    'direct': 174,       # direct transmitter hit: gate, WDFs, splat
    'nee_geom': 35,      # transmitter point, direction, cos
    'nee': 162,          # pdf, BSDF, gate, waveform and aperture WDFs
    'nee_splat': 23,     # contribution and tent splat
    'bounce': 73,        # cosine-hemisphere bounce
}


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f'nvidia-smi: {res.stderr.strip()}')
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int):
    """(per-call times [ms] from CUDA events around each of n calls of
    fn(i), the last call's result)."""
    import torch
    times, res = [], None
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times, res


def compare(acc, n_ev, ref, n_ref, what: str) -> dict:
    scale = float(ref.abs().max())
    err = float((acc - ref).abs().max())
    ev, ev_ref = int(n_ev), int(n_ref)
    print(f'parity {what}: max|acc| {scale:.6e}  max abs err {err:.3e} '
          f'({err / max(scale, 1e-300):.3e} of max)  events {ev} vs '
          f'{ev_ref}')
    if not (scale > 0 and err <= TOL * scale):
        fail(f'{what}: kernel differs from the plain version '
             f'({err:.3e} > {TOL} x {scale:.3e})')
    if abs(ev - ev_ref) > TOL * ev_ref:
        fail(f'{what}: event counts {ev} vs {ev_ref}')
    return dict(err=err, rel=err / scale)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a card')
    sys.path.insert(0, HERE)
    import beifong_tpu_torch as bt
    from beifong_tpu_torch.dsp.pulse import pulse_compress
    from beifong_tpu_torch.integrators import receive_kernel as rk
    from beifong_tpu_torch.scenes import flagship_scene, round_trip_bin

    # ---- 1. device ----
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f'device: {name}  ({torch.cuda.device_count()} visible)  torch '
          f'{torch.__version__}  CUDA {torch.version.cuda}')
    print(card)
    tag = f'[{card}]'

    # ---- 2. build: one nvcc per source, all started together ----
    builders = {'receive_megakernel': rk.build_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as ex:
        futures = {k: ex.submit(fn) for k, fn in builders.items()}
        infos = {k: f.result() for k, f in futures.items()}
    for kname, info in infos.items():
        print(f'build {kname}: {info.seconds:.1f} s nvcc '
              f'({os.path.basename(info.path)}) {tag}')
        for line in info.log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas: {line.strip()}')
    print(f'build wall {time.perf_counter() - t0:.1f} s {tag}')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(64, N_LANES, 4)
    print(f'receive_megakernel geometry at 2^28 lanes: {blocks} blocks x '
          f'{threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')

    # ---- 3. kernels against their plain versions on the card ----
    s, rx = flagship_scene()
    sd = s.compile(device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    params_t = torch.tensor(packed.params, device=dev)
    prim_t = torch.tensor(packed.prim, device=dev)
    txp_t = torch.tensor(packed.txp, device=dev)
    nd = rk.n_draws(MAX_DEPTH)
    rel_errs, abs_errs = [], []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for ts in ('gate', 'fixed'):
        u = torch.rand((nd, PARITY_LANES), generator=gen, device=dev)
        kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling=ts,
                  rx_kind='wigner')
        acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                          n_lanes=PARITY_LANES, uniforms=u,
                                          **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, n_ref = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                               **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = compare(acc, n_ev, ref, n_ref, f'injected {ts} 2^18 lanes')
        rel_errs.append(c['rel'])
        print(f'plain version {ts}, 2^18 lanes: {ms:.1f} ms {tag}')

    kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling='gate',
              rx_kind='wigner')
    acc1, n1 = rk.receive_megakernel(params_t, prim_t, txp_t,
                                     n_lanes=N_LANES, seed=SEED, **kw)
    acc2, n2 = rk.receive_megakernel(params_t, prim_t, txp_t,
                                     n_lanes=N_LANES, seed=SEED, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(acc1, acc2) and int(n1) == int(n2)):
        fail('two Philox-mode calls with one seed differ')
    print('parity philox 2^28 lanes: two calls bit-identical')

    # the plain version on the same Philox stream at the main path's shape
    stats: dict = {}
    plain = torch.zeros_like(acc1)
    n_plain = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lane0 in range(0, N_LANES, PLAIN_CHUNK):
        u = rk.philox_uniforms(SEED, nd, PLAIN_CHUNK, device=dev,
                               lane0=lane0)
        a, n = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                         stats=stats, **kw)
        plain += a
        n_plain += int(n)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    c = compare(acc1, n1, plain, n_plain, 'philox 2^28 lanes')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    print(f'plain version, 2^28 lanes in 2^22-lane chunks: '
          f'{plain_ms:.1f} ms {tag}')
    print('stage lanes: ' + json.dumps(stats))

    # ---- 4. the main path at full size ----
    anchor = round_trip_bin(s, rx)
    rk.receive_megakernel.launches = 0

    def run_main(seed):
        return bt.receive(s, sd, rx, seed=seed, spp=N_LANES,
                          max_depth=MAX_DEPTH, time_sampling='gate',
                          device=dev)

    run_main(1)
    call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
    launches = rk.receive_megakernel.launches
    if launches < 6:
        fail(f'the main path launched receive_megakernel {launches} times '
             f'in 6 receive() calls')
    prof = bt.develop_signal(adc, n, rx.adc)
    if tuple(prof.shape) != (rx.adc.n_time, 1, 1) \
            or not bool(torch.isfinite(prof).all()):
        fail(f'developed signal {tuple(prof.shape)} not finite / wrong shape')
    p = prof[:, 0, 0]
    rep_n = max(2, int(round(2e-3 / (rx.adc.sampling_time / rx.adc.n_time))))
    comp = pulse_compress(p.to(torch.complex64),
                          torch.ones(rep_n, dtype=torch.complex64,
                                     device=dev)).abs()
    pk, pk_c = int(p.argmax()), int(comp.argmax())
    print(f'profile peak bin {pk}, compressed {pk_c}, 2R/c anchor '
          f'{anchor:.2f}')
    if abs(pk - anchor) > 2 or abs(pk_c - anchor) > 2:
        fail(f'range profile peaks at {pk} / {pk_c}, anchor {anchor:.2f}')
    med = statistics.median(call_ms)
    print(f'receive() 2^28 samples depth 3: median {med:.2f} ms/call '
          f'({N_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]} {tag}')

    # kernel alone at the main path's shape (launches here do not count)
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params_t, prim_t, txp_t, n_lanes=N_LANES, seed=SEED, **kw), 5)
    k_med = statistics.median(k_ms)
    print(f'receive_megakernel 2^28 lanes: median {k_med:.3f} ms '
          f'{[round(x, 3) for x in k_ms]} {tag}')

    # ---- 5. report ----
    n_rect = int((prim_t[:, 0] == 0).sum())
    ops = (stats['lanes'] * FP32_OPS['ray_wigner']
           + stats['trace'] * n_rect * FP32_OPS['rect_test']
           + stats['occ_tests'] * FP32_OPS['rect_test']
           + sum(stats[k] * FP32_OPS[k] for k in
                 ('hit', 'direct', 'nee_geom', 'nee', 'nee_splat', 'bounce')))
    n_bytes = 4 * (params_t.numel() + prim_t.numel() + txp_t.numel()
                   + rx.adc.n_time) + 8
    t_ops, t_bytes = ops / H100_FP32_FLOPS * 1e3, n_bytes / H100_BYTES_PER_S \
        * 1e3
    print(f'bound: {ops:.4e} FP32 ops ({ops / N_LANES:.1f}/lane) over '
          f'{H100_FP32_FLOPS:.3g} FLOP/s = {t_ops:.4f} ms; {n_bytes} bytes '
          f'= {t_bytes:.3e} ms (published H100 SXM peaks at 700 W)')
    kernels = [{
        'name': 'receive_megakernel', 'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106)',
        'launches': launches, 'max_abs_err': max(abs_errs),
        'parity': max(rel_errs), 'ms': k_med, 'plain_ms': plain_ms,
        'bound_ms': max(t_ops, t_bytes),
        'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
        'library_ms': None, 'card': card,
    }]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
