#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`beifong_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device  - a CUDA card must be present; prints its name and power limit;
2. build   - compiles every CUDA source of the main paths from `csrc/`
             (one nvcc per source, all started together) and prints the
             build times and ptxas' registers and spills of every kernel
             and configuration;
3. parity  - each kernel against its plain PyTorch version on the card:
             the receive megakernel's flagship configuration on seeded
             (n_draws, 2^18) uniforms at depth 3 in gate and fixed time
             sampling and in Philox mode at 2^28 lanes; its mesh
             configuration on the 10,082-triangle mesh scene, depth 2, on
             injected uniforms at 2^16 lanes (no strata) and 2^20 lanes
             (1024 tiles, 32 x 32 strata) and in Philox mode at 2^20
             lanes; two Philox calls with one seed, which must be
             bit-identical, in both configurations; bvh_closest and
             bvh_any on 2^20 rays over the same mesh (half from the
             receiver aperture, half from around the mesh);
4. main    - the flagship receive at 2^28 samples, depth 3, and the mesh
             receive at 2^24 samples, depth 2, through `receive()` on the
             card (one warm-up, five timed calls each), then
             `develop_signal` and `pulse_compress`: finite output of the
             expected shape whose range profile peaks at the 2R/c delay;
             then a ray query on the mesh: bvh_closest of 2^20 receiver
             rays, bvh_any of their hits toward the transmitter.  Each
             path must have launched its kernels; the launch counts are
             set to 0 just before a path and read just after it;
   wavefront - the eager receive wavefront: ray_triangle_closest /
             ray_triangle_any (K4) against their plain versions at the
             wavefront's shape (2^17 receiver rays x the multi_body
             scene's 324 faces) and a query shape (2^18 rays x
             mesh_scene's 10,082 faces); then the multi_body scene
             (`scenes.multi_body_scene`, the JAX package's
             examples/multi_body.py) through receive() at 2^22 samples,
             gate sampling, depth 2 (one warm-up, five timed calls, one
             profiled call), its two bodies checked in their range gates
             at their Doppler; the same scene at 2^16 samples on the card
             and on the CPU with one seed; the flagship through the kernel
             and through the wavefront at 2^22 samples, depth 3; and
             mesh_scene through the wavefront, whose BVH queries run K2 /
             K3, at 2^20 samples;
5. report  - one JSON line of every kernel ({"kernels": [...]}), then the
             last line {"ok": true, "device": {...}}.

Every time printed is measured in this run on the card named beside it.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

N_LANES = 1 << 28          # flagship samples per receive() call
PARITY_LANES = 1 << 18     # flagship injected-uniform comparison
PLAIN_CHUNK = 1 << 22      # the plain version runs 2^28 lanes in chunks
MAX_DEPTH = 3
MESH_LANES = 1 << 24       # mesh samples per receive() call
MESH_DEPTH = 2
MESH_PLAIN_CHUNK = 1 << 20
MESH_BENCH_LANES = 1 << 20  # the JAX package's mesh benchmark size
N_RAYS = 1 << 20           # BVH query rays
SEED = 7
TOL = 1e-4                 # x max|acc| per bin; relative on event counts
EDGE_FLIPS = 1e-4          # rays whose face differs at a shared edge
H100_FP32_FLOPS = 67e12    # dense FP32 outside the tensor cores, 700 W
H100_BYTES_PER_S = 3.35e12
WF_SAMPLES = 1 << 22       # wavefront samples per receive() call
WF_DEPTH = 2
WF_CPU_SAMPLES = 1 << 16   # the card-against-CPU comparison
PROFILE_SAMPLES = 1 << 20  # the profiled wavefront call (8 passes)
K4_RAYS = 1 << 17          # the wavefront's K4 shape (one pass of lanes)
K4_QUERY_RAYS = 1 << 18    # the K4 query shape, on mesh_scene
FLAG_SAMPLES = 1 << 22     # flagship: kernel against wavefront
FLAG_DEPTH = 3
BVH_WF_SAMPLES = 1 << 20   # mesh_scene through the wavefront (K2 / K3)
# FP32 operations of one (ray, triangle) pair, counted from
# pallas_intersect._kernel as csrc/intersect_kernels.cu computes them
K4_PAIR_OPS = 47

# FP32 arithmetic instructions (add, sub, mul, div, sqrt, rsqrt, exp, log,
# min, max, abs, floor, ceil, rint, fmod) per lane and stage, counted by
# hand from csrc/receive_megakernel.cu and csrc/bvh_walk.cuh; compares,
# selects, integer work (Philox, strata cells, node links) are not
# counted, so the bound is a lower bound.
FP32_OPS = {
    'ray_wigner': 193,   # aperture point, MIS lobe direction, WDF weight
    'ray_strata': 163,   # the same with a stratified cosine direction
    'ray_omni': 33,
    'time_fixed': 2,
    'rect_test': 41,     # one ray / rectangle test (closest hit, shadow)
    'hit': 17,           # normal, path length, hit point
    'direct': 174,       # direct transmitter hit: gate, WDFs, splat
    'nee_geom': 35,      # transmitter point, direction, cos
    'nee': 162,          # pdf, BSDF, gate, waveform and aperture WDFs
    'nee_splat': 23,     # contribution and tent splat
    'bounce': 73,        # cosine-hemisphere bounce
    'walk': 6,           # BVH walk set-up: 3 x (abs, reciprocal)
    'node_test': 23,     # slab test of one node
    'leaf_test': 8 * 47,  # Moller-Trumbore of a leaf's 8 triangles
    'mesh_hit': 19,      # geometric normal of the winning triangle
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


def wall_ms(fn):
    """(host ms of fn() ending in a synchronise, its result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


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


def compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, max_depth,
                  what: str) -> dict:
    """Mesh parity, lane by lane: a lane whose contribution sum differs by
    more than TOL of itself (and 1e-6 of the largest lane) took another
    path, as a ray that meets a triangle edge may under FMA contraction;
    those lanes are counted, may be at most EDGE_FLIPS of all, and bound
    how far the sums may move beyond TOL x max|acc| (each can at most
    remove its own contributions from some bins and add them to others)
    and the events (2 per depth)."""
    tol_lane = TOL * lane_ref.abs() + 1e-6 * float(lane_ref.abs().max())
    flipped = (lane - lane_ref).abs() > tol_lane
    n_flip = int(flipped.sum())
    slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    scale = float(ref.abs().max())
    err = float((acc - ref).abs().max())
    ev, ev_ref = int(n_ev), int(n_ref)
    print(f'parity {what}: max|acc| {scale:.6e}  max abs err {err:.3e} '
          f'({err / max(scale, 1e-300):.3e} of max)  events {ev} vs '
          f'{ev_ref}; {n_flip} of {lane.numel()} lanes took another path '
          f'(their sums {slack:.3e} = {slack / max(scale, 1e-300):.3e} of '
          f'max)')
    if n_flip > EDGE_FLIPS * lane.numel():
        fail(f'{what}: {n_flip} lanes differ from the plain version')
    if not (scale > 0 and err <= TOL * scale + slack):
        fail(f'{what}: kernel differs from the plain version '
             f'({err:.3e} > {TOL} x {scale:.3e} + {slack:.3e})')
    if abs(ev - ev_ref) > TOL * ev_ref + 2 * max_depth * n_flip:
        fail(f'{what}: event counts {ev} vs {ev_ref}')
    return dict(err=err, rel=err / scale, flips=n_flip)


def bound(ops: float, n_bytes: float, what: str) -> dict:
    t_ops = ops / H100_FP32_FLOPS * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    print(f'bound {what}: {ops:.4e} FP32 ops over {H100_FP32_FLOPS:.3g} '
          f'FLOP/s = {t_ops:.4e} ms; {n_bytes:.4e} bytes over '
          f'{H100_BYTES_PER_S:.3g} B/s = {t_bytes:.4e} ms (published H100 '
          f'SXM peaks at 700 W)')
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def lane_ops(stats: dict, n_rect: int) -> float:
    """FP32 operations that the stage counts of a plain-version run say
    the receive kernel must do."""
    return ((stats['lanes'] - stats['strata']) * FP32_OPS['ray_wigner']
            + stats['strata'] * FP32_OPS['ray_strata']
            + stats['trace'] * n_rect * FP32_OPS['rect_test']
            + stats['occ_tests'] * FP32_OPS['rect_test']
            + sum(stats[k] * FP32_OPS[k] for k in
                  ('hit', 'direct', 'nee_geom', 'nee', 'nee_splat',
                   'bounce'))
            + walk_ops(stats))


def walk_ops(stats: dict) -> float:
    return (stats.get('walks', 0) * FP32_OPS['walk']
            + stats.get('node_tests', 0) * FP32_OPS['node_test']
            + stats.get('leaf_tests', 0) * FP32_OPS['leaf_test']
            + stats.get('mesh_hits', 0) * FP32_OPS['mesh_hit'])


def print_build(infos: dict, tag: str) -> None:
    names = {'receive_trace_kernelILb0E': 'receive_megakernel (flagship)',
             'receive_trace_kernelILb1E': 'receive_megakernel (mesh)',
             'receive_reduce_kernel': 'receive reduce',
             'bvh_closest_kernel': 'bvh_closest', 'bvh_any_kernel': 'bvh_any',
             'ray_triangle_kernelILb0E': 'ray_triangle_closest',
             'ray_triangle_kernelILb1E': 'ray_triangle_any'}
    for kname, info in infos.items():
        print(f'build {kname}: {info.seconds:.1f} s nvcc '
              f'({os.path.basename(info.path)}) {tag}')
        fn = '?'
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = next((v for k, v in names.items() if k in m.group(1)),
                          m.group(1))
            elif 'registers' in line or 'spill' in line:
                print(f'  ptxas {fn}: {line.strip()}')


def flagship(torch, bt, rk, dev, tag, pulse_compress) -> dict:
    from beifong_tpu_torch.scenes import flagship_scene, round_trip_bin
    s, rx = flagship_scene()
    sd = s.compile(device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    params_t = torch.tensor(packed.params, device=dev)
    prim_t = torch.tensor(packed.prim, device=dev)
    txp_t = torch.tensor(packed.txp, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(64, N_LANES, 4)
    print(f'receive_megakernel (flagship) geometry at 2^28 lanes: {blocks} '
          f'blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')

    # ---- 3. the kernel against its plain version ----
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
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params_t, prim_t, txp_t, u, **kw))
        c = compare(acc, n_ev, ref, n_ref, f'flagship injected {ts} 2^18 '
                    'lanes')
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
        fail('flagship: two Philox-mode calls with one seed differ')
    print('parity flagship philox 2^28 lanes: two calls bit-identical')

    # the plain version on the same Philox stream at the main path's shape
    stats: dict = {}

    def plain():
        total, n_tot = torch.zeros_like(acc1), 0
        for lane0 in range(0, N_LANES, PLAIN_CHUNK):
            u = rk.philox_uniforms(SEED, nd, PLAIN_CHUNK, device=dev,
                                   lane0=lane0)
            a, n = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                             stats=stats, **kw)
            total += a
            n_tot += int(n)
        return total, n_tot

    plain_ms, (ref, n_ref) = wall_ms(plain)
    c = compare(acc1, n1, ref, n_ref, 'flagship philox 2^28 lanes')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    print(f'plain version, 2^28 lanes in 2^22-lane chunks: '
          f'{plain_ms:.1f} ms {tag}')
    print('flagship stage lanes: ' + json.dumps(stats))

    # ---- 4. the main path ----
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
        fail(f'the flagship path launched receive_megakernel {launches} '
             f'times in 6 receive() calls')
    check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, 'flagship')
    med = statistics.median(call_ms)
    print(f'receive() flagship 2^28 samples depth 3: median {med:.2f} '
          f'ms/call ({N_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]} {tag}')

    # kernel alone at the main path's shape (launches here do not count)
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params_t, prim_t, txp_t, n_lanes=N_LANES, seed=SEED, **kw), 5)
    k_med = statistics.median(k_ms)
    print(f'receive_megakernel (flagship) 2^28 lanes: median {k_med:.3f} '
          f'ms {[round(x, 3) for x in k_ms]} {tag}')

    n_rect = int((prim_t[:, 0] == 0).sum())
    n_bytes = 4 * (params_t.numel() + prim_t.numel() + txp_t.numel()
                   + rx.adc.n_time) + 8
    b = bound(lane_ops(stats, n_rect), n_bytes, 'flagship 2^28 lanes')
    return {
        'name': 'receive_megakernel', 'configuration': 'flagship',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106)',
        'launches': launches, 'max_abs_err': max(abs_errs),
        'parity': max(rel_errs), 'ms': k_med, 'plain_ms': plain_ms,
        **b, 'library_ms': None,
    }


def check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, what):
    prof = bt.develop_signal(adc, n, rx.adc)
    if tuple(prof.shape) != (rx.adc.n_time, 1, 1) \
            or not bool(torch.isfinite(prof).all()):
        fail(f'{what}: developed signal {tuple(prof.shape)} not finite / '
             f'wrong shape')
    p = prof[:, 0, 0]
    rep_n = max(2, int(round(2e-3 / (rx.adc.sampling_time / rx.adc.n_time))))
    comp = pulse_compress(p.to(torch.complex64),
                          torch.ones(rep_n, dtype=torch.complex64,
                                     device=p.device)).abs()
    pk, pk_c = int(p.argmax()), int(comp.argmax())
    print(f'{what} profile peak bin {pk}, compressed {pk_c}, 2R/c anchor '
          f'{anchor:.2f}')
    if abs(pk - anchor) > 2 or abs(pk_c - anchor) > 2:
        fail(f'{what}: range profile peaks at {pk} / {pk_c}, anchor '
             f'{anchor:.2f}')


def mesh(torch, bt, rk, dev, tag, pulse_compress) -> dict:
    from beifong_tpu_torch.scenes import mesh_scene, round_trip_bin
    s, rx = mesh_scene()
    sd = s.compile(device=dev)
    t0 = time.perf_counter()
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    pack_ms = (time.perf_counter() - t0) * 1e3
    mb = packed.mesh
    print(f'mesh scene: {sd.tris.n_faces} triangles, BVH {mb.n_nodes} '
          f'nodes, {mb.n_leaves} leaves, tables {4 * mb.bbox.numel()} + '
          f'{4 * mb.links.numel()} + {4 * mb.leaves.numel()} B; build + '
          f'pack {pack_ms:.0f} ms on the host')
    params_t = torch.tensor(packed.params, device=dev)
    params_t[0] = rk.seed_slot(SEED)
    prim_t = torch.tensor(packed.prim, device=dev)
    txp_t = torch.tensor(packed.txp, device=dev)
    mesh_t = mb.to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(64, MESH_LANES, 3, mesh=True)
    print(f'receive_megakernel (mesh) geometry at 2^24 lanes: {blocks} '
          f'blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')

    # ---- 3. the kernel against its plain version ----
    nd = rk.n_draws(MESH_DEPTH)
    rel_errs, abs_errs, flips = [], [], []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = dict(adc=rx.adc, max_depth=MESH_DEPTH, time_sampling='gate',
                rx_kind='wigner', mesh=mesh_t)
    for n_lanes, patch_p in ((1 << 16, 0), (1 << 20, 32)):
        if patch_p and rk.patch_p_for(n_lanes) != patch_p:
            fail(f'{n_lanes} lanes: strata P {rk.patch_p_for(n_lanes)}')
        u = torch.rand((nd, n_lanes), generator=gen, device=dev)
        kw = dict(base, patch_p=patch_p)
        lane = torch.empty(n_lanes, device=dev)
        lane_ref = torch.empty(n_lanes, device=dev)
        acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                          n_lanes=n_lanes, uniforms=u,
                                          lane_out=lane, **kw)
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params_t, prim_t, txp_t, u, lane_out=lane_ref, **kw))
        c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                          f'mesh injected 2^{n_lanes.bit_length() - 1} '
                          f'lanes, P {patch_p}')
        rel_errs.append(c['rel'])
        abs_errs.append(c['err'])
        flips.append(c['flips'])
        print(f'plain version mesh 2^{n_lanes.bit_length() - 1} lanes, P '
              f'{patch_p}: {ms:.1f} ms {tag}')

    n_b = MESH_BENCH_LANES
    kw = dict(base, patch_p=rk.patch_p_for(n_b))
    lane = torch.empty(n_b, device=dev)
    lane_ref = torch.empty(n_b, device=dev)
    acc1, n1 = rk.receive_megakernel(params_t, prim_t, txp_t, n_lanes=n_b,
                                     seed=SEED, lane_out=lane, **kw)
    acc2, n2 = rk.receive_megakernel(params_t, prim_t, txp_t, n_lanes=n_b,
                                     seed=SEED, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(acc1, acc2) and int(n1) == int(n2)):
        fail('mesh: two Philox-mode calls with one seed differ')
    print('parity mesh philox 2^20 lanes: two calls bit-identical')
    u = rk.philox_uniforms(SEED, nd, n_b, device=dev)
    ref, n_ref = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                           lane_out=lane_ref, **kw)
    c = compare_lanes(acc1, n1, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                      'mesh philox 2^20 lanes, P 32')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    flips.append(c['flips'])

    # the plain version on the kernel's Philox stream at the main path's
    # shape, with its stage counts for the bound
    kw = dict(base, patch_p=rk.patch_p_for(MESH_LANES))
    stats: dict = {}
    lane_ref = torch.empty(MESH_LANES, device=dev)

    def plain():
        total, n_tot = torch.zeros(rx.adc.n_time, device=dev), 0
        for lane0 in range(0, MESH_LANES, MESH_PLAIN_CHUNK):
            u = rk.philox_uniforms(SEED, nd, MESH_PLAIN_CHUNK, device=dev,
                                   lane0=lane0)
            a, n = rk.receive_megakernel_ref(
                params_t, prim_t, txp_t, u, lane0=lane0, stats=stats,
                lane_out=lane_ref[lane0:lane0 + MESH_PLAIN_CHUNK], **kw)
            total += a
            n_tot += int(n)
        return total, n_tot

    plain_ms, (ref, n_ref) = wall_ms(plain)
    lane = torch.empty(MESH_LANES, device=dev)
    acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                      n_lanes=MESH_LANES, seed=SEED,
                                      lane_out=lane, **kw)
    c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                      'mesh philox 2^24 lanes, P 32')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    flips.append(c['flips'])
    print(f'plain version mesh, 2^24 lanes in 2^20-lane chunks: '
          f'{plain_ms:.1f} ms {tag}')
    print('mesh stage lanes: ' + json.dumps(stats))

    # ---- 4. the main path ----
    anchor = round_trip_bin(s, rx)
    rk.receive_megakernel.launches = 0

    def run_main(seed):
        return bt.receive(s, sd, rx, seed=seed, spp=MESH_LANES,
                          max_depth=MESH_DEPTH, time_sampling='gate',
                          device=dev)

    _, n0 = run_main(1)
    call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
    launches = rk.receive_megakernel.launches
    if launches < 6 or n0 != MESH_LANES or n != MESH_LANES:
        fail(f'the mesh path launched receive_megakernel {launches} times '
             f'in 6 receive() calls ({n} samples)')
    check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, 'mesh')
    med = statistics.median(call_ms)
    print(f'receive() mesh 2^24 samples depth 2: median {med:.3f} ms/call '
          f'({MESH_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]} {tag}')

    # the kernel alone (launches here do not count)
    k_med = None
    for n_lanes, depth in ((MESH_LANES, MESH_DEPTH), (n_b, 2), (n_b, 1)):
        kwd = dict(base, max_depth=depth, patch_p=rk.patch_p_for(n_lanes))
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
            params_t, prim_t, txp_t, n_lanes=n_lanes, seed=SEED, **kwd), 6)
        med_k = statistics.median(k_ms[1:])
        k_med = k_med if k_med is not None else med_k
        print(f'receive_megakernel (mesh) 2^{n_lanes.bit_length() - 1} '
              f'lanes depth {depth}: median {med_k:.3f} ms '
              f'({n_lanes / (med_k * 1e-3):.4e} samples/s) '
              f'{[round(x, 3) for x in k_ms[1:]]} {tag}')

    n_rect = int((prim_t[:, 0] == 0).sum())
    n_bytes = 4 * (params_t.numel() + prim_t.numel() + txp_t.numel()
                   + mesh_t.bbox.numel() + mesh_t.links.numel()
                   + mesh_t.leaves.numel() + rx.adc.n_time) + 8
    b = bound(lane_ops(stats, n_rect), n_bytes, 'mesh 2^24 lanes')
    return {
        'name': 'receive_megakernel', 'configuration': 'mesh',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106), has_mesh',
        'launches': launches, 'max_abs_err': max(abs_errs),
        'parity': max(rel_errs), 'lanes_on_another_path': flips,
        'ms': k_med, 'plain_ms': plain_ms, **b, 'library_ms': None,
    }


def aperture_rays(torch, scene, rx, lo, hi, n, gen, dev):
    """n rays from uniform points of the receiver aperture toward uniform
    points of the box [lo, hi]."""
    i = scene.shape_index_of_endpoint('receiver', rx.id)
    m = torch.tensor(scene.shapes[i].to_world, device=dev)
    uv = 2.0 * torch.rand((n, 2), generator=gen, device=dev) - 1.0
    o = uv[:, :1] * m[:3, 0] + uv[:, 1:] * m[:3, 1] + m[:3, 3]
    tgt = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return o, tgt


def queries(torch, bt, dev, tag) -> list:
    from beifong_tpu_torch.geometry import bvh as bvh_mod
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    from beifong_tpu_torch.scenes import mesh_scene
    s, rx = mesh_scene()
    sd = s.compile(device=dev)
    tris = [x.cpu().numpy() for x in (sd.tris.v0, sd.tris.e1, sd.tris.e2)]
    pb = bk.pack(bvh_mod.build(*tris, align=True)).to(dev)
    v = sd.tris.v0
    lo, hi = v.min(0).values - 0.02, v.max(0).values + 0.02
    gen = torch.Generator(device=dev).manual_seed(SEED)
    half = N_RAYS // 2
    o1, t1 = aperture_rays(torch, s, rx, lo, hi, half, gen, dev)
    t2 = lo + (hi - lo) * torch.rand((half, 3), generator=gen, device=dev)
    o2 = (lo + hi) / 2 + 3.0 * (torch.rand((half, 3), generator=gen,
                                           device=dev) - 0.5)
    o, tgt = torch.cat([o1, o2]), torch.cat([t1, t2])
    d = tgt - o
    dist = d.norm(dim=1)
    d = (d / dist[:, None]).contiguous()
    o = o.contiguous()
    maxt = (dist * (0.8 + 0.4 * torch.rand(N_RAYS, generator=gen,
                                           device=dev))).contiguous()

    # ---- 3. parity ----
    t, idx, u, vv = bk.bvh_closest(pb, o, d)
    occ = bk.bvh_any(pb, o, d, maxt)
    st_c: dict = {}
    st_a: dict = {}
    pc_ms, (rt, ri, ru, rv) = wall_ms(lambda: bk.bvh_closest_ref(
        pb, o, d, stats=st_c))
    pa_ms, ro = wall_ms(lambda: bk.bvh_any_ref(pb, o, d, maxt, stats=st_a))
    flips = int((idx != ri).sum())
    same = (idx == ri) & (ri >= 0)
    t_rel = float(((t - rt).abs() / rt.abs())[same].max())
    du = float((u - ru).abs()[same].max())
    dv = float((vv - rv).abs()[same].max())
    occ_flips = int((occ != ro).sum())
    t_abs = float((t - rt).abs()[same].max())
    print(f'parity bvh_closest 2^20 rays: {int((ri >= 0).sum())} hits, '
          f'{flips} rays with another face (edge flips), on the same face '
          f'max t err {t_abs:.3e} ({t_rel:.3e} relative), max |du| '
          f'{du:.3e}, max |dv| {dv:.3e}')
    print(f'parity bvh_any 2^20 rays: {int(ro.sum())} occluded, '
          f'{N_RAYS - int(ro.sum())} free, {occ_flips} flags differ')
    if flips > EDGE_FLIPS * N_RAYS or occ_flips > EDGE_FLIPS * N_RAYS:
        fail(f'bvh kernels: {flips} / {occ_flips} rays differ from the '
             f'plain versions')
    if not (t_rel <= 1e-5 and 0 < int(ro.sum()) < N_RAYS):
        fail(f'bvh_closest: t differs by {t_rel:.3e} relative, or the '
             f'shadow rays are all free or all blocked')
    print(f'plain versions: bvh_closest {pc_ms:.1f} ms, bvh_any '
          f'{pa_ms:.1f} ms {tag}; walk counts closest {json.dumps(st_c)}, '
          f'any {json.dumps(st_a)}')

    # ---- 4. the query path: receiver rays, then shadow rays to the tx ----
    ti = s.shape_index_of_endpoint('transmitter', s.transmitters[0].id)
    tx_pos = torch.tensor(s.shapes[ti].to_world[:3, 3], device=dev)
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    t_q, idx_q, _, _ = bk.bvh_closest(pb, o1.contiguous(),
                                      d[:half].contiguous())
    hit = idx_q >= 0
    p = o1[hit] + (t_q[hit, None] - 1e-4) * d[:half][hit]
    to_tx = tx_pos - p
    dist_tx = to_tx.norm(dim=1)
    occ_q = bk.bvh_any(pb, p.contiguous(),
                       (to_tx / dist_tx[:, None]).contiguous(),
                       dist_tx.contiguous())
    launches = (bk.bvh_closest.launches, bk.bvh_any.launches)
    torch.cuda.synchronize()
    if launches != (1, 1):
        fail(f'the query path launched bvh_closest / bvh_any {launches} '
             f'times')
    print(f'query path: {int(hit.sum())} of {half} receiver rays hit the '
          f'mesh, {int(occ_q.sum())} of those see no transmitter')

    # the kernels alone at 2^20 rays (launches here do not count)
    c_ms, _ = cuda_ms(lambda i: bk.bvh_closest(pb, o, d), 6)
    a_ms, _ = cuda_ms(lambda i: bk.bvh_any(pb, o, d, maxt), 6)
    c_med, a_med = statistics.median(c_ms[1:]), statistics.median(a_ms[1:])
    print(f'bvh_closest 2^20 rays: median {c_med:.4f} ms, bvh_any '
          f'{a_med:.4f} ms {tag}')
    tables = 4 * (pb.bbox.numel() + pb.links.numel() + pb.leaves.numel())
    b_c = bound(walk_ops(st_c), tables + N_RAYS * (24 + 16),
                'bvh_closest 2^20 rays')
    b_a = bound(walk_ops(st_a), tables + N_RAYS * (24 + 4 + 1),
                'bvh_any 2^20 rays')
    common = dict(route='cuda', source='beifong_tpu_torch/csrc/'
                  'bvh_kernels.cu', library_ms=None)
    return [
        dict(name='bvh_closest', **common,
             replaces='beifong_tpu/geometry/pallas_bvh.py:380',
             tpu_function='_run_closest via bvh_closest (pallas_bvh.py:396)',
             launches=launches[0], max_abs_err=t_abs, parity=t_rel,
             edge_flips=flips, ms=c_med, plain_ms=pc_ms, **b_c),
        dict(name='bvh_any', **common,
             replaces='beifong_tpu/geometry/pallas_bvh.py:426',
             tpu_function='_run_any via bvh_any (pallas_bvh.py:437)',
             launches=launches[1], max_abs_err=float(occ_flips > 0),
             parity=occ_flips / N_RAYS, edge_flips=occ_flips, ms=a_med,
             plain_ms=pa_ms, **b_a),
    ]


class Patch:
    """Replaces module attributes for the length of a `with` block (the
    hooks below time and record the K4 launches of a receive() call)."""

    def __init__(self, **targets):
        self.targets = targets    # 'label': (module, attribute, wrapper)
        self.saved = []

    def __enter__(self):
        for module, attr, make in self.targets.values():
            orig = getattr(module, attr)
            new = make(orig)
            if hasattr(orig, 'launches'):
                # the wrapped function counts its launches under its module
                # name, which now names the wrapper
                new.launches = orig.launches
            self.saved.append((module, attr, orig, new))
            setattr(module, attr, new)
        return self

    def __exit__(self, *exc):
        for module, attr, orig, new in self.saved:
            if hasattr(orig, 'launches'):
                orig.launches = new.launches
            setattr(module, attr, orig)
        return False


def _pairs_to_first_blocker(torch, ik, o, d, v0, e1, e2, maxt) -> int:
    """(ray, triangle) pairs a shadow test needs on this data: each ray's
    triangles in index order up to and including its first blocker, all of
    them for a ray that nothing blocks."""
    n, n_tris = int(o.shape[0]), int(v0.shape[0])
    limit = (maxt * (1.0 - 1e-3))[:, None]
    total = 0
    step = 1 << 12
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        first = torch.full((r1 - r0,), n_tris, dtype=torch.int64,
                           device=o.device)
        for f0 in range(0, n_tris, ik.CHUNK_F):
            f1 = min(f0 + ik.CHUNK_F, n_tris)
            det, u, v, t = ik.moller_trumbore(o[r0:r1], d[r0:r1], v0[f0:f1],
                                              e1[f0:f1], e2[f0:f1])
            blk = ik.is_hit(det, u, v, t) & (t < limit[r0:r1])
            # argmax returns the first True of a row
            at = torch.where(blk.any(1), blk.to(torch.float32).argmax(1) + f0 + 1,
                             n_tris)
            first = torch.minimum(first, at)
        total += int(first.sum())
    return total


def k4_parity(torch, ik, dev, tag) -> list:
    """K4 against its plain version on the card at the wavefront's shape
    and at a query shape; the kernel's and the plain version's times."""
    from beifong_tpu_torch.scenes import mesh_scene, multi_body_scene
    out = {'ray_triangle_closest': {}, 'ray_triangle_any': {}}
    for shape, (scene_fn, n_rays) in (
            ('wavefront', (multi_body_scene, K4_RAYS)),
            ('query', (mesh_scene, K4_QUERY_RAYS))):
        s, rx = scene_fn()
        sd = s.compile(use_bvh=False, device=dev)
        v0, e1, e2 = (x.contiguous() for x in (sd.tris.v0, sd.tris.e1,
                                               sd.tris.e2))
        n_tris = int(v0.shape[0])
        lo, hi = v0.min(0).values - 0.05, v0.max(0).values + 0.05
        gen = torch.Generator(device=dev).manual_seed(SEED)
        o, tgt = aperture_rays(torch, s, rx, lo, hi, n_rays, gen, dev)
        # a quarter of the rays aim past the faces' box: misses
        tgt[: n_rays // 4] += 3.0 * (hi - lo)
        d = tgt - o
        dist = d.norm(dim=1)
        d = (d / dist[:, None]).contiguous()
        o = o.contiguous()
        maxt = (dist * (0.6 + 0.8 * torch.rand(n_rays, generator=gen,
                                                device=dev))).contiguous()
        t, idx, u, v = ik.ray_triangle_closest(o, d, v0, e1, e2)
        occ = ik.ray_triangle_any(o, d, v0, e1, e2, maxt)
        pc_ms, (rt, ri, ru, rv) = wall_ms(
            lambda: ik.ray_triangle_closest_ref(o, d, v0, e1, e2))
        pa_ms, ro = wall_ms(
            lambda: ik.ray_triangle_any_ref(o, d, v0, e1, e2, maxt))
        hit_flips = int(((idx >= 0) != (ri >= 0)).sum())
        faces = int((idx != ri).sum())
        same = (idx == ri) & (ri >= 0)
        t_rel = float(((t - rt).abs() / rt.abs())[same].max())
        t_abs = float((t - rt).abs()[same].max())
        du = float((u - ru).abs()[same].max())
        dv = float((v - rv).abs()[same].max())
        occ_flips = int((occ != ro).sum())
        print(f'parity K4 {shape} {n_rays} rays x {n_tris} faces: '
              f'{int((ri >= 0).sum())} hits, hit presence differs on '
              f'{hit_flips}, face on {faces}; same face: max t err {t_abs:.3e} '
              f'({t_rel:.3e} relative), max |du| {du:.3e}, |dv| {dv:.3e}; '
              f'any: {int(ro.sum())} blocked, {occ_flips} flags differ')
        if hit_flips or faces > 1e-4 * n_rays or occ_flips > 1e-4 * n_rays:
            fail(f'K4 {shape}: {hit_flips} / {faces} / {occ_flips} rays '
                 'differ from the plain version')
        if not (t_rel <= 2e-5 and du <= 1e-4 and dv <= 1e-4
                and 0 < int(ro.sum()) < n_rays and int(same.sum()) > 0):
            fail(f'K4 {shape}: t {t_rel:.3e} relative, u {du:.3e}, '
                 f'v {dv:.3e}, or degenerate rays')
        c_ms, _ = cuda_ms(lambda i: ik.ray_triangle_closest(o, d, v0, e1,
                                                            e2), 6)
        a_ms, _ = cuda_ms(lambda i: ik.ray_triangle_any(o, d, v0, e1, e2,
                                                        maxt), 6)
        c_med, a_med = statistics.median(c_ms[1:]), statistics.median(a_ms[1:])
        print(f'K4 {shape} {n_rays} x {n_tris}: ray_triangle_closest median '
              f'{c_med:.4f} ms, ray_triangle_any {a_med:.4f} ms; plain '
              f'versions {pc_ms:.1f} / {pa_ms:.1f} ms {tag}')
        b_c = bound(float(n_rays) * n_tris * K4_PAIR_OPS,
                    n_rays * (24 + 16) + 36 * n_tris,
                    f'ray_triangle_closest {shape}')
        # the shadow test may stop at a ray's first blocker: count the pairs
        # this data needs
        pairs = _pairs_to_first_blocker(torch, ik, o, d, v0, e1, e2, maxt)
        b_a = bound(float(pairs) * K4_PAIR_OPS,
                    n_rays * (24 + 4 + 1) + 36 * n_tris,
                    f'ray_triangle_any {shape} ({pairs / (n_rays * n_tris):.3f}'
                    ' of the pairs: each ray up to its first blocker)')
        for name, ms, p_ms, b, err in (
                ('ray_triangle_closest', c_med, pc_ms, b_c, t_abs),
                # max |flag - plain flag| over the rays: 0 or 1
                ('ray_triangle_any', a_med, pa_ms, b_a,
                 float(occ_flips > 0))):
            key = '' if shape == 'wavefront' else '_query'
            out[name].update({f'ms{key}': ms, f'plain_ms{key}': p_ms,
                              f'bound_ms{key}': b['bound_ms'],
                              f'bound_by{key}': b['bound_by'],
                              f'max_abs_err{key}': err,
                              f'shape{key}': [n_rays, n_tris]})
    common = dict(route='cuda',
                  source='beifong_tpu_torch/csrc/intersect_kernels.cu',
                  replaces='beifong_tpu/geometry/pallas_intersect.py:109',
                  library_ms=None)
    return [dict(name='ray_triangle_closest', **common,
                 tpu_function='_kernel (pallas_intersect.py:30) via '
                 'ray_triangle_closest (:77)', **out['ray_triangle_closest']),
            dict(name='ray_triangle_any', **common,
                 tpu_function='_kernel (pallas_intersect.py:30) via '
                 'ray_triangle_any (:130)', **out['ray_triangle_any'])]


def _k4_timer(torch, ik, events: list):
    """Wrappers of the K4 entry points that bracket each launch with CUDA
    events (their sum is the K4 time inside a receive() call)."""
    def wrap(orig):
        def timed(*a):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            res = orig(*a)
            s1.record()
            events.append((s0, s1))
            return res
        return timed
    return Patch(c=(ik, 'ray_triangle_closest', wrap),
                 a=(ik, 'ray_triangle_any', wrap))


def _recorder(torch, ik, rp, rec: dict, n_lanes: int, dev):
    """Wrappers that record, per lane, the sum of |value| splatted and
    every K4 face and shadow flag (one pass of n_lanes lanes)."""
    rec['lane'] = torch.zeros(n_lanes, dtype=torch.float64, device=dev)
    rec['faces'], rec['flags'] = [], []

    def splat(orig):
        def hooked(adc, cfg, t_off, f_out, value, active, *a, **k):
            rec['lane'] += torch.where(active, value.abs(), 0.0).double()
            return orig(adc, cfg, t_off, f_out, value, active, *a, **k)
        return hooked

    def closest(orig):
        def hooked(*a):
            res = orig(*a)
            rec['faces'].append(res[1].cpu())
            return res
        return hooked

    def anyhit(orig):
        def hooked(*a):
            res = orig(*a)
            rec['flags'].append(res.cpu())
            return res
        return hooked

    return Patch(s=(rp, '_adc_splat', splat),
                 c=(ik, 'ray_triangle_closest', closest),
                 a=(ik, 'ray_triangle_any', anyhit))


def _profile(torch, run, what, tag):
    """One call under torch.profiler: device time by kernel, the device's
    busy share of the call, the top kernels (the table goes to
    chiprun_out/)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(run)
    rows = prof.key_averages()

    def dev_us(r):
        for attr in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(r, attr):
                return float(getattr(r, attr))
        return 0.0

    # kernel rows only: an operator's row repeats its kernels' device time
    kern = [(r.key, dev_us(r), r.count) for r in rows
            if str(getattr(r, 'device_type', '')).endswith('CUDA')
            and dev_us(r) > 0]
    busy = sum(k[1] for k in kern) / 1e3
    if not kern:
        print(f'profile {what}: no device time recorded (not measured)')
        return None
    groups = {'K4 ray_triangle': 0.0, 'K2/K3 bvh': 0.0,
              'splat index_add': 0.0, 'gathers': 0.0, 'matmul': 0.0,
              'elementwise and other': 0.0}
    for name, us, _ in kern:
        if 'ray_triangle' in name:
            groups['K4 ray_triangle'] += us
        elif 'bvh_' in name:
            groups['K2/K3 bvh'] += us
        elif 'indexFunc' in name:
            groups['splat index_add'] += us
        elif 'gather' in name or 'index_elementwise' in name:
            groups['gathers'] += us
        elif 'gemv' in name or 'gemm' in name or 'bmm' in name:
            groups['matmul'] += us
        else:
            groups['elementwise and other'] += us
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out',
                           f'profile_{what}.txt'), 'w') as f:
        f.write(rows.table(sort_by='self_device_time_total'
                           if hasattr(rows[0], 'self_device_time_total')
                           else 'self_cuda_time_total', row_limit=60))
    top = sorted(kern, key=lambda k: -k[1])[:8]
    print(f'profile {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms '
          f'({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), '
          f'{sum(k[2] for k in kern)} kernel launches; by group (ms): '
          + json.dumps({k: round(v / 1e3, 3) for k, v in groups.items()})
          + f' {tag}')
    for name, us, cnt in top:
        print(f'  {us / 1e3:9.3f} ms {cnt:6d}x {name[:90]}')
    return dict(wall_ms=wall, busy_ms=busy, groups_ms={
        k: v / 1e3 for k, v in groups.items()})


def _layers(torch, run, tag):
    """Host wall time of the wavefront's layers in one call, each call of
    a layer ended by a synchronise: intersect (closest hit and shadow
    test, K4 / K2 / K3 inside), BSDF (eval and sample), splat, sample
    stream (Philox); the rest (ray generation, NEE sampling, waveforms,
    Doppler) is the remainder."""
    from beifong_tpu_torch import scene as sc_mod
    from beifong_tpu_torch.core import rng
    from beifong_tpu_torch.integrators import radar_path as rp
    spent = {'intersect': 0.0, 'bsdf': 0.0, 'splat': 0.0, 'rng': 0.0}

    def timed(key):
        def make(orig):
            def f(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = orig(*a, **k)
                torch.cuda.synchronize()
                spent[key] += (time.perf_counter() - t0) * 1e3
                return res
            return f
        return make

    patch = Patch(ri=(sc_mod.SceneData, 'ray_intersect', timed('intersect')),
                  rt=(sc_mod.SceneData, 'ray_test', timed('intersect')),
                  be=(rp, 'bsdf_eval_pdf', timed('bsdf')),
                  bs=(rp, 'bsdf_sample', timed('bsdf')),
                  sp=(rp, '_adc_splat', timed('splat')),
                  rn=(rng.SampleStream, 'uniform', timed('rng')))
    with patch:
        wall, _ = wall_ms(run)
    rest = wall - sum(spent.values())
    print(f'layers of one wavefront call (host ms, synchronised): total '
          f'{wall:.1f}; ' + ', '.join(f'{k} {v:.1f} ({100 * v / wall:.1f}%)'
                                      for k, v in spent.items())
          + f', rest {rest:.1f} ({100 * rest / wall:.1f}%) {tag}')
    return dict(spent, total=wall)


def _bin_coord(value, lo, hi, n):
    """Continuous bin-centre coordinate of value on [lo, hi) in n bins."""
    return (value - lo) / (hi - lo) * n - 0.5


def wavefront(torch, bt, ik, bk, rk, dev, tag, pulse_compress):
    """The eager wavefront's paths.  Returns (K4 launches on the
    multi_body path, K2 / K3 launches on the BVH path)."""
    import numpy as np
    from beifong_tpu_torch.integrators import radar_path as rp
    from beifong_tpu_torch.scenes import (MULTI_BODY, flagship_scene,
                                          mesh_scene, multi_body_scene,
                                          round_trip_bin)
    s, rx = multi_body_scene()
    sd = s.compile(use_bvh=False, device=dev)
    cfg = rx.adc
    kw = dict(max_depth=WF_DEPTH, time_sampling='gate', use_kernel='auto')
    why: list = []
    if rk.supported(sd, rx, why) or sd.bvh is not None:
        fail('multi_body: expected outside the receive kernel, without BVH')
    print(f'multi_body: {sd.tris.n_faces} faces, routed to the wavefront '
          f'({why[0]})')

    # ---- the main path: receive() at 2^22 samples ----
    ik.ray_triangle_closest.launches = ik.ray_triangle_any.launches = 0
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    rk.receive_megakernel.launches = 0
    bt.receive(s, sd, rx, seed=1, spp=WF_SAMPLES, device=dev, **kw)
    events: list = []
    with _k4_timer(torch, ik, events):
        call_ms, (adc, n) = cuda_ms(lambda i: bt.receive(
            s, sd, rx, seed=2 + i, spp=WF_SAMPLES, device=dev, **kw), 5)
    torch.cuda.synchronize()
    k4_ms = sum(a.elapsed_time(b) for a, b in events) / 5
    k4 = {'ray_triangle_closest': ik.ray_triangle_closest.launches,
          'ray_triangle_any': ik.ray_triangle_any.launches}
    n_pass = WF_SAMPLES // (1 << 17)
    want = 6 * n_pass * WF_DEPTH
    if k4 != {'ray_triangle_closest': want, 'ray_triangle_any': want} \
            or rk.receive_megakernel.launches or bk.bvh_closest.launches \
            or n != WF_SAMPLES:
        fail(f'multi_body path launched K4 {k4} times in 6 calls (want '
             f'{want} each), K1 {rk.receive_megakernel.launches}, K2 '
             f'{bk.bvh_closest.launches}; {n} samples')
    med = statistics.median(call_ms)
    print(f'receive() multi_body wavefront 2^22 samples depth 2: median '
          f'{med:.2f} ms/call ({WF_SAMPLES / (med * 1e-3):.4e} samples/s), '
          f'calls {[round(x, 2) for x in call_ms]}; K4 launches per call: '
          f'{k4["ray_triangle_closest"] // 6} closest + '
          f'{k4["ray_triangle_any"] // 6} any ({n_pass} passes) {tag}')
    print(f'K4 inside the timed receive() calls: {len(events) // 5} launches '
          f'and {k4_ms:.3f} ms per call, {100 * k4_ms / med:.2f}% of the '
          f'median call (CUDA events around each launch) {tag}')
    # the time by kernel, over one call of PROFILE_SAMPLES (the passes are
    # alike; the profiler's own host cost would lengthen a full call)
    _profile(torch, lambda: bt.receive(s, sd, rx, seed=10,
                                       spp=PROFILE_SAMPLES, device=dev,
                                       **kw),
             'multi_body', tag)
    _layers(torch, lambda: bt.receive(s, sd, rx, seed=11,
                                      spp=PROFILE_SAMPLES, device=dev,
                                      **kw), tag)

    # the example's anchors: each body in its range gate at its Doppler
    grid = bt.develop_signal(adc, n, cfg)[..., 0]
    if tuple(grid.shape) != (cfg.n_time, cfg.n_freq) \
            or not bool(torch.isfinite(grid).all()):
        fail(f'multi_body grid {tuple(grid.shape)} not finite / wrong shape')
    grid = grid.cpu().double().numpy()
    tx_pos = np.array([0.3, 0.0, 0.0])
    rx_pos = np.array([-0.3, 0.0, 0.0])
    fc = 40e3
    t_half = 1e-3        # half the 2 ms pulse: the echo's centre
    for name, p, vel in (
            ('body 1 (diffuse, static)', np.array([0.0, -MULTI_BODY['R1'],
                                                   0.0]), np.zeros(3)),
            ('body 2 (conductor, closing)',
             np.array([0.0, -MULTI_BODY['R2'], MULTI_BODY['lift2']]),
             np.array([0.0, MULTI_BODY['v2'], 0.0]))):
        tau = (np.linalg.norm(p - tx_pos) + np.linalg.norm(p - rx_pos)) \
            / s.band.c
        u_tx = (tx_pos - p) / np.linalg.norm(tx_pos - p)
        u_rx = (rx_pos - p) / np.linalg.norm(rx_pos - p)
        f_dop = fc * (vel @ u_tx + vel @ u_rx) / s.band.c
        t_bin = _bin_coord(tau + t_half, cfg.sampling_start,
                           cfg.sampling_start + cfg.sampling_time,
                           cfg.n_time)
        f_bin = _bin_coord(fc + f_dop, cfg.freq_lo, cfg.freq_hi, cfg.n_freq)
        tb = int(round(t_bin))
        spec = grid[max(tb - 1, 0):tb + 2].sum(axis=0)
        fpk = int(spec.argmax())
        tpk = int(grid[:, fpk].argmax())
        print(f'{name}: range gate {t_bin:.2f} (peak {tpk}), Doppler '
              f'{f_dop:+.1f} Hz at bin {f_bin:.2f} (peak {fpk})')
        if abs(fpk - f_bin) > 1 or abs(tpk - t_bin) > 1:
            fail(f'multi_body {name}: peak at time {tpk} / Doppler {fpk}, '
                 f'expected {t_bin:.2f} / {f_bin:.2f}')

    # ---- the same scene on the card and on the CPU, one seed ----
    rec_gpu: dict = {}
    rec_cpu: dict = {}
    kw1 = dict(kw, seed=4, spp=WF_CPU_SAMPLES)
    with _recorder(torch, ik, rp, rec_gpu, WF_CPU_SAMPLES, dev):
        a_gpu, _ = bt.receive(s, sd, rx, device=dev, **kw1)
    sd_cpu = s.compile(use_bvh=False, device='cpu')
    cpu_ms, a_cpu = wall_ms(lambda: _cpu_receive(torch, bt, ik, rp, s, sd_cpu,
                                                 rx, rec_cpu, kw1))
    moved = torch.zeros(WF_CPU_SAMPLES, dtype=torch.bool)
    for a, b in zip(rec_gpu['faces'] + rec_gpu['flags'],
                    rec_cpu['faces'] + rec_cpu['flags']):
        moved |= a != b
    n_moved = int(moved.sum())
    lane = (rec_gpu['lane'].cpu() + rec_cpu['lane'])
    slack = float(lane[moved].sum())
    ref = a_cpu[..., 0].double()
    err = float((a_gpu[..., 0].cpu().double() - ref).abs().max())
    scale = float(ref.abs().max())
    n_calls = len(rec_gpu['faces']) + len(rec_gpu['flags'])
    print(f'wavefront card against CPU, {WF_CPU_SAMPLES} samples, seed 4: '
          f'max|acc| {scale:.6e}, max abs err {err:.3e} ({err / scale:.3e} '
          f'of max); {n_moved} lanes with another K4 face or flag in '
          f'{n_calls} K4 calls (their |values| {slack:.3e}); CPU run '
          f'{cpu_ms:.0f} ms')
    if n_moved > 1e-4 * WF_CPU_SAMPLES * n_calls \
            or not (scale > 0 and err <= TOL * scale + slack):
        fail(f'wavefront: card and CPU differ ({err:.3e} > {TOL} x '
             f'{scale:.3e} + {slack:.3e}; {n_moved} lanes moved)')

    # ---- the flagship through the kernel and through the wavefront ----
    fs, frx = flagship_scene()
    fsd = fs.compile(device=dev)
    profs = {}
    for use in (True, False):
        ms, (a, nn) = wall_ms(lambda: bt.receive(
            fs, fsd, frx, seed=3, spp=FLAG_SAMPLES, max_depth=FLAG_DEPTH,
            time_sampling='gate', use_kernel=use, device=dev))
        profs[use] = bt.develop_signal(a, nn, frx.adc)[:, 0, 0].cpu().double()
        print(f'flagship use_kernel={use}: {ms:.1f} ms for 2^22 samples, '
              f'depth 3 {tag}')
    tk, tw = profs[True], profs[False]
    pk_k, pk_w = int(tk.argmax()), int(tw.argmax())
    lo_, hi_ = max(pk_w - 3, 0), pk_w + 4
    e_k, e_w = float(tk[lo_:hi_].sum()), float(tw[lo_:hi_].sum())
    print(f'flagship kernel against wavefront: peak bins {pk_k} / {pk_w} '
          f'(2R/c {round_trip_bin(fs, frx):.2f}), peak-window energy '
          f'{e_k:.4e} / {e_w:.4e} ({e_k / e_w - 1:+.3f})')
    if abs(pk_k - pk_w) > 1 or abs(e_k - e_w) > 0.6 * abs(e_w):
        fail('flagship: kernel and wavefront disagree')

    # ---- mesh_scene through the wavefront: BVH queries on K2 / K3 ----
    ms_, mrx = mesh_scene()
    t0 = time.perf_counter()
    msd = ms_.compile(device=dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    if msd.bvh is None:
        fail('mesh_scene compiled without the wavefront BVH')
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    ik.ray_triangle_closest.launches = 0
    bvh_ms, (a, nn) = wall_ms(lambda: bt.receive(
        ms_, msd, mrx, seed=5, spp=BVH_WF_SAMPLES, max_depth=2,
        time_sampling='gate', use_kernel=False, device=dev))
    bvh_l = {'bvh_closest': bk.bvh_closest.launches,
             'bvh_any': bk.bvh_any.launches}
    n_pass = BVH_WF_SAMPLES // (1 << 17)
    if bvh_l != {'bvh_closest': 2 * n_pass, 'bvh_any': 2 * n_pass} \
            or ik.ray_triangle_closest.launches:
        fail(f'BVH wavefront launched K2 / K3 {bvh_l}, K4 '
             f'{ik.ray_triangle_closest.launches}')
    print(f'mesh_scene wavefront ({msd.tris.n_faces} faces, BVH '
          f'{msd.bvh.n_nodes} nodes, compile {build_ms:.0f} ms): 2^20 '
          f'samples depth 2 in {bvh_ms:.1f} ms; K2 / K3 launches {bvh_l} '
          f'{tag}')
    check_profile(torch, bt, a, nn, mrx, round_trip_bin(ms_, mrx),
                  pulse_compress, 'mesh_scene wavefront')
    return k4, bvh_l


def _cpu_receive(torch, bt, ik, rp, s, sd_cpu, rx, rec, kw1):
    with _recorder(torch, ik, rp, rec, WF_CPU_SAMPLES, 'cpu'):
        a, _ = bt.receive(s, sd_cpu, rx, device='cpu', **kw1)
    return a


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a card')
    sys.path.insert(0, HERE)
    import beifong_tpu_torch as bt
    from beifong_tpu_torch.dsp.pulse import pulse_compress
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    from beifong_tpu_torch.integrators import receive_kernel as rk

    # ---- 1. device ----
    t_start = time.perf_counter()
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f'device: {name}  ({torch.cuda.device_count()} visible)  torch '
          f'{torch.__version__}  CUDA {torch.version.cuda}')
    print(card)
    tag = f'[{card}]'

    # ---- 2. build: one nvcc per source, all started together ----
    builders = {'receive_megakernel': rk.build_library,
                'bvh_kernels': bk.build_library,
                'intersect_kernels': ik.build_library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as ex:
        futures = {k: ex.submit(fn) for k, fn in builders.items()}
        infos = {k: f.result() for k, f in futures.items()}
    print_build(infos, tag)
    print(f'build wall {time.perf_counter() - t0:.1f} s {tag}')

    # ---- 3-4. each path: parity, then the path itself ----
    kernels = [flagship(torch, bt, rk, dev, tag, pulse_compress),
               mesh(torch, bt, rk, dev, tag, pulse_compress)]
    kernels += queries(torch, bt, dev, tag)
    k4 = k4_parity(torch, ik, dev, tag)
    k4_launches, bvh_launches = wavefront(torch, bt, ik, bk, rk, dev, tag,
                                          pulse_compress)
    for k in k4:
        k['launches'] = k4_launches[k['name']]
    for k in kernels:
        if k['name'] in bvh_launches:
            k['wavefront_launches'] = bvh_launches[k['name']]
    kernels += k4

    # ---- 5. report ----
    for k in kernels:
        k['card'] = card
    print(f'chip_smoke wall {time.perf_counter() - t_start:.1f} s {tag}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
