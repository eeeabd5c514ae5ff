#!/usr/bin/env python3
"""A/B of the receive megakernel built without and with FMA contraction
(nvcc --fmad=false / --fmad=true) on one card.

Run from the repository root:  python3 tools/fmad_ab.py [--pairs 10]

Each variant runs in a process of its own, in pairs whose order alternates
(off/on, on/off, ...).  A process builds the kernel with its flag, holds it
against the plain PyTorch version on injected uniforms (2^18 lanes, depth
3, gate and fixed), then times the flagship at 2^28 Philox lanes, depth 3:
the kernel alone and `receive()`, one warm-up and five calls each, with
CUDA events.  The first pair also holds each build's 2^28-lane output
against the plain version on the same Philox stream.  Prints one JSON line
per process, then a summary: per variant the median of the processes'
kernel medians, the pairs each side won, the spread of each side's
medians, and the largest parity gaps.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (card_line, cuda_ms, the flagship sizes)

PARITY_LANES = chip_smoke.PARITY_LANES
N_LANES = chip_smoke.N_LANES
PLAIN_CHUNK = chip_smoke.PLAIN_CHUNK
MAX_DEPTH = chip_smoke.MAX_DEPTH
SEED = chip_smoke.SEED


def gap(acc, n_ev, ref, n_ref) -> dict:
    scale = float(ref.abs().max())
    return dict(rel=float((acc - ref).abs().max()) / scale,
                events=int(n_ev), events_plain=int(n_ref))


def child(fmad: str, full: bool) -> dict:
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a card')
    import beifong_tpu_torch as bt
    from beifong_tpu_torch import _nvcc
    from beifong_tpu_torch.integrators import receive_kernel as rk
    from beifong_tpu_torch.scenes import flagship_scene

    _nvcc.NVCC_FLAGS = tuple(f for f in _nvcc.NVCC_FLAGS
                             if not f.startswith('--fmad')) \
        + (f'--fmad={fmad}',)
    info = rk.build_library()
    regs = [ln.strip() for ln in info.log.splitlines()
            if 'registers' in ln]
    dev = torch.device('cuda')
    s, rx = flagship_scene()
    sd = s.compile(device=dev)
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    out = dict(fmad=fmad, build_s=info.seconds, ptxas=regs)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    nd = rk.n_draws(MAX_DEPTH)
    for ts in ('gate', 'fixed'):
        u = torch.rand((nd, PARITY_LANES), generator=gen, device=dev)
        kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling=ts,
                  rx_kind='wigner')
        acc, n_ev = rk.receive_megakernel(params, prim, txp, uniforms=u,
                                          n_lanes=PARITY_LANES, **kw)
        ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
        out[f'injected_{ts}'] = gap(acc, n_ev, ref, n_ref)

    kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling='gate',
              rx_kind='wigner')

    def kernel(_):
        return rk.receive_megakernel(params, prim, txp, n_lanes=N_LANES,
                                     seed=SEED, **kw)

    def main_path(i):
        return bt.receive(s, sd, rx, seed=SEED + i, spp=N_LANES,
                          max_depth=MAX_DEPTH, time_sampling='gate',
                          device=dev)

    kernel(0)
    out['kernel_ms'], (acc, n_ev) = chip_smoke.cuda_ms(kernel, 5)
    main_path(0)
    out['receive_ms'], _ = chip_smoke.cuda_ms(main_path, 5)
    if full:
        ref = torch.zeros_like(acc)
        n_ref = 0
        for lane0 in range(0, N_LANES, PLAIN_CHUNK):
            u = rk.philox_uniforms(SEED, nd, PLAIN_CHUNK, device=dev,
                                   lane0=lane0)
            a, n = rk.receive_megakernel_ref(params, prim, txp, u, **kw)
            ref += a
            n_ref += int(n)
        out['philox_2^28'] = gap(acc, n_ev, ref, n_ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--pairs', type=int, default=10)
    ap.add_argument('--child', choices=('false', 'true'))
    ap.add_argument('--full', action='store_true')
    args = ap.parse_args()
    if args.child:
        print('RESULT ' + json.dumps(child(args.child, args.full)))
        return 0

    card = chip_smoke.card_line()
    print(card)
    runs = {'false': [], 'true': []}
    for i in range(args.pairs):
        order = ('false', 'true') if i % 2 == 0 else ('true', 'false')
        for fmad in order:
            cmd = [sys.executable, os.path.abspath(__file__), '--child', fmad]
            res = subprocess.run(cmd + (['--full'] if i == 0 else []),
                                 capture_output=True, text=True, cwd=HERE,
                                 timeout=600)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith('RESULT ')][-1]
            r = json.loads(line[len('RESULT '):])
            r['pair'] = i
            print(json.dumps(r), flush=True)
            runs[fmad].append(r)

    def med(r, key):
        return statistics.median(r[key])

    def quartile_gap(xs):
        q = statistics.quantiles(xs, n=4)
        return q[2] - q[0]

    summary = {'card': card}
    for fmad, rs in runs.items():
        ks = [med(r, 'kernel_ms') for r in rs]
        rcv = [med(r, 'receive_ms') for r in rs]
        summary[f'fmad={fmad}'] = dict(
            kernel_ms_median=statistics.median(ks),
            kernel_ms_iqr=quartile_gap(ks) if len(ks) > 1 else None,
            receive_ms_median=statistics.median(rcv),
            receive_ms_iqr=quartile_gap(rcv) if len(rcv) > 1 else None,
            max_rel_gap=max(r[k]['rel'] for r in rs for k in r
                            if isinstance(r[k], dict)),
            max_event_gap=max(abs(r[k]['events'] - r[k]['events_plain'])
                              / r[k]['events_plain']
                              for r in rs for k in r
                              if isinstance(r[k], dict)))
    summary['pairs_won_by_fmad_true'] = sum(
        med(b, 'kernel_ms') < med(a, 'kernel_ms')
        for a, b in zip(runs['false'], runs['true']))
    summary['pairs'] = args.pairs
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
