#!/usr/bin/env python3
"""How wide the I / Q gate of the coherent prims twins is, and what it
still catches, for each threshold of the curved-root term of the plain
version's `cond_out` (`receive_kernel.CURVED_ROOT_U`).

Run from the repository root on the CPU (g++ for the fault sweep):

    python3 tools/cond_gate.py [--lanes 12] [--roots inf,1,3]

A root threshold of inf gives every hit the 1 u of the earlier gate
(no root term); 1 applies the term wherever it exceeds that 1 u; 3 is
the plain version's own.  For each cell (the flagship's I / Q sphere,
cylinder and sphere over the checkerboard, depth 2; the range-Doppler
pulse's closing sphere, the flagship's GGX sphere and golden config 2's
sonar sphere under mix_resample, depth 2) it runs the plain version on
2^lanes Philox lanes and prints one line `GATE {json}`: per threshold
the connections' own slack over the amplitude sum (cond / amp, the gate
being the phase slack times amp + cond) and the gate's largest cell over
the threshold-inf gate's.  Then, with the coherent prims twin compiled
by g++ against the CUDA stub (`tools/k1_emulate.py`), a planted fault:
the kernel's target moved k u / 2 further from the receiver (each of its
connections k u longer, u = 4 ulps of the longest path), held against
the plain version on the true tables with each threshold's gate, lane
by lane as `chip_smoke.compare_coherent`.  One line `FAULT {json}` a
cell: the worst cell's share of its bound for each k (0: no fault) and
threshold; at or above 1 the gate catches the fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = (0, 4, 16, 64, 256)    # k: the target's paths k u longer
DEPTH = 2


def cells():
    """name -> (scene builder, time sampling)."""
    sys.path.insert(0, HERE)
    from beifong_tpu_torch import scenes as S
    return {
        'flagship_sphere': (lambda: S.flagship_scene(target='sphere'),
                            'gate'),
        'flagship_cylinder': (lambda: S.flagship_scene(target='cylinder'),
                              'gate'),
        'flagship_sphere_checker': (lambda: S.flagship_scene(
            target='sphere', ground_texture='checkerboard'), 'gate'),
        'closing_sphere': (lambda: S.range_doppler_scene(0, 'sphere'),
                           'gate'),
        'ggx_sphere': (lambda: S.flagship_scene(
            target='sphere', material='rough_conductor'), 'gate'),
        'sonar_sphere': (lambda: S.fmcw_sonar_scene(target='sphere'),
                         'fixed'),
    }


def plain(rk, torch, tab, kw, prim, u, n, root_u):
    """The plain version with `root_u` for CURVED_ROOT_U: (I / Q, events,
    amp, cond, lane sums)."""
    keep = rk.CURVED_ROOT_U
    rk.CURVED_ROOT_U = root_u
    try:
        adc = kw['adc']
        amp = torch.zeros((adc.n_time, adc.n_freq), dtype=torch.float64)
        cond = torch.zeros_like(amp)
        lane = torch.zeros(n)
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, prim, tab.txp, u, amp_out=amp, cond_out=cond,
            lane_out=lane, **kw)
    finally:
        rk.CURVED_ROOT_U = keep
    return ref, n_ref, amp, cond, lane


def moved(torch, prim, idx, k, u_len):
    """The prim rows with record `idx` (a sphere's or cylinder's object
    frame, world -> object in columns 1-12) moved k u / 2 along the line
    from the origin to its centre."""
    p = prim.clone()
    m = p[idx, 1:13].view(3, 4)
    centre = -torch.linalg.solve(m[:, :3].double(), m[:, 3].double())
    d = (k * u_len / 2 * centre / centre.norm()).float()
    p[idx, 1:13].view(3, 4)[:, 3] -= m[:, :3] @ d
    return p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--lanes', type=int, default=12,
                    help='log2 of the Philox lanes a run')
    ap.add_argument('--roots', default='inf,1,3',
                    help='CURVED_ROOT_U values to compare')
    ap.add_argument('--no-faults', action='store_true',
                    help='the gate widths only (no g++)')
    args = ap.parse_args()
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import chip_smoke as cs
    from beifong_tpu_torch.integrators import receive_kernel as rk
    n = 1 << args.lanes
    roots = [float(r) for r in args.roots.split(',')]
    lib = None
    if not args.no_faults:
        import k1_emulate
        out = os.path.join(tempfile.mkdtemp(), 'k1.so')
        lib = k1_emulate._library(k1_emulate.emulate(HERE, out, '-O1'))
        rk.LIBRARY = lib
        torch.cuda.device = lambda d: contextlib.nullcontext()
        torch.cuda.current_stream = \
            lambda d=None: types.SimpleNamespace(cuda_stream=0)
    for name, (fn, ts) in cells().items():
        s, rx = fn()
        tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
        kw = dict(adc=rx.adc, max_depth=DEPTH, time_sampling=ts,
                  rx_kind='wigner', doppler=True, coherent=True,
                  mirror=tab.mirror, has_lo=rx.lo_waveform is not None,
                  receive_type=rx.receive_type)
        u = rk.philox_uniforms(13, rk.n_draws(DEPTH), n)
        runs = {r: plain(rk, torch, tab, kw, tab.prim, u, n, r)
                for r in roots}
        base = runs[float('inf')] if float('inf') in runs else None
        gate = {}
        for r, (ref, _, amp, cond, _) in runs.items():
            g = amp + cond
            gate[str(r)] = {
                'cond_over_amp': float(cond.sum() / amp.sum()),
                'max_cell_over_1u_gate': None if base is None else
                float(g.max() / (base[2] + base[3]).max())}
        print('GATE ' + json.dumps({'cell': name, 'lanes': n,
                                    'gates': gate}), flush=True)
        if lib is None:
            continue
        slack = rk.phase_slack(s.band, rx.adc)
        l_max = s.band.c * (rx.adc.sampling_start + rx.adc.sampling_time)
        u_len = 4 * float(np.spacing(np.float32(l_max)))
        idx = int(((tab.prim[:, 0] == rk.SPHERE)
                   | (tab.prim[:, 0] == rk.CYLINDER)).nonzero()[0])
        launch = k1_emulate.launch_kw(kw)
        reading: dict = {}
        for k in FAULTS:
            lane = torch.zeros(n)
            acc, ev = rk._launch(
                tab.params, moved(torch, tab.prim, idx, k, u_len), tab.txp,
                None, None, None, lane, n_pulses=1, n_lanes=n, seed=13,
                seed_step=0, patch_p=0, prims=True, **launch)
            for r, (ref, n_ref, amp, cond, lane_ref) in runs.items():
                c = cs.compare_coherent(
                    torch, acc.view(ref.shape), ev[0], ref, n_ref, amp,
                    slack, name, lane, lane_ref, depth=DEPTH, quiet=True,
                    cond=cond, check=False)
                reading.setdefault(str(r), {})[k] = round(c['worst'], 4)
            reading.setdefault('no_cond', {})[k] = round(c['worst_plain'],
                                                         4)
        print('FAULT ' + json.dumps({'cell': name, 'lanes': n, 'u_m': u_len,
                                     'worst_of_gate': reading}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
