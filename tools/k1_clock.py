#!/usr/bin/env python3
"""Where a warp-wavefront kernel's time goes, by the SM's clock: a copy of
the receive kernel whose warp loop reads clock64() at each turn's
boundaries (lane 0 of each warp, after a __syncwarp), summed over the
warps, at a main path's shape: the flagship (receive_flagship_kernel,
2^28 Philox lanes, depth 3), the coherent kernel
(receive_coherent_kernel) on pulse 0 of the pulse train (2^24 lanes,
depth 1) or the dechirp (2^24, depth 2), or the analytic lobe twins'
kernel (receive_lobe_kernel) on the windowed corner (2^24 lanes, depth
6; window_thin in power, window_dielectric in I / Q).

Run from the repository root on the card's machine:

    python3 tools/k1_clock.py [DIR] [--splat] [--config NAME]

It copies DIR's (default: this checkout's) `beifong_tpu_torch` into
`beifong_tpu_torch/_build/k1_clock/` (ignored by git), adds the clocks to
the configuration's kernel there (the turn's choice and slot hand-out,
RAY's ray, SHADE's shading (the coherent kernel's echo phase and, past
its warp rows, its grid splat) and bounce, the trace after each, the
waiting-set update, the warp splat), builds it, times one call after a
warm-up, and prints
one line `CLK {json}`: each part's share of the warps' cycles, the turns
and how full SHADE's were; with --splat also the cycles a SHADE turn of
the splat's phases (lane 0's clock, added to global counters; the
flagship's splat only).  The added __syncwarp()s and clock reads cost
time of their own: read the shares, not the call's time.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ('turn', 'ray', 'shade', 'trace_of_ray', 'trace_of_shade', 'masks',
         'splat')
# each configuration's kernel and the warp splat's call in its loop
KERNELS = {'flagship': 'receive_flagship_kernel',
           'pulse_train': 'receive_coherent_kernel',
           'dechirp': 'receive_coherent_kernel',
           'window_thin': 'receive_lobe_kernel',
           'window_dielectric': 'receive_lobe_kernel'}
SPLAT_CALL = {
    'receive_flagship_kernel':
        '        if (shade) {\n            // [k1 stage: splat]\n'
        '            flag_splat(w_row, w_mask, w_vals, cfg.n_time, val, yb, '
        'j);\n',
    'receive_coherent_kernel':
        '        if (shade && rows) {\n            // [k1 stage: splat]\n'
        '            coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, '
        'j);\n',
    'receive_lobe_kernel':
        '        if (shade && rows) {\n            // [k1 stage: splat]\n'
        '            if constexpr (COH)\n'
        '                coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, '
        'j);\n'
        '            else\n'
        '                pow_splat_rows(w_row, w_vals, cfg.n_time, ci, yb, j);'
        '\n'}

# (anchor in the source, text that replaces it)
PATCH = (
    ('// rect_hit on a rectangle\'s world-to-local rows held as float4s.',
     '__device__ unsigned long long k1_clk[16];\n\n'
     '// rect_hit on a rectangle\'s world-to-local rows held as float4s.'),
    ('    for (;;) {\n        // [k1 stage: sched]  the turn:',
     '    unsigned long long ck[16] = {0};\n'
     '    for (;;) {\n'
     '        const long long c0 = clock64();\n'
     '        // [k1 stage: sched]  the turn:'),
    ('        const int slot = j < n_go ? w_take[j] : -1;',
     '        const int slot = j < n_go ? w_take[j] : -1;\n'
     '        const long long c1 = clock64();\n'
     '        ck[0] += c1 - c0;\n'
     '        ck[shade ? 9 : 8] += 1;\n'
     '        ck[10] += shade ? n_go : 0;'),
    ('        // [k1 stage: trace]  the closest rectangle of the turn\'s rays',
     '        __syncwarp();\n'
     '        const long long c2 = clock64();\n'
     '        ck[shade ? 2 : 1] += c2 - c1;\n'
     '        ck[11] += __popc(__ballot_sync(FULL_MASK, live));\n'
     '        // [k1 stage: trace]  the closest rectangle of the turn\'s rays'),
    ('        // [k1 stage: sched]  the waiting set:',
     '        __syncwarp();\n'
     '        const long long c3 = clock64();\n'
     '        ck[shade ? 4 : 3] += c3 - c2;\n'
     '        // [k1 stage: sched]  the waiting set:'),
    ('{splat}        }}\n    }}',
     '        const long long c4 = clock64();\n'
     '        ck[5] += c4 - c3;\n'
     '{splat}'
     '        }}\n'
     '        ck[6] += clock64() - c4;\n'
     '    }}\n'
     '    if (j == 0)\n'
     '        for (int k = 0; k < 16; ++k) atomicAdd(&k1_clk[k], ck[k]);'),
    ('const char* rk_error_string(int err) {',
     'int rk_clock(unsigned long long* out, int reset) {\n'
     '    cudaError_t e = cudaMemcpyFromSymbol(out, k1_clk, sizeof(k1_clk));\n'
     '    if (e != cudaSuccess || !reset) return (int)e;\n'
     '    unsigned long long z[16] = {0};\n'
     '    return (int)cudaMemcpyToSymbol(k1_clk, z, sizeof(z));\n'
     '}\n\n'
     'const char* rk_error_string(int err) {'),
)


# with --splat: the splat's own phases (lane 0 of each warp adds to global
# counters 12-15 after each: the groups' ORs and staging, the mask reads,
# the bins of lanes' tap 0, those of tap 1 alone)
SPLAT_PATCH = (
    ('    if (!__any_sync(FULL_MASK, i0 != -2)) return;\n'
     '    const bool ok0',
     '    if (!__any_sync(FULL_MASK, i0 != -2)) return;\n'
     '    long long q0 = clock64();\n'
     '    const bool ok0'),
    ('    vals[32 + j] = v1;\n    __syncwarp();\n',
     '    vals[32 + j] = v1;\n    __syncwarp();\n'
     '    long long q1 = clock64();\n'
     '    if (j == 0) atomicAdd(&k1_clk[12], (unsigned long long)(q1 - q0));\n'),
    ('    const bool lead1 = ok1 && (g11 & lt) == 0u && tap0[i0 + 1] == 0u;\n'
     '    __syncwarp();\n',
     '    const bool lead1 = ok1 && (g11 & lt) == 0u && tap0[i0 + 1] == 0u;\n'
     '    __syncwarp();\n'
     '    long long q2 = clock64();\n'
     '    if (j == 0) atomicAdd(&k1_clk[13], (unsigned long long)(q2 - q1));\n'),
    ('        tap1[i0] = 0u;\n    }\n',
     '        tap1[i0] = 0u;\n    }\n    __syncwarp();\n'
     '    long long q3 = clock64();\n'
     '    if (j == 0) atomicAdd(&k1_clk[14], (unsigned long long)(q3 - q2));\n'),
    ('        tap1[i0 + 1] = 0u;\n    }\n}',
     '        tap1[i0 + 1] = 0u;\n    }\n    __syncwarp();\n'
     '    if (j == 0) atomicAdd(&k1_clk[15], '
     '(unsigned long long)(clock64() - q3));\n}'),
)


def _patch_body(s: str, head: str, patch) -> str:
    """`s` with `patch` applied inside the function whose definition
    starts at `head` (each anchor once there)."""
    if s.count(head) != 1:
        raise SystemExit(f'{head!r} not found once')
    a = s.index(head)
    b = s.index('\n}\n', a) + 3
    body = s[a:b]
    for old, new in patch:
        if body.count(old) != 1:
            raise SystemExit(f'anchor not found once: {old[:60]!r}')
        body = body.replace(old, new)
    return s[:a] + body + s[b:]


def instrument(s: str, splat: bool = False,
               kernel: str = 'receive_flagship_kernel') -> str:
    """The receive kernel's source `s` with the clock reads added to the
    warp loop of `kernel`; each anchor must appear exactly once (the
    loop's within the kernel's body)."""
    loop = tuple((old.format(splat=SPLAT_CALL[kernel]),
                  new.format(splat=SPLAT_CALL[kernel]))
                 if '{splat}' in old else (old, new)
                 for old, new in PATCH[1:-1])
    glob = (PATCH[0], PATCH[-1])
    if splat:
        if kernel != 'receive_flagship_kernel':
            raise SystemExit('--splat reads the flagship splat alone')
        # k1_clk must be declared before flag_splat: move its declaration
        decl = '// The sum of the values of a (nonempty) group of lanes,'
        glob = ((decl, '__device__ unsigned long long k1_clk[16];\n\n'
                 + decl), PATCH[-1])
        s = _patch_body(s, 'void flag_splat(double* row', SPLAT_PATCH)
    s = _patch_body(s, f'{kernel}(const float* __restrict__ params,', loop)
    for old, new in glob:
        if s.count(old) != 1:
            raise SystemExit(f'anchor not found once: {old[:60]!r}')
        s = s.replace(old, new)
    return s


def instrumented_copy(root: str, splat: bool = False,
                      kernel: str = 'receive_flagship_kernel') -> str:
    dst = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'k1_clock')
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    src = os.path.join(dst, 'beifong_tpu_torch', 'csrc',
                       'receive_megakernel.cu')
    with open(src) as f:
        s = f.read()
    with open(src, 'w') as f:
        f.write(instrument(s, splat, kernel))
    return dst


def run(tree: str, config: str = 'flagship') -> dict:
    sys.path.insert(0, tree)
    import torch
    from beifong_tpu_torch import scenes
    from beifong_tpu_torch.integrators import receive_kernel as rk
    assert rk.__file__.startswith(tree)
    dev = torch.device('cuda')
    s, rx = {'flagship': scenes.flagship_scene,
             'pulse_train': lambda: scenes.pulse_train_scene(0),
             'dechirp': scenes.fmcw_dechirp_scene,
             'window_thin': lambda: scenes.window_corner_scene('thin'),
             'window_dielectric':
                 lambda: scenes.window_corner_scene('dielectric')}[config]()
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    kw = dict(adc=rx.adc, max_depth=3, time_sampling='gate',
              rx_kind='wigner', n_lanes=1 << 28, seed=7)
    if config != 'flagship':
        kw.update(max_depth=1 if config == 'pulse_train' else 2,
                  n_lanes=1 << 24, doppler=True, coherent=True,
                  receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror))
    if config.startswith('window_'):
        kw.update(max_depth=6, coherent=config == 'window_dielectric',
                  lobes=p.lobes)
    lib = rk.LIBRARY.get()
    lib.rk_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 16)()
    rk.receive_megakernel(params, prim, txp, **kw)
    torch.cuda.synchronize()
    rk.LIBRARY.check(lib.rk_clock(buf, 1), 'rk_clock')
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rk.receive_megakernel(params, prim, txp, **kw)
    b.record()
    torch.cuda.synchronize()
    rk.LIBRARY.check(lib.rk_clock(buf, 1), 'rk_clock')
    v = list(buf)
    tot = sum(v[:len(NAMES)])
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    return {'card': card, 'config': config,
            'instrumented_ms': a.elapsed_time(b),
            'share': {n: v[i] / tot for i, n in enumerate(NAMES)},
            'warp_cycles_a_lane': tot * 32 / kw['n_lanes'],
            'splat_phases': {n: v[12 + i] / max(1, v[9]) for i, n in
                             enumerate(('ors_and_staging', 'mask_reads',
                                        'tap0_bins', 'tap1_bins'))},
            'ray_turns': v[8], 'shade_turns': v[9],
            'shade_fill': v[10] / max(1, 32 * v[9]),
            'traced_a_turn': v[11] / max(1, v[8] + v[9])}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == '--child':
        print('CLK ' + json.dumps(run(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    argv = sys.argv[1:]
    config = 'flagship'
    if '--config' in argv:
        i = argv.index('--config')
        config = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if a != '--splat']
    root = os.path.abspath(args[0] if args else HERE)
    tree = instrumented_copy(root, '--splat' in argv, KERNELS[config])
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          '--child', tree, config], capture_output=True,
                         text=True)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-4000:])
    return res.returncode


if __name__ == '__main__':
    sys.exit(main())
