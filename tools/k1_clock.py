#!/usr/bin/env python3
"""Where a warp-wavefront kernel's time goes, by the SM's clock: a copy of
the receive kernel whose warp loop reads clock64() at each turn's
boundaries (lane 0 of each warp, after a __syncwarp), summed over the
warps, at a main path's shape: the flagship (receive_flagship_kernel,
2^28 Philox lanes, depth 3; flagship_prims its prims twin on the same
scene, flagship_prims_tex the twin that carries the texture codes there,
flagship_sphere the prims twin on the sphere target), the coherent kernel
(receive_coherent_kernel) on pulse 0 of the pulse train (2^24 lanes,
depth 1) or the dechirp (2^24, depth 2), the analytic lobe twins'
kernel (receive_lobe_kernel) on the windowed corner (2^24 lanes, depth
6; window_thin in power, window_dielectric in I / Q), or the endpoint
kernels (receive_endpoint_kernel, receive_endpoint_coherent_kernel) on
the endpoint scenes (2^24 lanes, depth 2: ep_phased_tx, ep_phased_rx,
ep_four_tx in power, ep_phased_tx_coh in I / Q), where SHADE's
sub-stages are also read: each thread's cycles in the NEE's and the
receiver's cross-WDFs and the shadow loops (over 32: warp cycles where
a whole warp runs them), and the warp's cycles in the splats.  In a
tree before the endpoint kernels the endpoint configurations read the
grid-stride twins instead: each thread's cycles in its lanes and, of
them, in the cross-WDFs (pair_sum), the NEEs, the shadow loops and the
splats.  The analytic Doppler power kernel (receive_doppler_power_kernel)
runs range_doppler (pulse 0 of the range-Doppler example, gate) and
fmcw_sonar (golden config 2, fixed sampling) at 2^24 lanes, depth 2,
with each thread's cycles in SHADE's grid splat (the block's or the
global grid's atomics) read inside it, and its twins on the
range-Doppler pulse (doppler_sphere: the prims twin on a closing sphere;
doppler_checker: the texture twin over the checkerboard ground;
doppler_sphere_checker: both; `tools/tree_ab.py`'s scenes); in a tree
before that kernel the grid-stride instantiation's per-thread stage
cycles instead.  The
mesh Doppler kernel (receive_mesh_doppler_kernel) runs multi_body (the
Doppler mesh in power), mesh_lobes_iq and mesh_lobes_power (the
rough-plastic mesh_scene in I / Q and in power) and coherent_mesh (the
diffuse mesh_scene in I / Q) at 2^24 lanes, depth 2, with the main path's
direction strata, reading inside its turns each thread's cycles in the
closest-hit walks (the trace after RAY and after SHADE), in NEE's shadow
walk and in the block's power grid splat; in a tree whose configuration
runs the grid-stride instantiation (before the mesh Doppler kernel, or
before its instantiation for that configuration) that instantiation's
per-thread cycles in its lanes, their closest-hit walks, shadow walks
and grid splats.  The mesh kernel (receive_mesh_kernel) runs `mesh` (the
diffuse mesh_scene in power, 2^24 lanes, depth 2, the main path's
strata) with each thread's cycles in its walks, the MIMO array kernel
(receive_mimo_array_kernel) `mimo` (golden config 6, 2^24 lanes, depth
2) with each thread's cycles in SHADE's part of its connections' splats
(mimo_stage) and the warp's element taps as its splat;
in a tree before them the grid-stride instantiation's lanes, and their
walks or element loops.

Run from the repository root on the card's machine:

    python3 tools/k1_clock.py [DIR] [--splat] [--config NAME[,NAME...]]

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
           'flagship_prims': 'receive_flagship_kernel',
           'flagship_prims_tex': 'receive_flagship_kernel',
           'flagship_sphere': 'receive_flagship_kernel',
           'pulse_train': 'receive_coherent_kernel',
           'dechirp': 'receive_coherent_kernel',
           'window_thin': 'receive_lobe_kernel',
           'window_dielectric': 'receive_lobe_kernel',
           'ep_phased_tx': 'receive_endpoint_kernel',
           'ep_phased_rx': 'receive_endpoint_kernel',
           'ep_four_tx': 'receive_endpoint_kernel',
           'ep_phased_tx_coh': 'receive_endpoint_coherent_kernel',
           'range_doppler': 'receive_doppler_power_kernel',
           'fmcw_sonar': 'receive_doppler_power_kernel',
           'doppler_sphere': 'receive_doppler_power_kernel',
           'doppler_checker': 'receive_doppler_power_kernel',
           'doppler_sphere_checker': 'receive_doppler_power_kernel',
           'multi_body': 'receive_mesh_doppler_kernel',
           'mesh_lobes_iq': 'receive_mesh_doppler_kernel',
           'mesh_lobes_power': 'receive_mesh_doppler_kernel',
           'coherent_mesh': 'receive_mesh_doppler_kernel',
           'mesh': 'receive_mesh_kernel',
           'mimo': 'receive_mimo_array_kernel'}
# the mesh Doppler kernel's instantiation of each mesh configuration, as
# rk_launch launches it in a tree that has it
MDK_LAUNCH = {c: f'launch(receive_mesh_doppler_kernel<{f}>' for c, f in (
    ('multi_body', 'false, false'), ('mesh_lobes_iq', 'true, true'),
    ('mesh_lobes_power', 'false, true'), ('coherent_mesh', 'true, false'))}
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


# the endpoint kernels' warp loops: their ends (no warp splat there: each
# transmitter's splats inside SHADE), and their sub-stages' clocks: the
# NEE's cross-WDF (12), the shadow loop (13), the receiver's cross-WDF
# (15), per thread; the splats inside SHADE (14), per warp
EP_KERNELS = ('receive_endpoint_kernel', 'receive_endpoint_coherent_kernel')
EP_LOOP_END = {
    'receive_endpoint_kernel':
        '                | __reduce_or_sync(FULL_MASK, hi && hit ? bit : '
        '0u);\n    }\n',
    'receive_endpoint_coherent_kernel':
        '                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : '
        '0u);\n    }\n'}
EP_SPLAT = {
    'receive_endpoint_kernel':
        '                flag_splat(w_row, w_mask, w_vals, cfg.n_time, val, '
        'yb, j);\n',
    'receive_endpoint_coherent_kernel':
        '                    coh_splat_rows(w_row, w_vals, cfg.n_time, ci, '
        'si, yb, j);\n'}


# the Doppler power kernel's loop end (its warp splats) and its grid
# splat inside SHADE, per thread (14)
DPW_KERNEL = 'receive_doppler_power_kernel'
DPW_PATCH = PATCH[1:5] + (
    ('            pow_splat_rows(w_row, w_vals, cfg.n_time, pv, yb, j);\n'
     '        }\n    }\n',
     '            pow_splat_rows(w_row, w_vals, cfg.n_time, pv, yb, j);\n'
     '        }\n'
     '        ck[5] += clock64() - c3;\n    }\n'
     '    for (int k = 0; k < 16; ++k)\n'
     '        if (j == 0 || k == 14)\n'
     '            atomicAdd(&k1_clk[k], ck[k]);\n'),
    ('                    grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {\n'
     '                        return bin_freq(cfg, txw, lo, f_recv, t_recv);\n'
     '                    });\n',
     '                    const long long q3 = clock64();\n'
     '                    grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {\n'
     '                        return bin_freq(cfg, txw, lo, f_recv, t_recv);\n'
     '                    });\n'
     '                    ck[14] += clock64() - q3;\n'))


# the mesh Doppler kernel's loop end (its warp splats), and per thread its
# closest-hit walks (12), shadow walks (13) and grid splat (14)
MDK_KERNEL = 'receive_mesh_doppler_kernel'
MDK_PATCH = PATCH[1:5] + (
    ('                pow_splat_rows(w_row, w_vals, cfg.n_time, ci, yb, j);\n'
     '        }\n    }\n',
     '                pow_splat_rows(w_row, w_vals, cfg.n_time, ci, yb, j);\n'
     '        }\n'
     '        ck[5] += clock64() - c3;\n    }\n'
     '    for (int k = 0; k < 16; ++k)\n'
     '        if (j == 0 || k == 12 || k == 13 || k == 14)\n'
     '            atomicAdd(&k1_clk[k], ck[k]);\n'),
    ('            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), '
     'mc);\n',
     '            const long long q0 = clock64();\n'
     '            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), '
     'mc);\n'
     '            ck[12] += clock64() - q0;\n'),
    ('                        bvh::walk(mesh_b,\n'
     '                                  bvh::make_ray(sx, sy, sz, wx_, wy_, '
     'wz_),\n                                  sh);\n',
     '                        const long long q1 = clock64();\n'
     '                        bvh::walk(mesh_b,\n'
     '                                  bvh::make_ray(sx, sy, sz, wx_, wy_, '
     'wz_),\n                                  sh);\n'
     '                        ck[13] += clock64() - q1;\n'),
    ('                        grid_splat<false>(grid, cfg, val, 0.0f, yb, '
     '[&] {\n',
     '                        const long long q2 = clock64();\n'
     '                        grid_splat<false>(grid, cfg, val, 0.0f, yb, '
     '[&] {\n'),
    ('                            return bin_freq(cfg, txw, lo, f_recv, '
     't_recv);\n                        });\n                    }\n'
     '                }\n',
     '                            return bin_freq(cfg, txw, lo, f_recv, '
     't_recv);\n                        });\n'
     '                        ck[14] += clock64() - q2;\n'
     '                    }\n                }\n'))


# the mesh kernel's warp loop (the flagship's turns, its warp splat at the
# loop's end), and per thread its closest-hit walks (12) and shadow walks
# (13)
MSK_KERNEL = 'receive_mesh_kernel'
MSK_SPLAT = ('        if (shade) {\n            // [k1 stage: splat]\n'
             '            pow_splat_rows(w_row, w_vals, cfg.n_time, val, yb, '
             'j);\n')
MSK_PATCH = tuple(
    (old.format(splat=MSK_SPLAT), new.format(splat=MSK_SPLAT))
    if '{splat}' in old else (old, new) for old, new in PATCH[1:-1]) + (
    ('    if (j == 0)\n'
     '        for (int k = 0; k < 16; ++k) atomicAdd(&k1_clk[k], ck[k]);',
     '    for (int k = 0; k < 16; ++k)\n'
     '        if (j == 0 || k == 12 || k == 13)\n'
     '            atomicAdd(&k1_clk[k], ck[k]);'),) + MDK_PATCH[5:7]


# the MIMO array kernel's warp loop (the coherent kernel's turns, its warp
# element taps at the loop's end), and per thread SHADE's part of its
# connections' splats, the echo phase and the taps' staging (14)
MAK_KERNEL = 'receive_mimo_array_kernel'
MAK_SPLAT = ('        if (shade) {\n            // [k1 stage: splat]\n'
             '            mimo_warp_taps(grid, cfg, w_st, taps, j);\n')
MAK_PATCH = tuple(
    (old.format(splat=MAK_SPLAT), new.format(splat=MAK_SPLAT))
    if '{splat}' in old else (old, new) for old, new in PATCH[1:-1]) + (
    ('    if (j == 0)\n'
     '        for (int k = 0; k < 16; ++k) atomicAdd(&k1_clk[k], ck[k]);',
     '    for (int k = 0; k < 16; ++k)\n'
     '        if (j == 0 || k == 14)\n'
     '            atomicAdd(&k1_clk[k], ck[k]);'),
    ('                lsum += mimo_stage(cfg, tx, lo, sp, val, yb, f_recv, '
     't_recv,\n',
     '                const long long q2 = clock64();\n'
     '                lsum += mimo_stage(cfg, tx, lo, sp, val, yb, f_recv, '
     't_recv,\n'),
    ('                events += val != 0.0f;\n            }\n\n'
     '            // [k1 stage: bounce]',
     '                events += val != 0.0f;\n'
     '                ck[14] += clock64() - q2;\n            }\n\n'
     '            // [k1 stage: bounce]'))


def ep_patch(kernel: str) -> tuple:
    """(anchor, text) of an endpoint kernel's loop: the turn clocks of
    PATCH, its loop's end, and its sub-stages'."""
    end = EP_LOOP_END[kernel]
    splat = EP_SPLAT[kernel]
    return PATCH[1:5] + (
        (end,
         end[:-6] + '\n        ck[5] += clock64() - c3;\n    }\n'
         '    for (int k = 0; k < 16; ++k)\n'
         '        if (j == 0 || k == 12 || k == 13 || k == 15)\n'
         '            atomicAdd(&k1_clk[k], ck[k]);\n'),
        ('thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz,\n'
         '                                            lam);',
         '{ const long long q0 = clock64();\n'
         'thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz, lam);\n'
         'ck[15] += clock64() - q0; }'),
        ('                        // [k1 stage: nee_pairs]\n',
         '                        // [k1 stage: nee_pairs]\n'
         '                        const long long q1 = clock64();\n'),
        ('                        // [k1 stage: nee]\n'
         '                        float w_tx = sig * tr.gain * ap * TP;',
         '                        ck[12] += clock64() - q1;\n'
         '                        // [k1 stage: nee]\n'
         '                        float w_tx = sig * tr.gain * ap * TP;'),
        ('                        // [k1 stage: shadow]\n'
         '                        bool occ = false;\n',
         '                        // [k1 stage: shadow]\n'
         '                        const long long q2 = clock64();\n'
         '                        bool occ = false;\n'),
        ('                            occ = hit_p && t_p > F(1e-4) && t_p < '
         'limit;\n                        }\n',
         '                            occ = hit_p && t_p > F(1e-4) && t_p < '
         'limit;\n                        }\n'
         '                        ck[13] += clock64() - q2;\n'),
        (splat,
         '                __syncwarp();\n'
         '                const long long q3 = clock64();\n' + splat
         + '                __syncwarp();\n'
         '                ck[14] += clock64() - q3;\n'))


# the grid-stride endpoint twins (a parent before the endpoint kernels):
# each thread's cycles in its lanes (0), their cross-WDFs (1), NEEs (2),
# shadow loops (3) and splats (4), summed per thread in shared memory
# and added to the counters at the block's end
GRID_NAMES = ('lane', 'pairs', 'nee', 'shadow', 'splat')
GRID_PATCH = (
    ('__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {',
     '__device__ unsigned long long k1_clk[16];\n'
     '__shared__ unsigned k1_acc[5][256];\n\n'
     '__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {'),
    ('    if (i0 >= 0) hist[i0 * T] += val * fmaxf(1.0f - fabsf(yb - b0), '
     '0.0f);\n',
     '    const long long k1_s0 = clock64();\n'
     '    if (i0 >= 0) hist[i0 * T] += val * fmaxf(1.0f - fabsf(yb - b0), '
     '0.0f);\n'),
    ('        hist[(i0 + 1) * T] += val * fmaxf(1.0f - fabsf(yb - b1), '
     '0.0f);\n}',
     '        hist[(i0 + 1) * T] += val * fmaxf(1.0f - fabsf(yb - b1), '
     '0.0f);\n'
     '    k1_acc[4][threadIdx.x] += (unsigned)(clock64() - k1_s0);\n}'),
    ('        if (v == 0.0f) return;\n        if (s != nullptr)\n'
     '            atomicAdd(s + cell, v);\n        else\n'
     '            atomicAdd(g + cell, (double)v);\n',
     '        if (v == 0.0f) return;\n'
     '        const long long k1_a0 = clock64();\n'
     '        if (s != nullptr)\n'
     '            atomicAdd(s + cell, v);\n        else\n'
     '            atomicAdd(g + cell, (double)v);\n'
     '        k1_acc[4][threadIdx.x] += (unsigned)(clock64() - k1_a0);\n'),
    ('        return pair_sum(cfg.php + t * cfg.php_cols, cfg.n_pairs, '
     'm[0] * iwx,',
     '        const long long k1_p0 = clock64();\n'
     '        const float k1_v = pair_sum(cfg.php + t * cfg.php_cols, '
     'cfg.n_pairs, m[0] * iwx,'),
    ('                        -ez, lam);\n    }\n    return tr.aperture(',
     '                        -ez, lam);\n'
     '        k1_acc[1][threadIdx.x] += (unsigned)(clock64() - k1_p0);\n'
     '        return k1_v;\n    }\n    return tr.aperture('),
    ('        thr = w0 * pair_sum(cfg.rxph, cfg.n_rx_pairs, snx, sny, snz, '
     'tnx,',
     '        const long long k1_r0 = clock64();\n'
     '        thr = w0 * pair_sum(cfg.rxph, cfg.n_rx_pairs, snx, sny, snz, '
     'tnx,'),
    ('                            dy, dz, lam);\n        base = r0 + 4;\n',
     '                            dy, dz, lam);\n'
     '        k1_acc[1][threadIdx.x] += (unsigned)(clock64() - k1_r0);\n'
     '        base = r0 + 4;\n'),
    ('                const int dn = d0 + 1 + 3 * t;\n',
     '                const int dn = d0 + 1 + 3 * t;\n'
     '                const long long k1_n0 = clock64();\n'),
    ('                        if constexpr (MESH || DOP) lane_sum += lv;\n'
     '                    }\n                }\n            }\n'
     '        } else if (LOB ? lobe_nee',
     '                        if constexpr (MESH || DOP) lane_sum += lv;\n'
     '                    }\n                }\n'
     '                k1_acc[2][threadIdx.x] += '
     '(unsigned)(clock64() - k1_n0);\n'
     '            }\n        } else if (LOB ? lobe_nee'),
    ('                    bool occ = false;\n'
     '                    for (int p = 0; p < cfg.n_prims && !occ; ++p) {\n'
     '                        const float* row = prim + p * PRIM_COLS;\n'
     '                        // transmitter t\'s own rectangle',
     '                    const long long k1_o0 = clock64();\n'
     '                    bool occ = false;\n'
     '                    for (int p = 0; p < cfg.n_prims && !occ; ++p) {\n'
     '                        const float* row = prim + p * PRIM_COLS;\n'
     '                        // transmitter t\'s own rectangle'),
    ('                        occ = hit_p && t_p > F(1e-4) && t_p < limit;\n'
     '                    }\n                    if constexpr (MESH) {\n'
     '                        if (!occ) {',
     '                        occ = hit_p && t_p > F(1e-4) && t_p < limit;\n'
     '                    }\n'
     '                    k1_acc[3][threadIdx.x] += '
     '(unsigned)(clock64() - k1_o0);\n'
     '                    if constexpr (MESH) {\n'
     '                        if (!occ) {'),
    ('    static_assert(!(EP && MED), "the endpoint twins run in vacuum");\n',
     '    static_assert(!(EP && MED), "the endpoint twins run in vacuum");\n'
     '    for (int k = 0; k < 5; ++k) k1_acc[k][threadIdx.x] = 0u;\n'),
    ('        float v = trace_lane<MESH, DOP, COH, MIMO, MED, EP, LOB>(\n'
     '            cfg, s_par, s_prim, s_msh, tx, lo, mesh_b, dr, my_hist, '
     'T, grid,\n            &events);\n',
     '        const long long k1_l0 = clock64();\n'
     '        float v = trace_lane<MESH, DOP, COH, MIMO, MED, EP, LOB>(\n'
     '            cfg, s_par, s_prim, s_msh, tx, lo, mesh_b, dr, my_hist, '
     'T, grid,\n            &events);\n'
     '        k1_acc[0][threadIdx.x] += (unsigned)(clock64() - k1_l0);\n'),
    ('    unsigned long long ev = events;\n'
     '    for (int off = 16; off > 0; off >>= 1)\n'
     '        ev += __shfl_down_sync(0xffffffffu, ev, off);\n',
     '    for (int k = 0; k < 5; ++k)\n'
     '        atomicAdd(&k1_clk[k], (unsigned long long)k1_acc[k][tid]);\n'
     '    unsigned long long ev = events;\n'
     '    for (int off = 16; off > 0; off >>= 1)\n'
     '        ev += __shfl_down_sync(0xffffffffu, ev, off);\n'),
    PATCH[-1])


# a parent's grid-stride mesh instantiations: each thread's cycles in its
# lanes (0), their closest-hit walks (1), their shadow walks (3) and grid
# splats (4)
MESH_GRID_NAMES = ('lane', 'walk', '', 'shadow_walk', 'splat')
MESH_GRID_PATCH = GRID_PATCH[:1] + GRID_PATCH[3:4] + GRID_PATCH[-4:] + (
    ('            bvh::walk(lane_tables<DOP>(mesh, cfg),\n'
     '                      bvh::make_ray(cx, cy, cz, dx, dy, dz), mc);\n',
     '            const long long k1_w0 = clock64();\n'
     '            bvh::walk(lane_tables<DOP>(mesh, cfg),\n'
     '                      bvh::make_ray(cx, cy, cz, dx, dy, dz), mc);\n'
     '            k1_acc[1][threadIdx.x] += (unsigned)(clock64() - k1_w0);\n'),
    ('                        bvh::walk(lane_tables<DOP>(mesh, cfg),\n'
     '                                  bvh::make_ray(sx, sy, sz, wx_, wy_, '
     'wz_),\n                                  sh);\n',
     '                        const long long k1_w1 = clock64();\n'
     '                        bvh::walk(lane_tables<DOP>(mesh, cfg),\n'
     '                                  bvh::make_ray(sx, sy, sz, wx_, wy_, '
     'wz_),\n                                  sh);\n'
     '                        k1_acc[3][threadIdx.x] += '
     '(unsigned)(clock64() - k1_w1);\n'))


# a parent's grid-stride MIMO instantiation: each thread's cycles in its
# lanes (0) and in mimo_splat's element loop (4)
MIMO_GRID_NAMES = ('lane', '', '', '', 'elem_loop')
MIMO_GRID_PATCH = GRID_PATCH[:1] + GRID_PATCH[-4:] + (
    ('    float kf = mul_rn(F(6.283185307179586), f_recv / sp[1]);\n'
     '    const float* eo = grid.tab + 2;\n',
     '    float kf = mul_rn(F(6.283185307179586), f_recv / sp[1]);\n'
     '    const float* eo = grid.tab + 2;\n'
     '    const long long k1_m0 = clock64();\n'),
    ('            grid.add((i0 + 1) * n_ch + 2 * e + 1, si * wt1);\n'
     '        }\n    }\n    return amp;\n}',
     '            grid.add((i0 + 1) * n_ch + 2 * e + 1, si * wt1);\n'
     '        }\n    }\n'
     '    k1_acc[4][threadIdx.x] += (unsigned)(clock64() - k1_m0);\n'
     '    return amp;\n}'))


def instrument_grid(s: str, patch=GRID_PATCH) -> str:
    """The receive kernel's source `s` with each thread's clocks in the
    grid-stride endpoint twins' stages (GRID_NAMES), or with
    MESH_GRID_PATCH in the mesh instantiations' (MESH_GRID_NAMES)."""
    for old, new in patch:
        if s.count(old) != 1:
            raise SystemExit(f'anchor not found once: {old[:60]!r}')
        s = s.replace(old, new)
    return s


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


def mdk_runs(s: str, config: str) -> bool:
    """Whether the receive kernel's source `s` runs a mesh configuration
    (MDK_LAUNCH) on the mesh Doppler kernel, not on the grid-stride
    instantiation."""
    return MDK_KERNEL + '(const float' in s and MDK_LAUNCH[config] in s


def instrument(s: str, splat: bool = False,
               kernel: str = 'receive_flagship_kernel',
               config: str | None = None) -> str:
    """The receive kernel's source `s` with the clock reads added to the
    warp loop of `kernel` (of `config`'s instantiation: a mesh
    configuration's); each anchor must appear exactly once (the loop's
    within the kernel's body)."""
    if kernel == MDK_KERNEL and not mdk_runs(s, config or 'multi_body'):
        # a tree whose configuration runs the grid-stride body
        return instrument_grid(s, MESH_GRID_PATCH)
    if kernel in (MSK_KERNEL, MAK_KERNEL) \
            and kernel + '(const float' not in s:
        # a tree before the mesh kernel or the MIMO array kernel: the
        # grid-stride instantiation's lanes
        return instrument_grid(s, MESH_GRID_PATCH if kernel == MSK_KERNEL
                               else MIMO_GRID_PATCH)
    if kernel in (MSK_KERNEL, MAK_KERNEL):
        s = _patch_body(s, f'{kernel}(const float* __restrict__ params,',
                        MSK_PATCH if kernel == MSK_KERNEL else MAK_PATCH)
        for old, new in (PATCH[0], PATCH[-1]):
            if s.count(old) != 1:
                raise SystemExit(f'anchor not found once: {old[:60]!r}')
            s = s.replace(old, new)
        return s
    if kernel in EP_KERNELS + (DPW_KERNEL,) \
            and kernel + '(const float' not in s:
        # a tree before the endpoint kernels or the Doppler power kernel:
        # its grid-stride twins
        return instrument_grid(s)
    if kernel in (DPW_KERNEL, MDK_KERNEL):
        s = _patch_body(s, f'{kernel}(const float* __restrict__ params,',
                        DPW_PATCH if kernel == DPW_KERNEL else MDK_PATCH)
        for old, new in (PATCH[0], PATCH[-1]):
            if s.count(old) != 1:
                raise SystemExit(f'anchor not found once: {old[:60]!r}')
            s = s.replace(old, new)
        return s
    if kernel in EP_KERNELS:
        # both endpoint kernels: one build serves the four scenes
        for k in EP_KERNELS:
            s = _patch_body(s, f'{k}(const float* __restrict__ params,',
                            ep_patch(k))
        for old, new in (PATCH[0], PATCH[-1]):
            if s.count(old) != 1:
                raise SystemExit(f'anchor not found once: {old[:60]!r}')
            s = s.replace(old, new)
        return s
    loop = tuple(
        (old.format(splat=SPLAT_CALL[kernel]),
         new.format(splat=SPLAT_CALL[kernel]))
        if '{splat}' in old else (old, new) for old, new in PATCH[1:-1])
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
                      kernel: str = 'receive_flagship_kernel',
                      config: str | None = None) -> str:
    """DIR's package with `kernel` instrumented under _build/k1_clock/;
    a copy of the same tree and instrumentation (and its library) is
    kept."""
    dst = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'k1_clock')
    with open(os.path.join(root, 'beifong_tpu_torch', 'csrc',
                           'receive_megakernel.cu')) as f:
        text = instrument(f.read(), splat, kernel, config)
    src = os.path.join(dst, 'beifong_tpu_torch', 'csrc',
                       'receive_megakernel.cu')
    tag = os.path.join(dst, 'tree')
    if os.path.exists(src) and os.path.exists(tag):
        with open(src) as f, open(tag) as g:
            if f.read() == text and g.read() == root:
                return dst
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    with open(src, 'w') as f:
        f.write(text)
    with open(tag, 'w') as f:
        f.write(root)
    return dst


def run(tree: str, config: str = 'flagship') -> dict:
    sys.path.insert(0, tree)
    import torch
    from beifong_tpu_torch import scenes
    from beifong_tpu_torch.integrators import receive_kernel as rk
    assert rk.__file__.startswith(tree)
    dev = torch.device('cuda')
    if config.startswith('ep_') or config.startswith('doppler_') \
            or config in ('range_doppler', 'fmcw_sonar') \
            or config in MDK_LAUNCH or config in ('mesh', 'mimo'):
        return run_ep(tree, config, rk, scenes, dev)
    s, rx = {'flagship': scenes.flagship_scene,
             'flagship_prims': scenes.flagship_scene,
             'flagship_prims_tex': scenes.flagship_scene,
             'flagship_sphere': lambda: scenes.flagship_scene(
                 target='sphere'),
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
    if config.startswith('flagship_prims'):
        # the prims twin on the all-rectangle scene; _tex: the one that
        # carries the texture codes, handed a buffer of no texture
        kw['prims'] = True
        if config == 'flagship_prims_tex':
            kw.update(tex=torch.zeros((8, rk.TEX_LANE), device=dev),
                      bmp_meta=torch.tensor([[-1, 0, 0]] * prim.shape[0],
                                            dtype=torch.int32, device=dev),
                      textured=True)
    if not config.startswith('flagship'):
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


def run_ep(tree: str, config: str, rk, scenes, dev) -> dict:
    """An endpoint scene (tools/tree_ab.py's shapes): the endpoint kernels'
    turn shares and their sub-stages (per thread: the NEE's and the
    receiver's cross-WDFs, the shadow loops, over 32; per warp: the
    splats inside SHADE), or a tree's grid-stride twins' per-thread stage
    shares (GRID_NAMES, of the lanes' cycles)."""
    import torch
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import tree_ab
    mdk = config in MDK_LAUNCH
    own = config in ('mesh', 'mimo')   # the mesh or MIMO array kernel
    dpw = not config.startswith('ep_') and not mdk and not own
    if config == 'mesh':
        sys.path.insert(0, HERE)
        import chip_smoke
        params, prim, txp, kw = tree_ab.mesh_call(rk, scenes, dev,
                                                  chip_smoke)
    elif config == 'mimo':
        params, prim, txp, kw = tree_ab.mimo_call(rk, scenes, dev)
    else:
        params, prim, txp, kw = (tree_ab.mesh_doppler_call if mdk
                                 else tree_ab.doppler_power_call if dpw
                                 else tree_ab.endpoint_call)(rk, scenes,
                                                             config, dev)
    lib = rk.LIBRARY.get()
    lib.rk_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 16)()
    rk.receive_megakernel(params, prim, txp, seed=7, **kw)
    torch.cuda.synchronize()
    rk.LIBRARY.check(lib.rk_clock(buf, 1), 'rk_clock')
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rk.receive_megakernel(params, prim, txp, seed=7, **kw)
    b.record()
    torch.cuda.synchronize()
    rk.LIBRARY.check(lib.rk_clock(buf, 1), 'rk_clock')
    v = list(buf)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    out = {'card': card, 'config': config,
           'instrumented_ms': a.elapsed_time(b)}
    with open(os.path.join(tree, 'beifong_tpu_torch', 'csrc',
                           'receive_megakernel.cu')) as f:
        src = f.read()
    grid_stride = not mdk_runs(src, config) if mdk else \
        KERNELS[config] + '(const float' not in src if own else \
        not hasattr(rk, 'launched_doppler_power_kernel' if dpw
                    else 'launched_endpoint_kernel')
    if grid_stride:
        lane = max(1, v[0])
        names = MESH_GRID_NAMES if mdk or config == 'mesh' else \
            MIMO_GRID_NAMES if config == 'mimo' else GRID_NAMES
        out.update(kernel='grid-stride twin',
                   share_of_lane_cycles={n: v[i] / lane for i, n in
                                         enumerate(names) if n},
                   thread_cycles_a_lane=v[0] / kw['n_lanes'])
        return out
    tot = sum(v[:len(NAMES)])
    if mdk or config == 'mesh':
        within = {'walk': v[12] / 32 / tot, 'shadow_walk': v[13] / 32 / tot,
                  'grid_splat_in_shade': v[14] / 32 / tot}
    elif config == 'mimo':
        within = {'stage_in_shade': v[14] / 32 / tot}
    elif dpw:
        within = {'grid_splat_in_shade': v[14] / 32 / tot}
    else:
        within = {'nee_pairs': v[12] / 32 / tot, 'shadow': v[13] / 32 / tot,
                  'rx_pairs': v[15] / 32 / tot, 'splat_in_shade': v[14] / tot}
    out.update(kernel=KERNELS[config],
               share={n: v[i] / tot for i, n in enumerate(NAMES)},
               within=within,
               warp_cycles_a_lane=tot * 32 / kw['n_lanes'],
               ray_turns=v[8], shade_turns=v[9],
               shade_fill=v[10] / max(1, 32 * v[9]),
               traced_a_turn=v[11] / max(1, v[8] + v[9]))
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == '--child':
        for config in sys.argv[3].split(','):
            print('CLK ' + json.dumps(run(sys.argv[2], config)), flush=True)
        return 0
    argv = sys.argv[1:]
    config = 'flagship'
    if '--config' in argv:
        i = argv.index('--config')
        config = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if a != '--splat']
    root = os.path.abspath(args[0] if args else HERE)
    # several configurations of one kernel (comma-separated) share a build
    # and a process, one CLK line each
    configs = config.split(',')
    if len({KERNELS[c] for c in configs}) != 1:
        raise SystemExit('--config: configurations of one kernel')
    tree = instrumented_copy(root, '--splat' in argv, KERNELS[configs[0]],
                             configs[0])
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          '--child', tree, config], capture_output=True,
                         text=True)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-4000:])
    return res.returncode


if __name__ == '__main__':
    sys.exit(main())
