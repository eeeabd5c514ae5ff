#!/usr/bin/env python3
"""Ablation trees of the receive megakernel (K1) for paired timing: a copy
of a checkout's `beifong_tpu_torch` under `_archive/NAME/` (ignored by
git) with one named edit of
`csrc/receive_megakernel.cu`, to time against the unedited tree with
`tools/tree_ab.py --other TREE --this _archive/NAME --only ...`.

Run from the repository root:

    python3 tools/k1_ablate.py TREE NAME [NAME ...]

Each NAME is one of ABLATIONS, K4_ABLATIONS or BVH_ABLATIONS; each edit
is exact text that must appear once in TREE's source.  The edits of the grid-stride
lobe twins (receive_doppler_kernel<..., LOB>, the parent of
receive_lobe_kernel):
  no_splat     the splat's atomics skipped (its tent arithmetic kept: a
               grid whose two pointers never meet returns first);
  hash         Philox4x32 with one round in place of ten (a cheap hash:
               every draw moves, the work a lane does hardly);
  draws_false  Draws<false> (the pulse read at each draw, as the
               flagship's grid-stride kernel did);
  lb3, lb5, lb6  the Doppler family's launch bounds (128, 3 / 5 / 6) in
               place of (128, 4);
  phase0       the echo phase 0 (I / Q twins: no phase arithmetic);
and of receive_lobe_kernel:
  lob_lb5, lob_lb6  its blocks an SM, 5 / 6 in place of 4;
  lob_mixed    its SHADE turns of mixed kinds (no turn by kind);
of the grid-stride endpoint twins (receive_trace_kernel<false, false,
true>, receive_doppler_kernel<false, true, false, true>: the parents of
the endpoint kernels; time them with --only ep_phased_tx,...):
  ep_smem      the pair rows in shared memory (a block's copy after the
               transmitter rows) in place of the read-only path;
  ep_union     the pair loop behind a pre-test: a point outside the
               union of the array's footprints (a box, widened) skips it;
  ep_unroll4   the pair loop unrolled by 4;
  ep_gain1     the pair loop skipped (every cross-WDF 1: what the pair
               sums cost; not exact);
  ep_noshadow  the NEE shadow loop skipped (four_tx; not exact);
and of the endpoint kernels:
  epx_full     the full loop over the staged records (no footprint index:
               the same sums bit for bit);
  epw_lb4, epw_lb5  the power kernel held to 4 / 5 blocks an SM (not 6);
  epc_lb3, epc_lb4, epc_lb5  the coherent kernel's, 3 / 4 / 5 (not 6);
  epx_cells32  the footprint index with 32 cells an axis (not 64);
  epx_pairs2   the indexed pair loop two pairs at a time (their terms
               independent, added in pair order: the same sums);
  epx_warp     the receiver's cross-WDF for a whole warp (its (lane,
               pair) items spread over the warp's threads; the same sums);
of the analytic Doppler power kernel (receive_doppler_power_kernel; time
them with --only range_doppler,fmcw_sonar; its edits lie inside its body,
DPW_SCOPE):
  dpw_warp_taps  D2: the warp's taps summed a cell at a time in a fixed
               tree of shuffles before the atomics (pow_splat_warp) on
               grids without warp rows;
  dpw_rows2d   D3: a 2-D grid of at most 1,024 cells in a row of floats a
               warp, each cell's taps in lane order (pow_splat_rows2: no
               atomics, bit-identical repeats);
               (both with helpers outside the body: OUTSIDE)
  dpw_lb4, dpw_lb5  its blocks an SM, 4 / 5 in place of 6;
  dpw_freq_call  every lane's receive frequency the call's (no frequency
               drawn a lane, the block's lobe mixture; not exact);
  dpw_rule_raw  RAY's receive frequency not read off the chirp under
               mix_resample (the call's; not exact);
of the mesh Doppler kernel (receive_mesh_doppler_kernel; time them with
--only multi_body,mesh_lobes_iq,mesh_lobes_power,coherent_mesh):
  mdk_lb4, mdk_lb5  the blocks an SM of all four instantiations, 4 / 5
               in place of 6;
  mdc_lb4, mdc_lb5  the coherent mesh's, <true, false> (coherent_mesh);
  mdl_lb4, mdl_lb5  the power mesh lobe twin's, <false, true>
               (mesh_lobes_power);
  mdk_queue    the warp's walk queue: its shadow rays and its rays'
               closest hits walked one node a step by its threads, a
               thread whose walk ends taking the next (Aila and Laine's
               while-while traversal; the same results bit for bit), its
               splat after it (edits inside the kernel's body, MDK_SCOPE,
               and the helper and warp area outside it: OUTSIDE);
  mdk_smem_bvh  the pulse's BVH copied into the block's shared memory
               where it fits (MDK_SMEM_BVH_BYTES: multi_body's 19 KB) and
               walked there with plain loads (the same results bit for
               bit; _launch passes the tables' sizes for one pulse too);
of the mesh kernel (receive_mesh_kernel; --only mesh) and of the MIMO
array kernel (receive_mimo_array_kernel; --only mimo):
  msk_lb4, msk_lb5  the mesh kernel's blocks an SM, 4 / 5 in place of 6;
  mak_lb5, mak_lb6  the MIMO array kernel's, 5 / 6 in place of 4;
  msk_mdk      the mesh configuration in power routed to the mesh Doppler
               kernel <false, false> (no new code: the wrapper hands it a
               static diffuse mesh-shape row and the block's grid; a
               Python edit, PY_EDITS);
  mak_thread_elem  the MIMO array kernel's first design: each connecting
               thread loops over the elements in SHADE (mimo_splat), not
               the warp after the trace (mimo_warp_taps);
  mak_no_elem  the MIMO array kernel's element taps skipped (each
               connection's phase and amplitude kept, its taps not added;
               not exact);
and, no ablation, `tags`: the stage tags of trace_lane's lobe path added
to a parent that predates them (comments only: its machine code is the
parent's), for tools/k1_mix.py --sass.

The k4_ names edit K4's `csrc/intersect_kernels.cu` instead (time them
with `--only k4_closest,k4_any`).  Of the brute-force kernel that tests
every pair (the culling kernel's parent; not exact where noted):
  k4_rcp       the IEEE reciprocal as MUFU.RCP alone (__fdividef; not
               exact);
  k4_lds128    the nine SoA floats of a triangle as three float4s;
  k4_warp_any  the shadow kernel leaving its loop per warp (__all_sync
               every 8 triangles) once each lane is blocked;
  k4_cull      a plain bounding-sphere test (radius x 1.001, no rounding
               margin; not exact) in front of the exact test;
and of the culling kernel:
  k4_nocull    every pair kept (the layout and control alone);
  k4_group1 / k4_group8 / k4_group16  GROUP triangles a lane gathers
               before its exact tests (1: a branch a triangle; the
               kernel's 32);
  k4_threads128  blocks of 128 rays;
  k4_group64   masks of 64 triangles;
  k4_rays2     two rays a thread;
  k4_queue     D3, the warp queue (see K4_ABLATIONS); k4_queue_lb5 the
               same at five blocks an SM.

The bvh_ names edit K2 / K3's `csrc/bvh_kernels.cu` (the node-pair walk
of persistent warps; time them with `--only bvh_closest,bvh_any`):
  bvh_lockstep  no refill: a warp takes new rays only when its 32 lanes
               are all done (the grid-stride walk's lockstep);
  bvh_any_left  K3 enters the left child first (not the nearer one);
  bvh_rays2, bvh_rays4  the persistent grid sized for two or four rays
               a lane (fewer warps, which refill at 2^17 too);
  bvh_chunk32, bvh_chunk128  rays a warp takes from the counter, 32 or
               128 (not 64);
  bvh_threads128, bvh_threads256  blocks of 128 threads (8 an SM) or 256
               (4 an SM), not 512 (2);
  bvh_lb1, bvh_lb3  blocks an SM of 512 threads, 1 / 3 (at most 128 / 40
               registers) in place of 2 (64);
  bvh_smem     the node pairs in shared memory where they fit (96 KB),
               read with LDS.128.
All of them give the same results bit for bit.
"""

from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ABLATIONS = {
    'no_splat': ((
        '''    __device__ void add(int cell, float v) const {
        if (v == 0.0f) return;
        if (s != nullptr)''',
        '''    __device__ void add(int cell, float v) const {
        if (v == 0.0f || (const void*)s != (const void*)g) return;
        if (s != nullptr)'''),),
    'hash': (('    for (int r = 0; r < 10; ++r) {',
              '    for (int r = 0; r < 1; ++r) {'),),
    'draws_false': (('Draws<DOP>& dr,', 'Draws<false>& dr,'),
                    ('    Draws<DOP> dr;', '    Draws<false> dr;')),
    'phase0': ((
        '''    if constexpr (COH) {
        float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit, t_recv, k_pri);''',
        '''    if constexpr (COH) {
        float ph = 0.0f;'''),),
}
# the stage tags of trace_lane's lobe path, as comments: a parent that
# predates them gets the SASS mix by stage of tools/k1_mix.py --sass
ABLATIONS['tags'] = (
    ('                if constexpr (LOB) {\n'
     '                    // the hit\'s lobe; a composite\'s mix',
     '                if constexpr (LOB) {\n'
     '                    // [k1 stage: lobe_nee]\n'
     '                    // the hit\'s lobe; a composite\'s mix'),
    ('                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;\n'
     '                    }\n'
     '                } else if (is_ggx) {',
     '                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;\n'
     '                    }\n'
     '                    // [k1 stage: nee]\n'
     '                } else if (is_ggx) {'),
    ('            bool pass = false;\n            if (wmx < 1.0f',
     '            bool pass = false;\n            // [k1 stage: pick]\n'
     '            if (wmx < 1.0f'),
    ('                kk = r1[32];\n            }\n            float face',
     '                kk = r1[32];\n            }\n'
     '            // [k1 stage: bounce]\n            float face'),
    ('            } else if (cfg.mirror && kb == CONDUCTOR) {\n'
     '                float dn',
     '            } else if (cfg.mirror && kb == CONDUCTOR) {\n'
     '                // [k1 stage: mirror]\n                float dn'),
    ('            } else if (kb == DIELECTRIC || kb == THIN_DIELECTRIC) {\n'
     '                // the Fresnel',
     '            } else if (kb == DIELECTRIC || kb == THIN_DIELECTRIC) {\n'
     '                // [k1 stage: diel]\n                // the Fresnel'),
    ('                       || kb == ROUGH_DIELECTRIC) {\n'
     '                // the GGX half vector',
     '                       || kb == ROUGH_DIELECTRIC) {\n'
     '                // [k1 stage: ggx]\n'
     '                // the GGX half vector'),
    ('            } else {\n'
     '                // the cosine hemisphere: diffuse, and',
     '            } else {\n                // [k1 stage: diffuse]\n'
     '                // the cosine hemisphere: diffuse, and'),
    ('            if (!(w_b > 0.0f)) break;                   // absorbed\n'
     '            // direct hits',
     '            // [k1 stage: bounce]\n'
     '            if (!(w_b > 0.0f)) break;                   // absorbed\n'
     '            // direct hits'))
for _n in (3, 5, 6):
    ABLATIONS[f'lb{_n}'] = ((
        '__global__ void __launch_bounds__(DOP_THREADS, 4)\n'
        'receive_doppler_kernel(',
        f'__global__ void __launch_bounds__(DOP_THREADS, {_n})\n'
        'receive_doppler_kernel('),)
for _n in (5, 6):
    ABLATIONS[f'lob_lb{_n}'] = (('constexpr int LOB_MIN_BLOCKS = 4;',
                                 f'constexpr int LOB_MIN_BLOCKS = {_n};'),)
# the analytic Doppler power kernel's
for _n in (4, 5):
    ABLATIONS[f'dpw_lb{_n}'] = (('constexpr int DPW_MIN_BLOCKS = 6;',
                                 f'constexpr int DPW_MIN_BLOCKS = {_n};'),)
# the mesh Doppler kernel's blocks an SM, 4 / 5 in place of 6: of all
# four instantiations (mdk_), of the coherent mesh <true, false> alone
# (mdc_) and of the power mesh lobe twin <false, true> alone (mdl_)
for _n in (4, 5):
    ABLATIONS[f'mdk_lb{_n}'] = (('constexpr int MDK_MIN_BLOCKS = 6;',
                                 f'constexpr int MDK_MIN_BLOCKS = {_n};'),)
    for _k, _f in (('mdc', 'COH && !LOB'), ('mdl', '!COH && LOB')):
        ABLATIONS[f'{_k}_lb{_n}'] = ((
            'template <bool COH, bool LOB>\n__global__ void '
            '__launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)\n',
            'template <bool COH, bool LOB>\n__global__ void '
            f'__launch_bounds__(COH_THREADS, {_f} ? {_n} : MDK_MIN_BLOCKS)'
            '\n'),)
# the mesh kernel's and the MIMO array kernel's blocks an SM, 4 / 5 in
# place of 6
for _n in (4, 5):
    ABLATIONS[f'msk_lb{_n}'] = (('constexpr int MSK_MIN_BLOCKS = 6;',
                                 f'constexpr int MSK_MIN_BLOCKS = {_n};'),)

# the MIMO array kernel's blocks an SM, 5 / 6 in place of 4
for _n in (5, 6):
    ABLATIONS[f'mak_lb{_n}'] = (('constexpr int MAK_MIN_BLOCKS = 4;',
                                 f'constexpr int MAK_MIN_BLOCKS = {_n};'),)
# the MIMO array kernel's element taps skipped: each connection's phase
# and amplitude kept, its taps not added (the grid left empty; not exact)
ABLATIONS['mak_no_elem'] = ((
    '            mimo_warp_taps(grid, cfg, w_st, taps, j);',
    '            mimo_warp_taps(grid, cfg, w_st, false, j);'),)
ABLATIONS['dpw_freq_call'] = (
    ('    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);',
     '    const bool f_call = true;'),
    ('                    } else if (cfg.n_freq > 1) {\n'
     '                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;',
     '                    } else if (cfg.n_freq > 1 && false) {\n'
     '                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;'))
ABLATIONS['dpw_rule_raw'] = ((
    '                    if (cfg.rule == RX_MIX) {\n'
    '                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);',
    '                    if (cfg.rule == RX_MIX && false) {\n'
    '                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);'),)
# the ablations whose edits apply inside one function's body (from the
# line that starts its definition to its closing brace)
DPW_SCOPE = 'receive_doppler_power_kernel(const float* __restrict__ params,'
SCOPE = {n: DPW_SCOPE for n in ('dpw_freq_call', 'dpw_rule_raw',
                               'dpw_warp_taps', 'dpw_rows2d')}
# the Doppler power kernel's splat designs that lost to its block atomics
# (PERF.md §6): the warp's taps summed a cell at a time before the
# atomics (D2), and a 2-D grid in a row of floats a warp (D3)
DPW_WARP_SPLAT = """// The Doppler power kernel's warp splat of a grid without warp rows: each
// thread's taps (grid_splat's: two time bins, times two frequency bins on
// a 2-D grid, each weighted as there) are added across the warp before
// the atomics.  For each cell a tap of the warp lands on, in turn, the
// taps on it are summed in a fixed tree of shuffles and the lowest lane
// with such a tap adds the sum to the grid (Grid::add).  Every thread of
// the warp calls it (val 0: no taps); xb is the frequency coordinate.
// [k1 splat]
__device__ __forceinline__ void pow_splat_warp(const Grid& grid,
                                               const Cfg& cfg, float val,
                                               float yb, float xb, int j) {
    int c[4] = {-1, -1, -1, -1};
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float b0 = floorf(yb);
    if (val != 0.0f && b0 >= -1.0f && b0 < (float)cfg.n_time) {
        const float b1 = b0 + 1.0f;
        const float wt0 = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
        const float wt1 = fmaxf(1.0f - fabsf(yb - b1), 0.0f);
        const int i0 = (int)b0;
        if (cfg.n_freq == 1) {
            if (i0 >= 0) {
                c[0] = i0;
                v[0] = val * wt0;
            }
            if (i0 + 1 < cfg.n_time) {
                c[1] = i0 + 1;
                v[1] = val * wt1;
            }
        } else {
            const float c0 = floorf(xb);
            if (c0 >= -1.0f && c0 < (float)cfg.n_freq) {
                const float c1 = c0 + 1.0f;
                const float wf0 = fmaxf(1.0f - fabsf(xb - c0), 0.0f);
                const float wf1 = fmaxf(1.0f - fabsf(xb - c1), 0.0f);
                const int j0 = (int)c0;
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    const int it = i0 + a;
                    if (it < 0 || it >= cfg.n_time) continue;
                    const float vt = val * (a ? wt1 : wt0);
                    const int row = it * cfg.n_freq;
                    if (j0 >= 0) {
                        c[2 * a] = row + j0;
                        v[2 * a] = vt * wf0;
                    }
                    if (j0 + 1 < cfg.n_freq) {
                        c[2 * a + 1] = row + j0 + 1;
                        v[2 * a + 1] = vt * wf1;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (v[k] == 0.0f) c[k] = -1;       // Grid::add skips a zero
    for (;;) {
        const int mine = c[0] >= 0 ? c[0] : c[1] >= 0 ? c[1]
                         : c[2] >= 0 ? c[2] : c[3];
        const unsigned act = __ballot_sync(FULL_MASK, mine >= 0);
        if (act == 0u) return;
        const int lead = __ffs(act) - 1;
        const int cell = __shfl_sync(FULL_MASK, mine, lead);
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (c[k] == cell) {
                x = v[k];
                c[k] = -1;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(FULL_MASK, x, off);
        if (j == lead) grid.add(cell, x);
    }
}

"""
DPW_ROWS2_SPLAT = """// A 2-D grid of at most DPW_ROW2D_CELLS cells (mode 1) goes to a row of
// floats a warp, each cell's taps added in lane order (pow_splat_rows2),
// in place of the block's grid of atomics
constexpr int DPW_ROW2D_CELLS = 1024;

__host__ __device__ constexpr bool dpw_rows2(int n_time, int n_freq,
                                             int mode) {
    return mode == 1 && n_freq > 1
           && n_time * n_freq <= DPW_ROW2D_CELLS;
}
// Shared bytes of one warp's area: the coherent kernel's, then its row of
// n_time doubles (1-D warp rows) or of n_time x n_freq floats (2-D).
__host__ __device__ constexpr int dpw_warp_bytes(int n_time, int n_freq,
                                                 int mode) {
    return dpw_rows2(n_time, n_freq, mode)
               ? (coh_row_offset() + 4 * n_time * n_freq + 15) & ~15
               : lob_warp_bytes(n_time, lob_rows(n_time, n_freq, mode, 1),
                                1);
}

// The 2-D warp row's splat: each thread's taps (grid_splat's) staged, a
// base cell and a mask of its taps (tap t: base + (t & 1) + (t >> 1)
// n_freq); then for each staging lane in lane order the lane that owns
// cell c (c mod 32) adds the staged tap that lands on c.  Each cell thus
// sums its taps in lane order and nothing is atomic.  Every thread of the
// warp calls it (val 0: no taps); xb is the frequency coordinate.
// [k1 splat]
__device__ __forceinline__ void pow_splat_rows2(float* row, float* vals,
                                                const Cfg& cfg, float val,
                                                float yb, float xb, int j) {
    int base = 0;
    unsigned tm = 0u;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float b0 = floorf(yb), c0 = floorf(xb);
    if (val != 0.0f && b0 >= -1.0f && b0 < (float)cfg.n_time
        && c0 >= -1.0f && c0 < (float)cfg.n_freq) {
        const float wt0 = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
        const float wt1 = fmaxf(1.0f - fabsf(yb - (b0 + 1.0f)), 0.0f);
        const float wf0 = fmaxf(1.0f - fabsf(xb - c0), 0.0f);
        const float wf1 = fmaxf(1.0f - fabsf(xb - (c0 + 1.0f)), 0.0f);
        const int i0 = (int)b0, j0 = (int)c0;
        base = i0 * cfg.n_freq + j0;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int it = i0 + a;
            if (it < 0 || it >= cfg.n_time) continue;
            const float vt = val * (a ? wt1 : wt0);
            if (j0 >= 0) {
                v[2 * a] = vt * wf0;
                tm |= (v[2 * a] != 0.0f) << (2 * a);
            }
            if (j0 + 1 < cfg.n_freq) {
                v[2 * a + 1] = vt * wf1;
                tm |= (v[2 * a + 1] != 0.0f) << (2 * a + 1);
            }
        }
    }
    unsigned go = __ballot_sync(FULL_MASK, tm != 0u);
    if (go == 0u) return;
    int* first = reinterpret_cast<int*>(vals + 128);   // base x 16 + mask
    vals[j] = v[0];
    vals[32 + j] = v[1];
    vals[64 + j] = v[2];
    vals[96 + j] = v[3];
    first[j] = base * 16 + (int)tm;
    __syncwarp();
    while (go != 0u) {
        const int k = __ffs(go) - 1;
        go &= go - 1u;
        const int x = first[k];
        const int b = x >> 4, m = x & 15;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int c = b + (t & 1) + (t >> 1) * cfg.n_freq;
            if (((m >> t) & 1) && (c & 31) == j)
                row[c] = row[c] + vals[32 * t + k];
        }
    }
}

"""
DPW_ANCHOR = '// Blocks an SM the Doppler power kernel is held to:'
DPW_PV = '        float pv = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;'
DPW_PV_XB = ('        float pv = 0.0f, yb = 0.0f, xb = 0.0f, f_recv = 0.0f,'
             ' t_recv = 0.0f;')
DPW_GRID_SPLAT = '                    grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {\n                        return bin_freq(cfg, txw, lo, f_recv, t_recv);\n                    });\n'
DPW_XB = ('                    if (cfg.n_freq > 1)\n'
          '                        xb = (bin_freq(cfg, txw, lo, f_recv, t_recv)'
          ' - cfg.f_lo)\n'
          '                             / cfg.f_den * (float)cfg.n_freq'
          ' - 0.5f;\n')
DPW_LOOP_END = ('            pow_splat_rows(w_row, w_vals, cfg.n_time, pv, yb, j);\n'
                '        }\n')
ABLATIONS['dpw_warp_taps'] = (
    (DPW_PV, DPW_PV_XB), (DPW_GRID_SPLAT, DPW_XB),
    (DPW_LOOP_END, DPW_LOOP_END + '        if (shade && !rows) {\n'
     '            // [k1 stage: splat]\n'
     '            pow_splat_warp(grid, cfg, pv, yb, xb, j);\n'
     '        }\n'))
ABLATIONS['dpw_rows2d'] = (
    ('    const int wbytes = lob_warp_bytes(cfg.n_time, rows, 1);',
     '    const bool rows2 = dpw_rows2(cfg.n_time, cfg.n_freq, cfg.mode);\n'
     '    const int wbytes = dpw_warp_bytes(cfg.n_time, cfg.n_freq, cfg.mode);'),
    ('        for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;\n'
     '    } else if (cfg.mode == 1) {',
     '        for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;\n'
     '    } else if (rows2) {\n'
     '        for (long long i = j; i < n_vals; i += 32)\n'
     '            reinterpret_cast<float*>(w_row)[i] = 0.0f;\n'
     '    } else if (cfg.mode == 1) {'),
    (DPW_PV, DPW_PV_XB),
    (DPW_GRID_SPLAT, '                    if (rows2) {\n' + DPW_XB
     + '                    } else {\n' + DPW_GRID_SPLAT
     + '                    }\n'),
    (DPW_LOOP_END, DPW_LOOP_END + '        if (shade && rows2) {\n'
     '            // [k1 stage: splat]\n'
     '            pow_splat_rows2(reinterpret_cast<float*>(w_row), w_vals,'
     ' cfg, pv,\n                            yb, xb, j);\n'
     '        }\n'),
    ('            partial[(long long)blockIdx.x * n_vals + v] = s;\n'
     '        }\n    } else if (cfg.mode == 1) {',
     '            partial[(long long)blockIdx.x * n_vals + v] = s;\n'
     '        }\n    } else if (rows2) {\n'
     '        for (long long v = tid; v < n_vals; v += T) {\n'
     '            double s = 0.0;\n'
     '            for (int w = 0; w < T / 32; ++w)\n'
     '                s += (double)reinterpret_cast<const float*>(\n'
     '                    s_warps + w * wbytes + coh_row_offset())[v];\n'
     '            partial[(long long)blockIdx.x * n_vals + v] = s;\n'
     '        }\n    } else if (cfg.mode == 1) {'))
# edits of those ablations outside the kernel's body: each design's
# helpers, and (D3) the launch geometry's warp rows
OUTSIDE = {
    'dpw_warp_taps': ((DPW_ANCHOR, DPW_WARP_SPLAT + DPW_ANCHOR),),
    'dpw_rows2d': (
        (DPW_ANCHOR, DPW_ROWS2_SPLAT + DPW_ANCHOR),
        ('        const bool rows = lob_rows(n_time, n_freq, mode, 1);\n'
         '        const int grid_bytes = mode == 1 && !rows ? 4 * n_time * '
         'n_freq : 0;\n'
         '        smem = coh_table_bytes(n_prims, n_params)\n'
         '               + (T / 32) * lob_warp_bytes(n_time, rows, 1)',
         '        const bool rows = lob_rows(n_time, n_freq, mode, 1)\n'
         '                          || dpw_rows2(n_time, n_freq, mode);\n'
         '        const int grid_bytes = mode == 1 && !rows ? 4 * n_time * '
         'n_freq : 0;\n'
         '        smem = coh_table_bytes(n_prims, n_params)\n'
         '               + (T / 32) * dpw_warp_bytes(n_time, n_freq, mode)'))}

# the MIMO array kernel's first design: each connecting thread loops over
# the elements in SHADE (mimo_splat), the warp waiting (edits inside the
# kernel's body, MAK_SCOPE)
MAK_SCOPE = 'receive_mimo_array_kernel(const float* __restrict__ params,'
ABLATIONS['mak_thread_elem'] = (
    ('                lsum += mimo_stage(cfg, tx, lo, sp, val, yb, f_recv, t_recv,\n'
     '                                   dtot, t_emit, k_c, n_bnd, v0x, v0y, v0z,\n'
     '                                   r0m, w_st, j, &taps);',
     '                lsum += mimo_splat(grid, cfg, tx, lo, sp, val, yb, f_recv,\n'
     '                                   t_recv, dtot, t_emit, k_c, n_bnd, v0x,\n'
     '                                   v0y, v0z, r0m);'),
    ('            mimo_warp_taps(grid, cfg, w_st, taps, j);',
     '            mimo_warp_taps(grid, cfg, w_st, false, j);'))
SCOPE['mak_thread_elem'] = MAK_SCOPE

# the lobe kernel's SHADE turns of mixed kinds (no turn of 32 paths on the
# transmitter or 32 off it: the parent's slot order)
ABLATIONS['lob_mixed'] = (
    ('        if (shade && n_sh - n_tx >= 32) {',
     '        if (shade && n_sh - n_tx >= 32 && false) {'),
    ('        } else if (shade && n_tx >= 32) {',
     '        } else if (shade && n_tx >= 32 && false) {'))


# K4's ablations (see the docstring)
K4_ABLATIONS = {
    'k4_rcp': (('    const float inv = big ? __frcp_rn(det) : 0.0f;',
                '    const float inv = big ? __fdividef(1.0f, det) : 0.0f;'),),
    'k4_lds128': (
        ('    const float (*s)[TILE], int k, int index, float ox, float oy,',
         '    const float4 (*s)[TILE], int k, int index, float ox, float oy,'),
        ('    const float v0x = s[0][k], v0y = s[1][k], v0z = s[2][k];\n'
         '    const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];\n'
         '    const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];',
         '    const float4 a = s[0][k], b = s[1][k], c = s[2][k];\n'
         '    const float v0x = a.x, v0y = a.y, v0z = a.z;\n'
         '    const float e1x = b.x, e1y = b.y, e1z = b.z;\n'
         '    const float e2x = c.x, e2y = c.y, e2z = c.z;'),
        ('    __shared__ float s[9][TILE];', '    __shared__ float4 s[3][TILE];'),
        ('            s[0][k] = v0[f];\n'
         '            s[1][k] = v0[f + 1];\n'
         '            s[2][k] = v0[f + 2];\n'
         '            s[3][k] = e1[f];\n'
         '            s[4][k] = e1[f + 1];\n'
         '            s[5][k] = e1[f + 2];\n'
         '            s[6][k] = e2[f];\n'
         '            s[7][k] = e2[f + 1];\n'
         '            s[8][k] = e2[f + 2];',
         '            s[0][k] = make_float4(v0[f], v0[f + 1], v0[f + 2], 0.f);\n'
         '            s[1][k] = make_float4(e1[f], e1[f + 1], e1[f + 2], 0.f);\n'
         '            s[2][k] = make_float4(e2[f], e2[f + 1], e2[f + 2], 0.f);')),
    'k4_warp_any': ((
        '        if (!done) {\n'
        '            for (int k = 0; k < cnt; ++k)\n'
        '                test_triangle(s, k, base + k, ox, oy, oz, dx, dy, dz, '
        'best);\n'
        '        }',
        '        for (int k = 0; k < cnt; ++k) {\n'
        '            if (!done)\n'
        '                test_triangle(s, k, base + k, ox, oy, oz, dx, dy, dz, '
        'best);\n'
        '            if (ANY && (k & 7) == 7) {\n'
        '                done = done || best.t < limit;\n'
        '                if (__all_sync(0xffffffffu, done)) break;\n'
        '            }\n'
        '        }'),),
    'k4_cull': (
        ('    __shared__ float s[9][TILE];', '    __shared__ float s[13][TILE];'),
        ('            s[8][k] = e2[f + 2];\n',
         '            s[8][k] = e2[f + 2];\n'
         '            const float mx = v0[f] + (e1[f] + e2[f]) / 3.0f;\n'
         '            const float my = v0[f + 1] + (e1[f + 1] + e2[f + 1]) / 3.0f;\n'
         '            const float mz = v0[f + 2] + (e1[f + 2] + e2[f + 2]) / 3.0f;\n'
         '            const float px = v0[f] - mx, py = v0[f + 1] - my,\n'
         '                        pz = v0[f + 2] - mz;\n'
         '            const float qx = px + e1[f], qy = py + e1[f + 1],\n'
         '                        qz = pz + e1[f + 2];\n'
         '            const float wx = px + e2[f], wy = py + e2[f + 1],\n'
         '                        wz = pz + e2[f + 2];\n'
         '            s[9][k] = mx;\n'
         '            s[10][k] = my;\n'
         '            s[11][k] = mz;\n'
         '            s[12][k] = 1.002f * fmaxf(fmaxf(px * px + py * py + pz * pz,\n'
         '                                            qx * qx + qy * qy + qz * qz),\n'
         '                                      wx * wx + wy * wy + wz * wz);\n'),
        ('// One thread per ray.  ANY: stop once every ray of the block has a hit\n',
         '__device__ __forceinline__ bool sphere_keeps(\n'
         '    const float (*s)[TILE], int k, float ox, float oy, float oz, float dx,\n'
         '    float dy, float dz) {\n'
         '    const float wx = s[9][k] - ox, wy = s[10][k] - oy, wz = s[11][k] - oz;\n'
         '    const float b = wx * dx + wy * dy + wz * dz;\n'
         '    const float ww = wx * wx + wy * wy + wz * wz;\n'
         '    const float r2 = s[12][k];\n'
         '    return ww - b * b <= r2 && (b >= 0.0f || b * b <= r2);\n'
         '}\n\n'
         '// One thread per ray.  ANY: stop once every ray of the block has a hit\n'),
        ('                test_triangle(s, k, base + k, ox, oy, oz, dx, dy, dz, '
         'best);\n',
         '                if (sphere_keeps(s, k, ox, oy, oz, dx, dy, dz))\n'
         '                    test_triangle(s, k, base + k, ox, oy, oz, dx, dy, dz,\n'
         '                                  best);\n')),
    'k4_nocull': (('    return far & steep;', '    return false;'),),
    'k4_threads128': (('constexpr int THREADS = 256;',
                       'constexpr int THREADS = 128;'),),
}

# the mesh Doppler kernel's walk queue (an Aila-Laine while-while walk over
# the warp's shadow rays and closest hits, one node a step, a thread whose
# walk ends taking the next request; SHADE's splat moved after it, its
# shadow known): the design tried where the walks' SIMT efficiency fell
# below 60% (PERF.md §6, PR 17)
MDK_SCOPE = 'receive_mesh_doppler_kernel(const float* __restrict__ params,'
ABLATIONS['mdk_queue'] = (
    ('        bool conn = false;\n        float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;\n        int n_bnd = 0;\n',
     "        bool conn = false;\n        float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;\n        int n_bnd = 0;\n        // this thread's shadow ray, if its NEE walks one\n        bool q_any = false;\n        float4 qa0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), qa1 = qa0;\n"),
    ('    float* w_vals = reinterpret_cast<float*>(w_take + 32);\n',
     '    float* w_vals = reinterpret_cast<float*>(w_take + 32);\n    float4* w_q = reinterpret_cast<float4*>(w_vals + 160);\n'),
    ('                    if (!occ && !(LOB && (is_m || kb == DIELECTRIC\n                                          || kb == THIN_DIELECTRIC))) {\n                        bvh::Any sh;\n                        sh.limit = limit;\n                        bvh::walk(mesh_b,\n                                  bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),\n                                  sh);\n                        occ = sh.occ;\n                    }\n', '                    if (!occ && !(LOB && (is_m || kb == DIELECTRIC\n                                          || kb == THIN_DIELECTRIC))) {\n                        q_any = true;\n                        qa0 = make_float4(sx, sy, sz, limit);\n                        qa1 = make_float4(wx_, wy_, wz_, 0.0f);\n                    }\n'),
    ('            if constexpr (!COH) {\n                if (conn) {\n                    // [k1 stage: splat]  the power (conn_splat)\n                    ci = val;\n                    lsum += val;\n                    events += val != 0.0f;\n                    if (!rows) {\n                        const Wave txw{s_tx + 16, s_tx + 28};\n                        grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {\n                            return bin_freq(cfg, txw, lo, f_recv, t_recv);\n                        });\n                    }\n                }\n            } else if (conn) {\n                // [k1 stage: phase]  the echo phase, I and Q (conn_splat)\n                const Wave txw{s_tx + 16, s_tx + 28};\n                float ph = echo_phase(txw, lo, cfg, sp, dtot, t_emit,\n                                      t_recv, k_c);\n                if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));\n                float amp = sqrtf(fmaxf(val, 0.0f));\n                ci = amp * fast_cos(ph);\n                si = amp * fast_sin(ph);\n                lsum += amp;\n                events += val != 0.0f;\n                if (!rows) {\n                    // [k1 stage: splat]\n                    grid_splat<true>(grid, cfg, ci, si, yb, [&] {\n                        return bin_freq(cfg, txw, lo, f_recv, t_recv);\n                    });\n                }\n            }\n\n', ''),
    ('        bool hit = false;\n        if (live) {\n            float tb = F(3.4e38);\n            int code = -1;\n            for (int r = 0; r < n_rect; ++r) {\n                // [k1 stage: closest]\n                float t_p;\n                bool hit_p = rect_hit4(s_rec + REC * r, ox, oy, oz, dx,\n                                       dy, dz, &t_p);\n                if (hit_p && t_p > F(1e-4) && t_p < tb) {\n                    tb = t_p;\n                    code = r;\n                }\n            }\n            // [k1 stage: walk]\n            MeshClosest<true> mc;\n            mc.ta = tb;\n            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), mc);\n            // [k1 stage: trace]\n            const bool tri = mc.t < tb;\n            if (tri) {\n                tb = mc.t;\n                code = -1 - min(max((int)mc.sid, 0), cfg.n_msh - 1);\n            }\n            hit = tb < F(3.4e37);\n            if (hit) {\n                const unsigned long long ln = (unsigned long long)lane;\n                sl4[0] = make_float4(ox, oy, oz, thr);\n                sl4[1] = make_float4(dx, dy, dz, plen);\n                sl4[2] = make_float4(t_rx0, tb, __int_as_float(code),\n                                     __int_as_float(depth\n                                                    | (wdel ? 1 << 16 : 0)));\n                sl4[3] = make_float4(__uint_as_float((unsigned)ln),\n                                     __uint_as_float((unsigned)(ln >> 32)),\n                                     dop, lsum);\n                if (tri) sl4[4] = make_float4(mc.nx, mc.ny, mc.nz, mc.rf);\n            }\n        }\n', "        bool hit = false;\n        float tb = F(3.4e38);\n        int code = -1;\n        if (live) {\n            for (int r = 0; r < n_rect; ++r) {\n                // [k1 stage: closest]\n                float t_p;\n                bool hit_p = rect_hit4(s_rec + REC * r, ox, oy, oz, dx,\n                                       dy, dz, &t_p);\n                if (hit_p && t_p > F(1e-4) && t_p < tb) {\n                    tb = t_p;\n                    code = r;\n                }\n            }\n        }\n        // [k1 stage: walk]  the warp's walk queue: its shadow rays\n        // and its live rays' closest hits (mdk_walk_queue)\n        MeshClosest<true> mc;\n        mc.ta = tb;\n        {\n            const unsigned b_any = __ballot_sync(FULL_MASK, q_any);\n            const unsigned b_cl = __ballot_sync(FULL_MASK, live);\n            const int n_any = __popc(b_any);\n            const int i_any = __popc(b_any & lt);\n            const int i_cl = n_any + __popc(b_cl & lt);\n            if (q_any) {\n                w_q[2 * i_any] = qa0;\n                w_q[2 * i_any + 1] = make_float4(qa1.x, qa1.y, qa1.z, 1.0f);\n            }\n            if (live) {\n                w_q[2 * i_cl] = make_float4(ox, oy, oz, tb);\n                w_q[2 * i_cl + 1] = make_float4(dx, dy, dz, 0.0f);\n            }\n            __syncwarp();\n            mdk_walk_queue(mesh_b, w_q, n_any + __popc(b_cl), lt);\n            if (q_any && w_q[2 * i_any].x != 0.0f) conn = false;\n            if (live) {\n                const float4 r0 = w_q[2 * i_cl], r1 = w_q[2 * i_cl + 1];\n                mc.t = r0.x;\n                mc.nx = r0.y;\n                mc.ny = r0.z;\n                mc.nz = r0.w;\n                mc.rf = r1.x;\n                mc.sid = r1.y;\n            }\n            __syncwarp();\n        }\n        // the connection, its shadow known (SHADE's splat moved here)\n        if constexpr (!COH) {\n            if (conn) {\n                // [k1 stage: splat]  the power (conn_splat)\n                ci = val;\n                lsum += val;\n                events += val != 0.0f;\n                if (!rows) {\n                    const Wave txw{s_tx + 16, s_tx + 28};\n                    grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {\n                        return bin_freq(cfg, txw, lo, f_recv, t_recv);\n                    });\n                }\n            }\n        } else if (conn) {\n            // [k1 stage: phase]  the echo phase, I and Q (conn_splat)\n            const Wave txw{s_tx + 16, s_tx + 28};\n            float ph = echo_phase(txw, lo, cfg, sp, dtot, t_emit,\n                                  t_recv, k_c);\n            if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));\n            float amp = sqrtf(fmaxf(val, 0.0f));\n            ci = amp * fast_cos(ph);\n            si = amp * fast_sin(ph);\n            lsum += amp;\n            events += val != 0.0f;\n            if (!rows) {\n                // [k1 stage: splat]\n                grid_splat<true>(grid, cfg, ci, si, yb, [&] {\n                    return bin_freq(cfg, txw, lo, f_recv, t_recv);\n                });\n            }\n        }\n\n        if (live) {\n            // [k1 stage: trace]\n            const bool tri = mc.t < tb;\n            if (tri) {\n                tb = mc.t;\n                code = -1 - min(max((int)mc.sid, 0), cfg.n_msh - 1);\n            }\n            hit = tb < F(3.4e37);\n            if (hit) {\n                const unsigned long long ln = (unsigned long long)lane;\n                sl4[0] = make_float4(ox, oy, oz, thr);\n                sl4[1] = make_float4(dx, dy, dz, plen);\n                sl4[2] = make_float4(t_rx0, tb, __int_as_float(code),\n                                     __int_as_float(depth\n                                                    | (wdel ? 1 << 16 : 0)));\n                sl4[3] = make_float4(__uint_as_float((unsigned)ln),\n                                     __uint_as_float((unsigned)(ln >> 32)),\n                                     dop, lsum);\n                if (tri) sl4[4] = make_float4(mc.nx, mc.ny, mc.nz, mc.rf);\n            }\n        }\n"))
SCOPE['mdk_queue'] = MDK_SCOPE
MDK_HELPER = "// The warp's walk queue (tools/k1_ablate.py mdk_queue): n requests at q,\n// two float4s each (origin and the prune distance: a shadow ray's limit or\n// a closest hit's analytic best; direction and kind, 1 any hit, 0\n// closest), walked by the warp's threads one node a step, a thread whose\n// walk ends taking the next request (Aila and Laine's persistent\n// while-while traversal, HPG 2009); each result overwrites its request\n// (any hit: occluded in .x; closest: t and the normal, then the\n// reflectance and shape row).  Each walk takes bvh::walk's steps in its\n// order, so the results are its bit for bit.\n__device__ void mdk_walk_queue(const bvh::Tables& tab, float4* q, int n,\n                               unsigned lt) {\n    int item = -1, head = 0, node = -1;\n    bool any = false;\n    bvh::Ray r{};\n    MeshClosest<true> mc;\n    bvh::Any an;\n    an.limit = 0.0f;\n    for (;;) {\n        const unsigned idle = __ballot_sync(FULL_MASK, item < 0);\n        const int rank = __popc(idle & lt);\n        if (item < 0 && head + rank < n) {\n            item = head + rank;\n            const float4 a = q[2 * item], b = q[2 * item + 1];\n            r = bvh::make_ray(a.x, a.y, a.z, b.x, b.y, b.z);\n            any = b.w != 0.0f;\n            mc = MeshClosest<true>();\n            mc.ta = a.w;\n            an.limit = a.w;\n            an.occ = false;\n            node = 0;\n        }\n        head += __popc(idle);\n        if (!__any_sync(FULL_MASK, item >= 0)) break;\n        if (item >= 0) {\n            const int* lk = tab.links + 3 * node;\n            if (bvh::slab(tab.bbox + 6 * node, r,\n                          any ? an.tbest() : mc.tbest())) {\n                const int leaf = __ldg(lk + 2);\n                bool done = false;\n                if (leaf >= 0) {\n                    const float* lr = tab.leaves + (long long)leaf * tab.stride;\n#pragma unroll 1\n                    for (int k = 0; k < bvh::K_LEAF; ++k) {\n                        bvh::TriHit h;\n                        if (bvh::triangle(lr, k, r, &h)) {\n                            if (any) {\n                                an.hit(h, lr);\n                                if (an.done()) {\n                                    done = true;\n                                    break;\n                                }\n                            } else {\n                                mc.hit(h, lr);\n                            }\n                        }\n                    }\n                }\n                node = done ? -1 : __ldg(lk);\n            } else {\n                node = __ldg(lk + 1);\n            }\n            if (node < 0) {\n                if (any) {\n                    q[2 * item] = make_float4(an.occ ? 1.0f : 0.0f, 0.0f,\n                                              0.0f, 0.0f);\n                } else {\n                    q[2 * item] = make_float4(mc.t, mc.nx, mc.ny, mc.nz);\n                    q[2 * item + 1] = make_float4(mc.rf, mc.sid, 0.0f, 0.0f);\n                }\n                item = -1;\n            }\n        }\n    }\n    __syncwarp();\n}\n\n"
OUTSIDE['mdk_queue'] = (
    ('    return 4 * (COH_POOL * MDK_SLOT + 32 + 160);',
     '    return 4 * (COH_POOL * MDK_SLOT + 32 + 160 + 8 * COH_POOL);'),
    ('template <bool COH, bool LOB>\n__global__ void __launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)\n',
     MDK_HELPER + 'template <bool COH, bool LOB>\n__global__ void __launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)\n'))
# the pulse's BVH in shared memory where it fits (multi_body's 19 KB; the
# mesh scene's 575 KB does not): a walk of its own over the block's copy
# (the tables' sizes from the per-pulse strides, which _launch then passes
# for one pulse too)
ABLATIONS['mdk_smem_bvh'] = (
    ('    const bvh::Tables mesh_b = pulse_tables(mesh, cfg);\n',
     '    const bvh::Tables mesh_b = pulse_tables(mesh, cfg);\n'
     '    // the pulse\'s BVH in shared memory when it fits\n'
     '    const long long bvh_n = cfg.bbox_stride + cfg.links_stride\n'
     '                            + cfg.leaves_stride;\n'
     '    const bool bvh_s = bvh_n > 0 && 4 * bvh_n <= MDK_SMEM_BVH_BYTES;\n'
     '    bvh::Tables mesh_s = mesh_b;\n'
     '    if (bvh_s) {\n'
     '        float* sb = reinterpret_cast<float*>(\n'
     '            s_warps + (T / 32) * wbytes\n'
     '            + (cfg.mode == 1 && !rows ? 4 * n_vals : 0));\n'
     '        int* sl = reinterpret_cast<int*>(sb + cfg.bbox_stride);\n'
     '        float* sf = reinterpret_cast<float*>(sl + cfg.links_stride);\n'
     '        for (long long i = tid; i < cfg.bbox_stride; i += T)\n'
     '            sb[i] = mesh_b.bbox[i];\n'
     '        for (long long i = tid; i < cfg.links_stride; i += T)\n'
     '            sl[i] = mesh_b.links[i];\n'
     '        for (long long i = tid; i < cfg.leaves_stride; i += T)\n'
     '            sf[i] = mesh_b.leaves[i];\n'
     '        mesh_s = bvh::Tables{sb, sl, sf, mesh_b.stride};\n'
     '    }\n'
     '    __syncthreads();\n'),
    ('                        bvh::walk(mesh_b,\n'
     '                                  bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),\n'
     '                                  sh);\n',
     '                        if (bvh_s)\n'
     '                            walk_s(mesh_s, bvh::make_ray(sx, sy, sz, wx_,\n'
     '                                                         wy_, wz_), sh);\n'
     '                        else\n'
     '                            bvh::walk(mesh_b,\n'
     '                                      bvh::make_ray(sx, sy, sz, wx_, wy_,\n'
     '                                                    wz_), sh);\n'),
    ('            MeshClosest<true> mc;\n            mc.ta = tb;\n'
     '            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), mc);\n',
     '            MeshClosestS mc;\n            mc.ta = tb;\n'
     '            if (bvh_s)\n'
     '                walk_s(mesh_s, bvh::make_ray(ox, oy, oz, dx, dy, dz), mc);\n'
     '            else\n'
     '                bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz),\n'
     '                          mc);\n'))
SCOPE['mdk_smem_bvh'] = MDK_SCOPE
OUTSIDE['mdk_smem_bvh'] = (
    ('               + (mode == 1 && !rows ? 4 * per_bin * n_time * n_freq : 0);\n'
     '    } else if (DOP) {',
     '               + (mode == 1 && !rows ? 4 * per_bin * n_time * n_freq : 0)\n'
     '               + MDK_SMEM_BVH_BYTES;\n'
     '    } else if (DOP) {'),
    ('template <bool COH, bool LOB>\n__global__ void __launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)\n',
     "// The pulse's BVH in shared memory (tools/k1_ablate.py mdk_smem_bvh): a\n// block reserves MDK_SMEM_BVH_BYTES after its grid and copies the tables\n// there when they fit (multi_body's 324 faces: 81 nodes, 41 leaves, 19 KB);\n// the walk reads them with plain loads (a read-only load of a shared\n// address is not allowed): bvh::slab, bvh::triangle and bvh::walk with\n// every operation as there.\nconstexpr int MDK_SMEM_BVH_BYTES = 20480;\n\n__device__ __forceinline__ bool slab_s(const float* bb, const bvh::Ray& r,\n                                       float tbest) {\n    float tx0 = (bb[0] - r.ox) * r.ix;\n    float tx1 = (bb[3] - r.ox) * r.ix;\n    float ty0 = (bb[1] - r.oy) * r.iy;\n    float ty1 = (bb[4] - r.oy) * r.iy;\n    float tz0 = (bb[2] - r.oz) * r.iz;\n    float tz1 = (bb[5] - r.oz) * r.iz;\n    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),\n                     fminf(tz0, tz1));\n    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),\n                     fmaxf(tz0, tz1));\n    return tf >= fmaxf(tn, 0.0f) && tn < tbest;\n}\n\n__device__ __forceinline__ bool triangle_s(const float* lr, int k,\n                                           const bvh::Ray& r,\n                                           bvh::TriHit* h) {\n    float v0x = lr[0 + k], v0y = lr[8 + k], v0z = lr[16 + k];\n    float e1x = lr[24 + k], e1y = lr[32 + k], e1z = lr[40 + k];\n    float e2x = lr[48 + k], e2y = lr[56 + k], e2z = lr[64 + k];\n    float tri = lr[72 + k];\n    float px = r.dy * e2z - r.dz * e2y;\n    float py = r.dz * e2x - r.dx * e2z;\n    float pz = r.dx * e2y - r.dy * e2x;\n    float det = e1x * px + e1y * py + e1z * pz;\n    float inv = fabsf(det) > (float)1e-12 ? 1.0f / det : 0.0f;\n    float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;\n    float uu = (tvx * px + tvy * py + tvz * pz) * inv;\n    float qx = tvy * e1z - tvz * e1y;\n    float qy = tvz * e1x - tvx * e1z;\n    float qz = tvx * e1y - tvy * e1x;\n    float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;\n    float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;\n    h->t = tt; h->u = uu; h->v = vv;\n    h->e1x = e1x; h->e1y = e1y; h->e1z = e1z;\n    h->e2x = e2x; h->e2y = e2y; h->e2z = e2z;\n    h->slot = k;\n    return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f\n           && tt > (float)1e-4 && tri >= 0.0f;\n}\n\n// the visitors' leaf payloads from a shared row: MeshClosest's reflectance\n// and shape row (columns 80, 88)\nstruct MeshClosestS : MeshClosest<true> {\n    __device__ void hit(const bvh::TriHit& h, const float* lr) {\n        if (!(h.t < t)) return;\n        float gnx = cross_rn(h.e1y, h.e2z, h.e1z, h.e2y);\n        float gny = cross_rn(h.e1z, h.e2x, h.e1x, h.e2z);\n        float gnz = cross_rn(h.e1x, h.e2y, h.e1y, h.e2x);\n        float rn = rsqrtf(fmaxf(gnx * gnx + gny * gny + gnz * gnz,\n                                F(1e-20)));\n        nx = gnx * rn;\n        ny = gny * rn;\n        nz = gnz * rn;\n        rf = lr[80 + h.slot];\n        sid = lr[88 + h.slot];\n        t = h.t;\n    }\n};\n\ntemplate <class V>\n__device__ __forceinline__ void walk_s(const bvh::Tables& t,\n                                       const bvh::Ray& r, V& v) {\n    int node = 0;\n    while (node >= 0) {\n        const int* lk = t.links + 3 * node;\n        if (slab_s(t.bbox + 6 * node, r, v.tbest())) {\n            int leaf = lk[2];\n            if (leaf >= 0) {\n                const float* lr = t.leaves + (long long)leaf * t.stride;\n#pragma unroll 1\n                for (int k = 0; k < bvh::K_LEAF; ++k) {\n                    bvh::TriHit h;\n                    if (triangle_s(lr, k, r, &h)) {\n                        v.hit(h, lr);\n                        if (v.done()) return;\n                    }\n                }\n            }\n            node = lk[0];\n        } else {\n            node = lk[1];\n        }\n    }\n}\n\n" + 'template <bool COH, bool LOB>\n__global__ void __launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)\n'))
# package files (relative to the tree) an ablation also edits
PY_EDITS = {'mdk_smem_bvh': (
    ('integrators/receive_kernel.py',
     '        m_strides = (0, 0, 0) if mesh is None or n_pulses == 1 else tuple(',
     '        m_strides = (0, 0, 0) if mesh is None else tuple('),)}
# the mesh configuration in power routed to the mesh Doppler kernel
# <false, false> with no new code: the wrapper hands it the Doppler mesh's
# tables (one static diffuse mesh-shape row, the block's grid: mode 1),
# whose lanes are the mesh configuration's (tools/k1_emulate.py
# mesh_power_mdk holds them lane by lane)
ABLATIONS['msk_mdk'] = ()
PY_EDITS['msk_mdk'] = (
    ('integrators/receive_kernel.py',
     '''    dev = params.device
    lib = LIBRARY.get()
    n_elem = 0 if eoff is None else int(eoff.shape[0])''',
     '''    dev = params.device
    if mesh is not None and not doppler and not medium and not ep:
        doppler = True
        msh = torch.zeros(tuple(params.shape[:-1]) + (1, 8), device=dev)
    lib = LIBRARY.get()
    n_elem = 0 if eoff is None else int(eoff.shape[0])'''),)
for _n in (1, 8, 16):
    K4_ABLATIONS[f'k4_group{_n}'] = (('constexpr int GROUP = 32;',
                                      f'constexpr int GROUP = {_n};'),)
# masks of 64 triangles
K4_ABLATIONS['k4_group64'] = (
    ('constexpr int GROUP = 32;', 'constexpr int GROUP = 64;'),
    ('            unsigned keep = 0;', '            unsigned long long keep = 0;'),
    ('                    keep |= 1u << j;', '                    keep |= 1ull << j;'),
    ('            if (cnt - k0 < GROUP) keep &= (1u << (cnt - k0)) - 1u;',
     '            if (cnt - k0 < GROUP) keep &= (1ull << (cnt - k0)) - 1ull;'),
    ('                const int j = __ffs(keep) - 1;',
     '                const int j = __ffsll(keep) - 1;'))
# two rays a thread: one pair of cull records loaded for two culls (a
# span: the kernel and blocks_for)
K4_ABLATIONS['k4_rays2'] = ((
    '// One thread per ray.  ANY: stop once the ray has a hit before its '
    'limit.', '}  // namespace', r'''constexpr int RAYS = 2;   // rays a thread

// RAYS rays a thread.  ANY: stop once the ray has a hit before its limit.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
ray_triangle_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ v0,
                    const float* __restrict__ e1,
                    const float* __restrict__ e2, int n_rays, int n_tris,
                    const float* __restrict__ maxt, float* __restrict__ t_out,
                    int* __restrict__ idx_out, float* __restrict__ u_out,
                    float* __restrict__ v_out,
                    uint8_t* __restrict__ occ_out) {
    extern __shared__ float4 ksm[];
    const Tile s(ksm, tile_cap(n_tris));
    Ray r[RAYS];
    float limit[RAYS];
    Hit best[RAYS];
    bool done[RAYS];
    int ii[RAYS];
#pragma unroll
    for (int q = 0; q < RAYS; ++q) {
        const int i = (blockIdx.x * RAYS + q) * THREADS + threadIdx.x;
        ii[q] = i;
        r[q] = Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        limit[q] = 0.f;
        best[q] = Hit{INFINITY, 0.0f, 0.0f, -1};
        done[q] = i >= n_rays;
        if (i < n_rays) {
            r[q].ox = o[3 * i];
            r[q].oy = o[3 * i + 1];
            r[q].oz = o[3 * i + 2];
            r[q].dx = d[3 * i];
            r[q].dy = d[3 * i + 1];
            r[q].dz = d[3 * i + 2];
            const float len = sqrtf(dot3(r[q].dx, r[q].dy, r[q].dz, r[q].dx,
                                         r[q].dy, r[q].dz));
            r[q].hx = r[q].dx / len;
            r[q].hy = r[q].dy / len;
            r[q].hz = r[q].dz / len;
            if (ANY) limit[q] = __fmul_rn(maxt[i], (float)(1.0 - 1e-3));
        }
    }
    for (int base = 0; base < n_tris; base += TILE) {
        const int cnt = min(TILE, n_tris - base);
        if (base > 0) __syncthreads();
        stage(s, v0, e1, e2, base, cnt);
        __syncthreads();
        for (int k0 = 0; k0 < cnt && !__all_sync(FULL, done[0] && done[1]);
             k0 += GROUP) {
            unsigned keep[RAYS] = {0u, 0u};
#pragma unroll
            for (int j = 0; j < GROUP; ++j) {
                const float4 c = s.c[k0 + j], n = s.n[k0 + j];
#pragma unroll
                for (int q = 0; q < RAYS; ++q)
                    if (!cull_rejects(r[q], c, n)) keep[q] |= 1u << j;
            }
#pragma unroll
            for (int q = 0; q < RAYS; ++q) {
                if (cnt - k0 < GROUP) keep[q] &= (1u << (cnt - k0)) - 1u;
                if (done[q]) keep[q] = 0;
                while (keep[q]) {
                    const int j = __ffs(keep[q]) - 1;
                    keep[q] &= keep[q] - 1;
                    test_triangle(s, k0 + j, base + k0 + j, r[q], best[q]);
                    if (ANY && best[q].t < limit[q]) break;
                }
                if (ANY) done[q] = done[q] || best[q].t < limit[q];
            }
        }
        if (ANY && __syncthreads_and(done[0] && done[1])) break;
    }
#pragma unroll
    for (int q = 0; q < RAYS; ++q) {
        const int i = ii[q];
        if (i >= n_rays) continue;
        if (ANY) {
            occ_out[i] = best[q].t < limit[q] ? 1 : 0;
        } else {
            t_out[i] = best[q].t;
            idx_out[i] = best[q].idx;
            u_out[i] = best[q].u;
            v_out[i] = best[q].v;
        }
    }
}

int blocks_for(int n_rays) {
    return (n_rays + RAYS * THREADS - 1) / (RAYS * THREADS);
}


'''),)
# D3, the warp queue: each warp queues its lanes' kept pairs in shared
# memory (an inclusive sum over lanes places them) and runs the exact test
# 32 pairs at a time, a ray's best (t, index) a 64-bit key under a shared
# atomicMin, u and v recomputed for the winner at the end; a group that
# overflows the queue is tested lane by lane.  The second edit is a span:
# (first line, the text that ends it, its replacement).
K4_ABLATIONS['k4_queue'] = (
    ('size_t tile_bytes(int n_tris) {\n'
     '    return (size_t)tile_cap(n_tris) * (4 * sizeof(float4) + '
     'sizeof(float));\n}',
     'constexpr int WARPS = THREADS / 32;\n'
     'constexpr int QCAP = 256;      // queued (ray, triangle) pairs a warp\n'
     '// a block\'s best keys (one a ray) and its warps\' queues, before the '
     'tile\n'
     'constexpr int HEAD_BYTES = THREADS * 8 + WARPS * QCAP * 4;\n\n'
     'size_t tile_bytes(int n_tris) {\n'
     '    return HEAD_BYTES\n'
     '        + (size_t)tile_cap(n_tris) * (4 * sizeof(float4) + '
     'sizeof(float));\n}'),
    ('// Moller-Trumbore of one ray against triangle k of the tile, rounding',
     'int blocks_for(int n_rays)', r'''// Moller-Trumbore of the ray (o, d) against (v0, e1, e2), rounding every
// operation as the plain version does: true on a hit with t < +inf.
__device__ __forceinline__ bool moller_trumbore(
    float ox, float oy, float oz, float dx, float dy, float dz, float v0x,
    float v0y, float v0z, float e1x, float e1y, float e1z, float e2x,
    float e2y, float e2z, float& t, float& u, float& v) {
    const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
    const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
    const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px),
                                          __fmul_rn(e1y, py)),
                                __fmul_rn(e1z, pz));
    const bool big = fabsf(det) > 1e-12f;
    const float inv = big ? __frcp_rn(det) : 0.0f;
    const float tx = __fsub_rn(ox, v0x);
    const float ty = __fsub_rn(oy, v0y);
    const float tz = __fsub_rn(oz, v0z);
    u = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(tx, px), __fmul_rn(ty, py)),
                            __fmul_rn(tz, pz)), inv);
    const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
    const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
    const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
    v = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, qx), __fmul_rn(dy, qy)),
                            __fmul_rn(dz, qz)), inv);
    t = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(e2x, qx), __fmul_rn(e2y, qy)),
                            __fmul_rn(e2z, qz)), inv);
    return big && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f &&
           t > 1e-4f && t < INFINITY;
}

// A hit's key: t's bits over the index.  Hits have t > 1e-4 > 0, so the
// integer order is t's, then the index's: the least key is the closest
// hit with the lowest index among equal t.
__device__ __forceinline__ unsigned long long hit_key(float t, int index) {
    return (unsigned long long)__float_as_uint(t) << 32 | (unsigned)index;
}

// The exact test of the ray (o, d) against triangle k of the tile, folded
// into `key` (a shared-memory atomic: other lanes test this ray's pairs).
__device__ __forceinline__ void test_into(const Tile& s, int k, int index,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          unsigned long long* key) {
    const float4 a = s.a[k], b = s.b[k];
    float t, u, v;
    if (moller_trumbore(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, a.w, b.x, b.y,
                        b.z, b.w, s.z[k], t, u, v))
        atomicMin(key, hit_key(t, index));
}

// One batch of the warp's queue, a pair a lane: entry e = (ray lane << 16
// | triangle of the tile); `valid` false for a lane without one.
__device__ __forceinline__ void run_pair(const Tile& s, int base,
                                         unsigned e, bool valid,
                                         const Ray& r,
                                         unsigned long long* wkeys) {
    const int src = (int)(e >> 16), k = (int)(e & 0xffffu);
    const float ox = __shfl_sync(FULL, r.ox, src);
    const float oy = __shfl_sync(FULL, r.oy, src);
    const float oz = __shfl_sync(FULL, r.oz, src);
    const float dx = __shfl_sync(FULL, r.dx, src);
    const float dy = __shfl_sync(FULL, r.dy, src);
    const float dz = __shfl_sync(FULL, r.dz, src);
    if (valid) test_into(s, k, base + k, ox, oy, oz, dx, dy, dz, wkeys + src);
}

__device__ __forceinline__ float key_t(unsigned long long key) {
    return __uint_as_float((unsigned)(key >> 32));   // NaN for no hit
}

// One thread per ray.  Each warp queues its rays' kept pairs and runs the
// exact test 32 pairs at a time.  ANY: stop once the ray has a hit before
// its limit.
template <bool ANY>
__global__ void __launch_bounds__(THREADS)
ray_triangle_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ v0,
                    const float* __restrict__ e1,
                    const float* __restrict__ e2, int n_rays, int n_tris,
                    const float* __restrict__ maxt, float* __restrict__ t_out,
                    int* __restrict__ idx_out, float* __restrict__ u_out,
                    float* __restrict__ v_out,
                    uint8_t* __restrict__ occ_out) {
    extern __shared__ float4 ksm[];
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(ksm);
    unsigned* queue = reinterpret_cast<unsigned*>(keys + THREADS)
                      + (threadIdx.x >> 5) * QCAP;
    const Tile s(ksm + HEAD_BYTES / 16, tile_cap(n_tris));
    const int lane = threadIdx.x & 31;
    unsigned long long* wkeys = keys + (threadIdx.x & ~31);
    unsigned long long* key = keys + threadIdx.x;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const bool live = i < n_rays;
    Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float limit = 0.f;
    if (live) {
        r.ox = o[3 * i];
        r.oy = o[3 * i + 1];
        r.oz = o[3 * i + 2];
        r.dx = d[3 * i];
        r.dy = d[3 * i + 1];
        r.dz = d[3 * i + 2];
        const float len = sqrtf(dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz));
        r.hx = r.dx / len;
        r.hy = r.dy / len;
        r.hz = r.dz / len;
        if (ANY) limit = __fmul_rn(maxt[i], (float)(1.0 - 1e-3));
    }
    *key = ~0ull;
    bool done = !live;
    for (int base = 0; base < n_tris; base += TILE) {
        const int cnt = min(TILE, n_tris - base);
        if (base > 0) __syncthreads();   // every warp is done with the tile
        stage(s, v0, e1, e2, base, cnt);
        __syncthreads();
        int n = 0;                       // pairs in the warp's queue
        for (int k0 = 0; k0 < cnt && !__all_sync(FULL, done);
             k0 += GROUP) {
            unsigned keep = 0;
#pragma unroll
            for (int j = 0; j < GROUP; ++j)
                if (!cull_rejects(r, s.c[k0 + j], s.n[k0 + j]))
                    keep |= 1u << j;
            if (cnt - k0 < GROUP) keep &= (1u << (cnt - k0)) - 1u;
            if (done) keep = 0;
            if (!__any_sync(FULL, keep != 0)) continue;
            // the lane's place in the queue: an inclusive sum over lanes
            const int c = __popc(keep);
            int incl = c;
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(FULL, incl, off);
                if (lane >= off) incl += y;
            }
            const int total = __shfl_sync(FULL, incl, 31);
            if (n + total > QCAP) {
                // more than the queue holds: drain it, then test this
                // group's pairs lane by lane
                run_pair(s, base, lane < n ? queue[lane] : 0u, lane < n, r,
                         wkeys);
                n = 0;
                while (keep) {
                    const int j = __ffs(keep) - 1;
                    keep &= keep - 1;
                    test_into(s, k0 + j, base + k0 + j, r.ox, r.oy, r.oz,
                              r.dx, r.dy, r.dz, key);
                }
            } else {
                for (int at = n + incl - c; keep; ++at) {
                    const int j = __ffs(keep) - 1;
                    keep &= keep - 1;
                    queue[at] = (unsigned)lane << 16 | (unsigned)(k0 + j);
                }
                n += total;
                __syncwarp();
                while (n >= 32) {
                    n -= 32;
                    run_pair(s, base, queue[n + lane], true, r, wkeys);
                }
            }
            __syncwarp();
            if (ANY) done = done || key_t(*key) < limit;
        }
        // the rest, before the next tile overwrites the records
        if (n > 0)
            run_pair(s, base, lane < n ? queue[lane] : 0u, lane < n, r,
                     wkeys);
        __syncwarp();
        if (ANY) {
            done = done || key_t(*key) < limit;
            if (__syncthreads_and(done)) break;
        }
    }
    __syncwarp();
    if (!live) return;
    const unsigned long long kb = *key;
    if (ANY) {
        occ_out[i] = key_t(kb) < limit ? 1 : 0;
        return;
    }
    float t = INFINITY, u = 0.0f, v = 0.0f;
    int idx = -1;
    if (kb != ~0ull) {
        // u and v of the winner, as its exact test computed them
        idx = (int)(unsigned)kb;
        const long long f = 3LL * idx;
        moller_trumbore(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, v0[f], v0[f + 1],
                        v0[f + 2], e1[f], e1[f + 1], e1[f + 2], e2[f],
                        e2[f + 1], e2[f + 2], t, u, v);
    }
    t_out[i] = t;
    idx_out[i] = idx;
    u_out[i] = u;
    v_out[i] = v;
}

'''))
# D3 held to five blocks an SM
K4_ABLATIONS['k4_queue_lb5'] = K4_ABLATIONS['k4_queue'] + ((
    'template <bool ANY>\n__global__ void __launch_bounds__(THREADS)\n'
    'ray_triangle_kernel(',
    'template <bool ANY>\n__global__ void __launch_bounds__(THREADS, 5)\n'
    'ray_triangle_kernel('),)
# the grid-stride endpoint twins' ablations (a parent before the endpoint
# kernels)
EP_PAIR_FLOATS = 4 * 2 + 6 * 128 + 2 + 6 * 64   # php's caps, then rxph's
EP_RXPH_AT = 4 * 2 + 6 * 128
ABLATIONS['ep_smem'] = (
    ('    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS : TXP_COLS;\n'
     '    extern __shared__ float smem[];',
     f'    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS + {EP_PAIR_FLOATS}'
     ' : TXP_COLS;\n    extern __shared__ float smem[];'),
    ('    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS : TXP_COLS;\n'
     '    int T, smem;',
     f'    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS + {EP_PAIR_FLOATS}'
     ' : TXP_COLS;\n    int T, smem;'),
    ('            r[31] = r[10] * tnn;\n        }\n        __syncthreads();\n'
     '    }\n',
     '            r[31] = r[10] * tnn;\n        }\n'
     '        float* s_pair = s_tx + MAX_TX * TXP_COLS;\n'
     '        if (cfg.php != nullptr)\n'
     '            for (int i = tid; i < cfg.n_tx * cfg.php_cols; i += T)\n'
     '                s_pair[i] = cfg.php[i];\n'
     '        if (cfg.rx_phased)\n'
     '            for (int i = tid; i < 2 + 6 * cfg.n_rx_pairs; i += T)\n'
     f'                s_pair[{EP_RXPH_AT} + i] = cfg.rxph[i];\n'
     '        __syncthreads();\n    }\n'
     '    Cfg cfg2 = cfg;\n'
     '    if constexpr (EP) {\n'
     '        if (cfg.php != nullptr) cfg2.php = s_tx + MAX_TX * TXP_COLS;\n'
     '        if (cfg.rx_phased)\n'
     f'            cfg2.rxph = s_tx + MAX_TX * TXP_COLS + {EP_RXPH_AT};\n'
     '    }\n'),
    ('            cfg, s_par, s_prim, s_msh, tx, lo, mesh_b, dr, my_hist, T, '
     'grid,',
     '            cfg2, s_par, s_prim, s_msh, tx, lo, mesh_b, dr, my_hist, T, '
     'grid,'),
    ('__device__ float pair_sum(const float* __restrict__ row, int n_k,',
     '#define __ldg(p) (*(p))\n'
     '__device__ float pair_sum(const float* __restrict__ row, int n_k,'),
    ('        total = total + w_rect * fast_cos(ph) * val_k;\n    }\n'
     '    return total;\n}\n',
     '        total = total + w_rect * fast_cos(ph) * val_k;\n    }\n'
     '    return total;\n}\n#undef __ldg\n'))
# the pair loop behind a pre-test: a point outside the union of an
# array's footprints (a box in its s, t coordinates, widened by 1% of the
# element and 1e-5 m) skips it (the same sums where no accepted pair lies
# outside the box)
ABLATIONS['ep_union'] = (
    ('__device__ float pair_sum(const float* __restrict__ row, int n_k, '
     'float snx,',
     '__shared__ float ep_union[MAX_TX + 1][4];\n'
     '__shared__ const float* ep_union_row[MAX_TX + 1];\n\n'
     '__device__ float pair_sum(const float* __restrict__ row, int n_k, '
     'float snx,'),
    ('''    const float iwt = 1.0f / fmaxf(2.0f * wid_t, F(1e-20));
    float total = 0.0f;
#pragma unroll 1
    for (int k = 0; k < n_k; ++k) {''',
     '''    const float iwt = 1.0f / fmaxf(2.0f * wid_t, F(1e-20));
    float total = 0.0f;
    for (int a = 0; a < MAX_TX + 1; ++a) {
        if (ep_union_row[a] != row) continue;
        const float qs = (px - ox) * snx + (py - oy) * sny + (pz - oz) * snz;
        const float qt = (px - ox) * tnx + (py - oy) * tny + (pz - oz) * tnz;
        const float* u = ep_union[a];
        if (!(qs >= u[0] && qs <= u[1] && qt >= u[2] && qt <= u[3]))
            return total;
        break;
    }
#pragma unroll 1
    for (int k = 0; k < n_k; ++k) {'''),
    ('''            r[31] = r[10] * tnn;
        }
        __syncthreads();
    }
''',
     '''            r[31] = r[10] * tnn;
        }
        for (int a = tid; a < MAX_TX + 1; a += T) {
            const float* row = a < cfg.n_tx && cfg.php != nullptr
                                   ? cfg.php + a * cfg.php_cols
                               : a == MAX_TX && cfg.rx_phased ? cfg.rxph
                                                              : nullptr;
            const int n_k = a < cfg.n_tx ? cfg.n_pairs : cfg.n_rx_pairs;
            ep_union_row[a] = row;
            if (row == nullptr) continue;
            float s0 = F(3.4e38), s1 = -F(3.4e38), t0 = F(3.4e38),
                  t1 = -F(3.4e38);
            for (int k = 0; k < n_k; ++k) {
                s0 = fminf(s0, row[2 + 6 * k]);
                s1 = fmaxf(s1, row[2 + 6 * k]);
                t0 = fminf(t0, row[3 + 6 * k]);
                t1 = fmaxf(t1, row[3 + 6 * k]);
            }
            const float ms = 1.01f * row[0] + F(1e-5),
                        mt = 1.01f * row[1] + F(1e-5);
            ep_union[a][0] = s0 - ms;
            ep_union[a][1] = s1 + ms;
            ep_union[a][2] = t0 - mt;
            ep_union[a][3] = t1 + mt;
        }
        __syncthreads();
    }
'''))
ABLATIONS['ep_unroll4'] = ((
    '#pragma unroll 1\n    for (int k = 0; k < n_k; ++k) {\n'
    '        const float* q = row + 2 + 6 * k;',
    '#pragma unroll 4\n    for (int k = 0; k < n_k; ++k) {\n'
    '        const float* q = row + 2 + 6 * k;'),)
ABLATIONS['ep_gain1'] = ((
    '    const float TP = F(6.283185307179586);\n'
    '    float nu_x = (dex * snx + dey * sny + dez * snz) / lam;\n'
    '    float nu_y = (dex * tnx + dey * tny + dez * tnz) / lam;\n'
    '    const float wid_s = __ldg(row), wid_t = __ldg(row + 1);',
    '    return 1.0f;\n'
    '    const float TP = F(6.283185307179586);\n'
    '    float nu_x = (dex * snx + dey * sny + dez * snz) / lam;\n'
    '    float nu_y = (dex * tnx + dey * tny + dez * tnz) / lam;\n'
    '    const float wid_s = __ldg(row), wid_t = __ldg(row + 1);'),)
ABLATIONS['ep_noshadow'] = ((
    '                        if (row[14] == (float)t || (int)row[0] != '
    'RECTANGLE)',
    '                        if (true)'),)
# the endpoint kernels' ablations
ABLATIONS['epx_full'] = ((
    '    };\n    if (hi[21] && fabsf(px) + fabsf(py) + fabsf(pz) <= h[17]) {',
    '    };\n    if (false && hi[21] && fabsf(px) + fabsf(py) + fabsf(pz) '
    '<= h[17]) {'),)
# the endpoint kernels' blocks an SM
for _n in (4, 5):
    ABLATIONS[f'epw_lb{_n}'] = (('constexpr int EPW_MIN_BLOCKS = 6;',
                                 f'constexpr int EPW_MIN_BLOCKS = {_n};'),)
for _n in (3, 4, 5):
    ABLATIONS[f'epc_lb{_n}'] = (('constexpr int EPC_MIN_BLOCKS = 6;',
                                 f'constexpr int EPC_MIN_BLOCKS = {_n};'),)
# the footprint index with 32 cells an axis (the sums stay bit for bit)
ABLATIONS['epx_cells32'] = (('constexpr int EPX_CELLS = 64;      // cells an axis',
                             'constexpr int EPX_CELLS = 32;      // cells an axis'),)
# the indexed pair loop two pairs at a time (their terms independent,
# their sums in pair order: the same bits)
ABLATIONS['epx_pairs2'] = (
    ('''    auto term = [&](int k) {
        if constexpr (COUNT) ++*visits;
        const float4 q = rec[2 * k];''',
     '''    auto value = [&](int k, bool* in, float* val_k) {
        if constexpr (COUNT) ++*visits;
        const float4 q = rec[2 * k];'''),
    ('''        float ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt;
        if (!(fabsf(rx_) <= 0.5f && fabsf(ry_) <= 0.5f)) return;
        // [k1 stage: pair_terms]
        const float4 q1 = rec[2 * k + 1];
        const float val_k = q1.y;
        if (val_k == 0.0f) return;
        float txr = tri_f(rx_), tyr = tri_f(ry_);''',
     '''        float ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt;
        const float4 q1 = rec[2 * k + 1];
        *val_k = q1.y;
        *in = fabsf(rx_) <= 0.5f && fabsf(ry_) <= 0.5f && q1.y != 0.0f;
        // [k1 stage: pair_terms]
        float txr = tri_f(rx_), tyr = tri_f(ry_);'''),
    ('''        float ph = TP * (nu_x * q.z + nu_y * q.w) + q1.x;
        total = total + w_rect * fast_cos(ph) * val_k;
    };''',
     '''        float ph = TP * (nu_x * q.z + nu_y * q.w) + q1.x;
        return w_rect * fast_cos(ph);
    };
    auto term = [&](int k) {
        bool in;
        float v;
        const float a = value(k, &in, &v);
        if (in) total = total + a * v;
    };
    auto term2 = [&](int k1, int k2) {
        bool in1, in2;
        float v1, v2;
        const float a1 = value(k1, &in1, &v1), a2 = value(k2, &in2, &v2);
        if (in1) total = total + a1 * v1;
        if (in2) total = total + a2 * v2;
    };'''),
    ('''                const int k = 64 * w + __ffsll((long long)b) - 1;
                b &= b - 1ull;
                term(k);''',
     '''                const int k = 64 * w + __ffsll((long long)b) - 1;
                b &= b - 1ull;
                if (b == 0ull) {
                    term(k);
                    break;
                }
                const int k2 = 64 * w + __ffsll((long long)b) - 1;
                b &= b - 1ull;
                term2(k, k2);'''),
    ('''#pragma unroll 1
    for (int k = 0; k < hi[20]; ++k) term(k);
    return total;''',
     '''#pragma unroll 1
    for (int k = 0; k + 1 < hi[20]; k += 2) term2(k, k + 1);
    if (hi[20] & 1) term(hi[20] - 1);
    return total;'''))


# the receiver's cross-WDF for a whole warp (pair_sum_warp): the warp's
# (lane, pair) items spread over its threads, each lane's terms staged in
# the warp's splat area and added in pair order (the same sums)
ABLATIONS['epx_warp'] = (
    ('// ---- the power endpoint kernel: a warp wavefront',
     "// The receiver's cross-WDF for a whole warp (every thread calls it;\n// `active` the lanes with a ray): pair_sum_epx's sums, bit for bit, with\n// the work spread over the warp.  A lane's visits depend on its point's\n// cells (0-16 on an 8-element line), so a warp running each lane's own\n// loop waits for its busiest lane; here each lane finds its pairs (the\n// cells' mask, or every pair where the index does not hold), the warp\n// numbers the (lane, pair) items by a prefix sum of their counts, and\n// each round the 32 threads take 32 consecutive items: a thread finds its\n// item's lane (a binary search over the lanes' first items) and pair (the\n// rank-th set bit of that lane's mask), fetches the lane's point and\n// frequencies by shuffles, and runs pair_sum_epx's test and term; then\n// every lane adds, in item order, the terms of its own items (staged\n// from the threads that made them through `stage`, 32 float2s of the\n// warp's, which RAY turns leave free).  A lane's items are consecutive and\n// in ascending pair order, so its sum takes the same terms in the same\n// order as pair_sum_epx's, with the same expression.\n__device__ float pair_sum_warp(const Epx& ix, int a, bool active, float px,\n                               float py, float pz, float dex, float dey,\n                               float dez, float lam, float2* stage, int j) {\n    const float TP = F(6.283185307179586);\n    const float* h = ix.hdr + EPX_HDR * a;\n    const int* hi = reinterpret_cast<const int*>(h);\n    const float snx = h[0], sny = h[1], snz = h[2];\n    const float tnx = h[3], tny = h[4], tnz = h[5];\n    const float ox = h[6], oy = h[7], oz = h[8];\n    const float wid_s = h[9], wid_t = h[10];\n    const float iws = h[11], iwt = h[12];\n    const float4* rec = ix.rec + 2 * hi[22];\n    const int n_k = hi[20];\n    // [k1 stage: pair_index]  this lane's pairs\n    float nu_x = 0.0f, nu_y = 0.0f;\n    unsigned long long m0 = 0ull, m1 = 0ull;\n    if (active) {\n        nu_x = (dex * snx + dey * sny + dez * snz) / lam;\n        nu_y = (dex * tnx + dey * tny + dez * tnz) / lam;\n        if (hi[21] && fabsf(px) + fabsf(py) + fabsf(pz) <= h[17]) {\n            const float ex = __fsub_rn(px, ox), ey = __fsub_rn(py, oy),\n                        ez = __fsub_rn(pz, oz);\n            const float qs = __fadd_rn(__fadd_rn(__fmul_rn(ex, snx),\n                                                 __fmul_rn(ey, sny)),\n                                       __fmul_rn(ez, snz));\n            const float qt = __fadd_rn(__fadd_rn(__fmul_rn(ex, tnx),\n                                                 __fmul_rn(ey, tny)),\n                                       __fmul_rn(ez, tnz));\n            const float cs = epx_cell(qs, h[13], h[14]);\n            const float ct = epx_cell(qt, h[15], h[16]);\n            if (cs >= 0.0f && cs < (float)hi[18] && ct >= 0.0f\n                && ct < (float)hi[19]) {\n                const unsigned long long* ms =\n                    ix.masks + hi[23] + ix.W * (int)cs;\n                const unsigned long long* mt =\n                    ix.masks + hi[23] + ix.W * (EPX_CELLS + (int)ct);\n                m0 = ms[0] & mt[0];\n                if (ix.W > 1) m1 = ms[1] & mt[1];\n            }\n        } else {\n            // the full loop: every pair\n            m0 = n_k >= 64 ? ~0ull : (1ull << n_k) - 1ull;\n            m1 = n_k >= 128 ? ~0ull\n                 : n_k > 64 ? (1ull << (n_k - 64)) - 1ull : 0ull;\n        }\n    }\n    const int cnt = __popcll(m0) + __popcll(m1);\n    // the lanes' first items: an exclusive prefix sum\n    int incl = cnt;\n#pragma unroll\n    for (int d = 1; d < 32; d <<= 1) {\n        const int y = __shfl_up_sync(FULL_MASK, incl, d);\n        if (j >= d) incl += y;\n    }\n    const int off = incl - cnt;\n    const int n_items = __shfl_sync(FULL_MASK, incl, 31);\n    float total = 0.0f;\n    // [k1 stage: pairs]\n    for (int base = 0; base < n_items; base += 32) {\n        const int item = base + j;\n        // the item's lane: the last lane whose first item is <= item\n        int lane = 0;\n#pragma unroll\n        for (int step = 16; step > 0; step >>= 1) {\n            const int o = __shfl_sync(FULL_MASK, off, lane + step);\n            if (lane + step < 32 && o <= item) lane += step;\n        }\n        const int rank = item - __shfl_sync(FULL_MASK, off, lane);\n        unsigned long long w0 = __shfl_sync(FULL_MASK, m0, lane);\n        unsigned long long w1 = __shfl_sync(FULL_MASK, m1, lane);\n        const float lpx = __shfl_sync(FULL_MASK, px, lane);\n        const float lpy = __shfl_sync(FULL_MASK, py, lane);\n        const float lpz = __shfl_sync(FULL_MASK, pz, lane);\n        const float lnx = __shfl_sync(FULL_MASK, nu_x, lane);\n        const float lny = __shfl_sync(FULL_MASK, nu_y, lane);\n        float a_t = 0.0f, v_t = 0.0f;\n        if (item < n_items) {\n            // the rank-th set bit of the lane's mask\n            int r = rank, k = 0;\n            const int c0 = __popcll(w0);\n            if (r >= c0) {\n                r -= c0;\n                w0 = w1;\n                k = 64;\n            }\n            for (int q = 0; q < r; ++q) w0 &= w0 - 1ull;\n            k += __ffsll((long long)w0) - 1;\n            // pair_sum_epx's test and term for the item's lane\n            const float4 q4 = rec[2 * k];\n            const float mid_s = q4.x, mid_t = q4.y;\n            float mx = ox + mid_s * snx + mid_t * tnx;\n            float my = oy + mid_s * sny + mid_t * tny;\n            float mz = oz + mid_s * snz + mid_t * tnz;\n            float rlx = lpx - mx, rly = lpy - my, rlz = lpz - mz;\n            float rx_ = (rlx * snx + rly * sny + rlz * snz) * iws;\n            float ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt;\n            if (fabsf(rx_) <= 0.5f && fabsf(ry_) <= 0.5f) {\n                // [k1 stage: pair_terms]\n                const float4 q1 = rec[2 * k + 1];\n                const float val_k = q1.y;\n                if (val_k != 0.0f) {\n                    float txr = tri_f(rx_), tyr = tri_f(ry_);\n                    float w_rect = 4.0f * wid_s * wid_t * txr * tyr\n                                   * sinc_f(TP * lnx * wid_s * txr)\n                                   * sinc_f(TP * lny * wid_t * tyr);\n                    float ph = TP * (lnx * q4.z + lny * q4.w) + q1.x;\n                    a_t = w_rect * fast_cos(ph);\n                    v_t = val_k;\n                }\n            }\n        }\n        // [k1 stage: pairs]  each lane's terms of the round, in item order\n        stage[j] = make_float2(a_t, v_t);\n        __syncwarp();\n        const int i1 = min(off + cnt, base + 32);\n        for (int i = max(off, base); i < i1; ++i) {\n            const float2 e = stage[i - base];\n            if (e.y != 0.0f) total = total + e.x * e.y;\n        }\n        __syncwarp();\n    }\n    return total;\n    // [k1 stage: end]\n}\n\n// ---- the power endpoint kernel: a warp wavefront"),
    ("              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;\n        if (!shade) {\n            if (slot >= 0) {\n                // [k1 stage: ray]  trace_lane's receive ray (draws 0..4)",
     "              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;\n        float rx_lam = 0.0f;   // the analog phased receiver's wavelength\n        if (!shade) {\n            if (slot >= 0) {\n                // [k1 stage: ray]  trace_lane's receive ray (draws 0..4)"),
    ('                    float lam = cvel / fmaxf(cfg.f_rx, F(1e-6));\n                    float w0 = F(4.0 * 3.141592653589793) * sp[30] * sp[31]\n                               * sp[32];\n                    ox = ox + F(1e-4) * nzx;\n                    oy = oy + F(1e-4) * nzy;\n                    oz = oz + F(1e-4) * nzz;\n                    thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz,\n                                            lam);\n                } else if (cfg.omni) {',
     '                    rx_lam = cvel / fmaxf(cfg.f_rx, F(1e-6));\n                    // its weight, times its cross-WDF below\n                    thr = F(4.0 * 3.141592653589793) * sp[30] * sp[31]\n                          * sp[32];\n                    ox = ox + F(1e-4) * nzx;\n                    oy = oy + F(1e-4) * nzy;\n                    oz = oz + F(1e-4) * nzz;\n                } else if (cfg.omni) {'),
    ('                live = true;\n            }\n            next += stride;\n        } else {\n            // [k1 stage: hit]  the path from its slot, the hit point',
     "                live = true;\n            }\n            if (cfg.rx_phased) {\n                // [k1 stage: rx_pairs]  the analog phased receiver's\n                // cross-WDF, the warp's together\n                const float w = pair_sum_warp(\n                    ix, n_tx, slot >= 0, ox, oy, oz, dx, dy, dz, rx_lam,\n                    reinterpret_cast<float2*>(w_vals), j);\n                thr = thr * w;\n                // [k1 stage: ray]\n            }\n            next += stride;\n        } else {\n            // [k1 stage: hit]  the path from its slot, the hit point"),
    ('        const int d0 = base + (3 + 3 * n_tx) * depth;\n        float ud[6];\n',
     "        const int d0 = base + (3 + 3 * n_tx) * depth;\n        float ud[6];\n        float rx_lam = 0.0f;   // the analog phased receiver's wavelength\n"),
    ('                    float lam = cvel / fmaxf(f_rx, F(1e-6));\n                    float w0 = F(4.0 * 3.141592653589793) * sp[30] * sp[31]\n                               * sp[32];\n                    ox = ox + F(1e-4) * nzx;\n                    oy = oy + F(1e-4) * nzy;\n                    oz = oz + F(1e-4) * nzz;\n                    // [k1 stage: rx_pairs]\n                    thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz,\n                                            lam);\n                    // [k1 stage: ray]\n                } else if (cfg.omni) {',
     '                    rx_lam = cvel / fmaxf(f_rx, F(1e-6));\n                    // its weight, times its cross-WDF below\n                    thr = F(4.0 * 3.141592653589793) * sp[30] * sp[31]\n                          * sp[32];\n                    ox = ox + F(1e-4) * nzx;\n                    oy = oy + F(1e-4) * nzy;\n                    oz = oz + F(1e-4) * nzz;\n                } else if (cfg.omni) {'),
    ('                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;\n                live = true;\n            }\n            next += stride;\n        } else {\n            // [k1 stage: hit]  the path from its slot (slot >= 0), the hit',
     "                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;\n                live = true;\n            }\n            if (cfg.rx_phased) {\n                // [k1 stage: rx_pairs]  the analog phased receiver's\n                // cross-WDF, the warp's together\n                const float w = pair_sum_warp(\n                    ix, n_tx, slot >= 0, ox, oy, oz, dx, dy, dz, rx_lam,\n                    reinterpret_cast<float2*>(w_vals), j);\n                thr = thr * w;\n                // [k1 stage: ray]\n            }\n            next += stride;\n        } else {\n            // [k1 stage: hit]  the path from its slot (slot >= 0), the hit"),
)

# the ablations of the kernel that tested every pair, whose source only a
# checkout of it (unpacked with git archive) carries
K4_PARENT = ('k4_rcp', 'k4_lds128', 'k4_warp_any', 'k4_cull')

# K2 / K3, the BVH walks of csrc/bvh_kernels.cu: each lever of the
# node-pair walk taken back or varied (BVH_DOC)
BVH_ABLATIONS = {
    # no refill: a warp takes new rays only when all 32 lanes are done,
    # as the grid-stride walk it replaced (the same results)
    'bvh_lockstep': (('        const bool done = L.cur == 0;',
                      '        const bool done = __all_sync(FULL, '
                      'L.cur == 0);'),),
    # K3 enters the left child first, as K2 (the same flags)
    'bvh_any_left': (('            bool swap = ANY && tr < tl;',
                      '            bool swap = false;'),),
    # the persistent grid at two or four rays a lane (blocks for n / 2 or
    # n / 4 rays), so that lanes refill at 2^17 too
    'bvh_rays2': (('    long long need = (n + THREADS - 1) / THREADS;',
                   '    long long need = (n + 2 * THREADS - 1) '
                   '/ (2 * THREADS);'),),
    'bvh_rays4': (('    long long need = (n + THREADS - 1) / THREADS;',
                   '    long long need = (n + 4 * THREADS - 1) '
                   '/ (4 * THREADS);'),),
    'bvh_chunk32': (('constexpr int CHUNK = 64;', 'constexpr int CHUNK = 32;'),),
    'bvh_chunk128': (('constexpr int CHUNK = 64;',
                      'constexpr int CHUNK = 128;'),),
}
# the node pairs in the block's shared memory where they fit (96 KB: the
# query tree's 80 KB, not the 80,802-face tree's 855 KB), the steps'
# loads then LDS.128 (the same results)
BVH_ABLATIONS['bvh_smem'] = (
    ('constexpr unsigned FULL = 0xffffffffu;',
     'constexpr int SMEM_F4 = 96 * 1024 / 16;   // node-pair float4s\n'
     'constexpr unsigned FULL = 0xffffffffu;'),
    ('        float4 la = __ldg(p), lb = __ldg(p + 1), ra = __ldg(p + 2),\n'
     '               rb = __ldg(p + 3);',
     '        float4 la = p[0], lb = p[1], ra = p[2], rb = p[3];'),
    ('    const int lane = threadIdx.x & 31;\n',
     '    const int lane = threadIdx.x & 31;\n'
     '    extern __shared__ float4 srec[];\n'
     '    const int n4 = 4 * __float_as_int(__ldg(w.rec + 2).w);\n'
     '    const bool in_smem = n4 <= SMEM_F4;\n'
     '    if (in_smem) {\n'
     '        for (int k = threadIdx.x; k < n4; k += blockDim.x)\n'
     '            srec[k] = __ldg(w.rec + k);\n'
     '        __syncthreads();\n'
     '    }\n'),
    ('        while (L.cur > 0) L.step(w.rec, stk);',
     '        if (in_smem) {\n'
     '            while (L.cur > 0) L.step(srec, stk);\n'
     '        } else {\n'
     '            while (L.cur > 0) L.step(w.rec, stk);\n'
     '        }'),
    ('    bvh_closest_kernel<<<blocks, THREADS, 0, s>>>(',
     '    bvh_closest_kernel<<<blocks, THREADS, 16 * SMEM_F4, s>>>('),
    ('    bvh_any_kernel<<<blocks, THREADS, 0, s>>>(',
     '    bvh_any_kernel<<<blocks, THREADS, 16 * SMEM_F4, s>>>('),
    ('        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, '
     'kernel,\n                                                            '
     'THREADS, 0);',
     '        err = cudaFuncSetAttribute(\n'
     '            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n'
     '            16 * SMEM_F4);\n'
     '        if (err != cudaSuccess) return (int)err;\n'
     '        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n'
     '            &per_sm, kernel, THREADS, 16 * SMEM_F4);'))
for _t, _b in ((128, 8), (256, 4)):
    BVH_ABLATIONS[f'bvh_threads{_t}'] = (
        ('constexpr int THREADS = 512;', f'constexpr int THREADS = {_t};'),
        ('constexpr int MIN_BLOCKS = 2;',
         f'constexpr int MIN_BLOCKS = {_b};'))
for _b in (1, 3):
    BVH_ABLATIONS[f'bvh_lb{_b}'] = (('constexpr int MIN_BLOCKS = 2;',
                                     f'constexpr int MIN_BLOCKS = {_b};'),)


def scoped(source: str, name: str) -> tuple:
    """(the text an ablation's edits apply to, the source before it, the
    source after it): the body of its SCOPE function, or all of it."""
    if name not in SCOPE:
        return source, '', ''
    head = SCOPE[name]
    if source.count(head) != 1:
        raise SystemExit(f'{name}: {head!r} not found once')
    a = source.index(head)
    b = source.index('\n}\n', a) + 3
    return source[a:b], source[:a], source[b:]


def outside(head: str, tail: str, name: str) -> tuple:
    """(head, tail) of a scoped ablation's source with its OUTSIDE edits,
    each of whose text lies once in the two together."""
    for old, new in OUTSIDE.get(name, ()):
        if (head + tail).count(old) != 1:
            raise SystemExit(f'{name}: edit not found once: {old[:60]!r}')
        if old in head:
            head = head.replace(old, new)
        else:
            tail = tail.replace(old, new)
    return head, tail


def make(tree: str, name: str) -> str:
    """_archive/NAME: TREE's package with the ablation's edits."""
    dst = os.path.join(HERE, '_archive', name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    src = os.path.join(dst, 'beifong_tpu_torch', 'csrc',
                       'intersect_kernels.cu' if name in K4_ABLATIONS
                       else 'bvh_kernels.cu' if name in BVH_ABLATIONS
                       else 'receive_megakernel.cu')
    with open(src) as f:
        full = f.read()
    s, head, tail = scoped(full, name)
    for edit in {**ABLATIONS, **K4_ABLATIONS, **BVH_ABLATIONS}[name]:
        old, new = edit[0], edit[-1]
        if s.count(old) != 1 or (len(edit) == 3 and s.count(edit[1]) != 1):
            raise SystemExit(f'{name}: edit not found once: {old[:60]!r}')
        if len(edit) == 3:   # a span: from `old` up to edit[1]
            old = s[s.index(old):s.index(edit[1])]
        s = s.replace(old, new)
    head, tail = outside(head, tail, name)
    with open(src, 'w') as f:
        f.write(head + s + tail)
    for rel, old, new in PY_EDITS.get(name, ()):
        path = os.path.join(dst, 'beifong_tpu_torch', rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f'{name}: edit not found once in {rel}')
        with open(path, 'w') as f:
            f.write(text.replace(old, new))
    return dst


def main() -> int:
    names = set(ABLATIONS) | set(K4_ABLATIONS) | set(BVH_ABLATIONS)
    if len(sys.argv) < 3 or not set(sys.argv[2:]) <= names:
        raise SystemExit(f'usage: k1_ablate.py TREE NAME..., NAME among '
                         f'{sorted(names)}')
    tree = os.path.abspath(sys.argv[1])
    for name in sys.argv[2:]:
        print(make(tree, name))
    return 0


if __name__ == '__main__':
    sys.exit(main())
