#!/usr/bin/env python3
"""Ablation trees of the receive megakernel (K1) for paired timing: a copy
of a checkout's `beifong_tpu_torch` under `_archive/NAME/` (ignored by
git) with one named edit of
`csrc/receive_megakernel.cu`, to time against the unedited tree with
`tools/tree_ab.py --other TREE --this _archive/NAME --only ...`.

Run from the repository root:

    python3 tools/k1_ablate.py TREE NAME [NAME ...]

Each NAME is one of ABLATIONS or K4_ABLATIONS; each edit is exact text
that must appear once in TREE's source.  The edits of the grid-stride
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
        if (v == 0.0f || (const void*)s == (const void*)g) return;
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
# the ablations of the kernel that tested every pair, whose source only a
# checkout of it (unpacked with git archive) carries
K4_PARENT = ('k4_rcp', 'k4_lds128', 'k4_warp_any', 'k4_cull')


def make(tree: str, name: str) -> str:
    """_archive/NAME: TREE's package with the ablation's edits."""
    dst = os.path.join(HERE, '_archive', name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    src = os.path.join(dst, 'beifong_tpu_torch', 'csrc',
                       'intersect_kernels.cu' if name in K4_ABLATIONS
                       else 'receive_megakernel.cu')
    with open(src) as f:
        s = f.read()
    for edit in {**ABLATIONS, **K4_ABLATIONS}[name]:
        old, new = edit[0], edit[-1]
        if s.count(old) != 1 or (len(edit) == 3 and s.count(edit[1]) != 1):
            raise SystemExit(f'{name}: edit not found once: {old[:60]!r}')
        if len(edit) == 3:   # a span: from `old` up to edit[1]
            old = s[s.index(old):s.index(edit[1])]
        s = s.replace(old, new)
    with open(src, 'w') as f:
        f.write(s)
    return dst


def main() -> int:
    names = set(ABLATIONS) | set(K4_ABLATIONS)
    if len(sys.argv) < 3 or not set(sys.argv[2:]) <= names:
        raise SystemExit(f'usage: k1_ablate.py TREE NAME..., NAME among '
                         f'{sorted(names)}')
    tree = os.path.abspath(sys.argv[1])
    for name in sys.argv[2:]:
        print(make(tree, name))
    return 0


if __name__ == '__main__':
    sys.exit(main())
