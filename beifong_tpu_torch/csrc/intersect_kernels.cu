// Brute-force ray / triangle intersection for Hopper (sm_90a): the closest
// hit, and the any-hit shadow test, of a batch of rays against every
// triangle of a soup.
//
// Replaces the TPU kernel beifong_tpu/geometry/pallas_intersect.py:30-133
// (_kernel, launched by ray_triangle_closest; ray_triangle_any compares its
// t with maxt).  The TPU kernel streams (256 rays x 512 triangles) tiles
// through VMEM and min-reduces over the lane axis with the grid's triangle
// dimension running in order.  Here one thread owns one ray and keeps its
// running (t, index, u, v) minimum in registers, and the block stages up
// to TILE triangles at a time in shared memory.
//
// The answers are the plain PyTorch version's bit for bit.  The hit test
// is the TPU kernel's Moller-Trumbore: |det| > 1e-12, IEEE 1/det, u >= 0,
// v >= 0, u + v <= 1, t > 1e-4, with every product, sum and the reciprocal
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __frcp_rn, in the
// plain version's order): a contracted multiply-add can move a hit that
// lies on a triangle edge to the neighbouring face.  A lane tests its
// triangles in ascending order and a hit replaces its minimum only when
// its t is strictly smaller, so the lowest index wins a tie, as jnp.argmin
// inside a TPU tile and the `better` rule across tiles do.  On a miss:
// t = +inf, index -1, u = v = 0.  The shadow flag is "some hit has
// t < maxt (1 - 1e-3)", which equals closest-then-compare.
//
// What bounds it on the H100.  The exact test is 47 rounded FP32
// operations a (ray, triangle) pair (the two cross products 18, the u, v
// and t dot products with their 1/det scale 18, det 5 and its abs 1, the
// reciprocal 1, o - v0 3, u + v 1), ~75 issue slots with the IEEE
// reciprocal's refinement, the record's loads and the compares; rounded
// on its own, none of them can fuse into an FMA.  Yet almost every pair
// misses: on the wavefront's shape ~0.7% of the pairs pass near the
// triangle, at 10,082 faces ~0.02%.  So the design culls:
//
// - Staging: each triangle of a tile becomes a cull record (a centre C, a
//   radius, the unit normal's direction scaled by 1 / (|e1| |e2|)) and an
//   exact record (v0, e1, e2) in two float4s and a float, read with
//   LDS.128; the block computes them as it stages the tile.
// - The cull, 18 FP32 operations a pair (14 of them FMAs or products):
//   a lane rejects a triangle only where the rounded test above cannot
//   accept it (below).  It gathers its kept triangles among GROUP as a
//   bit mask, then runs the exact test on its own kept ones in ascending
//   order: the warp runs as many exact tests as its busiest lane keeps,
//   not one for each triangle that some lane keeps.
// - The shadow test: a lane stops testing at its first blocker, a warp
//   leaves its triangle loop once every lane is blocked (__all_sync after
//   each group), and a block stops staging once every ray is blocked.
//
// Why the cull is exact.  Write T = o - v0, M = [-d, e1, e2], det =
// det M, and x = (t, u, v) the rounded test's answer.  If it accepts,
// X = o + t d lies within |r| of Y = v0 + u e1 + v e2, which is inside
// the triangle (r = T - M x is the residual), so the half-line {o + s d,
// s > 0} passes within R + |r| of any centre C whose ball of radius R
// holds the triangle.  Bounding each rounded operation by eps = 2^-24
// (M adj(M) = det I gives r = (ddet T - M dN - sum_i M_i x_i eta_i) / det_c
// for the errors ddet of det, dN of the numerators and eta_i of the
// scalings):
//     |r| <= eps (6.1 + 40 / g) L,   L = |T| <= |C - o| + R,
//     g = |det_c| / (|d| |e1| |e2|)  (1 for a ray along the normal of a
//                                      right triangle, 0 grazing it).
// The constant 40 covers 29 = 6.5 (det) + 22.5 (the numerators through
// M).  A small g (a grazing ray; a ray in the triangle's plane gets
// rounding noise for u, v and t) makes the margin large, so the cull
// keeps the pair unless both
//   A: rho^2 > lambda^2 R^2 + kappa |w|^2, and
//   B: g^2 (rho^2 - kappa |w|^2) > K (|w|^2 + R^2)
// hold, where w = C - o, rho the half-line's distance to C (|w| where C
// is behind the origin), lambda = 1.02 (A gives rho >= lambda R, and B
// then gives rho (1 - 1 / lambda) > eps (6.1 + 40 / g) L, so rho > R +
// |r|), kappa = 2e-6 = 33.6 eps the cull's own rounding of rho^2 (~19.2
// eps |w|^2: w, its direction and the two dot products), and K = 4e-8 >=
// 2 x 46.11^2 eps^2 / (1 - 1 / lambda)^2.  g is taken from the cull
// record's scaled normal and the unit direction, less 64 eps (|gn - g|
// <= ~21 eps for |gn| <= 1).  R^2 carries a relative 1e-4 for the
// rounding of C and of the vertices' offsets from it.  A NaN anywhere
// (a degenerate triangle or direction) makes A or B false: the pair is
// kept.  The bounds assume finite inputs whose squared distances neither
// overflow nor underflow (|coordinates| between ~1e-18 and ~1e18).  The
// cull's operations are written as explicit fmaf so that the card and
// the g++ emulation (tools/emu) keep the same pairs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // rays a block, one a thread
constexpr int TILE = 512;      // triangles a block stages at a time
constexpr int GROUP = 32;      // triangles whose cull bits a lane gathers
constexpr unsigned FULL = 0xffffffffu;

// the cull's constants (see the header)
constexpr float EPS = 5.9604645e-8f;      // 2^-24
constexpr float KAPPA = 2e-6f;
constexpr float LAMBDA2 = 1.0405f;        // 1.02^2 (1 + 1e-4)
constexpr float K_GRAZE = 4e-8f;
constexpr float R2_SLACK = 1.0001f;
constexpr float G2_SLACK = 64.0f * EPS;

struct Hit {
    float t, u, v;
    int idx;
};

// shared-memory layout of a tile of `cap` triangles (cap a multiple of
// GROUP): cull records (centre, lambda^2 R^2) and (scaled normal, K R^2),
// then the exact records (v0, e1.x), (e1.yz, e2.xy) and e2.z
struct Tile {
    float4 *c, *n, *a, *b;
    float* z;
    __device__ Tile(float4* smem, int cap)
        : c(smem), n(smem + cap), a(smem + 2 * cap), b(smem + 3 * cap),
          z(reinterpret_cast<float*>(smem + 4 * cap)) {}
};

__host__ __device__ int tile_cap(int n_tris) {
    const int cap = n_tris < TILE ? n_tris : TILE;
    return (cap + GROUP - 1) / GROUP * GROUP;
}

size_t tile_bytes(int n_tris) {
    return (size_t)tile_cap(n_tris) * (4 * sizeof(float4) + sizeof(float));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
    return fmaf(az, bz, fmaf(ay, by, ax * bx));
}

// Triangles [base, base + cnt) into the tile, one thread a triangle.
__device__ void stage(const Tile& s, const float* __restrict__ v0,
                      const float* __restrict__ e1,
                      const float* __restrict__ e2, int base, int cnt) {
    for (int k = threadIdx.x; k < cnt; k += THREADS) {
        const long long f = 3LL * (base + k);
        const float ax = v0[f], ay = v0[f + 1], az = v0[f + 2];
        const float bx = e1[f], by = e1[f + 1], bz = e1[f + 2];
        const float cx = e2[f], cy = e2[f + 1], cz = e2[f + 2];
        s.a[k] = make_float4(ax, ay, az, bx);
        s.b[k] = make_float4(by, bz, cx, cy);
        s.z[k] = cz;
        // the centroid as rounded, and the largest squared distance from it
        // to the three vertices
        const float third = 1.0f / 3.0f;
        const float mx = fmaf(bx + cx, third, ax);
        const float my = fmaf(by + cy, third, ay);
        const float mz = fmaf(bz + cz, third, az);
        const float px = ax - mx, py = ay - my, pz = az - mz;
        const float r0 = dot3(px, py, pz, px, py, pz);
        const float qx = px + bx, qy = py + by, qz = pz + bz;
        const float r1 = dot3(qx, qy, qz, qx, qy, qz);
        const float wx = px + cx, wy = py + cy, wz = pz + cz;
        const float r2 = fmaxf(fmaxf(r0, r1), dot3(wx, wy, wz, wx, wy, wz))
                         * R2_SLACK;
        const float l = sqrtf(dot3(bx, by, bz, bx, by, bz))
                        * sqrtf(dot3(cx, cy, cz, cx, cy, cz));
        const float nx = fmaf(by, cz, -(bz * cy)) / l;
        const float ny = fmaf(bz, cx, -(bx * cz)) / l;
        const float nz = fmaf(bx, cy, -(by * cx)) / l;
        s.c[k] = make_float4(mx, my, mz, LAMBDA2 * r2);
        s.n[k] = make_float4(nx, ny, nz, K_GRAZE * r2);
    }
}

struct Ray {
    float ox, oy, oz, dx, dy, dz;   // as given
    float hx, hy, hz;               // the unit direction, for the cull
};

// True where the rounded test provably rejects the pair (the header).
// Both conditions are computed and ANDed as bits: a short-circuit `&&`
// becomes a branch a triangle.
__device__ __forceinline__ bool cull_rejects(const Ray& r, float4 c,
                                             float4 n) {
    const float wx = c.x - r.ox, wy = c.y - r.oy, wz = c.z - r.oz;
    const float b = dot3(wx, wy, wz, r.hx, r.hy, r.hz);
    const float ww = dot3(wx, wy, wz, wx, wy, wz);
    const float bp = fmaxf(b, 0.0f);
    const float rho2 = fmaf(-bp, bp, ww);
    const float gn = dot3(n.x, n.y, n.z, r.hx, r.hy, r.hz);
    const float g2 = fmaf(gn, gn, -G2_SLACK);
    const float lo = fmaf(-KAPPA, ww, rho2);     // rho^2 - kappa |w|^2
    const float rhs = fmaf(K_GRAZE, ww, n.w);
    const bool far = lo > c.w;                   // A
    const bool steep = fmaf(g2, lo, -rhs) > 0.0f;   // B
    return far & steep;
}

// Moller-Trumbore of one ray against triangle k of the tile, rounding
// every operation as the plain version does; updates `best`.
__device__ __forceinline__ void test_triangle(const Tile& s, int k,
                                              int index, const Ray& r,
                                              Hit& best) {
    const float4 a = s.a[k], b = s.b[k];
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = s.z[k];
    const float dx = r.dx, dy = r.dy, dz = r.dz;
    const float px = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
    const float py = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
    const float pz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, px),
                                          __fmul_rn(e1y, py)),
                                __fmul_rn(e1z, pz));
    const bool big = fabsf(det) > 1e-12f;
    const float inv = big ? __frcp_rn(det) : 0.0f;
    const float tx = __fsub_rn(r.ox, v0x);
    const float ty = __fsub_rn(r.oy, v0y);
    const float tz = __fsub_rn(r.oz, v0z);
    const float u = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(tx, px),
                                                  __fmul_rn(ty, py)),
                                        __fmul_rn(tz, pz)), inv);
    const float qx = __fsub_rn(__fmul_rn(ty, e1z), __fmul_rn(tz, e1y));
    const float qy = __fsub_rn(__fmul_rn(tz, e1x), __fmul_rn(tx, e1z));
    const float qz = __fsub_rn(__fmul_rn(tx, e1y), __fmul_rn(ty, e1x));
    const float v = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, qx),
                                                  __fmul_rn(dy, qy)),
                                        __fmul_rn(dz, qz)), inv);
    const float t = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(e2x, qx),
                                                  __fmul_rn(e2y, qy)),
                                        __fmul_rn(e2z, qz)), inv);
    const bool hit = big && u >= 0.0f && v >= 0.0f &&
                     __fadd_rn(u, v) <= 1.0f && t > 1e-4f;
    if (hit && t < best.t) {
        best.t = t;
        best.u = u;
        best.v = v;
        best.idx = index;
    }
}

// One thread per ray.  ANY: stop once the ray has a hit before its limit.
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
    Hit best{INFINITY, 0.0f, 0.0f, -1};
    bool done = !live;
    for (int base = 0; base < n_tris; base += TILE) {
        const int cnt = min(TILE, n_tris - base);
        if (base > 0) __syncthreads();   // every warp is done with the tile
        stage(s, v0, e1, e2, base, cnt);
        __syncthreads();
        for (int k0 = 0; k0 < cnt && !__all_sync(FULL, done);
             k0 += GROUP) {
            unsigned keep = 0;
#pragma unroll
            for (int j = 0; j < GROUP; ++j)
                if (!cull_rejects(r, s.c[k0 + j], s.n[k0 + j]))
                    keep |= 1u << j;
            if (cnt - k0 < GROUP) keep &= (1u << (cnt - k0)) - 1u;
            if (done) keep = 0;
            while (keep) {
                const int j = __ffs(keep) - 1;
                keep &= keep - 1;
                test_triangle(s, k0 + j, base + k0 + j, r, best);
                if (ANY && best.t < limit) break;
            }
            if (ANY) done = done || best.t < limit;
        }
        if (ANY && __syncthreads_and(done)) break;
    }
    if (!live) return;
    if (ANY) {
        occ_out[i] = best.t < limit ? 1 : 0;
    } else {
        t_out[i] = best.t;
        idx_out[i] = best.idx;
        u_out[i] = best.u;
        v_out[i] = best.v;
    }
}

int blocks_for(int n_rays) { return (n_rays + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

int ik_closest_launch(const float* o, const float* d, const float* v0,
                      const float* e1, const float* e2, int n_rays,
                      int n_tris, float* t, int* idx, float* u, float* v,
                      void* stream) {
    if (n_rays <= 0) return (int)cudaSuccess;
    ray_triangle_kernel<false><<<blocks_for(n_rays), THREADS,
                                 tile_bytes(n_tris),
                                 static_cast<cudaStream_t>(stream)>>>(
        o, d, v0, e1, e2, n_rays, n_tris, nullptr, t, idx, u, v, nullptr);
    return (int)cudaGetLastError();
}

int ik_any_launch(const float* o, const float* d, const float* v0,
                  const float* e1, const float* e2, const float* maxt,
                  int n_rays, int n_tris, uint8_t* occ, void* stream) {
    if (n_rays <= 0) return (int)cudaSuccess;
    ray_triangle_kernel<true><<<blocks_for(n_rays), THREADS,
                                tile_bytes(n_tris),
                                static_cast<cudaStream_t>(stream)>>>(
        o, d, v0, e1, e2, n_rays, n_tris, maxt, nullptr, nullptr, nullptr,
        nullptr, occ);
    return (int)cudaGetLastError();
}

// Dynamic shared memory a launch over n_tris triangles asks for.
int ik_shared_bytes(int n_tris) { return (int)tile_bytes(n_tris); }

const char* ik_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
