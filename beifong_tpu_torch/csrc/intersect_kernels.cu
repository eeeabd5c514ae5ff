// Brute-force ray / triangle intersection for Hopper (sm_90a): the closest
// hit, and the any-hit shadow test, of a batch of rays against every
// triangle of a soup.
//
// Replaces the TPU kernel beifong_tpu/geometry/pallas_intersect.py:30-133
// (_kernel, launched by ray_triangle_closest; ray_triangle_any compares its
// t with maxt).  The TPU kernel streams (256 rays x 512 triangles) tiles
// through VMEM and min-reduces over the lane axis with the grid's triangle
// dimension running in order.  Here one thread owns one ray and keeps its
// running (t, index, u, v) minimum in registers; the block stages 512
// triangles at a time in shared memory as nine SoA float arrays (18 KB),
// which every thread then reads at the same address (a broadcast).  The
// triangles run in ascending order and a hit replaces the minimum only when
// its t is strictly smaller, so the lowest index wins a tie, as
// jnp.argmin inside a TPU tile and the `better` rule across tiles do.  The
// ragged last tile is masked by its count: nothing is padded.
//
// The hit test is the TPU kernel's Moller-Trumbore: |det| > 1e-12, IEEE
// 1/det, u >= 0, v >= 0, u + v <= 1, t > 1e-4.  Every product, sum and the
// reciprocal is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __frcp_rn, in the plain version's order), so the kernel gives the plain
// PyTorch version's answers bit for bit: a contracted multiply-add can move
// a hit that lies on a triangle edge to the neighbouring face.  On a miss:
// t = +inf, index -1, u = v = 0.  The any-hit kernel stops its triangle
// loop once every ray of the block is blocked (a block vote after each
// tile); its flags equal closest-then-compare, t < maxt (1 - 1e-3).
//
// What bounds it on the H100: FP32 operations, 47 per (ray, triangle) pair
// counted from _kernel (the two cross products 18, the u, v and t dot
// products with their 1/det scale 18, det 5 and its abs 1, the reciprocal
// 1, o - v0 3, u + v 1), at
// 67 TFLOP/s; the bytes (24 per ray in, 16 out; 36 per triangle) are
// negligible beside them.  This first version is simple and exact; making
// it fast (several rays per thread, fewer rounded operations) is a later
// PR's work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 512;

struct Hit {
    float t, u, v;
    int idx;
};

// Moller-Trumbore of one ray against triangle k of the shared tile,
// rounding every operation as the plain version does; updates `best`.
__device__ __forceinline__ void test_triangle(
    const float (*s)[TILE], int k, int index, float ox, float oy, float oz,
    float dx, float dy, float dz, Hit& best) {
    const float v0x = s[0][k], v0y = s[1][k], v0z = s[2][k];
    const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];
    const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];
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

// One thread per ray.  ANY: stop once every ray of the block has a hit
// before its limit.
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
    __shared__ float s[9][TILE];
    const int r = blockIdx.x * THREADS + threadIdx.x;
    const bool live = r < n_rays;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float limit = 0.f;
    if (live) {
        ox = o[3 * r];
        oy = o[3 * r + 1];
        oz = o[3 * r + 2];
        dx = d[3 * r];
        dy = d[3 * r + 1];
        dz = d[3 * r + 2];
        if (ANY) limit = __fmul_rn(maxt[r], (float)(1.0 - 1e-3));
    }
    Hit best{INFINITY, 0.0f, 0.0f, -1};
    bool done = !live;
    for (int base = 0; base < n_tris; base += TILE) {
        const int cnt = min(TILE, n_tris - base);
        __syncthreads();
        for (int k = threadIdx.x; k < cnt; k += THREADS) {
            const long long f = 3LL * (base + k);
            s[0][k] = v0[f];
            s[1][k] = v0[f + 1];
            s[2][k] = v0[f + 2];
            s[3][k] = e1[f];
            s[4][k] = e1[f + 1];
            s[5][k] = e1[f + 2];
            s[6][k] = e2[f];
            s[7][k] = e2[f + 1];
            s[8][k] = e2[f + 2];
        }
        __syncthreads();
        if (!done) {
            for (int k = 0; k < cnt; ++k)
                test_triangle(s, k, base + k, ox, oy, oz, dx, dy, dz, best);
        }
        if (ANY) {
            done = done || best.t < limit;
            if (__syncthreads_and(done)) break;
        }
    }
    if (!live) return;
    if (ANY) {
        occ_out[r] = best.t < limit ? 1 : 0;
    } else {
        t_out[r] = best.t;
        idx_out[r] = best.idx;
        u_out[r] = best.u;
        v_out[r] = best.v;
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
    ray_triangle_kernel<false><<<blocks_for(n_rays), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        o, d, v0, e1, e2, n_rays, n_tris, nullptr, t, idx, u, v, nullptr);
    return (int)cudaGetLastError();
}

int ik_any_launch(const float* o, const float* d, const float* v0,
                  const float* e1, const float* e2, const float* maxt,
                  int n_rays, int n_tris, uint8_t* occ, void* stream) {
    if (n_rays <= 0) return (int)cudaSuccess;
    ray_triangle_kernel<true><<<blocks_for(n_rays), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        o, d, v0, e1, e2, n_rays, n_tris, maxt, nullptr, nullptr, nullptr,
        nullptr, occ);
    return (int)cudaGetLastError();
}

const char* ik_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
