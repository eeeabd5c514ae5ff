// Standalone BVH queries for Hopper (sm_90a): closest hit and any hit of
// a batch of rays against a packed triangle BVH.
//
// Replaces the TPU kernels beifong_tpu/geometry/pallas_bvh.py::
// _run_closest (K2, via bvh_closest) and _run_any (K3, via bvh_any), both
// pl.pallas_call launches of _traversal_kernel.  One thread walks one ray
// with bvh_walk.cuh in a grid-stride loop over the batch; the rays' six
// coordinates come in as (R, 3) origin and direction arrays, read once.
//
// What bounds them on the H100: FP32 work per ray (23 operations per node
// slab test, 47 per triangle of each entered leaf), not bytes: a ray reads
// 24 B (28 with maxt) and writes 16 B (1), and the tables stay in L2.
// The design keeps no per-ray state in memory: one thread per ray, the
// walk's state in registers, the tables behind the read-only cache.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

__device__ __forceinline__ bvh::Ray load_ray(const float* __restrict__ o,
                                             const float* __restrict__ d,
                                             long long i) {
    return bvh::make_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                         d[3 * i + 1], d[3 * i + 2]);
}

// t = inf and idx = -1 on a miss (u, v stay 0), as pallas_bvh.bvh_closest
__global__ void bvh_closest_kernel(bvh::Tables tab,
                                   const float* __restrict__ o,
                                   const float* __restrict__ d, long long n,
                                   float* __restrict__ t_out,
                                   int* __restrict__ idx_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        bvh::Ray r = load_ray(o, d, i);
        bvh::Closest c;
        bvh::walk(tab, r, c);
        bool miss = c.t >= (float)3.4e38;
        t_out[i] = miss ? INFINITY : c.t;
        idx_out[i] = miss ? -1 : c.idx;
        u_out[i] = c.u;
        v_out[i] = c.v;
    }
}

// occluded where a triangle blocks before maxt * (1 - 1e-3)
__global__ void bvh_any_kernel(bvh::Tables tab, const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ maxt, long long n,
                               uint8_t* __restrict__ occ_out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        bvh::Ray r = load_ray(o, d, i);
        bvh::Any a;
        a.limit = maxt[i] * (float)(1.0 - 1e-3);
        bvh::walk(tab, r, a);
        occ_out[i] = a.occ ? 1 : 0;
    }
}

constexpr int THREADS = 256;

template <class K>
int grid_for(K kernel, long long n, int* blocks) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    long long need = (n + THREADS - 1) / THREADS;
    long long nb = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    *blocks = (int)(need < nb ? (need > 0 ? need : 1) : nb);
    return (int)cudaSuccess;
}

}  // namespace

extern "C" {

int bvh_closest_launch(const float* bbox, const int* links,
                       const float* leaves, int stride, const float* o,
                       const float* d, long long n, float* t, int* idx,
                       float* u, float* v, void* stream) {
    int blocks = 0;
    int err = grid_for(bvh_closest_kernel, n, &blocks);
    if (err != 0) return err;
    bvh::Tables tab{bbox, links, leaves, stride};
    bvh_closest_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        tab, o, d, n, t, idx, u, v);
    return (int)cudaGetLastError();
}

int bvh_any_launch(const float* bbox, const int* links, const float* leaves,
                   int stride, const float* o, const float* d,
                   const float* maxt, long long n, uint8_t* occ,
                   void* stream) {
    int blocks = 0;
    int err = grid_for(bvh_any_kernel, n, &blocks);
    if (err != 0) return err;
    bvh::Tables tab{bbox, links, leaves, stride};
    bvh_any_kernel<<<blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        tab, o, d, maxt, n, occ);
    return (int)cudaGetLastError();
}

const char* bvh_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
