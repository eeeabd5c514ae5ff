// Standalone BVH queries for Hopper (sm_90a): closest hit and any hit of
// a batch of rays against a packed triangle BVH.
//
// Replaces the TPU kernels beifong_tpu/geometry/pallas_bvh.py::
// _run_closest (K2, the pl.pallas_call at pallas_bvh.py:380, via
// bvh_closest) and _run_any (K3, pallas_bvh.py:426, via bvh_any).  On the
// TPU a whole ray tile follows one node pointer; here every lane walks its
// own ray.
//
// What bounds them on the H100: neither FP32 work (23 operations a slab
// test, 47 a triangle) nor bytes (24 B in, 16 B out a ray; the tables stay
// in L2) nor the issue slots (the kernels run at ~15% of those), but the
// walk's scattered loads.  The grid-stride walk this replaces made nine
// scalar loads from two tables a node, each on a chain through the link
// it had just read (the link chase took 44-67% of its threads' cycles),
// and a warp of 32 fixed rays waited for its slowest lane.
// What this design does about it:
//   * node pairs: the walk reads the tree as records of 64 bytes, one an
//     inner node, holding both children's boxes and references (a leaf as
//     a negative code with its row and triangle count).  A step is four
//     16-byte loads from one record and two independent slab tests, so a
//     ray takes half as many dependent steps as slab tests.  A stack of
//     (child, entry t) in local memory, apart from the lane's registers,
//     holds the deferred children.
//   * triangles as three float4 (v0 and the face index, e1, e2), the pad
//     slots past a leaf's count skipped (they never hit), the next
//     triangle's loads in flight during a test.
//   * persistent warps that refill their lanes (Aila and Laine's while-
//     while loop with dynamic fetch, HPG 2009): a lane whose ray ends
//     takes the next one from its warp's chunk of rays, and the warp
//     tops its chunk up from a global counter, so a warp no longer waits
//     for the slowest of 32 fixed rays.
// Left: the node pairs' and triangles' loads, ~100 scattered 16-byte
// loads a closest-hit ray, about half in each; neither shared memory for
// the pairs, nor warps an SM, nor sorted rays moved them by more than a
// few percent (PERF.md).
// The records and triangles are derived on the device from the packed
// tables (geometry/bvh_kernel.py::walk_tables), once a BVH and device.
//
// The answers are the threaded walk's (bvh_walk.cuh, walk_ref) bit for
// bit under the same rounding: K2 visits the children left first, as the
// threaded walk does, and tests a deferred child's stored entry against
// the best t when it pops it, which is the test that walk makes when it
// reaches it; the slab and triangle tests repeat bvh_walk.cuh's
// operation by operation.  K3's flag does not depend on the order, so it
// visits the nearer child first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bvh_walk.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MIN_BLOCKS = 2;     // blocks an SM: at most 64 registers
constexpr int STACK = 64;         // deferred children (the tree's depth)
constexpr int CHUNK = 64;         // rays a warp takes from the counter
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = (float)3.4e38;

struct Walk {
    const float4* rec;    // (n_rec * 4) node pairs
    const float4* tri;    // (n_leaves * 8 * 3) triangles
    const float* o;
    const float* d;
    const float* maxt;    // K3 only
    long long n;
    unsigned long long* counter;   // rays handed out past the first round
};

// The box (lo.xyz, hi.xyz) is entered before `tbest`: bvh_walk.cuh's
// slab() on registers; its entry t in *tn.
__device__ __forceinline__ bool slab2(float4 lo, float4 hi,
                                      const bvh::Ray& r, float tbest,
                                      float* tn_out) {
    float tx0 = (lo.x - r.ox) * r.ix;
    float tx1 = (hi.x - r.ox) * r.ix;
    float ty0 = (lo.y - r.oy) * r.iy;
    float ty1 = (hi.y - r.oy) * r.iy;
    float tz0 = (lo.z - r.oz) * r.iz;
    float tz1 = (hi.z - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                     fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                     fmaxf(tz0, tz1));
    *tn_out = tn;
    return tf >= fmaxf(tn, 0.0f) && tn < tbest;
}

// bvh_walk.cuh's triangle() on one float4-packed triangle: the hit test
// and t, u, v; the face index is a.w (-1 for a pad).
__device__ __forceinline__ bool tri_test(float4 a, float4 b, float4 c,
                                         const bvh::Ray& r, float* t_out,
                                         float* u_out, float* v_out) {
    float v0x = a.x, v0y = a.y, v0z = a.z;
    float e1x = b.x, e1y = b.y, e1z = b.z;
    float e2x = c.x, e2y = c.y, e2z = c.z;
    float px = r.dy * e2z - r.dz * e2y;
    float py = r.dz * e2x - r.dx * e2z;
    float pz = r.dx * e2y - r.dy * e2x;
    float det = e1x * px + e1y * py + e1z * pz;
    float inv = fabsf(det) > (float)1e-12 ? 1.0f / det : 0.0f;
    float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    float uu = (tvx * px + tvy * py + tvz * pz) * inv;
    float qx = tvy * e1z - tvz * e1y;
    float qy = tvz * e1x - tvx * e1z;
    float qz = tvx * e1y - tvy * e1x;
    float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
    *t_out = tt; *u_out = uu; *v_out = vv;
    return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f
           && tt > (float)1e-4 && a.w >= 0.0f;
}

// One lane's walk: its ray, the best hit so far (K2) or the shadow limit
// and flag (K3), the node it stands at and the depth of its stack, whose
// entries (child, entry t bits) lie in an array of the caller's: inside
// the struct, the array's run-time index would keep the whole struct, ray
// included, in local memory.
template <bool ANY>
struct Lane {
    bvh::Ray r;
    float best;          // K2: the closest t; K3: maxt (1 - 1e-3)
    float u, v;
    int idx;             // K2: face index; K3: 1 once blocked
    int cur;             // > 0 a node pair, < 0 a leaf's code, 0 done
    int sp;

    // the next deferred child still entered before the best t, or 0
    __device__ __forceinline__ void pop(const int2* __restrict__ stk) {
        cur = 0;
        while (sp > 0) {
            int2 e = stk[--sp];
            if (ANY || __int_as_float(e.y) < best) {
                cur = e.x;
                return;
            }
        }
    }

    // one node pair: both children's slab tests; K2 enters the left one
    // first, K3 the nearer one
    __device__ __forceinline__ void step(const float4* __restrict__ rec,
                                         int2* __restrict__ stk) {
        const float4* p = rec + 4 * (long long)cur;
        float4 la = __ldg(p), lb = __ldg(p + 1), ra = __ldg(p + 2),
               rb = __ldg(p + 3);
        float tl, tr;
        bool el = slab2(la, lb, r, best, &tl);
        bool er = slab2(ra, rb, r, best, &tr);
        int cl = __float_as_int(la.w), cr = __float_as_int(ra.w);
        if (el && er) {
            bool swap = ANY && tr < tl;
            stk[sp++] = make_int2(swap ? cl : cr,
                                  __float_as_int(swap ? tl : tr));
            cur = swap ? cr : cl;
        } else if (el) {
            cur = cl;
        } else if (er) {
            cur = cr;
        } else {
            pop(stk);
        }
    }

    // a leaf's triangles in slot order, then the next deferred child; the
    // next triangle's loads go out before this one's test, so that the
    // tests do not each wait a load
    __device__ __forceinline__ void leaf(const float4* __restrict__ tri,
                                         const int2* __restrict__ stk) {
        const int code = ~cur;
        const float4* p = tri + 24 * (long long)(code >> 3);
        const int cnt = (code & 7) + 1;
        float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
#pragma unroll 1
        for (int k = 0; k < cnt; ++k) {
            float4 na = a, nb = b, nc = c;
            if (k + 1 < cnt) {
                p += 3;
                na = __ldg(p);
                nb = __ldg(p + 1);
                nc = __ldg(p + 2);
            }
            float tt, uu, vv;
            if (tri_test(a, b, c, r, &tt, &uu, &vv) && tt < best) {
                if (ANY) {
                    idx = 1;
                    cur = 0;
                    return;
                }
                best = tt;
                u = uu;
                v = vv;
                idx = (int)a.w;
            }
            a = na;
            b = nb;
            c = nc;
        }
        pop(stk);
    }

    // ray i: its set-up and the root's slab test
    __device__ __forceinline__ void start(const Walk& w, long long i) {
        r = bvh::make_ray(w.o[3 * i], w.o[3 * i + 1], w.o[3 * i + 2],
                          w.d[3 * i], w.d[3 * i + 1], w.d[3 * i + 2]);
        best = ANY ? w.maxt[i] * (float)(1.0 - 1e-3) : BIG;
        u = v = 0.0f;
        idx = ANY ? 0 : -1;
        sp = 0;
        float tn;
        float4 lo = __ldg(w.rec), hi = __ldg(w.rec + 1);
        cur = slab2(lo, hi, r, best, &tn) ? __float_as_int(lo.w) : 0;
    }
};

// The persistent while-while walk of K2 (ANY = false) and K3.  Each warp
// starts on 32 consecutive rays; at the top of each round the lanes whose
// walk ended write their result and take new rays from the warp's chunk
// (CHUNK rays from the counter at a time), then every lane walks node
// pairs until it reaches a leaf or ends, then tests its leaf.
template <bool ANY>
__device__ __forceinline__ void walk_rays(const Walk& w, float* t_out,
                                          int* idx_out, float* u_out,
                                          float* v_out, uint8_t* occ_out) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    // the warp's chunk of rays, [next, end): the first round's 32 are
    // fixed, the rest come CHUNK at a time from the counter (past `first`)
    const long long first = warps * 32;
    long long next = warp * 32 < w.n ? warp * 32 : w.n;
    long long end = next + 32 < w.n ? next + 32 : w.n;
    bool more = true;    // the counter may still hold rays
    Lane<ANY> L;
    int2 stk[STACK];
    L.cur = 0;
    long long i = -1;
    while (true) {
        const bool done = L.cur == 0;
        if (done && i >= 0) {
            if (ANY) {
                occ_out[i] = (uint8_t)L.idx;
            } else {
                const bool miss = L.best >= BIG;
                t_out[i] = miss ? INFINITY : L.best;
                idx_out[i] = miss ? -1 : L.idx;
                u_out[i] = L.u;
                v_out[i] = L.v;
            }
        }
        const unsigned want = __ballot_sync(FULL, done);
        const long long need = __popc(want);
        const long long avail = end > next ? end - next : 0;
        long long base = w.n;
        if (need > avail && more) {
            if (lane == 0)
                base = first + (long long)atomicAdd(
                    w.counter, (unsigned long long)CHUNK);
            base = __shfl_sync(FULL, base, 0);
            more = base < w.n;
        }
        if (done) {
            const long long k = __popc(want & below);
            const long long j = k < avail ? next + k : base + (k - avail);
            i = j < w.n ? j : -1;
            if (i >= 0) L.start(w, i);
        }
        if (need <= avail) {
            next += need;
        } else if (base < w.n) {
            next = base + (need - avail);
            end = base + CHUNK < w.n ? base + CHUNK : w.n;
        } else {
            next = end;
        }
        if (!__any_sync(FULL, i >= 0)) break;
        while (L.cur > 0) L.step(w.rec, stk);
        if (L.cur < 0) L.leaf(w.tri, stk);
    }
}

// t = inf and idx = -1 on a miss (u, v stay 0), as pallas_bvh.bvh_closest
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bvh_closest_kernel(Walk w, float* __restrict__ t_out,
                   int* __restrict__ idx_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
    walk_rays<false>(w, t_out, idx_out, u_out, v_out, nullptr);
}

// occluded where a triangle blocks before maxt * (1 - 1e-3)
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bvh_any_kernel(Walk w, uint8_t* __restrict__ occ_out) {
    walk_rays<true>(w, nullptr, nullptr, nullptr, nullptr, occ_out);
}

// Blocks of the persistent grid: as many as fit on the card, computed
// once a device and kernel (an occupancy query costs microseconds a call).
constexpr int MAX_DEVICES = 64;
int g_blocks[2][MAX_DEVICES];

template <class K>
int grid_for(K kernel, int which, long long n, int* blocks) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
    int full = g_blocks[which][dev];
    if (full == 0) {
        int per_sm = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        full = (per_sm > 0 ? per_sm : 1) * sms;
        g_blocks[which][dev] = full;
    }
    long long need = (n + THREADS - 1) / THREADS;
    *blocks = (int)(need < full ? need : full);
    return (int)cudaSuccess;
}

Walk walk_of(const float* rec, const float* tri, const float* o,
             const float* d, const float* maxt, long long n, void* counter) {
    return Walk{reinterpret_cast<const float4*>(rec),
                reinterpret_cast<const float4*>(tri), o, d, maxt, n,
                static_cast<unsigned long long*>(counter)};
}

}  // namespace

extern "C" {

// rec, tri: geometry/bvh_kernel.py::walk_tables; counter: 8 bytes of
// scratch the launch zeroes
int bvh_closest_launch(const float* rec, const float* tri, const float* o,
                       const float* d, long long n, float* t, int* idx,
                       float* u, float* v, void* counter, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks = 0;
    int err = grid_for(bvh_closest_kernel, 0, n, &blocks);
    if (err != 0) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = (int)cudaMemsetAsync(counter, 0, 8, s);
    if (err != 0) return err;
    bvh_closest_kernel<<<blocks, THREADS, 0, s>>>(
        walk_of(rec, tri, o, d, nullptr, n, counter), t, idx, u, v);
    return (int)cudaGetLastError();
}

int bvh_any_launch(const float* rec, const float* tri, const float* o,
                   const float* d, const float* maxt, long long n,
                   uint8_t* occ, void* counter, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks = 0;
    int err = grid_for(bvh_any_kernel, 1, n, &blocks);
    if (err != 0) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = (int)cudaMemsetAsync(counter, 0, 8, s);
    if (err != 0) return err;
    bvh_any_kernel<<<blocks, THREADS, 0, s>>>(
        walk_of(rec, tri, o, d, maxt, n, counter), occ);
    return (int)cudaGetLastError();
}

const char* bvh_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
