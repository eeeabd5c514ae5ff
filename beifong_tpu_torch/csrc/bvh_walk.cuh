// Stackless walk of a threaded BVH with 8-triangle leaves, one ray per
// thread, for Hopper (sm_90a).
//
// The walk of beifong_tpu/geometry/pallas_bvh.py::traversal_body, which
// the TPU kernels K2 (bvh_closest), K3 (bvh_any) and K1's mesh
// configuration (pallas_receive.py, closest hit and shadow test) share.
// On the TPU a whole (8, 128) ray tile follows ONE node pointer and takes
// the union of its lanes' node sets (with a DFS window to amortise the
// any-lane reduction); here every thread follows its own ray down the
// hit / miss links, so a ray visits only the nodes its own slab tests
// enter.  The two find the same hits: a lane of the TPU tile that tests
// a leaf its own box test rejected cannot hit a triangle in it, except at
// a box-rounding edge.
//
// Tables (geometry/bvh_kernel.py::pack), read-only in device memory
// through the read-only cache: bbox (N*6) f32 [min xyz, max xyz], links
// (N*3) i32 [hit_link, miss_link, leaf_id or -1], leaves (L*stride) f32
// with the 8 triangles of a leaf as columns: v0 x/y/z at 0/8/16, e1 at
// 24/32/40, e2 at 48/56/64, the original face index at 72 (-1 for a pad),
// optional payloads at 80 and 88.  The mesh scene's 10,082 triangles
// pack into 575 KB: they stay in the 50 MB L2 but not in a block's
// shared memory.
//
// What bounds a walk: FP32 work (23 operations per slab test, 47 per
// triangle) and the latency of the dependent node loads; divergence
// between the rays of a warp costs the rest.  The arithmetic repeats the
// plain version (bvh_kernel.py::walk_ref) operation by operation; only
// FMA contraction differs.

#pragma once

#include <cuda_runtime.h>

namespace bvh {

constexpr int K_LEAF = 8;

struct Tables {
    const float* bbox;
    const int* links;
    const float* leaves;
    int stride;
};

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// 1 / v with |v| kept above 1e-12 (the sign of v, +0 counting as +)
__device__ __forceinline__ float safe_inv(float v) {
    float tiny = v >= 0.0f ? (float)1e-12 : -(float)1e-12;
    return 1.0f / (fabsf(v) > (float)1e-12 ? v : tiny);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
    Ray r;
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.ix = safe_inv(dx);
    r.iy = safe_inv(dy);
    r.iz = safe_inv(dz);
    return r;
}

// The box of node `bb` is entered before `tbest`.
__device__ __forceinline__ bool slab(const float* __restrict__ bb,
                                     const Ray& r, float tbest) {
    float tx0 = (__ldg(bb + 0) - r.ox) * r.ix;
    float tx1 = (__ldg(bb + 3) - r.ox) * r.ix;
    float ty0 = (__ldg(bb + 1) - r.oy) * r.iy;
    float ty1 = (__ldg(bb + 4) - r.oy) * r.iy;
    float tz0 = (__ldg(bb + 2) - r.oz) * r.iz;
    float tz1 = (__ldg(bb + 5) - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                     fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                     fmaxf(tz0, tz1));
    return tf >= fmaxf(tn, 0.0f) && tn < tbest;
}

// One triangle of a leaf row, Möller-Trumbore.  Returns the hit test
// (u >= 0, v >= 0, u + v <= 1, t > 1e-4, not a pad slot) and t, u, v.
struct TriHit {
    float t, u, v, e1x, e1y, e1z, e2x, e2y, e2z;
    int slot;
};

__device__ __forceinline__ bool triangle(const float* __restrict__ lr,
                                         int k, const Ray& r, TriHit* h) {
    float v0x = __ldg(lr + 0 + k), v0y = __ldg(lr + 8 + k),
          v0z = __ldg(lr + 16 + k);
    float e1x = __ldg(lr + 24 + k), e1y = __ldg(lr + 32 + k),
          e1z = __ldg(lr + 40 + k);
    float e2x = __ldg(lr + 48 + k), e2y = __ldg(lr + 56 + k),
          e2z = __ldg(lr + 64 + k);
    float tri = __ldg(lr + 72 + k);
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
    h->t = tt; h->u = uu; h->v = vv;
    h->e1x = e1x; h->e1y = e1y; h->e1z = e1z;
    h->e2x = e2x; h->e2y = e2y; h->e2z = e2z;
    h->slot = k;
    return uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f
           && tt > (float)1e-4 && tri >= 0.0f;
}

// Walk the tree for one ray.  The visitor V gives the prune distance
// (`tbest()`: a box must be entered before it), takes each triangle hit
// in leaf order (`hit(h, leaf_row)`) and may end the walk (`done()`).
template <class V>
__device__ __forceinline__ void walk(const Tables& t, const Ray& r, V& v) {
    int node = 0;
    while (node >= 0) {
        const int* lk = t.links + 3 * node;
        if (slab(t.bbox + 6 * node, r, v.tbest())) {
            int leaf = __ldg(lk + 2);
            if (leaf >= 0) {
                const float* lr = t.leaves + (long long)leaf * t.stride;
#pragma unroll 1
                for (int k = 0; k < K_LEAF; ++k) {
                    TriHit h;
                    if (triangle(lr, k, r, &h)) {
                        v.hit(h, lr);
                        if (v.done()) return;
                    }
                }
            }
            node = __ldg(lk);
        } else {
            node = __ldg(lk + 1);
        }
    }
}

// Closest hit (K2): the running best prunes the walk.
struct Closest {
    float t = (float)3.4e38, u = 0.0f, v = 0.0f;
    int idx = -1;
    __device__ float tbest() const { return t; }
    __device__ void hit(const TriHit& h, const float* __restrict__ lr) {
        if (h.t < t) {
            t = h.t;
            u = h.u;
            v = h.v;
            idx = (int)__ldg(lr + 72 + h.slot);
        }
    }
    __device__ bool done() const { return false; }
};

// Any hit before `limit` (K3 and K1's shadow test): the walk ends at the
// first blocker.
struct Any {
    float limit;
    bool occ = false;
    __device__ float tbest() const { return limit; }
    __device__ void hit(const TriHit& h, const float* __restrict__) {
        occ = occ || h.t < limit;
    }
    __device__ bool done() const { return occ; }
};

}  // namespace bvh
