// A g++ emulation of the CUDA runtime for the receive megakernel
// (tools/k1_emulate.py), the ray / triangle kernels (tools/k4_emulate.py)
// and the BVH walks (tools/bvh_emulate.py): each block runs as blockDim.x
// std::threads; __syncthreads a block barrier, the warp votes and
// __syncwarp a barrier a warp; atomics are real atomics (a plain |= loses
// bits when two threads race); the occupancy query gives one block an SM
// on two SMs.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
// a __shared__ variable at namespace scope (an instrumented build): one
// copy for every block (a compile check only; its sums race)
#define __shared__

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct int2 { int x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return uint4{a, b, c, d};
}
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline int2 make_int2(int a, int b) { return int2{a, b}; }
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
    return float4{a, b, c, d};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };

namespace emu {
struct Block {
    std::unique_ptr<std::barrier<>> bar;
    std::vector<std::unique_ptr<std::barrier<>>> wbar;
    std::vector<unsigned long long> vote;   // 32 a warp
    std::vector<char> smem;
    std::atomic<int> all{1};                // __syncthreads_and
};
inline thread_local dim3 t_idx, b_idx, b_dim, g_dim;
inline thread_local Block* blk = nullptr;
inline int n_sms = 2;
inline int per_sm = 1;

inline void warp_wait() { blk->wbar[t_idx.x / 32]->arrive_and_wait(); }
inline unsigned long long* warp_votes() {
    return blk->vote.data() + 32 * (t_idx.x / 32);
}
inline char* cur_smem() { return blk->smem.data(); }

template <class K, class... A>
void launch(K kernel, dim3 g, dim3 b, int smem, void*, A... args) {
    for (unsigned by = 0; by < g.y; ++by)
        for (unsigned bx = 0; bx < g.x; ++bx) {
            Block bl;
            bl.bar = std::make_unique<std::barrier<>>(b.x);
            for (unsigned w = 0; w < (b.x + 31) / 32; ++w)
                bl.wbar.push_back(std::make_unique<std::barrier<>>(
                    std::min(32u, b.x - 32 * w)));
            bl.vote.assign(32 * ((b.x + 31) / 32), 0ull);
            bl.smem.assign(smem + 256, 0);
            std::vector<std::thread> th;
            for (unsigned t = 0; t < b.x; ++t)
                th.emplace_back([&, t] {
                    t_idx = dim3(t);
                    b_idx = dim3(bx, by);
                    b_dim = b;
                    g_dim = g;
                    blk = &bl;
                    kernel(args...);
                });
            for (auto& x : th) x.join();
        }
}
}  // namespace emu

#define threadIdx (emu::t_idx)
#define blockIdx (emu::b_idx)
#define blockDim (emu::b_dim)
#define gridDim (emu::g_dim)

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_wait(); }
// barriers around the reset, the votes and the read, so that no thread
// resets the value of the next call before every thread has read this one
inline int __syncthreads_and(int p) {
    emu::Block* b = emu::blk;
    b->bar->arrive_and_wait();
    if (emu::t_idx.x == 0) b->all = 1;
    b->bar->arrive_and_wait();
    if (!p) b->all = 0;
    b->bar->arrive_and_wait();
    const int r = b->all;
    b->bar->arrive_and_wait();
    return r;
}
template <class T>
inline unsigned long long emu_vote(T v, unsigned long long (*op)(
                                            unsigned long long*, int, int)) {
    unsigned long long* vo = emu::warp_votes();
    int j = emu::t_idx.x % 32;
    vo[j] = (unsigned long long)v;
    emu::warp_wait();
    unsigned long long r = op(vo, j, 32);
    emu::warp_wait();
    return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
    return (unsigned)emu_vote(p ? 1 : 0, [](unsigned long long* v, int,
                                            int n) {
        unsigned long long r = 0;
        for (int i = 0; i < n; ++i) r |= (v[i] ? 1ull : 0ull) << i;
        return r;
    });
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) {
    return __ballot_sync(m, p) == 0xffffffffu;
}
inline unsigned __reduce_or_sync(unsigned, unsigned x) {
    return (unsigned)emu_vote(x, [](unsigned long long* v, int, int n) {
        unsigned long long r = 0;
        for (int i = 0; i < n; ++i) r |= v[i];
        return r;
    });
}
inline unsigned __match_any_sync(unsigned, unsigned x) {
    return (unsigned)emu_vote(x, [](unsigned long long* v, int j, int n) {
        unsigned long long r = 0;
        for (int i = 0; i < n; ++i) r |= (v[i] == v[j] ? 1ull : 0ull) << i;
        return r;
    });
}
template <class T>
inline T __shfl_down_sync(unsigned, T x, int off) {
    unsigned long long* vo = emu::warp_votes();
    int j = emu::t_idx.x % 32;
    vo[j] = (unsigned long long)x;
    emu::warp_wait();
    T r = j + off < 32 ? (T)vo[j + off] : x;
    emu::warp_wait();
    return r;
}
// a value's bits through the warp's vote slots (any type of up to 8 bytes)
template <class T>
inline T emu_shfl(T x, int src) {
    unsigned long long* vo = emu::warp_votes();
    int j = emu::t_idx.x % 32;
    unsigned long long b = 0;
    memcpy(&b, &x, sizeof(T));
    vo[j] = b;
    emu::warp_wait();
    b = vo[((src % 32) + 32) % 32];
    emu::warp_wait();
    T r;
    memcpy(&r, &b, sizeof(T));
    return r;
}
template <class T>
inline T __shfl_sync(unsigned, T x, int src) { return emu_shfl(x, src); }
template <class T>
inline T __shfl_up_sync(unsigned, T x, unsigned off) {
    int j = emu::t_idx.x % 32;
    T r = emu_shfl(x, j >= (int)off ? j - (int)off : j);
    return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T x, int mask) {
    return emu_shfl(x, (emu::t_idx.x % 32) ^ mask);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __ffsll(unsigned long long x) { return __builtin_ffsll((long long)x); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __frcp_rn(float a) { volatile float r = 1.0f / a; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline int __float_as_int(float x) { int r; memcpy(&r, &x, 4); return r; }
inline unsigned __float_as_uint(float x) {
    unsigned r; memcpy(&r, &x, 4); return r;
}
inline float __int_as_float(int x) { float r; memcpy(&r, &x, 4); return r; }
inline float __uint_as_float(unsigned x) {
    float r; memcpy(&r, &x, 4); return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float atomicAdd(float* p, float v) {
    return std::atomic_ref<float>(*p).fetch_add(v);
}
inline double atomicAdd(double* p, double v) {
    return std::atomic_ref<double>(*p).fetch_add(v);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
    return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
    unsigned long long old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
    while (v < old && !__atomic_compare_exchange_n(
                          p, &old, v, false, __ATOMIC_SEQ_CST,
                          __ATOMIC_SEQ_CST)) {
    }
    return old;
}
inline long long clock64() { return 0; }
template <class A, class B> inline auto min(A a, B b) -> decltype(a + b) {
    return a < b ? a : b;
}
template <class A, class B> inline auto max(A a, B b) -> decltype(a + b) {
    return a > b ? a : b;
}

template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K,
                                                                 int, int) {
    *n = emu::per_sm;
    return 0;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
    *v = emu::n_sms;
    return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
    memset(p, v, n);
    return 0;
}
// the symbol copies of an instrumented build (tools/k1_clock.py)
template <class T, class S>
inline cudaError_t cudaMemcpyFromSymbol(T* dst, const S& sym, size_t n) {
    memcpy(dst, &sym, n);
    return 0;
}
template <class S, class T>
inline cudaError_t cudaMemcpyToSymbol(S& sym, const T* src, size_t n) {
    memcpy(&sym, src, n);
    return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaDeviceSynchronize() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
