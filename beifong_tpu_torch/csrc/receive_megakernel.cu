// Radar receive megakernel for Hopper (sm_90a), in five configurations:
// the flagship (analytic rectangles), the mesh configuration (the same
// lane plus a BVH walk over triangle meshes), the Doppler configuration
// (either of them plus moving geometry, the GGX rough conductor, time x
// frequency or wide fast-time grids and the receive types with a local
// oscillator), the coherent configuration (the Doppler one splatting
// I / Q with the echo phase) and the MIMO configuration (the coherent one
// of a phased receive array, one I / Q pair an element), seven
// instantiations of one block body trace_block<MESH, DOP, COH, MIMO, MED>
// (COH only with DOP, MIMO only with COH and without MESH), launched
// through receive_trace_kernel<MESH, MED> (flagship, mesh) and, with
// launch bounds, receive_doppler_kernel<MESH, COH, MED> (and its twins'
// flags, EP and LOB, below) and
// receive_mimo_kernel<MED>.  Each has a media twin (MED): the same body
// through the scene's ambient medium (the JAX kernel's `absorbing`,
// `layered` and `grid_meta`, :139-145, 399-423, 1457-1490, 1516-1528,
// 1731-1738), whose kind is the warp-uniform Cfg.medium (1 homogeneous,
// 2 layered, 3 a sigma grid): every segment a lane crosses multiplies its
// throughput, and every NEE connection its value, by exp(-tau) (seg_tau).
// The vacuum instantiations (MED false) compile as they did without it.
// The grid (at most 64 x 128 floats, 32 KB) stays in device memory behind
// the read-only path (__ldg, L1), not in shared memory: the Doppler
// family's four blocks an SM already hold their splat grids there, and a
// lane reads 16 cells a segment and a connection only where it hits.
// Each vacuum instantiation also has an endpoint twin (EP; the JAX
// kernel's n_tx > 1, tx_kinds and rx_kind 'phased' without mimo_e,
// :1066-1119, 1558-1720, 2703-2722, 2816-2820): up to MAX_TX transmitter
// rows of mixed kinds (Wigner, phased, area; Cfg.n_tx, the kind read off
// each row, warp-uniform) in shared memory, a direct hit counted for the
// transmitter the lane hit, NEE to every transmitter in row order with its
// own three draws (the draw stride of a depth is 3 + 3 n_tx), its own
// shadow test (its own rectangle never blocks it; the others' do) and its
// own phase pivots; a phased transmitter's aperture weight and an analog
// phased receiver's ray weight are the cross-WDF pair sums (pair_sum), in
// ascending pair order, over pair rows read through the read-only path
// (Cfg.php, Cfg.rxph).  The EP twins run in vacuum: a scene with these
// endpoints and a medium runs on the wavefront.  The vacuum and media
// instantiations (EP false) compile as they did without it.  On analytic
// scenes the power and coherent endpoint twins run kernels of their own
// (receive_endpoint_kernel, receive_endpoint_coherent_kernel, below: the
// flagship's and the coherent kernel's warp wavefronts, and a footprint
// index over each phased array's pairs); the mesh twins and the Doppler
// power twin run the EP instantiations of the block body.  The vacuum mesh
// configuration in power and the vacuum MIMO configuration run kernels of
// their own too (receive_mesh_kernel and receive_mimo_array_kernel, below:
// the flagship's and the coherent kernel's warp wavefronts); their media
// and endpoint twins run the block body.
// The Doppler family's four vacuum configurations have a lobe twin (the
// mesh ones receive_mesh_doppler_kernel<COH, true>, the analytic ones
// receive_lobe_kernel<COH>, below; the
// JAX kernel's diel, thin, plas, rplas, rdiel, has_blend and has_mask,
// :187-225, 819-835, 1122-1297, 1663-1671, 1912-2226), whose flags are
// the warp-uniform Cfg.lobes: the hit's lobe by its type, its NEE through
// lobe_fcos (0 from a delta lobe), a composite's second lobe read from
// its prim row (columns 27-33) where it is used, the NEE mix w f0 + (1 -
// w) f1, the lobe-mix pick, and the bounce of each lobe (a mask's pass,
// the mirror, the smooth and thin dielectric by the Fresnel of u8, the
// GGX half vector of the rough conductor, the rough plastic's coat and GGX
// glass, the cosine hemisphere of the diffuse and plastic bases); a
// refracted or passed ray spawns behind the face, and a delta bounce (a
// mirror, a dielectric, a mask's pass, where the tables hold a delta
// lobe) counts a direct hit at the next vertex.  A depth's draws are
// then 6, plus a lobe pick (plastics, GGX glass), plus a lobe-mix pick
// (composites).  The lobe twins run in vacuum with one Wigner
// transmitter; the other instantiations (LOB false) compile as they did
// without it.
//
// Replaces the TPU kernel beifong_tpu/integrators/pallas_receive.py::
// _make_kernel (launched by _run's pl.pallas_call) in its analytic /
// Wigner-aperture / raw / power configuration, with or without triangle
// meshes (has_mesh): per lane, the receive ray from the Wigner (or omni)
// receiver, the closest hit over <= 64 analytic rectangles and, in the
// mesh configuration, over the triangles of the scene's BVH (bvh_walk.cuh,
// the walk of pallas_bvh.py::traversal_body, pruned by the analytic best),
// direct transmitter hits at depth 0, next-event estimation to the one
// Wigner transmitter with the waveform and aperture Wigner weights, gate
// sampling and a shadow test (rectangles, then the BVH any-hit walk), a
// tent splat into the ADC bins, and the bounce.  The flagship and mesh
// configurations take diffuse lobes, a static scene and a fast-time ADC of
// at most 512 bins.  The Doppler configuration (DOP) adds what the JAX
// kernel bakes as `moving`, `ggx` and its other splats:
//  - the first-order Doppler chain: a cumulative factor `dop` from the
//    receiver's velocity, times the vertex-bounce and transmitter factors
//    at each NEE connection, and the bounce factor of each continued path
//    (pallas_receive.py:624-629, 1740-1749, 2208-2211);
//  - the GGX rough conductor beside the diffuse lobe, chosen per lane by
//    the hit's type: the prim row's columns 15-21 on rectangles, the
//    triangle's mesh-shape row (`msh`, second leaf payload) on meshes;
//    its NEE evaluation (_fres_cond, _g1, bsdf_eval_cos :1137-1279) and
//    its half-vector sample and weight (:1957-1984);
//  - a per-lane receive frequency drawn over the ADC's window when
//    n_freq > 1 (:450-452), splatted with the time tent over the
//    frequency bins (:1757-1758, 1880-1905), and fast-time grids past 512
//    bins (the TPU's wide 1-D splat, :1830-1879);
//  - the receive types (:174-179, 429-452, 1615-1625, 1750-1758):
//    mix_resample reads the receive frequency off the transmitter's chirp
//    and bins the beat |f_recv - f_tx(t_recv)|; mixer draws a beat over
//    the ADC window, f_rx = f_LO(t) - beat, and bins f_LO(t_recv) -
//    f_recv; raw_resample with an LO reads f_rx off the LO.  The LO's
//    waveform and phase pivots ride params[33:42].  The receive type is a
//    field of Cfg (`rule`), not a template flag: every lane of a launch
//    has the same one, so its branches never diverge, and a flag would
//    double the Doppler instantiations for the handful of instructions
//    they guard;
//  - the mirror chains of smooth conductors (`mirror` / `delta_any`
//    :199-209, 1558-1614, 1715-1717, 2115-2129, 2189-2190), behind the
//    warp-uniform `Cfg.mirror` in the same way: a mirror reflects the ray
//    about the flipped normal with the conductor's Fresnel weight, no NEE
//    leaves it, and the lane it continued (`wdel`) counts a direct
//    transmitter hit at its next vertex.
// A coherent processing interval (CPI) of P pulses is one launch with the
// pulse as the grid's y axis (receive_cpi_pallas's lax.scan, :3164-3327):
// block (x, p) reads pulse p's stacked tables, BVH, uniforms and Philox
// key (seed + seed_step p; the counter stays the lane within its pulse)
// and writes its own partials, which the reduce sums pulse by pulse.  One
// receive call is the launch with P = 1.
// The coherent configuration (COH) splats sqrt(max(power, 0)) times
// (fast_cos, fast_sin) of the connection's echo phase into two channels
// (_coh_vals :1435-1455): the JAX kernel's float32 phase (_frac_cycles,
// _h_cyc, echo_phase :327-397; the direct-hit phase :1626-1630, the NEE
// phase with its boundary phase :1759-1763), from the path length, the
// emission and receive times and the float64 pivots the host packs.
// Those three functions are written with __fmul_rn / __fadd_rn /
// __fsub_rn: _frac_cycles is a Dekker split and a compensated product,
// which FMA contraction would make inexact (the phase would then drift by
// far more than an ulp once f t >> 2^24 cycles), so they round as the
// plain version and the JAX kernel round.  The rest of the kernel keeps
// contraction on.
// The MIMO configuration (MIMO; the JAX kernel's mimo_e > 0 with
// eoff_ref, :465-513, 1435-1452, 1533-1552, 1792-1809) is the coherent
// one of a phased receive array on analytic scenes: the rays leave the
// array's origin over the cosine hemisphere about its normal, weighted by
// one element's pattern gain (its half-widths are the packed receiver
// row's first two floats); the lane's first vertex x1 anchors each
// element's path difference dd_e = |x1 - o - r_e| - |x1 - o|, and every
// connection splats amp (fast_cos, fast_sin) of its echo phase less
// 2 pi (f / c) dd_e into the element's I / Q pair of an (n_time, 2E)
// float64 grid.  The lane keeps x1 - o and |x1 - o| (four floats) and
// recomputes dd_e at each connection from the element offsets in shared
// memory, rather than holding E of them over the lane's path; dd_e is a
// difference of two ~4 m lengths, so its arithmetic rounds every
// operation (__fmul_rn, __fadd_rn, __fsqrt_rn) as the plain version does.
// The arithmetic follows beifong_tpu_torch/integrators/receive_kernel.py::
// receive_megakernel_ref operation by operation (same association, same
// constants rounded from double, no --use_fast_math), so the two differ
// only where nvcc contracts a multiply and an add into one FMA (one
// rounding fewer), in rsqrtf's last bits and in the order in which sums
// are taken.  A phase inherits the contracted path length's last bits:
// ~2 pi x a few ulps of the path over the wavelength.
//
// What bounds it on the H100: FP32 ALU and SFU work per lane.  A lane
// reads ~9 KB of scene tables that every lane shares and writes nothing
// but its splats, so there is no device-memory traffic to speak of
// (the output is n_blocks x n_cells values).  The design therefore keeps
// everything on chip: one thread per lane in a persistent grid-stride
// loop (a few blocks per SM, whatever the sample count), the scene tables
// copied once per block into shared memory, prims looped at run time,
// lanes that die (miss, absorbed, hit the receiver) leave the loop early.
// The BVH tables (575 KB for 10,082 triangles) do not fit a block's
// shared memory; they stay in device memory behind the read-only cache and
// L2.
//
// Direction strata (mesh configurations, patch_p > 0): the pallas kernel
// walks one node pointer per (8, 128) tile and keeps the tile's rays in
// one cell of a P x P grid of the cosine-hemisphere square, so each tile
// is a narrow beam.  Here lane L belongs to tile L / 1024 and takes cell
// (tile * 131 + int(params[0])) % P^2 as there; since the grid-stride loop
// hands a warp 32 consecutive lanes, a warp traces one beam and its
// per-thread walks stay coherent.
//
// Splats.  A tent touches floor(yb) and floor(yb) + 1 only (and, on a 2-D
// grid, floor(xb) and floor(xb) + 1: four cells).  The TPU splats with
// one-hot MXU products because Mosaic has no scatter; a GPU scatters.
//  - Flagship and mesh: each thread owns a private row of n_time floats in
//    shared memory (bin b of thread t at hist[b * T + t]: conflict-free
//    for any b), so no atomics are taken and the order of every float sum
//    is fixed by the launch geometry.  The block then sums its T rows in
//    thread order, in double, into an (n_blocks, n_time) partial buffer,
//    and a second small kernel sums the partials in block order, in
//    double, and rounds once to float.  A thread's own row sums a few
//    thousand lanes in float; the sums above it would otherwise add 10^5
//    rows of float at 2^28 lanes.  Event counts are integers.  The same
//    inputs therefore give bit-identical output on one card.
//  - Doppler: private rows do not scale past a few hundred cells (a 2-D
//    grid of 1,024 cells would leave no thread a row), so the block keeps
//    ONE (n_time, n_freq) float grid in shared memory and its threads add
//    their taps with shared-memory atomics (mode 1, up to 16,384 cells:
//    64 KB beside ~11 KB of tables still lets three blocks share an SM);
//    the block's grid then goes to the partial buffer in double and the
//    same fixed-order second kernel sums the blocks.  Larger grids (mode
//    2, up to 2^20 cells) add their taps straight into one global float64
//    grid with atomics (8 MB: it stays in L2), which the second kernel
//    rounds to float.  Atomics add in the order the threads arrive, so
//    this configuration gives up bit-identical repeats: two runs agree to
//    the rounding of a float sum per cell (~1e-6 of max|acc|), not to the
//    bit.
//  - Coherent: the same grids with I and Q interleaved per cell, so the
//    shared grid holds half the cells (8,192 in 64 KB) and the global one
//    2 x 2^20 doubles (16 MB, still in L2); the reduce kernel sums the
//    2 n_cells values as it sums n_cells.
//  - MIMO: an (n_time, 2E) grid of doubles, added to with float64
//    atomics: block-shared up to 8,192 values (64 KB; golden config 6's
//    64 x 16 is 8 KB), global past it (at most 8,192 x 16, 1 MB).  A
//    target's echo lands in a few bins, so the adds of a warp whose lanes
//    all hit would meet on a few dozen addresses; on config 6 0.3% of
//    the lanes hit, the kernel is its rays' FP32 work, and the splat does
//    not show (PERF.md).
//
// Random numbers: PRNG mode runs Philox4x32-10 keyed by the 64-bit seed
// with counter (lane, draw / 4), word draw % 4, top 24 bits scaled by
// 2^-24, so a lane's stream does not depend on the launch geometry.
// Injected mode reads u[draw * n_lanes + lane] from a (n_draws, n_lanes)
// tensor instead (parity with the plain version and the JAX package).
// Draw indices are positional (trace_lane: 0 time, 1 the frequency draw
// where the JAX kernel's sequential draws take one: raw receive with
// n_freq > 1, or mixer's beat; then the ray draws, then 3 + 3 n_tx per
// depth: six with one transmitter),
// so a lane that leaves the loop early skips its remaining draws without
// shifting anyone's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bvh_walk.cuh"

#define F(x) ((float)(x))

namespace {

constexpr int PRIM_COLS = 34;
constexpr int TXP_COLS = 32;
constexpr int MSH_COLS = 8;
constexpr int RECTANGLE = 0;
constexpr int SPHERE = 1;     // the prims twins' other analytic kinds
constexpr int DISK = 2;
constexpr int CYLINDER = 3;
constexpr float CW = 0.0f;
constexpr float LINFMCW = 2.0f;
constexpr float DIFFUSE = 0.0f;
constexpr float CONDUCTOR = 1.0f;
constexpr float ROUGH_CONDUCTOR = 2.0f;
constexpr float DIELECTRIC = 3.0f;
constexpr float THIN_DIELECTRIC = 4.0f;
constexpr float PLASTIC = 5.0f;
constexpr float ROUGH_PLASTIC = 6.0f;
constexpr float ROUGH_DIELECTRIC = 10.0f;
// the lobe twins' flags (Cfg.lobes; receive_kernel.py LOBE_*)
constexpr int LOBE_DIEL = 1;
constexpr int LOBE_THIN = 2;
constexpr int LOBE_PLAS = 4;
constexpr int LOBE_RPLAS = 8;
constexpr int LOBE_RDIEL = 16;
constexpr int LOBE_BLEND = 32;
constexpr int LOBE_MASK = 64;
// the lobes whose bounce draws a lobe pick (the JAX kernel's lobe_mix)
constexpr int LOBE_PICK = LOBE_PLAS | LOBE_RPLAS | LOBE_RDIEL;
// transmitter kinds (txp column 27) and the endpoint twins' table: up to
// MAX_TX transmitter rows in shared memory
constexpr float TX_PHASED = 1.0f;
constexpr float TX_AREA = 2.0f;
constexpr int MAX_TX = 4;
constexpr int DOP_THREADS = 128;   // threads per block, Doppler config
// The MIMO twins' blocks an SM: at 4 they fit 127 registers with no
// spill; 3 and 2 give them 137 and 139 (ptxas on the H100, PERF.md)
constexpr int MIMO_MIN_BLOCKS = 4;
// receive-frequency rules (receive_kernel.py RX_*)
constexpr int RX_MIX = 1;
constexpr int RX_MIXER = 2;
constexpr int RX_RAW_LO = 3;

struct Cfg {
    long long n_lanes;
    unsigned long long seed;
    int n_time;
    int max_depth;
    int gate;
    int omni;
    int n_prims;
    int n_params;
    int use_prng;
    int patch_p;      // direction strata per side (mesh; 0 = none)
    float t_start;
    float t_window;
    float f_rx;
    // Doppler configuration
    int n_freq;
    int n_msh;        // mesh-shape rows
    int mode;         // 1 block-shared grid, 2 global float64 grid
    float f_lo;       // ADC frequency window: low edge,
    float f_span;     // f_hi - f_lo (the frequency draw)
    float f_den;      // max(f_hi - f_lo, 1e-30) (the frequency bins)
    int rule;         // receive-frequency rule (RX_*; 0 raw)
    int has_lo;       // an LO waveform at params[33:42] (coherent dechirp)
    int mirror;       // a smooth conductor in the tables: mirror chains
    // the pulse axis (blockIdx.y): pulse p's tables sit p strides in, its
    // Philox key is seed + seed_step * p; one pulse has blockIdx.y == 0
    unsigned long long seed_step;
    long long u_stride;       // injected uniforms of one pulse
    long long bbox_stride;    // BVH tables of one pulse (floats / ints)
    long long links_stride;
    long long leaves_stride;
    int n_elem;               // MIMO: receive elements (2E channels)
    // ambient medium (the MED instantiations): 1 homogeneous, 2 layered,
    // 3 a sigma grid of (g_d * g_h, g_w) cells at `grid`; its scalars ride
    // params (sigma_t [29]; layered K [42], z_min [43], the layer
    // thickness [44], the K steps from [45]; a grid's box minimum [43:46]
    // and inverse extent [46:49])
    int medium;
    int g_d, g_h, g_w;
    const float* grid;
    // the endpoint twins (EP): n_tx transmitter rows (txp[:, 27] their
    // kinds); a phased transmitter's pair rows php, n_tx x php_cols floats
    // (the element half-widths, then n_pairs x (mid_s, mid_t, base_s,
    // base_t, psi, valid)); an analog phased receiver (rx_phased) and its
    // pair row rxph (2 + 6 n_rx_pairs floats).  Both tables stay in device
    // memory behind the read-only path, as the media grid does.
    int n_tx;
    int rx_phased;
    const float* php;
    int php_cols;
    int n_pairs;
    const float* rxph;
    int n_rx_pairs;
    // the lobe twins (LOB): the lobe flags (LOBE_*); a bounce draws a
    // lobe pick where they hold a plastic or GGX glass (LOBE_PICK), then a
    // lobe-mix pick where they hold a composite (LOBE_BLEND).  One int in
    // the struct's tail padding: the other kernels' parameters keep their
    // offsets
    int lobes;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
        uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += W0;
        k.y += W1;
    }
    return c;
}

// The pulse of a CPI launch, blockIdx.y, read anew at each use (a
// volatile read is not hoisted).  The flagship and mesh kernels form
// their pulse's uniforms, Philox key and BVH tables from it at each use,
// so no pulse-offset pointer or key stays live across the lane loop: the
// flagship runs at 79 registers (three blocks an SM, not two) and 6-8%
// faster than with them held.  The Doppler family, whose occupancy its
// launch bounds fix, holds them a block instead: reading the pulse at
// each use cost it 5-8% (PERF.md, tools/tree_ab.py and tools/k1_probe.py).
__device__ __forceinline__ long long pulse_id() {
    unsigned p;
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(p));
    return p;
}

// The pulse's BVH tables of a CPI's stacked tables (one pulse: strides 0).
__device__ __forceinline__ bvh::Tables pulse_tables(const bvh::Tables& m,
                                                    const Cfg& cfg) {
    const long long p = pulse_id();
    return bvh::Tables{m.bbox + p * cfg.bbox_stride,
                       m.links + p * cfg.links_stride,
                       m.leaves + p * cfg.leaves_stride, m.stride};
}

// The tables a walk reads: the Doppler family's `m` is its pulse's
// already (set once a block); the flagship and mesh kernels pass the
// CPI's and find the pulse's at each walk.
template <bool DOP>
__device__ __forceinline__ bvh::Tables lane_tables(const bvh::Tables& m,
                                                   const Cfg& cfg) {
    if constexpr (DOP)
        return m;
    else
        return pulse_tables(m, cfg);
}

// Uniform number `idx` of one lane, from the generator (keyed per pulse,
// seed + seed_step p; the counter is the lane within its pulse) or the
// injected tensor (one block of u_stride floats a pulse).  HOLD: `u` and
// `seed` are the pulse's own, set once a block; else they are the CPI's
// and the pulse is read at each use (see pulse_id).  Philox words come
// four at a time; the last block is cached.
template <bool HOLD>
struct Draws {
    const float* u;
    long long lane, n_lanes, u_stride;
    unsigned long long seed, seed_step;
    int use_prng;
    int group;
    uint4 words;

    __device__ float get(int idx) {
        if (!use_prng) {
            long long i = (long long)idx * n_lanes + lane;
            if constexpr (!HOLD) i += pulse_id() * u_stride;
            return u[i];
        }
        int g = idx >> 2;
        if (g != group) {
            unsigned long long k = seed;
            if constexpr (!HOLD) {
                if (seed_step != 0) k += seed_step * pulse_id();
            }
            words = philox4x32_10(
                make_uint4((uint32_t)lane, (uint32_t)(lane >> 32),
                           (uint32_t)g, 0u),
                make_uint2((uint32_t)k, (uint32_t)(k >> 32)));
            group = g;
        }
        int w = idx & 3;
        uint32_t x = w == 0 ? words.x : w == 1 ? words.y
                   : w == 2 ? words.z : words.w;
        return (float)(x >> 8) * F(1.0 / 16777216.0);
    }
};

__device__ __forceinline__ float fast_sin(float x) {
    float t = x * F(1.0 / 6.283185307179586);
    t = t - rintf(t);                        // half to even, as jnp.round
    float s = 16.0f * t * (0.5f - fabsf(t));
    return s * (F(0.775) + F(0.225) * fabsf(s));
}

__device__ __forceinline__ float fast_cos(float x) {
    return fast_sin(x + 0.5f * F(3.141592653589793));
}

__device__ __forceinline__ float sinc_f(float x) {
    return fabsf(x) > F(1e-8) ? fast_sin(x) / x : 1.0f;
}

__device__ __forceinline__ float tri_f(float x) {
    float ax = fabsf(x);
    return ax < 0.5f ? 1.0f - 2.0f * ax : 0.0f;
}

__device__ __forceinline__ float sgn_ge(float x) {   // 0 counts as +
    return x >= 0.0f ? 1.0f : -1.0f;
}

__device__ __forceinline__ float sign0(float x) {    // jnp.sign: 0 at 0
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float floor_mod(float a, float b) {
    float r = fmodf(a, b);
    if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = r + b;
    return r;
}

// Smith GGX masking for |cos| ct (pallas_receive.py::_g1).
__device__ __forceinline__ float g1(float ct, float a2) {
    float t2 = (1.0f - ct * ct) / fmaxf(ct * ct, F(1e-12));
    return 2.0f / (1.0f + sqrtf(1.0f + a2 * t2));
}

// Unpolarized conductor Fresnel (pallas_receive.py::_fres_cond).
__device__ __forceinline__ float fres_cond(float ci, float eta, float k) {
    float c2 = ci * ci;
    float s2 = 1.0f - c2;
    float e2 = eta * eta;
    float k2 = k * k;
    float t0 = e2 - k2 - s2;
    float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
    float t1 = a2b2 + c2;
    float a_ = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
    float t2 = 2.0f * a_ * ci;
    float rs = (t1 - t2) / fmaxf(t1 + t2, F(1e-20));
    float t3 = c2 * a2b2 + s2 * s2;
    float t4 = t2 * s2;
    float rp = rs * (t3 - t4) / fmaxf(t3 + t4, F(1e-20));
    return 0.5f * (rs + rp);
}

// GGX rough-conductor f(wi, wo) |cos_o| in the frame flipped toward wi
// (the GGX branch of pallas_receive.py::bsdf_eval_cos).
__device__ __forceinline__ float ggx_fcos(float rb, float ab, float eb,
                                          float kk, float nx, float ny,
                                          float nz, float wix, float wiy,
                                          float wiz, float wox, float woy,
                                          float woz) {
    float ci_raw = wix * nx + wiy * ny + wiz * nz;
    float sg = sgn_ge(ci_raw);
    float fx = nx * sg, fy = ny * sg, fz = nz * sg;
    float ci = ci_raw * sg;
    float co = wox * fx + woy * fy + woz * fz;
    float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
    float hn = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, F(1e-20)));
    hx = hx * hn;
    hy = hy * hn;
    hz = hz * hn;
    float hc = hx * fx + hy * fy + hz * fz;
    float hsg = sgn_ge(hc);
    hx = hx * hsg;
    hy = hy * hsg;
    hz = hz * hsg;
    hc = hc * hsg;
    float a2 = ab * ab;
    float dd = hc * hc * (a2 - 1.0f) + 1.0f;
    float d_ = a2 / fmaxf(F(3.141592653589793) * dd * dd, F(1e-20));
    float g_ = g1(fabsf(ci), a2) * g1(fabsf(co), a2);
    float idoth = wix * hx + wiy * hy + wiz * hz;
    float f_ = fres_cond(fabsf(idoth), eb, kk);
    float f_rc = rb * f_ * d_ * g_ / fmaxf(4.0f * ci, F(1e-8));
    return (co > 0.0f && ci > 0.0f) ? f_rc : 0.0f;
}

// ---- the lobe twins' lobes (LOB) -------------------------------------

// Unpolarized dielectric Fresnel for the signed cos_i ci
// (pallas_receive.py::_fres_diel :1122): the relative IOR eta from the
// side ci >= 0, its inverse from the other; total internal reflection
// gives 1.  Also returns the relative IOR it used and cos_t.
__device__ __forceinline__ float fres_diel_full(float ci, float eta,
                                                float* eta_it_out,
                                                float* cos_t_out) {
    float eta_s = fmaxf(eta, F(1e-6));
    float eta_it = ci >= 0.0f ? eta_s : 1.0f / eta_s;
    float c2t = 1.0f - (1.0f - ci * ci) / (eta_it * eta_it);
    float cos_t = sqrtf(fmaxf(c2t, 0.0f));
    float aci = fabsf(ci);
    float rs = (aci - eta_it * cos_t) / fmaxf(aci + eta_it * cos_t, F(1e-20));
    float rp = (eta_it * aci - cos_t) / fmaxf(eta_it * aci + cos_t, F(1e-20));
    *eta_it_out = eta_it;
    *cos_t_out = cos_t;
    return c2t <= 0.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
}

__device__ __forceinline__ float fres_diel(float ci, float eta) {
    float e, c;
    return fres_diel_full(ci, eta, &e, &c);
}

// h normalised and flipped onto f's side; returns h.f (>= 0).
__device__ __forceinline__ float half_toward(float* hx, float* hy,
                                             float* hz, float fx, float fy,
                                             float fz) {
    float hn = rsqrtf(fmaxf(*hx * *hx + *hy * *hy + *hz * *hz, F(1e-20)));
    *hx = *hx * hn;
    *hy = *hy * hn;
    *hz = *hz * hn;
    float hc = *hx * fx + *hy * fy + *hz * fz;
    float hs = sgn_ge(hc);
    *hx = *hx * hs;
    *hy = *hy * hs;
    *hz = *hz * hs;
    return hc * hs;
}

// Rough-dielectric (GGX glass) f(wi, wo) |cos_o| and its pdf (into *pdf)
// in the frame f flipped toward wi, ci_raw the unflipped cosine
// (pallas_receive.py::_rd_fcos_pdf :1160-1228): Walter 2007's reflection
// and transmission lobes through their half vector, chi+ sidedness, the
// 1 / eta^2 radiance compression; k carries the transmittance.
__device__ float rd_fcos_pdf(float ci_raw, float fx, float fy, float fz,
                             float eb, float kk, float rb, float ab,
                             float wix, float wiy, float wiz, float wox,
                             float woy, float woz, float* pdf) {
    float sgr = sgn_ge(ci_raw);
    float ci = fabsf(ci_raw);
    float co = wox * fx + woy * fy + woz * fz;
    bool same = co > 0.0f;
    float eta_s = fmaxf(eb, F(1e-6));
    float eta_it = ci_raw >= 0.0f ? eta_s : 1.0f / eta_s;
    float hx, hy, hz;
    if (same) {
        hx = wix + wox;
        hy = wiy + woy;
        hz = wiz + woz;
    } else {
        hx = -(wix + eta_it * wox);
        hy = -(wiy + eta_it * woy);
        hz = -(wiz + eta_it * woz);
    }
    float hc = half_toward(&hx, &hy, &hz, fx, fy, fz);
    float a2 = ab * ab;
    float dd = hc * hc * (a2 - 1.0f) + 1.0f;
    float d_ = a2 / fmaxf(F(3.141592653589793) * dd * dd, F(1e-20));
    float g_ = g1(ci, a2) * g1(fabsf(co), a2);
    float idh = wix * hx + wiy * hy + wiz * hz;
    float odh = wox * hx + woy * hy + woz * hz;
    float f_d = fres_diel(idh * sgr, eb);
    float aci = fmaxf(ci, F(1e-6));
    float den_t = idh + eta_it * odh;
    float jac_t = eta_it * eta_it * fabsf(odh) / fmaxf(den_t * den_t,
                                                       F(1e-12));
    bool live = ci > F(1e-6) && idh > 0.0f && odh * co > 0.0f;
    float pdf_h = d_ * hc;
    float f, p;
    if (same) {
        f = f_d * d_ * g_ / (4.0f * aci) * rb;
        p = f_d * pdf_h / fmaxf(4.0f * fabsf(odh), F(1e-8));
    } else {
        f = ((1.0f - f_d) * d_ * g_ * fabsf(idh) * jac_t / aci)
            / (eta_it * eta_it) * kk;
        p = (1.0f - f_d) * pdf_h * jac_t;
    }
    *pdf = live ? p : 0.0f;
    return live ? f : 0.0f;
}

// f(wi, wo) |cos_o| of the hit's lobe, by its type (pallas_receive.py::
// bsdf_eval_cos :1230-1297): 0 for the delta lobes (mirror, smooth and
// thin dielectric), the GGX rough conductor, GGX glass, the plastic base
// (1 - Fi)(1 - Fo) x diffuse, the rough plastic's GGX coat with the
// dielectric Fresnel at the half vector, else diffuse.
__device__ float lobe_fcos(float kb, float rb, float ab, float eb, float kk,
                           float nx, float ny, float nz, float wix,
                           float wiy, float wiz, float wox, float woy,
                           float woz) {
    if (kb == CONDUCTOR || kb == DIELECTRIC || kb == THIN_DIELECTRIC)
        return 0.0f;
    if (kb == ROUGH_CONDUCTOR)
        return ggx_fcos(rb, ab, eb, kk, nx, ny, nz, wix, wiy, wiz, wox, woy,
                        woz);
    float ci_raw = wix * nx + wiy * ny + wiz * nz;
    float sg = sgn_ge(ci_raw);
    float fx = nx * sg, fy = ny * sg, fz = nz * sg;
    if (kb == ROUGH_DIELECTRIC) {
        float pdf;
        return rd_fcos_pdf(ci_raw, fx, fy, fz, eb, kk, rb, ab, wix, wiy, wiz,
                           wox, woy, woz, &pdf);
    }
    float ci = ci_raw * sg;
    float co = wox * fx + woy * fy + woz * fz;
    float f_d = rb * F(1.0 / 3.141592653589793) * fmaxf(co, 0.0f);
    if (kb != PLASTIC && kb != ROUGH_PLASTIC) return f_d;
    float f_pl = f_d * (1.0f - fres_diel(ci, eb)) * (1.0f - fres_diel(co, eb));
    if (kb == PLASTIC || !(co > 0.0f && ci > 0.0f)) return f_pl;
    float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
    float hc = half_toward(&hx, &hy, &hz, fx, fy, fz);
    float a2 = ab * ab;
    float dd = hc * hc * (a2 - 1.0f) + 1.0f;
    float d_ = a2 / fmaxf(F(3.141592653589793) * dd * dd, F(1e-20));
    float g_ = g1(fabsf(ci), a2) * g1(fabsf(co), a2);
    float idoth = wix * hx + wiy * hy + wiz * hz;
    return f_pl + fres_diel(fabsf(idoth), eb) * d_ * g_
                  / fmaxf(4.0f * ci, F(1e-8));
}

// Instantaneous frequency of a waveform row (the chirp ridge; f_centre
// otherwise).
__device__ __forceinline__ float inst_freq_of(float wf, float prf,
                                              float text, float fc,
                                              float fext, float t) {
    float pri = 1.0f / fmaxf(prf, F(1e-12));
    float tm = floor_mod(t, pri);
    float ti = 0.5f * text;
    float fi = fc + (fext / fmaxf(text, F(1e-12))) * (tm - ti);
    return wf == LINFMCW ? fi : fc;
}

// A waveform row in shared memory, read where it is used (held in
// registers, the transmitter's and the LO's rows cost the Doppler
// instantiations ~16 registers): r = [kind, amplitude, prf, t_ext,
// f_centre, f_ext, fcpri, dfc] with the coherent phase pivots of the host's
// float64 (fcpri = frac(fc_ref PRI), dfc = f_centre - fc_ref), and phi0 at
// *p0.  The transmitter's row is txp[16:24] (phi0 at 28), the LO's
// params[33:41] (phi0 at 41).
struct Wave {
    const float* r;
    const float* p0;

    __device__ float wf() const { return r[0]; }
    __device__ float prf() const { return r[2]; }
    __device__ float text() const { return r[3]; }
    __device__ float fc() const { return r[4]; }
    __device__ float fext() const { return r[5]; }
    __device__ float fcpri() const { return r[6]; }
    __device__ float dfc() const { return r[7]; }
    __device__ float phi0() const { return *p0; }
    __device__ float inst_freq(float t) const {
        return inst_freq_of(r[0], r[2], r[3], r[4], r[5], t);
    }
};

// The phase arithmetic below rounds every operation (no contraction), as
// the plain version and the JAX kernel do.
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}

// frac(f t) with a compensated product (f t may be >> 2^24): a Dekker
// split of both factors (pallas_receive.py::_frac_cycles).
__device__ float frac_cycles(float f, float t) {
    float c_ = mul_rn(f, 4097.0f);
    float fh = sub_rn(c_, sub_rn(c_, f));
    float fl = sub_rn(f, fh);
    float ct = mul_rn(t, 4097.0f);
    float th = sub_rn(ct, sub_rn(ct, t));
    float tl = sub_rn(t, th);
    float pp = mul_rn(f, t);
    float err = add_rn(add_rn(add_rn(sub_rn(mul_rn(fh, th), pp),
                                     mul_rn(fh, tl)),
                              mul_rn(fl, th)),
                       mul_rn(fl, tl));
    float fr = add_rn(sub_rn(pp, floorf(pp)), err);
    return sub_rn(fr, floorf(fr));
}

// Small-argument waveform cycles h(tm) = g(tm) - fc_ref tm
// (pallas_receive.py::_h_cyc).
__device__ float h_cyc(const Wave& w, float tm) {
    float cyc = frac_cycles(w.dfc(), tm);
    if (w.wf() == LINFMCW) {
        float ti = mul_rn(0.5f, w.text());
        float s = w.fext() / fmaxf(w.text(), F(1e-12));
        float dtc = sub_rn(tm, ti);
        float extra = sub_rn(frac_cycles(mul_rn(mul_rn(0.5f, s), dtc), dtc),
                             frac_cycles(w.fc(), ti));
        cyc = add_rn(cyc, extra);
    }
    return cyc;
}

// Baseband phase [rad] of a connection of path length dtot
// (pallas_receive.py::echo_phase): the transmitter's cycles at emission
// less the fc_ref cycles of the delay (fc_ref / c as the double-single
// sp[17] + sp[18]), less the receive side's: the transmitter's own chirp
// under mix_resample, else the LO's dechirp, its fold rebuilt from the
// delay when the dechirp is matched.
__device__ float echo_phase(const Wave& tx, const Wave& lo, const Cfg& cfg,
                            const float* sp, float dtot, float t_emit,
                            float t_recv, float k_pri) {
    const float INV_TP = F(1.0 / 6.283185307179586);
    const float cvel = sp[1];
    float pri = 1.0f / fmaxf(tx.prf(), F(1e-12));
    float m_e = floorf(mul_rn(t_emit, tx.prf()));
    float tm_e = sub_rn(t_emit, mul_rn(m_e, pri));
    float ct = add_rn(frac_cycles(sp[17], dtot), mul_rn(dtot, sp[18]));
    float cyc = sub_rn(sub_rn(add_rn(mul_rn(tx.phi0(), INV_TP),
                                     h_cyc(tx, tm_e)),
                              sub_rn(ct, floorf(ct))),
                       mul_rn(add_rn(m_e, k_pri), tx.fcpri()));
    if (cfg.rule == RX_MIX) {
        float m_r = floorf(mul_rn(t_recv, tx.prf()));
        float jj = sub_rn(sub_rn(m_r, m_e), k_pri);
        float tm_r = sub_rn(add_rn(tm_e, dtot / cvel), mul_rn(jj, pri));
        cyc = add_rn(sub_rn(sub_rn(cyc, mul_rn(tx.phi0(), INV_TP)),
                            h_cyc(tx, tm_r)),
                     mul_rn(m_r, tx.fcpri()));
    } else if (cfg.has_lo) {
        float pri_lo = 1.0f / fmaxf(lo.prf(), F(1e-12));
        float m_r = floorf(mul_rn(t_recv, lo.prf()));
        float tm_r0 = sub_rn(t_recv, mul_rn(m_r, pri_lo));
        float tau = dtot / cvel;
        float jr = mul_rn(sub_rn(add_rn(tau, tm_e), tm_r0), lo.prf());
        float jj = rintf(jr);
        float tm_hp = sub_rn(add_rn(tm_e, tau), mul_rn(jj, pri_lo));
        float tm_r = fabsf(sub_rn(jr, jj)) < F(1e-3) ? tm_hp : tm_r0;
        cyc = add_rn(sub_rn(sub_rn(cyc, mul_rn(lo.phi0(), INV_TP)),
                            h_cyc(lo, tm_r)),
                     mul_rn(m_r, lo.fcpri()));
    }
    return mul_rn(F(6.283185307179586), sub_rn(cyc, floorf(cyc)));
}

// The one transmitter: a rect aperture and its waveform.
struct Tx {
    const float* m;   // to_world rows 0..2 (12 floats)
    float wx, wy, area, gain, wf, amp, prf, text, fc, fext;
    float nx, ny, nz;
    float vx, vy, vz;  // velocity (Doppler configuration)
    Wave w;            // its row (Doppler and coherent configurations)

    // the body of inst_freq_of, written out: calling it here costs the
    // mesh instantiation two registers (110 to 112, ptxas on the card)
    __device__ float inst_freq(float t) const {
        float pri = 1.0f / fmaxf(prf, F(1e-12));
        float tm = floor_mod(t, pri);
        float ti = 0.5f * text;
        float fi = fc + (fext / fmaxf(text, F(1e-12))) * (tm - ti);
        return wf == LINFMCW ? fi : fc;
    }

    __device__ float eval_wdf(float t, float f) const {
        float pri = 1.0f / fmaxf(prf, F(1e-12));
        float tm = floor_mod(t, pri);
        float ti = 0.5f * text;
        float fi = inst_freq(t);
        float x = (tm - ti) / fmaxf(text, F(1e-12));
        float tw = tri_f(x);
        float w = 2.0f * amp * amp * text * tw
                  * sinc_f(F(6.283185307179586) * (f - fi) * text * tw);
        w = fabsf(x) < 0.5f ? w : 0.0f;
        return wf == CW ? amp * amp : w;
    }

    // (t_emit, t_recv, gate weight) of a path of delay tau, and into
    // k_pri, unless null, the whole PRIs t_recv was moved by
    __device__ void emission(float tau, float u, float t_rx0, int gate,
                             float t_start, float t_window, float* t_emit,
                             float* t_recv, float* w_gate,
                             float* k_pri = nullptr) const {
        if (!gate) {
            *t_emit = t_rx0 - tau;
            *t_recv = t_rx0;
            *w_gate = 1.0f;
            if (k_pri != nullptr) *k_pri = 0.0f;
            return;
        }
        float pri = 1.0f / fmaxf(prf, F(1e-12));
        bool is_cw = wf == CW;
        float sup = is_cw ? t_window : text;
        float te = (is_cw ? t_start - tau : 0.0f) + u * sup;
        float tr = tau + te;
        float k = ceilf((t_start - tr) * prf);
        k = is_cw ? 0.0f : fmaxf(k, 0.0f);
        *t_emit = te;
        *t_recv = tr + k * pri;
        *w_gate = sup / t_window;
        if (k_pri != nullptr) *k_pri = k;
    }

    // rect-aperture Wigner weight at local (lx, ly), radiation leaving
    // along (ex, ey, ez)
    __device__ float aperture(float lx, float ly, float ex, float ey,
                              float ez, float lam) const {
        float nu_x = -(m[0] * ex + m[4] * ey + m[8] * ez)
                     / fmaxf(wx, F(1e-9)) / lam;
        float nu_y = -(m[1] * ex + m[5] * ey + m[9] * ez)
                     / fmaxf(wy, F(1e-9)) / lam;
        float t_x = tri_f(lx * 0.5f), t_y = tri_f(ly * 0.5f);
        const float TP = F(6.283185307179586);
        return 4.0f * t_x * t_y * sinc_f(TP * nu_x * wx * t_x)
               * sinc_f(TP * nu_y * wy * t_y);
    }
};

// Transmitter row r of the endpoint twins' table in shared memory: the
// fields the lane reads, loaded where it reads them (the block wrote each
// row's unit normal into its free columns 29-31).
__device__ __forceinline__ Tx tx_row(const float* r) {
    Tx t;
    t.m = r;
    t.wx = r[12];
    t.wy = r[13];
    t.area = r[14];
    t.gain = r[15];
    t.wf = r[16];
    t.amp = r[17];
    t.prf = r[18];
    t.text = r[19];
    t.fc = r[20];
    t.fext = r[21];
    t.nx = r[29];
    t.ny = r[30];
    t.nz = r[31];
    t.vx = r[24];
    t.vy = r[25];
    t.vz = r[26];
    t.w = Wave{r + 16, r + 28};
    return t;
}

// A phased array's cross-WDF gain at p toward (dex, dey, dez) at
// wavelength lam (pallas_receive.py::_pair_sum :1066-1104): over its pair
// row `row` (the element half-widths, then per pair (mid_s, mid_t, base_s,
// base_t, psi, valid) along the unit in-plane axes s, t from the array
// centre o), in ascending pair order, each pair's element rectangle WDF
// inside its footprint times fast_cos of its interference phase.  The row
// is read through the read-only path; the loop is not unrolled (up to 64
// pairs), and a pair whose footprint does not hold p adds nothing, so its
// WDF and phase are skipped (the plain version adds its 0).
__device__ float pair_sum(const float* __restrict__ row, int n_k, float snx,
                          float sny, float snz, float tnx, float tny,
                          float tnz, float ox, float oy, float oz, float px,
                          float py, float pz, float dex, float dey,
                          float dez, float lam) {
    const float TP = F(6.283185307179586);
    float nu_x = (dex * snx + dey * sny + dez * snz) / lam;
    float nu_y = (dex * tnx + dey * tny + dez * tnz) / lam;
    const float wid_s = __ldg(row), wid_t = __ldg(row + 1);
    const float iws = 1.0f / fmaxf(2.0f * wid_s, F(1e-20));
    const float iwt = 1.0f / fmaxf(2.0f * wid_t, F(1e-20));
    float total = 0.0f;
#pragma unroll 1
    for (int k = 0; k < n_k; ++k) {
        const float* q = row + 2 + 6 * k;
        const float mid_s = __ldg(q), mid_t = __ldg(q + 1);
        float mx = ox + mid_s * snx + mid_t * tnx;
        float my = oy + mid_s * sny + mid_t * tny;
        float mz = oz + mid_s * snz + mid_t * tnz;
        float rlx = px - mx, rly = py - my, rlz = pz - mz;
        float rx_ = (rlx * snx + rly * sny + rlz * snz) * iws;
        float ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt;
        if (!(fabsf(rx_) <= 0.5f && fabsf(ry_) <= 0.5f)) continue;
        const float val_k = __ldg(q + 5);
        if (val_k == 0.0f) continue;
        float txr = tri_f(rx_), tyr = tri_f(ry_);
        float w_rect = 4.0f * wid_s * wid_t * txr * tyr
                       * sinc_f(TP * nu_x * wid_s * txr)
                       * sinc_f(TP * nu_y * wid_t * tyr);
        float ph = TP * (nu_x * __ldg(q + 2) + nu_y * __ldg(q + 3))
                   + __ldg(q + 4);
        total = total + w_rect * fast_cos(ph) * val_k;
    }
    return total;
}

// Transmitter t's aperture weight for radiation leaving its point p
// (local (lx, ly) in [-1, 1]^2) along (ex, ey, ez) at wavelength lam, by
// its kind: the rect Wigner weight, the phased cross-WDF over its pair row
// (toward -e, its frame from its rectangle) or 1 (area).
__device__ __forceinline__ float tx_gain(const Tx& tr, int t, const Cfg& cfg,
                                         float lx, float ly, float px,
                                         float py, float pz, float ex,
                                         float ey, float ez, float lam) {
    const float kind = tr.m[27];
    if (kind == TX_AREA) return 1.0f;
    if (kind == TX_PHASED) {
        const float* m = tr.m;
        float iwx = 1.0f / fmaxf(tr.wx, F(1e-20));
        float iwy = 1.0f / fmaxf(tr.wy, F(1e-20));
        return pair_sum(cfg.php + t * cfg.php_cols, cfg.n_pairs, m[0] * iwx,
                        m[4] * iwx, m[8] * iwx, m[1] * iwy, m[5] * iwy,
                        m[9] * iwy, m[3], m[7], m[11], px, py, pz, -ex, -ey,
                        -ez, lam);
    }
    return tr.aperture(lx, ly, ex, ey, ez, lam);
}

// ---- the endpoint kernels' footprint index ------------------------------
//
// receive_endpoint_kernel and receive_endpoint_coherent_kernel (below) sum
// a phased array's pairs over the pairs whose footprint may hold the point
// in place of all of them.  A pair's footprint is an element rectangle at
// its midpoint, so a point lies in few of them (an 8-element line array
// has 15 midpoints along s, one along t, and up to 8 pairs share one).
// Each block stages every array's pair rows in shared memory as two float4
// records a pair and builds an index a separable one: EPX_CELLS cells along
// s and along t, each with a mask of the pairs whose footprint, widened by
// a margin, meets it.  A lane maps its point to its cell on each axis, ANDs
// the two masks and runs the unchanged per-pair test and term on the set
// bits in ascending pair order.  The sum is bit for bit the full loop's:
// a pair the loop skips adds nothing to it, and the visited set holds
// every pair the rounded test accepts, because
//  - an accepted pair has |qs - mid_s| <= W_s + delta_s, with qs the
//    point's rounded coordinate (p - o).s, W_s = 0.5 / iws the test's
//    half-width and delta_s the margin: 2^-16 (256 float epsilons) of the
//    magnitudes the test and qs round (|o|_1 + max |mid| + the point bound,
//    against ~40 epsilons they can lose), plus twice the frame's distance
//    from orthonormal (|s.s - 1| max|mid_s| + |s.t| max|mid_t|: the test
//    reads (p - o - mid_s s - mid_t t).s, qs - mid_s its orthonormal form);
//  - a cell is floor((x - lo) inv) in rounded arithmetic, monotone in x, so
//    a point inside the widened interval [a, b] of a pair has its cell in
//    [cell(a), cell(b)], the cells whose masks hold the pair; lo is the
//    least a, so no such point falls below cell 0 or past the last cell.
// A point beyond the bound the margin assumes (|p|_1 > the header's), and
// an array whose index would not be finite, run the full loop over the
// staged records.  Pairs with valid == 0 are in no mask (the loop skips
// them after its test).  tests/test_torch_endpoint_emulate.py holds the
// indexed sum to the full loop on points on and one ulp about footprint
// edges.
constexpr int EPX_CELLS = 64;      // cells an axis
constexpr int EPX_HDR = 32;        // floats of an array's header
// An array's header: floats 0-2 its axis s and 3-5 t (pair_sum's snx ..
// tnz), 6-8 its centre o, 9-10 the element half-widths, 11-12 iws, iwt,
// 13-14 s's first edge and inverse cell width, 15-16 t's, 17 the point
// bound, 24-25 the widened half-widths; as ints 18-19 the cells along s
// and t, 20 the pairs, 21 whether the index holds (else the full loop),
// 22 its first record, 23 its first mask word.

// Mask words a cell (pairs up to 64 each), at least one.
__host__ __device__ constexpr int epx_words(int n_pairs, int n_rx_pairs) {
    return ((n_pairs > n_rx_pairs ? n_pairs : n_rx_pairs) + 63) / 64 > 0
               ? ((n_pairs > n_rx_pairs ? n_pairs : n_rx_pairs) + 63) / 64
               : 1;
}
// Floats of a block's index: a header an array (the n_tx transmitters',
// then the receiver's), two float4 records a pair, then each array's
// masks (two axes of EPX_CELLS cells, epx_words 64-bit words each).
__host__ __device__ constexpr int epx_floats(int n_tx, int n_pairs,
                                             int n_rx_pairs) {
    return EPX_HDR * (n_tx + 1) + 8 * (n_tx * n_pairs + n_rx_pairs)
           + 4 * EPX_CELLS * epx_words(n_pairs, n_rx_pairs) * (n_tx + 1);
}

// Whether x is finite (not an infinity, not a NaN).
__device__ __forceinline__ bool fin_f(float x) {
    return fabsf(x) <= F(3.4028234663852886e38);
}

// The cell of coordinate x on an axis of first edge lo and inverse cell
// width inv (rounded as written: monotone in x).
__device__ __forceinline__ float epx_cell(float x, float lo, float inv) {
    return floorf(__fmul_rn(__fsub_rn(x, lo), inv));
}

// Array a's header (one thread): transmitter a < n_tx (its pair row
// php + a php_cols; a phased one only) or the analog receiver (a ==
// n_tx; rxph), the frame as trace_lane's callers of pair_sum form it.
__device__ void epx_header(const Cfg& cfg, const float* sp, const float* s_tx,
                           float* h, int a) {
    int* hi = reinterpret_cast<int*>(h);
    const bool tx = a < cfg.n_tx;
    const float* r = s_tx + a * TXP_COLS;
    const int n_k = tx ? (r[27] == TX_PHASED ? cfg.n_pairs : 0)
                       : (cfg.rx_phased ? cfg.n_rx_pairs : 0);
    hi[18] = hi[19] = 0;
    hi[20] = n_k;
    hi[21] = 0;
    hi[22] = tx ? a * cfg.n_pairs : cfg.n_tx * cfg.n_pairs;
    hi[23] = 2 * EPX_CELLS * epx_words(cfg.n_pairs, cfg.n_rx_pairs) * a;
    if (n_k == 0) return;
    // to_world rows: the axes in columns 0 and 1, the centre in column 3
    const float* m = tx ? r : sp + 2;
    const float wx = tx ? r[12] : sp[14], wy = tx ? r[13] : sp[15];
    const float iwx = 1.0f / fmaxf(wx, F(1e-20));
    const float iwy = 1.0f / fmaxf(wy, F(1e-20));
    const float reach = tx ? fabsf(r[12]) + fabsf(r[13])
                           : fabsf(sp[30]) + fabsf(sp[31]);
    const float* row = tx ? cfg.php + a * cfg.php_cols : cfg.rxph;
    const float snx = m[0] * iwx, sny = m[4] * iwx, snz = m[8] * iwx;
    const float tnx = m[1] * iwy, tny = m[5] * iwy, tnz = m[9] * iwy;
    const float ox = m[3], oy = m[7], oz = m[11];
    const float wid_s = __ldg(row), wid_t = __ldg(row + 1);
    const float iws = 1.0f / fmaxf(2.0f * wid_s, F(1e-20));
    const float iwt = 1.0f / fmaxf(2.0f * wid_t, F(1e-20));
    h[0] = snx; h[1] = sny; h[2] = snz;
    h[3] = tnx; h[4] = tny; h[5] = tnz;
    h[6] = ox; h[7] = oy; h[8] = oz;
    h[9] = wid_s; h[10] = wid_t; h[11] = iws; h[12] = iwt;
    // the test's half-widths, the largest |mid|, the midpoints' span
    const float w_s = __fdiv_rn(0.5f, iws), w_t = __fdiv_rn(0.5f, iwt);
    float ms = 0.0f, mt = 0.0f;
    float s0 = F(3.4e38), s1 = -F(3.4e38), t0 = F(3.4e38), t1 = -F(3.4e38);
    bool fin = true;
    for (int k = 0; k < n_k; ++k) {
        const float* q = row + 2 + 6 * k;
        const float a_s = __ldg(q), a_t = __ldg(q + 1);
        fin = fin && fin_f(a_s) && fin_f(a_t);
        ms = fmaxf(ms, fabsf(a_s));
        mt = fmaxf(mt, fabsf(a_t));
        if (__ldg(q + 5) == 0.0f) continue;
        s0 = fminf(s0, a_s);
        s1 = fmaxf(s1, a_s);
        t0 = fminf(t0, a_t);
        t1 = fmaxf(t1, a_t);
    }
    // rounded as written (no contraction), as the plain version's count of
    // the visited pairs rounds them
    auto add = [](float x, float y) { return __fadd_rn(x, y); };
    auto mul = [](float x, float y) { return __fmul_rn(x, y); };
    auto dot = [&](float a0, float a1, float a2, float b0, float b1,
                   float b2) {
        return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
    };
    const float o1 = add(add(fabsf(ox), fabsf(oy)), fabsf(oz));
    const float big = add(add(o1, ms), mt);
    const float plim = add(add(o1, mul(4.0f, add(add(add(ms, mt), w_s), w_t))),
                           mul(4.0f, reach));
    const float ss = dot(snx, sny, snz, snx, sny, snz);
    const float tt = dot(tnx, tny, tnz, tnx, tny, tnz);
    const float st = dot(snx, sny, snz, tnx, tny, tnz);
    const float e16 = F(1.0 / 65536.0), e20 = F(1.0 / 1048576.0);
    const float dst = add(fabsf(st), e20);
    const float ext_s =
        add(add(w_s, mul(e16, add(add(plim, big), w_s))),
            mul(2.0f, add(mul(ms, add(fabsf(__fsub_rn(ss, 1.0f)), e20)),
                          mul(mt, dst))));
    const float ext_t =
        add(add(w_t, mul(e16, add(add(plim, big), w_t))),
            mul(2.0f, add(mul(mt, add(fabsf(__fsub_rn(tt, 1.0f)), e20)),
                          mul(ms, dst))));
    h[17] = plim;
    h[24] = ext_s;
    h[25] = ext_t;
    if (!(s0 <= s1)) {   // no valid pair: the sum is 0 at every point
        hi[21] = 1;
        return;
    }
    const float lo_s = __fsub_rn(s0, ext_s), hi_s = __fadd_rn(s1, ext_s);
    const float lo_t = __fsub_rn(t0, ext_t), hi_t = __fadd_rn(t1, ext_t);
    const float inv_s = __fdiv_rn((float)(EPX_CELLS - 2),
                                  __fsub_rn(hi_s, lo_s));
    const float inv_t = __fdiv_rn((float)(EPX_CELLS - 2),
                                  __fsub_rn(hi_t, lo_t));
    if (!(fin && fin_f(plim) && fin_f(ext_s) && fin_f(ext_t)
          && fin_f(inv_s) && fin_f(inv_t) && inv_s > 0.0f
          && inv_t > 0.0f))
        return;   // the full loop
    h[13] = lo_s;
    h[14] = inv_s;
    h[15] = lo_t;
    h[16] = inv_t;
    hi[18] = (int)epx_cell(hi_s, lo_s, inv_s) + 1;   // <= EPX_CELLS - 1
    hi[19] = (int)epx_cell(hi_t, lo_t, inv_t) + 1;
    hi[21] = 1;
}

// Block set-up of the index (every thread; syncs the block): records,
// headers, then each (array, axis, cell)'s mask, one thread each.
__device__ void epx_build(const Cfg& cfg, const float* sp, const float* s_tx,
                          float* s_epx, int tid, int T) {
    const int n_arr = cfg.n_tx + 1;
    const int n_txp = cfg.n_tx * cfg.n_pairs;
    const int W = epx_words(cfg.n_pairs, cfg.n_rx_pairs);
    float4* rec = reinterpret_cast<float4*>(s_epx + EPX_HDR * n_arr);
    unsigned long long* masks = reinterpret_cast<unsigned long long*>(
        s_epx + EPX_HDR * n_arr + 8 * (n_txp + cfg.n_rx_pairs));
    for (int i = tid; i < n_txp + cfg.n_rx_pairs; i += T) {
        const float* q = i < n_txp
                             ? cfg.php + (i / cfg.n_pairs) * cfg.php_cols + 2
                                   + 6 * (i % cfg.n_pairs)
                             : cfg.rxph + 2 + 6 * (i - n_txp);
        rec[2 * i] = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2),
                                 __ldg(q + 3));
        rec[2 * i + 1] = make_float4(__ldg(q + 4), __ldg(q + 5), 0.0f, 0.0f);
    }
    for (int a = tid; a < n_arr; a += T)
        epx_header(cfg, sp, s_tx, s_epx + EPX_HDR * a, a);
    __syncthreads();
    for (int i = tid; i < n_arr * 2 * EPX_CELLS; i += T) {
        const int a = i / (2 * EPX_CELLS), c = i % EPX_CELLS;
        const int ax = (i / EPX_CELLS) & 1;   // 0 along s, 1 along t
        const float* h = s_epx + EPX_HDR * a;
        const int* hi = reinterpret_cast<const int*>(h);
        unsigned long long* mk = masks + hi[23] + W * (ax * EPX_CELLS + c);
        for (int w = 0; w < W; ++w) mk[w] = 0ull;
        if (!hi[21] || c >= hi[18 + ax]) continue;
        const float lo = h[13 + 2 * ax], inv = h[14 + 2 * ax];
        const float ext = h[24 + ax];
        const float4* r = rec + 2 * hi[22];
        for (int k = 0; k < hi[20]; ++k) {
            if (r[2 * k + 1].y == 0.0f) continue;
            const float mid = ax ? r[2 * k].y : r[2 * k].x;
            const float ca = epx_cell(__fsub_rn(mid, ext), lo, inv);
            const float cb = epx_cell(__fadd_rn(mid, ext), lo, inv);
            if (ca <= (float)c && (float)c <= cb)
                mk[k >> 6] |= 1ull << (k & 63);
        }
    }
    __syncthreads();
}

// A block's index as a lane reads it: the headers, records and masks.
struct Epx {
    const float* hdr;
    const float4* rec;
    const unsigned long long* masks;
    int W;
    __device__ Epx(const Cfg& cfg, const float* base)
        : hdr(base),
          rec(reinterpret_cast<const float4*>(base + EPX_HDR * (cfg.n_tx + 1))),
          masks(reinterpret_cast<const unsigned long long*>(
              base + EPX_HDR * (cfg.n_tx + 1)
              + 8 * (cfg.n_tx * cfg.n_pairs + cfg.n_rx_pairs))),
          W(epx_words(cfg.n_pairs, cfg.n_rx_pairs)) {}
};

// pair_sum over array a's staged records: the pairs of the point's cells
// (ascending), or all of them where the index does not hold; the per-pair
// test and term are pair_sum's, operation by operation.  COUNT: the pairs
// it tested into *visits (the index check, rk_epx_check).
template <bool COUNT = false>
__device__ float pair_sum_epx(const Epx& ix, int a, float px, float py,
                              float pz, float dex, float dey, float dez,
                              float lam, int* visits = nullptr) {
    const float TP = F(6.283185307179586);
    const float* h = ix.hdr + EPX_HDR * a;
    const int* hi = reinterpret_cast<const int*>(h);
    const float snx = h[0], sny = h[1], snz = h[2];
    const float tnx = h[3], tny = h[4], tnz = h[5];
    const float ox = h[6], oy = h[7], oz = h[8];
    float nu_x = (dex * snx + dey * sny + dez * snz) / lam;
    float nu_y = (dex * tnx + dey * tny + dez * tnz) / lam;
    const float wid_s = h[9], wid_t = h[10];
    const float iws = h[11], iwt = h[12];
    const float4* rec = ix.rec + 2 * hi[22];
    float total = 0.0f;
    // [k1 stage: pairs]
    auto term = [&](int k) {
        if constexpr (COUNT) ++*visits;
        const float4 q = rec[2 * k];
        const float mid_s = q.x, mid_t = q.y;
        float mx = ox + mid_s * snx + mid_t * tnx;
        float my = oy + mid_s * sny + mid_t * tny;
        float mz = oz + mid_s * snz + mid_t * tnz;
        float rlx = px - mx, rly = py - my, rlz = pz - mz;
        float rx_ = (rlx * snx + rly * sny + rlz * snz) * iws;
        float ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt;
        if (!(fabsf(rx_) <= 0.5f && fabsf(ry_) <= 0.5f)) return;
        // [k1 stage: pair_terms]
        const float4 q1 = rec[2 * k + 1];
        const float val_k = q1.y;
        if (val_k == 0.0f) return;
        float txr = tri_f(rx_), tyr = tri_f(ry_);
        float w_rect = 4.0f * wid_s * wid_t * txr * tyr
                       * sinc_f(TP * nu_x * wid_s * txr)
                       * sinc_f(TP * nu_y * wid_t * tyr);
        float ph = TP * (nu_x * q.z + nu_y * q.w) + q1.x;
        total = total + w_rect * fast_cos(ph) * val_k;
    };
    if (hi[21] && fabsf(px) + fabsf(py) + fabsf(pz) <= h[17]) {
        // [k1 stage: pair_index]
        const float ex = __fsub_rn(px, ox), ey = __fsub_rn(py, oy),
                    ez = __fsub_rn(pz, oz);
        const float qs = __fadd_rn(__fadd_rn(__fmul_rn(ex, snx),
                                             __fmul_rn(ey, sny)),
                                   __fmul_rn(ez, snz));
        const float qt = __fadd_rn(__fadd_rn(__fmul_rn(ex, tnx),
                                             __fmul_rn(ey, tny)),
                                   __fmul_rn(ez, tnz));
        const float cs = epx_cell(qs, h[13], h[14]);
        const float ct = epx_cell(qt, h[15], h[16]);
        if (!(cs >= 0.0f && cs < (float)hi[18] && ct >= 0.0f
              && ct < (float)hi[19]))
            return total;   // in no footprint
        const unsigned long long* ms = ix.masks + hi[23] + ix.W * (int)cs;
        const unsigned long long* mt =
            ix.masks + hi[23] + ix.W * (EPX_CELLS + (int)ct);
        // [k1 stage: pairs]
#pragma unroll 1
        for (int w = 0; w < ix.W; ++w) {
            unsigned long long b = ms[w] & mt[w];
            while (b != 0ull) {
                const int k = 64 * w + __ffsll((long long)b) - 1;
                b &= b - 1ull;
                term(k);
            }
        }
        return total;
    }
#pragma unroll 1
    for (int k = 0; k < hi[20]; ++k) term(k);
    return total;
    // [k1 stage: end]
}

// Transmitter t's aperture weight as tx_gain, the phased cross-WDF through
// the index.
__device__ __forceinline__ float tx_gain_epx(const Tx& tr, int t,
                                             const Epx& ix, float lx,
                                             float ly, float px, float py,
                                             float pz, float ex, float ey,
                                             float ez, float lam) {
    const float kind = tr.m[27];
    if (kind == TX_AREA) return 1.0f;
    if (kind == TX_PHASED)
        return pair_sum_epx(ix, t, px, py, pz, -ex, -ey, -ez, lam);
    return tr.aperture(lx, ly, ex, ey, ez, lam);
}

// Ray against the unit rectangle of one prim row (to_object at cols 1..12).
__device__ __forceinline__ bool rect_hit(const float* q, float cx, float cy,
                                         float cz, float dx, float dy,
                                         float dz, float* t_out) {
    float oox = q[0] * cx + q[1] * cy + q[2] * cz + q[3];
    float ooy = q[4] * cx + q[5] * cy + q[6] * cz + q[7];
    float ooz = q[8] * cx + q[9] * cy + q[10] * cz + q[11];
    float odx = q[0] * dx + q[1] * dy + q[2] * dz;
    float ody = q[4] * dx + q[5] * dy + q[6] * dz;
    float odz = q[8] * dx + q[9] * dy + q[10] * dz;
    bool big = fabsf(odz) > F(1e-12);
    float t_p = -ooz / (big ? odz : F(1e-12));
    float px = oox + t_p * odx;
    float py = ooy + t_p * ody;
    *t_out = t_p;
    return big && fabsf(px) <= 1.0f && fabsf(py) <= 1.0f;
}

// Mesh closest hit for the receive lane: the walk is pruned by the
// analytic best `ta`; a winning triangle gives its geometric normal, its
// reflectance payload (leaf column 80) and, with ROWS, its mesh-shape row
// (column 88).  The normal is the edge cross product rounded as the plain
// version rounds it (no FMA contraction): on a face whose exact normal has
// z = 0 the rounding alone picks the sign of z, and that sign picks the
// tangent frame of the bounce, so one rounding fewer would send the
// bounce elsewhere.
__device__ __forceinline__ float cross_rn(float a, float b, float c,
                                          float d) {   // a * b - c * d
    return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

template <bool ROWS>
struct MeshClosest {
    float t = F(3.4e38), ta;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, rf = 0.0f, sid = 0.0f;
    __device__ float tbest() const { return fminf(t, ta); }
    __device__ void hit(const bvh::TriHit& h, const float* __restrict__ lr) {
        if (!(h.t < t)) return;
        float gnx = cross_rn(h.e1y, h.e2z, h.e1z, h.e2y);
        float gny = cross_rn(h.e1z, h.e2x, h.e1x, h.e2z);
        float gnz = cross_rn(h.e1x, h.e2y, h.e1y, h.e2x);
        float rn = rsqrtf(fmaxf(gnx * gnx + gny * gny + gnz * gnz,
                                F(1e-20)));
        nx = gnx * rn;
        ny = gny * rn;
        nz = gnz * rn;
        rf = __ldg(lr + 80 + h.slot);
        if constexpr (ROWS) sid = __ldg(lr + 88 + h.slot);
        t = h.t;
    }
    __device__ bool done() const { return false; }
};

// Tent splat of `val` at continuous bin yb into this thread's row.
__device__ __forceinline__ void splat(float* hist, int T, int n_time,
                                      float val, float yb) {
    if (val == 0.0f) return;
    float b0 = floorf(yb);
    if (!(b0 >= -1.0f && b0 < (float)n_time)) return;   // also drops NaN
    float b1 = b0 + 1.0f;
    int i0 = (int)b0;
    if (i0 >= 0) hist[i0 * T] += val * fmaxf(1.0f - fabsf(yb - b0), 0.0f);
    if (i0 + 1 < n_time)
        hist[(i0 + 1) * T] += val * fmaxf(1.0f - fabsf(yb - b1), 0.0f);
}

// The Doppler configuration's ADC grid: block-shared floats (mode 1) or
// global doubles (mode 2), both added to with atomics.
struct Grid {
    float* s;
    double* g;
    __device__ void add(int cell, float v) const {
        if (v == 0.0f) return;
        if (s != nullptr)
            atomicAdd(s + cell, v);
        else
            atomicAdd(g + cell, (double)v);
    }
};

// The MIMO configuration's (n_time, 2E) grid of doubles, block-shared (s)
// or global (g), and the table its lanes read: the element half-widths
// at tab[0:2], the element offsets (E, 3) from tab[2].
struct MimoGrid {
    const float* tab;
    double* s;
    double* g;
    __device__ void add(int cell, float v) const {
        if (v == 0.0f) return;
        atomicAdd((s != nullptr ? s : g) + cell, (double)v);
    }
};

template <bool MIMO> struct GridOf { using type = Grid; };
template <> struct GridOf<true> { using type = MimoGrid; };

// One tap of weight w into `cell`: the power, or I and Q interleaved.
template <bool COH>
__device__ __forceinline__ void grid_tap(const Grid& grid, int cell,
                                         float v0, float v1, float w) {
    if constexpr (COH) {
        grid.add(2 * cell, v0 * w);
        grid.add(2 * cell + 1, v1 * w);
    } else {
        grid.add(cell, v0 * w);
    }
}

// Tent splat of the power v0 (or, coherent, of I = v0 and Q = v1) at time
// coordinate yb and, on a 2-D grid, at the frequency coordinate of the
// bin frequency f_bin() (evaluated only there): (v * w_t) * w_f into up to
// four cells.
template <bool COH, class FBin>
__device__ __forceinline__ void grid_splat(const Grid& grid, const Cfg& cfg,
                                           float v0, float v1, float yb,
                                           FBin f_bin) {
    if (v0 == 0.0f && (!COH || v1 == 0.0f)) return;
    float b0 = floorf(yb);
    if (!(b0 >= -1.0f && b0 < (float)cfg.n_time)) return;  // drops NaN
    float b1 = b0 + 1.0f;
    float wt0 = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
    float wt1 = fmaxf(1.0f - fabsf(yb - b1), 0.0f);
    int i0 = (int)b0;
    if (cfg.n_freq == 1) {
        if (i0 >= 0) grid_tap<COH>(grid, i0, v0, v1, wt0);
        if (i0 + 1 < cfg.n_time) grid_tap<COH>(grid, i0 + 1, v0, v1, wt1);
        return;
    }
    float xb = (f_bin() - cfg.f_lo) / cfg.f_den * (float)cfg.n_freq - 0.5f;
    float c0 = floorf(xb);
    if (!(c0 >= -1.0f && c0 < (float)cfg.n_freq)) return;
    float c1 = c0 + 1.0f;
    float wf0 = fmaxf(1.0f - fabsf(xb - c0), 0.0f);
    float wf1 = fmaxf(1.0f - fabsf(xb - c1), 0.0f);
    int j0 = (int)c0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        int it = i0 + a;
        if (it < 0 || it >= cfg.n_time) continue;
        float wt = a ? wt1 : wt0;
        float vt0 = v0 * wt, vt1 = COH ? v1 * wt : 0.0f;
        int row = it * cfg.n_freq;
        if (j0 >= 0) grid_tap<COH>(grid, row + j0, vt0, vt1, wf0);
        if (j0 + 1 < cfg.n_freq)
            grid_tap<COH>(grid, row + j0 + 1, vt0, vt1, wf1);
    }
}

// The frequency a contribution is binned at: the beat under mix_resample
// (against the transmitter's chirp) and mixer (against the LO), else the
// received frequency.
__device__ __forceinline__ float bin_freq(const Cfg& cfg, const Wave& tx,
                                          const Wave& lo, float f_recv,
                                          float t_recv) {
    if (cfg.rule == RX_MIX) return fabsf(f_recv - tx.inst_freq(t_recv));
    if (cfg.rule == RX_MIXER) return lo.inst_freq(t_recv) - f_recv;
    return f_recv;
}

// The Doppler family's splat of one connection of power `val`: the power,
// or (COH) sqrt(max(val, 0)) (fast_cos, fast_sin) of its echo phase plus
// n_bnd boundary phases (pallas_receive.py::_coh_vals).  Returns the lane
// sum's share: the power, or the amplitude.
template <bool COH>
__device__ __forceinline__ float conn_splat(const Grid& grid, const Cfg& cfg,
                                            const Tx& tx, const Wave& lo,
                                            const float* sp, float val,
                                            float yb, float f_recv,
                                            float t_recv, float dtot,
                                            float t_emit, float k_pri,
                                            int n_bnd) {
    auto f_bin = [&] { return bin_freq(cfg, tx.w, lo, f_recv, t_recv); };
    if constexpr (COH) {
        float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit, t_recv, k_pri);
        if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
        float amp = sqrtf(fmaxf(val, 0.0f));
        grid_splat<true>(grid, cfg, amp * fast_cos(ph), amp * fast_sin(ph),
                         yb, f_bin);
        return amp;
    } else {
        grid_splat<false>(grid, cfg, val, 0.0f, yb, f_bin);
        return val;
    }
}

// The MIMO configuration's splat of one connection of power `val`: its
// echo phase plus n_bnd boundary phases, then for each element e the
// phase less 2 pi (f_recv / c) dd_e, dd_e = |v0 - r_e| - r0 from the
// lane's first vertex (v0 = x1 - o, r0 = |v0|), into the element's I / Q
// pair of both tent bins (pallas_receive.py::_coh_vals' MIMO branch and
// its channel splat).  The element term rounds each operation, as the
// plain version does.  Returns the lane sum's share, the amplitude.
__device__ float mimo_splat(const MimoGrid& grid, const Cfg& cfg,
                            const Tx& tx, const Wave& lo, const float* sp,
                            float val, float yb, float f_recv, float t_recv,
                            float dtot, float t_emit, float k_pri, int n_bnd,
                            float v0x, float v0y, float v0z, float r0) {
    float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit, t_recv, k_pri);
    if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
    float amp = sqrtf(fmaxf(val, 0.0f));
    if (val == 0.0f) return amp;
    float b0 = floorf(yb);
    if (!(b0 >= -1.0f && b0 < (float)cfg.n_time)) return amp;  // drops NaN
    float wt0 = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
    float wt1 = fmaxf(1.0f - fabsf(yb - (b0 + 1.0f)), 0.0f);
    int i0 = (int)b0;
    const int n_ch = 2 * cfg.n_elem;
    const bool lo_ok = i0 >= 0, hi_ok = i0 + 1 < cfg.n_time;
    float kf = mul_rn(F(6.283185307179586), f_recv / sp[1]);
    const float* eo = grid.tab + 2;
    for (int e = 0; e < cfg.n_elem; ++e) {
        float vx = sub_rn(v0x, eo[3 * e]);
        float vy = sub_rn(v0y, eo[3 * e + 1]);
        float vz = sub_rn(v0z, eo[3 * e + 2]);
        float re = __fsqrt_rn(fmaxf(add_rn(add_rn(mul_rn(vx, vx),
                                                  mul_rn(vy, vy)),
                                           mul_rn(vz, vz)), F(1e-20)));
        float pe = sub_rn(ph, mul_rn(kf, sub_rn(re, r0)));
        float ci = amp * fast_cos(pe), si = amp * fast_sin(pe);
        if (lo_ok) {
            grid.add(i0 * n_ch + 2 * e, ci * wt0);
            grid.add(i0 * n_ch + 2 * e + 1, si * wt0);
        }
        if (hi_ok) {
            grid.add((i0 + 1) * n_ch + 2 * e, ci * wt1);
            grid.add((i0 + 1) * n_ch + 2 * e + 1, si * wt1);
        }
    }
    return amp;
}

// Optical depth of the segment o + t d, t in [0, ln), through the
// medium (pallas_receive.py's seg_tau :399-423 and seg_tau3 :1457-1490):
// homogeneous sigma_t ln; layered, the closed form (T(z_b) - T(z_a)) / d_z
// of the cumulative profile T(z) = c_0 (z - z_min) + sum_i c_i relu(z -
// z_i), both T summed in one loop over the K steps in shared memory, or
// sigma(z_a) ln where |d_z| <= 1e-5; a grid, the 16-point midpoint
// quadrature of its nearest cells (zero outside the box), each cell one
// read-only load (the grid, at most 32 KB, stays in L1).  Every operation
// rounds as the plain version's does (no contraction): a near-horizontal
// segment divides a difference of two ~K-term sums by d_z, and a sample
// on a cell's edge picks its cell by the last bit of its coordinate.
__device__ float seg_tau(const Cfg& cfg, const float* sp, float ox, float oy,
                         float oz, float dx, float dy, float dz, float ln) {
    if (cfg.medium == 1) return mul_rn(sp[29], ln);
    if (cfg.medium == 2) {
        const int k = (int)sp[42];
        const float z0 = sp[43], dzl = sp[44];
        if (fabsf(dz) > F(1e-5)) {
            const float zb = add_rn(oz, mul_rn(dz, ln));
            float ta = mul_rn(sp[45], sub_rn(oz, z0));
            float tb = mul_rn(sp[45], sub_rn(zb, z0));
            for (int i = 1; i < k; ++i) {
                const float e = add_rn(z0, mul_rn((float)i, dzl));
                ta = add_rn(ta, mul_rn(sp[45 + i], fmaxf(sub_rn(oz, e),
                                                         0.0f)));
                tb = add_rn(tb, mul_rn(sp[45 + i], fmaxf(sub_rn(zb, e),
                                                         0.0f)));
            }
            return __fdiv_rn(sub_rn(tb, ta), dz);
        }
        float sg = sp[45];
        for (int i = 1; i < k; ++i)
            if (oz >= add_rn(z0, mul_rn((float)i, dzl)))
                sg = add_rn(sg, sp[45 + i]);
        return mul_rn(sg, ln);
    }
    const int gd = cfg.g_d, gh = cfg.g_h, gw = cfg.g_w;
    const float* __restrict__ cells = cfg.grid;
    const float sx = mul_rn(dx, ln), sy = mul_rn(dy, ln), sz = mul_rn(dz, ln);
    float tot = 0.0f;
    for (int j = 0; j < 16; ++j) {
        const float tk = ((float)j + 0.5f) * 0.0625f;   // exact
        float qx = mul_rn(sub_rn(add_rn(ox, mul_rn(sx, tk)), sp[43]), sp[46]);
        float qy = mul_rn(sub_rn(add_rn(oy, mul_rn(sy, tk)), sp[44]), sp[47]);
        float qz = mul_rn(sub_rn(add_rn(oz, mul_rn(sz, tk)), sp[45]), sp[48]);
        if (qx >= 0.0f && qx <= 1.0f && qy >= 0.0f && qy <= 1.0f
            && qz >= 0.0f && qz <= 1.0f) {
            int ix = min((int)floorf(mul_rn(qx, (float)gw)), gw - 1);
            int iy = min((int)floorf(mul_rn(qy, (float)gh)), gh - 1);
            int iz = min((int)floorf(mul_rn(qz, (float)gd)), gd - 1);
            tot = add_rn(tot, __ldg(cells + (iz * gh + iy) * gw + ix));
        }
    }
    return mul_rn(mul_rn(tot, ln), 0.0625f);
}

// Traces one lane.  In the mesh and Doppler configurations it returns the
// sum of the lane's contributions, which a parity run reads per lane
// (`lane_val`): a ray that meets a triangle edge may, with one rounding
// fewer under FMA contraction, take the neighbouring face or slip between
// the two, and the per-lane sums show which lanes did.  In the coherent
// configuration a lane's sum is of its amplitudes sqrt(max(power, 0)):
// they bound how far a lane on another path can move a cell's I or Q
// (MIMO: the same amplitudes, shared by every element's pair).
template <bool MESH, bool DOP, bool COH, bool MIMO = false, bool MED = false,
          bool EP = false, bool LOB = false>
__device__ float trace_lane(const Cfg& cfg, const float* sp,
                            const float* prim, const float* msh,
                            const Tx& tx, const Wave& lo,
                            const bvh::Tables& mesh, Draws<DOP>& dr,
                            float* hist, int T,
                            const typename GridOf<MIMO>::type& grid,
                            unsigned int* events) {
    const float TP = F(6.283185307179586);
    const float cvel = sp[1];
    const float* rxm = sp + 2;
    const float rx_wx = sp[14], rx_wy = sp[15];
    const float n_time_f = (float)cfg.n_time;
    const float t_start = cfg.t_start, t_window = cfg.t_window;

    // ---------------- receive-ray generation (draws 0..n_ray) ----------
    float t_rx0 = cfg.gate ? 0.0f : t_start + dr.get(0) * t_window;
    // the receive frequency by receive type, read at mid-window under
    // gate sampling; a frequency or beat draw comes before the ray draws
    int r0 = 1;
    float f_rx = cfg.f_rx;
    if constexpr (DOP) {
        float t_mid = t_rx0 + (cfg.gate ? 0.5f * t_window : 0.0f);
        if (cfg.rule == RX_MIX) {
            f_rx = tx.w.inst_freq(t_mid);
        } else if (cfg.rule == RX_RAW_LO) {
            f_rx = lo.inst_freq(t_mid);
        } else if (cfg.rule == RX_MIXER) {
            f_rx = lo.inst_freq(t_mid) - (cfg.f_lo + dr.get(1) * cfg.f_span);
            r0 = 2;
        } else if (cfg.n_freq > 1) {
            f_rx = cfg.f_lo + dr.get(1) * cfg.f_span;
            r0 = 2;
        }
    }
    float ox, oy, oz, dx, dy, dz, thr;
    int base;
    if constexpr (MIMO) {
        // the phased array: draws r0, r0 + 1 (a point on its rectangle)
        // are not used, as MIMO rays leave the array's origin over the
        // cosine hemisphere about its normal, weighted by one element's
        // pattern gain x area (pallas_receive.py:465-513)
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float u3 = dr.get(r0 + 2), u4 = dr.get(r0 + 3);
        float rr = sqrtf(u3);
        float ph = TP * u4;
        float tx_ = rr * fast_cos(ph), ty_ = rr * fast_sin(ph);
        float tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float s1x = 1.0f + sign * nzx * nzx * a, s1y = sign * b,
              s1z = -sign * nzx;
        float s2x = b, s2y = sign + nzy * nzy * a, s2z = -nzy;
        dx = s1x * tx_ + s2x * ty_ + nzx * tz;
        dy = s1y * tx_ + s2y * ty_ + nzy * tz;
        dz = s1z * tx_ + s2z * ty_ + nzz * tz;
        float iwx = 1.0f / fmaxf(rx_wx, F(1e-20));
        float iwy = 1.0f / fmaxf(rx_wy, F(1e-20));
        float lam = cvel / fmaxf(f_rx, F(1e-6));
        float nu_x = (dx * (rxm[0] * iwx) + dy * (rxm[4] * iwx)
                      + dz * (rxm[8] * iwx)) / lam;
        float nu_y = (dx * (rxm[1] * iwy) + dy * (rxm[5] * iwy)
                      + dz * (rxm[9] * iwy)) / lam;
        float wex = grid.tab[0], wey = grid.tab[1];
        thr = F(16.0 * 3.141592653589793) * wex * wey
              * sinc_f(TP * nu_x * wex) * sinc_f(TP * nu_y * wey) * sp[32];
        ox = rxm[3] + F(1e-4) * nzx;
        oy = rxm[7] + F(1e-4) * nzy;
        oz = rxm[11] + F(1e-4) * nzz;
        base = r0 + 4;
    } else if (EP && cfg.rx_phased) {
        // the analog phased array (pallas_receive.py:465-513, 1111-1119):
        // a point uniform over its bounding rectangle (half-extents
        // sp[30:32]), the cosine hemisphere about its normal, weighted by
        // pi x its area and its cross-WDF at the ray
        float u1 = dr.get(r0), u2 = dr.get(r0 + 1);
        float iwx = 1.0f / fmaxf(rx_wx, F(1e-20));
        float iwy = 1.0f / fmaxf(rx_wy, F(1e-20));
        float snx = rxm[0] * iwx, sny = rxm[4] * iwx, snz = rxm[8] * iwx;
        float tnx = rxm[1] * iwy, tny = rxm[5] * iwy, tnz = rxm[9] * iwy;
        float lxr = (2.0f * u1 - 1.0f) * sp[30];
        float lyr = (2.0f * u2 - 1.0f) * sp[31];
        ox = rxm[3] + lxr * snx + lyr * tnx;
        oy = rxm[7] + lxr * sny + lyr * tny;
        oz = rxm[11] + lxr * snz + lyr * tnz;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float u3 = dr.get(r0 + 2), u4 = dr.get(r0 + 3);
        float rr = sqrtf(u3);
        float ph = TP * u4;
        float tx_ = rr * fast_cos(ph), ty_ = rr * fast_sin(ph);
        float tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float s1x = 1.0f + sign * nzx * nzx * a, s1y = sign * b,
              s1z = -sign * nzx;
        float s2x = b, s2y = sign + nzy * nzy * a, s2z = -nzy;
        dx = s1x * tx_ + s2x * ty_ + nzx * tz;
        dy = s1y * tx_ + s2y * ty_ + nzy * tz;
        dz = s1z * tx_ + s2z * ty_ + nzz * tz;
        float lam = cvel / fmaxf(f_rx, F(1e-6));
        float w0 = F(4.0 * 3.141592653589793) * sp[30] * sp[31] * sp[32];
        ox = ox + F(1e-4) * nzx;
        oy = oy + F(1e-4) * nzy;
        oz = oz + F(1e-4) * nzz;
        thr = w0 * pair_sum(cfg.rxph, cfg.n_rx_pairs, snx, sny, snz, tnx,
                            tny, tnz, rxm[3], rxm[7], rxm[11], ox, oy, oz, dx,
                            dy, dz, lam);
        base = r0 + 4;
    } else if (cfg.omni) {
        ox = rxm[3];
        oy = rxm[7];
        oz = rxm[11];
        float u1 = dr.get(r0), u2 = dr.get(r0 + 1);
        float z = 1.0f - 2.0f * u1;
        float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        float ph = TP * u2;
        dx = r * fast_cos(ph);
        dy = r * fast_sin(ph);
        dz = z;
        thr = F(4.0 * 3.141592653589793) * sp[32];
        base = r0 + 2;
    } else {
        float u1 = dr.get(r0), u2 = dr.get(r0 + 1);
        float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
        ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
        oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
        oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float u3 = dr.get(r0 + 2), u4 = dr.get(r0 + 3);
        float area = 4.0f * rx_wx * rx_wy;
        float tx_, ty_, tz, w0;
        if (MESH && cfg.patch_p > 0) {
            // stratified cosine hemisphere: the tile's cell plus the
            // lane's jitter; cos pdf, weight pi * area
            const long long P = cfg.patch_p;
            long long patch = ((dr.lane / 1024) * 131 + (int)sp[0])
                              % (P * P);
            u3 = ((float)(patch % P) + u3) * (float)(1.0 / (double)P);
            u4 = ((float)(patch / P) + u4) * (float)(1.0 / (double)P);
            float rr = sqrtf(u3);
            float ph = TP * u4;
            tx_ = rr * fast_cos(ph);
            ty_ = rr * fast_sin(ph);
            tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
            w0 = F(3.141592653589793) * area * sp[32];
        } else {
            float lam0 = cvel / fmaxf(f_rx, F(1e-6));
            float w_mn = fminf(rx_wx, rx_wy);
            float q = 2.0f * w_mn / (F(0.6) * lam0);
            float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
            bool pick = u3 >= 0.5f;
            float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
            float ph = TP * u4;
            float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
            float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / (k_l + 1.0f));
            tz = pick ? ct_l : ct_c;
            float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
            tx_ = st * fast_cos(ph);
            ty_ = st * fast_sin(ph);
            float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
            float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                          + 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586)
                            * cosk;
            w0 = (tz / fmaxf(pdf_d, F(1e-30))) * area * sp[32];
        }
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float s1x = 1.0f + sign * nzx * nzx * a, s1y = sign * b,
              s1z = -sign * nzx;
        float s2x = b, s2y = sign + nzy * nzy * a, s2z = -nzy;
        dx = s1x * tx_ + s2x * ty_ + nzx * tz;
        dy = s1y * tx_ + s2y * ty_ + nzy * tz;
        dz = s1z * tx_ + s2z * ty_ + nzz * tz;
        float lam = cvel / fmaxf(f_rx, F(1e-6));
        float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                     / fmaxf(rx_wx, F(1e-9)) / lam;
        float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                     / fmaxf(rx_wy, F(1e-9)) / lam;
        float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
        thr = w0 * (4.0f * trx * try_ * sinc_f(TP * nu_x * rx_wx * trx)
                    * sinc_f(TP * nu_y * rx_wy * try_));
        ox = ox + F(1e-4) * nzx;
        oy = oy + F(1e-4) * nzy;
        oz = oz + F(1e-4) * nzz;
        base = r0 + 4;
    }

    // cumulative Doppler factor (f_received = f_emitted * dop), the
    // receiver's motion first; exactly 1 in a static scene
    float dop = 1.0f;
    if constexpr (DOP) dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25])
                                    / cvel;

    float cx = ox, cy = oy, cz = oz;
    float plen = 0.0f;
    float lane_sum = 0.0f;
    bool wdel = false;   // the last bounce was a mirror (Doppler family)
    // MIMO: the first vertex less the origin, and its length
    float v0x = 0.0f, v0y = 0.0f, v0z = 0.0f, r0m = 0.0f;
    for (int depth = 0; depth < cfg.max_depth; ++depth) {
        // draws of this depth: u_dh, u5, u6, u7 (EP: three a
        // transmitter), then u8, u9 (LOB: then the lobe pick, the
        // lobe-mix pick)
        const int d0 = base + (EP ? 3 + 3 * cfg.n_tx
                                  : LOB ? 6 + ((cfg.lobes & LOBE_PICK) != 0)
                                              + ((cfg.lobes & LOBE_BLEND) != 0)
                                        : 6) * depth;
        // ---- closest hit over the rectangles ----
        float tb = F(3.4e38), nx = 0.0f, ny = 0.0f, nz = 0.0f, rb = 0.0f,
              txc = -1.0f;
        // the hit's lobe (type, GGX alpha, conductor eta / k) and velocity
        float kb = 0.0f, ab = F(0.1), eb = 0.0f, kk = 0.0f, vbx = 0.0f,
              vby = 0.0f, vbz = 0.0f;
        // LOB: the winning prim row, whose columns 27-33 hold a
        // composite's second lobe (-1: a mesh hit, one lobe)
        int pw = -1;
        for (int p = 0; p < cfg.n_prims; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            float t_p;
            bool hit_p = rect_hit(row + 1, cx, cy, cz, dx, dy, dz, &t_p);
            if (hit_p && t_p > F(1e-4) && t_p < tb) {
                const float* q = row + 1;
                float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                           + q[10] * q[10], F(1e-20)));
                tb = t_p;
                nx = q[8] * rnorm;
                ny = q[9] * rnorm;
                nz = q[10] * rnorm;
                rb = row[13];
                txc = row[14];
                if constexpr (DOP) {
                    kb = row[18];
                    ab = row[15];
                    eb = row[16];
                    kk = row[17];
                    vbx = row[19];
                    vby = row[20];
                    vbz = row[21];
                }
                if constexpr (LOB) pw = p;
            }
        }
        if constexpr (MESH) {
            MeshClosest<DOP> mc;
            mc.ta = tb;
            bvh::walk(lane_tables<DOP>(mesh, cfg),
                      bvh::make_ray(cx, cy, cz, dx, dy, dz), mc);
            if (mc.t < tb) {
                tb = mc.t;
                nx = mc.nx;
                ny = mc.ny;
                nz = mc.nz;
                rb = mc.rf;
                txc = -1.0f;
                if constexpr (DOP) {
                    int sid = min(max((int)mc.sid, 0), cfg.n_msh - 1);
                    const float* r = msh + MSH_COLS * sid;
                    kb = r[6];
                    ab = r[3];
                    eb = r[4];
                    kk = r[5];
                    vbx = r[0];
                    vby = r[1];
                    vbz = r[2];
                }
                if constexpr (LOB) pw = -1;
            }
        }
        if (!(tb < F(3.4e37))) break;     // miss: the lane is dead
        plen = plen + tb;
        // ambient absorption along the segment
        if constexpr (MED)
            thr = thr * expf(-seg_tau(cfg, sp, cx, cy, cz, dx, dy, dz, tb));
        float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
        const bool is_ggx = DOP && kb == ROUGH_CONDUCTOR;
        const bool is_m = DOP && cfg.mirror && kb == CONDUCTOR;
        // LOB: a composite's first-lobe weight (1 on a plain row), and
        // whether NEE leaves the hit: not from a delta lobe, unless a
        // composite's other lobe may connect
        float wmx = 1.0f;
        bool lobe_nee = false;
        if constexpr (LOB) {
            if (pw >= 0) wmx = prim[pw * PRIM_COLS + 33];
            lobe_nee = txc < 0.0f
                       && !((is_m || kb == DIELECTRIC
                             || kb == THIN_DIELECTRIC) && !(wmx < 1.0f));
        }
        if constexpr (MIMO) {
            if (depth == 0) {
                v0x = hx - cx;
                v0y = hy - cy;
                v0z = hz - cz;
                r0m = __fsqrt_rn(fmaxf(add_rn(add_rn(mul_rn(v0x, v0x),
                                                     mul_rn(v0y, v0y)),
                                              mul_rn(v0z, v0z)), F(1e-20)));
            }
        }

        // ---- direct transmitter hits: at depth 0, and after a mirror
        //      bounce (NEE covers the rest); EP: the transmitter the lane
        //      hit, with its kind's aperture weight ----
        if constexpr (EP) {
            if ((depth == 0 || wdel) && txc >= 0.0f) {
              const int t = (int)txc;
              const Tx tr = tx_row(tx.m + t * TXP_COLS);
              float cos_dh = -(dx * tr.nx + dy * tr.ny + dz * tr.nz);
              if (cos_dh > 0.0f) {
                const float* m = tr.m;
                float te_h, tr_h, wg_h, k_h = 0.0f;
                tr.emission(plen / cvel, dr.get(d0), t_rx0, cfg.gate,
                            t_start, t_window, &te_h, &tr_h, &wg_h,
                            COH ? &k_h : nullptr);
                float fe_h = tr.inst_freq(te_h);
                float sig_h = tr.eval_wdf(te_h, fe_h);
                float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                             + (hz - m[11]) * m[8])
                            / fmaxf(tr.wx * tr.wx, F(1e-12));
                float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                             + (hz - m[11]) * m[9])
                            / fmaxf(tr.wy * tr.wy, F(1e-12));
                float ap_h = tx_gain(tr, t, cfg, lxh, lyh, hx, hy, hz, dx, dy,
                                     dz, lam_h);
                float w_dh = sig_h * tr.gain * ap_h * TP;
                float val_h = thr * w_dh * wg_h;
                float yb_h = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                float lv = val_h;   // the lane sum's share
                if constexpr (MIMO)
                    lv = mimo_splat(grid, cfg, tr, lo, sp, val_h, yb_h,
                                    fe_h * dop, tr_h, plen, te_h, k_h, 0,
                                    v0x, v0y, v0z, r0m);
                else if constexpr (DOP)
                    lv = conn_splat<COH>(grid, cfg, tr, lo, sp, val_h, yb_h,
                                         fe_h * dop, tr_h, plen, te_h, k_h,
                                         0);
                else
                    splat(hist, T, cfg.n_time, val_h, yb_h);
                *events += val_h != 0.0f;
                if constexpr (MESH || DOP) lane_sum += lv;
              }
            }
        } else if (depth == 0 || wdel) {
            float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
            if (txc == 0.0f && cos_dh > 0.0f) {
                const float* m = tx.m;
                float te_h, tr_h, wg_h, k_h = 0.0f;
                tx.emission(plen / cvel, dr.get(d0), t_rx0, cfg.gate,
                            t_start, t_window, &te_h, &tr_h, &wg_h,
                            COH ? &k_h : nullptr);
                float fe_h = tx.inst_freq(te_h);
                float sig_h = tx.eval_wdf(te_h, fe_h);
                float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                             + (hz - m[11]) * m[8])
                            / fmaxf(tx.wx * tx.wx, F(1e-12));
                float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                             + (hz - m[11]) * m[9])
                            / fmaxf(tx.wy * tx.wy, F(1e-12));
                float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                float w_dh = sig_h * tx.gain * ap_h * TP;
                float val_h = thr * w_dh * wg_h;
                float yb_h = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                float lv = val_h;   // the lane sum's share
                if constexpr (MIMO)
                    lv = mimo_splat(grid, cfg, tx, lo, sp, val_h, yb_h,
                                    fe_h * dop, tr_h, plen, te_h, k_h, 0,
                                    v0x, v0y, v0z, r0m);
                else if constexpr (DOP)
                    lv = conn_splat<COH>(grid, cfg, tx, lo, sp, val_h, yb_h,
                                         fe_h * dop, tr_h, plen, te_h, k_h,
                                         0);
                else
                    splat(hist, T, cfg.n_time, val_h, yb_h);
                *events += val_h != 0.0f;
                if constexpr (MESH || DOP) lane_sum += lv;
            }
        }

        // ---- NEE to the transmitter (only from non-transmitter hits; a
        //      mirror's delta lobe has no density toward it); EP: to every
        //      transmitter in row order, each with its three draws, its
        //      kind's aperture weight and its own shadow test ----
        if constexpr (EP) {
#pragma unroll 1
            for (int t = 0; t < cfg.n_tx && txc < 0.0f && !is_m; ++t) {
                const Tx tr = tx_row(tx.m + t * TXP_COLS);
                const float* m = tr.m;
                const int dn = d0 + 1 + 3 * t;
                float glx = 2.0f * dr.get(dn) - 1.0f;
                float gly = 2.0f * dr.get(dn + 1) - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tr.nx + wy_ * tr.ny + wz_ * tr.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tr.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float f_cos;
                    if (is_ggx) {
                        f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx, -dy,
                                         -dz, wx_, wy_, wz_);
                    } else {
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        f_cos = rb * F(1.0 / 3.141592653589793)
                                * fmaxf(co, 0.0f);
                    }
                    float t_emit, t_recv, w_gate, k_nee = 0.0f;
                    tr.emission((plen + dist) / cvel, dr.get(dn + 2), t_rx0,
                                cfg.gate, t_start, t_window, &t_emit, &t_recv,
                                &w_gate, COH ? &k_nee : nullptr);
                    float f_emit = tr.inst_freq(t_emit);
                    float sig = tr.eval_wdf(t_emit, f_emit);
                    float ap = tx_gain(tr, t, cfg, glx, gly, qx, qy, qz, wx_,
                                       wy_, wz_,
                                       cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tr.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    bool occ = false;
                    for (int p = 0; p < cfg.n_prims && !occ; ++p) {
                        const float* row = prim + p * PRIM_COLS;
                        // transmitter t's own rectangle (t in column 14)
                        // never occludes its NEE; the others' do
                        if (row[14] == (float)t || (int)row[0] != RECTANGLE)
                            continue;
                        float t_p;
                        bool hit_p = rect_hit(row + 1, sx, sy, sz, wx_, wy_,
                                              wz_, &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    if constexpr (MESH) {
                        if (!occ) {
                            bvh::Any sh;
                            sh.limit = limit;
                            bvh::walk(lane_tables<DOP>(mesh, cfg),
                                      bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),
                                      sh);
                            occ = sh.occ;
                        }
                    }
                    if (!occ && pdf_sa > 0.0f) {
                        float val = thr * f_cos * w_tx * w_gate
                                    / fmaxf(pdf_sa, F(1e-30));
                        float yb = (t_recv - t_start) / t_window * n_time_f
                                   - 0.5f;
                        float lv = val;
                        if constexpr (DOP) {
                            // connection Doppler: the vertex's bounce and the
                            // transmitter's motion; the phase adds the
                            // boundary phase of depth + 1 vertices
                            float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                    + (wy_ - dy) * vby
                                                    + (wz_ - dz) * vbz) / cvel;
                            float dop_tx = 1.0f - (wx_ * tr.vx + wy_ * tr.vy
                                                   + wz_ * tr.vz) / cvel;
                            if constexpr (MIMO)
                                lv = mimo_splat(
                                    grid, cfg, tr, lo, sp, val, yb,
                                    f_emit * dop * dop_vtx * dop_tx, t_recv,
                                    plen + dist, t_emit, k_nee, depth + 1,
                                    v0x, v0y, v0z, r0m);
                            else
                                lv = conn_splat<COH>(
                                    grid, cfg, tr, lo, sp, val, yb,
                                    f_emit * dop * dop_vtx * dop_tx, t_recv,
                                    plen + dist, t_emit, k_nee, depth + 1);
                        } else {
                            splat(hist, T, cfg.n_time, val, yb);
                        }
                        *events += val != 0.0f;
                        if constexpr (MESH || DOP) lane_sum += lv;
                    }
                }
            }
        } else if (LOB ? lobe_nee : (txc < 0.0f && !is_m)) {
            const float* m = tx.m;
            float glx = 2.0f * dr.get(d0 + 1) - 1.0f;
            float gly = 2.0f * dr.get(d0 + 2) - 1.0f;
            float qx = m[0] * glx + m[1] * gly + m[3];
            float qy = m[4] * glx + m[5] * gly + m[7];
            float qz = m[8] * glx + m[9] * gly + m[11];
            float vx = qx - hx, vy = qy - hy, vz = qz - hz;
            float dist2 = vx * vx + vy * vy + vz * vz;
            float dist = sqrtf(fmaxf(dist2, F(1e-20)));
            float inv_d = 1.0f / dist;
            float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
            float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
            if (cos_tx > F(1e-6)) {
                float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                               / fmaxf(cos_tx, F(1e-6));
                float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                float f_cos;
                if constexpr (LOB) {
                    // [k1 stage: lobe_nee]
                    // the hit's lobe; a composite's mix w f0 + (1 - w) f1
                    // with its second lobe read from the prim row (a
                    // mask's is a zero diffuse one)
                    f_cos = lobe_fcos(kb, rb, ab, eb, kk, nx, ny, nz, -dx,
                                      -dy, -dz, wx_, wy_, wz_);
                    if (wmx < 1.0f) {
                        const float* r1 = prim + pw * PRIM_COLS;
                        float f1 = lobe_fcos(r1[28], r1[29], r1[30], r1[31],
                                             r1[32], nx, ny, nz, -dx, -dy,
                                             -dz, wx_, wy_, wz_);
                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;
                    }
                    // [k1 stage: nee]
                } else if (is_ggx) {
                    f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx, -dy,
                                     -dz, wx_, wy_, wz_);
                } else {
                    float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                    float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                               + wz_ * (nz * sg);
                    f_cos = rb * F(1.0 / 3.141592653589793)
                            * fmaxf(co, 0.0f);
                }
                float t_emit, t_recv, w_gate, k_nee = 0.0f;
                tx.emission((plen + dist) / cvel, dr.get(d0 + 3), t_rx0,
                            cfg.gate, t_start, t_window, &t_emit, &t_recv,
                            &w_gate, COH ? &k_nee : nullptr);
                float f_emit = tx.inst_freq(t_emit);
                float sig = tx.eval_wdf(t_emit, f_emit);
                float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                       cvel / fmaxf(f_emit, F(1e-6)));
                float w_tx = sig * tx.gain * ap * TP;
                float off = F(1e-4) * sign0(cos_s);
                float sx = hx + off * nx, sy = hy + off * ny,
                      sz = hz + off * nz;
                float limit = dist * F(0.999);
                bool occ = false;
                for (int p = 0; p < cfg.n_prims && !occ; ++p) {
                    const float* row = prim + p * PRIM_COLS;
                    // the transmitter's own rectangle (tx index 0 in
                    // column 14) never occludes its NEE
                    if (row[14] == 0.0f || (int)row[0] != RECTANGLE)
                        continue;
                    float t_p;
                    bool hit_p = rect_hit(row + 1, sx, sy, sz, wx_, wy_,
                                          wz_, &t_p);
                    occ = hit_p && t_p > F(1e-4) && t_p < limit;
                }
                if constexpr (MESH) {
                    // LOB: as the JAX kernel's walk, none from a delta
                    // lobe (a composite's other lobe connects unshadowed
                    // by the mesh there)
                    if (!occ && !(LOB && (is_m || kb == DIELECTRIC
                                          || kb == THIN_DIELECTRIC))) {
                        bvh::Any sh;
                        sh.limit = limit;
                        bvh::walk(lane_tables<DOP>(mesh, cfg),
                                  bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),
                                  sh);
                        occ = sh.occ;
                    }
                }
                if (!occ && pdf_sa > 0.0f) {
                    float val = thr * f_cos * w_tx * w_gate
                                / fmaxf(pdf_sa, F(1e-30));
                    // ambient absorption along the connection
                    if constexpr (MED)
                        val = val * expf(-seg_tau(cfg, sp, hx, hy, hz, wx_,
                                                  wy_, wz_, dist));
                    float yb = (t_recv - t_start) / t_window * n_time_f
                               - 0.5f;
                    float lv = val;
                    if constexpr (DOP) {
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion; the phase adds the
                        // boundary phase of depth + 1 vertices
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        if constexpr (MIMO)
                            lv = mimo_splat(grid, cfg, tx, lo, sp, val, yb,
                                            f_emit * dop * dop_vtx * dop_tx,
                                            t_recv, plen + dist, t_emit,
                                            k_nee, depth + 1, v0x, v0y, v0z,
                                            r0m);
                        else
                            lv = conn_splat<COH>(
                                grid, cfg, tx, lo, sp, val, yb,
                                f_emit * dop * dop_vtx * dop_tx, t_recv,
                                plen + dist, t_emit, k_nee, depth + 1);
                    } else {
                        splat(hist, T, cfg.n_time, val, yb);
                    }
                    *events += val != 0.0f;
                    if constexpr (MESH || DOP) lane_sum += lv;
                }
            }
        }

        if (depth == cfg.max_depth - 1) break;
        if constexpr (!DOP) {
            if (!(rb > 0.0f) || !(txc < 0.0f)) break;   // absorbed / tx

            // ---- diffuse bounce: cosine hemisphere about the flipped
            //      normal ----
            // (EP: after each transmitter's three NEE draws)
            const int db = EP ? d0 + 1 + 3 * cfg.n_tx : d0 + 4;
            float u8 = dr.get(db), u9 = dr.get(db + 1);
            float face = -(dx * nx + dy * ny + dz * nz);
            float sgn = sgn_ge(face);
            float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
            float sign = sgn_ge(fz);
            float a2 = -1.0f / (sign + fz);
            float b2 = fx * fy * a2;
            float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                  s1z = -sign * fx;
            float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
            float rr2 = sqrtf(u8);
            float ph2 = TP * u9;
            float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
            float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
            dx = s1x * bx + s2x * by + fx * bz;
            dy = s1y * bx + s2y * by + fy * bz;
            dz = s1z * bx + s2z * by + fz * bz;
            thr = thr * rb;
            cx = hx + F(1e-4) * fx;
            cy = hy + F(1e-4) * fy;
            cz = hz + F(1e-4) * fz;
        } else if constexpr (LOB) {
            if (!(txc < 0.0f)) break;                   // on the tx

            // ---- bounce of the hit's lobe (pallas_receive.py:1912-2226):
            //      a composite first picks its lobe; then a mask's pass, a
            //      mirror, a smooth or thin dielectric's reflection or
            //      refraction, a GGX half vector (rough conductor, rough
            //      plastic's coat, GGX glass) or the cosine hemisphere
            //      (diffuse, plastic's base) about the flipped normal ----
            const int db = d0 + 4;
            float u8 = dr.get(db), u9 = dr.get(db + 1);
            bool pass = false;
            // [k1 stage: pick]
            if (wmx < 1.0f
                && !(dr.get(db + 2 + ((cfg.lobes & LOBE_PICK) != 0)) < wmx)) {
                // the second lobe; a mask's passes the ray straight on (a
                // delta null transmission, weight 1)
                const float* r1 = prim + pw * PRIM_COLS;
                pass = r1[27] == 2.0f;
                kb = r1[28];
                rb = r1[29];
                ab = r1[30];
                eb = r1[31];
                kk = r1[32];
            }
            // [k1 stage: bounce]
            float face = -(dx * nx + dy * ny + dz * nz);
            float sgn = sgn_ge(face);
            float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
            float sign = sgn_ge(fz);
            float a2 = -1.0f / (sign + fz);
            float b2 = fx * fy * a2;
            float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                  s1z = -sign * fx;
            float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
            float ph2 = TP * u9;
            float ndx, ndy, ndz, w_b;
            bool del = false;   // a delta bounce: direct hits at the next
            if (pass) {
                ndx = dx;
                ndy = dy;
                ndz = dz;
                w_b = 1.0f;
                del = true;
            } else if (cfg.mirror && kb == CONDUCTOR) {
                // [k1 stage: mirror]
                float dn = dx * fx + dy * fy + dz * fz;
                ndx = dx - 2.0f * dn * fx;
                ndy = dy - 2.0f * dn * fy;
                ndz = dz - 2.0f * dn * fz;
                w_b = rb * fres_cond(fabsf(dn), eb, kk);
                del = true;
            } else if (kb == DIELECTRIC || kb == THIN_DIELECTRIC) {
                // [k1 stage: diel]
                // the Fresnel of the unflipped cosine picks by u8: reflect
                // about n, or refract (thin: pass straight on)
                float eta_it, cos_t;
                float f_d = fres_diel_full(face, eb, &eta_it, &cos_t);
                bool refl = kb == DIELECTRIC
                                ? u8 < f_d
                                : u8 < (f_d < 1.0f ? 2.0f * f_d / (1.0f + f_d)
                                                   : 1.0f);
                if (refl) {
                    ndx = dx + 2.0f * face * nx;
                    ndy = dy + 2.0f * face * ny;
                    ndz = dz + 2.0f * face * nz;
                    w_b = kb == DIELECTRIC ? rb : 1.0f;
                } else if (kb == DIELECTRIC) {
                    // the refraction: transmittance (k) x the radiance
                    // compression 1 / eta^2
                    float scl = 1.0f / eta_it;
                    float coef = scl * face - sgn_ge(face) * cos_t;
                    ndx = scl * dx + coef * nx;
                    ndy = scl * dy + coef * ny;
                    ndz = scl * dz + coef * nz;
                    w_b = kk * scl * scl;
                } else {
                    ndx = dx;
                    ndy = dy;
                    ndz = dz;
                    w_b = 1.0f;
                }
                del = true;
            } else if (kb == ROUGH_CONDUCTOR || kb == ROUGH_PLASTIC
                       || kb == ROUGH_DIELECTRIC) {
                // [k1 stage: ggx]
                // the GGX half vector hw about the flipped normal and its
                // reflection wg of the ray
                float ag2 = ab * ab;
                float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                float cth = rsqrtf(1.0f + tan2);
                float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                float hlx = sth * fast_cos(ph2), hly = sth * fast_sin(ph2);
                float hwx = s1x * hlx + s2x * hly + fx * cth;
                float hwy = s1y * hlx + s2y * hly + fy * cth;
                float hwz = s1z * hlx + s2z * hly + fz * cth;
                float ci_b = fabsf(face);
                float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                ndx = 2.0f * idoth * hwx + dx;
                ndy = 2.0f * idoth * hwy + dy;
                ndz = 2.0f * idoth * hwz + dz;
                if (kb == ROUGH_CONDUCTOR) {
                    // weight refl F G (wi.h) / (cos_i h.n)
                    float co_g = ndx * fx + ndy * fy + ndz * fz;
                    float f_b = fres_cond(fabsf(idoth), eb, kk);
                    float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                    w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth,
                                                         F(1e-8));
                    if (!(co_g > 0.0f && idoth > 0.0f)) w_b = 0.0f;
                } else if (kb == ROUGH_PLASTIC) {
                    // the coat (wg) with probability spec_w, else the
                    // diffuse base; the weight is f / pdf of both lobes
                    float fi = fres_diel(ci_b, eb);
                    float spec_w = fminf(fmaxf(fi, F(0.05)), F(0.95));
                    if (!(dr.get(db + 2) < spec_w)) {
                        float rr2 = sqrtf(u8);
                        float bx = rr2 * fast_cos(ph2),
                              by = rr2 * fast_sin(ph2);
                        float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                        ndx = s1x * bx + s2x * by + fx * bz;
                        ndy = s1y * bx + s2y * by + fy * bz;
                        ndz = s1z * bx + s2z * by + fz * bz;
                    }
                    float co_r = ndx * fx + ndy * fy + ndz * fz;
                    float h2x = -dx + ndx, h2y = -dy + ndy, h2z = -dz + ndz;
                    float hc2 = half_toward(&h2x, &h2y, &h2z, fx, fy, fz);
                    float dd2 = hc2 * hc2 * (ag2 - 1.0f) + 1.0f;
                    float d_r = ag2 / fmaxf(F(3.141592653589793) * dd2 * dd2,
                                            F(1e-20));
                    float g_r = g1(ci_b, ag2) * g1(fabsf(co_r), ag2);
                    float idoth2 = -dx * h2x + -dy * h2y + -dz * h2z;
                    float f_val = rb * F(1.0 / 3.141592653589793)
                                      * fmaxf(co_r, 0.0f) * (1.0f - fi)
                                      * (1.0f - fres_diel(co_r, eb))
                                  + fres_diel(fabsf(idoth2), eb) * d_r * g_r
                                        / fmaxf(4.0f * ci_b, F(1e-8));
                    float odoth2 = fabsf(ndx * h2x + ndy * h2y + ndz * h2z);
                    float pdf_r = (1.0f - spec_w) * fmaxf(co_r, 0.0f)
                                      * F(1.0 / 3.141592653589793)
                                  + spec_w * d_r * hc2
                                        / fmaxf(4.0f * odoth2, F(1e-8));
                    w_b = (co_r > 0.0f && ci_b > F(1e-6))
                              ? f_val / fmaxf(pdf_r, F(1e-20))
                              : 0.0f;
                } else {
                    // GGX glass: reflect (wg) or refract through hw by its
                    // Fresnel, the relative IOR by the side the ray came
                    // from; the weight is the eval-consistent f cos / pdf
                    float eta_i2, cost_h;
                    float f_h = fres_diel_full(idoth * sgn, eb, &eta_i2,
                                               &cost_h);
                    bool pick_rf = dr.get(db + 2) < f_h;
                    if (!pick_rf) {
                        float inv_e2 = 1.0f / eta_i2;
                        float coef_t = (inv_e2 * fabsf(idoth) - cost_h)
                                       * sgn_ge(idoth);
                        float ttx = coef_t * hwx - (-dx) * inv_e2;
                        float tty = coef_t * hwy - (-dy) * inv_e2;
                        float ttz = coef_t * hwz - (-dz) * inv_e2;
                        float ttn = rsqrtf(fmaxf(ttx * ttx + tty * tty
                                                 + ttz * ttz, F(1e-20)));
                        ndx = ttx * ttn;
                        ndy = tty * ttn;
                        ndz = ttz * ttn;
                    }
                    float p_c;
                    float f_c = rd_fcos_pdf(face, fx, fy, fz, eb, kk, rb, ab,
                                            -dx, -dy, -dz, ndx, ndy, ndz,
                                            &p_c);
                    float co_rd = ndx * fx + ndy * fy + ndz * fz;
                    float odh_s = ndx * hwx + ndy * hwy + ndz * hwz;
                    bool ok = (pick_rf ? co_rd : -co_rd) > 0.0f
                              && idoth > 0.0f && odh_s * co_rd > 0.0f;
                    w_b = ok && p_c > 0.0f ? f_c / fmaxf(p_c, F(1e-20))
                                           : 0.0f;
                }
            } else {
                // [k1 stage: diffuse]
                // the cosine hemisphere: diffuse, and the plastic's base
                float rr2 = sqrtf(u8);
                float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                ndx = s1x * bx + s2x * by + fx * bz;
                ndy = s1y * bx + s2y * by + fy * bz;
                ndz = s1z * bx + s2z * by + fz * bz;
                w_b = rb;
                if (kb == PLASTIC) {
                    // the smooth coat's mirror direction with probability
                    // spec_w; both share the base's ratio
                    float fi = fres_diel(fabsf(face), eb);
                    float spec_w = fminf(fmaxf(fi, F(0.05)), F(0.95));
                    if (dr.get(db + 2) < spec_w) {
                        float dn2 = dx * fx + dy * fy + dz * fz;
                        ndx = dx - 2.0f * dn2 * fx;
                        ndy = dy - 2.0f * dn2 * fy;
                        ndz = dz - 2.0f * dn2 * fz;
                    }
                    float co_p = ndx * fx + ndy * fy + ndz * fz;
                    w_b = rb * (1.0f - fi) * (1.0f - fres_diel(co_p, eb))
                          / fmaxf(1.0f - spec_w, F(1e-6));
                    if (!(co_p > 0.0f)) w_b = 0.0f;
                }
            }
            // [k1 stage: bounce]
            if (!(w_b > 0.0f)) break;                   // absorbed
            // direct hits at the next vertex follow a delta bounce only
            // where the tables hold a delta lobe (the JAX kernel's
            // delta_any; a mask's pass alone counts none)
            wdel = del && (cfg.mirror
                           || (cfg.lobes & (LOBE_DIEL | LOBE_THIN)) != 0);
            // bounce Doppler of the continued path
            dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                 + (ndz - dz) * vbz) / cvel);
            // a refracted or passed ray leaves through the back face
            float off = F(1e-4);
            if ((cfg.lobes & (LOBE_DIEL | LOBE_THIN | LOBE_RDIEL | LOBE_MASK))
                && !(ndx * fx + ndy * fy + ndz * fz >= 0.0f))
                off = F(-1e-4);
            dx = ndx;
            dy = ndy;
            dz = ndz;
            thr = thr * w_b;
            cx = hx + off * fx;
            cy = hy + off * fy;
            cz = hz + off * fz;
        } else {
            if (!(txc < 0.0f)) break;                   // on the tx
            if (!is_ggx && !is_m && !(rb > 0.0f)) break;   // absorbed

            // ---- bounce: cosine hemisphere (diffuse) or a GGX half
            //      vector about the flipped normal ----
            // (EP: after each transmitter's three NEE draws)
            const int db = EP ? d0 + 1 + 3 * cfg.n_tx : d0 + 4;
            float u8 = dr.get(db), u9 = dr.get(db + 1);
            float face = -(dx * nx + dy * ny + dz * nz);
            float sgn = sgn_ge(face);
            float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
            float sign = sgn_ge(fz);
            float a2 = -1.0f / (sign + fz);
            float b2 = fx * fy * a2;
            float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                  s1z = -sign * fx;
            float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
            float ph2 = TP * u9;
            float ndx, ndy, ndz, w_b;
            if (is_m) {
                // smooth conductor: the specular reflection about the
                // flipped normal, weight refl x conductor Fresnel
                float dn = dx * fx + dy * fy + dz * fz;
                ndx = dx - 2.0f * dn * fx;
                ndy = dy - 2.0f * dn * fy;
                ndz = dz - 2.0f * dn * fz;
                w_b = rb * fres_cond(fabsf(dn), eb, kk);
                if (!(w_b > 0.0f)) break;
            } else if (is_ggx) {
                // weight refl F G (wi.h) / (cos_i h.n)
                float ag2 = ab * ab;
                float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                float cth = rsqrtf(1.0f + tan2);
                float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                float hlx = sth * fast_cos(ph2), hly = sth * fast_sin(ph2);
                float hwx = s1x * hlx + s2x * hly + fx * cth;
                float hwy = s1y * hlx + s2y * hly + fy * cth;
                float hwz = s1z * hlx + s2z * hly + fz * cth;
                float ci_b = fabsf(face);
                float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                ndx = 2.0f * idoth * hwx + dx;
                ndy = 2.0f * idoth * hwy + dy;
                ndz = 2.0f * idoth * hwz + dz;
                float co_g = ndx * fx + ndy * fy + ndz * fz;
                float f_b = fres_cond(fabsf(idoth), eb, kk);
                float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth, F(1e-8));
                if (!(co_g > 0.0f && idoth > 0.0f && w_b > 0.0f)) break;
            } else {
                float rr2 = sqrtf(u8);
                float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                ndx = s1x * bx + s2x * by + fx * bz;
                ndy = s1y * bx + s2y * by + fy * bz;
                ndz = s1z * bx + s2z * by + fz * bz;
                w_b = rb;
            }
            wdel = is_m;
            // bounce Doppler of the continued path
            dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                 + (ndz - dz) * vbz) / cvel);
            dx = ndx;
            dy = ndy;
            dz = ndz;
            thr = thr * w_b;
            cx = hx + F(1e-4) * fx;
            cy = hy + F(1e-4) * fy;
            cz = hz + F(1e-4) * fz;
        }
    }
    return lane_sum;
}

// One block's work: its pulse's tables into shared memory, the
// grid-stride loop over the pulse's lanes, the block's grid or rows into
// `partial`, its event count.  Pulse p = blockIdx.y reads its tables,
// uniforms, BVH and lane sums p strides in and writes its own partials, so
// a CPI of P pulses is one launch of gridDim.x blocks a pulse; the
// reduce then sums each pulse's rows apart.  The MIMO configuration also
// copies the receiver row's element half-widths and the element offsets
// (rxph, eoff) into shared memory, before its grid of doubles.  The
// endpoint twins (EP) hold up to MAX_TX transmitter rows there, each with
// its unit normal written into its free columns 29-31.
template <bool MESH, bool DOP, bool COH, bool MIMO = false, bool MED = false,
          bool EP = false, bool LOB = false>
__device__ __forceinline__ void trace_block(
    const float* __restrict__ params, const float* __restrict__ prim,
    const float* __restrict__ txp, const float* __restrict__ msh,
    const float* __restrict__ uniforms, const bvh::Tables& mesh,
    float* __restrict__ lane_val, double* __restrict__ partial,
    unsigned long long* __restrict__ part_ev, const Cfg& cfg,
    const float* __restrict__ rxph = nullptr,
    const float* __restrict__ eoff = nullptr) {
    static_assert(!(EP && MED), "the endpoint twins run in vacuum");
    static_assert(!LOB || (DOP && !MIMO && !MED && !EP),
                  "the lobe twins: the Doppler family, in vacuum, one "
                  "Wigner transmitter");
    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS : TXP_COLS;
    extern __shared__ float smem[];
    const int T = blockDim.x, tid = threadIdx.x;
    const long long pulse = blockIdx.y;
    params += pulse * cfg.n_params;
    prim += pulse * cfg.n_prims * PRIM_COLS;
    if constexpr (EP)
        txp += pulse * cfg.n_tx * TXP_COLS;
    else
        txp += pulse * TXP_COLS;
    if (msh != nullptr) msh += pulse * cfg.n_msh * MSH_COLS;
    float* s_par = smem;
    float* s_prim = s_par + cfg.n_params;
    float* s_tx = s_prim + cfg.n_prims * PRIM_COLS;
    float* hist = s_tx + TX_FLOATS;      // flagship / mesh: private rows
    float* s_msh = s_tx + TX_FLOATS;     // Doppler: mesh-shape rows, grid
    float* s_grid = s_msh + cfg.n_msh * MSH_COLS;
    // grid values: one a cell, I and Q interleaved, or (MIMO) an I / Q
    // pair an element
    const long long n_cells = (long long)cfg.n_time * cfg.n_freq
                              * (MIMO ? 2 * cfg.n_elem : COH ? 2 : 1);
    // MIMO: element half-widths and offsets, then the 8-byte aligned grid
    float* s_mimo = s_grid;
    double* s_dgrid = reinterpret_cast<double*>(
        smem + (((s_mimo - smem) + 2 + 3 * cfg.n_elem + 1) & ~1));
    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < cfg.n_prims * PRIM_COLS; i += T) s_prim[i] = prim[i];
    if constexpr (EP)
        for (int i = tid; i < cfg.n_tx * TXP_COLS; i += T) s_tx[i] = txp[i];
    else
        for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    if constexpr (MIMO) {
        for (int i = tid; i < cfg.n_msh * MSH_COLS; i += T) s_msh[i] = msh[i];
        for (int i = tid; i < 2; i += T) s_mimo[i] = rxph[i];
        for (int i = tid; i < 3 * cfg.n_elem; i += T) s_mimo[2 + i] = eoff[i];
        if (cfg.mode == 1)
            for (int i = tid; i < n_cells; i += T) s_dgrid[i] = 0.0;
    } else if constexpr (DOP) {
        for (int i = tid; i < cfg.n_msh * MSH_COLS; i += T) s_msh[i] = msh[i];
        if (cfg.mode == 1)
            for (int i = tid; i < n_cells; i += T) s_grid[i] = 0.0f;
    } else {
        for (int i = tid; i < cfg.n_time * T; i += T) hist[i] = 0.0f;
    }
    __syncthreads();
    if constexpr (EP) {
        // each transmitter row's unit normal (to_world column 2)
        for (int t = tid; t < cfg.n_tx; t += T) {
            float* r = s_tx + t * TXP_COLS;
            float tnn = rsqrtf(fmaxf(r[2] * r[2] + r[6] * r[6]
                                     + r[10] * r[10], F(1e-20)));
            r[29] = r[2] * tnn;
            r[30] = r[6] * tnn;
            r[31] = r[10] * tnn;
        }
        __syncthreads();
    }

    Tx tx;
    tx.m = s_tx;
    tx.wx = s_tx[12];
    tx.wy = s_tx[13];
    tx.area = s_tx[14];
    tx.gain = s_tx[15];
    tx.wf = s_tx[16];
    tx.amp = s_tx[17];
    tx.prf = s_tx[18];
    tx.text = s_tx[19];
    tx.fc = s_tx[20];
    tx.fext = s_tx[21];
    {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        tx.nx = m[2] * tnn;
        tx.ny = m[6] * tnn;
        tx.nz = m[10] * tnn;
    }
    tx.w = Wave{s_tx + 16, s_tx + 28};
    const Wave lo{s_par + 33, s_par + 41};
    if constexpr (DOP) {
        tx.vx = s_tx[24];
        tx.vy = s_tx[25];
        tx.vz = s_tx[26];
    }
    typename GridOf<MIMO>::type grid;
    if constexpr (MIMO) {
        grid.tab = s_mimo;
        grid.s = cfg.mode == 1 ? s_dgrid : nullptr;
    } else {
        grid.s = cfg.mode == 1 ? s_grid : nullptr;
    }
    grid.g = partial + (cfg.mode == 2 ? pulse * n_cells : 0);  // its grid

    Draws<DOP> dr;
    dr.u = uniforms;
    dr.n_lanes = cfg.n_lanes;
    dr.u_stride = cfg.u_stride;
    dr.seed = cfg.seed;
    dr.seed_step = cfg.seed_step;
    dr.use_prng = cfg.use_prng;
    // the Doppler family holds its pulse's uniforms, key, BVH tables and
    // lane sums a block (see pulse_id)
    bvh::Tables mesh_b = mesh;
    if constexpr (DOP) {
        if (uniforms != nullptr) dr.u = uniforms + pulse * cfg.u_stride;
        dr.seed = cfg.seed + cfg.seed_step * pulse;
        if constexpr (MESH) mesh_b = pulse_tables(mesh, cfg);
        if (lane_val != nullptr) lane_val += pulse * cfg.n_lanes;
    }
    float* my_hist = hist + tid;
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    for (long long lane = (long long)blockIdx.x * T + tid; lane < cfg.n_lanes;
         lane += stride) {
        dr.lane = lane;
        dr.group = -1;
        float v = trace_lane<MESH, DOP, COH, MIMO, MED, EP, LOB>(
            cfg, s_par, s_prim, s_msh, tx, lo, mesh_b, dr, my_hist, T, grid,
            &events);
        if constexpr (DOP) {
            if (lane_val != nullptr) lane_val[lane] = v;
        } else if constexpr (MESH) {
            if (lane_val != nullptr)
                lane_val[lane + pulse_id() * cfg.n_lanes] = v;
        }
    }
    __syncthreads();

    // the pulse's partial rows (mode 0 / 1) and event counts
    partial += pulse_id() * gridDim.x
               * (DOP ? n_cells : (long long)cfg.n_time);
    part_ev += pulse_id() * gridDim.x;

    if constexpr (DOP) {
        // the block's grid, in double (mode 2 added to `partial` already)
        if (cfg.mode == 1)
            for (long long c = tid; c < n_cells; c += T)
                partial[(long long)blockIdx.x * n_cells + c] =
                    MIMO ? s_dgrid[c] : (double)s_grid[c];
    } else {
        // block row: sum the T private rows in thread order
        for (int b = tid; b < cfg.n_time; b += T) {
            double s = 0.0;
            const float* row = hist + b * T;
            for (int t = 0; t < T; ++t) s += (double)row[t];
            partial[(long long)blockIdx.x * cfg.n_time + b] = s;
        }
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(0xffffffffu, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(smem);
    if ((tid & 31) == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < (T + 31) / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The flagship and mesh kernels carry no launch bounds: a bound of 256
// threads alone moves the flagship from 95 registers to 96.  Each kernel
// below has a media twin (MED), the same body through an ambient medium,
// and an endpoint twin (EP), the same body with up to MAX_TX transmitters
// of mixed kinds and an analog phased receiver, in vacuum.
template <bool MESH, bool MED, bool EP = false>
__global__ void receive_trace_kernel(const float* __restrict__ params,
                                     const float* __restrict__ prim,
                                     const float* __restrict__ txp,
                                     const float* __restrict__ msh,
                                     const float* __restrict__ uniforms,
                                     bvh::Tables mesh,
                                     float* __restrict__ lane_val,
                                     double* __restrict__ partial,
                                     unsigned long long* __restrict__ part_ev,
                                     Cfg cfg) {
    trace_block<MESH, false, false, false, MED, EP>(
        params, prim, txp, msh, uniforms, mesh, lane_val, partial, part_ev,
        cfg);
}

// ---- the flagship kernel --------------------------------------------------
//
// The flagship configuration (analytic rectangles, one Wigner transmitter,
// a Wigner or omni receiver, power, vacuum; receive_trace_kernel<false,
// false, false> before) runs a kernel of its own.  Its lane is
// trace_lane's, operation by operation; what differs is which thread runs
// which part of which lane, and when.  Its parts were chosen by
// tools/k1_mix.py (the SIMT models, the instruction mix),
// tools/k1_clock.py (where a warp's cycles go) and tools/tree_ab.py pair
// runs against the grid-stride kernel and ablations (PERF.md):
//  - A wavefront inside each warp.  A lane is a receive ray, then
//    vertices: a closest hit over the rectangles, and at a hit the direct
//    hit or the NEE, the splat and the bounce.  Half of the traces miss and
//    28% of the lanes end at depth 0, so a thread that follows one lane to
//    its end, as the grid-stride loop does, leaves a warp issuing each
//    stage for the few of its 32 lanes that need it: ~53% of the slots do
//    work.  Here a warp keeps a pool of FLAG_POOL paths waiting to be
//    shaded, in shared memory, and each turn of its loop runs one of two
//    stages over 32 threads: SHADE (32 waiting paths, in slot order:
//    direct hit or NEE, splat, bounce) when 32 wait, else RAY (the warp's
//    next 32 lanes, lane = first + j + k stride as in the grid-stride
//    loop), else the rest of SHADE; either traces the rays it made, and a
//    hit waits in its slot (origin, throughput, direction, path length,
//    receive time, hit, depth, lane: 16 floats) while a miss frees it.  The
//    waiting set is two masks of 32 bits that every thread holds the same,
//    updated with __reduce_or_sync.  A warp takes ~2 turns for 32 lanes,
//    each 97-100% full.
//  - Warp rows in a fixed order.  SHADE is a point that all 32 threads
//    reach together, so the warp splats there: every tent tap goes to the
//    warp's row of n_time doubles, the taps on one bin summed in lane order
//    by one lane (flag_splat).  A warp's turns, and so every sum, follow
//    from the data and the launch geometry alone: repeats are
//    bit-identical.  A block's rows take 2 KB at 64 bins (the thread rows
//    took 64 KB), so shared memory no longer sets occupancy.
//  - Draws a stage at a time.  The Philox blocks a stage needs are
//    computed at its start by every thread (FlagDraws), not at the draw
//    site where a thread's cached block ran out, which differs by depth.
//  - Tables laid out for the card.  Each rectangle is five float4s: its
//    world-to-local rows, then its unit normal and reflectance, then its
//    transmitter column; a test reads three LDS.128, and the normal's
//    rsqrtf is taken once a block with trace_lane's expression.  The
//    rectangles that can shadow an NEE (all but the transmitter's) have a
//    list of their own.  The Wigner receiver's frame and lobe constants are
//    computed once a block, with trace_lane's expressions.
// The packed tables, the positional draws, the tent, the partial rows and
// the reduce are the other configurations', so the plain version and the
// CPI's pulse axis hold as they did.  The tags "[k1 stage: ...]" name each
// stage for tools/k1_mix.py.
constexpr int FLAG_THREADS = 128;   // four warps a block
constexpr int FLAG_POOL = 64;       // paths a warp
constexpr int FLAG_SLOT = 16;       // floats a path: four float4s
constexpr int FLAG_REC = 5;         // float4s a rectangle
constexpr unsigned FULL_MASK = 0xffffffffu;

// Shared bytes of one warp's area: its paths, a turn's slots, the
// splat's staging (two taps a lane), then its row of n_time doubles and
// the splat's two bin masks of n_time words.
__host__ __device__ constexpr int flag_row_offset() {
    return 4 * (FLAG_POOL * FLAG_SLOT + 32 + 64);
}
__host__ __device__ constexpr int flag_warp_bytes(int n_time) {
    return (flag_row_offset() + 16 * n_time + 15) & ~15;
}
constexpr int FLAG_RXC = 16;        // the Wigner receiver's constants
// Shared bytes of a block's tables, ahead of the warps' areas: the
// rectangles, the shadowing rectangles' rows, params, the transmitter row
// and its unit normal, the receiver's constants, the prim rows, two
// counts.
__host__ __device__ constexpr int flag_table_bytes(int n_prims,
                                                   int n_params) {
    return (16 * (FLAG_REC + 3) * n_prims
            + 4 * (n_params + TXP_COLS + 4 + FLAG_RXC + n_prims * PRIM_COLS
                   + 4) + 15)
           & ~15;
}

// Philox4x32-10 block g of a lane: Draws<false>'s key (the pulse read at
// use) and counter.
__device__ __forceinline__ uint4 flag_block(const Cfg& cfg, long long lane,
                                            int g) {
    unsigned long long k = cfg.seed;
    if (cfg.seed_step != 0) k += cfg.seed_step * pulse_id();
    return philox4x32_10(
        make_uint4((uint32_t)lane, (uint32_t)(lane >> 32), (uint32_t)g, 0u),
        make_uint2((uint32_t)k, (uint32_t)(k >> 32)));
}

// Uniform number x of a Philox word (Draws' top 24 bits).
__device__ __forceinline__ float flag_unit(uint32_t x) {
    return (float)(x >> 8) * F(1.0 / 16777216.0);
}

// The flagship kernel's draws: the positional stream of Draws<false>, word
// for word, five draws a stage (RAY draws 0-4, SHADE d0 + 1 .. d0 + 5: its
// NEE's three and its bounce's two), taken from the two Philox blocks
// that hold them at the stage's start, where every thread of the warp
// computes them.  Draws<false> caches the last block and computes one
// where a draw leaves it, at the draw's own site: a SHADE turn mixes
// depths, whose draws leave their blocks at different sites, so a warp ran
// up to three Philox blocks a turn, each for some of its threads.
// Injected uniforms are read as there.
__device__ __forceinline__ void flag_draws5(const Cfg& cfg, const float* u,
                                            long long lane, int first,
                                            float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 5; ++k)
            out[k] = u[(long long)(first + k) * cfg.n_lanes + lane
                       + pulse_id() * cfg.u_stride];
        return;
    }
    const uint4 a = flag_block(cfg, lane, first >> 2);
    const uint4 b = flag_block(cfg, lane, (first >> 2) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int o = first & 3;
#pragma unroll
    for (int k = 0; k < 5; ++k)
        out[k] = flag_unit(o == 0 ? w[k] : o == 1 ? w[k + 1]
                           : o == 2 ? w[k + 2] : w[k + 3]);
}

// One draw of a lane, its block computed here (the direct hit's draw d0,
// at depth 0 only).
__device__ __forceinline__ float flag_draw1(const Cfg& cfg, const float* u,
                                            long long lane, int idx) {
    if (!cfg.use_prng)
        return u[(long long)idx * cfg.n_lanes + lane
                 + pulse_id() * cfg.u_stride];
    const uint4 w = flag_block(cfg, lane, idx >> 2);
    const int k = idx & 3;
    return flag_unit(k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w);
}

// rect_hit on a rectangle's world-to-local rows held as float4s.
// rect_hit4_uv also gives the hit's local coordinates (px, py), the
// texture twins' uv; rect_hit4 drops them.
__device__ __forceinline__ bool rect_hit4_uv(const float4* q, float cx,
                                             float cy, float cz, float dx,
                                             float dy, float dz,
                                             float* t_out, float* px_out,
                                             float* py_out) {
    const float4 a = q[0], b = q[1], c = q[2];
    float oox = a.x * cx + a.y * cy + a.z * cz + a.w;
    float ooy = b.x * cx + b.y * cy + b.z * cz + b.w;
    float ooz = c.x * cx + c.y * cy + c.z * cz + c.w;
    float odx = a.x * dx + a.y * dy + a.z * dz;
    float ody = b.x * dx + b.y * dy + b.z * dz;
    float odz = c.x * dx + c.y * dy + c.z * dz;
    bool big = fabsf(odz) > F(1e-12);
    float t_p = -ooz / (big ? odz : F(1e-12));
    float px = oox + t_p * odx;
    float py = ooy + t_p * ody;
    *t_out = t_p;
    *px_out = px;
    *py_out = py;
    return big && fabsf(px) <= 1.0f && fabsf(py) <= 1.0f;
}

__device__ __forceinline__ bool rect_hit4(const float4* q, float cx,
                                          float cy, float cz, float dx,
                                          float dy, float dz, float* t_out) {
    float px, py;
    return rect_hit4_uv(q, cx, cy, cz, dx, dy, dz, t_out, &px, &py);
}

// The texture twins' record of a rectangle (two float4s, after the
// warps' areas in shared memory): (code, c0, c1, su) and (sv, its first
// texel, H, W), from prim columns 22-26 and the bitmap rectangles' (first
// row, H, W) at the head of the texture buffer `tb` (four floats a prim
// row, then the texel rows of w_row texels; Cfg.grid and Cfg.g_w, which
// the vacuum kernels read for nothing else).
__device__ __forceinline__ void tex_record(float4* t, const float* row,
                                           int p, const float* tb,
                                           int n_prims, int w_row) {
    const float* bm = tb + 4 * p;
    t[0] = make_float4(row[26], row[22], row[23], row[24]);
    t[1] = make_float4(row[25],
                       __int_as_float(4 * n_prims + (int)bm[0] * w_row),
                       bm[1], bm[2]);
}

// The reflectance of a textured rectangle at its local hit point (px,
// py): rb times its checkerboard's colour or its bitmap's nearest texel at
// uv = (p + 1) / 2 scaled, in the JAX kernel's arithmetic (the
// checkerboard :762-770, the bitmap's uv fraction :771-776 and its texel
// :1497-1510: floor(f W) held below W), the plain version's too.  A
// bitmap's texel is one load through the read-only path.
__device__ __forceinline__ float tex_reflectance(const float4* t, float rb,
                                                 float px, float py,
                                                 const float* tb,
                                                 int w_row) {
    const float4 a = t[0], b = t[1];
    float uu = (px + 1.0f) * 0.5f * a.w;
    float vv = (py + 1.0f) * 0.5f * b.x;
    if (a.x == 1.0f) {
        float cs = floorf(uu) + floorf(vv);
        float par = cs - 2.0f * floorf(cs * 0.5f);
        return rb * (par < 0.5f ? a.y : a.z);
    }
    if (a.x == 2.0f) {
        float fu = uu - floorf(uu), fv = vv - floorf(vv);
        float ix = fminf(floorf(fu * b.w), b.w - 1.0f);
        float iy = fminf(floorf(fv * b.z), b.z - 1.0f);
        return rb * __ldg(tb + __float_as_int(b.y) + (int)iy * w_row
                          + (int)ix);
    }
    return rb;
}

// The prims twins' test of one analytic prim of kind `kind` (its
// world-to-local rows as float4s `q`): the JAX kernel's arithmetic
// (pallas_receive.py:697-798), which the plain version copies.  A
// rectangle as rect_hit4_uv; a disk the plane z = 0 clipped to the unit
// circle; a cylinder x^2 + y^2 = 1, z in [0, 1], by the roots (-b -+
// sqrt(disc)) / 2a and the near root where its z is on the surface, else
// the far one; a sphere by the stable q = -(b + sgn(b) sqrt(disc)) / 2,
// t0 = q / a, t1 = c / q, the near root if positive, else the far one.
// (px, py) are a rectangle's local hit coordinates (the texture codes');
// the shadow test uses the same roots.
__device__ __forceinline__ bool prim_hit4_uv(const float4* q, int kind,
                                             float cx, float cy, float cz,
                                             float dx, float dy, float dz,
                                             float* t_out, float* px_out,
                                             float* py_out) {
    if (kind == RECTANGLE)
        return rect_hit4_uv(q, cx, cy, cz, dx, dy, dz, t_out, px_out,
                            py_out);
    const float4 a = q[0], b = q[1], c = q[2];
    float oox = a.x * cx + a.y * cy + a.z * cz + a.w;
    float ooy = b.x * cx + b.y * cy + b.z * cz + b.w;
    float ooz = c.x * cx + c.y * cy + c.z * cz + c.w;
    float odx = a.x * dx + a.y * dy + a.z * dz;
    float ody = b.x * dx + b.y * dy + b.z * dz;
    float odz = c.x * dx + c.y * dy + c.z * dz;
    *px_out = 0.0f;
    *py_out = 0.0f;
    if (kind == DISK) {
        bool big = fabsf(odz) > F(1e-12);
        float t_p = -ooz / (big ? odz : F(1e-12));
        float px = oox + t_p * odx;
        float py = ooy + t_p * ody;
        *t_out = t_p;
        return big && px * px + py * py <= 1.0f;
    }
    if (kind == CYLINDER) {
        float a_s = odx * odx + ody * ody;
        float b_s = 2.0f * (oox * odx + ooy * ody);
        float c_s = oox * oox + ooy * ooy - 1.0f;
        float disc = b_s * b_s - 4.0f * a_s * c_s;
        float sq = sqrtf(fmaxf(disc, 0.0f));
        float a_sf = fabsf(a_s) > F(1e-20) ? a_s : F(1e-20);
        float t0 = (-b_s - sq) / (2.0f * a_sf);
        float t1 = (-b_s + sq) / (2.0f * a_sf);
        float z0 = ooz + t0 * odz;
        float z1 = ooz + t1 * odz;
        bool v0 = disc >= 0.0f && z0 >= 0.0f && z0 <= 1.0f && t0 > 0.0f;
        bool v1 = disc >= 0.0f && z1 >= 0.0f && z1 <= 1.0f && t1 > 0.0f;
        *t_out = v0 ? t0 : t1;
        return v0 || v1;
    }
    float a_s = odx * odx + ody * ody + odz * odz;
    float b_s = 2.0f * (oox * odx + ooy * ody + ooz * odz);
    float c_s = oox * oox + ooy * ooy + ooz * ooz - 1.0f;
    float disc = b_s * b_s - 4.0f * a_s * c_s;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float qq = -0.5f * (b_s + (b_s >= 0.0f ? 1.0f : -1.0f) * sq);
    float t0 = qq / (fabsf(a_s) > F(1e-20) ? a_s : F(1e-20));
    float t1 = c_s / (fabsf(qq) > F(1e-20) ? qq : F(3.4e38));
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    float t_p = tn > 0.0f ? tn : tf;
    *t_out = t_p;
    return disc >= 0.0f && t_p > 0.0f;
}

__device__ __forceinline__ bool prim_hit4(const float4* q, int kind,
                                          float cx, float cy, float cz,
                                          float dx, float dy, float dz,
                                          float* t_out) {
    float px, py;
    return prim_hit4_uv(q, kind, cx, cy, cz, dx, dy, dz, t_out, &px, &py);
}

// The unit world normal at the hit t of the ray (c, d) on a prim of kind
// `kind` (rows `q`): a rectangle's or disk's from its record (`n`, rows
// 8-10 normalised once a block); a cylinder's M^T (px, py, 0), a sphere's
// M^T p, normalised by rsqrt, from the hit point in object space as the
// trace computed it.  SHADE recomputes it from the slot's ray and t.  The
// normal is the result's x, y, z.
__device__ __forceinline__ float4 prim_normal4(const float4* q, int kind,
                                               float4 n, float cx, float cy,
                                               float cz, float dx, float dy,
                                               float dz, float t) {
    if (kind != SPHERE && kind != CYLINDER) return n;
    const float4 a = q[0], b = q[1], c = q[2];
    float px = (a.x * cx + a.y * cy + a.z * cz + a.w)
               + t * (a.x * dx + a.y * dy + a.z * dz);
    float py = (b.x * cx + b.y * cy + b.z * cz + b.w)
               + t * (b.x * dx + b.y * dy + b.z * dz);
    float pz = kind == SPHERE ? (c.x * cx + c.y * cy + c.z * cz + c.w)
                                    + t * (c.x * dx + c.y * dy + c.z * dz)
                              : 0.0f;
    float snx = a.x * px + b.x * py + c.x * pz;
    float sny = a.y * px + b.y * py + c.y * pz;
    float snz = a.z * px + b.z * py + c.z * pz;
    float nn = rsqrtf(fmaxf(snx * snx + sny * sny + snz * snz, F(1e-20)));
    return make_float4(snx * nn, sny * nn, snz * nn, 0.0f);
}

// The sum of the values of a (nonempty) group of lanes, in lane order,
// four loads in flight.
__device__ __forceinline__ float group_sum(const float* vals, unsigned g) {
    float s = vals[__ffs(g) - 1];
    g &= g - 1u;
    while (g != 0u) {
        int l[4];
        int n = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            l[q] = 0;
            if (g != 0u) {
                l[q] = __ffs(g) - 1;
                g &= g - 1u;
                n = q + 1;
            }
        }
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = vals[l[q]];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (q < n) s += v[q];
    }
    return s;
}

// The warp's tent splat of each thread's (val, yb) into its row (val 0:
// nothing); every thread of the warp calls it.  Tap 0 of a lane goes to
// bin floor(yb), tap 1 to floor(yb) + 1.  Each lane ORs its bit into the
// mask of each tap's bin (a mask array a tap), so a bin's two masks are
// its two groups of lanes, whatever order the ORs took.  One lane a bin
// then adds to the row, in double, the sum of the bin's tap-0 group and
// then that of its tap-1 group, each in lane order: the lowest lane of the
// tap-0 group, or of the tap-1 group where the bin has no tap 0; it clears
// the bin's masks.  The masks, not __match_any_sync (the same groups, the
// same time: PERF.md), hold both taps' groups of a bin for that one lane.
// [k1 splat]
__device__ __forceinline__ void flag_splat(double* row, unsigned* masks,
                                           float* vals, int n_time,
                                           float val, float yb, int j) {
    int i0 = -2;
    float v0 = 0.0f, v1 = 0.0f;
    if (val != 0.0f) {
        float b0 = floorf(yb);
        if (b0 >= -1.0f && b0 < (float)n_time) {   // also drops NaN
            float b1 = b0 + 1.0f;
            i0 = (int)b0;
            v0 = val * fmaxf(1.0f - fabsf(yb - b0), 0.0f);
            v1 = val * fmaxf(1.0f - fabsf(yb - b1), 0.0f);
        }
    }
    if (!__any_sync(FULL_MASK, i0 != -2)) return;
    const bool ok0 = i0 >= 0, ok1 = i0 != -2 && i0 + 1 < n_time;
    unsigned* tap0 = masks;              // bin b's tap-0 group at tap0[b]
    unsigned* tap1 = masks + n_time;     // and its tap-1 group at tap1[b]
    if (ok0) atomicOr(tap0 + i0, 1u << j);
    if (ok1) atomicOr(tap1 + i0 + 1, 1u << j);
    vals[j] = v0;
    vals[32 + j] = v1;
    __syncwarp();
    const unsigned lt = (1u << j) - 1u;
    // bin i0 through tap 0, bin i0 + 1 through tap 1 where it has no tap 0
    const unsigned g00 = ok0 ? tap0[i0] : 0u;
    const unsigned g01 = ok0 ? tap1[i0] : 0u;
    const unsigned g11 = ok1 ? tap1[i0 + 1] : 0u;
    const bool lead0 = ok0 && (g00 & lt) == 0u;
    const bool lead1 = ok1 && (g11 & lt) == 0u && tap0[i0 + 1] == 0u;
    __syncwarp();
    if (lead0) {
        double r = row[i0] + (double)group_sum(vals, g00);
        if (g01 != 0u) r = r + (double)group_sum(vals + 32, g01);
        row[i0] = r;
        tap0[i0] = 0u;
        tap1[i0] = 0u;
    }
    if (lead1) {
        row[i0 + 1] = row[i0 + 1] + (double)group_sum(vals + 32, g11);
        tap1[i0 + 1] = 0u;
    }
}

template <bool TEX, bool PRIM = false>
__global__ void __launch_bounds__(FLAG_THREADS)
receive_flagship_kernel(const float* __restrict__ params,
                        const float* __restrict__ prim,
                        const float* __restrict__ txp,
                        const float* __restrict__ msh,
                        const float* __restrict__ uniforms, bvh::Tables mesh,
                        float* __restrict__ lane_val,
                        double* __restrict__ partial,
                        unsigned long long* __restrict__ part_ev, Cfg cfg) {
    extern __shared__ float4 fsm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = fsm;
    float4* s_blk = s_rec + FLAG_REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's constants
    float* s_prim = s_rxc + FLAG_RXC;
    int* s_cnt = reinterpret_cast<int*>(s_prim + np * PRIM_COLS);
    char* s_warps = reinterpret_cast<char*>(fsm)
                    + flag_table_bytes(np, cfg.n_params);
    const int wbytes = flag_warp_bytes(cfg.n_time);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + FLAG_POOL * FLAG_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + flag_row_offset());
    unsigned* w_mask = reinterpret_cast<unsigned*>(w_row + cfg.n_time);
    // TEX: each rectangle's texture record, after the warps' areas
    float4* s_tex = reinterpret_cast<float4*>(s_warps + (T / 32) * wbytes);
    // PRIM: the kinds of the prim records, then of the shadowing rows,
    // after the texture records where there are any
    int* s_kind = reinterpret_cast<int*>(s_tex + (TEX ? 2 * np : 0));

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = tid; i < np * PRIM_COLS; i += T) s_prim[i] = prim[i];
    for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;
    for (int i = j; i < 2 * cfg.n_time; i += 32) w_mask[i] = 0u;
    __syncthreads();
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does);
        // PRIM: the spheres, disks and cylinders among them, in prim order
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = s_prim + p * PRIM_COLS;
            const int kd = (int)row[0];
            if constexpr (PRIM) {
                if (kd != RECTANGLE && kd != SPHERE && kd != DISK
                    && kd != CYLINDER)
                    continue;
            } else if (kd != RECTANGLE) {
                continue;
            }
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + FLAG_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], 0.0f, 0.0f, 0.0f);
            if constexpr (TEX)
                tex_record(s_tex + 2 * (nr - 1), row, p, cfg.grid, np,
                           cfg.g_w);
            if constexpr (PRIM) s_kind[nr - 1] = kd;
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
                if constexpr (PRIM) s_kind[np + nb - 1] = kd;
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame and lobe mixture, trace_lane's
        // expressions: they depend on the tables alone
        const float* rxm = s_par + 2;
        const float rx_wx = s_par[14], rx_wy = s_par[15];
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float lam0 = s_par[1] / fmaxf(cfg.f_rx, F(1e-6));
        float w_mn = fminf(rx_wx, rx_wy);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * rx_wx * rx_wy;                         // area
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    const int base = cfg.omni ? 3 : 5;        // trace_lane's r0 + 2 or r0 + 4
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes (at most 31 paths wait, so
        // 33 slots are free), else the rest of SHADE, else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        // thread j's slots j and j + 32 in the turn's set (SHADE: the
        // waiting paths, RAY: the free slots) and their ranks in slot
        // order: the turn's k-th slot goes to thread k
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int r1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && r1 < 32) w_take[r1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float* sl = w_slots + FLAG_SLOT * (slot < 0 ? 0 : slot);
        float4* sl4 = reinterpret_cast<float4*>(sl);
        // the turn's lane and its five draws: RAY a new lane's draws 0-4,
        // SHADE its path's d0 + 1 .. d0 + 5 (the slot's lane and depth)
        long long lane = next + j;
        int depth = 0;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            depth = __float_as_int(sl4[2].w);
        }
        const int d0 = base + 6 * depth;
        float u5[5];
        // [k1 stage: draws]
        if (slot >= 0)
            flag_draws5(cfg, uniforms, lane, shade ? d0 + 1 : 0, u5);
        // [k1 stage: sched]

        // the path this turn traces: a new lane's ray (RAY) or the bounce
        // of a shaded one (SHADE); its state
        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        float val = 0.0f, yb = 0.0f;       // SHADE: the contribution
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive ray (draws 0..4)
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f
                                 : cfg.t_start + u5[0] * cfg.t_window;
                const int r0 = 1;
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float u1 = u5[r0], u2 = u5[r0 + 1];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float u1 = u5[r0], u2 = u5[r0 + 1];
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = u5[r0 + 2], u4 = u5[r0 + 3];
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / rc[5]);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(rc[4] * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + rc[6] * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = rc[7];
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const int pw = __float_as_int(c.z);
            const float4 nrb = s_rec[FLAG_REC * pw + 3];
            // TEX: the textured reflectance the trace left in the slot;
            // PRIM: a sphere's or cylinder's normal at the hit
            const float4 nh = PRIM ? prim_normal4(s_rec + FLAG_REC * pw,
                                                  s_kind[pw], nrb, cx, cy,
                                                  cz, dx, dy, dz, tb)
                                   : nrb;
            const float nx = nh.x, ny = nh.y, nz = nh.z,
                        rb = TEX ? sl4[3].z : nrb.w;
            const float txc = s_rec[FLAG_REC * pw + 4].x;
            const float cvel = sp[1];
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;

            // [k1 stage: direct]  direct transmitter hits at depth 0
            if (depth == 0) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h;
                    tx.emission(plen / cvel,
                                flag_draw1(cfg, uniforms, lane, d0), t_rx0,
                                cfg.gate,
                                t_start, t_window, &te_h, &tr_h, &wg_h,
                                nullptr);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    events += val != 0.0f;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits)
            if (txc < 0.0f) {
                float glx = 2.0f * u5[0] - 1.0f;
                float gly = 2.0f * u5[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d,
                      wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12)))
                                   * dist2 / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                    float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                               + wz_ * (nz * sg);
                    float f_cos = rb * F(1.0 / 3.141592653589793)
                                  * fmaxf(co, 0.0f);
                    float t_emit, t_recv, w_gate;
                    tx.emission((plen + dist) / cvel, u5[2],
                                t_rx0, cfg.gate, t_start, t_window,
                                &t_emit, &t_recv, &w_gate, nullptr);
                    float f_emit = tx.inst_freq(t_emit);
                    float sig = tx.eval_wdf(t_emit, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = PRIM ? prim_hit4(s_blk + 3 * r,
                                                      s_kind[np + r], sx, sy,
                                                      sz, wx_, wy_, wz_, &t_p)
                                          : rect_hit4(s_blk + 3 * r, sx, sy,
                                                      sz, wx_, wy_, wz_,
                                                      &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (t_recv - t_start) / t_window * n_time_f
                             - 0.5f;
                        events += val != 0.0f;
                    }
                }
            }

            // [k1 stage: bounce]  the diffuse bounce: cosine
            // hemisphere about the flipped normal (none after the
            // last depth, from an absorbing hit or on the transmitter)
            if (depth < cfg.max_depth - 1 && rb > 0.0f && txc < 0.0f) {
                float u8 = u5[3], u9 = u5[4];           // draws d0 + 4, 5
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float rr2 = sqrtf(u8);
                float ph2 = TP * u9;
                float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                dx = s1x * bx + s2x * by + fx * bz;
                dy = s1y * bx + s2y * by + fy * bz;
                dz = s1z * bx + s2z * by + fz * bz;
                thr = thr * rb;
                ox = hx + F(1e-4) * fx;
                oy = hy + F(1e-4) * fy;
                oz = hz + F(1e-4) * fz;
                depth = depth + 1;
                live = true;
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE, a miss frees it
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            float bpx = 0.0f, bpy = 0.0f;      // TEX: the winner's (px, py)
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p, px, py;
                bool hit_p = PRIM ? prim_hit4_uv(s_rec + FLAG_REC * r,
                                                 s_kind[r], ox, oy, oz, dx,
                                                 dy, dz, &t_p, &px, &py)
                                  : rect_hit4_uv(s_rec + FLAG_REC * r, ox, oy,
                                                 oz, dx, dy, dz, &t_p, &px,
                                                 &py);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                    if constexpr (TEX) {
                        bpx = px;
                        bpy = py;
                    }
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                     __int_as_float(depth));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     0.0f, 0.0f);
                // TEX: the winner's textured reflectance
                if constexpr (TEX)
                    sl4[3].z = tex_reflectance(s_tex + 2 * pw,
                                               s_rec[FLAG_REC * pw + 3].w,
                                               bpx, bpy, cfg.grid, cfg.g_w);
            }
        }
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo = slot >= 0 && slot < 32, hi = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi && hit ? bit : 0u);
        if (shade) {
            // [k1 stage: splat]
            flag_splat(w_row, w_mask, w_vals, cfg.n_time, val, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's row: its warps' rows summed in warp order; its events
    partial += pulse * gridDim.x * (long long)cfg.n_time;
    part_ev += pulse * gridDim.x;
    for (int b = tid; b < cfg.n_time; b += T) {
        double s = 0.0;
        for (int w = 0; w < T / 32; ++w)
            s += reinterpret_cast<const double*>(
                s_warps + w * wbytes + flag_row_offset())[b];
        partial[(long long)blockIdx.x * cfg.n_time + b] = s;
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(fsm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The untextured flagship kernel, instantiated where it is defined, so
// that the module keeps its kernels' order: instantiated where it is
// used, at the module's end, it left every kernel's PTX as it was but for
// its labels' numbers, and ptxas then gave the endpoint kernel other
// machine code.  The texture twin is instantiated where it is used.
template __global__ void receive_flagship_kernel<false>(
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, bvh::Tables, float* __restrict__,
    double* __restrict__, unsigned long long* __restrict__, Cfg);

// ---- the power endpoint kernel: a warp wavefront -------------------------
//
// The power endpoint twin on analytic scenes (receive_trace_kernel<false,
// false, true> before) runs the flagship kernel's turns: a pool of
// FLAG_POOL paths a warp, RAY over the warp's next 32 lanes and SHADE over
// 32 waiting paths, each tracing the rays it makes, warp rows of doubles
// in a fixed order (flag_splat).  Its lane is trace_lane's endpoint path,
// operation by operation:
//  - RAY: the Wigner, omni or analog phased receiver's ray; the phased
//    one's cross-WDF through the footprint index (pair_sum_epx), at a
//    point where all 32 threads run it together;
//  - SHADE: a path on transmitter t (a direct hit, depth 0) or NEE to
//    every transmitter in row order, each with its three draws (taken at
//    its start from the blocks that hold them), its kind's aperture
//    weight (the phased cross-WDF through the index) and its shadow test
//    over its own list of rectangles (all but its own, as float4
//    records); each transmitter's contribution splats in its own warp
//    splat, then the bounce (draws d0 + 1 + 3 n_tx, + 2).
// The tables: the flagship's rectangles, MAX_TX transmitter rows with
// their normals in columns 29-31 (trace_block's), the footprint index.
// [k1 stage: block]

// Shared bytes of an endpoint kernel's tables up to its index: the
// rectangles (`rec` float4s each), each transmitter's shadowing
// rectangles, params, the transmitter rows, the receiver's `rxc`
// constants, counts; then the index, ahead of the warps' areas.
__host__ __device__ constexpr int ep_index_offset(int n_prims, int n_params,
                                                  int n_tx, int rec,
                                                  int rxc) {
    return (16 * (rec + 3 * n_tx) * n_prims
            + 4 * (n_params + MAX_TX * TXP_COLS + rxc + 1 + MAX_TX) + 15)
           & ~15;
}
__host__ __device__ constexpr int ep_table_bytes(int n_prims, int n_params,
                                                 int n_tx, int n_pairs,
                                                 int n_rx_pairs, int rec,
                                                 int rxc) {
    return ep_index_offset(n_prims, n_params, n_tx, rec, rxc)
           + ((4 * epx_floats(n_tx, n_pairs, n_rx_pairs) + 15) & ~15);
}

// Blocks an SM the power endpoint kernel is held to: six (80 registers,
// ~160 B spilled) ran 0.92-0.96 of no bound (119 registers, four blocks),
// five 0.93-0.96 (PERF.md)
constexpr int EPW_MIN_BLOCKS = 6;

// Draws first .. first + 2 of a lane (an NEE's three), from the one or two
// Philox blocks that hold them.
__device__ __forceinline__ void epw_draws3(const Cfg& cfg, const float* u,
                                           long long lane, int first,
                                           float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
            out[k] = u[(long long)(first + k) * cfg.n_lanes + lane
                       + pulse_id() * cfg.u_stride];
        return;
    }
    const int o = first & 3;
    const uint4 a = flag_block(cfg, lane, first >> 2);
    uint4 b = a;
    if (o > 1) b = flag_block(cfg, lane, (first >> 2) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 3; ++k)
        out[k] = flag_unit(o == 0 ? w[k] : o == 1 ? w[k + 1]
                           : o == 2 ? w[k + 2] : w[k + 3]);
}

__global__ void __launch_bounds__(FLAG_THREADS, EPW_MIN_BLOCKS)
receive_endpoint_kernel(const float* __restrict__ params,
                        const float* __restrict__ prim,
                        const float* __restrict__ txp,
                        const float* __restrict__ msh,
                        const float* __restrict__ uniforms, bvh::Tables mesh,
                        float* __restrict__ lane_val,
                        double* __restrict__ partial,
                        unsigned long long* __restrict__ part_ev, Cfg cfg) {
    extern __shared__ float4 fsm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims, n_tx = cfg.n_tx;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * n_tx * TXP_COLS;
    float4* s_rec = fsm;
    float4* s_blk = s_rec + FLAG_REC * np;    // transmitter t's at t np
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * n_tx * np);
    float* s_tx = s_par + cfg.n_params;       // rows, normals in 29-31
    float* s_rxc = s_tx + MAX_TX * TXP_COLS;  // the receiver's constants
    int* s_cnt = reinterpret_cast<int*>(s_rxc + FLAG_RXC);
    float* s_epx = reinterpret_cast<float*>(
        reinterpret_cast<char*>(fsm)
        + ep_index_offset(np, cfg.n_params, n_tx, FLAG_REC, FLAG_RXC));
    char* s_warps = reinterpret_cast<char*>(fsm)
                    + ep_table_bytes(np, cfg.n_params, n_tx, cfg.n_pairs,
                                     cfg.n_rx_pairs, FLAG_REC, FLAG_RXC);
    const int wbytes = flag_warp_bytes(cfg.n_time);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + FLAG_POOL * FLAG_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + flag_row_offset());
    unsigned* w_mask = reinterpret_cast<unsigned*>(w_row + cfg.n_time);

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < n_tx * TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;
    for (int i = j; i < 2 * cfg.n_time; i += 32) w_mask[i] = 0u;
    __syncthreads();
    // each transmitter row's unit normal (trace_block's)
    for (int t = tid; t < n_tx; t += T) {
        float* r = s_tx + t * TXP_COLS;
        float tnn = rsqrtf(fmaxf(r[2] * r[2] + r[6] * r[6] + r[10] * r[10],
                                 F(1e-20)));
        r[29] = r[2] * tnn;
        r[30] = r[6] * tnn;
        r[31] = r[10] * tnn;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // to transmitter t (all but its own, t in column 14)
        int nr = 0;
        int nb[MAX_TX] = {0, 0, 0, 0};
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + FLAG_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], 0.0f, 0.0f, 0.0f);
            for (int t = 0; t < n_tx; ++t) {
                if (row[14] == (float)t) continue;
                float4* b = s_blk + 3 * (t * np + nb[t]++);
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        for (int t = 0; t < MAX_TX; ++t) s_cnt[1 + t] = nb[t];
        // the Wigner receiver's frame and lobe mixture (the flagship's)
        const float* rxm = s_par + 2;
        const float rx_wx = s_par[14], rx_wy = s_par[15];
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float lam0 = s_par[1] / fmaxf(cfg.f_rx, F(1e-6));
        float w_mn = fminf(rx_wx, rx_wy);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * rx_wx * rx_wy;                         // area
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
    }
    __syncthreads();
    epx_build(cfg, s_par, s_tx, s_epx, tid, T);
    const Epx ix(cfg, s_epx);

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const int n_rect = s_cnt[0];
    const int base = cfg.omni ? 3 : 5;        // trace_lane's r0 + 2 or r0 + 4
    const int stride_d = 3 + 3 * n_tx;        // draws a depth
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: the flagship kernel's
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int r1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && r1 < 32) w_take[r1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float* sl = w_slots + FLAG_SLOT * (slot < 0 ? 0 : slot);
        float4* sl4 = reinterpret_cast<float4*>(sl);
        long long lane = next + j;
        int depth = 0;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            depth = __float_as_int(sl4[2].w);
        }
        const int d0 = base + stride_d * depth;
        float u5[5];
        // [k1 stage: draws]  RAY's draws 0-4
        if (slot >= 0 && !shade) flag_draws5(cfg, uniforms, lane, 0, u5);
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive ray (draws 0..4)
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                const float cvel = sp[1];
                t_rx0 = cfg.gate ? 0.0f
                                 : cfg.t_start + u5[0] * cfg.t_window;
                const int r0 = 1;
                if (cfg.rx_phased) {
                    // the analog phased array (trace_lane's)
                    float u1 = u5[r0], u2 = u5[r0 + 1];
                    float iwx = 1.0f / fmaxf(rx_wx, F(1e-20));
                    float iwy = 1.0f / fmaxf(rx_wy, F(1e-20));
                    float snx = rxm[0] * iwx, sny = rxm[4] * iwx,
                          snz = rxm[8] * iwx;
                    float tnx = rxm[1] * iwy, tny = rxm[5] * iwy,
                          tnz = rxm[9] * iwy;
                    float lxr = (2.0f * u1 - 1.0f) * sp[30];
                    float lyr = (2.0f * u2 - 1.0f) * sp[31];
                    ox = rxm[3] + lxr * snx + lyr * tnx;
                    oy = rxm[7] + lxr * sny + lyr * tny;
                    oz = rxm[11] + lxr * snz + lyr * tnz;
                    const float nzx = s_rxc[0], nzy = s_rxc[1],
                                nzz = s_rxc[2];
                    float u3 = u5[r0 + 2], u4 = u5[r0 + 3];
                    float rr = sqrtf(u3);
                    float ph = TP * u4;
                    float tx_ = rr * fast_cos(ph), ty_ = rr * fast_sin(ph);
                    float tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
                    dx = s_rxc[8] * tx_ + s_rxc[11] * ty_ + nzx * tz;
                    dy = s_rxc[9] * tx_ + s_rxc[12] * ty_ + nzy * tz;
                    dz = s_rxc[10] * tx_ + s_rxc[13] * ty_ + nzz * tz;
                    float lam = cvel / fmaxf(cfg.f_rx, F(1e-6));
                    float w0 = F(4.0 * 3.141592653589793) * sp[30] * sp[31]
                               * sp[32];
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                    thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz,
                                            lam);
                } else if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float u1 = u5[r0], u2 = u5[r0 + 1];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float u1 = u5[r0], u2 = u5[r0 + 1];
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = u5[r0 + 2], u4 = u5[r0 + 3];
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / rc[5]);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(rc[4] * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + rc[6] * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = rc[7];
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                live = true;
            }
            next += stride;
        } else {
            // [k1 stage: hit]  the path from its slot, the hit point
            float nx = 0.0f, ny = 0.0f, nz = 0.0f, rb = 0.0f, txc = 0.0f,
                  hx = 0.0f, hy = 0.0f, hz = 0.0f;
            const float cvel = sp[1];
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            if (slot >= 0) {
                const float4 a = sl4[0], b = sl4[1], c = sl4[2];
                thr = a.w;
                dx = b.x;
                dy = b.y;
                dz = b.z;
                t_rx0 = c.x;
                const float tb = c.y;
                const int pw = __float_as_int(c.z);
                const float4 nrb = s_rec[FLAG_REC * pw + 3];
                nx = nrb.x;
                ny = nrb.y;
                nz = nrb.z;
                rb = nrb.w;
                txc = s_rec[FLAG_REC * pw + 4].x;
                plen = b.w + tb;
                hx = a.x + tb * dx;
                hy = a.y + tb * dy;
                hz = a.z + tb * dz;
            }
            // each transmitter in row order: the direct hit of the one the
            // path is on (depth 0), or the NEE from a hit off them; each
            // contribution splats in its own warp splat
            for (int t = 0; t < n_tx; ++t) {
                float val = 0.0f, yb = 0.0f;
                const Tx tr = tx_row(s_tx + t * TXP_COLS);
                const float* m = tr.m;
                if (slot >= 0 && txc < 0.0f) {
                    // [k1 stage: nee]
                    float u3[3];
                    epw_draws3(cfg, uniforms, lane, d0 + 1 + 3 * t, u3);
                    float glx = 2.0f * u3[0] - 1.0f;
                    float gly = 2.0f * u3[1] - 1.0f;
                    float qx = m[0] * glx + m[1] * gly + m[3];
                    float qy = m[4] * glx + m[5] * gly + m[7];
                    float qz = m[8] * glx + m[9] * gly + m[11];
                    float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                    float dist2 = vx * vx + vy * vy + vz * vz;
                    float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                    float inv_d = 1.0f / dist;
                    float wx_ = vx * inv_d, wy_ = vy * inv_d,
                          wz_ = vz * inv_d;
                    float cos_tx = -(wx_ * tr.nx + wy_ * tr.ny
                                     + wz_ * tr.nz);
                    if (cos_tx > F(1e-6)) {
                        float pdf_sa = (1.0f / fmaxf(tr.area, F(1e-12)))
                                       * dist2 / fmaxf(cos_tx, F(1e-6));
                        float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        float f_cos = rb * F(1.0 / 3.141592653589793)
                                      * fmaxf(co, 0.0f);
                        float t_emit, t_recv, w_gate;
                        tr.emission((plen + dist) / cvel, u3[2], t_rx0,
                                    cfg.gate, t_start, t_window, &t_emit,
                                    &t_recv, &w_gate, nullptr);
                        float f_emit = tr.inst_freq(t_emit);
                        float sig = tr.eval_wdf(t_emit, f_emit);
                        // [k1 stage: nee_pairs]
                        float ap = tx_gain_epx(tr, t, ix, glx, gly, qx, qy,
                                               qz, wx_, wy_, wz_,
                                               cvel / fmaxf(f_emit,
                                                            F(1e-6)));
                        // [k1 stage: nee]
                        float w_tx = sig * tr.gain * ap * TP;
                        float off = F(1e-4) * sign0(cos_s);
                        float sx = hx + off * nx, sy = hy + off * ny,
                              sz = hz + off * nz;
                        float limit = dist * F(0.999);
                        // [k1 stage: shadow]
                        bool occ = false;
                        const float4* blk = s_blk + 3 * t * np;
                        for (int r = 0; r < s_cnt[1 + t] && !occ; ++r) {
                            float t_p;
                            bool hit_p = rect_hit4(blk + 3 * r, sx, sy, sz,
                                                   wx_, wy_, wz_, &t_p);
                            occ = hit_p && t_p > F(1e-4) && t_p < limit;
                        }
                        // [k1 stage: nee]
                        if (!occ && pdf_sa > 0.0f) {
                            val = thr * f_cos * w_tx * w_gate
                                  / fmaxf(pdf_sa, F(1e-30));
                            yb = (t_recv - t_start) / t_window * n_time_f
                                 - 0.5f;
                            events += val != 0.0f;
                        }
                    }
                } else if (slot >= 0 && depth == 0 && txc == (float)t) {
                    // [k1 stage: direct]
                    float cos_dh = -(dx * tr.nx + dy * tr.ny + dz * tr.nz);
                    if (cos_dh > 0.0f) {
                        float te_h, tr_h, wg_h;
                        tr.emission(plen / cvel,
                                    flag_draw1(cfg, uniforms, lane, d0),
                                    t_rx0, cfg.gate, t_start, t_window,
                                    &te_h, &tr_h, &wg_h, nullptr);
                        float fe_h = tr.inst_freq(te_h);
                        float sig_h = tr.eval_wdf(te_h, fe_h);
                        float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                        float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                     + (hz - m[11]) * m[8])
                                    / fmaxf(tr.wx * tr.wx, F(1e-12));
                        float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                     + (hz - m[11]) * m[9])
                                    / fmaxf(tr.wy * tr.wy, F(1e-12));
                        float ap_h = tx_gain_epx(tr, t, ix, lxh, lyh, hx, hy,
                                                 hz, dx, dy, dz, lam_h);
                        float w_dh = sig_h * tr.gain * ap_h * TP;
                        val = thr * w_dh * wg_h;
                        yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                        events += val != 0.0f;
                    }
                }
                // [k1 stage: splat]
                flag_splat(w_row, w_mask, w_vals, cfg.n_time, val, yb, j);
                // [k1 stage: hit]
            }
            // [k1 stage: bounce]  the diffuse bounce (draws d0 + 1 + 3
            // n_tx, + 2; none after the last depth, from an absorbing hit
            // or on a transmitter)
            if (slot >= 0 && depth < cfg.max_depth - 1 && rb > 0.0f
                && txc < 0.0f) {
                float u2[3];
                epw_draws3(cfg, uniforms, lane, d0 + 1 + 3 * n_tx, u2);
                float u8 = u2[0], u9 = u2[1];
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float rr2 = sqrtf(u8);
                float ph2 = TP * u9;
                float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                dx = s1x * bx + s2x * by + fx * bz;
                dy = s1y * bx + s2y * by + fy * bz;
                dz = s1z * bx + s2z * by + fz * bz;
                thr = thr * rb;
                ox = hx + F(1e-4) * fx;
                oy = hy + F(1e-4) * fy;
                oz = hz + F(1e-4) * fz;
                depth = depth + 1;
                live = true;
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + FLAG_REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                     __int_as_float(depth));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     0.0f, 0.0f);
            }
        }
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo = slot >= 0 && slot < 32, hi = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi && hit ? bit : 0u);
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's row: its warps' rows summed in warp order; its events
    partial += pulse * gridDim.x * (long long)cfg.n_time;
    part_ev += pulse * gridDim.x;
    for (int b = tid; b < cfg.n_time; b += T) {
        double s = 0.0;
        for (int w = 0; w < T / 32; ++w)
            s += reinterpret_cast<const double*>(
                s_warps + w * wbytes + flag_row_offset())[b];
        partial[(long long)blockIdx.x * cfg.n_time + b] = s;
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(fsm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The Doppler family (power or coherent) runs 128-thread blocks held to
// 128 registers, four blocks an SM: unbounded, the receive types took the
// Doppler mesh instantiation to 135 registers, three blocks an SM, and
// multi_body's kernel 13% slower (tools/tree_ab.py); bounded, it spills a
// few bytes and runs as fast as before.
template <bool MESH, bool COH, bool MED, bool EP = false, bool LOB = false>
__global__ void __launch_bounds__(DOP_THREADS, 4)
receive_doppler_kernel(const float* __restrict__ params,
                       const float* __restrict__ prim,
                       const float* __restrict__ txp,
                       const float* __restrict__ msh,
                       const float* __restrict__ uniforms, bvh::Tables mesh,
                       float* __restrict__ lane_val,
                       double* __restrict__ partial,
                       unsigned long long* __restrict__ part_ev, Cfg cfg) {
    trace_block<MESH, true, COH, false, MED, EP, LOB>(params, prim, txp, msh,
                                                      uniforms, mesh,
                                                      lane_val, partial,
                                                      part_ev, cfg);
}

// ---- the coherent kernel --------------------------------------------------
//
// The coherent configuration on analytic scenes (I / Q, one Wigner
// transmitter, a Wigner or omni receiver, vacuum; receive_doppler_kernel<
// false, true, false> before) runs a kernel of its own, built as the
// flagship kernel is: its lane is trace_lane's, operation by operation,
// and what differs is which thread runs which part of which lane, and when
// (PERF.md):
//  - A wavefront inside each warp.  A warp keeps a pool of COH_POOL paths
//    waiting to be shaded, in shared memory; each turn of its loop runs
//    SHADE over 32 waiting paths when 32 wait (direct hit or NEE, the echo
//    phase, the bounce: a diffuse cosine, a GGX half vector or a mirror),
//    else RAY over the warp's next 32 lanes (the receive frequency by
//    receive type, the receive ray and its Doppler factor), else the rest
//    of SHADE; either traces the rays it made, and a hit waits in its slot
//    (origin, throughput, direction, path length, receive time, hit,
//    depth and the mirror flag, lane, Doppler factor, lane sum: 16 floats)
//    while a miss ends the lane.  A mirror chain is a path that SHADE
//    continues with no NEE, its next vertex counting a direct hit.
//  - The splat.  SHADE is a point all 32 threads reach together.  A 1-D
//    grid of at most COH_ROW_VALS values (I and Q interleaved: the pulse
//    train's 16, a CPI's pulse of 8 bins) goes to the warp's row of
//    doubles, each value owned by one lane (v mod 32), which adds the
//    taps landing on it in lane order (coh_splat_rows): no atomics, and
//    repeats are bit-identical.  Larger grids (the dechirp's and the
//    corner's 1,024 bins, a 2-D grid) keep the block's float grid of
//    shared-memory atomics (mode 1) or the global float64 grid (mode 2):
//    there a contribution's taps spread over the grid and a warp's rarely
//    meet, and a warp row of 2,048 doubles would take 16 KB a warp (four
//    warps' rows and pools 83 KB a block: two blocks an SM).
//  - Draws a stage at a time: RAY's six and SHADE's five (its NEE's three
//    and its bounce's two) from the two Philox blocks that hold them,
//    taken at the stage's start by every thread; the direct hit's draw d0
//    where it is used (depth 0, or after a mirror).
//  - The Wigner receiver's frame, and its lobe mixture where every lane's
//    receive frequency is the call's, computed once a block with
//    trace_lane's expressions.
//  - Tables laid out for the card: a rectangle is COH_REC float4s (its
//    world-to-local rows, unit normal and reflectance, transmitter column
//    and lobe, conductor k and velocity); the rectangles that can shadow
//    an NEE have a list of their own.
// The packed tables, the positional draws, the tent, the partial rows,
// the reduce and the CPI's pulse axis are the other configurations'.  The
// tags "[k1 stage: ...]" name each stage for tools/k1_mix.py.
constexpr int COH_THREADS = 128;    // four warps a block
constexpr int COH_POOL = 64;        // paths a warp
constexpr int COH_SLOT = 16;        // floats a path: four float4s
constexpr int COH_REC = 6;          // float4s a rectangle
constexpr int COH_ROW_VALS = 512;   // the largest warp row, in doubles
constexpr int COH_RXC = 16;         // the receiver's frame
// Blocks an SM the coherent kernel is held to: six (80 registers, ~100 B
// spilled, 24 warps) ran the pulse train 0.95 and the dechirp 0.97 of no
// bound (123 registers, 16 warps); five (96) 0.98 / 1.01 (PERF.md)
constexpr int COH_MIN_BLOCKS = 6;

// Whether a grid goes to warp rows: 1-D, in mode 1, at most COH_ROW_VALS
// values (I and Q of n_time bins).
__host__ __device__ constexpr bool coh_rows(int n_time, int n_freq,
                                            int mode) {
    return mode == 1 && n_freq == 1 && 2 * n_time <= COH_ROW_VALS;
}
// Shared bytes of one warp's area: its paths, a turn's slots, the
// splat's staging (I and Q of two taps a lane, each lane's first row
// value), then (warp rows) its row of 2 n_time doubles.
__host__ __device__ constexpr int coh_row_offset() {
    return 4 * (COH_POOL * COH_SLOT + 32 + 160);
}
__host__ __device__ constexpr int coh_warp_bytes(int n_time, bool rows) {
    return (coh_row_offset() + (rows ? 16 * n_time : 0) + 15) & ~15;
}
// Shared bytes of a block's tables, ahead of the warps' areas: the
// rectangles, the shadowing rectangles' rows, params, the transmitter row
// and its unit normal, the receiver's frame, two counts.
__host__ __device__ constexpr int coh_table_bytes(int n_prims, int n_params) {
    return (16 * (COH_REC + 3) * n_prims
            + 4 * (n_params + TXP_COLS + 4 + COH_RXC + 4) + 15)
           & ~15;
}

// Philox4x32-10 block g of a lane under the pulse's key.
__device__ __forceinline__ uint4 coh_block(unsigned long long key,
                                           long long lane, int g) {
    return philox4x32_10(
        make_uint4((uint32_t)lane, (uint32_t)(lane >> 32), (uint32_t)g, 0u),
        make_uint2((uint32_t)key, (uint32_t)(key >> 32)));
}

// RAY's draws 0-5 (blocks 0 and 1), or the injected pulse's `u`.
__device__ __forceinline__ void coh_ray_draws(const Cfg& cfg, const float* u,
                                              unsigned long long key,
                                              long long lane, float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 6; ++k)
            out[k] = u[(long long)k * cfg.n_lanes + lane];
        return;
    }
    const uint4 a = coh_block(key, lane, 0), b = coh_block(key, lane, 1);
    out[0] = flag_unit(a.x);
    out[1] = flag_unit(a.y);
    out[2] = flag_unit(a.z);
    out[3] = flag_unit(a.w);
    out[4] = flag_unit(b.x);
    out[5] = flag_unit(b.y);
}

// SHADE's draws first .. first + 4 (first = d0 + 1), from the two blocks
// that hold them.
__device__ __forceinline__ void coh_draws5(const Cfg& cfg, const float* u,
                                           unsigned long long key,
                                           long long lane, int first,
                                           float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 5; ++k)
            out[k] = u[(long long)(first + k) * cfg.n_lanes + lane];
        return;
    }
    const uint4 a = coh_block(key, lane, first >> 2);
    const uint4 b = coh_block(key, lane, (first >> 2) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int o = first & 3;
#pragma unroll
    for (int k = 0; k < 5; ++k)
        out[k] = flag_unit(o == 0 ? w[k] : o == 1 ? w[k + 1]
                           : o == 2 ? w[k + 2] : w[k + 3]);
}

// One draw of a lane (the direct hit's d0).
__device__ __forceinline__ float coh_draw1(const Cfg& cfg, const float* u,
                                           unsigned long long key,
                                           long long lane, int idx) {
    if (!cfg.use_prng) return u[(long long)idx * cfg.n_lanes + lane];
    const uint4 w = coh_block(key, lane, idx >> 2);
    const int k = idx & 3;
    return flag_unit(k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w);
}

// The warp's tent splat of each thread's (I, Q, yb) into its row of
// 2 n_time doubles (I = Q = 0: nothing); every thread of the warp calls
// it.  A lane's two taps are four row values, 2 i0 .. 2 i0 + 3: I and Q at
// bin i0 (weight wt0), then at bin i0 + 1 (wt1).  Each lane stages them;
// then, for each staging lane in lane order, the lane that owns row value
// v (lane v mod 32) adds, in double, the staged value that lands on v.
// Each value thus sums its taps in lane order, no two lanes touch one
// value, and nothing is atomic.
// [k1 splat]
__device__ __forceinline__ void coh_splat_rows(double* row, float* vals,
                                               int n_time, float ci,
                                               float si, float yb, int j) {
    int i0 = -2;
    float c0 = 0.0f, s0 = 0.0f, c1 = 0.0f, s1 = 0.0f;
    if (ci != 0.0f || si != 0.0f) {
        float b0 = floorf(yb);
        if (b0 >= -1.0f && b0 < (float)n_time) {   // also drops NaN
            float b1 = b0 + 1.0f;
            float wt0 = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
            float wt1 = fmaxf(1.0f - fabsf(yb - b1), 0.0f);
            i0 = (int)b0;
            c0 = ci * wt0;
            s0 = si * wt0;
            c1 = ci * wt1;
            s1 = si * wt1;
        }
    }
    unsigned go = __ballot_sync(FULL_MASK, i0 != -2);
    if (go == 0u) return;
    int* first = reinterpret_cast<int*>(vals + 128);   // 2 i0 of each lane
    vals[j] = c0;
    vals[32 + j] = s0;
    vals[64 + j] = c1;
    vals[96 + j] = s1;
    first[j] = 2 * i0;
    __syncwarp();
    const int n_vals = 2 * n_time;
    while (go != 0u) {
        const int k = __ffs(go) - 1;
        go &= go - 1u;
        const int v0 = first[k];
        const int d = (j - v0) & 31;          // this lane's value of lane k
        const int v = v0 + d;
        if (d < 4 && v >= 0 && v < n_vals)
            row[v] = row[v] + (double)vals[32 * d + k];
    }
}

template <bool TEX, bool PRIM = false>
__global__ void __launch_bounds__(COH_THREADS, COH_MIN_BLOCKS)
receive_coherent_kernel(const float* __restrict__ params,
                        const float* __restrict__ prim,
                        const float* __restrict__ txp,
                        const float* __restrict__ msh,
                        const float* __restrict__ uniforms, bvh::Tables mesh,
                        float* __restrict__ lane_val,
                        double* __restrict__ partial,
                        unsigned long long* __restrict__ part_ev, Cfg cfg) {
    extern __shared__ float4 csm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = csm;
    float4* s_blk = s_rec + COH_REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    const bool rows = coh_rows(cfg.n_time, cfg.n_freq, cfg.mode);
    char* s_warps = reinterpret_cast<char*>(csm)
                    + coh_table_bytes(np, cfg.n_params);
    const int wbytes = coh_warp_bytes(cfg.n_time, rows);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * COH_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + coh_row_offset());
    // the values of a pulse's grid: I and Q of each cell
    const long long n_vals = 2LL * cfg.n_time * cfg.n_freq;
    // mode 1 without warp rows: the block's float grid after the warps'
    float* s_grid = reinterpret_cast<float*>(s_warps + (T / 32) * wbytes);
    // TEX: each rectangle's texture record, after the block's grid
    float4* s_tex = reinterpret_cast<float4*>(
        reinterpret_cast<char*>(s_grid)
        + (cfg.mode == 1 && !rows ? (4 * n_vals + 15) & ~15LL : 0LL));
    // PRIM: the kinds of the prim records, then of the shadowing rows,
    // after the texture records where there are any
    int* s_kind = reinterpret_cast<int*>(s_tex + (TEX ? 2 * np : 0));

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    if (rows) {
        for (int i = j; i < 2 * cfg.n_time; i += 32) w_row[i] = 0.0;
    } else if (cfg.mode == 1) {
        for (long long i = tid; i < n_vals; i += T) s_grid[i] = 0.0f;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        // PRIM: the spheres, disks and cylinders among them, in prim order
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            const int kd = (int)row[0];
            if constexpr (PRIM) {
                if (kd != RECTANGLE && kd != SPHERE && kd != DISK
                    && kd != CYLINDER)
                    continue;
            } else if (kd != RECTANGLE) {
                continue;
            }
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + COH_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            if constexpr (TEX)
                tex_record(s_tex + 2 * (nr - 1), row, p, cfg.grid, np,
                           cfg.g_w);
            if constexpr (PRIM) s_kind[nr - 1] = kd;
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
                if constexpr (PRIM) s_kind[np + nb - 1] = kd;
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
    }
    __syncthreads();
    if (tid == 0) {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame, trace_lane's expressions
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * s_par[14] * s_par[15];                 // area
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
        // the lobe mixture of a receive frequency every lane shares (raw
        // receive on a 1-D grid; mix_resample and the LO's raw_resample
        // under gate sampling, read at mid-window): RAY's expressions
        float t_mid = 0.0f + (cfg.gate ? 0.5f * cfg.t_window : 0.0f);
        float f_rx = cfg.rule == RX_MIX ? Wave{s_tx + 16, s_tx + 28}
                                              .inst_freq(t_mid)
                     : cfg.rule == RX_RAW_LO
                         ? Wave{s_par + 33, s_par + 41}.inst_freq(t_mid)
                         : cfg.f_rx;
        float lam0 = s_par[1] / fmaxf(f_rx, F(1e-6));
        float w_mn = fminf(s_par[14], s_par[15]);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    // the pulse's uniforms, Philox key and lane sums, held a block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + (cfg.omni ? 2 : 4);
    // every lane's receive frequency is the block's (s_rxc[4:8])
    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);
    Grid grid;
    grid.s = cfg.mode == 1 ? s_grid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + COH_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            // TEX: the hit rectangle rides bits 17 and up
            wdel = ((TEX ? dw & 0x1ffff : dw) >> 16) != 0;
        }
        const int d0 = base + 6 * depth;
        float ud[6];
        // [k1 stage: draws]
        if (slot >= 0) {
            if (shade)
                coh_draws5(cfg, u_p, key, lane, d0 + 1, ud);
            else
                coh_ray_draws(cfg, u_p, key, lane, ud);
        }
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // SHADE: the contribution's I, Q and time coordinate, and its
        // frequency and receive time (the frequency bin of a 2-D grid)
        float ci = 0.0f, si = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and ray
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = ud[r0 + 2], u4 = ud[r0 + 3];
                    // the lobe mixture: the block's, or this lane's
                    float lam0 = rc[7], k_l = rc[4], k_l1 = rc[5],
                          kc = rc[6];
                    if (!f_call) {
                        lam0 = cvel / fmaxf(f_rx, F(1e-6));
                        float w_mn = fminf(rx_wx, rx_wy);
                        float q = 2.0f * w_mn / (F(0.6) * lam0);
                        k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
                        k_l1 = k_l + 1.0f;
                        kc = 0.5f * (k_l + 1.0f)
                             * F(1.0 / 6.283185307179586);
                    }
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / k_l1);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + kc * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = lam0;
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit rectangle's lobe
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            // TEX: the slot holds the textured reflectance in place of
            // the rectangle, which rides the depth word
            const int pw = TEX ? __float_as_int(c.w) >> 17
                               : __float_as_int(c.z);
            const float4* rec = s_rec + COH_REC * pw;
            const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
            // PRIM: a sphere's or cylinder's normal at the hit
            const float4 nh = PRIM ? prim_normal4(rec, s_kind[pw], nrb, cx,
                                                  cy, cz, dx, dy, dz, tb)
                                   : nrb;
            const float nx = nh.x, ny = nh.y, nz = nh.z,
                        rb = TEX ? c.z : nrb.w;
            const float txc = lob.x, kb = lob.y, ab = lob.z, eb = lob.w;
            const float kk = kv.x, vbx = kv.y, vby = kv.z, vbz = kv.w;
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            tx.vx = s_tx[24];
            tx.vy = s_tx[25];
            tx.vz = s_tx[26];
            tx.w = Wave{s_tx + 16, s_tx + 28};
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_ggx = kb == ROUGH_CONDUCTOR;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // the connection, if any: its power and its phase's inputs
            bool conn = false;
            float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;
            int n_bnd = 0;

            // [k1 stage: direct]  direct transmitter hits at depth 0 and
            // after a mirror bounce
            if (depth == 0 || wdel) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h, k_h = 0.0f;
                    tx.emission(plen / cvel,
                                coh_draw1(cfg, u_p, key, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, &k_h);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    f_recv = fe_h * dop;
                    t_recv = tr_h;
                    dtot = plen;
                    t_emit = te_h;
                    k_c = k_h;
                    conn = true;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits; none from a mirror)
            if (txc < 0.0f && !is_m) {
                float glx = 2.0f * ud[0] - 1.0f;
                float gly = 2.0f * ud[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float f_cos;
                    if (is_ggx) {
                        f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx,
                                         -dy, -dz, wx_, wy_, wz_);
                    } else {
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        f_cos = rb * F(1.0 / 3.141592653589793)
                                * fmaxf(co, 0.0f);
                    }
                    float te_n, tr_n, w_gate, k_nee = 0.0f;
                    tx.emission((plen + dist) / cvel, ud[2], t_rx0, cfg.gate,
                                t_start, t_window, &te_n, &tr_n, &w_gate,
                                &k_nee);
                    float f_emit = tx.inst_freq(te_n);
                    float sig = tx.eval_wdf(te_n, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = PRIM ? prim_hit4(s_blk + 3 * r,
                                                      s_kind[np + r], sx, sy,
                                                      sz, wx_, wy_, wz_, &t_p)
                                          : rect_hit4(s_blk + 3 * r, sx, sy,
                                                      sz, wx_, wy_, wz_,
                                                      &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (tr_n - t_start) / t_window * n_time_f - 0.5f;
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion; the phase adds the
                        // boundary phase of depth + 1 vertices
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        f_recv = f_emit * dop * dop_vtx * dop_tx;
                        t_recv = tr_n;
                        dtot = plen + dist;
                        t_emit = te_n;
                        k_c = k_nee;
                        n_bnd = depth + 1;
                        conn = true;
                    }
                }
            }
            if (conn) {
                // [k1 stage: phase]  the echo phase, I and Q (conn_splat)
                float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit,
                                      t_recv, k_c);
                if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
                float amp = sqrtf(fmaxf(val, 0.0f));
                ci = amp * fast_cos(ph);
                si = amp * fast_sin(ph);
                lsum += amp;
                events += val != 0.0f;
                if (!rows) {
                    // [k1 stage: splat]
                    const Wave txw = tx.w;
                    grid_splat<true>(grid, cfg, ci, si, yb, [&] {
                        return bin_freq(cfg, txw, lo, f_recv, t_recv);
                    });
                }
            }

            // [k1 stage: bounce]  a diffuse cosine, a GGX half vector or a
            // mirror about the flipped normal (none after the last depth,
            // on the transmitter, or from an absorbing hit)
            if (depth < cfg.max_depth - 1 && txc < 0.0f
                && (is_ggx || is_m || rb > 0.0f)) {
                float u8 = ud[3], u9 = ud[4];           // draws d0 + 4, 5
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float ph2 = TP * u9;
                float ndx, ndy, ndz, w_b;
                bool go = true;
                if (is_m) {
                    float dn = dx * fx + dy * fy + dz * fz;
                    ndx = dx - 2.0f * dn * fx;
                    ndy = dy - 2.0f * dn * fy;
                    ndz = dz - 2.0f * dn * fz;
                    w_b = rb * fres_cond(fabsf(dn), eb, kk);
                    go = w_b > 0.0f;
                } else if (is_ggx) {
                    float ag2 = ab * ab;
                    float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                    float cth = rsqrtf(1.0f + tan2);
                    float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                    float hlx = sth * fast_cos(ph2),
                          hly = sth * fast_sin(ph2);
                    float hwx = s1x * hlx + s2x * hly + fx * cth;
                    float hwy = s1y * hlx + s2y * hly + fy * cth;
                    float hwz = s1z * hlx + s2z * hly + fz * cth;
                    float ci_b = fabsf(face);
                    float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                    ndx = 2.0f * idoth * hwx + dx;
                    ndy = 2.0f * idoth * hwy + dy;
                    ndz = 2.0f * idoth * hwz + dz;
                    float co_g = ndx * fx + ndy * fy + ndz * fz;
                    float f_b = fres_cond(fabsf(idoth), eb, kk);
                    float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                    w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth, F(1e-8));
                    go = co_g > 0.0f && idoth > 0.0f && w_b > 0.0f;
                } else {
                    float rr2 = sqrtf(u8);
                    float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                    float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                    ndx = s1x * bx + s2x * by + fx * bz;
                    ndy = s1y * bx + s2y * by + fy * bz;
                    ndz = s1z * bx + s2z * by + fz * bz;
                    w_b = rb;
                }
                if (go) {
                    wdel = is_m;
                    // bounce Doppler of the continued path
                    dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                         + (ndz - dz) * vbz) / cvel);
                    dx = ndx;
                    dy = ndy;
                    dz = ndz;
                    thr = thr * w_b;
                    ox = hx + F(1e-4) * fx;
                    oy = hy + F(1e-4) * fy;
                    oz = hz + F(1e-4) * fz;
                    depth = depth + 1;
                    live = true;
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            float bpx = 0.0f, bpy = 0.0f;      // TEX: the winner's (px, py)
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p, px, py;
                bool hit_p = PRIM ? prim_hit4_uv(s_rec + COH_REC * r,
                                                 s_kind[r], ox, oy, oz, dx,
                                                 dy, dz, &t_p, &px, &py)
                                  : rect_hit4_uv(s_rec + COH_REC * r, ox, oy,
                                                 oz, dx, dy, dz, &t_p, &px,
                                                 &py);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                    if constexpr (TEX) {
                        bpx = px;
                        bpy = py;
                    }
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                if constexpr (TEX)
                    sl4[2] = make_float4(
                        t_rx0, tb,
                        tex_reflectance(s_tex + 2 * pw,
                                        s_rec[COH_REC * pw + 3].w, bpx, bpy,
                                        cfg.grid, cfg.g_w),
                        __int_as_float(depth | (wdel ? 1 << 16 : 0)
                                       | pw << 17));
                else
                    sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                         __int_as_float(
                                             depth | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
            }
        }
        // the lane's sum of amplitudes, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
        if (shade && rows) {
            // [k1 stage: splat]
            coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid: its warps' rows summed in warp order, or its
    // float grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (rows) {
        for (int v = tid; v < n_vals; v += T) {
            double s = 0.0;
            for (int w = 0; w < T / 32; ++w)
                s += reinterpret_cast<const double*>(
                    s_warps + w * wbytes + coh_row_offset())[v];
            partial[(long long)blockIdx.x * n_vals + v] = s;
        }
    } else if (cfg.mode == 1) {
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = (double)s_grid[v];
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(csm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The untextured coherent kernel, instantiated where it is defined, so
// that the module keeps its kernels' order: instantiated where it is
// used, at the module's end, it left every kernel's PTX as it was but for
// its labels' numbers, and ptxas then gave the endpoint kernel other
// machine code.  The texture twin is instantiated where it is used.
template __global__ void receive_coherent_kernel<false>(
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, bvh::Tables, float* __restrict__,
    double* __restrict__, unsigned long long* __restrict__, Cfg);

// ---- the coherent endpoint kernel: the coherent kernel's turns ----------
//
// The coherent endpoint twin on analytic scenes (receive_doppler_kernel<
// false, true, false, true> before) runs the coherent kernel's turns, warp
// rows and draws, with the power endpoint kernel's transmitter loop: its
// lane is trace_lane's coherent endpoint path, operation by operation
// (the receive frequency by receive type, the Wigner, omni or analog
// phased receiver's ray, the Doppler factors, the mirror chains and GGX
// lobes, the echo phase of each connection with its transmitter's
// waveform).  A SHADE turn runs every transmitter in row order over all 32
// threads: the direct hit of the one a path is on, or its NEE (three draws
// taken where it starts, the kind's aperture weight through the footprint
// index, its own list of shadowing rectangles), each connection's I and Q
// splatting in turn: in the warp's row (coh_splat_rows, bit-identical
// repeats) on a 1-D grid of at most COH_ROW_VALS values, else the block's
// or the global grid.  The bounce's draws are d0 + 1 + 3 n_tx, + 2.

// Blocks an SM the coherent endpoint kernel is held to: six (80 registers,
// ~330 B spilled) ran 0.95 of four (128), five 0.96, three 1.13 (PERF.md)
constexpr int EPC_MIN_BLOCKS = 6;

// Draws first .. first + 2 of a lane (an NEE's three, or the bounce's
// two and the next), from the one or two blocks that hold them, or the
// injected pulse's `u`.
__device__ __forceinline__ void epc_draws3(const Cfg& cfg, const float* u,
                                           unsigned long long key,
                                           long long lane, int first,
                                           float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
            out[k] = u[(long long)(first + k) * cfg.n_lanes + lane];
        return;
    }
    const int o = first & 3;
    const uint4 a = coh_block(key, lane, first >> 2);
    uint4 b = a;
    if (o > 1) b = coh_block(key, lane, (first >> 2) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 3; ++k)
        out[k] = flag_unit(o == 0 ? w[k] : o == 1 ? w[k + 1]
                           : o == 2 ? w[k + 2] : w[k + 3]);
}

__global__ void __launch_bounds__(COH_THREADS, EPC_MIN_BLOCKS)
receive_endpoint_coherent_kernel(const float* __restrict__ params,
                        const float* __restrict__ prim,
                        const float* __restrict__ txp,
                        const float* __restrict__ msh,
                        const float* __restrict__ uniforms, bvh::Tables mesh,
                        float* __restrict__ lane_val,
                        double* __restrict__ partial,
                        unsigned long long* __restrict__ part_ev, Cfg cfg) {
    extern __shared__ float4 csm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims, n_tx = cfg.n_tx;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * n_tx * TXP_COLS;
    float4* s_rec = csm;
    float4* s_blk = s_rec + COH_REC * np;    // transmitter t's at t np
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * n_tx * np);
    float* s_tx = s_par + cfg.n_params;      // rows, normals in 29-31
    float* s_rxc = s_tx + MAX_TX * TXP_COLS; // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    float* s_epx = reinterpret_cast<float*>(
        reinterpret_cast<char*>(csm)
        + ep_index_offset(np, cfg.n_params, n_tx, COH_REC, COH_RXC));
    const bool rows = coh_rows(cfg.n_time, cfg.n_freq, cfg.mode);
    char* s_warps = reinterpret_cast<char*>(csm)
                    + ep_table_bytes(np, cfg.n_params, n_tx, cfg.n_pairs,
                                     cfg.n_rx_pairs, COH_REC, COH_RXC);
    const int wbytes = coh_warp_bytes(cfg.n_time, rows);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * COH_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + coh_row_offset());
    // the values of a pulse's grid: I and Q of each cell
    const long long n_vals = 2LL * cfg.n_time * cfg.n_freq;
    // mode 1 without warp rows: the block's float grid after the warps'
    float* s_grid = reinterpret_cast<float*>(s_warps + (T / 32) * wbytes);

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < n_tx * TXP_COLS; i += T) s_tx[i] = txp[i];
    if (rows) {
        for (int i = j; i < 2 * cfg.n_time; i += 32) w_row[i] = 0.0;
    } else if (cfg.mode == 1) {
        for (long long i = tid; i < n_vals; i += T) s_grid[i] = 0.0f;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // to transmitter t (all but its own, t in column 14)
        int nr = 0;
        int nb[MAX_TX] = {0, 0, 0, 0};
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + COH_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            for (int t = 0; t < n_tx; ++t) {
                if (row[14] == (float)t) continue;
                float4* b = s_blk + 3 * (t * np + nb[t]++);
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        for (int t = 0; t < MAX_TX; ++t) s_cnt[1 + t] = nb[t];
    }
    __syncthreads();
    // each transmitter row's unit normal (trace_block's)
    for (int t = tid; t < n_tx; t += T) {
        float* r = s_tx + t * TXP_COLS;
        float tnn = rsqrtf(fmaxf(r[2] * r[2] + r[6] * r[6] + r[10] * r[10],
                                 F(1e-20)));
        r[29] = r[2] * tnn;
        r[30] = r[6] * tnn;
        r[31] = r[10] * tnn;
    }
    if (tid == 0) {
        // the receiver's frame, trace_lane's expressions
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * s_par[14] * s_par[15];                 // area
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
        // the lobe mixture of a receive frequency every lane shares (raw
        // receive on a 1-D grid; mix_resample and the LO's raw_resample
        // under gate sampling, read at mid-window): RAY's expressions
        float t_mid = 0.0f + (cfg.gate ? 0.5f * cfg.t_window : 0.0f);
        float f_rx = cfg.rule == RX_MIX ? Wave{s_tx + 16, s_tx + 28}
                                              .inst_freq(t_mid)
                     : cfg.rule == RX_RAW_LO
                         ? Wave{s_par + 33, s_par + 41}.inst_freq(t_mid)
                         : cfg.f_rx;
        float lam0 = s_par[1] / fmaxf(f_rx, F(1e-6));
        float w_mn = fminf(s_par[14], s_par[15]);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
    }
    __syncthreads();
    epx_build(cfg, s_par, s_tx, s_epx, tid, T);
    const Epx ix(cfg, s_epx);

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0];
    // the pulse's uniforms, Philox key and lane sums, held a block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + (cfg.omni ? 2 : 4);
    // every lane's receive frequency is the block's (s_rxc[4:8])
    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);
    Grid grid;
    grid.s = cfg.mode == 1 ? s_grid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + COH_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            wdel = (dw >> 16) != 0;
        }
        const int d0 = base + (3 + 3 * n_tx) * depth;
        float ud[6];
        // [k1 stage: draws]  RAY's six (SHADE's where they are used)
        if (slot >= 0 && !shade) coh_ray_draws(cfg, u_p, key, lane, ud);
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // SHADE: the contribution's I, Q and time coordinate, and its
        // frequency and receive time (the frequency bin of a 2-D grid)
        float ci = 0.0f, si = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and ray
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                if (cfg.rx_phased) {
                    // the analog phased array (trace_lane's): a point on
                    // its bounding rectangle, the cosine hemisphere, its
                    // cross-WDF through the footprint index
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float iwx = 1.0f / fmaxf(rx_wx, F(1e-20));
                    float iwy = 1.0f / fmaxf(rx_wy, F(1e-20));
                    float snx = rxm[0] * iwx, sny = rxm[4] * iwx,
                          snz = rxm[8] * iwx;
                    float tnx = rxm[1] * iwy, tny = rxm[5] * iwy,
                          tnz = rxm[9] * iwy;
                    float lxr = (2.0f * u1 - 1.0f) * sp[30];
                    float lyr = (2.0f * u2 - 1.0f) * sp[31];
                    ox = rxm[3] + lxr * snx + lyr * tnx;
                    oy = rxm[7] + lxr * sny + lyr * tny;
                    oz = rxm[11] + lxr * snz + lyr * tnz;
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = ud[r0 + 2], u4 = ud[r0 + 3];
                    float rr = sqrtf(u3);
                    float ph = TP * u4;
                    float tx_ = rr * fast_cos(ph), ty_ = rr * fast_sin(ph);
                    float tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = cvel / fmaxf(f_rx, F(1e-6));
                    float w0 = F(4.0 * 3.141592653589793) * sp[30] * sp[31]
                               * sp[32];
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                    // [k1 stage: rx_pairs]
                    thr = w0 * pair_sum_epx(ix, n_tx, ox, oy, oz, dx, dy, dz,
                                            lam);
                    // [k1 stage: ray]
                } else if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = ud[r0 + 2], u4 = ud[r0 + 3];
                    // the lobe mixture: the block's, or this lane's
                    float lam0 = rc[7], k_l = rc[4], k_l1 = rc[5],
                          kc = rc[6];
                    if (!f_call) {
                        lam0 = cvel / fmaxf(f_rx, F(1e-6));
                        float w_mn = fminf(rx_wx, rx_wy);
                        float q = 2.0f * w_mn / (F(0.6) * lam0);
                        k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
                        k_l1 = k_l + 1.0f;
                        kc = 0.5f * (k_l + 1.0f)
                             * F(1.0 / 6.283185307179586);
                    }
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / k_l1);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + kc * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = lam0;
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else {
            // [k1 stage: hit]  the path from its slot (slot >= 0), the hit
            // point and the hit rectangle's lobe; every thread of the warp
            // runs SHADE's transmitter loop, whose splats it shares
            const bool on = slot >= 0;
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const float4* rec = s_rec + COH_REC * (on ? __float_as_int(c.z)
                                                      : 0);
            const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
            const float nx = nrb.x, ny = nrb.y, nz = nrb.z, rb = nrb.w;
            // off a slot, no transmitter's index and no NEE
            const float txc = on ? lob.x : -2.0f;
            const float kb = lob.y, ab = lob.z, eb = lob.w;
            const float kk = kv.x, vbx = kv.y, vby = kv.z, vbz = kv.w;
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_ggx = kb == ROUGH_CONDUCTOR;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // each transmitter in row order: the direct hit of the one the
            // path is on (at depth 0 and after a mirror bounce), or the NEE
            // from a hit off them (none from a mirror); each connection's
            // I and Q splat in turn
            for (int t = 0; t < n_tx; ++t) {
                const Tx tr = tx_row(s_tx + t * TXP_COLS);
                const float* m = tr.m;
                bool conn = false;
                float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;
                int n_bnd = 0;
                ci = 0.0f;
                si = 0.0f;
                // [k1 stage: direct]
                if ((depth == 0 || wdel) && txc == (float)t) {
                    float cos_dh = -(dx * tr.nx + dy * tr.ny + dz * tr.nz);
                    if (cos_dh > 0.0f) {
                        float te_h, tr_h, wg_h, k_h = 0.0f;
                        tr.emission(plen / cvel,
                                    coh_draw1(cfg, u_p, key, lane, d0),
                                    t_rx0, cfg.gate, t_start, t_window,
                                    &te_h, &tr_h, &wg_h, &k_h);
                        float fe_h = tr.inst_freq(te_h);
                        float sig_h = tr.eval_wdf(te_h, fe_h);
                        float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                        float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                     + (hz - m[11]) * m[8])
                                    / fmaxf(tr.wx * tr.wx, F(1e-12));
                        float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                     + (hz - m[11]) * m[9])
                                    / fmaxf(tr.wy * tr.wy, F(1e-12));
                        float ap_h = tx_gain_epx(tr, t, ix, lxh, lyh, hx, hy,
                                                 hz, dx, dy, dz, lam_h);
                        float w_dh = sig_h * tr.gain * ap_h * TP;
                        val = thr * w_dh * wg_h;
                        yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                        f_recv = fe_h * dop;
                        t_recv = tr_h;
                        dtot = plen;
                        t_emit = te_h;
                        k_c = k_h;
                        conn = true;
                    }
                }
                // [k1 stage: nee]
                if (on && txc < 0.0f && !is_m) {
                    float u3[3];
                    epc_draws3(cfg, u_p, key, lane, d0 + 1 + 3 * t, u3);
                    float glx = 2.0f * u3[0] - 1.0f;
                    float gly = 2.0f * u3[1] - 1.0f;
                    float qx = m[0] * glx + m[1] * gly + m[3];
                    float qy = m[4] * glx + m[5] * gly + m[7];
                    float qz = m[8] * glx + m[9] * gly + m[11];
                    float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                    float dist2 = vx * vx + vy * vy + vz * vz;
                    float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                    float inv_d = 1.0f / dist;
                    float wx_ = vx * inv_d, wy_ = vy * inv_d,
                          wz_ = vz * inv_d;
                    float cos_tx = -(wx_ * tr.nx + wy_ * tr.ny
                                     + wz_ * tr.nz);
                    if (cos_tx > F(1e-6)) {
                        float pdf_sa = (1.0f / fmaxf(tr.area, F(1e-12)))
                                       * dist2 / fmaxf(cos_tx, F(1e-6));
                        float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                        float f_cos;
                        if (is_ggx) {
                            f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx,
                                             -dy, -dz, wx_, wy_, wz_);
                        } else {
                            float sg = sgn_ge(-dx * nx + -dy * ny
                                              + -dz * nz);
                            float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                       + wz_ * (nz * sg);
                            f_cos = rb * F(1.0 / 3.141592653589793)
                                    * fmaxf(co, 0.0f);
                        }
                        float te_n, tr_n, w_gate, k_nee = 0.0f;
                        tr.emission((plen + dist) / cvel, u3[2], t_rx0,
                                    cfg.gate, t_start, t_window, &te_n,
                                    &tr_n, &w_gate, &k_nee);
                        float f_emit = tr.inst_freq(te_n);
                        float sig = tr.eval_wdf(te_n, f_emit);
                        // [k1 stage: nee_pairs]
                        float ap = tx_gain_epx(tr, t, ix, glx, gly, qx, qy,
                                               qz, wx_, wy_, wz_,
                                               cvel / fmaxf(f_emit,
                                                            F(1e-6)));
                        // [k1 stage: nee]
                        float w_tx = sig * tr.gain * ap * TP;
                        float off = F(1e-4) * sign0(cos_s);
                        float sx = hx + off * nx, sy = hy + off * ny,
                              sz = hz + off * nz;
                        float limit = dist * F(0.999);
                        // [k1 stage: shadow]
                        bool occ = false;
                        const float4* blk = s_blk + 3 * t * np;
                        for (int r = 0; r < s_cnt[1 + t] && !occ; ++r) {
                            float t_p;
                            bool hit_p = rect_hit4(blk + 3 * r, sx, sy, sz,
                                                   wx_, wy_, wz_, &t_p);
                            occ = hit_p && t_p > F(1e-4) && t_p < limit;
                        }
                        // [k1 stage: nee]
                        if (!occ && pdf_sa > 0.0f) {
                            val = thr * f_cos * w_tx * w_gate
                                  / fmaxf(pdf_sa, F(1e-30));
                            yb = (tr_n - t_start) / t_window * n_time_f
                                 - 0.5f;
                            // connection Doppler: the vertex's bounce and
                            // the transmitter's motion; the phase adds the
                            // boundary phase of depth + 1 vertices
                            float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                    + (wy_ - dy) * vby
                                                    + (wz_ - dz) * vbz)
                                                   / cvel;
                            float dop_tx = 1.0f - (wx_ * tr.vx + wy_ * tr.vy
                                                   + wz_ * tr.vz) / cvel;
                            f_recv = f_emit * dop * dop_vtx * dop_tx;
                            t_recv = tr_n;
                            dtot = plen + dist;
                            t_emit = te_n;
                            k_c = k_nee;
                            n_bnd = depth + 1;
                            conn = true;
                        }
                    }
                }
                if (conn) {
                    // [k1 stage: phase]  the echo phase, I and Q
                    // (conn_splat)
                    float ph = echo_phase(tr.w, lo, cfg, sp, dtot, t_emit,
                                          t_recv, k_c);
                    if (n_bnd > 0)
                        ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
                    float amp = sqrtf(fmaxf(val, 0.0f));
                    ci = amp * fast_cos(ph);
                    si = amp * fast_sin(ph);
                    lsum += amp;
                    events += val != 0.0f;
                    if (!rows) {
                        // [k1 stage: splat]
                        const Wave txw = tr.w;
                        grid_splat<true>(grid, cfg, ci, si, yb, [&] {
                            return bin_freq(cfg, txw, lo, f_recv, t_recv);
                        });
                    }
                }
                if (rows) {
                    // [k1 stage: splat]
                    coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, j);
                }
                // [k1 stage: hit]
            }

            // [k1 stage: bounce]  a diffuse cosine, a GGX half vector or a
            // mirror about the flipped normal (none after the last depth,
            // on the transmitter, or from an absorbing hit)
            if (on && depth < cfg.max_depth - 1 && txc < 0.0f
                && (is_ggx || is_m || rb > 0.0f)) {
                // draws d0 + 1 + 3 n_tx, + 2
                float u3[3];
                epc_draws3(cfg, u_p, key, lane, d0 + 1 + 3 * n_tx, u3);
                float u8 = u3[0], u9 = u3[1];
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float ph2 = TP * u9;
                float ndx, ndy, ndz, w_b;
                bool go = true;
                if (is_m) {
                    float dn = dx * fx + dy * fy + dz * fz;
                    ndx = dx - 2.0f * dn * fx;
                    ndy = dy - 2.0f * dn * fy;
                    ndz = dz - 2.0f * dn * fz;
                    w_b = rb * fres_cond(fabsf(dn), eb, kk);
                    go = w_b > 0.0f;
                } else if (is_ggx) {
                    float ag2 = ab * ab;
                    float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                    float cth = rsqrtf(1.0f + tan2);
                    float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                    float hlx = sth * fast_cos(ph2),
                          hly = sth * fast_sin(ph2);
                    float hwx = s1x * hlx + s2x * hly + fx * cth;
                    float hwy = s1y * hlx + s2y * hly + fy * cth;
                    float hwz = s1z * hlx + s2z * hly + fz * cth;
                    float ci_b = fabsf(face);
                    float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                    ndx = 2.0f * idoth * hwx + dx;
                    ndy = 2.0f * idoth * hwy + dy;
                    ndz = 2.0f * idoth * hwz + dz;
                    float co_g = ndx * fx + ndy * fy + ndz * fz;
                    float f_b = fres_cond(fabsf(idoth), eb, kk);
                    float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                    w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth, F(1e-8));
                    go = co_g > 0.0f && idoth > 0.0f && w_b > 0.0f;
                } else {
                    float rr2 = sqrtf(u8);
                    float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                    float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                    ndx = s1x * bx + s2x * by + fx * bz;
                    ndy = s1y * bx + s2y * by + fy * bz;
                    ndz = s1z * bx + s2z * by + fz * bz;
                    w_b = rb;
                }
                if (go) {
                    wdel = is_m;
                    // bounce Doppler of the continued path
                    dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                         + (ndz - dz) * vbz) / cvel);
                    dx = ndx;
                    dy = ndy;
                    dz = ndz;
                    thr = thr * w_b;
                    ox = hx + F(1e-4) * fx;
                    oy = hy + F(1e-4) * fy;
                    oz = hz + F(1e-4) * fz;
                    depth = depth + 1;
                    live = true;
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + COH_REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                     __int_as_float(depth
                                                    | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
            }
        }
        // the lane's sum of amplitudes, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid: its warps' rows summed in warp order, or its
    // float grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (rows) {
        for (int v = tid; v < n_vals; v += T) {
            double s = 0.0;
            for (int w = 0; w < T / 32; ++w)
                s += reinterpret_cast<const double*>(
                    s_warps + w * wbytes + coh_row_offset())[v];
            partial[(long long)blockIdx.x * n_vals + v] = s;
        }
    } else if (cfg.mode == 1) {
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = (double)s_grid[v];
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(csm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// ---- the lobe twins' kernel ------------------------------------------
//
// The lobe twins of the Doppler (power) and coherent (I / Q) configurations
// on analytic scenes (receive_doppler_kernel<false, COH, false, false,
// true> before) run a kernel of their own, built on the coherent kernel's
// turns: its lane is trace_lane's lobe path, operation by operation, and
// what differs is which thread runs which part of which lane, and when
// (PERF.md):
//  - A wavefront inside each warp: the coherent kernel's pool of COH_POOL
//    paths, its turns (SHADE over 32 waiting paths, else RAY over the
//    warp's next 32 lanes), each tracing the rays it makes, and its slot
//    of 16 floats a path (origin, throughput, direction, path length,
//    receive time, hit, depth and the delta flag, lane, Doppler factor,
//    lane sum: what a lobe chain carries from one vertex to the next).
//  - SHADE by kind.  A path whose ray hit the transmitter has only its
//    direct hit to shade (no NEE, no bounce); on the windowed corner one
//    SHADE path in ten, so mixed in nearly every turn.  The waiting set
//    keeps those paths apart (tx_lo, tx_hi), and a SHADE turn takes 32 of
//    one kind where 32 wait.
//  - The splat: the coherent kernel's warp rows for a 1-D grid of at most
//    COH_ROW_VALS values (a bin's I and Q, or its power alone:
//    pow_splat_rows), each value summed in lane order, so repeats are
//    bit-identical; the block's float grid (mode 1) or the global float64
//    grid (mode 2) past them.
//  - Draws a stage at a time: RAY's six, SHADE's d0 + 1 .. d0 + 5 and the
//    depth's lobe and composite picks from the two or three Philox blocks
//    that hold them (lob_draws), taken at the stage's start by every
//    thread; the direct hit's d0 where it is used.
//  - Rectangles as LOB_REC float4s: the coherent kernel's six, then a
//    composite's mark, second lobe and first-lobe weight (prim columns
//    27-33).
// The packed tables, the positional draws, the tent, the partial rows,
// the reduce and the CPI's pulse axis are the other configurations'.  The
// tags "[k1 stage: ...]" name each stage for tools/k1_mix.py.
constexpr int LOB_REC = 8;          // float4s a rectangle
// Blocks an SM the lobe kernel is held to: four (128 registers) ran as
// fast as five (96, 32-96 B spilled) and six (80, 136-202 B) on the
// windowed corner, within 1.5% (PERF.md)
constexpr int LOB_MIN_BLOCKS = 4;

// Whether the lobe kernel's grid goes to warp rows: 1-D, in mode 1, at
// most COH_ROW_VALS values (per_bin a bin: I and Q, or the power).
__host__ __device__ constexpr bool lob_rows(int n_time, int n_freq, int mode,
                                            int per_bin) {
    return mode == 1 && n_freq == 1 && per_bin * n_time <= COH_ROW_VALS;
}
// Shared bytes of one warp's area: the coherent kernel's, its row of
// per_bin x n_time doubles.
__host__ __device__ constexpr int lob_warp_bytes(int n_time, bool rows,
                                                 int per_bin) {
    return (coh_row_offset() + (rows ? 8 * per_bin * n_time : 0) + 15) & ~15;
}
// Shared bytes of a block's tables: the coherent kernel's, with
// rectangles of LOB_REC float4s.
__host__ __device__ constexpr int lob_table_bytes(int n_prims,
                                                  int n_params) {
    return (16 * (LOB_REC + 3) * n_prims
            + 4 * (n_params + TXP_COLS + 4 + COH_RXC + 4) + 15)
           & ~15;
}

// SHADE's draws first .. first + 4 + n_more (first = d0 + 1; n_more the
// depth's lobe pick and composite pick, 0-2, the same in every lane), from
// the two or three Philox blocks that hold them.
__device__ __forceinline__ void lob_draws(const Cfg& cfg, const float* u,
                                          unsigned long long key,
                                          long long lane, int first,
                                          int n_more, float* out) {
    if (!cfg.use_prng) {
#pragma unroll
        for (int k = 0; k < 7; ++k)
            out[k] = k < 5 + n_more
                         ? u[(long long)(first + k) * cfg.n_lanes + lane]
                         : 0.0f;
        return;
    }
    const int g = first >> 2, o = first & 3;
    const uint4 a = coh_block(key, lane, g), b = coh_block(key, lane, g + 1);
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if (o + 5 + n_more > 8) c = coh_block(key, lane, g + 2);
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                            b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 7; ++k)
        out[k] = flag_unit(o == 0 ? w[k] : o == 1 ? w[k + 1]
                           : o == 2 ? w[k + 2] : w[k + 3]);
}

// The power lobe twin's warp splat: coh_splat_rows with one value a bin,
// the power `val`, into a row of n_time doubles (a lane's two taps are
// row values i0 and i0 + 1).
// [k1 splat]
__device__ __forceinline__ void pow_splat_rows(double* row, float* vals,
                                               int n_time, float val,
                                               float yb, int j) {
    int i0 = -2;
    float c0 = 0.0f, c1 = 0.0f;
    if (val != 0.0f) {
        float b0 = floorf(yb);
        if (b0 >= -1.0f && b0 < (float)n_time) {   // also drops NaN
            float b1 = b0 + 1.0f;
            i0 = (int)b0;
            c0 = val * fmaxf(1.0f - fabsf(yb - b0), 0.0f);
            c1 = val * fmaxf(1.0f - fabsf(yb - b1), 0.0f);
        }
    }
    unsigned go = __ballot_sync(FULL_MASK, i0 != -2);
    if (go == 0u) return;
    int* first = reinterpret_cast<int*>(vals + 64);   // i0 of each lane
    vals[j] = c0;
    vals[32 + j] = c1;
    first[j] = i0;
    __syncwarp();
    while (go != 0u) {
        const int k = __ffs(go) - 1;
        go &= go - 1u;
        const int v0 = first[k];
        const int d = (j - v0) & 31;          // this lane's value of lane k
        const int v = v0 + d;
        if (d < 2 && v >= 0 && v < n_time)
            row[v] = row[v] + (double)vals[32 * d + k];
    }
}

// The body of the coherent kernel (COH, !LOB) and of the lobe twins'
// kernel (LOB; power or I / Q): what LOB adds is under `if constexpr`.
template <bool COH>
__global__ void __launch_bounds__(COH_THREADS, LOB_MIN_BLOCKS)
receive_lobe_kernel(const float* __restrict__ params,
                    const float* __restrict__ prim,
                    const float* __restrict__ txp,
                    const float* __restrict__ msh,
                    const float* __restrict__ uniforms, bvh::Tables mesh,
                    float* __restrict__ lane_val,
                    double* __restrict__ partial,
                    unsigned long long* __restrict__ part_ev, Cfg cfg) {
    constexpr int REC = LOB_REC;
    constexpr int PER_BIN = COH ? 2 : 1;   // a bin's values: I and Q, or power
    extern __shared__ float4 lsm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = lsm;
    float4* s_blk = s_rec + REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    const bool rows = lob_rows(cfg.n_time, cfg.n_freq, cfg.mode, PER_BIN);
    char* s_warps = reinterpret_cast<char*>(lsm)
                    + lob_table_bytes(np, cfg.n_params);
    const int wbytes = lob_warp_bytes(cfg.n_time, rows, PER_BIN);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * COH_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + coh_row_offset());
    // the values of a pulse's grid: I and Q of each cell, or its power
    const long long n_vals = (long long)PER_BIN * cfg.n_time * cfg.n_freq;
    // mode 1 without warp rows: the block's float grid after the warps'
    float* s_grid = reinterpret_cast<float*>(s_warps + (T / 32) * wbytes);

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    if (rows) {
        for (int i = j; i < PER_BIN * cfg.n_time; i += 32) w_row[i] = 0.0;
    } else if (cfg.mode == 1) {
        for (long long i = tid; i < n_vals; i += T) s_grid[i] = 0.0f;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            // a composite's mark, second lobe and first lobe's weight
            r[6] = make_float4(row[27], row[28], row[29], row[30]);
            r[7] = make_float4(row[31], row[32], row[33], 0.0f);
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
    }
    __syncthreads();
    if (tid == 0) {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame, trace_lane's expressions
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * s_par[14] * s_par[15];                 // area
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
        // the lobe mixture of a receive frequency every lane shares (raw
        // receive on a 1-D grid; mix_resample and the LO's raw_resample
        // under gate sampling, read at mid-window): RAY's expressions
        float t_mid = 0.0f + (cfg.gate ? 0.5f * cfg.t_window : 0.0f);
        float f_rx = cfg.rule == RX_MIX ? Wave{s_tx + 16, s_tx + 28}
                                              .inst_freq(t_mid)
                     : cfg.rule == RX_RAW_LO
                         ? Wave{s_par + 33, s_par + 41}.inst_freq(t_mid)
                         : cfg.f_rx;
        float lam0 = s_par[1] / fmaxf(f_rx, F(1e-6));
        float w_mn = fminf(s_par[14], s_par[15]);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    // the pulse's uniforms, Philox key and lane sums, held a block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + (cfg.omni ? 2 : 4);
    // the draws of a depth: six, and the lobe pick and composite pick
    // where the tables hold them
    const int n_more = ((cfg.lobes & LOBE_PICK) != 0)
                       + ((cfg.lobes & LOBE_BLEND) != 0);
    // every lane's receive frequency is the block's (s_rxc[4:8])
    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);
    Grid grid;
    grid.s = cfg.mode == 1 ? s_grid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s), and of those the paths on the transmitter
    // (tx_lo, tx_hi: a direct hit or nothing); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u, tx_lo = 0u, tx_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done.  SHADE takes 32 paths of one kind where 32 wait:
        // those that bounce or connect, or those on the transmitter,
        // whose direct hits would otherwise run beside the bounces in
        // nearly every turn
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_tx = __popc(tx_lo) + __popc(tx_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        unsigned m0 = ~sh_lo, m1 = ~sh_hi;
        if (shade && n_sh - n_tx >= 32) {
            m0 = sh_lo & ~tx_lo;
            m1 = sh_hi & ~tx_hi;
        } else if (shade && n_tx >= 32) {
            m0 = tx_lo;
            m1 = tx_hi;
        } else if (shade) {
            m0 = sh_lo;
            m1 = sh_hi;
        }
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, __popc(m0) + __popc(m1)) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + COH_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            wdel = (dw >> 16) != 0;
        }
        const int d0 = base + (6 + n_more) * depth;
        float ud[7];
        // [k1 stage: draws]
        if (slot >= 0) {
            if (shade)
                lob_draws(cfg, u_p, key, lane, d0 + 1, n_more, ud);
            else
                coh_ray_draws(cfg, u_p, key, lane, ud);
        }
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // SHADE: the contribution's I, Q (the power alone in `ci`) and time
        // coordinate, and its frequency and receive time (the frequency
        // bin of a 2-D grid)
        float ci = 0.0f, si = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and ray
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                // the ray draws r0 .. r0 + 3, each read at a constant
                // index (a run-time one would keep `ud` in local memory)
                const bool fd = r0 == 2;
                const float u1 = fd ? ud[2] : ud[1], u2 = fd ? ud[3] : ud[2];
                const float u3 = fd ? ud[4] : ud[3], u4 = fd ? ud[5] : ud[4];
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    // the lobe mixture: the block's, or this lane's
                    float lam0 = rc[7], k_l = rc[4], k_l1 = rc[5],
                          kc = rc[6];
                    if (!f_call) {
                        lam0 = cvel / fmaxf(f_rx, F(1e-6));
                        float w_mn = fminf(rx_wx, rx_wy);
                        float q = 2.0f * w_mn / (F(0.6) * lam0);
                        k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
                        k_l1 = k_l + 1.0f;
                        kc = 0.5f * (k_l + 1.0f)
                             * F(1.0 / 6.283185307179586);
                    }
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / k_l1);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + kc * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = lam0;
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit rectangle's lobe
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const float4* rec = s_rec + REC * __float_as_int(c.z);
            const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
            const float nx = nrb.x, ny = nrb.y, nz = nrb.z, rb = nrb.w;
            const float txc = lob.x, kb = lob.y, ab = lob.z, eb = lob.w;
            const float kk = kv.x, vbx = kv.y, vby = kv.z, vbz = kv.w;
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            tx.vx = s_tx[24];
            tx.vy = s_tx[25];
            tx.vz = s_tx[26];
            tx.w = Wave{s_tx + 16, s_tx + 28};
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // a composite's first-lobe weight (1 on a plain row), and
            // whether NEE leaves the hit: not from a delta lobe, unless a
            // composite's other lobe may connect
            const float wmx = rec[7].z;
            const bool lobe_nee = txc < 0.0f
                                  && !((is_m || kb == DIELECTRIC
                                        || kb == THIN_DIELECTRIC)
                                       && !(wmx < 1.0f));
            // the connection, if any: its power and its phase's inputs
            bool conn = false;
            float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;
            int n_bnd = 0;

            // [k1 stage: direct]  direct transmitter hits at depth 0 and
            // after a delta bounce
            if (depth == 0 || wdel) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h, k_h = 0.0f;
                    tx.emission(plen / cvel,
                                coh_draw1(cfg, u_p, key, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, &k_h);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    f_recv = fe_h * dop;
                    t_recv = tr_h;
                    dtot = plen;
                    t_emit = te_h;
                    k_c = k_h;
                    conn = true;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits; none from a delta lobe)
            if (lobe_nee) {
                float glx = 2.0f * ud[0] - 1.0f;
                float gly = 2.0f * ud[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    // [k1 stage: lobe_nee]  the hit's lobe; a composite's
                    // mix w f0 + (1 - w) f1 with its second lobe (a
                    // mask's: a zero diffuse one)
                    float f_cos = lobe_fcos(kb, rb, ab, eb, kk, nx, ny, nz,
                                            -dx, -dy, -dz, wx_, wy_, wz_);
                    if (wmx < 1.0f) {
                        const float4 l1 = rec[6], l2 = rec[7];
                        float f1 = lobe_fcos(l1.y, l1.z, l1.w, l2.x, l2.y,
                                             nx, ny, nz, -dx, -dy, -dz, wx_,
                                             wy_, wz_);
                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;
                    }
                    // [k1 stage: nee]
                    float te_n, tr_n, w_gate, k_nee = 0.0f;
                    tx.emission((plen + dist) / cvel, ud[2], t_rx0, cfg.gate,
                                t_start, t_window, &te_n, &tr_n, &w_gate,
                                &k_nee);
                    float f_emit = tx.inst_freq(te_n);
                    float sig = tx.eval_wdf(te_n, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = rect_hit4(s_blk + 3 * r, sx, sy, sz,
                                               wx_, wy_, wz_, &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (tr_n - t_start) / t_window * n_time_f - 0.5f;
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion; the phase adds the
                        // boundary phase of depth + 1 vertices
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        f_recv = f_emit * dop * dop_vtx * dop_tx;
                        t_recv = tr_n;
                        dtot = plen + dist;
                        t_emit = te_n;
                        k_c = k_nee;
                        n_bnd = depth + 1;
                        conn = true;
                    }
                }
            }
            if constexpr (!COH) {
                if (conn) {
                    // [k1 stage: splat]  the power (conn_splat)
                    ci = val;
                    lsum += val;
                    events += val != 0.0f;
                    if (!rows) {
                        const Wave txw = tx.w;
                        grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {
                            return bin_freq(cfg, txw, lo, f_recv, t_recv);
                        });
                    }
                }
            } else if (conn) {
                // [k1 stage: phase]  the echo phase, I and Q (conn_splat)
                float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit,
                                      t_recv, k_c);
                if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
                float amp = sqrtf(fmaxf(val, 0.0f));
                ci = amp * fast_cos(ph);
                si = amp * fast_sin(ph);
                lsum += amp;
                events += val != 0.0f;
                if (!rows) {
                    // [k1 stage: splat]
                    const Wave txw = tx.w;
                    grid_splat<true>(grid, cfg, ci, si, yb, [&] {
                        return bin_freq(cfg, txw, lo, f_recv, t_recv);
                    });
                }
            }

            // [k1 stage: bounce]  the hit's lobe (trace_lane's lobe
            // bounce): a composite first picks its lobe; then a
            // mask's pass, a mirror, a smooth or thin dielectric's
            // reflection or refraction, a GGX half vector (rough
            // conductor, rough plastic's coat, GGX glass) or the
            // cosine hemisphere (diffuse, plastic's base) about the
            // flipped normal (none after the last depth or on the
            // transmitter)
            if (depth < cfg.max_depth - 1 && txc < 0.0f) {
                float u8 = ud[3], u9 = ud[4];       // draws d0 + 4, 5
                float lk = kb, lr = rb, la = ab, le = eb, lkk = kk;
                bool pass = false;
                // [k1 stage: pick]
                if (wmx < 1.0f
                    && !(((cfg.lobes & LOBE_PICK) ? ud[6] : ud[5]) < wmx)) {
                    // the second lobe; a mask's passes the ray
                    // straight on (a delta null transmission, weight 1)
                    const float4 l1 = rec[6], l2 = rec[7];
                    pass = l1.x == 2.0f;
                    lk = l1.y;
                    lr = l1.z;
                    la = l1.w;
                    le = l2.x;
                    lkk = l2.y;
                }
                // [k1 stage: bounce]
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float ph2 = TP * u9;
                float ndx, ndy, ndz, w_b;
                bool del = false;   // a delta bounce
                if (pass) {
                    ndx = dx;
                    ndy = dy;
                    ndz = dz;
                    w_b = 1.0f;
                    del = true;
                } else if (cfg.mirror && lk == CONDUCTOR) {
                    // [k1 stage: mirror]
                    float dn = dx * fx + dy * fy + dz * fz;
                    ndx = dx - 2.0f * dn * fx;
                    ndy = dy - 2.0f * dn * fy;
                    ndz = dz - 2.0f * dn * fz;
                    w_b = lr * fres_cond(fabsf(dn), le, lkk);
                    del = true;
                } else if (lk == DIELECTRIC || lk == THIN_DIELECTRIC) {
                    // [k1 stage: diel]  the Fresnel of the unflipped
                    // cosine picks by u8: reflect about n, or refract
                    // (thin: pass straight on)
                    float eta_it, cos_t;
                    float f_d = fres_diel_full(face, le, &eta_it, &cos_t);
                    bool refl = lk == DIELECTRIC
                                    ? u8 < f_d
                                    : u8 < (f_d < 1.0f
                                                ? 2.0f * f_d / (1.0f + f_d)
                                                : 1.0f);
                    if (refl) {
                        ndx = dx + 2.0f * face * nx;
                        ndy = dy + 2.0f * face * ny;
                        ndz = dz + 2.0f * face * nz;
                        w_b = lk == DIELECTRIC ? lr : 1.0f;
                    } else if (lk == DIELECTRIC) {
                        // the refraction: transmittance (k) x the
                        // radiance compression 1 / eta^2
                        float scl = 1.0f / eta_it;
                        float coef = scl * face - sgn_ge(face) * cos_t;
                        ndx = scl * dx + coef * nx;
                        ndy = scl * dy + coef * ny;
                        ndz = scl * dz + coef * nz;
                        w_b = lkk * scl * scl;
                    } else {
                        ndx = dx;
                        ndy = dy;
                        ndz = dz;
                        w_b = 1.0f;
                    }
                    del = true;
                } else if (lk == ROUGH_CONDUCTOR || lk == ROUGH_PLASTIC
                           || lk == ROUGH_DIELECTRIC) {
                    // [k1 stage: ggx]  the GGX half vector hw about the
                    // flipped normal and its reflection of the ray
                    float ag2 = la * la;
                    float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                    float cth = rsqrtf(1.0f + tan2);
                    float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                    float hlx = sth * fast_cos(ph2),
                          hly = sth * fast_sin(ph2);
                    float hwx = s1x * hlx + s2x * hly + fx * cth;
                    float hwy = s1y * hlx + s2y * hly + fy * cth;
                    float hwz = s1z * hlx + s2z * hly + fz * cth;
                    float ci_b = fabsf(face);
                    float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                    ndx = 2.0f * idoth * hwx + dx;
                    ndy = 2.0f * idoth * hwy + dy;
                    ndz = 2.0f * idoth * hwz + dz;
                    if (lk == ROUGH_CONDUCTOR) {
                        // weight refl F G (wi.h) / (cos_i h.n)
                        float co_g = ndx * fx + ndy * fy + ndz * fz;
                        float f_b = fres_cond(fabsf(idoth), le, lkk);
                        float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                        w_b = lr * f_b * g_b * idoth
                              / fmaxf(ci_b * cth, F(1e-8));
                        if (!(co_g > 0.0f && idoth > 0.0f)) w_b = 0.0f;
                    } else if (lk == ROUGH_PLASTIC) {
                        // the coat with probability spec_w, else the
                        // diffuse base; the weight is f / pdf of both
                        float fi = fres_diel(ci_b, le);
                        float spec_w = fminf(fmaxf(fi, F(0.05)), F(0.95));
                        if (!(ud[5] < spec_w)) {
                            float rr2 = sqrtf(u8);
                            float bx = rr2 * fast_cos(ph2),
                                  by = rr2 * fast_sin(ph2);
                            float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                            ndx = s1x * bx + s2x * by + fx * bz;
                            ndy = s1y * bx + s2y * by + fy * bz;
                            ndz = s1z * bx + s2z * by + fz * bz;
                        }
                        float co_r = ndx * fx + ndy * fy + ndz * fz;
                        float h2x = -dx + ndx, h2y = -dy + ndy,
                              h2z = -dz + ndz;
                        float hc2 = half_toward(&h2x, &h2y, &h2z, fx, fy,
                                                fz);
                        float dd2 = hc2 * hc2 * (ag2 - 1.0f) + 1.0f;
                        float d_r = ag2
                                    / fmaxf(F(3.141592653589793) * dd2
                                                * dd2,
                                            F(1e-20));
                        float g_r = g1(ci_b, ag2) * g1(fabsf(co_r), ag2);
                        float idoth2 = -dx * h2x + -dy * h2y + -dz * h2z;
                        float f_val = lr * F(1.0 / 3.141592653589793)
                                          * fmaxf(co_r, 0.0f) * (1.0f - fi)
                                          * (1.0f - fres_diel(co_r, le))
                                      + fres_diel(fabsf(idoth2), le) * d_r
                                            * g_r
                                            / fmaxf(4.0f * ci_b, F(1e-8));
                        float odoth2 = fabsf(ndx * h2x + ndy * h2y
                                             + ndz * h2z);
                        float pdf_r = (1.0f - spec_w) * fmaxf(co_r, 0.0f)
                                          * F(1.0 / 3.141592653589793)
                                      + spec_w * d_r * hc2
                                            / fmaxf(4.0f * odoth2,
                                                    F(1e-8));
                        w_b = (co_r > 0.0f && ci_b > F(1e-6))
                                  ? f_val / fmaxf(pdf_r, F(1e-20))
                                  : 0.0f;
                    } else {
                        // GGX glass: reflect or refract through hw by
                        // its Fresnel, the relative IOR by the side the
                        // ray came from; the weight is the
                        // eval-consistent f cos / pdf
                        float eta_i2, cost_h;
                        float f_h = fres_diel_full(idoth * sgn, le,
                                                   &eta_i2, &cost_h);
                        bool pick_rf = ud[5] < f_h;
                        if (!pick_rf) {
                            float inv_e2 = 1.0f / eta_i2;
                            float coef_t = (inv_e2 * fabsf(idoth)
                                            - cost_h)
                                           * sgn_ge(idoth);
                            float ttx = coef_t * hwx - (-dx) * inv_e2;
                            float tty = coef_t * hwy - (-dy) * inv_e2;
                            float ttz = coef_t * hwz - (-dz) * inv_e2;
                            float ttn = rsqrtf(fmaxf(ttx * ttx
                                                     + tty * tty
                                                     + ttz * ttz,
                                                     F(1e-20)));
                            ndx = ttx * ttn;
                            ndy = tty * ttn;
                            ndz = ttz * ttn;
                        }
                        float p_c;
                        float f_c = rd_fcos_pdf(face, fx, fy, fz, le, lkk,
                                                lr, la, -dx, -dy, -dz,
                                                ndx, ndy, ndz, &p_c);
                        float co_rd = ndx * fx + ndy * fy + ndz * fz;
                        float odh_s = ndx * hwx + ndy * hwy + ndz * hwz;
                        bool ok = (pick_rf ? co_rd : -co_rd) > 0.0f
                                  && idoth > 0.0f && odh_s * co_rd > 0.0f;
                        w_b = ok && p_c > 0.0f
                                  ? f_c / fmaxf(p_c, F(1e-20))
                                  : 0.0f;
                    }
                } else {
                    // [k1 stage: diffuse]  the cosine hemisphere:
                    // diffuse, and the plastic's base
                    float rr2 = sqrtf(u8);
                    float bx = rr2 * fast_cos(ph2),
                          by = rr2 * fast_sin(ph2);
                    float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                    ndx = s1x * bx + s2x * by + fx * bz;
                    ndy = s1y * bx + s2y * by + fy * bz;
                    ndz = s1z * bx + s2z * by + fz * bz;
                    w_b = lr;
                    if (lk == PLASTIC) {
                        // the smooth coat's mirror direction with
                        // probability spec_w; both share the base's
                        // ratio
                        float fi = fres_diel(fabsf(face), le);
                        float spec_w = fminf(fmaxf(fi, F(0.05)), F(0.95));
                        if (ud[5] < spec_w) {
                            float dn2 = dx * fx + dy * fy + dz * fz;
                            ndx = dx - 2.0f * dn2 * fx;
                            ndy = dy - 2.0f * dn2 * fy;
                            ndz = dz - 2.0f * dn2 * fz;
                        }
                        float co_p = ndx * fx + ndy * fy + ndz * fz;
                        w_b = lr * (1.0f - fi)
                              * (1.0f - fres_diel(co_p, le))
                              / fmaxf(1.0f - spec_w, F(1e-6));
                        if (!(co_p > 0.0f)) w_b = 0.0f;
                    }
                }
                // [k1 stage: bounce]
                if (w_b > 0.0f) {
                    // direct hits at the next vertex follow a delta
                    // bounce only where the tables hold a delta lobe
                    // (a mask's pass alone counts none)
                    wdel = del && (cfg.mirror
                                   || (cfg.lobes
                                       & (LOBE_DIEL | LOBE_THIN)) != 0);
                    // bounce Doppler of the continued path
                    dop = dop * (1.0f + ((ndx - dx) * vbx
                                         + (ndy - dy) * vby
                                         + (ndz - dz) * vbz) / cvel);
                    // a refracted or passed ray leaves through the
                    // back face
                    float off = F(1e-4);
                    if ((cfg.lobes & (LOBE_DIEL | LOBE_THIN | LOBE_RDIEL
                                      | LOBE_MASK))
                        && !(ndx * fx + ndy * fy + ndz * fz >= 0.0f))
                        off = F(-1e-4);
                    dx = ndx;
                    dy = ndy;
                    dz = ndz;
                    thr = thr * w_b;
                    ox = hx + off * fx;
                    oy = hy + off * fy;
                    oz = hz + off * fz;
                    depth = depth + 1;
                    live = true;
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE (of its kind: on the transmitter
        // or not), a miss ends the lane
        bool hit = false, on_tx = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                     __int_as_float(depth
                                                    | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
                on_tx = s_rec[REC * pw + 4].x == 0.0f;
            }
        }
        // the lane's sum of amplitudes, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it (on_tx: and the transmitter's set)
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        const unsigned gone_lo = __reduce_or_sync(FULL_MASK, lo_s ? bit : 0u);
        const unsigned gone_hi = __reduce_or_sync(FULL_MASK, hi_s ? bit : 0u);
        sh_lo = (sh_lo & ~gone_lo)
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~gone_hi)
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
        tx_lo = (tx_lo & ~gone_lo)
                | __reduce_or_sync(FULL_MASK, lo_s && on_tx ? bit : 0u);
        tx_hi = (tx_hi & ~gone_hi)
                | __reduce_or_sync(FULL_MASK, hi_s && on_tx ? bit : 0u);
        if (shade && rows) {
            // [k1 stage: splat]
            if constexpr (COH)
                coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, j);
            else
                pow_splat_rows(w_row, w_vals, cfg.n_time, ci, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid: its warps' rows summed in warp order, or its
    // float grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (rows) {
        for (int v = tid; v < n_vals; v += T) {
            double s = 0.0;
            for (int w = 0; w < T / 32; ++w)
                s += reinterpret_cast<const double*>(
                    s_warps + w * wbytes + coh_row_offset())[v];
            partial[(long long)blockIdx.x * n_vals + v] = s;
        }
    } else if (cfg.mode == 1) {
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = (double)s_grid[v];
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(lsm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// ---- the Doppler power kernel: the coherent kernel's turns ----------------
//
// The Doppler configuration in power on analytic scenes (moving scenes,
// GGX rough conductors, mirror chains, time x frequency and wide grids,
// the receive rules; receive_doppler_kernel<false, false, false, false>
// before) runs a kernel of its own, on the coherent kernel's turns: its
// lane is trace_lane's power Doppler path, operation by operation, and
// what differs is which thread runs which part of which lane, and when
// (PERF.md):
//  - A wavefront inside each warp: the coherent kernel's pool of COH_POOL
//    paths and slots of COH_SLOT floats, its turns (SHADE over 32 waiting
//    paths, else RAY over the warp's next 32 lanes, each tracing the rays
//    it makes), its draws a stage at a time and its tables (COH_REC
//    float4s a rectangle, the shadowing rectangles' list, the receiver's
//    frame and the block's lobe mixture).  The grid-stride body ran at
//    ~3% of its FP32 bound: a warp waited on its slowest lane.
//  - The splat: a 1-D grid of at most COH_ROW_VALS bins goes to the
//    warp's row of doubles (pow_splat_rows: each bin's taps in lane order,
//    bit-identical repeats); a 2-D or wider grid to the block's floats of
//    shared-memory atomics (mode 1) or the global float64 grid (mode 2),
//    as before.  On the range-Doppler pulse a warp's taps land on a few
//    cells and the atomics take a quarter of the time, but summing the
//    warp's taps a cell at a time before them, or a row of floats a warp
//    summed in lane order, cost more than they saved (PERF.md).
//  - Its texture twin (TEX: checkerboard and bitmap rectangles) and its
//    prims twin (PRIM: spheres, disks and cylinders beside the
//    rectangles; with TEX, the twin that also carries the texture codes)
//    are the coherent kernel's, flag for flag: each rectangle's texture
//    record and each record's kind in shared memory after the block's
//    grid, the closest-hit and the shadow tests by kind (prim_hit4_uv,
//    the same branch in every lane of a warp), SHADE's normal recomputed
//    from the slot's ray and t (prim_normal4), the winner's textured
//    reflectance in the slot.  A moving sphere's velocity is its row's,
//    as a rectangle's: the Doppler factors' arithmetic is the plate's.
// The packed tables, the positional draws (n_draws unchanged), the tent,
// the partial rows, the reduce and the CPI's pulse axis are the other
// configurations'.  The tags "[k1 stage: ...]" name each stage for
// tools/k1_mix.py.

// Blocks an SM the Doppler power kernel is held to: six (80 registers,
// ~60 B spilled) ran range_doppler 0.90 of four (128) and 0.93 of five
constexpr int DPW_MIN_BLOCKS = 6;

template <bool TEX, bool PRIM = false>
__global__ void __launch_bounds__(COH_THREADS, DPW_MIN_BLOCKS)
receive_doppler_power_kernel(const float* __restrict__ params,
                             const float* __restrict__ prim,
                             const float* __restrict__ txp,
                             const float* __restrict__ msh,
                             const float* __restrict__ uniforms,
                             bvh::Tables mesh, float* __restrict__ lane_val,
                             double* __restrict__ partial,
                             unsigned long long* __restrict__ part_ev,
                             Cfg cfg) {
    extern __shared__ float4 dsm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = dsm;
    float4* s_blk = s_rec + COH_REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    const bool rows = lob_rows(cfg.n_time, cfg.n_freq, cfg.mode, 1);
    char* s_warps = reinterpret_cast<char*>(dsm)
                    + coh_table_bytes(np, cfg.n_params);
    const int wbytes = lob_warp_bytes(cfg.n_time, rows, 1);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * COH_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + coh_row_offset());
    // the values of a pulse's grid: the power of each cell
    const long long n_vals = (long long)cfg.n_time * cfg.n_freq;
    // mode 1 without warp rows: the block's float grid after the warps'
    float* s_grid = reinterpret_cast<float*>(s_warps + (T / 32) * wbytes);
    // TEX: each rectangle's texture record, after the block's grid
    float4* s_tex = reinterpret_cast<float4*>(
        reinterpret_cast<char*>(s_grid)
        + (cfg.mode == 1 && !rows ? (4 * n_vals + 15) & ~15LL : 0LL));
    // PRIM: the kinds of the prim records, then of the shadowing rows,
    // after the texture records where there are any
    int* s_kind = reinterpret_cast<int*>(s_tex + (TEX ? 2 * np : 0));

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    if (rows) {
        for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;
    } else if (cfg.mode == 1) {
        for (long long i = tid; i < n_vals; i += T) s_grid[i] = 0.0f;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        // PRIM: the spheres, disks and cylinders among them, in prim order
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            const int kd = (int)row[0];
            if constexpr (PRIM) {
                if (kd != RECTANGLE && kd != SPHERE && kd != DISK
                    && kd != CYLINDER)
                    continue;
            } else if (kd != RECTANGLE) {
                continue;
            }
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + COH_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            if constexpr (TEX)
                tex_record(s_tex + 2 * (nr - 1), row, p, cfg.grid, np,
                           cfg.g_w);
            if constexpr (PRIM) s_kind[nr - 1] = kd;
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
                if constexpr (PRIM) s_kind[np + nb - 1] = kd;
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
    }
    __syncthreads();
    if (tid == 0) {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame, trace_lane's expressions
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * s_par[14] * s_par[15];                 // area
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
        // the lobe mixture of a receive frequency every lane shares (raw
        // receive on a 1-D grid; mix_resample and the LO's raw_resample
        // under gate sampling, read at mid-window): RAY's expressions
        float t_mid = 0.0f + (cfg.gate ? 0.5f * cfg.t_window : 0.0f);
        float f_rx = cfg.rule == RX_MIX ? Wave{s_tx + 16, s_tx + 28}
                                              .inst_freq(t_mid)
                     : cfg.rule == RX_RAW_LO
                         ? Wave{s_par + 33, s_par + 41}.inst_freq(t_mid)
                         : cfg.f_rx;
        float lam0 = s_par[1] / fmaxf(f_rx, F(1e-6));
        float w_mn = fminf(s_par[14], s_par[15]);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    // the pulse's uniforms, Philox key and lane sums, held a block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + (cfg.omni ? 2 : 4);
    // every lane's receive frequency is the block's (s_rxc[4:8])
    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);
    Grid grid;
    grid.s = cfg.mode == 1 ? s_grid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + COH_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            // TEX: the hit rectangle rides bits 17 and up
            wdel = ((TEX ? dw & 0x1ffff : dw) >> 16) != 0;
        }
        const int d0 = base + 6 * depth;
        float ud[6];
        // [k1 stage: draws]
        if (slot >= 0) {
            if (shade)
                coh_draws5(cfg, u_p, key, lane, d0 + 1, ud);
            else
                coh_ray_draws(cfg, u_p, key, lane, ud);
        }
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // SHADE: the contribution's power and time coordinate, and its
        // frequency and receive time (the frequency bin of a 2-D grid)
        float pv = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and ray
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float u1 = ud[r0], u2 = ud[r0 + 1];
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    float u3 = ud[r0 + 2], u4 = ud[r0 + 3];
                    // the lobe mixture: the block's, or this lane's
                    float lam0 = rc[7], k_l = rc[4], k_l1 = rc[5],
                          kc = rc[6];
                    if (!f_call) {
                        lam0 = cvel / fmaxf(f_rx, F(1e-6));
                        float w_mn = fminf(rx_wx, rx_wy);
                        float q = 2.0f * w_mn / (F(0.6) * lam0);
                        k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
                        k_l1 = k_l + 1.0f;
                        kc = 0.5f * (k_l + 1.0f)
                             * F(1.0 / 6.283185307179586);
                    }
                    bool pick = u3 >= 0.5f;
                    float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                    float ph = TP * u4;
                    float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                    float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / k_l1);
                    float tz = pick ? ct_l : ct_c;
                    float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                    float tx_ = st * fast_cos(ph);
                    float ty_ = st * fast_sin(ph);
                    float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
                    float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                  + kc * cosk;
                    float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = lam0;
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit rectangle's lobe
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            // TEX: the slot holds the textured reflectance in place of
            // the rectangle, which rides the depth word
            const int pw = TEX ? __float_as_int(c.w) >> 17
                               : __float_as_int(c.z);
            const float4* rec = s_rec + COH_REC * pw;
            const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
            // PRIM: a sphere's or cylinder's normal at the hit
            const float4 nh = PRIM ? prim_normal4(rec, s_kind[pw], nrb, cx,
                                                  cy, cz, dx, dy, dz, tb)
                                   : nrb;
            const float nx = nh.x, ny = nh.y, nz = nh.z,
                        rb = TEX ? c.z : nrb.w;
            const float txc = lob.x, kb = lob.y, ab = lob.z, eb = lob.w;
            const float kk = kv.x, vbx = kv.y, vby = kv.z, vbz = kv.w;
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            tx.vx = s_tx[24];
            tx.vy = s_tx[25];
            tx.vz = s_tx[26];
            tx.w = Wave{s_tx + 16, s_tx + 28};
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_ggx = kb == ROUGH_CONDUCTOR;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // the connection, if any: its power
            bool conn = false;
            float val = 0.0f;

            // [k1 stage: direct]  direct transmitter hits at depth 0 and
            // after a mirror bounce
            if (depth == 0 || wdel) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h, k_h = 0.0f;
                    tx.emission(plen / cvel,
                                coh_draw1(cfg, u_p, key, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, &k_h);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    f_recv = fe_h * dop;
                    t_recv = tr_h;
                    conn = true;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits; none from a mirror)
            if (txc < 0.0f && !is_m) {
                float glx = 2.0f * ud[0] - 1.0f;
                float gly = 2.0f * ud[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float f_cos;
                    if (is_ggx) {
                        f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx,
                                         -dy, -dz, wx_, wy_, wz_);
                    } else {
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        f_cos = rb * F(1.0 / 3.141592653589793)
                                * fmaxf(co, 0.0f);
                    }
                    float te_n, tr_n, w_gate, k_nee = 0.0f;
                    tx.emission((plen + dist) / cvel, ud[2], t_rx0, cfg.gate,
                                t_start, t_window, &te_n, &tr_n, &w_gate,
                                &k_nee);
                    float f_emit = tx.inst_freq(te_n);
                    float sig = tx.eval_wdf(te_n, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = PRIM ? prim_hit4(s_blk + 3 * r,
                                                      s_kind[np + r], sx, sy,
                                                      sz, wx_, wy_, wz_, &t_p)
                                          : rect_hit4(s_blk + 3 * r, sx, sy,
                                                      sz, wx_, wy_, wz_,
                                                      &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (tr_n - t_start) / t_window * n_time_f - 0.5f;
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        f_recv = f_emit * dop * dop_vtx * dop_tx;
                        t_recv = tr_n;
                        conn = true;
                    }
                }
            }
            if (conn) {
                // [k1 stage: splat]  the power (conn_splat)
                pv = val;
                lsum += val;
                events += val != 0.0f;
                if (!rows) {
                    const Wave txw = tx.w;
                    grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {
                        return bin_freq(cfg, txw, lo, f_recv, t_recv);
                    });
                }
            }

            // [k1 stage: bounce]  a diffuse cosine, a GGX half vector or a
            // mirror about the flipped normal (none after the last depth,
            // on the transmitter, or from an absorbing hit)
            if (depth < cfg.max_depth - 1 && txc < 0.0f
                && (is_ggx || is_m || rb > 0.0f)) {
                float u8 = ud[3], u9 = ud[4];           // draws d0 + 4, 5
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float ph2 = TP * u9;
                float ndx, ndy, ndz, w_b;
                bool go = true;
                if (is_m) {
                    float dn = dx * fx + dy * fy + dz * fz;
                    ndx = dx - 2.0f * dn * fx;
                    ndy = dy - 2.0f * dn * fy;
                    ndz = dz - 2.0f * dn * fz;
                    w_b = rb * fres_cond(fabsf(dn), eb, kk);
                    go = w_b > 0.0f;
                } else if (is_ggx) {
                    float ag2 = ab * ab;
                    float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                    float cth = rsqrtf(1.0f + tan2);
                    float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                    float hlx = sth * fast_cos(ph2),
                          hly = sth * fast_sin(ph2);
                    float hwx = s1x * hlx + s2x * hly + fx * cth;
                    float hwy = s1y * hlx + s2y * hly + fy * cth;
                    float hwz = s1z * hlx + s2z * hly + fz * cth;
                    float ci_b = fabsf(face);
                    float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                    ndx = 2.0f * idoth * hwx + dx;
                    ndy = 2.0f * idoth * hwy + dy;
                    ndz = 2.0f * idoth * hwz + dz;
                    float co_g = ndx * fx + ndy * fy + ndz * fz;
                    float f_b = fres_cond(fabsf(idoth), eb, kk);
                    float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                    w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth, F(1e-8));
                    go = co_g > 0.0f && idoth > 0.0f && w_b > 0.0f;
                } else {
                    float rr2 = sqrtf(u8);
                    float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                    float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                    ndx = s1x * bx + s2x * by + fx * bz;
                    ndy = s1y * bx + s2y * by + fy * bz;
                    ndz = s1z * bx + s2z * by + fz * bz;
                    w_b = rb;
                }
                if (go) {
                    wdel = is_m;
                    // bounce Doppler of the continued path
                    dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                         + (ndz - dz) * vbz) / cvel);
                    dx = ndx;
                    dy = ndy;
                    dz = ndz;
                    thr = thr * w_b;
                    ox = hx + F(1e-4) * fx;
                    oy = hy + F(1e-4) * fy;
                    oz = hz + F(1e-4) * fz;
                    depth = depth + 1;
                    live = true;
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            float bpx = 0.0f, bpy = 0.0f;      // TEX: the winner's (px, py)
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p, px, py;
                bool hit_p = PRIM ? prim_hit4_uv(s_rec + COH_REC * r,
                                                 s_kind[r], ox, oy, oz, dx,
                                                 dy, dz, &t_p, &px, &py)
                                  : rect_hit4_uv(s_rec + COH_REC * r, ox, oy,
                                                 oz, dx, dy, dz, &t_p, &px,
                                                 &py);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                    if constexpr (TEX) {
                        bpx = px;
                        bpy = py;
                    }
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                if constexpr (TEX)
                    sl4[2] = make_float4(
                        t_rx0, tb,
                        tex_reflectance(s_tex + 2 * pw,
                                        s_rec[COH_REC * pw + 3].w, bpx, bpy,
                                        cfg.grid, cfg.g_w),
                        __int_as_float(depth | (wdel ? 1 << 16 : 0)
                                       | pw << 17));
                else
                    sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                         __int_as_float(
                                             depth | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
            }
        }
        // the lane's sum of amplitudes, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
        if (shade && rows) {
            // [k1 stage: splat]
            pow_splat_rows(w_row, w_vals, cfg.n_time, pv, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid: its warps' rows summed in warp order, or its
    // float grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (rows) {
        for (int v = tid; v < n_vals; v += T) {
            double s = 0.0;
            for (int w = 0; w < T / 32; ++w)
                s += reinterpret_cast<const double*>(
                    s_warps + w * wbytes + coh_row_offset())[v];
            partial[(long long)blockIdx.x * n_vals + v] = s;
        }
    } else if (cfg.mode == 1) {
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = (double)s_grid[v];
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(dsm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The untextured Doppler power kernel of rectangles, instantiated where
// it is defined, as the flagship and the coherent kernels' are, so that its
// machine code stays as it was; the texture and prims twins are
// instantiated where they are used.
template __global__ void receive_doppler_power_kernel<false>(
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, const float* __restrict__,
    const float* __restrict__, bvh::Tables, float* __restrict__,
    double* __restrict__, unsigned long long* __restrict__, Cfg);

// ---- the mesh Doppler kernel: the coherent kernel's turns with the walk ---
//
// The four vacuum mesh configurations of the Doppler family run a kernel
// of their own on the coherent kernel's turns,
// receive_mesh_doppler_kernel<COH, LOB>: the Doppler mesh in power
// (<false, false>; receive_doppler_kernel<true, false> before), the
// coherent mesh (<true, false>; receive_doppler_kernel<true, true>
// before), the power mesh lobe twin (<false, true>;
// receive_doppler_kernel<true, false, false, false, true> before) and the
// mesh lobe twin in I / Q (<true, true>; receive_doppler_kernel<true, true,
// false, false, true> before).  Its lane is trace_lane's mesh path,
// operation by operation (the power Doppler one or the coherent one, or
// with LOB the lobe one), and what differs is which thread runs which part
// of which lane, and when (PERF.md):
//  - A wavefront inside each warp: the coherent kernel's pool of COH_POOL
//    paths, its turns (SHADE over 32 waiting paths, else RAY over the
//    warp's next 32 lanes, each tracing the rays it makes), its draws a
//    stage at a time and its tables (the rectangles, the shadowing
//    rectangles' list, the receiver's frame and the block's lobe
//    mixture).  The grid-stride bodies ran at ~2% of their FP32 bounds: a
//    warp waited on its slowest lane's path, its walks included.
//  - The walks.  Each turn's trace runs the closest-hit walk of the BVH
//    (bvh::walk with MeshClosest<true>, pruned by the analytic best) after
//    the rectangles, and SHADE's NEE the any-hit walk (bvh::Any, behind the
//    shadowing rectangles, none from a delta lobe under LOB) on the
//    pulse's tables in device memory behind the read-only path, as the
//    grid-stride bodies walk them.  RAY's walks are coherent: a turn's 32
//    lanes are consecutive, so they share a 1024-lane tile's direction
//    stratum (a narrow beam); SHADE's bounce and shadow walks are not.
//  - The slot: a path waits in MDK_SLOT floats, the coherent kernel's 16
//    and a mesh hit's unit normal and reflectance; the hit's code (column
//    10) is its rectangle (>= 0) or -1 - its mesh-shape row, whose lobe,
//    conductor constants and velocity SHADE reads from the block's copy of
//    the shape rows in shared memory.
//  - The splat: a 1-D grid of at most COH_ROW_VALS values goes to the
//    warp's row of doubles, each value summed in lane order (coh_splat_rows
//    for I / Q, pow_splat_rows for power: bit-identical repeats); a 2-D or
//    wider grid (multi_body's 16 x 32) to the block's floats of
//    shared-memory atomics (mode 1) or the global float64 grid (mode 2).
// The packed tables, the positional draws (n_draws unchanged), the
// direction strata, the tent, the partial rows, the reduce and the CPI's
// pulse axis are the other configurations'.  The tags "[k1 stage: ...]"
// name each stage for tools/k1_mix.py (walk: the closest-hit walks,
// shadow_walk: NEE's any-hit walk).
constexpr int MDK_SLOT = 20;        // floats a path: five float4s
// Blocks an SM the mesh Doppler kernel is held to: six.  The power kernel
// ran 1.04 / 1.21 of that at five / four; the I / Q lobe twin held to four
// (124 registers, as the lobe kernel) ran 1.15 of it; the coherent mesh
// 1.06 / 1.24 and the power mesh lobe twin 1.07 / 1.23 at five / four
// (tools/k1_ablate.py mdk_lb*, mdc_lb*, mdl_lb*; PERF.md)
constexpr int MDK_MIN_BLOCKS = 6;

// Shared bytes of one warp's area: its paths of MDK_SLOT floats, a turn's
// slots, the splat's staging, then (warp rows) its row of per_bin x
// n_time doubles.
__host__ __device__ constexpr int mdk_row_offset() {
    return 4 * (COH_POOL * MDK_SLOT + 32 + 160);
}
__host__ __device__ constexpr int mdk_warp_bytes(int n_time, bool rows,
                                                 int per_bin) {
    return (mdk_row_offset() + (rows ? 8 * per_bin * n_time : 0) + 15) & ~15;
}
// Shared bytes of a block's tables: the rectangles (rec float4s each),
// the shadowing rectangles' rows, params, the transmitter row and its unit
// normal, the receiver's frame, four counts, the mesh-shape rows.
__host__ __device__ constexpr int mdk_table_bytes(int n_prims, int n_params,
                                                  int n_msh, int rec) {
    return (16 * (rec + 3) * n_prims
            + 4 * (n_params + TXP_COLS + 4 + COH_RXC + 4 + MSH_COLS * n_msh)
            + 15)
           & ~15;
}

template <bool COH, bool LOB>
__global__ void __launch_bounds__(COH_THREADS, MDK_MIN_BLOCKS)
receive_mesh_doppler_kernel(const float* __restrict__ params,
                            const float* __restrict__ prim,
                            const float* __restrict__ txp,
                            const float* __restrict__ msh,
                            const float* __restrict__ uniforms,
                            bvh::Tables mesh, float* __restrict__ lane_val,
                            double* __restrict__ partial,
                            unsigned long long* __restrict__ part_ev,
                            Cfg cfg) {
    constexpr int REC = LOB ? LOB_REC : COH_REC;
    constexpr int PER_BIN = COH ? 2 : 1;   // a bin's values: I and Q, or power
    extern __shared__ float4 msm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    msh += pulse * cfg.n_msh * MSH_COLS;
    float4* s_rec = msm;
    float4* s_blk = s_rec + REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    float* s_msh = reinterpret_cast<float*>(s_cnt + 4);
    const bool rows = lob_rows(cfg.n_time, cfg.n_freq, cfg.mode, PER_BIN);
    char* s_warps = reinterpret_cast<char*>(msm)
                    + mdk_table_bytes(np, cfg.n_params, cfg.n_msh, REC);
    const int wbytes = mdk_warp_bytes(cfg.n_time, rows, PER_BIN);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * MDK_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + mdk_row_offset());
    // the values of a pulse's grid: I and Q of each cell, or its power
    const long long n_vals = (long long)PER_BIN * cfg.n_time * cfg.n_freq;
    // mode 1 without warp rows: the block's float grid after the warps'
    float* s_grid = reinterpret_cast<float*>(s_warps + (T / 32) * wbytes);

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = tid; i < cfg.n_msh * MSH_COLS; i += T) s_msh[i] = msh[i];
    if (rows) {
        for (int i = j; i < PER_BIN * cfg.n_time; i += 32) w_row[i] = 0.0;
    } else if (cfg.mode == 1) {
        for (long long i = tid; i < n_vals; i += T) s_grid[i] = 0.0f;
    }
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            if constexpr (LOB) {
                // a composite's mark, second lobe and first lobe's weight
                r[6] = make_float4(row[27], row[28], row[29], row[30]);
                r[7] = make_float4(row[31], row[32], row[33], 0.0f);
            }
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
    }
    __syncthreads();
    if (tid == 0) {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame, trace_lane's expressions
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * s_par[14] * s_par[15];                 // area
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
        // the lobe mixture of a receive frequency every lane shares (raw
        // receive on a 1-D grid; mix_resample and the LO's raw_resample
        // under gate sampling, read at mid-window): RAY's expressions
        float t_mid = 0.0f + (cfg.gate ? 0.5f * cfg.t_window : 0.0f);
        float f_rx = cfg.rule == RX_MIX ? Wave{s_tx + 16, s_tx + 28}
                                              .inst_freq(t_mid)
                     : cfg.rule == RX_RAW_LO
                         ? Wave{s_par + 33, s_par + 41}.inst_freq(t_mid)
                         : cfg.f_rx;
        float lam0 = s_par[1] / fmaxf(f_rx, F(1e-6));
        float w_mn = fminf(s_par[14], s_par[15]);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    // the pulse's uniforms, Philox key, BVH tables and lane sums, held a
    // block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    const bvh::Tables mesh_b = pulse_tables(mesh, cfg);
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + (cfg.omni ? 2 : 4);
    // the draws of a depth: six, and (LOB) the lobe pick and composite
    // pick where the tables hold them
    const int n_more = LOB ? ((cfg.lobes & LOBE_PICK) != 0)
                                 + ((cfg.lobes & LOBE_BLEND) != 0)
                           : 0;
    // every lane's receive frequency is the block's (s_rxc[4:8])
    const bool f_call = r0 == 1 && (cfg.gate || cfg.rule == 0);
    // the direction strata: the tile's cell of a P x P grid (trace_lane's)
    const long long n_strata = (long long)cfg.patch_p * cfg.patch_p;
    const int slot0 = (int)sp[0];
    const float inv_p = cfg.patch_p > 0
                            ? (float)(1.0 / (double)cfg.patch_p) : 0.0f;
    Grid grid;
    grid.s = cfg.mode == 1 ? s_grid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + MDK_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            wdel = (dw >> 16) != 0;
        }
        const int d0 = base + (6 + n_more) * depth;
        float ud[7];
        // [k1 stage: draws]
        if (slot >= 0) {
            if (!shade)
                coh_ray_draws(cfg, u_p, key, lane, ud);
            else if constexpr (LOB)
                lob_draws(cfg, u_p, key, lane, d0 + 1, n_more, ud);
            else
                coh_draws5(cfg, u_p, key, lane, d0 + 1, ud);
        }
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // SHADE: the contribution's I, Q (the power alone in `ci`) and time
        // coordinate, and its frequency and receive time (the frequency
        // bin of a 2-D grid); the connection, if any: its power and its
        // phase's inputs
        float ci = 0.0f, si = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f;
        bool conn = false;
        float val = 0.0f, dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;
        int n_bnd = 0;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and ray
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                // the ray draws r0 .. r0 + 3, each read at a constant
                // index (a run-time one would keep `ud` in local memory)
                const bool fd = r0 == 2;
                const float u1 = fd ? ud[2] : ud[1], u2 = fd ? ud[3] : ud[2];
                const float u3 = fd ? ud[4] : ud[3], u4 = fd ? ud[5] : ud[4];
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float z = 1.0f - 2.0f * u1;
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u2;
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    // the lobe mixture's constants: the block's, or this
                    // lane's
                    float lam0 = rc[7], k_l = rc[4], k_l1 = rc[5],
                          kc = rc[6];
                    if (!f_call) {
                        lam0 = cvel / fmaxf(f_rx, F(1e-6));
                        float w_mn = fminf(rx_wx, rx_wy);
                        float q = 2.0f * w_mn / (F(0.6) * lam0);
                        k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
                        k_l1 = k_l + 1.0f;
                        kc = 0.5f * (k_l + 1.0f)
                             * F(1.0 / 6.283185307179586);
                    }
                    float tx_, ty_, tz, w0;
                    if (cfg.patch_p > 0) {
                        // stratified cosine hemisphere: the tile's cell
                        // plus the lane's jitter; cos pdf, weight pi area
                        const long long P = cfg.patch_p;
                        long long patch = ((lane / 1024) * 131 + slot0)
                                          % n_strata;
                        float s3 = ((float)(patch % P) + u3) * inv_p;
                        float s4 = ((float)(patch / P) + u4) * inv_p;
                        float rr = sqrtf(s3);
                        float ph = TP * s4;
                        tx_ = rr * fast_cos(ph);
                        ty_ = rr * fast_sin(ph);
                        tz = sqrtf(fmaxf(1.0f - s3, 0.0f));
                        w0 = F(3.141592653589793) * rc[3] * sp[32];
                    } else {
                        bool pick = u3 >= 0.5f;
                        float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                        float ph = TP * u4;
                        float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                        float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / k_l1);
                        tz = pick ? ct_l : ct_c;
                        float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                        tx_ = st * fast_cos(ph);
                        ty_ = st * fast_sin(ph);
                        float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
                        float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                      + kc * cosk;
                        w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    }
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = lam0;
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit's lobe: a rectangle's record, or a triangle's normal
            // and reflectance and its mesh-shape row
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const int code = __float_as_int(c.z);
            const float4* rec = s_rec + REC * (code < 0 ? 0 : code);
            float nx, ny, nz, rb, txc, kb, ab, eb, kk, vbx, vby, vbz;
            // a composite's first-lobe weight (1 on a plain row or a mesh)
            float wmx = 1.0f;
            if (code >= 0) {
                const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
                nx = nrb.x;
                ny = nrb.y;
                nz = nrb.z;
                rb = nrb.w;
                txc = lob.x;
                kb = lob.y;
                ab = lob.z;
                eb = lob.w;
                kk = kv.x;
                vbx = kv.y;
                vby = kv.z;
                vbz = kv.w;
                if constexpr (LOB) wmx = rec[7].z;
            } else {
                const float4 nm = sl4[4];
                nx = nm.x;
                ny = nm.y;
                nz = nm.z;
                rb = nm.w;
                txc = -1.0f;
                const float* r = s_msh + MSH_COLS * (-1 - code);
                kb = r[6];
                ab = r[3];
                eb = r[4];
                kk = r[5];
                vbx = r[0];
                vby = r[1];
                vbz = r[2];
            }
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            tx.vx = s_tx[24];
            tx.vy = s_tx[25];
            tx.vz = s_tx[26];
            tx.w = Wave{s_tx + 16, s_tx + 28};
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_ggx = kb == ROUGH_CONDUCTOR;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // whether NEE leaves the hit: not from the transmitter or a
            // mirror, and (LOB) not from a delta lobe, unless a composite's
            // other lobe may connect
            const bool nee = LOB ? txc < 0.0f
                                       && !((is_m || kb == DIELECTRIC
                                             || kb == THIN_DIELECTRIC)
                                            && !(wmx < 1.0f))
                                 : txc < 0.0f && !is_m;

            // [k1 stage: direct]  direct transmitter hits at depth 0 and
            // after a delta bounce
            if (depth == 0 || wdel) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h, k_h = 0.0f;
                    tx.emission(plen / cvel,
                                coh_draw1(cfg, u_p, key, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, &k_h);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    f_recv = fe_h * dop;
                    t_recv = tr_h;
                    dtot = plen;
                    t_emit = te_h;
                    k_c = k_h;
                    conn = true;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter
            if (nee) {
                float glx = 2.0f * ud[0] - 1.0f;
                float gly = 2.0f * ud[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float f_cos;
                    if constexpr (LOB) {
                        // [k1 stage: lobe_nee]  the hit's lobe; a
                        // composite's mix w f0 + (1 - w) f1 with its second
                        // lobe (a mask's: a zero diffuse one)
                        f_cos = lobe_fcos(kb, rb, ab, eb, kk, nx, ny, nz,
                                          -dx, -dy, -dz, wx_, wy_, wz_);
                        if (wmx < 1.0f) {
                            const float4 l1 = rec[6], l2 = rec[7];
                            float f1 = lobe_fcos(l1.y, l1.z, l1.w, l2.x,
                                                 l2.y, nx, ny, nz, -dx, -dy,
                                                 -dz, wx_, wy_, wz_);
                            f_cos = wmx * f_cos + (1.0f - wmx) * f1;
                        }
                        // [k1 stage: nee]
                    } else if (is_ggx) {
                        f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx,
                                         -dy, -dz, wx_, wy_, wz_);
                    } else {
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        f_cos = rb * F(1.0 / 3.141592653589793)
                                * fmaxf(co, 0.0f);
                    }
                    float te_n, tr_n, w_gate, k_nee = 0.0f;
                    tx.emission((plen + dist) / cvel, ud[2], t_rx0, cfg.gate,
                                t_start, t_window, &te_n, &tr_n, &w_gate,
                                &k_nee);
                    float f_emit = tx.inst_freq(te_n);
                    float sig = tx.eval_wdf(te_n, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = rect_hit4(s_blk + 3 * r, sx, sy, sz,
                                               wx_, wy_, wz_, &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: shadow_walk]  the mesh's any hit (LOB:
                    // none from a delta lobe, as the JAX kernel's walk;
                    // a composite's other lobe connects unshadowed by the
                    // mesh there)
                    if (!occ && !(LOB && (is_m || kb == DIELECTRIC
                                          || kb == THIN_DIELECTRIC))) {
                        bvh::Any sh;
                        sh.limit = limit;
                        bvh::walk(mesh_b,
                                  bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),
                                  sh);
                        occ = sh.occ;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (tr_n - t_start) / t_window * n_time_f - 0.5f;
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion; the phase adds the
                        // boundary phase of depth + 1 vertices
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        f_recv = f_emit * dop * dop_vtx * dop_tx;
                        t_recv = tr_n;
                        dtot = plen + dist;
                        t_emit = te_n;
                        k_c = k_nee;
                        n_bnd = depth + 1;
                        conn = true;
                    }
                }
            }
            if constexpr (!COH) {
                if (conn) {
                    // [k1 stage: splat]  the power (conn_splat)
                    ci = val;
                    lsum += val;
                    events += val != 0.0f;
                    if (!rows) {
                        const Wave txw{s_tx + 16, s_tx + 28};
                        grid_splat<false>(grid, cfg, val, 0.0f, yb, [&] {
                            return bin_freq(cfg, txw, lo, f_recv, t_recv);
                        });
                    }
                }
            } else if (conn) {
                // [k1 stage: phase]  the echo phase, I and Q (conn_splat)
                const Wave txw{s_tx + 16, s_tx + 28};
                float ph = echo_phase(txw, lo, cfg, sp, dtot, t_emit,
                                      t_recv, k_c);
                if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
                float amp = sqrtf(fmaxf(val, 0.0f));
                ci = amp * fast_cos(ph);
                si = amp * fast_sin(ph);
                lsum += amp;
                events += val != 0.0f;
                if (!rows) {
                    // [k1 stage: splat]
                    grid_splat<true>(grid, cfg, ci, si, yb, [&] {
                        return bin_freq(cfg, txw, lo, f_recv, t_recv);
                    });
                }
            }

            if constexpr (LOB) {
                // [k1 stage: bounce]  the hit's lobe (trace_lane's lobe
                // bounce): a composite first picks its lobe; then a
                // mask's pass, a mirror, a smooth or thin dielectric's
                // reflection or refraction, a GGX half vector (rough
                // conductor, rough plastic's coat, GGX glass) or the
                // cosine hemisphere (diffuse, plastic's base) about the
                // flipped normal (none after the last depth or on the
                // transmitter)
                if (depth < cfg.max_depth - 1 && txc < 0.0f) {
                    float u8 = ud[3], u9 = ud[4];       // draws d0 + 4, 5
                    float lk = kb, lr = rb, la = ab, le = eb, lkk = kk;
                    bool pass = false;
                    // [k1 stage: pick]
                    if (wmx < 1.0f
                        && !(((cfg.lobes & LOBE_PICK) ? ud[6] : ud[5])
                             < wmx)) {
                        // the second lobe; a mask's passes the ray
                        // straight on (a delta null transmission, weight 1)
                        const float4 l1 = rec[6], l2 = rec[7];
                        pass = l1.x == 2.0f;
                        lk = l1.y;
                        lr = l1.z;
                        la = l1.w;
                        le = l2.x;
                        lkk = l2.y;
                    }
                    // [k1 stage: bounce]
                    float face = -(dx * nx + dy * ny + dz * nz);
                    float sgn = sgn_ge(face);
                    float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                    float sign = sgn_ge(fz);
                    float a2 = -1.0f / (sign + fz);
                    float b2 = fx * fy * a2;
                    float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                          s1z = -sign * fx;
                    float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                    float ph2 = TP * u9;
                    float ndx, ndy, ndz, w_b;
                    bool del = false;   // a delta bounce
                    if (pass) {
                        ndx = dx;
                        ndy = dy;
                        ndz = dz;
                        w_b = 1.0f;
                        del = true;
                    } else if (cfg.mirror && lk == CONDUCTOR) {
                        // [k1 stage: mirror]
                        float dn = dx * fx + dy * fy + dz * fz;
                        ndx = dx - 2.0f * dn * fx;
                        ndy = dy - 2.0f * dn * fy;
                        ndz = dz - 2.0f * dn * fz;
                        w_b = lr * fres_cond(fabsf(dn), le, lkk);
                        del = true;
                    } else if (lk == DIELECTRIC || lk == THIN_DIELECTRIC) {
                        // [k1 stage: diel]  the Fresnel of the unflipped
                        // cosine picks by u8: reflect about n, or refract
                        // (thin: pass straight on)
                        float eta_it, cos_t;
                        float f_d = fres_diel_full(face, le, &eta_it, &cos_t);
                        bool refl = lk == DIELECTRIC
                                        ? u8 < f_d
                                        : u8 < (f_d < 1.0f
                                                    ? 2.0f * f_d / (1.0f + f_d)
                                                    : 1.0f);
                        if (refl) {
                            ndx = dx + 2.0f * face * nx;
                            ndy = dy + 2.0f * face * ny;
                            ndz = dz + 2.0f * face * nz;
                            w_b = lk == DIELECTRIC ? lr : 1.0f;
                        } else if (lk == DIELECTRIC) {
                            // the refraction: transmittance (k) x the
                            // radiance compression 1 / eta^2
                            float scl = 1.0f / eta_it;
                            float coef = scl * face - sgn_ge(face) * cos_t;
                            ndx = scl * dx + coef * nx;
                            ndy = scl * dy + coef * ny;
                            ndz = scl * dz + coef * nz;
                            w_b = lkk * scl * scl;
                        } else {
                            ndx = dx;
                            ndy = dy;
                            ndz = dz;
                            w_b = 1.0f;
                        }
                        del = true;
                    } else if (lk == ROUGH_CONDUCTOR || lk == ROUGH_PLASTIC
                               || lk == ROUGH_DIELECTRIC) {
                        // [k1 stage: ggx]  the GGX half vector hw about the
                        // flipped normal and its reflection of the ray
                        float ag2 = la * la;
                        float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                        float cth = rsqrtf(1.0f + tan2);
                        float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                        float hlx = sth * fast_cos(ph2),
                              hly = sth * fast_sin(ph2);
                        float hwx = s1x * hlx + s2x * hly + fx * cth;
                        float hwy = s1y * hlx + s2y * hly + fy * cth;
                        float hwz = s1z * hlx + s2z * hly + fz * cth;
                        float ci_b = fabsf(face);
                        float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                        ndx = 2.0f * idoth * hwx + dx;
                        ndy = 2.0f * idoth * hwy + dy;
                        ndz = 2.0f * idoth * hwz + dz;
                        if (lk == ROUGH_CONDUCTOR) {
                            // weight refl F G (wi.h) / (cos_i h.n)
                            float co_g = ndx * fx + ndy * fy + ndz * fz;
                            float f_b = fres_cond(fabsf(idoth), le, lkk);
                            float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                            w_b = lr * f_b * g_b * idoth
                                  / fmaxf(ci_b * cth, F(1e-8));
                            if (!(co_g > 0.0f && idoth > 0.0f)) w_b = 0.0f;
                        } else if (lk == ROUGH_PLASTIC) {
                            // the coat with probability spec_w, else the
                            // diffuse base; the weight is f / pdf of both
                            float fi = fres_diel(ci_b, le);
                            float spec_w = fminf(fmaxf(fi, F(0.05)),
                                                 F(0.95));
                            if (!(ud[5] < spec_w)) {
                                float rr2 = sqrtf(u8);
                                float bx = rr2 * fast_cos(ph2),
                                      by = rr2 * fast_sin(ph2);
                                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                                ndx = s1x * bx + s2x * by + fx * bz;
                                ndy = s1y * bx + s2y * by + fy * bz;
                                ndz = s1z * bx + s2z * by + fz * bz;
                            }
                            float co_r = ndx * fx + ndy * fy + ndz * fz;
                            float h2x = -dx + ndx, h2y = -dy + ndy,
                                  h2z = -dz + ndz;
                            float hc2 = half_toward(&h2x, &h2y, &h2z, fx, fy,
                                                    fz);
                            float dd2 = hc2 * hc2 * (ag2 - 1.0f) + 1.0f;
                            float d_r = ag2
                                        / fmaxf(F(3.141592653589793) * dd2
                                                    * dd2,
                                                F(1e-20));
                            float g_r = g1(ci_b, ag2) * g1(fabsf(co_r), ag2);
                            float idoth2 = -dx * h2x + -dy * h2y + -dz * h2z;
                            float f_val = lr * F(1.0 / 3.141592653589793)
                                              * fmaxf(co_r, 0.0f)
                                              * (1.0f - fi)
                                              * (1.0f - fres_diel(co_r, le))
                                          + fres_diel(fabsf(idoth2), le)
                                                * d_r * g_r
                                                / fmaxf(4.0f * ci_b,
                                                        F(1e-8));
                            float odoth2 = fabsf(ndx * h2x + ndy * h2y
                                                 + ndz * h2z);
                            float pdf_r = (1.0f - spec_w) * fmaxf(co_r, 0.0f)
                                              * F(1.0 / 3.141592653589793)
                                          + spec_w * d_r * hc2
                                                / fmaxf(4.0f * odoth2,
                                                        F(1e-8));
                            w_b = (co_r > 0.0f && ci_b > F(1e-6))
                                      ? f_val / fmaxf(pdf_r, F(1e-20))
                                      : 0.0f;
                        } else {
                            // GGX glass: reflect or refract through hw by
                            // its Fresnel, the relative IOR by the side the
                            // ray came from; the weight is the
                            // eval-consistent f cos / pdf
                            float eta_i2, cost_h;
                            float f_h = fres_diel_full(idoth * sgn, le,
                                                       &eta_i2, &cost_h);
                            bool pick_rf = ud[5] < f_h;
                            if (!pick_rf) {
                                float inv_e2 = 1.0f / eta_i2;
                                float coef_t = (inv_e2 * fabsf(idoth)
                                                - cost_h)
                                               * sgn_ge(idoth);
                                float ttx = coef_t * hwx - (-dx) * inv_e2;
                                float tty = coef_t * hwy - (-dy) * inv_e2;
                                float ttz = coef_t * hwz - (-dz) * inv_e2;
                                float ttn = rsqrtf(fmaxf(ttx * ttx
                                                         + tty * tty
                                                         + ttz * ttz,
                                                         F(1e-20)));
                                ndx = ttx * ttn;
                                ndy = tty * ttn;
                                ndz = ttz * ttn;
                            }
                            float p_c;
                            float f_c = rd_fcos_pdf(face, fx, fy, fz, le,
                                                    lkk, lr, la, -dx, -dy,
                                                    -dz, ndx, ndy, ndz,
                                                    &p_c);
                            float co_rd = ndx * fx + ndy * fy + ndz * fz;
                            float odh_s = ndx * hwx + ndy * hwy + ndz * hwz;
                            bool ok = (pick_rf ? co_rd : -co_rd) > 0.0f
                                      && idoth > 0.0f
                                      && odh_s * co_rd > 0.0f;
                            w_b = ok && p_c > 0.0f
                                      ? f_c / fmaxf(p_c, F(1e-20))
                                      : 0.0f;
                        }
                    } else {
                        // [k1 stage: diffuse]  the cosine hemisphere:
                        // diffuse, and the plastic's base
                        float rr2 = sqrtf(u8);
                        float bx = rr2 * fast_cos(ph2),
                              by = rr2 * fast_sin(ph2);
                        float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                        ndx = s1x * bx + s2x * by + fx * bz;
                        ndy = s1y * bx + s2y * by + fy * bz;
                        ndz = s1z * bx + s2z * by + fz * bz;
                        w_b = lr;
                        if (lk == PLASTIC) {
                            // the smooth coat's mirror direction with
                            // probability spec_w; both share the base's
                            // ratio
                            float fi = fres_diel(fabsf(face), le);
                            float spec_w = fminf(fmaxf(fi, F(0.05)),
                                                 F(0.95));
                            if (ud[5] < spec_w) {
                                float dn2 = dx * fx + dy * fy + dz * fz;
                                ndx = dx - 2.0f * dn2 * fx;
                                ndy = dy - 2.0f * dn2 * fy;
                                ndz = dz - 2.0f * dn2 * fz;
                            }
                            float co_p = ndx * fx + ndy * fy + ndz * fz;
                            w_b = lr * (1.0f - fi)
                                  * (1.0f - fres_diel(co_p, le))
                                  / fmaxf(1.0f - spec_w, F(1e-6));
                            if (!(co_p > 0.0f)) w_b = 0.0f;
                        }
                    }
                    // [k1 stage: bounce]
                    if (w_b > 0.0f) {
                        // direct hits at the next vertex follow a delta
                        // bounce only where the tables hold a delta lobe
                        // (a mask's pass alone counts none)
                        wdel = del && (cfg.mirror
                                       || (cfg.lobes
                                           & (LOBE_DIEL | LOBE_THIN)) != 0);
                        // bounce Doppler of the continued path
                        dop = dop * (1.0f + ((ndx - dx) * vbx
                                             + (ndy - dy) * vby
                                             + (ndz - dz) * vbz) / cvel);
                        // a refracted or passed ray leaves through the
                        // back face
                        float off = F(1e-4);
                        if ((cfg.lobes & (LOBE_DIEL | LOBE_THIN | LOBE_RDIEL
                                          | LOBE_MASK))
                            && !(ndx * fx + ndy * fy + ndz * fz >= 0.0f))
                            off = F(-1e-4);
                        dx = ndx;
                        dy = ndy;
                        dz = ndz;
                        thr = thr * w_b;
                        ox = hx + off * fx;
                        oy = hy + off * fy;
                        oz = hz + off * fz;
                        depth = depth + 1;
                        live = true;
                    }
                }
            } else {
                // [k1 stage: bounce]  a diffuse cosine, a GGX half vector
                // or a mirror about the flipped normal (none after the last
                // depth, on the transmitter, or from an absorbing hit)
                if (depth < cfg.max_depth - 1 && txc < 0.0f
                    && (is_ggx || is_m || rb > 0.0f)) {
                    float u8 = ud[3], u9 = ud[4];       // draws d0 + 4, 5
                    float face = -(dx * nx + dy * ny + dz * nz);
                    float sgn = sgn_ge(face);
                    float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                    float sign = sgn_ge(fz);
                    float a2 = -1.0f / (sign + fz);
                    float b2 = fx * fy * a2;
                    float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                          s1z = -sign * fx;
                    float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                    float ph2 = TP * u9;
                    float ndx, ndy, ndz, w_b;
                    bool go = true;
                    if (is_m) {
                        // [k1 stage: mirror]
                        float dn = dx * fx + dy * fy + dz * fz;
                        ndx = dx - 2.0f * dn * fx;
                        ndy = dy - 2.0f * dn * fy;
                        ndz = dz - 2.0f * dn * fz;
                        w_b = rb * fres_cond(fabsf(dn), eb, kk);
                        go = w_b > 0.0f;
                    } else if (is_ggx) {
                        // [k1 stage: ggx]
                        float ag2 = ab * ab;
                        float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                        float cth = rsqrtf(1.0f + tan2);
                        float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                        float hlx = sth * fast_cos(ph2),
                              hly = sth * fast_sin(ph2);
                        float hwx = s1x * hlx + s2x * hly + fx * cth;
                        float hwy = s1y * hlx + s2y * hly + fy * cth;
                        float hwz = s1z * hlx + s2z * hly + fz * cth;
                        float ci_b = fabsf(face);
                        float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                        ndx = 2.0f * idoth * hwx + dx;
                        ndy = 2.0f * idoth * hwy + dy;
                        ndz = 2.0f * idoth * hwz + dz;
                        float co_g = ndx * fx + ndy * fy + ndz * fz;
                        float f_b = fres_cond(fabsf(idoth), eb, kk);
                        float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                        w_b = rb * f_b * g_b * idoth
                              / fmaxf(ci_b * cth, F(1e-8));
                        go = co_g > 0.0f && idoth > 0.0f && w_b > 0.0f;
                    } else {
                        // [k1 stage: diffuse]
                        float rr2 = sqrtf(u8);
                        float bx = rr2 * fast_cos(ph2),
                              by = rr2 * fast_sin(ph2);
                        float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                        ndx = s1x * bx + s2x * by + fx * bz;
                        ndy = s1y * bx + s2y * by + fy * bz;
                        ndz = s1z * bx + s2z * by + fz * bz;
                        w_b = rb;
                    }
                    // [k1 stage: bounce]
                    if (go) {
                        wdel = is_m;
                        // bounce Doppler of the continued path
                        dop = dop * (1.0f + ((ndx - dx) * vbx
                                             + (ndy - dy) * vby
                                             + (ndz - dz) * vbz) / cvel);
                        dx = ndx;
                        dy = ndy;
                        dz = ndz;
                        thr = thr * w_b;
                        ox = hx + F(1e-4) * fx;
                        oy = hy + F(1e-4) * fy;
                        oz = hz + F(1e-4) * fz;
                        depth = depth + 1;
                        live = true;
                    }
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays, then
        // the closest triangle (the walk, pruned by the rectangle's t); a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int code = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    code = r;
                }
            }
            // [k1 stage: walk]
            MeshClosest<true> mc;
            mc.ta = tb;
            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), mc);
            // [k1 stage: trace]
            const bool tri = mc.t < tb;
            if (tri) {
                tb = mc.t;
                code = -1 - min(max((int)mc.sid, 0), cfg.n_msh - 1);
            }
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(code),
                                     __int_as_float(depth
                                                    | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
                if (tri) sl4[4] = make_float4(mc.nx, mc.ny, mc.nz, mc.rf);
            }
        }
        // the lane's sum, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
        if (shade && rows) {
            // [k1 stage: splat]
            if constexpr (COH)
                coh_splat_rows(w_row, w_vals, cfg.n_time, ci, si, yb, j);
            else
                pow_splat_rows(w_row, w_vals, cfg.n_time, ci, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid: its warps' rows summed in warp order, or its
    // float grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (rows) {
        for (int v = tid; v < n_vals; v += T) {
            double s = 0.0;
            for (int w = 0; w < T / 32; ++w)
                s += reinterpret_cast<const double*>(
                    s_warps + w * wbytes + mdk_row_offset())[v];
            partial[(long long)blockIdx.x * n_vals + v] = s;
        }
    } else if (cfg.mode == 1) {
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = (double)s_grid[v];
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(msm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// ---- the mesh kernel: the flagship's turns with the BVH walks -------------
//
// The mesh configuration in power (a static scene of diffuse rectangles
// and triangle meshes, one Wigner transmitter, a Wigner or omni receiver,
// vacuum, mode 0; receive_trace_kernel<true, false, false> before) runs a
// kernel of its own on the flagship kernel's turns.  Its lane is
// trace_lane's mesh path, operation by operation, and what differs is
// which thread runs which part of which lane, and when (PERF.md):
//  - A wavefront inside each warp: the flagship kernel's pool of
//    FLAG_POOL paths, its turns (SHADE over 32 waiting paths, else RAY
//    over the warp's next 32 lanes, each tracing the rays it makes), its
//    draws a stage at a time (flag_draws5, the pulse read at use) and its
//    tables (the rectangles as float4 records, the shadowing rectangles'
//    list, the Wigner receiver's constants).
//  - The walks.  Each turn's trace runs the closest-hit walk of the BVH
//    (bvh::walk with MeshClosest<false>, pruned by the analytic best)
//    after the rectangles, and SHADE's NEE the any-hit walk (bvh::Any,
//    behind the shadowing rectangles) on the pulse's tables in device
//    memory behind the read-only path, as the grid-stride body walks
//    them.  RAY's walks are coherent: a turn's 32 lanes are consecutive,
//    so they share a 1024-lane tile's direction stratum.
//  - The direction strata: RAY takes the tile's cell of the P x P grid
//    (trace_lane's expressions) where the call has them.
//  - The slot: a path waits in MSK_SLOT floats, the flagship's 16 (its
//    free two floats now the lane's sum) and a triangle hit's unit normal
//    and reflectance; the hit's code is its rectangle (>= 0) or -1 (a
//    triangle).
//  - The splat: the 1-D grid goes to the warp's row of n_time doubles,
//    each bin summed in lane order (pow_splat_rows): no atomics, and
//    repeats are bit-identical, as the grid-stride body's private tent
//    rows were.  Each lane's sum goes to lane_val where its path ends.
// The packed tables, the positional draws, the tent, the partial rows,
// the reduce and the CPI's pulse axis (blockIdx.y, as the flagship's) are
// the other configurations'.  The tags "[k1 stage: ...]" name each stage
// for tools/k1_mix.py (walk: the closest-hit walks, shadow_walk: NEE's
// any-hit walk).
constexpr int MSK_SLOT = 20;        // floats a path: five float4s
// Blocks an SM the mesh kernel is held to (PERF.md)
constexpr int MSK_MIN_BLOCKS = 6;

// Shared bytes of one warp's area: its paths of MSK_SLOT floats, a turn's
// slots, the splat's staging (two taps a lane, each lane's first bin),
// then its row of n_time doubles.
__host__ __device__ constexpr int msk_row_offset() {
    return 4 * (FLAG_POOL * MSK_SLOT + 32 + 96);
}
__host__ __device__ constexpr int msk_warp_bytes(int n_time) {
    return (msk_row_offset() + 8 * n_time + 15) & ~15;
}

__global__ void __launch_bounds__(FLAG_THREADS, MSK_MIN_BLOCKS)
receive_mesh_kernel(const float* __restrict__ params,
                    const float* __restrict__ prim,
                    const float* __restrict__ txp,
                    const float* __restrict__ msh,
                    const float* __restrict__ uniforms, bvh::Tables mesh,
                    float* __restrict__ lane_val,
                    double* __restrict__ partial,
                    unsigned long long* __restrict__ part_ev, Cfg cfg) {
    extern __shared__ float4 ksm[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = ksm;
    float4* s_blk = s_rec + FLAG_REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's constants
    float* s_prim = s_rxc + FLAG_RXC;
    int* s_cnt = reinterpret_cast<int*>(s_prim + np * PRIM_COLS);
    char* s_warps = reinterpret_cast<char*>(ksm)
                    + flag_table_bytes(np, cfg.n_params);
    const int wbytes = msk_warp_bytes(cfg.n_time);
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + FLAG_POOL * MSK_SLOT);
    float* w_vals = reinterpret_cast<float*>(w_take + 32);
    double* w_row = reinterpret_cast<double*>(
        reinterpret_cast<char*>(w_slots) + msk_row_offset());

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = tid; i < np * PRIM_COLS; i += T) s_prim[i] = prim[i];
    for (int i = j; i < cfg.n_time; i += 32) w_row[i] = 0.0;
    __syncthreads();
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = s_prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + FLAG_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], 0.0f, 0.0f, 0.0f);
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the Wigner receiver's frame and lobe mixture, trace_lane's
        // expressions: they depend on the tables alone
        const float* rxm = s_par + 2;
        const float rx_wx = s_par[14], rx_wy = s_par[15];
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float lam0 = s_par[1] / fmaxf(cfg.f_rx, F(1e-6));
        float w_mn = fminf(rx_wx, rx_wy);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[3] = 4.0f * rx_wx * rx_wy;                         // area
        rc[4] = k_l;
        rc[5] = k_l + 1.0f;
        rc[6] = 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586);
        rc[7] = lam0;
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    const int base = cfg.omni ? 3 : 5;        // trace_lane's r0 + 2 or r0 + 4
    // the pulse's BVH tables and lane sums, held a block
    const bvh::Tables mesh_b = pulse_tables(mesh, cfg);
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // the direction strata: the tile's cell of a P x P grid (trace_lane's)
    const long long n_strata = (long long)cfg.patch_p * cfg.patch_p;
    const int slot0 = (int)sp[0];
    const float inv_p = cfg.patch_p > 0
                            ? (float)(1.0 / (double)cfg.patch_p) : 0.0f;
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes (at most 31 paths wait, so
        // 33 slots are free), else the rest of SHADE, else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int r1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && r1 < 32) w_take[r1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + MSK_SLOT * (slot < 0 ? 0 : slot));
        // the turn's lane and its five draws: RAY a new lane's draws 0-4,
        // SHADE its path's d0 + 1 .. d0 + 5 (the slot's lane and depth)
        long long lane = next + j;
        int depth = 0;
        float lsum = 0.0f;
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            lsum = e.z;
            depth = __float_as_int(sl4[2].w);
        }
        const int d0 = base + 6 * depth;
        float u5[5];
        // [k1 stage: draws]
        if (slot >= 0)
            flag_draws5(cfg, uniforms, lane, shade ? d0 + 1 : 0, u5);
        // [k1 stage: sched]

        // the path this turn traces: a new lane's ray (RAY) or the bounce
        // of a shaded one (SHADE); its state
        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        float val = 0.0f, yb = 0.0f;       // SHADE: the contribution
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive ray (draws 0..4)
                const float* rxm = sp + 2;
                const float rx_wx = sp[14], rx_wy = sp[15];
                t_rx0 = cfg.gate ? 0.0f
                                 : cfg.t_start + u5[0] * cfg.t_window;
                if (cfg.omni) {
                    ox = rxm[3];
                    oy = rxm[7];
                    oz = rxm[11];
                    float z = 1.0f - 2.0f * u5[1];
                    float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
                    float ph = TP * u5[2];
                    dx = r * fast_cos(ph);
                    dy = r * fast_sin(ph);
                    dz = z;
                    thr = F(4.0 * 3.141592653589793) * sp[32];
                } else {
                    float lx = 2.0f * u5[1] - 1.0f, ly = 2.0f * u5[2] - 1.0f;
                    ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
                    oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
                    oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
                    const float* rc = s_rxc;
                    const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                    const float u3 = u5[3], u4 = u5[4];
                    float tx_, ty_, tz, w0;
                    if (cfg.patch_p > 0) {
                        // stratified cosine hemisphere: the tile's cell
                        // plus the lane's jitter; cos pdf, weight pi area
                        const long long P = cfg.patch_p;
                        long long patch = ((lane / 1024) * 131 + slot0)
                                          % n_strata;
                        float s3 = ((float)(patch % P) + u3) * inv_p;
                        float s4 = ((float)(patch / P) + u4) * inv_p;
                        float rr = sqrtf(s3);
                        float ph = TP * s4;
                        tx_ = rr * fast_cos(ph);
                        ty_ = rr * fast_sin(ph);
                        tz = sqrtf(fmaxf(1.0f - s3, 0.0f));
                        w0 = F(3.141592653589793) * rc[3] * sp[32];
                    } else {
                        bool pick = u3 >= 0.5f;
                        float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
                        float ph = TP * u4;
                        float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
                        float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / rc[5]);
                        tz = pick ? ct_l : ct_c;
                        float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
                        tx_ = st * fast_cos(ph);
                        ty_ = st * fast_sin(ph);
                        float cosk = expf(rc[4] * logf(fmaxf(tz, F(1e-12))));
                        float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                                      + rc[6] * cosk;
                        w0 = (tz / fmaxf(pdf_d, F(1e-30))) * rc[3] * sp[32];
                    }
                    dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                    dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                    dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                    float lam = rc[7];
                    float nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz)
                                 / fmaxf(rx_wx, F(1e-9)) / lam;
                    float nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz)
                                 / fmaxf(rx_wy, F(1e-9)) / lam;
                    float trx = tri_f(lx * 0.5f), try_ = tri_f(ly * 0.5f);
                    thr = w0 * (4.0f * trx * try_
                                * sinc_f(TP * nu_x * rx_wx * trx)
                                * sinc_f(TP * nu_y * rx_wy * try_));
                    ox = ox + F(1e-4) * nzx;
                    oy = oy + F(1e-4) * nzy;
                    oz = oz + F(1e-4) * nzz;
                }
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit's normal and reflectance: a rectangle's record, or
            // the triangle's from the slot
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const int code = __float_as_int(c.z);
            const float4 nrb = code >= 0 ? s_rec[FLAG_REC * code + 3]
                                         : sl4[4];
            const float nx = nrb.x, ny = nrb.y, nz = nrb.z, rb = nrb.w;
            const float txc = code >= 0 ? s_rec[FLAG_REC * code + 4].x
                                        : -1.0f;
            const float cvel = sp[1];
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;

            // [k1 stage: direct]  direct transmitter hits at depth 0
            if (depth == 0) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h;
                    tx.emission(plen / cvel,
                                flag_draw1(cfg, uniforms, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, nullptr);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    events += val != 0.0f;
                    lsum += val;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits)
            if (txc < 0.0f) {
                float glx = 2.0f * u5[0] - 1.0f;
                float gly = 2.0f * u5[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d,
                      wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12)))
                                   * dist2 / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                    float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                               + wz_ * (nz * sg);
                    float f_cos = rb * F(1.0 / 3.141592653589793)
                                  * fmaxf(co, 0.0f);
                    float t_emit, t_recv, w_gate;
                    tx.emission((plen + dist) / cvel, u5[2],
                                t_rx0, cfg.gate, t_start, t_window,
                                &t_emit, &t_recv, &w_gate, nullptr);
                    float f_emit = tx.inst_freq(t_emit);
                    float sig = tx.eval_wdf(t_emit, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = rect_hit4(s_blk + 3 * r, sx, sy, sz,
                                               wx_, wy_, wz_, &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: shadow_walk]  the mesh's any hit
                    if (!occ) {
                        bvh::Any sh;
                        sh.limit = limit;
                        bvh::walk(mesh_b,
                                  bvh::make_ray(sx, sy, sz, wx_, wy_, wz_),
                                  sh);
                        occ = sh.occ;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (t_recv - t_start) / t_window * n_time_f
                             - 0.5f;
                        events += val != 0.0f;
                        lsum += val;
                    }
                }
            }

            // [k1 stage: bounce]  the diffuse bounce: cosine
            // hemisphere about the flipped normal (none after the
            // last depth, from an absorbing hit or on the transmitter)
            if (depth < cfg.max_depth - 1 && rb > 0.0f && txc < 0.0f) {
                float u8 = u5[3], u9 = u5[4];           // draws d0 + 4, 5
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float rr2 = sqrtf(u8);
                float ph2 = TP * u9;
                float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                dx = s1x * bx + s2x * by + fx * bz;
                dy = s1y * bx + s2y * by + fy * bz;
                dz = s1z * bx + s2z * by + fz * bz;
                thr = thr * rb;
                ox = hx + F(1e-4) * fx;
                oy = hy + F(1e-4) * fy;
                oz = hz + F(1e-4) * fz;
                depth = depth + 1;
                live = true;
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays, then
        // the closest triangle (the walk, pruned by the rectangle's t); a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int code = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + FLAG_REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    code = r;
                }
            }
            // [k1 stage: walk]
            MeshClosest<false> mc;
            mc.ta = tb;
            bvh::walk(mesh_b, bvh::make_ray(ox, oy, oz, dx, dy, dz), mc);
            // [k1 stage: trace]
            const bool tri = mc.t < tb;
            if (tri) {
                tb = mc.t;
                code = -1;
            }
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(code),
                                     __int_as_float(depth));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     lsum, 0.0f);
                if (tri) sl4[4] = make_float4(mc.nx, mc.ny, mc.nz, mc.rf);
            }
        }
        // the lane's sum, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo = slot >= 0 && slot < 32, hi = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi && hit ? bit : 0u);
        if (shade) {
            // [k1 stage: splat]
            pow_splat_rows(w_row, w_vals, cfg.n_time, val, yb, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's row: its warps' rows summed in warp order; its events
    partial += pulse * gridDim.x * (long long)cfg.n_time;
    part_ev += pulse * gridDim.x;
    for (int b = tid; b < cfg.n_time; b += T) {
        double s = 0.0;
        for (int w = 0; w < T / 32; ++w)
            s += reinterpret_cast<const double*>(
                s_warps + w * wbytes + msk_row_offset())[b];
        partial[(long long)blockIdx.x * cfg.n_time + b] = s;
    }
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(ksm);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// ---- the MIMO array kernel: the coherent kernel's turns --------------------
//
// The MIMO configuration (a phased receive array, one I / Q pair an
// element, analytic scenes, vacuum; receive_mimo_kernel<false, false>
// before) runs a kernel of its own on the coherent kernel's turns.  Its
// lane is trace_lane's MIMO path, operation by operation, and what
// differs is which thread runs which part of which lane, and when
// (PERF.md):
//  - A wavefront inside each warp: the coherent kernel's pool of COH_POOL
//    paths, its turns (SHADE over 32 waiting paths, else RAY over the
//    warp's next 32 lanes, each tracing the rays it makes), its draws a
//    stage at a time and its tables (the rectangles, the shadowing
//    rectangles' list, the receiver's frame).  On golden config 6 a few
//    lanes in a thousand hit: the grid-stride body held a warp on the one
//    lane that did (its NEE, its element loop, its bounce and trace).
//  - RAY: the receive frequency by receive type, then the array's ray
//    from its origin over the cosine hemisphere about its normal, weighted
//    by one element's pattern gain (draws r0 + 2, r0 + 3; r0, r0 + 1 are
//    not used), and its Doppler factor.
//  - The slot: a path waits in MAK_SLOT floats, the coherent kernel's 16
//    and the lane's first vertex less the array's origin and its length
//    (x1 - o, |x1 - o|: SHADE takes them at depth 0 and carries them).
//  - The splat: each connection's echo phase less each element's term,
//    into the element's I / Q pair of the (n_time, 2E) grid of doubles:
//    the block's grid in shared memory, added to with float64 atomics, or
//    the global grid past MAX_SMEM_MIMO_VALS values (mode 2).  SHADE
//    stages each connection's phase, amplitude, tent and first vertex in
//    the warp's staging area (mimo_stage); after the turn's trace the warp
//    runs the connections' (connection, element) items 32 at a time
//    (mimo_warp_taps), each with mimo_splat's rounded arithmetic, rather
//    than each connecting thread looping over the E elements while the
//    others wait (0.90 of that, tools/k1_ablate.py).  Each lane's sum of
//    amplitudes goes to lane_val where its path ends.
// The packed tables, the positional draws, the tent, the partial rows and
// the reduce are the other configurations'.  The tags "[k1 stage: ...]"
// name each stage for tools/k1_mix.py.
constexpr int MAK_SLOT = 20;        // floats a path: five float4s
constexpr int MAK_STAGE = 10;       // floats a connection stages for taps
// Blocks an SM the MIMO array kernel is held to: four (128 registers, no
// spill) ran 0.93 of six (80, ~170 B spilled), five 0.98 (PERF.md)
constexpr int MAK_MIN_BLOCKS = 4;

// Shared bytes of one warp's area: its paths of MAK_SLOT floats, a turn's
// slots, the staging of 32 connections' taps.
__host__ __device__ constexpr int mak_warp_bytes() {
    return (4 * (COH_POOL * MAK_SLOT + 32 + 32 * MAK_STAGE) + 15) & ~15;
}
// Shared bytes of a block's tables, ahead of the warps' areas: the
// coherent kernel's, then the element half-widths and offsets.
__host__ __device__ constexpr int mak_table_bytes(int n_prims, int n_params,
                                                  int n_elem) {
    return (16 * (COH_REC + 3) * n_prims
            + 4 * (n_params + TXP_COLS + 4 + COH_RXC + 4 + 2 + 3 * n_elem)
            + 15)
           & ~15;
}

// SHADE's part of a connection's taps (mimo_splat's terms before its
// element loop): its echo phase plus n_bnd boundary phases and amplitude,
// returned as the lane sum's share; where it has taps (val != 0 and a
// bin in the grid), its phase, amplitude, 2 pi f / c, tent weights, first
// bin and first vertex go to thread j's column of the warp's staging area
// `st` (MAK_STAGE rows of 32) and *taps is set.
__device__ __forceinline__ float mimo_stage(
    const Cfg& cfg, const Tx& tx, const Wave& lo, const float* sp, float val,
    float yb, float f_recv, float t_recv, float dtot, float t_emit,
    float k_pri, int n_bnd, float v0x, float v0y, float v0z, float r0,
    float* st, int j, bool* taps) {
    float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit, t_recv, k_pri);
    if (n_bnd > 0) ph = add_rn(ph, mul_rn((float)n_bnd, sp[16]));
    float amp = sqrtf(fmaxf(val, 0.0f));
    *taps = false;
    if (val == 0.0f) return amp;
    float b0 = floorf(yb);
    if (!(b0 >= -1.0f && b0 < (float)cfg.n_time)) return amp;  // drops NaN
    st[j] = ph;
    st[32 + j] = amp;
    st[64 + j] = mul_rn(F(6.283185307179586), f_recv / sp[1]);
    st[96 + j] = fmaxf(1.0f - fabsf(yb - b0), 0.0f);
    st[128 + j] = fmaxf(1.0f - fabsf(yb - (b0 + 1.0f)), 0.0f);
    st[160 + j] = __int_as_float((int)b0);
    st[192 + j] = v0x;
    st[224 + j] = v0y;
    st[256 + j] = v0z;
    st[288 + j] = r0;
    *taps = true;
    return amp;
}

// The warp's element taps of the connections its threads staged (taps):
// item i of the n_c x E items is element i mod E of the (i / E)-th staged
// thread in lane order, run by thread i mod 32, each with mimo_splat's
// element arithmetic, rounded as the plain version's.  Every thread of
// the warp calls it.
// [k1 splat]
__device__ __forceinline__ void mimo_warp_taps(const MimoGrid& grid,
                                               const Cfg& cfg,
                                               const float* st, bool taps,
                                               int j) {
    const unsigned go = __ballot_sync(FULL_MASK, taps);
    if (go == 0u) return;
    __syncwarp();
    const int n_e = cfg.n_elem, n_ch = 2 * n_e;
    const int n = __popc(go) * n_e;
    const float* eo = grid.tab + 2;
    for (int it = j; it < n; it += 32) {
        const int c = it / n_e, e = it - c * n_e;
        unsigned g = go;
        for (int q = 0; q < c; ++q) g &= g - 1u;
        const int k = __ffs(g) - 1;
        const float ph = st[k], amp = st[32 + k], kf = st[64 + k];
        const float wt0 = st[96 + k], wt1 = st[128 + k];
        const int i0 = __float_as_int(st[160 + k]);
        float vx = sub_rn(st[192 + k], eo[3 * e]);
        float vy = sub_rn(st[224 + k], eo[3 * e + 1]);
        float vz = sub_rn(st[256 + k], eo[3 * e + 2]);
        float re = __fsqrt_rn(fmaxf(add_rn(add_rn(mul_rn(vx, vx),
                                                  mul_rn(vy, vy)),
                                           mul_rn(vz, vz)), F(1e-20)));
        float pe = sub_rn(ph, mul_rn(kf, sub_rn(re, st[288 + k])));
        float ci = amp * fast_cos(pe), si = amp * fast_sin(pe);
        if (i0 >= 0) {
            grid.add(i0 * n_ch + 2 * e, ci * wt0);
            grid.add(i0 * n_ch + 2 * e + 1, si * wt0);
        }
        if (i0 + 1 < cfg.n_time) {
            grid.add((i0 + 1) * n_ch + 2 * e, ci * wt1);
            grid.add((i0 + 1) * n_ch + 2 * e + 1, si * wt1);
        }
    }
    __syncwarp();
}

__global__ void __launch_bounds__(COH_THREADS, MAK_MIN_BLOCKS)
receive_mimo_array_kernel(const float* __restrict__ params,
                          const float* __restrict__ prim,
                          const float* __restrict__ txp,
                          const float* __restrict__ msh,
                          const float* __restrict__ uniforms,
                          bvh::Tables mesh, float* __restrict__ lane_val,
                          double* __restrict__ partial,
                          unsigned long long* __restrict__ part_ev, Cfg cfg,
                          const float* __restrict__ rxph,
                          const float* __restrict__ eoff) {
    extern __shared__ float4 asm_[];
    const int T = blockDim.x, tid = threadIdx.x, j = tid & 31;
    const long long pulse = blockIdx.y;
    const int np = cfg.n_prims;
    params += pulse * cfg.n_params;
    prim += pulse * np * PRIM_COLS;
    txp += pulse * TXP_COLS;
    float4* s_rec = asm_;
    float4* s_blk = s_rec + COH_REC * np;
    float* s_par = reinterpret_cast<float*>(s_blk + 3 * np);
    float* s_tx = s_par + cfg.n_params;      // its row, then its unit normal
    float* s_rxc = s_tx + TXP_COLS + 4;      // the receiver's frame
    int* s_cnt = reinterpret_cast<int*>(s_rxc + COH_RXC);
    // the element half-widths, then the (E, 3) element offsets
    float* s_mimo = reinterpret_cast<float*>(s_cnt + 4);
    char* s_warps = reinterpret_cast<char*>(asm_)
                    + mak_table_bytes(np, cfg.n_params, cfg.n_elem);
    const int wbytes = mak_warp_bytes();
    float* w_slots = reinterpret_cast<float*>(s_warps + (tid >> 5) * wbytes);
    int* w_take = reinterpret_cast<int*>(w_slots + COH_POOL * MAK_SLOT);
    float* w_st = reinterpret_cast<float*>(w_take + 32);   // taps' staging
    // the values of a pulse's grid: an I / Q pair an element a bin
    const long long n_vals = 2LL * cfg.n_elem * cfg.n_time;
    // mode 1: the block's grid of doubles after the warps'
    double* s_dgrid = reinterpret_cast<double*>(s_warps + (T / 32) * wbytes);

    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = tid; i < 2; i += T) s_mimo[i] = rxph[i];
    for (int i = tid; i < 3 * cfg.n_elem; i += T) s_mimo[2 + i] = eoff[i];
    if (cfg.mode == 1)
        for (long long i = tid; i < n_vals; i += T) s_dgrid[i] = 0.0;
    if (tid == 0) {
        // the rectangles in prim order, and those that can shadow an NEE
        // (the transmitter's own, tx index 0 in column 14, never does)
        int nr = 0, nb = 0;
        for (int p = 0; p < np; ++p) {
            const float* row = prim + p * PRIM_COLS;
            if ((int)row[0] != RECTANGLE) continue;
            const float* q = row + 1;
            float rnorm = rsqrtf(fmaxf(q[8] * q[8] + q[9] * q[9]
                                       + q[10] * q[10], F(1e-20)));
            float4* r = s_rec + COH_REC * nr++;
            r[0] = make_float4(q[0], q[1], q[2], q[3]);
            r[1] = make_float4(q[4], q[5], q[6], q[7]);
            r[2] = make_float4(q[8], q[9], q[10], q[11]);
            r[3] = make_float4(q[8] * rnorm, q[9] * rnorm, q[10] * rnorm,
                               row[13]);
            r[4] = make_float4(row[14], row[18], row[15], row[16]);
            r[5] = make_float4(row[17], row[19], row[20], row[21]);
            if (row[14] != 0.0f) {
                float4* b = s_blk + 3 * nb++;
                b[0] = r[0];
                b[1] = r[1];
                b[2] = r[2];
            }
        }
        s_cnt[0] = nr;
        s_cnt[1] = nb;
    }
    __syncthreads();
    if (tid == 0) {
        const float* m = s_tx;
        float tnn = rsqrtf(fmaxf(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                 F(1e-20)));
        s_tx[TXP_COLS] = m[2] * tnn;
        s_tx[TXP_COLS + 1] = m[6] * tnn;
        s_tx[TXP_COLS + 2] = m[10] * tnn;
        // the array's frame about its normal, trace_lane's expressions,
        // and its rows' inverse half-widths
        const float* rxm = s_par + 2;
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float* rc = s_rxc;
        rc[0] = nzx;
        rc[1] = nzy;
        rc[2] = nzz;
        rc[4] = 1.0f / fmaxf(s_par[14], F(1e-20));           // iwx
        rc[5] = 1.0f / fmaxf(s_par[15], F(1e-20));           // iwy
        rc[8] = 1.0f + sign * nzx * nzx * a;                  // s1
        rc[9] = sign * b;
        rc[10] = -sign * nzx;
        rc[11] = b;                                           // s2
        rc[12] = sign + nzy * nzy * a;
        rc[13] = -nzy;
    }
    __syncthreads();

    const float TP = F(6.283185307179586);
    const float* sp = s_par;
    const float cvel = sp[1];
    const int n_rect = s_cnt[0], n_blk = s_cnt[1];
    // the pulse's uniforms, Philox key and lane sums, held a block
    const float* u_p = uniforms == nullptr ? nullptr
                                           : uniforms + pulse * cfg.u_stride;
    const unsigned long long key = cfg.seed + cfg.seed_step * pulse;
    float* lv_p = lane_val == nullptr ? nullptr : lane_val + pulse * cfg.n_lanes;
    // trace_lane's r0: a frequency or beat draw comes before the ray's
    const int r0 = (cfg.rule == RX_MIXER
                    || (cfg.rule == 0 && cfg.n_freq > 1)) ? 2 : 1;
    const int base = r0 + 4;
    MimoGrid grid;
    grid.tab = s_mimo;
    grid.s = cfg.mode == 1 ? s_dgrid : nullptr;
    grid.g = partial + (cfg.mode == 2 ? pulse * n_vals : 0);
    const Wave lo{s_par + 33, s_par + 41};
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    long long next = (long long)blockIdx.x * T + (tid & ~31);
    const unsigned lt = (1u << j) - 1u;
    // the slots whose paths wait for SHADE, the same in every thread (bit
    // s of the pair: slot s); the others are free
    unsigned sh_lo = 0u, sh_hi = 0u;
    for (;;) {
        // [k1 stage: sched]  the turn: SHADE when 32 paths wait for it,
        // else RAY for the warp's next lanes, else the rest of SHADE,
        // else done
        __syncwarp();
        const int n_sh = __popc(sh_lo) + __popc(sh_hi);
        const int n_new = next < cfg.n_lanes
                              ? (int)min(32LL, cfg.n_lanes - next) : 0;
        const bool shade = n_sh >= 32 || (n_new == 0 && n_sh > 0);
        if (!shade && n_new == 0) break;
        const unsigned m0 = shade ? sh_lo : ~sh_lo;
        const unsigned m1 = shade ? sh_hi : ~sh_hi;
        if ((m0 >> j) & 1u) w_take[__popc(m0 & lt)] = j;
        const int rk1 = __popc(m0) + __popc(m1 & lt);
        if (((m1 >> j) & 1u) && rk1 < 32) w_take[rk1] = j + 32;
        __syncwarp();
        const int n_go = shade ? min(32, n_sh) : n_new;
        const int slot = j < n_go ? w_take[j] : -1;
        float4* sl4 = reinterpret_cast<float4*>(
            w_slots + MAK_SLOT * (slot < 0 ? 0 : slot));
        long long lane = next + j;
        int depth = 0;
        bool wdel = false;
        float dop = 1.0f, lsum = 0.0f;
        bool taps = false;      // SHADE staged a connection's taps
        if (shade && slot >= 0) {
            const float4 e = sl4[3];
            lane = (long long)(((unsigned long long)__float_as_uint(e.y)
                                << 32)
                               | __float_as_uint(e.x));
            dop = e.z;
            lsum = e.w;
            const int dw = __float_as_int(sl4[2].w);
            depth = dw & 0xffff;
            wdel = (dw >> 16) != 0;
        }
        const int d0 = base + 6 * depth;
        float ud[6];
        // [k1 stage: draws]
        if (slot >= 0) {
            if (shade)
                coh_draws5(cfg, u_p, key, lane, d0 + 1, ud);
            else
                coh_ray_draws(cfg, u_p, key, lane, ud);
        }
        // [k1 stage: sched]

        bool live = false;
        float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
              dz = 0.0f, thr = 0.0f, plen = 0.0f, t_rx0 = 0.0f;
        // the lane's first vertex less the array's origin, and its length
        float v0x = 0.0f, v0y = 0.0f, v0z = 0.0f, r0m = 0.0f;
        if (!shade) {
            if (slot >= 0) {
                // [k1 stage: ray]  trace_lane's receive frequency and the
                // array's ray
                const float* rxm = sp + 2;
                t_rx0 = cfg.gate ? 0.0f : cfg.t_start + ud[0] * cfg.t_window;
                float f_rx = cfg.f_rx;
                {
                    float t_mid = t_rx0 + (cfg.gate ? 0.5f * cfg.t_window
                                                    : 0.0f);
                    if (cfg.rule == RX_MIX) {
                        f_rx = Wave{s_tx + 16, s_tx + 28}.inst_freq(t_mid);
                    } else if (cfg.rule == RX_RAW_LO) {
                        f_rx = lo.inst_freq(t_mid);
                    } else if (cfg.rule == RX_MIXER) {
                        f_rx = lo.inst_freq(t_mid)
                               - (cfg.f_lo + ud[1] * cfg.f_span);
                    } else if (cfg.n_freq > 1) {
                        f_rx = cfg.f_lo + ud[1] * cfg.f_span;
                    }
                }
                // the ray draws r0 + 2, r0 + 3, each read at a constant
                // index (a run-time one would keep `ud` in local memory)
                const bool fd = r0 == 2;
                const float u3 = fd ? ud[4] : ud[3], u4 = fd ? ud[5] : ud[4];
                const float* rc = s_rxc;
                const float nzx = rc[0], nzy = rc[1], nzz = rc[2];
                float rr = sqrtf(u3);
                float ph = TP * u4;
                float tx_ = rr * fast_cos(ph), ty_ = rr * fast_sin(ph);
                float tz = sqrtf(fmaxf(1.0f - u3, 0.0f));
                dx = rc[8] * tx_ + rc[11] * ty_ + nzx * tz;
                dy = rc[9] * tx_ + rc[12] * ty_ + nzy * tz;
                dz = rc[10] * tx_ + rc[13] * ty_ + nzz * tz;
                float iwx = rc[4], iwy = rc[5];
                float lam = cvel / fmaxf(f_rx, F(1e-6));
                float nu_x = (dx * (rxm[0] * iwx) + dy * (rxm[4] * iwx)
                              + dz * (rxm[8] * iwx)) / lam;
                float nu_y = (dx * (rxm[1] * iwy) + dy * (rxm[5] * iwy)
                              + dz * (rxm[9] * iwy)) / lam;
                float wex = s_mimo[0], wey = s_mimo[1];
                thr = F(16.0 * 3.141592653589793) * wex * wey
                      * sinc_f(TP * nu_x * wex) * sinc_f(TP * nu_y * wey)
                      * sp[32];
                ox = rxm[3] + F(1e-4) * nzx;
                oy = rxm[7] + F(1e-4) * nzy;
                oz = rxm[11] + F(1e-4) * nzz;
                // cumulative Doppler factor, the receiver's motion first
                dop = 1.0f + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel;
                live = true;
            }
            next += stride;
        } else if (slot >= 0) {
            // [k1 stage: hit]  the path from its slot, the hit point and
            // the hit rectangle's lobe
            const float4 a = sl4[0], b = sl4[1], c = sl4[2];
            const float cx = a.x, cy = a.y, cz = a.z;
            thr = a.w;
            dx = b.x;
            dy = b.y;
            dz = b.z;
            t_rx0 = c.x;
            const float tb = c.y;
            const float4* rec = s_rec + COH_REC * __float_as_int(c.z);
            const float4 nrb = rec[3], lob = rec[4], kv = rec[5];
            const float nx = nrb.x, ny = nrb.y, nz = nrb.z, rb = nrb.w;
            const float txc = lob.x, kb = lob.y, ab = lob.z, eb = lob.w;
            const float kk = kv.x, vbx = kv.y, vby = kv.z, vbz = kv.w;
            const float n_time_f = (float)cfg.n_time;
            const float t_start = cfg.t_start, t_window = cfg.t_window;
            Tx tx;
            tx.m = s_tx;
            tx.wx = s_tx[12];
            tx.wy = s_tx[13];
            tx.area = s_tx[14];
            tx.gain = s_tx[15];
            tx.wf = s_tx[16];
            tx.amp = s_tx[17];
            tx.prf = s_tx[18];
            tx.text = s_tx[19];
            tx.fc = s_tx[20];
            tx.fext = s_tx[21];
            tx.nx = s_tx[TXP_COLS];
            tx.ny = s_tx[TXP_COLS + 1];
            tx.nz = s_tx[TXP_COLS + 2];
            tx.vx = s_tx[24];
            tx.vy = s_tx[25];
            tx.vz = s_tx[26];
            tx.w = Wave{s_tx + 16, s_tx + 28};
            const float* m = tx.m;
            plen = b.w + tb;
            float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;
            const bool is_ggx = kb == ROUGH_CONDUCTOR;
            const bool is_m = cfg.mirror && kb == CONDUCTOR;
            // the first vertex less the origin (depth 0), rounded as the
            // plain version's; after it, the slot's
            if (depth == 0) {
                v0x = hx - cx;
                v0y = hy - cy;
                v0z = hz - cz;
                r0m = __fsqrt_rn(fmaxf(add_rn(add_rn(mul_rn(v0x, v0x),
                                                     mul_rn(v0y, v0y)),
                                              mul_rn(v0z, v0z)), F(1e-20)));
            } else {
                const float4 v = sl4[4];
                v0x = v.x;
                v0y = v.y;
                v0z = v.z;
                r0m = v.w;
            }
            // the connection, if any: its power and its phase's inputs
            bool conn = false;
            float val = 0.0f, yb = 0.0f, f_recv = 0.0f, t_recv = 0.0f,
                  dtot = 0.0f, t_emit = 0.0f, k_c = 0.0f;
            int n_bnd = 0;

            // [k1 stage: direct]  direct transmitter hits at depth 0 and
            // after a mirror bounce
            if (depth == 0 || wdel) {
                float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
                if (txc == 0.0f && cos_dh > 0.0f) {
                    float te_h, tr_h, wg_h, k_h = 0.0f;
                    tx.emission(plen / cvel,
                                coh_draw1(cfg, u_p, key, lane, d0), t_rx0,
                                cfg.gate, t_start, t_window, &te_h, &tr_h,
                                &wg_h, &k_h);
                    float fe_h = tx.inst_freq(te_h);
                    float sig_h = tx.eval_wdf(te_h, fe_h);
                    float lam_h = cvel / fmaxf(fe_h, F(1e-6));
                    float lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                                 + (hz - m[11]) * m[8])
                                / fmaxf(tx.wx * tx.wx, F(1e-12));
                    float lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                                 + (hz - m[11]) * m[9])
                                / fmaxf(tx.wy * tx.wy, F(1e-12));
                    float ap_h = tx.aperture(lxh, lyh, dx, dy, dz, lam_h);
                    float w_dh = sig_h * tx.gain * ap_h * TP;
                    val = thr * w_dh * wg_h;
                    yb = (tr_h - t_start) / t_window * n_time_f - 0.5f;
                    f_recv = fe_h * dop;
                    t_recv = tr_h;
                    dtot = plen;
                    t_emit = te_h;
                    k_c = k_h;
                    conn = true;
                }
            }

            // [k1 stage: nee]  NEE to the transmitter (only from
            // non-transmitter hits; none from a mirror)
            if (txc < 0.0f && !is_m) {
                float glx = 2.0f * ud[0] - 1.0f;
                float gly = 2.0f * ud[1] - 1.0f;
                float qx = m[0] * glx + m[1] * gly + m[3];
                float qy = m[4] * glx + m[5] * gly + m[7];
                float qz = m[8] * glx + m[9] * gly + m[11];
                float vx = qx - hx, vy = qy - hy, vz = qz - hz;
                float dist2 = vx * vx + vy * vy + vz * vz;
                float dist = sqrtf(fmaxf(dist2, F(1e-20)));
                float inv_d = 1.0f / dist;
                float wx_ = vx * inv_d, wy_ = vy * inv_d, wz_ = vz * inv_d;
                float cos_tx = -(wx_ * tx.nx + wy_ * tx.ny + wz_ * tx.nz);
                if (cos_tx > F(1e-6)) {
                    float pdf_sa = (1.0f / fmaxf(tx.area, F(1e-12))) * dist2
                                   / fmaxf(cos_tx, F(1e-6));
                    float cos_s = wx_ * nx + wy_ * ny + wz_ * nz;
                    float f_cos;
                    if (is_ggx) {
                        f_cos = ggx_fcos(rb, ab, eb, kk, nx, ny, nz, -dx,
                                         -dy, -dz, wx_, wy_, wz_);
                    } else {
                        float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                        float co = wx_ * (nx * sg) + wy_ * (ny * sg)
                                   + wz_ * (nz * sg);
                        f_cos = rb * F(1.0 / 3.141592653589793)
                                * fmaxf(co, 0.0f);
                    }
                    float te_n, tr_n, w_gate, k_nee = 0.0f;
                    tx.emission((plen + dist) / cvel, ud[2], t_rx0, cfg.gate,
                                t_start, t_window, &te_n, &tr_n, &w_gate,
                                &k_nee);
                    float f_emit = tx.inst_freq(te_n);
                    float sig = tx.eval_wdf(te_n, f_emit);
                    float ap = tx.aperture(glx, gly, wx_, wy_, wz_,
                                           cvel / fmaxf(f_emit, F(1e-6)));
                    float w_tx = sig * tx.gain * ap * TP;
                    float off = F(1e-4) * sign0(cos_s);
                    float sx = hx + off * nx, sy = hy + off * ny,
                          sz = hz + off * nz;
                    float limit = dist * F(0.999);
                    // [k1 stage: shadow]
                    bool occ = false;
                    for (int r = 0; r < n_blk && !occ; ++r) {
                        float t_p;
                        bool hit_p = rect_hit4(s_blk + 3 * r, sx, sy, sz,
                                               wx_, wy_, wz_, &t_p);
                        occ = hit_p && t_p > F(1e-4) && t_p < limit;
                    }
                    // [k1 stage: nee]
                    if (!occ && pdf_sa > 0.0f) {
                        val = thr * f_cos * w_tx * w_gate
                              / fmaxf(pdf_sa, F(1e-30));
                        yb = (tr_n - t_start) / t_window * n_time_f - 0.5f;
                        // connection Doppler: the vertex's bounce and the
                        // transmitter's motion; the phase adds the
                        // boundary phase of depth + 1 vertices
                        float dop_vtx = 1.0f + ((wx_ - dx) * vbx
                                                + (wy_ - dy) * vby
                                                + (wz_ - dz) * vbz) / cvel;
                        float dop_tx = 1.0f - (wx_ * tx.vx + wy_ * tx.vy
                                               + wz_ * tx.vz) / cvel;
                        f_recv = f_emit * dop * dop_vtx * dop_tx;
                        t_recv = tr_n;
                        dtot = plen + dist;
                        t_emit = te_n;
                        k_c = k_nee;
                        n_bnd = depth + 1;
                        conn = true;
                    }
                }
            }
            if (conn) {
                // [k1 stage: splat]  the echo phase; the element taps'
                // terms staged for the warp
                lsum += mimo_stage(cfg, tx, lo, sp, val, yb, f_recv, t_recv,
                                   dtot, t_emit, k_c, n_bnd, v0x, v0y, v0z,
                                   r0m, w_st, j, &taps);
                events += val != 0.0f;
            }

            // [k1 stage: bounce]  a diffuse cosine, a GGX half vector or a
            // mirror about the flipped normal (none after the last depth,
            // on the transmitter, or from an absorbing hit)
            if (depth < cfg.max_depth - 1 && txc < 0.0f
                && (is_ggx || is_m || rb > 0.0f)) {
                float u8 = ud[3], u9 = ud[4];           // draws d0 + 4, 5
                float face = -(dx * nx + dy * ny + dz * nz);
                float sgn = sgn_ge(face);
                float fx = nx * sgn, fy = ny * sgn, fz = nz * sgn;
                float sign = sgn_ge(fz);
                float a2 = -1.0f / (sign + fz);
                float b2 = fx * fy * a2;
                float s1x = 1.0f + sign * fx * fx * a2, s1y = sign * b2,
                      s1z = -sign * fx;
                float s2x = b2, s2y = sign + fy * fy * a2, s2z = -fy;
                float ph2 = TP * u9;
                float ndx, ndy, ndz, w_b;
                bool go = true;
                if (is_m) {
                    float dn = dx * fx + dy * fy + dz * fz;
                    ndx = dx - 2.0f * dn * fx;
                    ndy = dy - 2.0f * dn * fy;
                    ndz = dz - 2.0f * dn * fz;
                    w_b = rb * fres_cond(fabsf(dn), eb, kk);
                    go = w_b > 0.0f;
                } else if (is_ggx) {
                    float ag2 = ab * ab;
                    float tan2 = ag2 * u8 / fmaxf(1.0f - u8, F(1e-12));
                    float cth = rsqrtf(1.0f + tan2);
                    float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
                    float hlx = sth * fast_cos(ph2),
                          hly = sth * fast_sin(ph2);
                    float hwx = s1x * hlx + s2x * hly + fx * cth;
                    float hwy = s1y * hlx + s2y * hly + fy * cth;
                    float hwz = s1z * hlx + s2z * hly + fz * cth;
                    float ci_b = fabsf(face);
                    float idoth = -dx * hwx + -dy * hwy + -dz * hwz;
                    ndx = 2.0f * idoth * hwx + dx;
                    ndy = 2.0f * idoth * hwy + dy;
                    ndz = 2.0f * idoth * hwz + dz;
                    float co_g = ndx * fx + ndy * fy + ndz * fz;
                    float f_b = fres_cond(fabsf(idoth), eb, kk);
                    float g_b = g1(ci_b, ag2) * g1(fabsf(co_g), ag2);
                    w_b = rb * f_b * g_b * idoth / fmaxf(ci_b * cth, F(1e-8));
                    go = co_g > 0.0f && idoth > 0.0f && w_b > 0.0f;
                } else {
                    float rr2 = sqrtf(u8);
                    float bx = rr2 * fast_cos(ph2), by = rr2 * fast_sin(ph2);
                    float bz = sqrtf(fmaxf(1.0f - u8, 0.0f));
                    ndx = s1x * bx + s2x * by + fx * bz;
                    ndy = s1y * bx + s2y * by + fy * bz;
                    ndz = s1z * bx + s2z * by + fz * bz;
                    w_b = rb;
                }
                if (go) {
                    wdel = is_m;
                    // bounce Doppler of the continued path
                    dop = dop * (1.0f + ((ndx - dx) * vbx + (ndy - dy) * vby
                                         + (ndz - dz) * vbz) / cvel);
                    dx = ndx;
                    dy = ndy;
                    dz = ndz;
                    thr = thr * w_b;
                    ox = hx + F(1e-4) * fx;
                    oy = hy + F(1e-4) * fy;
                    oz = hz + F(1e-4) * fz;
                    depth = depth + 1;
                    live = true;
                }
            }
        }

        // [k1 stage: trace]  the closest rectangle of the turn's rays; a
        // hit waits in its slot for SHADE, a miss ends the lane
        bool hit = false;
        if (live) {
            float tb = F(3.4e38);
            int pw = -1;
            for (int r = 0; r < n_rect; ++r) {
                // [k1 stage: closest]
                float t_p;
                bool hit_p = rect_hit4(s_rec + COH_REC * r, ox, oy, oz, dx,
                                       dy, dz, &t_p);
                if (hit_p && t_p > F(1e-4) && t_p < tb) {
                    tb = t_p;
                    pw = r;
                }
            }
            // [k1 stage: trace]
            hit = tb < F(3.4e37);
            if (hit) {
                const unsigned long long ln = (unsigned long long)lane;
                sl4[0] = make_float4(ox, oy, oz, thr);
                sl4[1] = make_float4(dx, dy, dz, plen);
                sl4[2] = make_float4(t_rx0, tb, __int_as_float(pw),
                                     __int_as_float(depth
                                                    | (wdel ? 1 << 16 : 0)));
                sl4[3] = make_float4(__uint_as_float((unsigned)ln),
                                     __uint_as_float((unsigned)(ln >> 32)),
                                     dop, lsum);
                if (depth > 0) sl4[4] = make_float4(v0x, v0y, v0z, r0m);
            }
        }
        // the lane's sum of amplitudes, where its path ended
        if (slot >= 0 && !hit && lv_p != nullptr) lv_p[lane] = lsum;
        // [k1 stage: sched]  the waiting set: the turn's slots leave it,
        // those whose ray hit join it
        const bool lo_s = slot >= 0 && slot < 32, hi_s = slot >= 32;
        const unsigned bit = 1u << (slot & 31);
        sh_lo = (sh_lo & ~__reduce_or_sync(FULL_MASK, lo_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, lo_s && hit ? bit : 0u);
        sh_hi = (sh_hi & ~__reduce_or_sync(FULL_MASK, hi_s ? bit : 0u))
                | __reduce_or_sync(FULL_MASK, hi_s && hit ? bit : 0u);
        if (shade) {
            // [k1 stage: splat]
            mimo_warp_taps(grid, cfg, w_st, taps, j);
        }
    }
    // [k1 stage: end]
    __syncthreads();

    // the block's grid (mode 2 added to `partial` already); its events
    partial += pulse * gridDim.x * n_vals;
    part_ev += pulse * gridDim.x;
    if (cfg.mode == 1)
        for (long long v = tid; v < n_vals; v += T)
            partial[(long long)blockIdx.x * n_vals + v] = s_dgrid[v];
    __syncthreads();
    unsigned long long ev = events;
    for (int off = 16; off > 0; off >>= 1)
        ev += __shfl_down_sync(FULL_MASK, ev, off);
    unsigned long long* s_ev = reinterpret_cast<unsigned long long*>(asm_);
    if (j == 0) s_ev[tid >> 5] = ev;
    __syncthreads();
    if (tid == 0) {
        unsigned long long tot = 0;
        for (int w = 0; w < T / 32; ++w) tot += s_ev[w];
        part_ev[blockIdx.x] = tot;
    }
}

// The MIMO configuration's media and endpoint twins: the coherent one of a
// phased array on analytic scenes, in 128-thread blocks of its own launch
// bounds.
template <bool MED, bool EP = false>
__global__ void __launch_bounds__(DOP_THREADS, MIMO_MIN_BLOCKS)
receive_mimo_kernel(const float* __restrict__ params,
                    const float* __restrict__ prim,
                    const float* __restrict__ txp,
                    const float* __restrict__ msh,
                    const float* __restrict__ uniforms, bvh::Tables mesh,
                    float* __restrict__ lane_val,
                    double* __restrict__ partial,
                    unsigned long long* __restrict__ part_ev, Cfg cfg,
                    const float* __restrict__ rxph,
                    const float* __restrict__ eoff) {
    trace_block<false, true, true, true, MED, EP>(params, prim, txp, msh,
                                                  uniforms, mesh, lane_val,
                                                  partial, part_ev, cfg, rxph,
                                                  eoff);
}

// The kernel of a configuration.
template <bool MESH, bool DOP, bool COH, bool MIMO, bool MED, bool EP,
          bool LOB = false, bool TEX = false, bool PRIM = false>
constexpr auto kernel_of() {
    if constexpr (MIMO && !MED && !EP)
        return receive_mimo_array_kernel;
    else if constexpr (MIMO)
        return receive_mimo_kernel<MED, EP>;
    else if constexpr (DOP && !MESH && COH && !MED && !EP && !LOB)
        return receive_coherent_kernel<TEX, PRIM>;
    else if constexpr (DOP && !MESH && !MED && !EP && LOB)
        return receive_lobe_kernel<COH>;
    else if constexpr (DOP && !MESH && !COH && !MED && !EP)
        return receive_doppler_power_kernel<TEX, PRIM>;
    else if constexpr (EP && !MESH && !MED && !LOB && !DOP)
        return receive_endpoint_kernel;
    else if constexpr (EP && !MESH && !MED && !LOB && DOP && COH)
        return receive_endpoint_coherent_kernel;
    else if constexpr (DOP && MESH && !MED && !EP)
        return receive_mesh_doppler_kernel<COH, LOB>;
    else if constexpr (DOP)
        return receive_doppler_kernel<MESH, COH, MED, EP, LOB>;
    else if constexpr (!MESH && !MED && !EP)
        return receive_flagship_kernel<TEX, PRIM>;
    else if constexpr (!MED && !EP)
        return receive_mesh_kernel;
    else
        return receive_trace_kernel<MESH, MED, EP>;
}

// Fixed-order sum of each pulse's per-block partials (n_rows of n_cells
// doubles a pulse; a coherent grid's I and Q count as two cells), one
// thread per cell of a pulse; the events of each pulse's n_blocks trace
// blocks.  Pulse p's rows follow pulse p - 1's.
constexpr int REDUCE_THREADS = 256;

__global__ void receive_reduce_kernel(const double* __restrict__ partial,
                                      const unsigned long long* __restrict__
                                          part_ev,
                                      int n_rows, int n_blocks,
                                      long long n_cells, int n_pulses,
                                      float* __restrict__ out,
                                      long long* __restrict__ out_events) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_cells * n_pulses) return;
    long long p = i / n_cells, c = i - p * n_cells;
    const double* rows = partial + p * n_rows * n_cells;
    double s = 0.0;
    for (int k = 0; k < n_rows; ++k) s += rows[(long long)k * n_cells + c];
    out[i] = (float)s;
    if (c == 0) {
        unsigned long long e = 0;
        for (int k = 0; k < n_blocks; ++k) e += part_ev[p * n_blocks + k];
        out_events[p] = (long long)e;
    }
}

// The footprint index check's kernel (rk_epx_check): the index of one
// phased transmitter built as a block of the endpoint kernels builds it.
__global__ void epx_check_kernel(const float* __restrict__ row, int n_k,
                                 const float* __restrict__ m, float wx,
                                 float wy, const float* __restrict__ pts,
                                 int n, float* __restrict__ out,
                                 int* __restrict__ visits) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x, T = blockDim.x;
    float* s_tx = smem;
    float* s_epx = smem + TXP_COLS;
    Cfg cfg{};
    cfg.n_tx = 1;
    cfg.php = row;
    cfg.php_cols = 2 + 6 * n_k;
    cfg.n_pairs = n_k;
    for (int i = tid; i < TXP_COLS; i += T)
        s_tx[i] = i < 12 ? m[i] : i == 12 ? wx : i == 13 ? wy
                  : i == 27 ? TX_PHASED : 0.0f;
    __syncthreads();
    epx_build(cfg, nullptr, s_tx, s_epx, tid, T);
    const Epx ix(cfg, s_epx);
    const float iwx = 1.0f / fmaxf(wx, F(1e-20));
    const float iwy = 1.0f / fmaxf(wy, F(1e-20));
    for (int i = tid; i < n; i += T) {
        const float* q = pts + 7 * i;
        int v = 0;
        out[2 * i] = pair_sum_epx<true>(ix, 0, q[0], q[1], q[2], q[3], q[4],
                                        q[5], q[6], &v);
        out[2 * i + 1] = pair_sum(row, n_k, m[0] * iwx, m[4] * iwx,
                                  m[8] * iwx, m[1] * iwy, m[5] * iwy,
                                  m[9] * iwy, m[3], m[7], m[11], q[0], q[1],
                                  q[2], q[3], q[4], q[5], q[6]);
        visits[i] = v;
    }
}


int threads_for(int n_time) {
    // per-thread histogram rows: keep them within ~96 KB per block
    int t = (96 * 1024) / (4 * n_time);
    t = t > 256 ? 256 : t;
    return (t / 32) * 32;
}

template <bool MESH, bool DOP, bool COH, bool MIMO, bool MED, bool EP,
          bool LOB = false, bool TEX = false, bool PRIM = false>
int geometry(int n_time, int n_freq, long long n_lanes, int n_prims,
             int n_params, int n_msh, int mode, int n_pulses, int n_elem,
             int n_tx, int n_pairs, int n_rx_pairs, int* blocks,
             int* threads, int* smem_bytes) {
    constexpr int TX_FLOATS = EP ? MAX_TX * TXP_COLS : TXP_COLS;
    int T, smem;
    if (MIMO && !MED && !EP) {
        // the MIMO array kernel: its tables and the element half-widths
        // and offsets, each warp's paths, then the block's grid of doubles
        // (mode 1)
        T = COH_THREADS;
        smem = mak_table_bytes(n_prims, n_params, n_elem)
               + (T / 32) * mak_warp_bytes()
               + (mode == 1 ? 8 * n_time * 2 * n_elem : 0);
    } else if (MIMO) {
        // tables, element half-widths and offsets, padded to 8 bytes,
        // then the grid of doubles
        T = DOP_THREADS;
        int floats = n_params + n_prims * PRIM_COLS + TX_FLOATS
                     + n_msh * MSH_COLS + 2 + 3 * n_elem;
        floats = (floats + 1) & ~1;
        long long vals = mode == 1 ? (long long)n_time * 2 * n_elem : 0;
        smem = (int)(4 * floats + 8 * vals);
    } else if (EP && !MESH && !MED && !LOB && !DOP) {
        // the power endpoint kernel: its tables and index, then each
        // warp's paths and row
        T = FLAG_THREADS;
        smem = ep_table_bytes(n_prims, n_params, n_tx, n_pairs, n_rx_pairs,
                              FLAG_REC, FLAG_RXC)
               + (T / 32) * flag_warp_bytes(n_time);
    } else if (EP && !MESH && !MED && !LOB && DOP && COH) {
        // the coherent endpoint kernel: its tables and index, each warp's
        // paths (and row), then the block's float grid where there are no
        // warp rows (mode 1)
        T = COH_THREADS;
        const bool rows = coh_rows(n_time, n_freq, mode);
        smem = ep_table_bytes(n_prims, n_params, n_tx, n_pairs, n_rx_pairs,
                              COH_REC, COH_RXC)
               + (T / 32) * coh_warp_bytes(n_time, rows)
               + (mode == 1 && !rows ? 8 * n_time * n_freq : 0);
    } else if (DOP && !MESH && COH && !MED && !EP && !LOB) {
        // the coherent kernel: its tables, each warp's paths (and row), then
        // the block's float grid where there are no warp rows (mode 1);
        // its texture twin's records after them, and its prims twin's
        // kinds after those
        T = COH_THREADS;
        const bool rows = coh_rows(n_time, n_freq, mode);
        const int grid_bytes = mode == 1 && !rows ? 8 * n_time * n_freq : 0;
        smem = coh_table_bytes(n_prims, n_params)
               + (T / 32) * coh_warp_bytes(n_time, rows)
               + (PRIM ? 8 * n_prims : 0)
               + (TEX || PRIM ? ((grid_bytes + 15) & ~15)
                                    + (TEX ? 32 * n_prims : 0)
                              : grid_bytes);
    } else if (DOP && !MESH && !COH && !MED && !EP && !LOB) {
        // the Doppler power kernel: the coherent kernel's tables, each
        // warp's paths (and row of n_time doubles), then the block's float
        // grid where there are no warp rows (mode 1); its texture twin's
        // records after them, and its prims twin's kinds after those
        T = COH_THREADS;
        const bool rows = lob_rows(n_time, n_freq, mode, 1);
        const int grid_bytes = mode == 1 && !rows ? 4 * n_time * n_freq : 0;
        smem = coh_table_bytes(n_prims, n_params)
               + (T / 32) * lob_warp_bytes(n_time, rows, 1)
               + (PRIM ? 8 * n_prims : 0)
               + (TEX || PRIM ? ((grid_bytes + 15) & ~15)
                                    + (TEX ? 32 * n_prims : 0)
                              : grid_bytes);
    } else if (DOP && !MESH && !MED && !EP && LOB) {
        // the analytic lobe twins' kernel: the coherent kernel's layout,
        // rectangles of LOB_REC float4s, a bin's power or I and Q
        T = COH_THREADS;
        constexpr int per_bin = COH ? 2 : 1;
        const bool rows = lob_rows(n_time, n_freq, mode, per_bin);
        smem = lob_table_bytes(n_prims, n_params)
               + (T / 32) * lob_warp_bytes(n_time, rows, per_bin)
               + (mode == 1 && !rows ? 4 * per_bin * n_time * n_freq : 0);
    } else if (DOP && MESH && !MED && !EP) {
        // the mesh Doppler kernel: its tables and mesh-shape rows, each
        // warp's paths (and row), then the block's float grid where there
        // are no warp rows (mode 1)
        T = COH_THREADS;
        constexpr int per_bin = COH ? 2 : 1;
        const bool rows = lob_rows(n_time, n_freq, mode, per_bin);
        smem = mdk_table_bytes(n_prims, n_params, n_msh,
                               LOB ? LOB_REC : COH_REC)
               + (T / 32) * mdk_warp_bytes(n_time, rows, per_bin)
               + (mode == 1 && !rows ? 4 * per_bin * n_time * n_freq : 0);
    } else if (DOP) {
        T = DOP_THREADS;
        long long cells = mode == 1 ? (long long)n_time * n_freq
                                          * (COH ? 2 : 1)
                                    : 0;
        smem = (int)(4 * (n_params + n_prims * PRIM_COLS + TX_FLOATS
                          + n_msh * MSH_COLS + cells));
    } else if (!MESH && !MED && !EP) {
        // the flagship kernel: its tables, then each warp's paths and row;
        // its texture twin's records after them
        T = FLAG_THREADS;
        smem = flag_table_bytes(n_prims, n_params)
               + (T / 32) * flag_warp_bytes(n_time)
               + (TEX ? 32 * n_prims : 0) + (PRIM ? 8 * n_prims : 0);
    } else if (!MED && !EP) {
        // the mesh kernel: the flagship's tables, then each warp's paths
        // and row
        T = FLAG_THREADS;
        smem = flag_table_bytes(n_prims, n_params)
               + (T / 32) * msk_warp_bytes(n_time);
    } else {
        T = threads_for(n_time);
        if (T < 32) return (int)cudaErrorInvalidValue;
        smem = 4 * (n_params + n_prims * PRIM_COLS + TX_FLOATS + n_time * T);
    }
    cudaError_t err = cudaFuncSetAttribute(
        kernel_of<MESH, DOP, COH, MIMO, MED, EP, LOB, TEX, PRIM>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<MESH, DOP, COH, MIMO, MED, EP, LOB, TEX, PRIM>(),
        T,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // blocks a pulse, fewer when a pulse's lanes run out: the flagship and
    // mesh configurations give each pulse the resident grid of one call
    // (the pulses run in waves, and each sums its lanes in the order one
    // call does); the Doppler family shares the resident grid among the
    // pulses (one wave; its per-block grids would otherwise multiply)
    long long need = (n_lanes + T - 1) / T;
    long long nb = (long long)per_sm * sms;
    if (DOP) nb = nb / n_pulses > 1 ? nb / n_pulses : 1;
    *blocks = (int)(nb < need ? nb : need);
    *threads = T;
    *smem_bytes = smem;
    return (int)cudaSuccess;
}

// Launch geometry for one call: threads per block, dynamic shared bytes
// and the persistent grid's blocks a pulse (the resident blocks on every
// SM, shared by the n_pulses pulses in the Doppler family, fewer if a
// pulse's lanes run out), for the
// flagship (mesh == 0, mode == 0), mesh (mesh == 1, mode == 0), Doppler
// (mode 1 block-shared grid, 2 global grid; analytic or mesh) or coherent
// configuration (coh == 1, mode 1 or 2), or the MIMO configuration of
// n_elem > 0 elements (analytic, coherent, mode 1 or 2), of the
// configuration's media twin with MED, its endpoint twin with EP.  Returns
// a cudaError_t.
template <bool MED, bool EP>
int geometry_of(int n_time, int n_freq, long long n_lanes, int n_prims,
                int n_params, int n_msh, int mesh, int mode, int coh,
                int n_pulses, int n_elem, int n_tx, int n_pairs,
                int n_rx_pairs, int* blocks, int* threads,
                int* smem_bytes) {
    auto g = [&](auto fn) {
        return fn(n_time, n_freq, n_lanes, n_prims, n_params, n_msh, mode,
                  n_pulses, n_elem, n_tx, n_pairs, n_rx_pairs, blocks,
                  threads, smem_bytes);
    };
    if (n_elem > 0) {
        if (mesh || !coh || mode == 0 || n_freq != 1)
            return (int)cudaErrorInvalidValue;
        return g(geometry<false, true, true, true, MED, EP>);
    }
    if (mode == 0)
        return mesh ? g(geometry<true, false, false, false, MED, EP>)
                    : g(geometry<false, false, false, false, MED, EP>);
    if (coh)
        return mesh ? g(geometry<true, true, true, false, MED, EP>)
                    : g(geometry<false, true, true, false, MED, EP>);
    return mesh ? g(geometry<true, true, false, false, MED, EP>)
                : g(geometry<false, true, false, false, MED, EP>);
}

// The launch record: the trace kernel rk_launch launched last (host
// code; read by rk_last_kernel).
const void* last_kernel = nullptr;

// Launch geometry of a Doppler configuration's lobe twin (mode 1 or 2; in
// vacuum, no MIMO).
int geometry_lobes(int n_time, int n_freq, long long n_lanes, int n_prims,
                   int n_params, int n_msh, int mesh, int mode, int coh,
                   int n_pulses, int n_elem, int* blocks, int* threads,
                   int* smem_bytes) {
    if (mode == 0 || n_elem > 0) return (int)cudaErrorInvalidValue;
    auto g = [&](auto fn) {
        return fn(n_time, n_freq, n_lanes, n_prims, n_params, n_msh, mode,
                  n_pulses, n_elem, 1, 0, 0, blocks, threads, smem_bytes);
    };
    if (coh)
        return mesh
                   ? g(geometry<true, true, true, false, false, false, true>)
                   : g(geometry<false, true, true, false, false, false, true>);
    return mesh ? g(geometry<true, true, false, false, false, false, true>)
                : g(geometry<false, true, false, false, false, false, true>);
}

// Whether a call may run a texture twin: the flagship configuration
// (mode 0), the coherent one or the Doppler one in power, on an analytic
// scene, one pulse, in vacuum, with one Wigner transmitter, no lobe twin
// and no MIMO.  A prims twin asks with `n_pulses` 1: a CPI's pulses run
// it too (their tables carry no texture: the caller's rule).
bool tex_config(int mesh, int medium, int ep, int lob, int n_elem,
                int n_pulses) {
    return !mesh && !medium && !ep && !lob && n_elem == 0 && n_pulses == 1;
}

// The launch geometry of a texture or prims twin (with `coh`, the coherent
// kernel's; mode 0 the flagship's; else the Doppler power kernel's).
template <bool TEX, bool PRIM>
int geometry_twin(int n_time, int n_freq, long long n_lanes, int n_prims,
                  int n_params, int n_msh, int mode, int coh, int n_pulses,
                  int n_elem, int* blocks, int* threads, int* smem_bytes) {
    auto g = [&](auto fn) {
        return fn(n_time, n_freq, n_lanes, n_prims, n_params, n_msh, mode,
                  n_pulses, n_elem, 1, 0, 0, blocks, threads, smem_bytes);
    };
    if (coh)
        return g(geometry<false, true, true, false, false, false, false, TEX,
                          PRIM>);
    if (mode == 0)
        return g(geometry<false, false, false, false, false, false, false,
                          TEX, PRIM>);
    return g(geometry<false, true, false, false, false, false, false, TEX,
                      PRIM>);
}

}  // namespace

extern "C" {

// Launch geometry (geometry_of) of a configuration, of its media twin
// when `medium` != 0, of its endpoint twin when `ep` != 0 (n_tx
// transmitters, n_pairs pairs a phased transmitter's row, n_rx_pairs an
// analog phased receiver's: the endpoint kernels' index), of a Doppler
// configuration's lobe twin when `lob` != 0 (one of the three at most), of
// the flagship, the analytic coherent or the analytic Doppler power
// configuration's texture twin when `tex` != 0 (one pulse, vacuum, one
// Wigner transmitter, no lobe twin), of their prims twin when `prims` != 0
// (spheres, disks and cylinders; with `tex` too, the twin that also
// carries the texture codes; a CPI's pulses too).
int rk_geometry(int n_time, int n_freq, long long n_lanes, int n_prims,
                int n_params, int n_msh, int mesh, int mode, int coh,
                int n_pulses, int n_elem, int medium, int ep, int lob,
                int n_tx, int n_pairs, int n_rx_pairs, int tex, int prims,
                int* blocks, int* threads, int* smem_bytes) {
    if (n_pulses < 1 || (medium && ep) || (lob && (medium || ep))
        || n_tx < 1 || n_tx > MAX_TX || n_pairs < 0 || n_rx_pairs < 0)
        return (int)cudaErrorInvalidValue;
    if (prims) {
        if (!tex_config(mesh, medium, ep, lob, n_elem, 1))
            return (int)cudaErrorInvalidValue;
        // with `tex`, the twin that carries the texture codes
        return (tex ? geometry_twin<true, true> : geometry_twin<false, true>)(
            n_time, n_freq, n_lanes, n_prims, n_params, n_msh, mode, coh,
            n_pulses, n_elem, blocks, threads, smem_bytes);
    }
    if (tex) {
        if (!tex_config(mesh, medium, ep, lob, n_elem, n_pulses))
            return (int)cudaErrorInvalidValue;
        return geometry_twin<true, false>(n_time, n_freq, n_lanes, n_prims,
                                          n_params, n_msh, mode, coh,
                                          n_pulses, n_elem, blocks, threads,
                                          smem_bytes);
    }
    if (lob)
        return geometry_lobes(n_time, n_freq, n_lanes, n_prims, n_params,
                              n_msh, mesh, mode, coh, n_pulses, n_elem,
                              blocks, threads, smem_bytes);
    return (medium ? geometry_of<true, false>
                   : ep ? geometry_of<false, true>
                        : geometry_of<false, false>)(
        n_time, n_freq, n_lanes, n_prims, n_params, n_msh, mesh, mode, coh,
        n_pulses, n_elem, n_tx, n_pairs, n_rx_pairs, blocks, threads,
        smem_bytes);
}

// Trace + reduce on `stream`, for n_pulses pulses (a CPI; 1 for one
// receive call) of n_lanes lanes each.  The tables hold one row block a
// pulse: params n_params floats, prim n_prims rows, txp one row, msh n_msh
// rows, the BVH bbox / links / leaves the given strides, the injected
// uniforms (null in PRNG mode) u_stride floats; pulse p draws Philox keyed
// by seed + seed_step * p.  `bbox` is null for an analytic scene, else the
// BVH tables of a mesh (leaf rows of `stride` floats), with `patch_p`
// direction strata per side (0 = none); `msh` the mesh's shape rows
// (Doppler and coherent configurations).  Unless null, each lane's
// contribution sum goes to `lane_val` (n_pulses x n_lanes floats; mesh,
// Doppler and coherent configurations).  `rule` is the receive-frequency
// rule, `has_lo` says whether params carry an LO, `mirror` whether the
// tables hold a smooth conductor (the Doppler family's mirror chains).
// n_elem > 0 launches the MIMO configuration (coh 1, no mesh, n_freq 1),
// which reads the receiver row's element half-widths rxph[0:2] and the
// (n_elem, 3) element offsets `eoff`.  `medium` != 0 launches the
// configuration's media twin (1 homogeneous, 2 layered, its scalars in
// params; 3 a grid of g_d x g_h x g_w float cells at `grid`, which every
// pulse reads).  `ep` != 0 launches its endpoint twin (not with a medium):
// txp then holds n_tx rows a pulse (1 <= n_tx <= MAX_TX), `php` the
// n_tx x php_cols pair rows of its phased transmitters (every pulse's),
// and `rx_phased` an analog phased receiver whose pair row of n_rx_pairs
// pairs is `rxph`.  `lobes` != 0 (LOBE_* flags) launches a Doppler
// configuration's lobe twin (in vacuum, one Wigner transmitter, no MIMO):
// the draw stride of a depth is then 6, plus one for a lobe pick
// (plastics, GGX glass), plus one for a composite's pick.
// `partial` holds n_pulses x blocks x n_vals doubles (mode 0 / 1) or
// n_pulses x n_vals (mode 2, zeroed here), n_vals = n_cells, 2 n_cells
// coherent or 2 n_elem n_cells MIMO; `out` n_pulses x n_vals floats,
// `out_events` n_pulses counts.
int rk_launch(const float* params, const float* prim, const float* txp,
              const float* msh, const float* uniforms, double* partial,
              unsigned long long* part_ev, float* out, long long* out_events,
              const float* bbox, const int* links, const float* leaves,
              int stride, int patch_p, float* lane_val, long long n_lanes,
              unsigned long long seed, int n_time, int n_freq, int max_depth,
              int gate, int omni, int n_prims, int n_params, int n_msh,
              int mode, int coh, int rule, int has_lo, int mirror,
              float t_start, float t_window, float f_rx, float f_lo, float f_span,
              float f_den, int n_pulses, unsigned long long seed_step,
              long long u_stride, long long bbox_stride,
              long long links_stride, long long leaves_stride, int blocks,
              int threads, int smem_bytes, const float* rxph,
              const float* eoff, int n_elem, int medium, const float* grid,
              int g_d, int g_h, int g_w, int n_tx, int ep, const float* php,
              int php_cols, int rx_phased, int n_rx_pairs, int lobes,
              const float* tex, int tex_w, int prims, void* stream) {
    Cfg cfg;
    cfg.n_lanes = n_lanes;
    cfg.seed = seed;
    cfg.n_time = n_time;
    cfg.max_depth = max_depth;
    cfg.gate = gate;
    cfg.omni = omni;
    cfg.n_prims = n_prims;
    cfg.n_params = n_params;
    cfg.use_prng = uniforms == nullptr;
    cfg.patch_p = patch_p;
    cfg.t_start = t_start;
    cfg.t_window = t_window;
    cfg.f_rx = f_rx;
    cfg.n_freq = mode == 0 ? 1 : n_freq;
    cfg.n_msh = n_msh;
    cfg.mode = mode;
    cfg.f_lo = f_lo;
    cfg.f_span = f_span;
    cfg.f_den = f_den;
    cfg.rule = rule;
    cfg.has_lo = has_lo;
    cfg.mirror = mirror;
    cfg.seed_step = seed_step;
    cfg.u_stride = u_stride;
    cfg.bbox_stride = bbox_stride;
    cfg.links_stride = links_stride;
    cfg.leaves_stride = leaves_stride;
    cfg.n_elem = n_elem;
    cfg.medium = medium;
    cfg.g_d = g_d;
    cfg.g_h = g_h;
    cfg.g_w = g_w;
    cfg.grid = grid;
    cfg.n_tx = n_tx;
    cfg.rx_phased = rx_phased;
    cfg.php = php;
    cfg.php_cols = php_cols;
    cfg.n_pairs = php == nullptr ? 0 : (php_cols - 2) / 6;
    cfg.rxph = rxph;
    cfg.n_rx_pairs = n_rx_pairs;
    cfg.lobes = lobes;
    if (lobes && (mode == 0 || ep || medium || n_elem > 0 || lobes > 127))
        return (int)cudaErrorInvalidValue;
    if (n_tx < 1 || n_tx > MAX_TX || (!ep && (n_tx != 1 || rx_phased))
        || (ep && medium) || (php != nullptr && php_cols < 8)
        || (rx_phased && (rxph == nullptr || n_rx_pairs < 1 || n_elem > 0)))
        return (int)cudaErrorInvalidValue;
    if (medium < 0 || medium > 3 || (medium == 3) != (grid != nullptr)
        || (medium == 3 && (g_d < 1 || g_h < 1 || g_w < 1)))
        return (int)cudaErrorInvalidValue;
    if (mode == 0 && (coh || rule != 0 || mirror))
        return (int)cudaErrorInvalidValue;
    if (n_pulses < 1 || n_pulses > 65535) return (int)cudaErrorInvalidValue;
    if (tex != nullptr) {
        // the texture and prims twins read the texture buffer through
        // cfg.grid
        if (!tex_config(bbox != nullptr, medium, ep, lobes, n_elem,
                        prims ? 1 : n_pulses)
            || tex_w < 1)
            return (int)cudaErrorInvalidValue;
        cfg.grid = tex;
        cfg.g_w = tex_w;
    } else if (prims && !tex_config(bbox != nullptr, medium, ep, lobes,
                                    n_elem, 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_elem > 0 && (mode == 0 || !coh || bbox != nullptr || n_freq != 1
                       || n_pulses != 1 || rxph == nullptr
                       || eoff == nullptr))
        return (int)cudaErrorInvalidValue;
    long long n_vals = (long long)n_time * cfg.n_freq
                       * (n_elem > 0 ? 2 * n_elem : coh ? 2 : 1);
    bvh::Tables mesh{bbox, links, leaves, stride};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == 2) {
        cudaError_t e = cudaMemsetAsync(partial, 0, 8 * n_vals * n_pulses, s);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 blocks_grid(blocks, n_pulses);
    auto launch = [&](auto kernel, float* lv) {
        last_kernel = reinterpret_cast<const void*>(kernel);
        kernel<<<blocks_grid, threads, smem_bytes, s>>>(
            params, prim, txp, msh, uniforms, mesh, lv, partial, part_ev,
            cfg);
    };
    // the MIMO kernels take the receiver row and the element offsets
    auto launch_mimo = [&](auto kernel) {
        last_kernel = reinterpret_cast<const void*>(kernel);
        kernel<<<blocks_grid, threads, smem_bytes, s>>>(
            params, prim, txp, msh, uniforms, mesh, lane_val, partial,
            part_ev, cfg, rxph, eoff);
    };
    const bool m = bbox != nullptr;
    // the configuration, or (MED) its media twin, or (EP) its endpoint twin
    auto pick = [&](auto med, auto ep_) {
        constexpr bool MED = decltype(med)::value;
        constexpr bool EP = decltype(ep_)::value;
        if (n_elem > 0) {
            if constexpr (!MED && !EP)
                launch_mimo(receive_mimo_array_kernel);
            else
                launch_mimo(receive_mimo_kernel<MED, EP>);
        } else if (mode == 0) {
            if (m) {
                if constexpr (!MED && !EP)
                    launch(receive_mesh_kernel, lane_val);
                else
                    launch(receive_trace_kernel<true, MED, EP>, lane_val);
            } else if constexpr (!MED && !EP)
                prims ? (tex != nullptr
                             ? launch(receive_flagship_kernel<true, true>,
                                      nullptr)
                             : launch(receive_flagship_kernel<false, true>,
                                      nullptr))
                : tex != nullptr
                    ? launch(receive_flagship_kernel<true>, nullptr)
                    : launch(receive_flagship_kernel<false>, nullptr);
            else if constexpr (EP)
                launch(receive_endpoint_kernel, nullptr);
            else
                launch(receive_trace_kernel<false, MED, EP>, nullptr);
        }
        else if (coh) {
            if (m) {
                if constexpr (!MED && !EP)
                    launch(receive_mesh_doppler_kernel<true, false>,
                           lane_val);
                else
                    launch(receive_doppler_kernel<true, true, MED, EP>,
                           lane_val);
            } else if constexpr (!MED && !EP)
                prims ? (tex != nullptr
                             ? launch(receive_coherent_kernel<true, true>,
                                      lane_val)
                             : launch(receive_coherent_kernel<false, true>,
                                      lane_val))
                : tex != nullptr
                    ? launch(receive_coherent_kernel<true>, lane_val)
                    : launch(receive_coherent_kernel<false>, lane_val);
            else if constexpr (EP)
                launch(receive_endpoint_coherent_kernel, lane_val);
            else
                launch(receive_doppler_kernel<false, true, MED, EP>,
                       lane_val);
        }
        else if (m) {
            if constexpr (!MED && !EP)
                launch(receive_mesh_doppler_kernel<false, false>, lane_val);
            else
                launch(receive_doppler_kernel<true, false, MED, EP>,
                       lane_val);
        }
        else if constexpr (!MED && !EP)
            prims ? (tex != nullptr
                         ? launch(receive_doppler_power_kernel<true, true>,
                                  lane_val)
                         : launch(receive_doppler_power_kernel<false, true>,
                                  lane_val))
            : tex != nullptr
                ? launch(receive_doppler_power_kernel<true>, lane_val)
                : launch(receive_doppler_power_kernel<false>, lane_val);
        else
            launch(receive_doppler_kernel<false, false, MED, EP>, lane_val);
    };
    if (lobes) {
        // the lobe twins of the Doppler and coherent configurations: the
        // mesh ones the mesh Doppler kernel's, the analytic ones' kernel of
        // their own
        if (coh)
            m ? launch(receive_mesh_doppler_kernel<true, true>, lane_val)
              : launch(receive_lobe_kernel<true>, lane_val);
        else
            m ? launch(receive_mesh_doppler_kernel<false, true>, lane_val)
              : launch(receive_lobe_kernel<false>, lane_val);
    } else if (medium)
        pick(std::true_type{}, std::false_type{});
    else if (ep)
        pick(std::false_type{}, std::true_type{});
    else
        pick(std::false_type{}, std::false_type{});
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int n_rows = mode == 2 ? 1 : blocks;
    int rb = (int)((n_vals * n_pulses + REDUCE_THREADS - 1) / REDUCE_THREADS);
    receive_reduce_kernel<<<rb, REDUCE_THREADS, 0, s>>>(
        partial, part_ev, n_rows, blocks, n_vals, n_pulses, out, out_events);
    return (int)cudaGetLastError();
}

// The launch record: the trace kernel the last rk_launch launched, and
// (which 0 / 1) the analytic lobe twins' kernel of the power / I / Q
// configuration, to compare with it.
const void* rk_last_kernel() { return last_kernel; }

const void* rk_lobe_kernel(int coh) {
    return coh ? reinterpret_cast<const void*>(receive_lobe_kernel<true>)
               : reinterpret_cast<const void*>(receive_lobe_kernel<false>);
}

// The footprint index check: a phased transmitter of frame `m` (12 floats,
// a to_world's rows: its axes in columns 0 and 1 over the half-widths
// wx, wy, its centre in column 3) and pair row `row` (2 + 6 n_k floats),
// at n points (px, py, pz, dex, dey, dez, lam: 7 floats each): into
// out[2 i] the indexed sum, out[2 i + 1] pair_sum's full loop over `row`,
// visits[i] the pairs the index tested.  One block of 32 threads; the
// pointers are the device's (host memory in the CPU emulation).
int rk_epx_check(const float* row, int n_k, const float* m, float wx,
                 float wy, const float* pts, int n, float* out, int* visits,
                 void* stream) {
    if (n_k < 1 || n_k > 128 || n < 0) return (int)cudaErrorInvalidValue;
    auto kernel = epx_check_kernel;
    const int smem = 4 * (TXP_COLS + epx_floats(1, n_k, 0));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    kernel<<<1, 32, smem, st>>>(row, n_k, m, wx, wy, pts, n, out, visits);
    return (int)cudaGetLastError();
}

// The analytic Doppler power configuration's kernel (twin 0), or its
// media (1) or endpoint (2) twin's, or its texture (3), prims (4) or
// textured prims (5) twin, to compare with the launch record.
const void* rk_doppler_power_kernel(int twin) {
    switch (twin) {
    case 1:
        return reinterpret_cast<const void*>(
            receive_doppler_kernel<false, false, true, false>);
    case 2:
        return reinterpret_cast<const void*>(
            receive_doppler_kernel<false, false, false, true>);
    case 3:
        return reinterpret_cast<const void*>(
            receive_doppler_power_kernel<true>);
    case 4:
        return reinterpret_cast<const void*>(
            receive_doppler_power_kernel<false, true>);
    case 5:
        return reinterpret_cast<const void*>(
            receive_doppler_power_kernel<true, true>);
    default:
        return reinterpret_cast<const void*>(
            receive_doppler_power_kernel<false>);
    }
}

// The mesh Doppler kernel of a vacuum mesh configuration of the Doppler
// family, to compare with the launch record: the Doppler mesh in power
// (coh 0, lob 0), the coherent mesh (1, 0), the power mesh lobe twin (0,
// 1) or the mesh lobe twin in I / Q (1, 1).
const void* rk_mesh_doppler_kernel(int coh, int lob) {
    return coh ? (lob ? reinterpret_cast<const void*>(
                            receive_mesh_doppler_kernel<true, true>)
                      : reinterpret_cast<const void*>(
                            receive_mesh_doppler_kernel<true, false>))
               : (lob ? reinterpret_cast<const void*>(
                            receive_mesh_doppler_kernel<false, true>)
                      : reinterpret_cast<const void*>(
                            receive_mesh_doppler_kernel<false, false>));
}

// The MIMO array kernel (the vacuum MIMO configuration) and the mesh
// kernel (the vacuum mesh configuration in power), to compare with the
// launch record.
const void* rk_mimo_kernel() {
    return reinterpret_cast<const void*>(receive_mimo_array_kernel);
}

const void* rk_mesh_kernel() {
    return reinterpret_cast<const void*>(receive_mesh_kernel);
}

// The texture twins (which 0 / 1): the flagship's and the coherent
// kernel's.
const void* rk_tex_kernel(int coh) {
    return coh ? reinterpret_cast<const void*>(receive_coherent_kernel<true>)
               : reinterpret_cast<const void*>(receive_flagship_kernel<true>);
}

// The prims twins (which 0 / 1): the flagship's and the coherent
// kernel's, with the texture codes (tex 1: a textured scene's) or
// without.
const void* rk_prim_kernel(int coh, int tex) {
    if (tex)
        return coh ? reinterpret_cast<const void*>(
                         receive_coherent_kernel<true, true>)
                   : reinterpret_cast<const void*>(
                         receive_flagship_kernel<true, true>);
    return coh ? reinterpret_cast<const void*>(
                     receive_coherent_kernel<false, true>)
               : reinterpret_cast<const void*>(
                     receive_flagship_kernel<false, true>);
}

// The endpoint kernel of the power (coh 0) or I / Q configuration, to
// compare with the launch record.
const void* rk_endpoint_kernel(int coh) {
    return coh ? reinterpret_cast<const void*>(
                     receive_endpoint_coherent_kernel)
               : reinterpret_cast<const void*>(receive_endpoint_kernel);
}

const char* rk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
