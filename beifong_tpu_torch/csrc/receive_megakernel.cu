// Radar receive megakernel for Hopper (sm_90a), flagship configuration.
//
// Replaces the TPU kernel beifong_tpu/integrators/pallas_receive.py::
// _make_kernel (launched by _run's pl.pallas_call) in its analytic /
// diffuse / Wigner-aperture / raw / power / n_freq == 1 configuration:
// per lane, the receive ray from the Wigner (or omni) receiver, the
// closest hit over <= 64 analytic rectangles, direct transmitter hits at
// depth 0, next-event estimation to the one Wigner transmitter with the
// waveform and aperture Wigner weights, gate sampling and a shadow test,
// a tent splat into the fast-time bins, and the diffuse bounce.  The
// arithmetic follows beifong_tpu_torch/integrators/receive_kernel.py::
// receive_megakernel_ref operation by operation (same association, same
// constants rounded from double, no --use_fast_math), so the two differ
// only where nvcc contracts a multiply and an add into one FMA (one
// rounding fewer) and in the order in which sums are taken.
//
// What bounds it on the H100: FP32 ALU and SFU work per lane.  A lane
// reads ~9 KB of scene tables that every lane shares and writes nothing
// but its splats, so there is no device-memory traffic to speak of
// (the output is n_blocks x n_time floats).  The design therefore keeps
// everything on chip: one thread per lane in a persistent grid-stride
// loop (a few blocks per SM, whatever the sample count), the scene tables
// copied once per block into shared memory, prims looped at run time,
// lanes that die (miss, absorbed, hit the receiver) leave the loop early.
//
// Splat and determinism: a tent touches floor(yb) and floor(yb) + 1
// only.  Each thread owns a private row of n_time floats in shared memory
// (bin b of thread t at hist[b * T + t]: conflict-free for any b), so no
// atomics are taken and the order of every float sum is fixed by the
// launch geometry.  The block then sums its T rows in thread order, in
// double, into an (n_blocks, n_time) partial buffer, and a second small
// kernel sums the partials in block order, in double, and rounds once to
// float.  A thread's own row sums a few thousand lanes in float; the
// sums above it would otherwise add 10^5 rows of float at 2^28 lanes.
// Event counts are integers.  The same inputs therefore give
// bit-identical output on one card.
//
// Random numbers: PRNG mode runs Philox4x32-10 keyed by the 64-bit seed
// with counter (lane, draw / 4), word draw % 4, top 24 bits scaled by
// 2^-24, so a lane's stream does not depend on the launch geometry.
// Injected mode reads u[draw * n_lanes + lane] from a (n_draws, n_lanes)
// tensor instead (parity with the plain version and the JAX package).
// Draw indices are positional (trace_lane: 0 time, then the ray draws,
// then six per depth), so a lane that leaves the loop early skips its
// remaining draws without shifting anyone's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr int PRIM_COLS = 34;
constexpr int TXP_COLS = 32;
constexpr int RECTANGLE = 0;
constexpr float CW = 0.0f;
constexpr float LINFMCW = 2.0f;

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
    float t_start;
    float t_window;
    float f_rx;
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

// Uniform number `idx` of one lane, from the generator or the injected
// tensor.  Philox words come four at a time; the last block is cached.
struct Draws {
    const float* u;
    long long lane, n_lanes;
    uint2 key;
    int use_prng;
    int group;
    uint4 words;

    __device__ float get(int idx) {
        if (!use_prng) return u[(long long)idx * n_lanes + lane];
        int g = idx >> 2;
        if (g != group) {
            words = philox4x32_10(
                make_uint4((uint32_t)lane, (uint32_t)(lane >> 32),
                           (uint32_t)g, 0u), key);
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

// The one transmitter: a rect aperture and its waveform.
struct Tx {
    const float* m;   // to_world rows 0..2 (12 floats)
    float wx, wy, area, gain, wf, amp, prf, text, fc, fext;
    float nx, ny, nz;

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

    // (t_emit, t_recv, gate weight) of a path of delay tau
    __device__ void emission(float tau, float u, float t_rx0, int gate,
                             float t_start, float t_window, float* t_emit,
                             float* t_recv, float* w_gate) const {
        if (!gate) {
            *t_emit = t_rx0 - tau;
            *t_recv = t_rx0;
            *w_gate = 1.0f;
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

__device__ void trace_lane(const Cfg& cfg, const float* sp,
                           const float* prim, const Tx& tx, Draws& dr,
                           float* hist, int T, unsigned int* events) {
    const float TP = F(6.283185307179586);
    const float cvel = sp[1];
    const float* rxm = sp + 2;
    const float rx_wx = sp[14], rx_wy = sp[15];
    const float n_time_f = (float)cfg.n_time;
    const float t_start = cfg.t_start, t_window = cfg.t_window;

    // ---------------- receive-ray generation (draws 0..n_ray) ----------
    float t_rx0 = cfg.gate ? 0.0f : t_start + dr.get(0) * t_window;
    float ox, oy, oz, dx, dy, dz, thr;
    int base;
    if (cfg.omni) {
        ox = rxm[3];
        oy = rxm[7];
        oz = rxm[11];
        float u1 = dr.get(1), u2 = dr.get(2);
        float z = 1.0f - 2.0f * u1;
        float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        float ph = TP * u2;
        dx = r * fast_cos(ph);
        dy = r * fast_sin(ph);
        dz = z;
        thr = F(4.0 * 3.141592653589793) * sp[32];
        base = 3;
    } else {
        float u1 = dr.get(1), u2 = dr.get(2);
        float lx = 2.0f * u1 - 1.0f, ly = 2.0f * u2 - 1.0f;
        ox = rxm[0] * lx + rxm[1] * ly + rxm[3];
        oy = rxm[4] * lx + rxm[5] * ly + rxm[7];
        oz = rxm[8] * lx + rxm[9] * ly + rxm[11];
        float nzx = rxm[2], nzy = rxm[6], nzz = rxm[10];
        float nn = rsqrtf(nzx * nzx + nzy * nzy + nzz * nzz);
        nzx = nzx * nn;
        nzy = nzy * nn;
        nzz = nzz * nn;
        float u3 = dr.get(3), u4 = dr.get(4);
        float area = 4.0f * rx_wx * rx_wy;
        float lam0 = cvel / fmaxf(cfg.f_rx, F(1e-6));
        float w_mn = fminf(rx_wx, rx_wy);
        float q = 2.0f * w_mn / (F(0.6) * lam0);
        float k_l = fmaxf(2.0f * (q * q) - 2.0f, 0.0f);
        bool pick = u3 >= 0.5f;
        float u0m = pick ? 2.0f * u3 - 1.0f : 2.0f * u3;
        float ph = TP * u4;
        float ct_c = sqrtf(fmaxf(1.0f - u0m, 0.0f));
        float ct_l = expf(logf(fmaxf(u0m, F(1e-12))) / (k_l + 1.0f));
        float tz = pick ? ct_l : ct_c;
        float st = sqrtf(fmaxf(1.0f - tz * tz, 0.0f));
        float tx_ = st * fast_cos(ph), ty_ = st * fast_sin(ph);
        float cosk = expf(k_l * logf(fmaxf(tz, F(1e-12))));
        float pdf_d = 0.5f * tz * F(1.0 / 3.141592653589793)
                      + 0.5f * (k_l + 1.0f) * F(1.0 / 6.283185307179586)
                        * cosk;
        float w0 = (tz / fmaxf(pdf_d, F(1e-30))) * area * sp[32];
        float sign = sgn_ge(nzz);
        float a = -1.0f / (sign + nzz);
        float b = nzx * nzy * a;
        float s1x = 1.0f + sign * nzx * nzx * a, s1y = sign * b,
              s1z = -sign * nzx;
        float s2x = b, s2y = sign + nzy * nzy * a, s2z = -nzy;
        dx = s1x * tx_ + s2x * ty_ + nzx * tz;
        dy = s1y * tx_ + s2y * ty_ + nzy * tz;
        dz = s1z * tx_ + s2z * ty_ + nzz * tz;
        float lam = cvel / fmaxf(cfg.f_rx, F(1e-6));
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
        base = 5;
    }

    float cx = ox, cy = oy, cz = oz;
    float plen = 0.0f;
    for (int depth = 0; depth < cfg.max_depth; ++depth) {
        // draws of this depth: u_dh, u5, u6, u7, then u8, u9
        const int d0 = base + 6 * depth;
        // ---- closest hit over the rectangles ----
        float tb = F(3.4e38), nx = 0.0f, ny = 0.0f, nz = 0.0f, rb = 0.0f,
              txc = -1.0f;
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
            }
        }
        if (!(tb < F(3.4e37))) break;     // miss: the lane is dead
        plen = plen + tb;
        float hx = cx + tb * dx, hy = cy + tb * dy, hz = cz + tb * dz;

        // ---- direct transmitter hits (depth 0; NEE covers the rest) ----
        if (depth == 0) {
            float cos_dh = -(dx * tx.nx + dy * tx.ny + dz * tx.nz);
            if (txc == 0.0f && cos_dh > 0.0f) {
                const float* m = tx.m;
                float te_h, tr_h, wg_h;
                tx.emission(plen / cvel, dr.get(d0), t_rx0, cfg.gate,
                            t_start, t_window, &te_h, &tr_h, &wg_h);
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
                splat(hist, T, cfg.n_time, val_h, yb_h);
                *events += val_h != 0.0f;
            }
        }

        // ---- NEE to the transmitter (only from non-transmitter hits) ----
        if (txc < 0.0f) {
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
                float sg = sgn_ge(-dx * nx + -dy * ny + -dz * nz);
                float co = wx_ * (nx * sg) + wy_ * (ny * sg) + wz_ * (nz * sg);
                float f_cos = rb * F(1.0 / 3.141592653589793)
                              * fmaxf(co, 0.0f);
                float t_emit, t_recv, w_gate;
                tx.emission((plen + dist) / cvel, dr.get(d0 + 3), t_rx0,
                            cfg.gate, t_start, t_window, &t_emit, &t_recv,
                            &w_gate);
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
                if (!occ && pdf_sa > 0.0f) {
                    float val = thr * f_cos * w_tx * w_gate
                                / fmaxf(pdf_sa, F(1e-30));
                    float yb = (t_recv - t_start) / t_window * n_time_f
                               - 0.5f;
                    splat(hist, T, cfg.n_time, val, yb);
                    *events += val != 0.0f;
                }
            }
        }

        if (depth == cfg.max_depth - 1) break;
        if (!(rb > 0.0f) || !(txc < 0.0f)) break;   // absorbed / on the tx

        // ---- diffuse bounce: cosine hemisphere about the flipped normal --
        float u8 = dr.get(d0 + 4), u9 = dr.get(d0 + 5);
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
    }
}

__global__ void receive_trace_kernel(const float* __restrict__ params,
                                     const float* __restrict__ prim,
                                     const float* __restrict__ txp,
                                     const float* __restrict__ uniforms,
                                     double* __restrict__ partial,
                                     unsigned long long* __restrict__ part_ev,
                                     Cfg cfg) {
    extern __shared__ float smem[];
    const int T = blockDim.x, tid = threadIdx.x;
    float* s_par = smem;
    float* s_prim = s_par + cfg.n_params;
    float* s_tx = s_prim + cfg.n_prims * PRIM_COLS;
    float* hist = s_tx + TXP_COLS;
    for (int i = tid; i < cfg.n_params; i += T) s_par[i] = params[i];
    for (int i = tid; i < cfg.n_prims * PRIM_COLS; i += T) s_prim[i] = prim[i];
    for (int i = tid; i < TXP_COLS; i += T) s_tx[i] = txp[i];
    for (int i = tid; i < cfg.n_time * T; i += T) hist[i] = 0.0f;
    __syncthreads();

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

    Draws dr;
    dr.u = uniforms;
    dr.n_lanes = cfg.n_lanes;
    dr.key = make_uint2((uint32_t)cfg.seed, (uint32_t)(cfg.seed >> 32));
    dr.use_prng = cfg.use_prng;
    float* my_hist = hist + tid;
    unsigned int events = 0;
    const long long stride = (long long)gridDim.x * T;
    for (long long lane = (long long)blockIdx.x * T + tid; lane < cfg.n_lanes;
         lane += stride) {
        dr.lane = lane;
        dr.group = -1;
        trace_lane(cfg, s_par, s_prim, tx, dr, my_hist, T, &events);
    }
    __syncthreads();

    // block row: sum the T private rows in thread order
    for (int b = tid; b < cfg.n_time; b += T) {
        double s = 0.0;
        const float* row = hist + b * T;
        for (int t = 0; t < T; ++t) s += (double)row[t];
        partial[(long long)blockIdx.x * cfg.n_time + b] = s;
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

// Fixed-order sum of the per-block partials.
__global__ void receive_reduce_kernel(const double* __restrict__ partial,
                                      const unsigned long long* __restrict__
                                          part_ev,
                                      int n_blocks, int n_time,
                                      float* __restrict__ out,
                                      long long* __restrict__ out_events) {
    int b = threadIdx.x;
    if (b < n_time) {
        double s = 0.0;
        for (int k = 0; k < n_blocks; ++k)
            s += partial[(long long)k * n_time + b];
        out[b] = (float)s;
    }
    if (b == 0) {
        unsigned long long e = 0;
        for (int k = 0; k < n_blocks; ++k) e += part_ev[k];
        out_events[0] = (long long)e;
    }
}

int threads_for(int n_time) {
    // per-thread histogram rows: keep them within ~96 KB per block
    int t = (96 * 1024) / (4 * n_time);
    t = t > 256 ? 256 : t;
    return (t / 32) * 32;
}

}  // namespace

extern "C" {

// Launch geometry for one call: threads per block, dynamic shared bytes
// and the persistent grid (resident blocks on every SM, fewer if the
// lanes run out).  Returns a cudaError_t.
int rk_geometry(int n_time, long long n_lanes, int n_prims, int n_params,
                int* blocks, int* threads, int* smem_bytes) {
    int T = threads_for(n_time);
    if (T < 32) return (int)cudaErrorInvalidValue;
    int smem = 4 * (n_params + n_prims * PRIM_COLS + TXP_COLS + n_time * T);
    cudaError_t err = cudaFuncSetAttribute(
        receive_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, receive_trace_kernel, T, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    long long need = (n_lanes + T - 1) / T;
    long long nb = (long long)per_sm * sms;
    *blocks = (int)(nb < need ? nb : need);
    *threads = T;
    *smem_bytes = smem;
    return (int)cudaSuccess;
}

// Trace + reduce on `stream`.  `uniforms` is null in PRNG mode.
int rk_launch(const float* params, const float* prim, const float* txp,
              const float* uniforms, double* partial,
              unsigned long long* part_ev, float* out, long long* out_events,
              long long n_lanes, unsigned long long seed, int n_time,
              int max_depth, int gate, int omni, int n_prims, int n_params,
              float t_start, float t_window, float f_rx,
              int blocks, int threads, int smem_bytes, void* stream) {
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
    cfg.t_start = t_start;
    cfg.t_window = t_window;
    cfg.f_rx = f_rx;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    receive_trace_kernel<<<blocks, threads, smem_bytes, s>>>(
        params, prim, txp, uniforms, partial, part_ev, cfg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int rt = ((n_time + 31) / 32) * 32;
    receive_reduce_kernel<<<1, rt, 0, s>>>(partial, part_ev, blocks, n_time,
                                           out, out_events);
    return (int)cudaGetLastError();
}

const char* rk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
