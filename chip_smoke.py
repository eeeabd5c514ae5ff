#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`beifong_tpu_torch`) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device  - a CUDA card must be present; prints its name and power limit;
2. build   - compiles every CUDA source of the main paths from `csrc/`
             (one nvcc per source, all started together, and a -lineinfo
             cubin of the receive kernel for the flagship's and the
             coherent kernel's instruction mixes) and prints the build times and ptxas' registers and
             spills of every kernel and configuration;
3. parity  - each kernel against its plain PyTorch version on the card:
             the receive megakernel's flagship configuration on seeded
             (n_draws, 2^18) uniforms at depth 3 in gate and fixed time
             sampling and in Philox mode at 2^28 lanes, its launch
             geometry, registers, SASS mix by class and stage and the
             issue-slot bound of the lane stages' fewest instructions
             beside the FP32 bound (`tools/k1_mix.py`);
             its mesh
             configuration on the 10,082-triangle mesh scene, depth 2, on
             injected uniforms at 2^16 lanes (no strata) and 2^20 lanes
             (1024 tiles, 32 x 32 strata) and in Philox mode at 2^20
             lanes; two Philox calls with one seed, which must be
             bit-identical, in both configurations; bvh_closest and
             bvh_any on 2^20 rays over the same mesh (half from the
             receiver aperture, half from around the mesh), their device
             times at 2^20 and at the wavefront pass's 2^17 (calls queued
             behind a sleep) beside a call with its wrapper and the
             wrapper's host µs, registers and the issue-slot bound of
             their SASS (`tools/bvh_mix.py`);
   doppler - the receive megakernel's Doppler configuration (moving
             geometry, the GGX rough conductor, time x frequency grids)
             against its plain version: the multi_body scene lane by lane
             on injected uniforms at 2^16 lanes, depth 2; one pulse of the
             range-Doppler example per cell at 2^18 lanes; the flagship on
             a 1,024-bin fast-time grid and the range-Doppler pulse on a
             256 x 128 grid (the global accumulator); two Philox calls
             with one seed of each main scene, which must agree per cell to
             1e-6 of max|acc| (the configuration adds with atomics), and
             the plain version on the same stream at 2^24 lanes;
   coherent - K1's coherent configuration and its LO receive types
             against the plain version on injected uniforms, depth 2:
             fmcw_sonar (mix_resample, power), the FMCW mixer (I / Q) and
             raw_resample (power) scenes, pulse 0 of the train (I / Q, a
             moving plate), the flagship (I / Q) and the dechirp scene
             (I / Q, 1,024 bins) at 2^18 lanes, mesh_scene (I / Q) lane by
             lane at 2^16; I / Q per cell within TOL x max(|I|, |Q|) plus
             the phase slack (`receive_kernel.phase_slack`) times the
             cell's sum of amplitudes;
4. main    - the flagship receive at 2^28 samples, depth 3, and the mesh
             receive at 2^24 samples, depth 2, through `receive()` on the
             card (one warm-up, five timed calls each), then
             `develop_signal` and `pulse_compress`: finite output of the
             expected shape whose range profile peaks at the 2R/c delay;
             multi_body and the range-Doppler pulse through `receive()` at
             2^24 samples, depth 2, gate sampling (one warm-up, five timed
             calls each), each launching the Doppler configuration of K1
             and no K4 (the range-Doppler pulse, like every analytic power
             scene of the Doppler and fmcw_sonar parity, the Doppler power
             kernel `receive_doppler_power_kernel` by the launch record,
             with its geometry, registers, SASS mix and issue-slot bound),
             the bodies and the plate at their range gates and
             Doppler bins, and CA-CFAR (`dsp.ca_cfar_2d`) on the
             plate's range-Doppler map, on the card, whose detections
             hold the plate's cell; then a ray query on the mesh: bvh_closest of
             2^20 receiver rays, bvh_any of their hits toward the
             transmitter.  Each path must have launched its kernels; the
             launch counts are set to 0 just before a path and read just
             after it;
   coherent - through `receive()` at 2^24 samples, one warm-up and five
             timed calls each, every call launching K1 and no wavefront
             pass: golden config 2 (`fmcw_sonar_scene`, depth 2), whose
             beat spectrum peaks within 2 bins of slope 2R / c; the pulse
             train of golden config 3 (eight coherent calls of
             `pulse_train_scene(p)`, depth 1, one seed), whose slow-time
             FFT peaks on bin 5; the dechirp chain of golden config 4
             (coherent `fmcw_dechirp_scene`, depth 2, then conj,
             `decimate` by 8 and a Hann `range_fft`), whose beat lands
             within 1 bin of the config's range bin; mesh_scene coherent,
             whose |I + jQ| peaks within 2 bins of 2R / c.  Each beside its
             kernel alone, a Philox repeat and the plain version at 2^24
             lanes (the pulse train's bit-identical: its 8 bins sum in the
             coherent kernel's warp rows); for the pulse train and the
             dechirp the coherent kernel's (`receive_coherent_kernel`)
             launch geometry, registers, SASS mix by class and stage and
             issue-slot bound (`tools/k1_mix.py`), as the CPI phase prints
             them for the corner; then K1 against the wavefront on
             fmcw_sonar (peak bin, window energy) and pulse 0 (the summed
             I / Q's magnitude and phase);
   textures - K1's texture twins (receive_flagship_kernel<true>, power,
             and receive_coherent_kernel<true>, I / Q) on the flagship
             scene with a checkerboard or a 128 x 128 bitmap ground
             (`flagship_scene(ground_texture=...)`): each against its
             plain version on injected uniforms (2^18 lanes) and Philox
             (power 2^28, I / Q 2^24); the anchors (a uniform
             checkerboard equals the
             untextured scene bit for bit, a constant bitmap its
             checkerboard to 1e-5); receive() at the flagship's 2^28
             samples, depth 3, and the coherent receive's 2^24, depth 2,
             one warm-up and five timed calls a ground, each launching
             the twin (the launch record), the target on its round-trip
             bin; each twin alone beside the untextured kernel, its
             registers, SASS mix and bounds;
   doppler_prims - the kinds and the textures in K1's Doppler
             configurations at the range-Doppler pulse's width (2^24
             lanes, depth 2): the Doppler power twins
             (receive_doppler_power_kernel<true>, <false, true>, <true,
             true>) on the pulse with a closing sphere, disk or cylinder,
             over a checkerboard or bitmap ground, the flagship's metal
             (conductor) sphere and golden config 2's sonar sphere, and the
             coherent prims twin on the closing sphere and the metal one:
             each against its plain version on injected uniforms (2^18)
             and Philox (power lane by lane, a lane's floor
             PRIM_LANE_FLOOR; I / Q with each ill-conditioned
             connection's own slack); the anchors (the Doppler bin and
             CA-CFAR cell, the ground's ridge at 0 Hz, the metal sphere's
             range bin and its closed mirror chains, the sonar's beat);
             receive() five calls a scene, each launching its twin; a
             closing sphere's CPI in one launch, power and I / Q; each
             twin alone, beside the rectangle kernel on the plate and
             over an untextured ground; registers, SASS mix and bounds;
   mimo    - golden config 6 (`mimo_beamform_scene`: an 8-element
             lambda / 2 receive array, one target at 15 degrees, 4 m out)
             through K1's MIMO configuration: against its plain version on
             injected uniforms (all 2E = 16 channels, 2^14 lanes) and on
             the Philox stream at 2^24 lanes (per cell within TOL x
             max|I, Q| plus the MIMO phase slack times the cell's
             amplitude sum); receive_mimo() at 2^13 samples, depth 2,
             gate, then develop_mimo, delay-and-sum and MVDR over 81
             azimuths: both peak within 2 bins of the target's azimuth,
             the beamformed profile at 2R / c within 2 bins; receive_mimo()
             timed at 2^24 and 2^22 samples (bench.py's MIMO rate), every
             call launching K1's MIMO configuration and no wavefront pass;
             the beamformers timed; K1 against the MIMO wavefront at 2^20
             samples (the DAS azimuth spectra correlated > 0.9);
   media   - examples/stratified_medium.py (`stratified_medium_scene`)
             through receive() and K1's media twins: the echo attenuation
             through the example's slab at 2^14 and 2^24 samples within
             10% of its closed form (`two_leg_transmittance`, 0.263), a
             uniform 8 x 8 x 128 grid equal to the homogeneous medium to
             1e-3 of max|acc|, a half-space grid's attenuation within 10%
             of the wavefront's; each medium kind in the flagship and
             coherent twins against the plain version on injected
             uniforms (the point target) and on Philox at 2^24 (the
             example); config 5's CPI through a medium in one launch
             against the plain version; the times of vacuum, K = 4,
             K = 32, homogeneous and the grid at 2^24 samples;
   phased  - K1's endpoint twins at full width: phased_tx_scene (an
             8-element phased transmitter steered at its target, then
             away), phased_rx_scene (an analog 8-element phased receiver
             steered at the 4 m target, then at the 5 m one) and
             four_tx_scene (four transmitters of three kinds) through
             receive() at 2^24 samples, depth 2, gate, and phased_tx
             coherent: each twin against its plain version on injected
             uniforms (2^16 lanes) and on Philox (2^22), the anchors (the
             echo within 2 bins of its round trip, off-steer window < 0.5
             of on-steer, the other target's window < 0.5 of the steered
             one's, each transmitter's echo within 2 bins of its own round
             trip), the kernel alone, K1 against the wavefront at 2^20
             (peak bins within 2, window energies within 0.2-5x; the
             coherent case averaged over 16 seeds on each route); then
             the receive rules (`rule_parity`): the I / Q endpoint kernel
             on the analog phased receiver and on the phased transmitter
             under a mixer with an LO, and (at the lobes phase's end) the
             lobe kernel on the rough plastic under that mixer in power
             and I / Q, each on injected uniforms (2^16 lanes) and Philox
             (2^20) lane by lane against the plain version;
   wavefront - the eager receive wavefront: ray_triangle_closest /
             ray_triangle_any (K4) against their plain versions, bit for
             bit, at the wavefront's shape (2^17 receiver rays x the
             multi_body scene's 324 faces), a query shape (2^18 rays x
             mesh_scene's 10,082 faces) and the largest soup that
             use_bvh='auto' leaves to K4 (2^17 rays x mesh_scene(n_side=
             22)'s 968 faces), with their registers, shared memory, both
             bounds and the pairs the cull keeps; then the multi_body scene
             (`scenes.multi_body_scene`, the JAX package's
             examples/multi_body.py) through receive(use_kernel=False) at
             2^22 samples, gate sampling, depth 2 (one warm-up, five timed
             calls, one profiled call), its two bodies checked in their
             range gates at their Doppler and against K1 at the same
             sample count (peak cells within one bin, each body's window
             energy within K1_WF_BOUND); the same scene at 2^16 samples on
             the card
             and on the CPU with one seed; the flagship through the kernel
             and through the wavefront at 2^22 samples, depth 3; and
             mesh_scene through the wavefront, whose BVH queries run K2 /
             K3, at 2^20 samples;
5. report  - one JSON line of every kernel ({"kernels": [...]}), then the
             last line {"ok": true, "device": {...}}.

Every time printed is measured in this run on the card named beside it.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

N_LANES = 1 << 28          # flagship samples per receive() call
PARITY_LANES = 1 << 18     # flagship injected-uniform comparison
PLAIN_CHUNK = 1 << 22      # the plain version runs 2^28 lanes in chunks
MAX_DEPTH = 3
MESH_LANES = 1 << 24       # mesh samples per receive() call
MESH_DEPTH = 2
# the mesh paths' plain version walks the BVH one node a step for every
# lane at once, so its time goes with the steps more than with the lanes:
# their Philox parity runs in chunks as large as the flagship's
MESH_PLAIN_CHUNK = 1 << 22
# the Philox parity of the phased and lobes phases, over the first 2^22 of
# their main paths' 2^24 lanes (`scaled_stats`); every other path's runs at
# its main path's width
PARITY_PHILOX_LANES = 1 << 22
MESH_BENCH_LANES = 1 << 20  # the JAX package's mesh benchmark size
N_RAYS = 1 << 20           # BVH query rays
WF_PASS_RAYS = 1 << 17     # the BVH wavefront's rays a pass (K2 / K3)
SEED = 7
TOL = 1e-4                 # x max|acc| per bin; relative on event counts
EDGE_FLIPS = 1e-4          # rays whose face differs at a shared edge
H100_FP32_FLOPS = 67e12    # dense FP32 outside the tensor cores, 700 W
H100_BYTES_PER_S = 3.35e12
WF_SAMPLES = 1 << 22       # wavefront samples per receive() call
WF_DEPTH = 2
WF_CPU_SAMPLES = 1 << 16   # the card-against-CPU comparison
PROFILE_SAMPLES = 1 << 20  # the profiled wavefront call (8 passes)
K4_RAYS = 1 << 17          # the wavefront's K4 shape (one pass of lanes)
K4_QUERY_RAYS = 1 << 18    # the K4 query shape, on mesh_scene
K4_QUEUED = 20             # K4 calls a timed run, queued behind a sleep
K4_SLEEP_CYCLES = 4_000_000  # ~2 ms at 1980 MHz: longer than 20 enqueues
FLAG_SAMPLES = 1 << 22     # flagship: kernel against wavefront
FLAG_DEPTH = 3
BVH_WF_SAMPLES = 1 << 20   # mesh_scene through the wavefront (K2 / K3)
DOP_LANES = 1 << 24        # Doppler configuration: samples per receive()
DOP_DEPTH = 2
DOP_PLAIN_CHUNK = 1 << 20
MB_PARITY_LANES = 1 << 16  # multi_body, lane by lane
RD_PARITY_LANES = 1 << 18  # range-Doppler pulse, wide and global grids
REPEAT_TOL = 1e-6          # x max|acc| per cell: two Philox calls, atomics
LARGE_GRID_WHAT = 'range_doppler 4096 x 128 (2^19 cells, global grid)'
# K1 against the wavefront on multi_body at 2^22 samples: each body's
# window energy (two unbiased estimators of one expectation; a CPU
# rehearsal at 2^17 samples differed by at most 8% over three seeds)
K1_WF_BOUND = 0.25
# FP32 operations of one (ray, triangle) pair, counted from
# pallas_intersect._kernel as csrc/intersect_kernels.cu computes them
K4_PAIR_OPS = 47
# and of the cull in front of it (csrc/intersect_kernels.cu cull_rejects):
# 3 subtractions, 3 dot products of 5 (a product and two FMAs), a max and
# 5 FMAs, an FMA counted as two
K4_CULL_OPS = 3 + 3 * 5 + 1 + 5 * 2
# the coherent configuration and the LO receive types
COH_PARITY_LANES = 1 << 18   # injected-uniform comparisons
COH_MESH_PARITY_LANES = 1 << 16
COH_LANES = 1 << 24          # samples per receive() call on the main paths
COH_DEPTH = 2
PULSE_DEPTH = 1              # golden config 3 traces one bounce
COH_PLAIN_CHUNK = 1 << 20
# lane flags of a coherent mesh run: the amplitude is the square root of a
# power, so the power test's 1e-6 of the largest lane becomes 1e-3
COH_LANE_FLOOR = 1e-3
# K1 against the wavefront, two unbiased estimators of one expectation:
# - fmcw_sonar (power) at 2^22 samples: the beat spectrum's peak bin and
#   the energy of the five bins around it (a CPU rehearsal at 2^18 and
#   2^20 samples, three seeds each, differed by at most 3.5%);
# - pulse 0 of the train (I / Q) at 2^26 samples: the summed I / Q, its
#   magnitude and its phase (the CW echo's fast-time profile is flat: its
#   peak bin is noise).  The rehearsal at 2^22 samples differed by up to
#   41% in magnitude and 0.43 rad in phase over three seeds; 16x the
#   samples take a quarter of that spread.
KW_SAMPLES = {'fmcw_sonar': 1 << 22, 'pulse_train': 1 << 26}
KW_LANES_PER_PASS = 1 << 20  # the wavefront's passes (fewer host launches)
K1_WF_COH_BOUND = 0.25
K1_WF_PHASE_BOUND = 0.3      # rad, tests/test_pallas_receive.py's bound

# FP32 arithmetic instructions (add, sub, mul, div, sqrt, rsqrt, exp, log,
# min, max, abs, floor, ceil, rint, fmod) per lane and stage, counted by
# hand from csrc/receive_megakernel.cu and csrc/bvh_walk.cuh; compares,
# selects, integer work (Philox, strata cells, node links) are not
# counted, so the bound is a lower bound.
FP32_OPS = {
    'ray_wigner': 193,   # aperture point, MIS lobe direction, WDF weight
    'ray_strata': 163,   # the same with a stratified cosine direction
    'ray_omni': 33,
    'time_fixed': 2,
    'rect_test': 41,     # one ray / rectangle test (closest hit, shadow)
    'hit': 17,           # normal, path length, hit point
    'direct': 174,       # direct transmitter hit: gate, WDFs, splat
    'nee_geom': 35,      # transmitter point, direction, cos
    'nee': 162,          # pdf, BSDF, gate, waveform and aperture WDFs
    'nee_splat': 23,     # contribution and tent splat
    'bounce': 73,        # cosine-hemisphere bounce
    'walk': 6,           # BVH walk set-up: 3 x (abs, reciprocal)
    'node_test': 23,     # slab test of one node
    'leaf_test': 8 * 47,  # Moller-Trumbore of a leaf's 8 triangles
    'mesh_hit': 19,      # geometric normal of the winning triangle
    # Doppler configuration
    'freq_draw': 2,      # receive frequency over the ADC window
    'ggx_nee': 100,      # GGX f cos (half vector, D, G, Fresnel) beyond
    #                      the diffuse one
    'ggx_bounce': 166,   # frame + GGX half-vector sample, Fresnel, G
    'dop_direct': 1,
    'dop_nee': 20,       # vertex and transmitter factors
    'dop_bounce': 11,
    'splat_2d': 20,      # frequency coordinate, its tent, four taps
    # receive types and coherent I / Q
    'lo_freq': 11,       # receive frequency off a waveform (inst_freq)
    'lo_bin': 12,        # a beat: inst_freq, difference, |.|
    'phase': 92,         # echo phase with the transmitter's h (a tone),
    #                      boundary phase, sqrt, two fast sines, the second
    #                      channel's taps
    'phase_lo': 35,      # mix_resample's receive fold and its h (the LO
    #                      dechirp's is 43)
    'h_chirp': 52,       # the quadratic term of each h of a chirp
    'mirror_bounce': 56,  # flipped normal, d - 2 (d.n) n, conductor Fresnel
    # MIMO: a phased array's ray (origin, cosine hemisphere, one element's
    # pattern gain) in place of ray_wigner; x1 - o and its length once a
    # lane; per element of a connection: dd_e (10), its phase term (3),
    # fast_cos + fast_sin (23), amplitude (2), four taps (4 mul, 4 adds).
    # A MIMO connection still counts 'phase', whose two fast sines and
    # second channel (~27) it does not run: < 8% of its 8 x 46
    'ray_phased': 133,
    'mimo_vertex': 10,
    'mimo_elem': 46,
    # a phased array's cross-WDF (pair_sum): per pair, its midpoint, the
    # point's footprint coordinates and the inside test; per pair whose
    # footprint holds the point, two tents, two sincs (fast_sin and a
    # divide each), the rectangle weight, the phase, fast_cos and the sum
    'pair_tests': 29,
    'pair_terms': 55,
    # the endpoint kernels' footprint index, a cross-WDF's look-up: the
    # point's offset (3), its two coordinates (10), the point bound (5), two
    # cells (6); then 'pair_tests' for each pair it visits ('pair_visits')
    'pair_index': 24,
    # the lobe twins, beyond the diffuse NEE and bounce (the cosine
    # hemisphere's 73 operations; fres_diel is 24: the relative IOR, cos_t,
    # rs, rp and their mean square): the plastic base's two Fresnels; the
    # rough plastic's too, plus its GGX coat (half vector, D, two g1,
    # the coat's Fresnel); GGX glass's rd_fcos_pdf (its half vector, D,
    # G, Fresnel, Jacobian, f and pdf); a composite's second lobe (a
    # diffuse f cos, the mix; its type's own extra counted by type)
    'plas_nee': 52,
    'rplas_nee': 134,
    'rdiel_nee': 100,
    'blend_nee': 21,
    # bounces, each in place of the diffuse one (not counted in 'bounce'):
    # a dielectric's Fresnel and reflection or refraction, a plastic's
    # cosine sample, coat pick and two Fresnels, a rough plastic's GGX
    # sample, coat weight and pdf, GGX glass's sample, refraction and
    # rd_fcos_pdf, a mask's pass (the back-face spawn)
    'diel_bounce': 40,
    'plas_bounce': 143,
    'rplas_bounce': 300,
    'rdiel_bounce': 295,
    'pass_bounce': 5,
    # the texture twins: a hit on a textured rectangle, its scaled uv (6),
    # the checkerboard's parity (6) and the reflectance's product (the
    # bitmap's fraction, texel coordinates and clamps take 19)
    'tex_hit': 13,
    # the prims twins, in place of 'rect_test' for those records (closest
    # hit and shadow): the object-space ray (33), then a disk's plane and
    # circle (10); a cylinder's quadratic, two roots and their z (31); a
    # sphere's quadratic, stable roots and their min / max (32); and at a
    # hit SHADE's normal: a sphere's object point, M^T p, rsqrt and scale
    # (64), a cylinder's (45; a disk's is its record's)
    'disk_test': 43,
    'cylinder_test': 64,
    'sphere_test': 65,
    'sphere_hit': 64,
    'cylinder_hit': 45,
}


def fail(msg: str) -> None:
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f'nvidia-smi: {res.stderr.strip()}')
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int):
    """(per-call times [ms] from CUDA events around each of n calls of
    fn(i), the last call's result)."""
    import torch
    times, res = [], None
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times, res


def wall_ms(fn):
    """(host ms of fn() ending in a synchronise, its result)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def compare(acc, n_ev, ref, n_ref, what: str) -> dict:
    scale = float(ref.abs().max())
    err = float((acc - ref).abs().max())
    ev, ev_ref = int(n_ev), int(n_ref)
    print(f'parity {what}: max|acc| {scale:.6e}  max abs err {err:.3e} '
          f'({err / max(scale, 1e-300):.3e} of max)  events {ev} vs '
          f'{ev_ref}')
    if not (scale > 0 and err <= TOL * scale):
        fail(f'{what}: kernel differs from the plain version '
             f'({err:.3e} > {TOL} x {scale:.3e})')
    if abs(ev - ev_ref) > TOL * ev_ref:
        fail(f'{what}: event counts {ev} vs {ev_ref}')
    return dict(err=err, rel=err / scale)


def lane_bound(acc, lane, ref, lane_ref, cell_slack=0.0,
               floor=1e-6) -> dict:
    """`compare_lanes`' bound without its verdict: the lanes that took
    another path (beyond TOL of themselves and `floor` of the largest
    lane), their sums, and the worst cell against TOL x max|acc| plus
    those sums plus `cell_slack`."""
    tol_lane = TOL * lane_ref.abs() + floor * float(lane_ref.abs().max())
    flipped = (lane - lane_ref).abs() > tol_lane
    slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    scale = float(ref.abs().max())
    diff = (acc - ref).abs()
    return dict(flipped=flipped, n_flip=int(flipped.sum()), slack=slack,
                scale=scale, err=float(diff.max()),
                worst=float((diff / (TOL * scale + slack + cell_slack))
                            .max()))


def compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, max_depth,
                  what: str, cell_slack=0.0, floor=1e-6, ill=None) -> dict:
    """Mesh parity, lane by lane: a lane whose contribution sum differs by
    more than TOL of itself (and 1e-6 of the largest lane) took another
    path, as a ray that meets a triangle edge may under FMA contraction;
    those lanes are counted, may be at most EDGE_FLIPS of all, and bound
    how far the sums may move beyond TOL x max|acc| (each can at most
    remove its own contributions from some bins and add them to others)
    and the events (2 per depth).  `cell_slack` (a tensor of the grid's
    shape, or 0) widens each cell's bound beyond that; `floor` replaces
    the 1e-6 of the largest lane; lanes of the mask `ill` (the plain
    version's `ill_out`) may take another path beside the EDGE_FLIPS
    share."""
    b = lane_bound(acc, lane, ref, lane_ref, cell_slack, floor)
    flipped, n_flip, slack, scale, err, worst = (
        b[k] for k in ('flipped', 'n_flip', 'slack', 'scale', 'err',
                       'worst'))
    n_out = n_flip if ill is None else int((flipped & ~ill).sum())
    ev, ev_ref = int(n_ev), int(n_ref)
    print(f'parity {what}: max|acc| {scale:.6e}  max abs err {err:.3e} '
          f'({err / max(scale, 1e-300):.3e} of max)  events {ev} vs '
          f'{ev_ref}; {n_flip} of {lane.numel()} lanes took another path '
          f'(their sums {slack:.3e} = {slack / max(scale, 1e-300):.3e} of '
          f'max); worst cell at {worst:.3f} of its bound')
    if n_out > EDGE_FLIPS * lane.numel():
        fail(f'{what}: {n_flip} lanes differ from the plain version')
    if not (scale > 0 and worst <= 1.0):
        fail(f'{what}: kernel differs from the plain version (worst cell '
             f'{worst:.3f} of its bound; {err:.3e} against {TOL} x '
             f'{scale:.3e} + {slack:.3e})')
    if abs(ev - ev_ref) > TOL * ev_ref + 2 * max_depth * n_flip:
        fail(f'{what}: event counts {ev} vs {ev_ref}')
    return dict(err=err, rel=err / scale, flips=n_flip)


def bound(ops: float, n_bytes: float, what: str) -> dict:
    t_ops = ops / H100_FP32_FLOPS * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    print(f'bound {what}: {ops:.4e} FP32 ops over {H100_FP32_FLOPS:.3g} '
          f'FLOP/s = {t_ops:.4e} ms; {n_bytes:.4e} bytes over '
          f'{H100_BYTES_PER_S:.3g} B/s = {t_bytes:.4e} ms (published H100 '
          f'SXM peaks at 700 W)')
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def lane_ops(stats: dict, n_rect: int, ray: str = 'ray_wigner',
             kinds: dict | None = None) -> float:
    """FP32 operations that the stage counts of a plain-version run say
    the receive kernel must do; `ray` the cost of an unstratified ray
    ('ray_omni' for an omni receiver).  `kinds` ({'sphere': n, 'disk': n,
    'cylinder': n}, the prims twins' records among the `n_rect`) costs
    their closest-hit and shadow tests and their hits' normals."""
    phased = stats.get('phased_ray', 0)
    extra = 0.0
    for k, n in (kinds or {}).items():
        d = FP32_OPS[f'{k}_test'] - FP32_OPS['rect_test']
        extra += (stats['trace'] * n + stats.get(f'{k}_occ', 0)) * d \
            + stats.get(f'{k}_hit', 0) * FP32_OPS.get(f'{k}_hit', 0)
    return extra + ((stats['lanes'] - stats['strata'] - phased)
            * FP32_OPS[ray]
            + stats['strata'] * FP32_OPS['ray_strata']
            + phased * FP32_OPS['ray_phased']
            + stats['trace'] * n_rect * FP32_OPS['rect_test']
            + stats['occ_tests'] * FP32_OPS['rect_test']
            + sum(stats.get(k, 0) * FP32_OPS[k] for k in
                  ('hit', 'direct', 'nee_geom', 'nee', 'nee_splat',
                   'bounce', 'freq_draw', 'ggx_nee', 'ggx_bounce',
                   'dop_direct', 'dop_nee', 'dop_bounce', 'splat_2d',
                   'lo_freq', 'lo_bin', 'phase', 'phase_lo', 'h_chirp',
                   'mirror_bounce', 'mimo_vertex', 'mimo_elem',
                   'pair_tests', 'pair_terms', 'plas_nee', 'rplas_nee',
                   'rdiel_nee', 'blend_nee', 'diel_bounce', 'plas_bounce',
                   'rplas_bounce', 'rdiel_bounce', 'pass_bounce',
                   'tex_hit'))
            + walk_ops(stats))


def walk_ops(stats: dict) -> float:
    return (stats.get('walks', 0) * FP32_OPS['walk']
            + stats.get('node_tests', 0) * FP32_OPS['node_test']
            + stats.get('leaf_tests', 0) * FP32_OPS['leaf_test']
            + stats.get('mesh_hits', 0) * FP32_OPS['mesh_hit'])


def print_build(infos: dict, tag: str) -> None:
    # K1's configurations by their mangled template arguments (each ends
    # in Lb0ELb0EE, Lb1ELb0EE for its media twin, Lb0ELb1EE for its
    # endpoint twin; the Doppler family's in a third flag, Lb1E for its
    # lobe twin)
    k1 = {'receive_flagship_kernel': 'flagship',
          'receive_trace_kernelILb0E': 'flagship',
          'receive_trace_kernelILb1E': 'mesh',
          'receive_doppler_kernelILb0ELb0E': 'doppler',
          'receive_doppler_kernelILb1ELb0E': 'doppler mesh',
          'receive_doppler_kernelILb0ELb1E': 'coherent',
          'receive_doppler_kernelILb1ELb1E': 'coherent mesh',
          'receive_mimo_kernelI': 'mimo'}
    names = {}
    for k, v in k1.items():
        if k == 'receive_flagship_kernel':
            continue
        for m, e, lob in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)):
            if lob and 'doppler' not in k:
                continue
            tail = f'Lb{lob}E' if 'doppler' in k else ''
            names[f'{k}Lb{m}ELb{e}E{tail}E'] = (
                f'receive_megakernel ({v}' + (' media)' if m else
                                              ' endpoints)' if e else
                                              ' lobes)' if lob else ')'))
    names['receive_flagship_kernelILb0ELb1E'] = \
        'receive_megakernel (flagship prims)'
    names['receive_coherent_kernelILb0ELb1E'] = \
        'receive_megakernel (coherent prims)'
    names['receive_flagship_kernelILb1ELb1E'] = \
        'receive_megakernel (flagship prims textures)'
    names['receive_coherent_kernelILb1ELb1E'] = \
        'receive_megakernel (coherent prims textures)'
    names['receive_flagship_kernelILb0E'] = 'receive_megakernel (flagship)'
    names['receive_flagship_kernelILb1E'] = \
        'receive_megakernel (flagship textures)'
    names['receive_mesh_kernel'] = 'receive_megakernel (mesh)'
    names['receive_mimo_array_kernel'] = 'receive_megakernel (mimo)'
    names['receive_coherent_kernelILb0E'] = 'receive_megakernel (coherent)'
    names['receive_coherent_kernelILb1E'] = \
        'receive_megakernel (coherent textures)'
    names['receive_doppler_power_kernelILb0ELb0E'] = \
        'receive_megakernel (doppler)'
    names['receive_doppler_power_kernelILb1ELb0E'] = \
        'receive_megakernel (doppler textures)'
    names['receive_doppler_power_kernelILb0ELb1E'] = \
        'receive_megakernel (doppler prims)'
    names['receive_doppler_power_kernelILb1ELb1E'] = \
        'receive_megakernel (doppler prims textures)'
    names['receive_mesh_doppler_kernelILb0ELb0E'] = \
        'receive_megakernel (doppler mesh)'
    names['receive_mesh_doppler_kernelILb1ELb1E'] = \
        'receive_megakernel (coherent mesh lobes)'
    names['receive_mesh_doppler_kernelILb1ELb0E'] = \
        'receive_megakernel (coherent mesh)'
    names['receive_mesh_doppler_kernelILb0ELb1E'] = \
        'receive_megakernel (doppler mesh lobes)'
    names['receive_lobe_kernelILb0E'] = 'receive_megakernel (doppler lobes)'
    names['receive_lobe_kernelILb1E'] = \
        'receive_megakernel (coherent lobes)'
    names['receive_endpoint_kernel'] = \
        'receive_megakernel (flagship endpoints)'
    names['receive_endpoint_coherent_kernel'] = \
        'receive_megakernel (coherent endpoints)'
    names.update({
             'receive_reduce_kernel': 'receive reduce',
             'bvh_closest_kernel': 'bvh_closest', 'bvh_any_kernel': 'bvh_any',
             'ray_triangle_kernelILb0E': 'ray_triangle_closest',
             'ray_triangle_kernelILb1E': 'ray_triangle_any'})
    for kname, info in infos.items():
        print(f'build {kname}: {info.seconds:.1f} s nvcc '
              f'({os.path.basename(info.path)}) {tag}')
        fn = '?'
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = next((v for k, v in names.items() if k in m.group(1)),
                          m.group(1))
            elif 'registers' in line or 'spill' in line:
                print(f'  ptxas {fn}: {line.strip()}')


# the warp-wavefront kernel of each configuration `tools/k1_mix.py` reads
MIX_KERNEL = {'flagship': 'receive_flagship_kernelILb0ELb0E',
              'pulse_train': 'receive_coherent_kernelILb0ELb0E',
              'dechirp': 'receive_coherent_kernelILb0ELb0E',
              'corner': 'receive_coherent_kernelILb0ELb0E',
              'flagship_checker': 'receive_flagship_kernelILb1ELb0E',
              'coherent_checker': 'receive_coherent_kernelILb1ELb0E',
              'flagship_sphere': 'receive_flagship_kernelILb0ELb1E',
              'coherent_sphere': 'receive_coherent_kernelILb0ELb1E',
              'flagship_sphere_checker': 'receive_flagship_kernelILb1ELb1E',
              'coherent_sphere_checker': 'receive_coherent_kernelILb1ELb1E',
              'window_thin': 'receive_lobe_kernelILb0E',
              'window_dielectric': 'receive_lobe_kernelILb1E',
              'ep_phased_tx': 'receive_endpoint_kernel',
              'ep_phased_rx': 'receive_endpoint_kernel',
              'ep_four_tx': 'receive_endpoint_kernel',
              'ep_phased_tx_coh': 'receive_endpoint_coherent_kernel',
              'range_doppler': 'receive_doppler_power_kernelILb0ELb0E',
              'fmcw_sonar': 'receive_doppler_power_kernelILb0ELb0E',
              **{f'doppler_{t}': 'receive_doppler_power_kernelILb0ELb1E'
                 for t in ('sphere', 'disk', 'cylinder')},
              **{f'doppler_{g}': 'receive_doppler_power_kernelILb1ELb0E'
                 for g in ('checker', 'bitmap')},
              'doppler_sphere_checker':
                  'receive_doppler_power_kernelILb1ELb1E',
              'multi_body': 'receive_mesh_doppler_kernelILb0ELb0E',
              'mesh_lobes_iq': 'receive_mesh_doppler_kernelILb1ELb1E',
              'mesh_lobes_power': 'receive_mesh_doppler_kernelILb0ELb1E',
              'coherent_mesh': 'receive_mesh_doppler_kernelILb1ELb0E',
              'mesh': 'receive_mesh_kernel',
              'mimo': 'receive_mimo_array_kernel'}


def kernel_mix(dev, tag, build_log: str, cubin: str, config: str,
               geometry: tuple, sms: int, n_pulses: int = 1) -> dict:
    """A warp-wavefront kernel on one of its main paths (`tools/k1_mix.py`
    CONFIGS: the flagship kernel's, the coherent kernel's pulse train,
    dechirp and corner CPI, the lobe kernel's windowed corner in power
    and I / Q, or the endpoint kernels on the endpoint scenes): its
    launch geometry (`geometry`, a pulse's of
    `n_pulses`), its registers and spills (ptxas, from a fresh build's
    log), its SASS instruction mix by class and stage under the plain
    version's stage entries at 2^16 lanes, and the function's issue-slot
    bound at the path's lanes: the fewest lane-stage thread-instructions
    measured (`k1_mix.LEAST_STAGE_INSTRUCTIONS`), so that a kernel's own
    bookkeeping (its turns) does not raise its bound."""
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import k1_mix
    kernel = MIX_KERNEL[config]
    blocks, threads, smem = geometry
    fn, regs = '?', []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif kernel in fn and ('registers' in line or 'spill' in line):
            regs.append(line.strip())
    what = f'receive_megakernel ({kernel}, {config})'
    print(f'{what} ptxas: {" | ".join(regs)} {tag}')
    print(f'{what} geometry: {blocks} blocks a pulse x {n_pulses} pulses x '
          f'{threads} threads, {smem} B shared each; '
          f'{blocks * n_pulses / sms:g} blocks, '
          f'{blocks * n_pulses * threads / 32 / sms:g} warps an SM {tag}')
    if config == 'flagship':
        assert (k1_mix.DEPTH, k1_mix.SEED) == (MAX_DEPTH, SEED)
    n = 1 << 16
    masks, n_rect = k1_mix.stage_masks(n, device=dev.type, config=config)
    a = k1_mix.per_lane(masks, n)
    mix = k1_mix.sass_mix(cubin, k1_mix.source_of(HERE), kernel, a, n_rect,
                          os.path.join(HERE, 'chiprun_out',
                                       f'k1_sass_{config}.txt'), config,
                          k1_mix.pair_totals(masks))
    _, _, mhz, _ = k1_mix.card_clock_mhz()
    lanes = k1_mix.CONFIGS[config]['lanes']
    bi = mix['bound_instructions_a_lane']
    issue_ms = k1_mix.issue_slot_bound_ms(bi, lanes, mhz, sms)
    print(f'{what} SASS: {mix["instructions"]} instructions; by class a '
          f'lane ' + json.dumps(
              {k: round(v, 1) for k, v in
               mix['thread_instructions_a_lane_by_class'].items()}))
    print(f'{what} SASS by stage a lane ' + json.dumps(
        {k: round(v, 1) for k, v in
         mix['thread_instructions_a_lane_by_stage'].items()}))
    print(f'bound {config}, issue slots: {bi:.1f} thread-instructions a '
          f'lane (the fewest measured for the lane stages; this kernel '
          f'{mix["stage_instructions_a_lane"]:.1f} there and '
          f'{mix["thread_instructions_a_lane"]:.1f} in all) over {lanes} '
          f'lanes / 32 over {sms} SMs x 4 schedulers at {mhz:g} MHz = '
          f'{issue_ms:.4f} ms {tag}')
    return {'kernel': kernel, 'issue_slot_bound_ms': float(issue_ms),
            'thread_instructions_a_lane': float(
                mix['thread_instructions_a_lane']),
            'bound_instructions_a_lane': float(bi),
            'registers': ' | '.join(regs),
            'geometry': [blocks, threads, smem]}


def flagship(torch, bt, rk, dev, tag, pulse_compress, build_log: str,
             cubin: str) -> dict:
    from beifong_tpu_torch.scenes import flagship_scene, round_trip_bin
    s, rx = flagship_scene()
    sd = s.compile(device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    params_t = torch.tensor(packed.params, device=dev)
    prim_t = torch.tensor(packed.prim, device=dev)
    txp_t = torch.tensor(packed.txp, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(64, N_LANES, 4)
    print(f'receive_megakernel (flagship) geometry at 2^28 lanes: {blocks} '
          f'blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks ({blocks * threads / 32 / sms:g} warps) '
          f'per SM on {sms} SMs {tag}')

    # ---- 3. the kernel against its plain version ----
    nd = rk.n_draws(MAX_DEPTH)
    rel_errs, abs_errs = [], []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for ts in ('gate', 'fixed'):
        u = torch.rand((nd, PARITY_LANES), generator=gen, device=dev)
        kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling=ts,
                  rx_kind='wigner')
        acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                          n_lanes=PARITY_LANES, uniforms=u,
                                          **kw)
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params_t, prim_t, txp_t, u, **kw))
        c = compare(acc, n_ev, ref, n_ref, f'flagship injected {ts} 2^18 '
                    'lanes')
        rel_errs.append(c['rel'])
        print(f'plain version {ts}, 2^18 lanes: {ms:.1f} ms {tag}')

    kw = dict(adc=rx.adc, max_depth=MAX_DEPTH, time_sampling='gate',
              rx_kind='wigner')
    acc1, n1 = rk.receive_megakernel(params_t, prim_t, txp_t,
                                     n_lanes=N_LANES, seed=SEED, **kw)
    acc2, n2 = rk.receive_megakernel(params_t, prim_t, txp_t,
                                     n_lanes=N_LANES, seed=SEED, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(acc1, acc2) and int(n1) == int(n2)):
        fail('flagship: two Philox-mode calls with one seed differ')
    print('parity flagship philox 2^28 lanes: two calls bit-identical')

    # the plain version on the same Philox stream at the main path's shape
    stats: dict = {}

    def plain():
        total, n_tot = torch.zeros_like(acc1), 0
        for lane0 in range(0, N_LANES, PLAIN_CHUNK):
            u = rk.philox_uniforms(SEED, nd, PLAIN_CHUNK, device=dev,
                                   lane0=lane0)
            a, n = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                             stats=stats, **kw)
            total += a
            n_tot += int(n)
        return total, n_tot

    plain_ms, (ref, n_ref) = wall_ms(plain)
    c = compare(acc1, n1, ref, n_ref, 'flagship philox 2^28 lanes')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    print(f'plain version, 2^28 lanes in 2^22-lane chunks: '
          f'{plain_ms:.1f} ms {tag}')
    print('flagship stage lanes: ' + json.dumps(stats))

    # ---- 4. the main path ----
    anchor = round_trip_bin(s, rx)
    rk.receive_megakernel.launches = 0
    rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)

    def run_main(seed):
        return bt.receive(s, sd, rx, seed=seed, spp=N_LANES,
                          max_depth=MAX_DEPTH, time_sampling='gate',
                          device=dev)

    run_main(1)
    call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
    launches = rk.receive_megakernel.launches
    if launches < 6 or rk.receive_megakernel.by_config['flagship'] \
            != launches:
        fail(f'the flagship path launched receive_megakernel '
             f'{rk.receive_megakernel.by_config} in 6 receive() calls')
    check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, 'flagship')
    med = statistics.median(call_ms)
    print(f'receive() flagship 2^28 samples depth 3: median {med:.2f} '
          f'ms/call ({N_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]} {tag}')

    # kernel alone at the main path's shape (launches here do not count)
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params_t, prim_t, txp_t, n_lanes=N_LANES, seed=SEED, **kw), 5)
    k_med = statistics.median(k_ms)
    print(f'receive_megakernel (flagship) 2^28 lanes: median {k_med:.3f} '
          f'ms {[round(x, 3) for x in k_ms]} {tag}')

    n_rect = int((prim_t[:, 0] == 0).sum())
    n_bytes = 4 * (params_t.numel() + prim_t.numel() + txp_t.numel()
                   + rx.adc.n_time) + 8
    b = bound(lane_ops(stats, n_rect), n_bytes, 'flagship 2^28 lanes')
    mix = kernel_mix(dev, tag, build_log, cubin, 'flagship',
                     (blocks, threads, smem), sms)
    print(f'flagship bounds: FP32 {b["bound_ms"]:.4f} ms, issue slots '
          f'{mix["issue_slot_bound_ms"]:.4f} ms; kernel {k_med:.3f} ms '
          f'{tag}')
    return {
        'name': 'receive_megakernel', 'configuration': 'flagship',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106)',
        'launches': launches, 'max_abs_err': max(abs_errs),
        'parity': max(rel_errs), 'ms': k_med, 'plain_ms': plain_ms,
        **b, 'library_ms': None, **mix,
    }


def check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, what):
    prof = bt.develop_signal(adc, n, rx.adc)
    if tuple(prof.shape) != (rx.adc.n_time, 1, 1) \
            or not bool(torch.isfinite(prof).all()):
        fail(f'{what}: developed signal {tuple(prof.shape)} not finite / '
             f'wrong shape')
    p = prof[:, 0, 0]
    rep_n = max(2, int(round(2e-3 / (rx.adc.sampling_time / rx.adc.n_time))))
    comp = pulse_compress(p.to(torch.complex64),
                          torch.ones(rep_n, dtype=torch.complex64,
                                     device=p.device)).abs()
    pk, pk_c = int(p.argmax()), int(comp.argmax())
    print(f'{what} profile peak bin {pk}, compressed {pk_c}, 2R/c anchor '
          f'{anchor:.2f}')
    if abs(pk - anchor) > 2 or abs(pk_c - anchor) > 2:
        fail(f'{what}: range profile peaks at {pk} / {pk_c}, anchor '
             f'{anchor:.2f}')


def mesh(torch, bt, rk, dev, tag, pulse_compress, build_log: str,
         cubin: str) -> dict:
    from beifong_tpu_torch.scenes import mesh_scene, round_trip_bin
    s, rx = mesh_scene()
    sd = s.compile(device=dev)
    t0 = time.perf_counter()
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    pack_ms = (time.perf_counter() - t0) * 1e3
    mb = packed.mesh
    print(f'mesh scene: {sd.tris.n_faces} triangles, BVH {mb.n_nodes} '
          f'nodes, {mb.n_leaves} leaves, tables {4 * mb.bbox.numel()} + '
          f'{4 * mb.links.numel()} + {4 * mb.leaves.numel()} B; build + '
          f'pack {pack_ms:.0f} ms on the host')
    params_t = torch.tensor(packed.params, device=dev)
    params_t[0] = rk.seed_slot(SEED)
    prim_t = torch.tensor(packed.prim, device=dev)
    txp_t = torch.tensor(packed.txp, device=dev)
    mesh_t = mb.to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(64, MESH_LANES, 3, mesh=True)
    print(f'receive_megakernel (mesh) geometry at 2^24 lanes: {blocks} '
          f'blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')

    # ---- 3. the kernel against its plain version ----
    nd = rk.n_draws(MESH_DEPTH)
    rel_errs, abs_errs, flips = [], [], []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = dict(adc=rx.adc, max_depth=MESH_DEPTH, time_sampling='gate',
                rx_kind='wigner', mesh=mesh_t)
    for n_lanes, patch_p in ((1 << 16, 0), (1 << 20, 32)):
        if patch_p and rk.patch_p_for(n_lanes) != patch_p:
            fail(f'{n_lanes} lanes: strata P {rk.patch_p_for(n_lanes)}')
        u = torch.rand((nd, n_lanes), generator=gen, device=dev)
        kw = dict(base, patch_p=patch_p)
        lane = torch.empty(n_lanes, device=dev)
        lane_ref = torch.empty(n_lanes, device=dev)
        acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                          n_lanes=n_lanes, uniforms=u,
                                          lane_out=lane, **kw)
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params_t, prim_t, txp_t, u, lane_out=lane_ref, **kw))
        c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                          f'mesh injected 2^{n_lanes.bit_length() - 1} '
                          f'lanes, P {patch_p}')
        rel_errs.append(c['rel'])
        abs_errs.append(c['err'])
        flips.append(c['flips'])
        print(f'plain version mesh 2^{n_lanes.bit_length() - 1} lanes, P '
              f'{patch_p}: {ms:.1f} ms {tag}')

    n_b = MESH_BENCH_LANES
    kw = dict(base, patch_p=rk.patch_p_for(n_b))
    lane = torch.empty(n_b, device=dev)
    lane_ref = torch.empty(n_b, device=dev)
    acc1, n1 = rk.receive_megakernel(params_t, prim_t, txp_t, n_lanes=n_b,
                                     seed=SEED, lane_out=lane, **kw)
    acc2, n2 = rk.receive_megakernel(params_t, prim_t, txp_t, n_lanes=n_b,
                                     seed=SEED, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(acc1, acc2) and int(n1) == int(n2)):
        fail('mesh: two Philox-mode calls with one seed differ')
    print('parity mesh philox 2^20 lanes: two calls bit-identical')
    u = rk.philox_uniforms(SEED, nd, n_b, device=dev)
    ref, n_ref = rk.receive_megakernel_ref(params_t, prim_t, txp_t, u,
                                           lane_out=lane_ref, **kw)
    c = compare_lanes(acc1, n1, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                      'mesh philox 2^20 lanes, P 32')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    flips.append(c['flips'])

    # the plain version on the kernel's Philox stream at the main path's
    # shape, with its stage counts for the bound
    kw = dict(base, patch_p=rk.patch_p_for(MESH_LANES))
    stats: dict = {}
    lane_ref = torch.empty(MESH_LANES, device=dev)

    def plain():
        total, n_tot = torch.zeros((rx.adc.n_time, 1), device=dev), 0
        for lane0 in range(0, MESH_LANES, MESH_PLAIN_CHUNK):
            u = rk.philox_uniforms(SEED, nd, MESH_PLAIN_CHUNK, device=dev,
                                   lane0=lane0)
            a, n = rk.receive_megakernel_ref(
                params_t, prim_t, txp_t, u, lane0=lane0, stats=stats,
                lane_out=lane_ref[lane0:lane0 + MESH_PLAIN_CHUNK], **kw)
            total += a
            n_tot += int(n)
        return total, n_tot

    plain_ms, (ref, n_ref) = wall_ms(plain)
    lane = torch.empty(MESH_LANES, device=dev)
    acc, n_ev = rk.receive_megakernel(params_t, prim_t, txp_t,
                                      n_lanes=MESH_LANES, seed=SEED,
                                      lane_out=lane, **kw)
    c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, MESH_DEPTH,
                      'mesh philox 2^24 lanes, P 32')
    rel_errs.append(c['rel'])
    abs_errs.append(c['err'])
    flips.append(c['flips'])
    print(f'plain version mesh, 2^24 lanes in '
          f'2^{MESH_PLAIN_CHUNK.bit_length() - 1}-lane chunks: '
          f'{plain_ms:.1f} ms {tag}')
    print('mesh stage lanes: ' + json.dumps(stats))

    # ---- 4. the main path ----
    anchor = round_trip_bin(s, rx)
    rk.receive_megakernel.launches = 0
    rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)

    # each call's launch record: the mesh kernel (receive_mesh_kernel)
    record = []

    def run_main(seed):
        out = bt.receive(s, sd, rx, seed=seed, spp=MESH_LANES,
                         max_depth=MESH_DEPTH, time_sampling='gate',
                         device=dev)
        record.append(rk.launched_mesh_kernel())
        return out

    _, n0 = run_main(1)
    call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
    launches = rk.receive_megakernel.launches
    if launches < 6 or rk.receive_megakernel.by_config['mesh'] != launches \
            or n0 != MESH_LANES or n != MESH_LANES:
        fail(f'the mesh path launched receive_megakernel '
             f'{rk.receive_megakernel.by_config} in 6 receive() calls ({n} '
             'samples)')
    print(f'mesh path launch record: receive_mesh_kernel on '
          f'{sum(record)} of {len(record)} receive() calls')
    if len(record) != launches or not all(record):
        fail('mesh: the launch record does not show receive_mesh_kernel '
             'on every receive() call')
    check_profile(torch, bt, adc, n, rx, anchor, pulse_compress, 'mesh')
    med = statistics.median(call_ms)
    print(f'receive() mesh 2^24 samples depth 2: median {med:.3f} ms/call '
          f'({MESH_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]} {tag}')

    # the kernel alone (launches here do not count)
    k_med = None
    for n_lanes, depth in ((MESH_LANES, MESH_DEPTH), (n_b, 2), (n_b, 1)):
        kwd = dict(base, max_depth=depth, patch_p=rk.patch_p_for(n_lanes))
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
            params_t, prim_t, txp_t, n_lanes=n_lanes, seed=SEED, **kwd), 6)
        med_k = statistics.median(k_ms[1:])
        k_med = k_med if k_med is not None else med_k
        print(f'receive_megakernel (mesh) 2^{n_lanes.bit_length() - 1} '
              f'lanes depth {depth}: median {med_k:.3f} ms '
              f'({n_lanes / (med_k * 1e-3):.4e} samples/s) '
              f'{[round(x, 3) for x in k_ms[1:]]} {tag}')

    n_rect = int((prim_t[:, 0] == 0).sum())
    n_bytes = 4 * (params_t.numel() + prim_t.numel() + txp_t.numel()
                   + mesh_t.bbox.numel() + mesh_t.links.numel()
                   + mesh_t.leaves.numel() + rx.adc.n_time) + 8
    b = bound(lane_ops(stats, n_rect), n_bytes, 'mesh 2^24 lanes')
    mix = kernel_mix(dev, tag, build_log, cubin, 'mesh',
                     (blocks, threads, smem), sms) if cubin else {}
    return {
        'name': 'receive_megakernel', 'configuration': 'mesh',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106), has_mesh',
        'launches': launches, 'max_abs_err': max(abs_errs),
        'parity': max(rel_errs), 'lanes_on_another_path': flips,
        'ms': k_med, 'plain_ms': plain_ms, **b, 'library_ms': None,
        'repeat_bit_identical': True, **mix,
    }


def _bin_coord(value, lo, hi, n):
    """Continuous bin-centre coordinate of value on [lo, hi) in n bins."""
    return (value - lo) / (hi - lo) * n - 0.5


def multi_body_anchors(s, cfg) -> list:
    """(name, time bin, Doppler bin, Doppler Hz) of each multi_body body:
    its bistatic delay plus half the 2 ms pulse, its bistatic Doppler."""
    import numpy as np
    from beifong_tpu_torch.scenes import MULTI_BODY
    tx_pos = np.array([0.3, 0.0, 0.0])
    rx_pos = np.array([-0.3, 0.0, 0.0])
    fc = 40e3
    t_half = 1e-3        # half the 2 ms pulse: the echo's centre
    out = []
    for name, p, vel in (
            ('body 1 (diffuse, static)', np.array([0.0, -MULTI_BODY['R1'],
                                                   0.0]), np.zeros(3)),
            ('body 2 (conductor, closing)',
             np.array([0.0, -MULTI_BODY['R2'], MULTI_BODY['lift2']]),
             np.array([0.0, MULTI_BODY['v2'], 0.0]))):
        tau = (np.linalg.norm(p - tx_pos) + np.linalg.norm(p - rx_pos)) \
            / s.band.c
        u_tx = (tx_pos - p) / np.linalg.norm(tx_pos - p)
        u_rx = (rx_pos - p) / np.linalg.norm(rx_pos - p)
        f_dop = fc * (vel @ u_tx + vel @ u_rx) / s.band.c
        t_bin = _bin_coord(tau + t_half, cfg.sampling_start,
                           cfg.sampling_start + cfg.sampling_time,
                           cfg.n_time)
        f_bin = _bin_coord(fc + f_dop, cfg.freq_lo, cfg.freq_hi, cfg.n_freq)
        out.append((name, t_bin, f_bin, f_dop))
    return out


def _window(grid, t_bin):
    """The body's range gate: time rows round(t_bin) - 1 .. + 1."""
    tb = int(round(t_bin))
    return slice(max(tb - 1, 0), tb + 2)


def check_multi_body(torch, grid, s, cfg, what):
    """Each body in its range gate at its Doppler (within one bin)."""
    if tuple(grid.shape) != (cfg.n_time, cfg.n_freq) \
            or not bool(torch.isfinite(grid).all()):
        fail(f'{what}: multi_body grid {tuple(grid.shape)} not finite / '
             'wrong shape')
    g = grid.cpu().double().numpy()
    for name, t_bin, f_bin, f_dop in multi_body_anchors(s, cfg):
        fpk = int(g[_window(g, t_bin)].sum(axis=0).argmax())
        tpk = int(g[:, fpk].argmax())
        print(f'{what} {name}: range gate {t_bin:.2f} (peak {tpk}), Doppler '
              f'{f_dop:+.1f} Hz at bin {f_bin:.2f} (peak {fpk})')
        if abs(fpk - f_bin) > 1 or abs(tpk - t_bin) > 1:
            fail(f'{what} multi_body {name}: peak at time {tpk} / Doppler '
                 f'{fpk}, expected {t_bin:.2f} / {f_bin:.2f}')


def check_range_doppler(torch, grid, s, cfg, what):
    """The plate's echo at fc (1 + 2 v_r / c): the Doppler bin of the
    spectrum summed over the (CW) fast-time bins, within one bin."""
    import numpy as np
    from beifong_tpu_torch.scenes import RANGE_DOPPLER
    if tuple(grid.shape) != (cfg.n_time, cfg.n_freq) \
            or not bool(torch.isfinite(grid).all()):
        fail(f'{what}: grid {tuple(grid.shape)} not finite / wrong shape')
    p = np.array([0.0, -RANGE_DOPPLER['R0'], 0.0])
    vel = np.array([0.0, RANGE_DOPPLER['v'], 0.0])
    fc = 40e3
    f_dop = sum(fc * (vel @ ((e - p) / np.linalg.norm(e - p))) / s.band.c
                for e in (np.array([0.3, 0, 0]), np.array([-0.3, 0, 0])))
    f_bin = _bin_coord(fc + f_dop, cfg.freq_lo, cfg.freq_hi, cfg.n_freq)
    spec = grid.cpu().double().sum(0)
    fpk = int(spec.argmax())
    f_2v = 2 * RANGE_DOPPLER['v'] / s.band.c * fc
    print(f'{what} plate: Doppler {f_dop:+.1f} Hz (2v/c fc {f_2v:.1f} Hz) '
          f'at bin {f_bin:.2f} (peak {fpk})')
    if abs(fpk - f_bin) > 1:
        fail(f'{what}: Doppler peak at bin {fpk}, expected {f_bin:.2f}')
    # CA-CFAR (dsp/cfar.py) on the map, Doppler rows by range columns, on
    # the grid's device: its detections hold the plate's cell (the anchored
    # Doppler bin, within one, at the range bin where its column peaks)
    from beifong_tpu_torch.dsp import ca_cfar_2d
    rd_map = grid.T.contiguous()
    ms, (det, thresh) = wall_ms(lambda: ca_cfar_2d(rd_map))
    t_pk = int(grid[:, int(round(f_bin))].argmax())
    f0 = int(round(f_bin))
    found = bool(det[max(f0 - 1, 0):f0 + 2, t_pk].any())
    print(f'{what} CA-CFAR ({det.device}): {int(det.sum())} detections of '
          f'{det.numel()} cells, Doppler bins '
          f'{sorted(set(det.nonzero()[:, 0].tolist()))}; the plate\'s cell '
          f'(Doppler {f0}, range {t_pk}) detected {found}; {ms:.3f} ms')
    if not found or not bool(torch.isfinite(thresh).all()):
        fail(f'{what}: CA-CFAR misses the plate\'s cell (Doppler {f0}, '
             f'range {t_pk})')


def _doppler_tables(torch, rk, scene_fn, dev):
    s, rx = scene_fn()
    sd = s.compile(use_bvh=False, device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    if not packed.doppler(rx.adc):
        fail(f'{scene_fn.__name__}: expected the Doppler configuration')
    params = torch.tensor(packed.params, device=dev)
    params[0] = rk.seed_slot(SEED)
    mesh = None if packed.mesh is None else packed.mesh.to(dev)
    kw = dict(adc=rx.adc, max_depth=DOP_DEPTH, time_sampling='gate',
              rx_kind='wigner', mesh=mesh, doppler=True,
              msh=None if mesh is None else torch.tensor(packed.msh,
                                                         device=dev),
              mirror=packed.mirror)
    return (s, sd, rx, params, torch.tensor(packed.prim, device=dev),
            torch.tensor(packed.txp, device=dev), kw)


def doppler(torch, bt, rk, ik, dev, tag, build_log: str, cubin: str):
    """The Doppler configuration of K1: parity, the main paths, the kernel
    alone (the analytic scenes' the Doppler power kernel, which the
    launch record shows ran).  Returns (two kernel entries, K1's developed
    multi_body grid at WF_SAMPLES for the comparison with the
    wavefront)."""
    import dataclasses as dc
    from beifong_tpu_torch.scenes import (flagship_scene, multi_body_scene,
                                          range_doppler_scene)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 3. parity on injected uniforms: multi_body lane by lane, the
    #      range-Doppler pulse, a wide fast-time grid, the global grid ----
    def variant(scene_fn, **adc):
        def fn():
            s, rx = scene_fn()
            rx = dc.replace(rx, adc=dc.replace(rx.adc, **adc))
            s.receivers[0] = rx
            return s, rx
        fn.__name__ = scene_fn.__name__
        return fn

    errs = {'doppler_mesh': [], 'doppler': []}
    for what, fn, n_lanes, depth in (
            ('multi_body', multi_body_scene, MB_PARITY_LANES, DOP_DEPTH),
            ('range_doppler', range_doppler_scene, RD_PARITY_LANES,
             DOP_DEPTH),
            ('flagship 1024 bins', variant(flagship_scene, n_time=1024),
             RD_PARITY_LANES, 3),
            # past MAX_SMEM_CELLS; its cells still average ~10^2 taps: on
            # a sparse grid one ulp of a float32 frequency (4 mHz at 41
            # kHz) moves a tap weight by ~1e-4 at 256 bins over 4 kHz,
            # and the per-cell tolerance would measure that, not the kernel
            ('range_doppler 256 x 128 (global grid)',
             variant(range_doppler_scene, n_time=256, n_freq=128),
             RD_PARITY_LANES, DOP_DEPTH),
            # 2^19 cells: a cell holds a few lanes' taps, so ulps of a
            # tap's coordinate move it past TOL of max|acc|; held lane by
            # lane, each cell also within `coord_slack` of its |power|
            (LARGE_GRID_WHAT, variant(range_doppler_scene, n_time=4096,
                                      n_freq=128), RD_PARITY_LANES,
             DOP_DEPTH)):
        s, sd, rx, params, prim, txp, kw = _doppler_tables(torch, rk, fn,
                                                           dev)
        kw = dict(kw, max_depth=depth)
        u = torch.rand((rk.n_draws(depth), n_lanes), generator=gen,
                       device=dev)
        lane = torch.empty(n_lanes, device=dev)
        lane_ref = torch.empty(n_lanes, device=dev)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=dev)
        acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                          uniforms=u, lane_out=lane, **kw)
        if rk.launched_doppler_power_kernel() != (kw['mesh'] is None):
            fail(f'doppler {what}: the launch record does not show the '
                 f'Doppler power kernel on an analytic scene alone')
        if rk.launched_mesh_doppler_kernel() != (kw['mesh'] is not None):
            fail(f'doppler {what}: the launch record does not show the '
                 f'mesh Doppler kernel on multi_body alone')
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params, prim, txp, u, lane_out=lane_ref, amp_out=amp, **kw))
        mode = rk.grid_mode(rx.adc.n_time * rx.adc.n_freq, True)
        name = f'doppler {what} injected 2^{n_lanes.bit_length() - 1} ' \
            f'lanes (grid mode {mode})'
        if kw['mesh'] is not None:
            c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, depth,
                              name)
            errs['doppler_mesh'].append(c)
        elif what == LARGE_GRID_WHAT:
            errs['doppler'].append(compare_lanes(
                acc, n_ev, lane, ref, n_ref, lane_ref, depth, name,
                rk.coord_slack(rx.adc) * amp.float()))
        else:
            errs['doppler'].append(compare(acc, n_ev, ref, n_ref, name))
        print(f'plain version {what}: {ms:.1f} ms {tag}')

    entries, k1_grid = [], None
    for cfg_name, what, fn, check in (
            ('doppler_mesh', 'multi_body', multi_body_scene,
             check_multi_body),
            ('doppler', 'range_doppler', range_doppler_scene,
             check_range_doppler)):
        s, sd, rx, params, prim, txp, kw = _doppler_tables(torch, rk, fn,
                                                           dev)
        mesh = kw['mesh']
        n_msh = 0 if kw['msh'] is None else int(kw['msh'].shape[0])
        blocks, threads, smem = rk.launch_geometry(
            rx.adc.n_time, DOP_LANES, int(prim.shape[0]),
            mesh=mesh is not None, n_freq=rx.adc.n_freq, n_msh=n_msh,
            doppler=True)
        print(f'receive_megakernel ({cfg_name}) geometry at 2^24 lanes: '
              f'{blocks} blocks x {threads} threads, {smem} B shared each, '
              f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')
        if mesh is not None:
            kw['patch_p'] = rk.patch_p_for(DOP_LANES)
        # two Philox calls with one seed: atomics add in arrival order
        lane = torch.empty(DOP_LANES, device=dev)
        acc1, n1 = rk.receive_megakernel(params, prim, txp,
                                         n_lanes=DOP_LANES, seed=SEED,
                                         lane_out=lane, **kw)
        acc2, n2 = rk.receive_megakernel(params, prim, txp,
                                         n_lanes=DOP_LANES, seed=SEED, **kw)
        torch.cuda.synchronize()
        scale = float(acc1.abs().max())
        rep = float((acc1 - acc2).abs().max())
        print(f'parity {what} philox 2^24 lanes: two calls differ by at most '
              f'{rep:.3e} ({rep / max(scale, 1e-300):.3e} of max|acc|) per '
              f'cell, events {int(n1)} / {int(n2)}')
        if not (scale > 0 and rep <= REPEAT_TOL * scale
                and int(n1) == int(n2)):
            fail(f'{what}: two Philox-mode calls with one seed differ')
        # the plain version on the kernel's Philox stream at the main
        # path's shape, with its stage counts for the bound
        stats: dict = {}
        lane_ref = torch.empty(DOP_LANES, device=dev)
        nd = rk.n_draws(DOP_DEPTH)
        chunk = DOP_PLAIN_CHUNK if mesh is None else MESH_PLAIN_CHUNK

        def plain():
            total = torch.zeros((rx.adc.n_time, rx.adc.n_freq), device=dev)
            n_tot = 0
            for lane0 in range(0, DOP_LANES, chunk):
                u = rk.philox_uniforms(SEED, nd, chunk, device=dev,
                                       lane0=lane0)
                a, n = rk.receive_megakernel_ref(
                    params, prim, txp, u, lane0=lane0, stats=stats,
                    lane_out=lane_ref[lane0:lane0 + chunk], **kw)
                total += a
                n_tot += int(n)
            return total, n_tot

        plain_ms, (ref, n_ref) = wall_ms(plain)
        name = f'doppler {what} philox 2^24 lanes'
        if mesh is not None:
            c = compare_lanes(acc1, n1, lane, ref, n_ref, lane_ref, DOP_DEPTH,
                              name + f', P {kw["patch_p"]}')
        else:
            c = compare(acc1, n1, ref, n_ref, name)
        errs[cfg_name].append(c)
        print(f'plain version {what}, 2^24 lanes in '
              f'2^{chunk.bit_length() - 1}-lane chunks: {plain_ms:.1f} ms '
              f'{tag}')
        print(f'{what} stage lanes: ' + json.dumps(stats))

        # ---- 4. the main path: receive() ----
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)
        ik.ray_triangle_closest.launches = ik.ray_triangle_any.launches = 0

        def run_main(seed):
            return bt.receive(s, sd, rx, seed=seed, spp=DOP_LANES,
                              max_depth=DOP_DEPTH, time_sampling='gate',
                              device=dev)

        _, n0 = run_main(1)
        call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
        launches = rk.receive_megakernel.launches
        by_cfg = dict(rk.receive_megakernel.by_config)
        if rk.launched_doppler_power_kernel() != (mesh is None):
            fail(f'the {what} path: the launch record does not show the '
                 f'Doppler power kernel on the analytic scene alone')
        if rk.launched_mesh_doppler_kernel() != (mesh is not None):
            fail(f'the {what} path: the launch record does not show the '
                 f'mesh Doppler kernel on multi_body alone')
        k4 = (ik.ray_triangle_closest.launches, ik.ray_triangle_any.launches)
        if launches < 6 or by_cfg[cfg_name] != launches or k4 != (0, 0) \
                or n0 != DOP_LANES or n != DOP_LANES:
            fail(f'the {what} path launched K1 {by_cfg}, K4 {k4} in 6 '
                 f'receive() calls ({n} samples)')
        med = statistics.median(call_ms)
        print(f'receive() {what} 2^24 samples depth 2: median {med:.3f} '
              f'ms/call ({DOP_LANES / (med * 1e-3):.4e} samples/s), calls '
              f'{[round(x, 3) for x in call_ms]}; K1 launches {by_cfg}, K4 '
              f'{k4} {tag}')
        grid = bt.develop_signal(adc, n, rx.adc)[..., 0]
        check(torch, grid, s, rx.adc, f'receive() {what}')

        # the kernel alone (launches here do not count)
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
            params, prim, txp, n_lanes=DOP_LANES, seed=SEED, **kw), 6)
        k_med = statistics.median(k_ms[1:])
        print(f'receive_megakernel ({cfg_name}) 2^24 lanes depth 2: median '
              f'{k_med:.3f} ms ({DOP_LANES / (k_med * 1e-3):.4e} samples/s) '
              f'{[round(x, 3) for x in k_ms[1:]]} {tag}')

        if mesh is not None:
            # K1 at the wavefront phase's sample count, for the comparison
            a, nn = bt.receive(s, sd, rx, seed=3, spp=WF_SAMPLES,
                               max_depth=WF_DEPTH, time_sampling='gate',
                               device=dev)
            k1_grid = bt.develop_signal(a, nn, rx.adc)[..., 0]

        n_rect = int((prim[:, 0] == 0).sum())
        tab = [params, prim, txp] + ([] if mesh is None else [
            kw['msh'], mesh.bbox, mesh.links, mesh.leaves])
        n_bytes = 4 * (sum(t.numel() for t in tab)
                       + rx.adc.n_time * rx.adc.n_freq) + 8
        b = bound(lane_ops(stats, n_rect), n_bytes, f'{what} 2^24 lanes')
        # the Doppler power kernel's and the mesh Doppler kernel's
        # issue-slot bounds (tools/k1_mix.py)
        mix = kernel_mix(dev, tag, build_log, cubin,
                         'range_doppler' if mesh is None else 'multi_body',
                         (blocks, threads, smem), sms) if cubin else {}
        entries.append({
            'name': 'receive_megakernel',
            'configuration': cfg_name.replace('_', ' '), 'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': '_make_kernel (pallas_receive.py:106), moving, '
            'ggx, 2-D splat' + (', has_mesh' if mesh is not None else ''),
            'main_path': f'receive({what}_scene()), 2^24 samples, depth 2',
            'launches': launches,
            'max_abs_err': max(c['err'] for c in errs[cfg_name]),
            'parity': max(c['rel'] for c in errs[cfg_name]),
            'repeat_rel': rep / scale, 'ms': k_med, 'plain_ms': plain_ms,
            'receive_ms': med, **b, 'library_ms': None, **mix})
    return entries, k1_grid


def compare_coherent(torch, acc, n_ev, ref, n_ref, amp, slack, what,
                     lane=None, lane_ref=None, depth=COH_DEPTH,
                     quiet=False, ill=None, cond=None, check=True) -> dict:
    """I / Q parity per cell and channel: within TOL x max(|I|, |Q|) plus
    the phase slack (`receive_kernel.phase_slack`) times the cell's sum of
    amplitudes `amp` (the plain version's), since the kernel's contracted
    path lengths move each phase by a few ulps of the path over the
    wavelength.  With `lane`, lane by lane as `compare_lanes`, flagging
    lanes beyond TOL of themselves and COH_LANE_FLOOR of the largest.
    `cond` (the plain version's `cond_out`) widens each cell's phase
    slack term to the slack times (amp + cond): each ill-conditioned
    connection's own slack, from its vertices' incidence cosines and
    curvatures; the reading without it is printed beside (`worst_plain`).
    `check` False returns the readings without failing."""
    scale = float(ref.abs().max())
    bound = TOL * scale + slack * amp.float()[..., None]
    plain_bound = bound
    if cond is not None:
        bound = bound + slack * cond.float()[..., None]
    flips, flip_slack = 0, 0.0
    if lane is not None:
        flipped = (lane - lane_ref).abs() > \
            TOL * lane_ref.abs() + COH_LANE_FLOOR * float(lane_ref.abs().max())
        flips = int(flipped.sum())
        if ill is not None:
            flipped_out = int((flipped & ~ill).sum())
        flip_slack = float((lane.abs() + lane_ref.abs())[flipped].sum())
    diff = (acc - ref).abs()
    err = float(diff.max())
    worst = float((diff / (bound + flip_slack)).max())
    worst_plain = float((diff / (plain_bound + flip_slack)).max())
    ev, ev_ref = int(n_ev), int(n_ref)
    if not quiet:
        print(f'parity {what}: max(|I|, |Q|) {scale:.6e}  max abs err '
              f'{err:.3e} ({err / max(scale, 1e-300):.3e} of max; worst '
              f'cell at {worst:.3f} of its bound, phase slack {slack:.3e} '
              f'rad, largest amplitude sum '
              f'{float(amp.max()) / max(scale, 1e-300):.2f} x max)  events '
              f'{ev} vs {ev_ref}'
              + ('' if lane is None else f'; {flips} of {lane.numel()} '
                 f'lanes took another path')
              + ('' if cond is None else f'; without the connections\' own '
                 f'slack {worst_plain:.3f} of the bound'))
    if check and lane is not None \
            and (flips if ill is None else flipped_out) \
            > EDGE_FLIPS * lane.numel():
        fail(f'{what}: {flips} lanes differ from the plain version')
    if check and not (scale > 0 and worst <= 1.0):
        fail(f'{what}: kernel differs from the plain version (worst cell '
             f'{worst:.3f} of its bound)')
    if check and abs(ev - ev_ref) > TOL * ev_ref + 2 * depth * flips:
        fail(f'{what}: event counts {ev} vs {ev_ref}')
    return dict(err=err, rel=err / scale, worst=worst, flips=flips,
                worst_plain=worst_plain)


def _coh_tables(torch, rk, scene_fn, dev, coherent):
    s, rx = scene_fn()
    sd = s.compile(use_bvh=False, device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    params = torch.tensor(packed.params, device=dev)
    params[0] = rk.seed_slot(SEED)
    mesh = None if packed.mesh is None else packed.mesh.to(dev)
    kw = dict(adc=rx.adc, max_depth=COH_DEPTH, time_sampling='gate',
              rx_kind='wigner', mesh=mesh, doppler=True,
              msh=None if mesh is None else torch.tensor(packed.msh,
                                                         device=dev),
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, coherent=coherent,
              mirror=packed.mirror)
    return (s, sd, rx, params, torch.tensor(packed.prim, device=dev),
            torch.tensor(packed.txp, device=dev), kw)


def _chirp_h(stats, txp):
    """Each echo phase of a chirp adds the quadratic term to its h's."""
    if float(txp[0, 16]) == 2.0:       # LINFMCW
        stats['h_chirp'] = stats['phase'] + stats['phase_lo']
    return stats


def scaled_stats(stats: dict, factor: int) -> dict:
    """The stage counts of a plain-version run over the first 1 / factor
    of a path's Philox lanes, scaled to the path's lanes for its bound:
    the lanes are independent draws, so each count's share of them is the
    whole path's to sampling noise (a few 1e-4 at 2^22 lanes)."""
    return {k: v * factor for k, v in stats.items()}


class _Wavefront:
    """Counts the wavefront passes of receive() (or, `name`
    '_receive_mimo_pass', receive_mimo()) calls: a path that runs K1 must
    make none."""

    def __init__(self, bt, name='_receive_pass'):
        import importlib
        self.mod = importlib.import_module('beifong_tpu_torch.receive')
        self.name = name
        self.calls = 0

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)
        setattr(self.mod, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)
        return False


def _kernel_entry(torch, rk, cfg_name, what, main_path, launches, errs,
                  k_ms, plain_ms, recv_ms, stats, tables, n_cells, n_ch,
                  extra=None) -> dict:
    n_rect = int((tables[1][:, 0] == 0).sum())
    n_bytes = 4 * (sum(t.numel() for t in tables) + n_cells * n_ch) + 8
    b = bound(lane_ops(stats, n_rect), n_bytes, what)
    entry = {
        'name': 'receive_megakernel', 'configuration': cfg_name,
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106), '
        + cfg_name, 'main_path': main_path, 'launches': launches,
        'max_abs_err': max(c['err'] for c in errs),
        'parity': max(c['rel'] for c in errs), 'ms': k_ms,
        'plain_ms': plain_ms, 'receive_ms': recv_ms, **b,
        'library_ms': None}
    entry.update(extra or {})
    return entry


def _plain_philox(torch, rk, params, prim, txp, kw, n_lanes, depth, dev,
                  lane_ref=None, power_amp=False, chunk=COH_PLAIN_CHUNK,
                  cond=None):
    """The plain version on the kernel's Philox stream at the main path's
    shape, in `chunk`-lane chunks: (acc, events, amplitude sums (of
    |power| with `power_amp`), stage counts, ms); `cond`, a float64 grid,
    takes its `cond_out`."""
    stats: dict = {}
    nd = rk.n_draws(depth, int(txp.shape[-2]),
                    **rk.lobe_draws(kw.get('lobes') or 0))
    cfg = kw['adc']
    amp = torch.zeros((cfg.n_time, cfg.n_freq), dtype=torch.float64,
                      device=dev)

    def plain():
        total, n_tot = None, 0
        for lane0 in range(0, n_lanes, chunk):
            u = rk.philox_uniforms(SEED, nd, chunk, device=dev, lane0=lane0)
            a, n = rk.receive_megakernel_ref(
                params, prim, txp, u, lane0=lane0, stats=stats,
                amp_out=amp if kw.get('coherent') or power_amp
                or kw.get('eoff') is not None else None,
                lane_out=None if lane_ref is None
                else lane_ref[lane0:lane0 + chunk], cond_out=cond, **kw)
            total = a if total is None else total + a
            n_tot += int(n)
        return total, n_tot

    ms, (ref, n_ref) = wall_ms(plain)
    return ref, n_ref, amp, _chirp_h(stats, txp), ms


def _twin_tables(rk, dev, names, scene_fn) -> dict:
    """The scenes of a twin phase on the card: name -> (scene, compiled
    scene, receiver, device tables)."""
    tabs = {}
    for name in names:
        s, rx = scene_fn(name)
        sd = s.compile(device=dev)
        tabs[name] = (s, sd, rx, rk._device_tables(s, sd, rx, dev))
    return tabs


def _twin_parity(torch, rk, dev, tab, kw, n_lanes, u, record, what, tag, *,
                 chunk, lanes=False, cond=False, floor=1e-6, prims=None):
    """One launch of a K1 twin against its plain version on the same
    draws: the injected uniforms `u`, or (None) the Philox stream in
    `chunk`-lane pieces.  Power per cell (`compare`), or with `lanes` lane
    by lane (`compare_lanes`, a lane's floor `floor`); I / Q
    (`kw['coherent']`) with the phase slack (`compare_coherent`, with
    `lanes` lane by lane in amplitude), with `cond` also each
    ill-conditioned connection's own (the plain version's `cond_out`; the
    reading without it printed beside).  `record()`, read after the
    launch, must show the twin; `prims` as `receive_megakernel`'s.
    Returns (the comparison, the Philox
    run's stage counts or None, the plain version's ms)."""
    s, _, rx, t = tab
    coh, depth = bool(kw.get('coherent')), kw['max_depth']
    lane, lane_ref = (torch.empty(n_lanes, device=dev),
                      torch.empty(n_lanes, device=dev)) if lanes \
        else (None, None)
    acc, n_ev = rk.receive_megakernel(t.params, t.prim, t.txp,
                                      n_lanes=n_lanes, seed=SEED, uniforms=u,
                                      prims=prims, lane_out=lane, **kw)
    torch.cuda.synchronize()
    if not record():
        fail(f'{what}: the launch record does not show its twin')
    grid = (rx.adc.n_time, rx.adc.n_freq)
    c_out = torch.zeros(grid, dtype=torch.float64, device=dev) \
        if coh and cond else None
    stats = None
    if u is not None:
        amp = torch.zeros(grid, dtype=torch.float64, device=dev) \
            if coh else None
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            t.params, t.prim, t.txp, u, amp_out=amp, cond_out=c_out,
            lane_out=lane_ref, **kw))
    else:
        ref, n_ref, amp, stats, ms = _plain_philox(
            torch, rk, t.params, t.prim, t.txp, kw, n_lanes, depth, dev,
            lane_ref=lane_ref, chunk=chunk, cond=c_out)
    if coh:
        c = compare_coherent(torch, acc, n_ev, ref, n_ref, amp,
                             rk.phase_slack(s.band, rx.adc), what, lane,
                             lane_ref, depth=depth, cond=c_out)
        if c_out is not None:
            c['cond_share'] = float(c_out.sum() / amp.sum())
            print(f'{what}: the ill-conditioned connections\' own slack '
                  f'adds {c["cond_share"]:.4f} x the amplitude-weighted '
                  'phase slack')
    elif lanes:
        c = compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, depth, what,
                          floor=floor)
    else:
        c = compare(acc, n_ev, ref, n_ref, what)
    print(f'plain version {what}'
          + ('' if u is not None else
             f' in 2^{chunk.bit_length() - 1}-lane chunks')
          + f': {ms:.1f} ms' + ('' if stats is None else
                                 '; stage lanes ' + json.dumps(stats))
          + f' {tag}')
    return c, stats, ms


def _alternating(fns: dict, pairs: int, reps: int = 3) -> dict:
    """Each call of `fns` (key -> fn()) timed with CUDA events, `reps`
    calls a turn less the first, in `pairs` rounds in the same process
    whose order alternates; the median ms of each key."""
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(pairs):
        for k in (keys if i % 2 == 0 else keys[::-1]):
            t_ms, _ = cuda_ms(lambda j: fns[k](), reps)
            times[k].extend(t_ms[1:])
    return {k: statistics.median(v) for k, v in times.items()}


def coherent(torch, bt, rk, ik, dev, tag, build_log: str,
             cubin: str) -> list:
    """K1's coherent configuration and the LO receive types: parity, the
    main paths (FMCW sonar, the pulse train, the dechirp chain, a coherent
    mesh), the kernels alone, K1 against the wavefront."""
    import numpy as np
    from beifong_tpu_torch.dsp import rangedoppler as rd
    from beifong_tpu_torch.dsp import resample, windows
    from beifong_tpu_torch.scenes import (
        DECHIRP, FMCW, FMCW_SONAR_R, PULSE_TRAIN, flagship_scene,
        fmcw_beat_hz, fmcw_dechirp_scene, fmcw_scene, fmcw_sonar_scene,
        mesh_scene, pulse_train_scene, round_trip_bin)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def reset():
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)
        ik.ray_triangle_closest.launches = ik.ray_triangle_any.launches = 0

    # ---- 3. parity on injected uniforms ----
    errs = {'doppler': [], 'coherent': [], 'coherent_mesh': []}
    for what, fn, ts, coh, n_lanes in (
            ('fmcw_sonar (mix_resample, power)', fmcw_sonar_scene, 'fixed',
             False, COH_PARITY_LANES),
            ('fmcw mixer (I / Q)', lambda: fmcw_scene('mixer'), 'fixed',
             True, COH_PARITY_LANES),
            ('fmcw raw_resample (power)', lambda: fmcw_scene('raw_resample'),
             'fixed', False, COH_PARITY_LANES),
            ('pulse train p 0 (I / Q, moving)', pulse_train_scene, 'gate',
             True, COH_PARITY_LANES),
            ('flagship (I / Q)', flagship_scene, 'gate', True,
             COH_PARITY_LANES),
            ('dechirp 1024 bins (I / Q)', fmcw_dechirp_scene, 'gate', True,
             COH_PARITY_LANES),
            ('mesh_scene (I / Q)', mesh_scene, 'gate', True,
             COH_MESH_PARITY_LANES)):
        s, sd, rx, params, prim, txp, kw = _coh_tables(torch, rk, fn, dev,
                                                       coh)
        kw['time_sampling'] = ts
        u = torch.rand((rk.n_draws(COH_DEPTH), n_lanes), generator=gen,
                       device=dev)
        lane = torch.empty(n_lanes, device=dev)
        lane_ref = torch.empty(n_lanes, device=dev)
        amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                          dtype=torch.float64, device=dev)
        acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_lanes,
                                          uniforms=u, lane_out=lane, **kw)
        mesh = kw['mesh'] is not None
        if rk.launched_doppler_power_kernel() != (not coh and not mesh):
            fail(f'{what}: the launch record does not show the Doppler '
                 f'power kernel on an analytic power scene alone')
        if rk.launched_mesh_doppler_kernel(False, coh) != mesh:
            fail(f'{what}: the launch record does not show the mesh '
                 f'Doppler kernel on the mesh alone')
        ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
            params, prim, txp, u, lane_out=lane_ref,
            amp_out=amp if coh else None, **kw))
        name = (f'{what} injected 2^{n_lanes.bit_length() - 1} lanes, '
                f'{ts} (grid mode '
                f'{rk.grid_mode(rx.adc.n_time * rx.adc.n_freq, True, coh)})')
        cfg_name = rk.config_name(mesh, True, coh)
        if coh:
            errs[cfg_name].append(compare_coherent(
                torch, acc, n_ev, ref, n_ref, amp,
                rk.phase_slack(s.band, rx.adc), name,
                lane if mesh else None, lane_ref if mesh else None))
        else:
            errs[cfg_name].append(compare(acc, n_ev, ref, n_ref, name))
        print(f'plain version {what}: {ms:.1f} ms {tag}')

    entries = []

    # ---- 4a. FMCW sonar (golden config 2): power, mix_resample ----
    s, sd, rx, params, prim, txp, kw = _coh_tables(
        torch, rk, fmcw_sonar_scene, dev, False)
    kw['time_sampling'] = 'fixed'
    f_beat = fmcw_beat_hz(FMCW_SONAR_R)
    f_axis = (np.arange(rx.adc.n_freq) + 0.5) / rx.adc.n_freq * (4 * f_beat)
    want = int(np.argmin(np.abs(f_axis - f_beat)))
    reset()
    with _Wavefront(bt) as wfc:
        bt.receive(s, sd, rx, seed=1, spp=COH_LANES, max_depth=COH_DEPTH,
                   device=dev)
        call_ms, (adc, n) = cuda_ms(lambda i: bt.receive(
            s, sd, rx, seed=2 + i, spp=COH_LANES, max_depth=COH_DEPTH,
            device=dev), 5)
    launches = rk.receive_megakernel.by_config['doppler']
    if launches != 6 or rk.receive_megakernel.launches != 6 or wfc.calls:
        fail(f'fmcw_sonar path launched K1 {rk.receive_megakernel.by_config}'
             f', the wavefront {wfc.calls} times in 6 receive() calls')
    spec = bt.develop_signal(adc, n, rx.adc).sum(0)[:, 0]
    if tuple(adc.shape) != (16, 256, 3) or not bool(
            torch.isfinite(adc).all()):
        fail(f'fmcw_sonar: grid {tuple(adc.shape)} not finite / wrong shape')
    pk = int(spec.argmax())
    med = statistics.median(call_ms)
    print(f'receive() fmcw_sonar (mix_resample, power) 2^24 samples depth 2,'
          f' fixed: median {med:.3f} ms/call ({COH_LANES / (med * 1e-3):.4e}'
          f' samples/s), calls {[round(x, 3) for x in call_ms]}; beat peak '
          f'bin {pk}, slope 2R/c at bin {want} ({f_beat:.1f} Hz) {tag}')
    if abs(pk - want) > 2:
        fail(f'fmcw_sonar: beat peak at bin {pk}, expected {want}')
    if not rk.launched_doppler_power_kernel():
        fail('fmcw_sonar path: the launch record does not show the Doppler '
             'power kernel')
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=COH_LANES, seed=SEED, **kw), 6)
    k_med = statistics.median(k_ms[1:])
    acc1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    scale = float(acc1.abs().max())
    rep = float((acc1 - acc2).abs().max())
    print(f'parity fmcw_sonar philox 2^24 lanes: two calls differ by at '
          f'most {rep:.3e} ({rep / max(scale, 1e-300):.3e} of max|acc|) per '
          f'cell, events {int(n1)} / {int(n2)}')
    if not (scale > 0 and rep <= REPEAT_TOL * scale and int(n1) == int(n2)):
        fail('fmcw_sonar: two Philox-mode calls with one seed differ')
    ref, n_ref, _, stats, plain_ms = _plain_philox(
        torch, rk, params, prim, txp, kw, COH_LANES, COH_DEPTH, dev)
    c = compare(acc1, n1, ref, n_ref, 'fmcw_sonar philox 2^24 lanes')
    print(f'receive_megakernel (doppler, mix_resample) 2^24 lanes depth 2: '
          f'median {k_med:.3f} ms ({COH_LANES / (k_med * 1e-3):.4e} '
          f'samples/s) {[round(x, 3) for x in k_ms[1:]]}; plain version '
          f'{plain_ms:.1f} ms {tag}')
    print('fmcw_sonar stage lanes: ' + json.dumps(stats))
    mix = kernel_mix(dev, tag, build_log, cubin, 'fmcw_sonar',
                     rk.launch_geometry(rx.adc.n_time, COH_LANES,
                                        int(prim.shape[0]),
                                        n_freq=rx.adc.n_freq, doppler=True),
                     sms)
    entries.append(_kernel_entry(
        torch, rk, 'doppler, mix_resample', 'fmcw_sonar 2^24 lanes',
        'receive(fmcw_sonar_scene()), 2^24 samples, depth 2, fixed',
        launches, errs['doppler'] + [c], k_med, plain_ms, med, stats,
        [params, prim, txp], 16 * 256, 1, dict(repeat_rel=rep / scale,
                                               **mix)))
    kw_grid = {'fmcw_sonar': (s, sd, rx)}

    # ---- 4b. the pulse train (golden config 3): eight coherent pulses,
    #      one seed (frozen speckle), the slow-time FFT ----
    pt = PULSE_TRAIN
    pulses = []
    for p in range(pt['n_pulses']):
        s_p, rx_p = pulse_train_scene(p)
        pulses.append((s_p, s_p.compile(device=dev), rx_p))

    def train():
        iq = []
        for s_p, sd_p, rx_p in pulses:
            a, n = bt.receive(s_p, sd_p, rx_p, seed=11, spp=COH_LANES,
                              max_depth=PULSE_DEPTH, coherent=True,
                              time_sampling='gate', device=dev)
            iq.append(torch.complex(a[..., 0].sum(), a[..., 1].sum()) / n)
        return torch.stack(iq), a

    reset()
    with _Wavefront(bt) as wfc:
        train()
        train_ms, (iq, a_last) = cuda_ms(lambda i: train(), 5)
    launches = rk.receive_megakernel.by_config['coherent']
    n_calls = 6 * pt['n_pulses']
    if launches != n_calls or rk.receive_megakernel.launches != n_calls \
            or wfc.calls:
        fail(f'pulse train launched K1 {rk.receive_megakernel.by_config}, '
             f'the wavefront {wfc.calls} times in {n_calls} receive() calls')
    if tuple(a_last.shape) != (8, 1, 4) or not bool(
            torch.isfinite(iq).all()):
        fail('pulse train: I / Q not finite / wrong shape')
    dop = (torch.fft.fft(iq).abs() ** 2).cpu().numpy()
    fd = 2 * pt['v'] * pt['fc'] / pulses[0][0].band.c
    want = int(round((fd / pt['prf'] % 1.0) * pt['n_pulses'])) \
        % pt['n_pulses']
    med = statistics.median(train_ms)
    print(f'pulse train: 8 coherent receive() calls of 2^24 samples, depth '
          f'1, gate: median {med:.3f} ms per train ({8 * COH_LANES / (med * 1e-3):.4e} samples/s), trains '
          f'{[round(x, 3) for x in train_ms]}; slow-time FFT peak bin '
          f'{int(dop.argmax())}, fd {fd:.1f} Hz aliased to bin {want}; '
          f'Doppler power {np.round(dop / dop.max(), 3).tolist()} {tag}')
    if int(dop.argmax()) != want:
        fail(f'pulse train: Doppler peak at bin {int(dop.argmax())}, '
             f'expected {want}')
    s, sd, rx = pulses[0]
    _, _, _, params, prim, txp, kw = _coh_tables(
        torch, rk, pulse_train_scene, dev, True)
    kw['max_depth'] = PULSE_DEPTH
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=COH_LANES, seed=SEED, **kw), 6)
    k_med = statistics.median(k_ms[1:])
    acc1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    ref, n_ref, amp, stats, plain_ms = _plain_philox(
        torch, rk, params, prim, txp, kw, COH_LANES, PULSE_DEPTH, dev)
    rep = float((acc1 - acc2).abs().max())
    amp_max = float(amp.max())
    # the warp rows sum every bin in a fixed order: repeats are
    # bit-identical there
    rows = rk.coherent_warp_rows(rx.adc)
    print(f'parity pulse train philox 2^24 lanes: two calls differ by at '
          f'most {rep:.3e} ({rep / amp_max:.3e} of the largest amplitude '
          f'sum) per cell, events {int(n1)} / {int(n2)}; warp rows {rows}, '
          f'bit-identical {bool(torch.equal(acc1, acc2))}')
    if not ((torch.equal(acc1, acc2) if rows
             else rep <= REPEAT_TOL * amp_max) and int(n1) == int(n2)):
        fail('pulse train: two Philox-mode calls with one seed differ')
    c = compare_coherent(torch, acc1, n1, ref, n_ref, amp,
                         rk.phase_slack(s.band, rx.adc),
                         'pulse train philox 2^24 lanes', depth=PULSE_DEPTH)
    print(f'receive_megakernel (coherent) pulse 0, 2^24 lanes depth 1: '
          f'median {k_med:.3f} ms ({COH_LANES / (k_med * 1e-3):.4e} '
          f'samples/s) {[round(x, 3) for x in k_ms[1:]]}; plain version '
          f'{plain_ms:.1f} ms {tag}')
    print('pulse train stage lanes: ' + json.dumps(stats))
    mix = kernel_mix(dev, tag, build_log, cubin, 'pulse_train',
                     rk.launch_geometry(rx.adc.n_time, COH_LANES,
                                        int(prim.shape[0]), doppler=True,
                                        coherent=True), sms)
    entries.append(_kernel_entry(
        torch, rk, 'coherent', 'pulse train pulse 0, 2^24 lanes',
        'eight receive(pulse_train_scene(p), coherent=True) calls, 2^24 '
        'samples each, depth 1, gate', launches, errs['coherent'] + [c],
        k_med, plain_ms, med / pt['n_pulses'], stats, [params, prim, txp],
        8, 2, dict(repeat_rel=rep / amp_max,
                   repeat_bit_identical=bool(torch.equal(acc1, acc2)),
                   **mix)))
    kw_grid['pulse_train'] = (s, sd, rx)

    # ---- 4c. the dechirp chain (golden config 4, one pulse) ----
    s, sd, rx, params, prim, txp, kw = _coh_tables(
        torch, rk, fmcw_dechirp_scene, dev, True)
    d = DECHIRP

    def chain(seed):
        a, n = bt.receive(s, sd, rx, seed=seed, spp=COH_LANES,
                          max_depth=COH_DEPTH, coherent=True,
                          time_sampling='gate', device=dev)
        return a, n

    reset()
    with _Wavefront(bt) as wfc:
        chain(1)
        call_ms, (adc, n) = cuda_ms(lambda i: chain(2 + i), 5)
    launches = rk.receive_megakernel.by_config['coherent']
    if launches != 6 or rk.receive_megakernel.launches != 6 or wfc.calls:
        fail(f'dechirp path launched K1 {rk.receive_megakernel.by_config}, '
             f'the wavefront {wfc.calls} times in 6 receive() calls')

    def dsp():
        iq = torch.complex(adc[:, 0, 0], adc[:, 0, 1]) * (d['n_fast'] / n)
        dec = resample.decimate(torch.conj(iq), d['q'])
        return rd.range_fft(dec, window=windows.hann(dec.shape[-1],
                                                     device=dev))

    dsp()   # cuFFT plans and the FIR bank: set-up
    dsp_ms, rc = wall_ms(dsp)
    n_adc = rc.shape[-1]
    fs_adc = d['n_fast'] / d['window'] / d['q']
    slope = FMCW['sweep'] / FMCW['chirp']
    tau = 2 * (d['R'] - abs(d['rx_pos'][1])) / s.band.c
    want = int(round(slope * tau / fs_adc * n_adc)) % n_adc
    path = d['R'] + np.linalg.norm(np.array([0.0, -d['R'], 0.0])
                                   - np.array(d['rx_pos']))
    bistatic = slope * path / s.band.c / fs_adc * n_adc
    p_rc = rc.abs()
    pk = int(p_rc.argmax())
    med = statistics.median(call_ms)
    print(f'receive() dechirp 2^24 samples depth 2, I / Q: median {med:.3f} '
          f'ms/call ({COH_LANES / (med * 1e-3):.4e} samples/s), calls '
          f'{[round(x, 3) for x in call_ms]}; conj, decimate x{d["q"]} and '
          f'Hann range FFT {dsp_ms:.2f} ms: beat peak bin {pk} of {n_adc} '
          f'(peak / median {float(p_rc.max() / p_rc.median()):.1f}), the '
          f'config\'s anchor {want}, the plate\'s bistatic path '
          f'{bistatic:.2f} {tag}')
    if not bool(torch.isfinite(rc).all()) or abs(pk - want) > 1:
        fail(f'dechirp: beat at range bin {pk}, expected {want}')
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=COH_LANES, seed=SEED, **kw), 6)
    k_med = statistics.median(k_ms[1:])
    acc1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    ref, n_ref, amp, stats, plain_ms = _plain_philox(
        torch, rk, params, prim, txp, kw, COH_LANES, COH_DEPTH, dev)
    c = compare_coherent(torch, acc1, n1, ref, n_ref, amp,
                         rk.phase_slack(s.band, rx.adc),
                         'dechirp philox 2^24 lanes')
    print(f'receive_megakernel (coherent) dechirp 2^24 lanes depth 2: median '
          f'{k_med:.3f} ms ({COH_LANES / (k_med * 1e-3):.4e} samples/s) '
          f'{[round(x, 3) for x in k_ms[1:]]}; plain version {plain_ms:.1f} '
          f'ms {tag}')
    print('dechirp stage lanes: ' + json.dumps(stats))
    mix = kernel_mix(dev, tag, build_log, cubin, 'dechirp',
                     rk.launch_geometry(rx.adc.n_time, COH_LANES,
                                        int(prim.shape[0]), doppler=True,
                                        coherent=True), sms)
    entries.append(_kernel_entry(
        torch, rk, 'coherent (dechirp)', 'dechirp 2^24 lanes',
        'receive(fmcw_dechirp_scene(), coherent=True), 2^24 samples, depth '
        '2, gate; decimate, range_fft', launches, [c], k_med, plain_ms, med,
        stats, [params, prim, txp], 1024, 2, mix))

    # ---- 4d. a coherent mesh: mesh_scene's I / Q profile ----
    s, sd, rx, params, prim, txp, kw = _coh_tables(torch, rk, mesh_scene,
                                                   dev, True)
    kw['patch_p'] = rk.patch_p_for(COH_LANES)
    blocks, threads, smem = rk.launch_geometry(
        64, COH_LANES, int(prim.shape[0]), mesh=True,
        n_msh=int(kw['msh'].shape[0]), doppler=True, coherent=True)
    print(f'receive_megakernel (coherent mesh) geometry at 2^24 lanes: '
          f'{blocks} blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs {tag}')
    reset()
    with _Wavefront(bt) as wfc:
        bt.receive(s, sd, rx, seed=1, spp=COH_LANES, max_depth=COH_DEPTH,
                   coherent=True, time_sampling='gate', device=dev)
        call_ms, (adc, n) = cuda_ms(lambda i: bt.receive(
            s, sd, rx, seed=2 + i, spp=COH_LANES, max_depth=COH_DEPTH,
            coherent=True, time_sampling='gate', device=dev), 5)
    launches = rk.receive_megakernel.by_config['coherent_mesh']
    k4 = (ik.ray_triangle_closest.launches, ik.ray_triangle_any.launches)
    if launches != 6 or rk.receive_megakernel.launches != 6 or wfc.calls \
            or k4 != (0, 0):
        fail(f'coherent mesh path launched K1 '
             f'{rk.receive_megakernel.by_config}, K4 {k4}, the wavefront '
             f'{wfc.calls} times in 6 receive() calls')
    mag = torch.complex(adc[:, 0, 0], adc[:, 0, 1]).abs()
    anchor = round_trip_bin(s, rx)
    med = statistics.median(call_ms)
    print(f'receive() mesh_scene 2^24 samples depth 2, I / Q: median '
          f'{med:.3f} ms/call ({COH_LANES / (med * 1e-3):.4e} samples/s), '
          f'calls {[round(x, 3) for x in call_ms]}; |I + jQ| peak bin '
          f'{int(mag.argmax())}, 2R/c anchor {anchor:.2f} {tag}')
    if not bool(torch.isfinite(adc).all()) \
            or abs(int(mag.argmax()) - anchor) > 2:
        fail('coherent mesh: |I + jQ| not finite or off the 2R/c anchor')
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=COH_LANES, seed=SEED, **kw), 6)
    k_med = statistics.median(k_ms[1:])
    lane = torch.empty(COH_LANES, device=dev)
    lane_ref = torch.empty(COH_LANES, device=dev)
    acc1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, lane_out=lane, **kw)
    # the coherent mesh runs the mesh Doppler kernel <true, false> (the
    # launch record), whose warp rows make Philox repeats bit-identical
    if not rk.launched_mesh_doppler_kernel(False, True):
        fail('coherent mesh: the launch record does not show '
             'receive_mesh_doppler_kernel<true, false>')
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=COH_LANES,
                                     seed=SEED, **kw)
    rows = rk.coherent_warp_rows(rx.adc)
    same = bool(torch.equal(acc1, acc2)) and int(n1) == int(n2)
    print(f'coherent mesh philox repeat: mesh Doppler kernel <true, false> '
          f'launched, warp rows {rows}, bit-identical {same}, max '
          f'difference {float((acc1 - acc2).abs().max()):.3e}, events '
          f'{int(n1)} / {int(n2)}')
    if not rows or not same:
        fail('coherent mesh: two Philox-mode calls with one seed differ')
    ref, n_ref, amp, stats, plain_ms = _plain_philox(
        torch, rk, params, prim, txp, kw, COH_LANES, COH_DEPTH, dev,
        lane_ref=lane_ref, chunk=MESH_PLAIN_CHUNK)
    c = compare_coherent(torch, acc1, n1, ref, n_ref, amp,
                         rk.phase_slack(s.band, rx.adc),
                         'coherent mesh philox 2^24 lanes, P 32', lane,
                         lane_ref)
    print(f'receive_megakernel (coherent mesh) 2^24 lanes depth 2: median '
          f'{k_med:.3f} ms ({COH_LANES / (k_med * 1e-3):.4e} samples/s) '
          f'{[round(x, 3) for x in k_ms[1:]]}; plain version {plain_ms:.1f} '
          f'ms {tag}')
    print('coherent mesh stage lanes: ' + json.dumps(stats))
    mix = kernel_mix(dev, tag, build_log, cubin, 'coherent_mesh',
                     (blocks, threads, smem), sms) if cubin else {}
    if mix:
        mix['kernel'] = 'receive_mesh_doppler_kernel<true, false>'
    entries.append(_kernel_entry(
        torch, rk, 'coherent mesh', 'mesh_scene 2^24 lanes',
        'receive(mesh_scene(), coherent=True), 2^24 samples, depth 2, gate',
        launches, errs['coherent_mesh'] + [c], k_med, plain_ms, med, stats,
        [params, prim, txp, kw['msh'], kw['mesh'].bbox, kw['mesh'].links,
         kw['mesh'].leaves], 64, 2, dict(lanes_on_another_path=c['flips'],
                                         repeat_bit_identical=same, **mix)))

    # ---- K1 against the wavefront ----
    compare_k1_wavefront_lo(torch, bt, dev, kw_grid, tag)
    return entries


# the coherent processing interval (CPI): golden configs 5 and 4, each a
# 64-pulse train through receive_cpi, every pulse in one K1 launch
CPI_PULSES = 64
CPI_CONFIGS = {
    # config 5: a CW train over an orbiting plate; config 4: the LFMCW
    # dechirp chain over a closing trihedral of mirrors
    'micro_doppler': dict(spp=1 << 13, max_depth=1, time_sampling='gate'),
    'corner': dict(spp=1 << 16, max_depth=4, time_sampling='fixed'),
}
CPI_RATE_SAMPLES = 1 << 20     # samples a pulse of the rate runs
MIRROR_PARITY_LANES = 1 << 16  # one corner pulse, injected uniforms


def _cpi_scene(sc_mod, name):
    """(scene, prf, seed) of a CPI configuration."""
    if name == 'micro_doppler':
        s, _ = sc_mod.micro_doppler_scene()
        return s, sc_mod.MICRO_DOPPLER['prf'], sc_mod.MICRO_DOPPLER['seed']
    s, _ = sc_mod.corner_scene()
    return s, sc_mod.CORNER['prf'], sc_mod.CORNER['seed']


def _check_cpi_anchor(torch, sc_mod, name, cube, n, tag) -> float:
    """Config 5's Bessel comb on its bins, the rest 12 dB down; config 4's
    range-Doppler peak in its analytic cell.  Returns the DSP's ms (the
    corner's decimate and two FFTs)."""
    import numpy as np
    if name == 'micro_doppler':
        spec = sc_mod.micro_doppler_spectrum(cube, n).double().cpu().numpy()
        comb = sc_mod.micro_doppler_comb_bins()
        top = sorted(np.argsort(spec)[::-1][:len(comb)].tolist())
        off = [b for b in range(len(spec)) if b not in comb]
        floor_db = 10 * np.log10(spec[off].max() / spec.max())
        print(f'micro_doppler anchor: top {len(comb)} slow-time bins {top}, '
              f'comb {comb}; strongest bin off the comb {floor_db:.2f} dB '
              f'{tag}')
        if not np.isfinite(spec).all() or top != comb or floor_db > -12.0:
            fail('micro_doppler: the Bessel comb is off its bins')
        return 0.0
    sc_mod.corner_rd_map(cube, n)      # cuFFT plans and the FIR bank
    dsp_ms, rdm = wall_ms(lambda: sc_mod.corner_rd_map(cube, n))
    mag = rdm.abs()
    pk = divmod(int(mag.argmax()), mag.shape[1])
    want = sc_mod.corner_anchors()
    print(f'corner anchor: range-Doppler peak (Doppler, range) {pk} of '
          f'{tuple(mag.shape)}, analytic cell ({want["doppler_bin"]}, '
          f'{want["range_bin"]}), peak / median '
          f'{float(mag.max() / mag.median()):.1f}; conj, decimate, range '
          f'and Doppler FFTs {dsp_ms:.2f} ms {tag}')
    if not bool(torch.isfinite(mag).all()) \
            or abs(pk[0] - want['doppler_bin']) > 1 \
            or abs(pk[1] - want['range_bin']) > 2:
        fail('corner: the range-Doppler peak is off its analytic cell')
    return dsp_ms


def cpi(torch, bt, rk, ik, dev, tag, build_log: str, cubin: str) -> list:
    """The CPI phase: the mirror chains against the plain version, then
    configs 5 and 4 through receive_cpi (one K1 launch a train), their
    anchors, the launch alone, against one launch a pulse and the plain
    version, the loop engine, and each at CPI_RATE_SAMPLES a pulse."""
    from beifong_tpu_torch import scenes as sc_mod
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def reset():
        for fn in (rk.receive_megakernel, rk.receive_megakernel_cpi):
            fn.launches = 0
            fn.by_config = dict.fromkeys(rk.CONFIGS, 0)
        ik.ray_triangle_closest.launches = ik.ray_triangle_any.launches = 0

    # ---- 3. the mirror chains: a pulse of config 4's corner on injected
    #      uniforms, lane by lane ----
    def corner_pulse():
        s_, rx_ = sc_mod.corner_scene()
        return s_.at_time(0.0), rx_
    cm = CPI_CONFIGS['corner']
    s, sd, rx, params, prim, txp, kw = _coh_tables(torch, rk, corner_pulse,
                                                   dev, True)
    kw.update(max_depth=cm['max_depth'], time_sampling=cm['time_sampling'])
    n_l = MIRROR_PARITY_LANES
    u = torch.rand((rk.n_draws(cm['max_depth']), n_l), generator=gen,
                   device=dev)
    lane = torch.empty(n_l, device=dev)
    lane_ref = torch.empty(n_l, device=dev)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=dev)
    stats_m: dict = {}
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_l,
                                      uniforms=u, lane_out=lane, **kw)
    m_plain_ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
        params, prim, txp, u, lane_out=lane_ref, amp_out=amp, stats=stats_m,
        **kw))
    c_mirror = compare_coherent(
        torch, acc, n_ev, ref, n_ref, amp, rk.phase_slack(s.band, rx.adc),
        'corner pulse 0 mirror chains (I / Q) injected 2^16 lanes, depth 4',
        lane, lane_ref, depth=cm['max_depth'])
    print(f'mirror chains: {stats_m["mirror_bounce"]} mirror bounces, '
          f'{stats_m["direct"]} direct transmitter hits; plain version '
          f'{m_plain_ms:.1f} ms {tag}')
    if not (stats_m['mirror_bounce'] > 0 and stats_m['direct'] > 0):
        fail('corner: no mirror chain reached the transmitter')
    m_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=n_l, seed=SEED, **kw), 6)
    m_med = statistics.median(m_ms[1:])
    print(f'receive_megakernel (coherent, mirror chains) corner pulse 2^16 '
          f'lanes depth 4: median {m_med:.3f} ms '
          f'({n_l / (m_med * 1e-3):.4e} samples/s) '
          f'{[round(x, 3) for x in m_ms[1:]]} {tag}')

    entries, mirror_launches = [], 0
    for name, cfg in CPI_CONFIGS.items():
        s, prf, seed = _cpi_scene(sc_mod, name)
        spp, depth, ts = cfg['spp'], cfg['max_depth'], cfg['time_sampling']

        def run(engine='scan', n_spp=spp):
            return bt.receive_cpi(s, n_pulses=CPI_PULSES, prf=prf, seed=seed,
                                  coherent=True, spp=n_spp, max_depth=depth,
                                  time_sampling=ts, engine=engine,
                                  device=dev)

        # set-up: the per-pulse snapshots, their packs and the tables on
        # the card, cached on the scene
        setup_ms, _ = wall_ms(run)
        # ---- 4. the main path: one warm-up and five timed calls ----
        reset()
        with _Wavefront(bt) as wfc:
            call_ms, (cube, n) = cuda_ms(lambda i: run(), 6)
        launches = rk.receive_megakernel_cpi.launches
        by_cfg = dict(rk.receive_megakernel_cpi.by_config)
        if launches != 6 or by_cfg['coherent'] != 6 \
                or rk.receive_megakernel.launches or wfc.calls:
            fail(f'{name} CPI launched the CPI kernel {by_cfg}, K1 alone '
                 f'{rk.receive_megakernel.launches}, the wavefront '
                 f'{wfc.calls} times in 6 receive_cpi() calls')
        if tuple(cube.shape) != (CPI_PULSES, rx_n_time(s), 1, 4) \
                or n != spp or not bool(torch.isfinite(cube).all()):
            fail(f'{name}: cube {tuple(cube.shape)} ({n} samples a pulse) '
                 'not finite / wrong shape')
        med = statistics.median(call_ms[1:])
        total = CPI_PULSES * n
        print(f'receive_cpi() {name} {CPI_PULSES} pulses x 2^'
              f'{spp.bit_length() - 1} samples depth {depth}, {ts}: median '
              f'{med:.3f} ms/call ({total / (med * 1e-3):.4e} samples/s), '
              f'calls {[round(x, 3) for x in call_ms[1:]]}; set-up (at_time, '
              f'pack, tables to the card) {setup_ms:.1f} ms {tag}')
        dsp_ms = _check_cpi_anchor(torch, sc_mod, name, cube, n, tag)
        if name == 'corner':
            mirror_launches = launches

        # the launch alone, on the main path's tables
        packed, rx, _ = rk.pack_cpi(s, CPI_PULSES, prf)
        params = torch.tensor(packed.params, device=dev)
        params[:, 0] = rk.seed_slot(seed)
        prim = torch.tensor(packed.prim, device=dev)
        txp = torch.tensor(packed.txp, device=dev)
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
                  rx_kind='wigner', n_lanes=spp, doppler=True,
                  receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, coherent=True,
                  mirror=packed.mirror)
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel_cpi(
            params, prim, txp, seed=seed, **kw), 6)
        k_med = statistics.median(k_ms[1:])
        blocks, threads, smem = rk.launch_geometry(
            rx.adc.n_time, spp, int(prim.shape[1]), n_freq=1, doppler=True,
            coherent=True, n_pulses=CPI_PULSES)
        print(f'receive_megakernel_cpi {name}: median {k_med:.3f} ms '
              f'({total / (k_med * 1e-3):.4e} samples/s) '
              f'{[round(x, 3) for x in k_ms[1:]]}; {blocks} blocks a pulse '
              f'x {CPI_PULSES} pulses x {threads} threads, {smem} B shared '
              f'each (grid mode {rk.grid_mode(rx.adc.n_time, True, True)}) '
              f'{tag}')

        # parity: the launch against one launch a pulse (the atomics'
        # order) and against the plain version on the Philox stream
        lane = torch.empty((CPI_PULSES, spp), device=dev)
        acc, n_ev = rk.receive_megakernel_cpi(params, prim, txp, seed=seed,
                                              lane_out=lane, **kw)
        stats: dict = {}
        worst = {'err': 0.0, 'rel': 0.0, 'worst': 0.0, 'worst_plain': 0.0,
                 'flips': 0, 'per_pulse': 0.0}
        kw1 = {k: v for k, v in kw.items() if k != 'n_lanes'}
        u = rk.philox_uniforms(seed, rk.n_draws(depth), spp, device=dev)
        slack = rk.phase_slack(s.band, rx.adc)
        t_plain, amp_max = 0.0, 0.0
        for p in range(CPI_PULSES):
            one, n_one = rk.receive_megakernel(params[p], prim[p], txp[p],
                                               n_lanes=spp, seed=seed, **kw1)
            amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                              device=dev)
            lane_ref = torch.empty(spp, device=dev)
            ms, (ref, n_ref) = wall_ms(lambda: rk.receive_megakernel_ref(
                params[p], prim[p], txp[p], u, lane_out=lane_ref,
                amp_out=amp, stats=stats, **kw1))
            t_plain += ms
            amp_max = max(amp_max, float(amp.max()))
            per = float((acc[p] - one).abs().max()) / float(amp.max())
            if int(n_one) != int(n_ev[p]) or not per <= REPEAT_TOL:
                fail(f'{name} pulse {p}: the CPI launch and one launch '
                     f'differ ({per:.3e} of the amplitude sum; events '
                     f'{int(n_ev[p])} / {int(n_one)})')
            c = compare_coherent(torch, acc[p], n_ev[p], ref, n_ref, amp,
                                 slack, f'{name} pulse {p}', lane[p],
                                 lane_ref, depth=depth, quiet=True)
            worst = {k: max(worst[k], c[k]) for k in c} | {
                'per_pulse': max(worst['per_pulse'], per),
                'flips': worst['flips'] + c['flips']}
        print(f'parity {name} CPI launch, {CPI_PULSES} pulses x 2^'
              f'{spp.bit_length() - 1} philox lanes: against one launch a '
              f'pulse at most {worst["per_pulse"]:.3e} of the amplitude sum '
              f'per cell; against the plain version worst cell at '
              f'{worst["worst"]:.3f} of its bound (max abs err '
              f'{worst["err"]:.3e}, {worst["rel"]:.3e} of max), '
              f'{worst["flips"]} of {CPI_PULSES * spp} lanes took another '
              f'path; plain version {t_plain:.1f} ms {tag}')
        print(f'{name} stage lanes: ' + json.dumps(stats))

        # the loop engine: one receive() a pulse, timed the same way
        reset()
        loop_ms, (cube_l, _) = cuda_ms(lambda i: run('loop'), 6)
        loop_med = statistics.median(loop_ms[1:])
        if rk.receive_megakernel.launches != 6 * CPI_PULSES:
            fail(f'{name} loop engine: K1 launched '
                 f'{rk.receive_megakernel.launches} times')
        # one stream a pulse either way: the cubes differ by the atomics
        diff = float((cube_l - cube).abs().max()) / amp_max
        print(f'receive_cpi(engine=\'loop\') {name}: median {loop_med:.3f} '
              f'ms/call ({total / (loop_med * 1e-3):.4e} samples/s), calls '
              f'{[round(x, 3) for x in loop_ms[1:]]}, {loop_med / med:.2f} x '
              f'the CPI launch\'s; cubes differ by {diff:.3e} of the largest '
              f'amplitude sum {tag}')
        if not diff <= REPEAT_TOL:
            fail(f'{name}: the loop engine and the CPI launch disagree')

        # the rate at CPI_RATE_SAMPLES a pulse
        run(n_spp=CPI_RATE_SAMPLES)
        rate_ms, (cube_r, n_r) = cuda_ms(
            lambda i: run(n_spp=CPI_RATE_SAMPLES), 5)
        rate_med = statistics.median(rate_ms)
        print(f'receive_cpi() {name} {CPI_PULSES} pulses x 2^20 samples: '
              f'median {rate_med:.3f} ms/call '
              f'({CPI_PULSES * n_r / (rate_med * 1e-3):.4e} samples/s), calls '
              f'{[round(x, 3) for x in rate_ms]} {tag}')
        _check_cpi_anchor(torch, sc_mod, name, cube_r, n_r, tag)

        n_rect = int((prim[0, :, 0] == 0).sum())
        n_bytes = 4 * (params.numel() + prim.numel() + txp.numel()
                       + CPI_PULSES * rx.adc.n_time * 2) + 8 * CPI_PULSES
        b = bound(lane_ops(_chirp_h(stats, txp[0]), n_rect), n_bytes,
                  f'{name} CPI')
        mix = {'kernel': 'receive_coherent_kernel'}
        if name == 'corner':
            mix = kernel_mix(
                dev, tag, build_log, cubin, 'corner', rk.launch_geometry(
                    rx.adc.n_time, spp, int(prim.shape[1]), doppler=True,
                    coherent=True, n_pulses=CPI_PULSES),
                torch.cuda.get_device_properties(0).multi_processor_count,
                CPI_PULSES)
        entries.append({
            'name': 'receive_megakernel',
            'configuration': 'coherent CPI (pulse axis)'
            + (', mirror chains' if packed.mirror else ''),
            'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': 'receive_cpi_pallas (pallas_receive.py:3164), '
            'the lax.scan of _run over the pulses (_cpi_run_all :3289)',
            'main_path': f'receive_cpi({name}_scene(), {CPI_PULSES} pulses '
            f'x 2^{spp.bit_length() - 1} samples, depth {depth}, {ts})',
            'launches': launches, 'max_abs_err': worst['err'],
            'parity': worst['rel'], 'ms': k_med, 'plain_ms': t_plain,
            'receive_cpi_ms': med, 'loop_engine_ms': loop_med,
            'dsp_ms': dsp_ms, **b, 'library_ms': None,
            'lanes_on_another_path': worst['flips'],
            'per_pulse_launch_rel': worst['per_pulse'], **mix})

    # the mirror form: one pulse of config 4 (its shape on the CPI path)
    n_rect = int((prim[0, :, 0] == 0).sum())
    b = bound(lane_ops(_chirp_h(stats_m, txp[0]), n_rect),
              4 * (params[0].numel() + prim[0].numel() + txp[0].numel()
                   + 2 * rx.adc.n_time) + 8, 'corner pulse, mirror chains')
    entries.insert(0, {
        'name': 'receive_megakernel',
        'configuration': 'coherent + mirror chains', 'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106), mirror / '
        'delta_any (:199-209, 1558-1614, 2115-2129)',
        'main_path': 'receive_cpi(corner_scene()): every pulse runs the '
        'mirror chains', 'launches': mirror_launches,
        'max_abs_err': c_mirror['err'], 'parity': c_mirror['rel'],
        'ms': m_med, 'plain_ms': m_plain_ms, **b, 'library_ms': None,
        'lanes_on_another_path': c_mirror['flips'],
        'kernel': 'receive_coherent_kernel'})
    return entries


# the texture twins: the flagship scene's ground under a checkerboard of
# 1 m cells or a 128 x 128 reflectance bitmap (`ground_texture`)
TEX_TEXTURES = ('checkerboard', 'bitmap')
TEX_LANES = 1 << 28            # the flagship's width, depth 3
TEX_COH_LANES = 1 << 24        # the coherent receive's, depth 2
TEX_COH_DEPTH = 2
TEX_PARITY_LANES = 1 << 18     # injected uniforms
TEX_ANCHOR_LANES = 1 << 22     # the anchors' calls
TEX_CONSTANT_RTOL = 1e-5       # the 0.7 grounds against each other
TEX_MOVED = 100                # a texture moves the grid > this x TOL


def _tex_scene(texture):
    """The flagship scene with a textured ground (None: untextured), or
    the anchors' own grounds: 'uniform' a checkerboard of 1.0 / 1.0,
    'uniform07' one of 0.7 / 0.7, 'constant' an 8 x 8 bitmap of 0.7,
    'plain07' an untextured ground of reflectance 0.7."""
    from beifong_tpu_torch import textures as tx
    from beifong_tpu_torch.bsdf.tables import diffuse
    from beifong_tpu_torch.scenes import flagship_scene
    if texture in (None,) + TEX_TEXTURES:
        return flagship_scene(ground_texture=texture)
    s, rx = flagship_scene()
    if texture == 'plain07':
        s.add(diffuse('gnd', reflectance=0.7, twosided=True))
    else:
        s.add({'uniform': tx.checkerboard('t', 1.0, 1.0),
               'uniform07': tx.checkerboard('t', 0.7, 0.7),
               'constant': tx.bitmap('t', [[0.7] * 8] * 8)}[texture])
        s.add(diffuse('gnd', reflectance=1.0, twosided=True, texture='t'))
    s.shapes[-1].bsdf = 'gnd'
    return s, rx


def textures(torch, bt, rk, dev, tag, pulse_compress, build_log: str,
             cubin: str) -> list:
    """K1's texture twins, receive_flagship_kernel<true> (power, the
    flagship's 2^28 lanes at depth 3) and receive_coherent_kernel<true>
    (I / Q, 2^24 lanes at depth 2), on the checkerboard and the bitmap
    ground: each against its plain version on injected uniforms and on
    the Philox stream at the main path's width; the anchors (a uniform
    checkerboard is the untextured scene bit for bit; a constant bitmap,
    the uniform checkerboard of its value and an untextured ground of that
    reflectance agree to 1e-5; each texture moves the grid far beyond the
    parity bound; the target's peak on its round-trip bin); receive() at
    full width, six calls a scene, every one launching the twin; each twin
    alone beside the untextured kernel; their bounds."""
    from beifong_tpu_torch.scenes import round_trip_bin
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = []
    for coh in (False, True):
        depth = TEX_COH_DEPTH if coh else MAX_DEPTH
        lanes = TEX_COH_LANES if coh else TEX_LANES
        twin = 'coherent' if coh else 'flagship'
        cfg_name = f'{twin}_tex'
        tabs = _twin_tables(rk, dev, (None, 'uniform', 'uniform07',
                                      'constant', 'plain07') + TEX_TEXTURES,
                            _tex_scene)

        def kwargs(texture):
            _, _, rx, t = tabs[texture]
            return dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                        rx_kind='wigner', doppler=coh, coherent=coh,
                        tex=t.tex, bmp_meta=t.bmp_meta)

        def call(texture, n_lanes, u=None):
            t = tabs[texture][3]
            return rk.receive_megakernel(t.params, t.prim, t.txp,
                                         n_lanes=n_lanes, seed=SEED,
                                         uniforms=u, **kwargs(texture))

        # ---- 3. each twin against its plain version: injected uniforms,
        # then the Philox stream at the main path's width ----
        errs, plain, stats = [], {}, {}
        nd = rk.n_draws(depth)
        for texture in TEX_TEXTURES:
            for n, u in ((TEX_PARITY_LANES, torch.rand(
                    (nd, TEX_PARITY_LANES), generator=gen, device=dev)),
                    (lanes, None)):
                what = (f'{twin} textures ({texture}) '
                        f'{"injected" if u is not None else "philox"} 2^'
                        f'{n.bit_length() - 1} lanes, depth {depth}')
                c, st, ms = _twin_parity(
                    torch, rk, dev, tabs[texture], kwargs(texture), n, u,
                    lambda: rk.launched_tex_kernel(coh), what, tag,
                    chunk=COH_PLAIN_CHUNK if coh else PLAIN_CHUNK)
                errs.append(c)
            stats[texture], plain[texture] = st, ms

        # ---- the anchors, on the card ----
        grids = {k: call(k, TEX_ANCHOR_LANES)[0] for k in
                 (None, 'uniform', 'uniform07', 'constant', 'plain07')
                 + TEX_TEXTURES}
        torch.cuda.synchronize()
        if not torch.equal(grids['uniform'], grids[None]):
            fail(f'{twin}: the uniform checkerboard differs from the '
                 'untextured scene')
        rels = {}
        for a, b in (('constant', 'uniform07'), ('constant', 'plain07'),
                     ('uniform07', 'plain07')):
            rels[f'{a}/{b}'] = float((grids[a] - grids[b]).abs().max()) \
                / float(grids[b].abs().max())
        scale = float(grids[None].abs().max())
        moved = {k: float((grids[k] - grids[None]).abs().max())
                 / (TOL * scale) for k in TEX_TEXTURES}
        print(f'{twin} textures anchors, 2^'
              f'{TEX_ANCHOR_LANES.bit_length() - 1} lanes: uniform '
              f'checkerboard == untextured bit for bit; the 0.7 grounds '
              + ', '.join(f'{k} {v:.3e}' for k, v in rels.items())
              + f' of max (bound {TEX_CONSTANT_RTOL}); max|texture - '
              f'untextured| ' + ', '.join(f'{k} {v:.1f}' for k, v in
                                          moved.items())
              + f' x the parity bound {TOL} x max|acc| (floor {TEX_MOVED})')
        for k, v in rels.items():
            if v > TEX_CONSTANT_RTOL:
                fail(f'{twin}: the 0.7 grounds {k} differ by {v:.3e} of max')
        for k, v in moved.items():
            if not v > TEX_MOVED:
                fail(f'{twin}: the {k} ground moves the grid by {v:.1f} x '
                     'the parity bound only')

        # ---- 4. the main path: receive() of both grounds ----
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)
        recv = {}
        for texture in TEX_TEXTURES:
            s, sd, rx, _ = tabs[texture]

            def run_main(seed, s=s, sd=sd, rx=rx):
                return bt.receive(s, sd, rx, seed=seed, spp=lanes,
                                  max_depth=depth, coherent=coh,
                                  time_sampling='gate', device=dev)

            run_main(1)
            call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 5)
            if not rk.launched_tex_kernel(coh):
                fail(f'receive() {texture} {twin}: not the texture twin')
            anchor = round_trip_bin(s, rx)
            if coh:
                iq = bt.develop_signal(adc, n, rx.adc)
                if tuple(iq.shape) != (rx.adc.n_time, 1, 2) \
                        or not bool(torch.isfinite(iq).all()):
                    fail(f'{texture} {twin}: I / Q {tuple(iq.shape)} not '
                         'finite / wrong shape')
                pk = int(iq[:, 0].square().sum(-1).argmax())
                print(f'{texture} {twin} |I + jQ|^2 peak bin {pk}, 2R/c '
                      f'anchor {anchor:.2f}')
                if abs(pk - anchor) > 2:
                    fail(f'{texture} {twin}: peak at {pk}, anchor '
                         f'{anchor:.2f}')
            else:
                check_profile(torch, bt, adc, n, rx, anchor, pulse_compress,
                              f'{texture} {twin}')
            recv[texture] = statistics.median(call_ms)
            print(f'receive() {texture} {twin} 2^{lanes.bit_length() - 1} '
                  f'samples depth {depth}: median {recv[texture]:.3f} '
                  f'ms/call ({lanes / (recv[texture] * 1e-3):.4e} '
                  f'samples/s), calls {[round(x, 3) for x in call_ms]} '
                  f'{tag}')
        launches = rk.receive_megakernel.launches
        by_cfg = dict(rk.receive_megakernel.by_config)
        if launches < 12 or by_cfg[cfg_name] != launches:
            fail(f'the {twin} textures path launched K1 {by_cfg} in 12 '
                 'receive() calls')

        # ---- each twin alone, beside the untextured kernel ----
        k_ms = {}
        for texture in (None,) + TEX_TEXTURES + (None,):
            t_ms, _ = cuda_ms(lambda i: call(texture, lanes), 6)
            k_ms.setdefault(texture, []).extend(t_ms[1:])
        med = {k: statistics.median(v) for k, v in k_ms.items()}
        print(f'receive_megakernel ({twin}) 2^{lanes.bit_length() - 1} '
              f'lanes depth {depth}: untextured {med[None]:.3f} ms, '
              f'checkerboard {med["checkerboard"]:.3f} ms '
              f'({med["checkerboard"] / med[None]:.4f}), bitmap '
              f'{med["bitmap"]:.3f} ms ({med["bitmap"] / med[None]:.4f}) '
              f'{tag}')

        # the bounds, from the checkerboard's stage counts on the main
        # path's stream
        _, _, rx, t = tabs['checkerboard']
        n_rect = int((t.prim[:, 0] == 0).sum())
        n_bytes = 4 * (t.params.numel() + t.prim.numel() + t.txp.numel()
                       + t.tex.numel() + t.bmp_meta.numel()
                       + rx.adc.n_time * (2 if coh else 1)) + 8
        b = bound(lane_ops(stats['checkerboard'], n_rect), n_bytes,
                  f'{twin} textures 2^{lanes.bit_length() - 1} lanes')
        geom = rk.launch_geometry(rx.adc.n_time, lanes, int(t.prim.shape[0]),
                                  doppler=coh, coherent=coh, tex=True)
        mix = kernel_mix(dev, tag, build_log, cubin, f'{twin}_checker',
                         geom, sms)
        print(f'{twin} textures bounds: FP32 {b["bound_ms"]:.4f} ms, issue '
              f'slots {mix["issue_slot_bound_ms"]:.4f} ms; kernel '
              f'{med["checkerboard"]:.3f} ms {tag}')
        entries.append({
            'name': 'receive_megakernel',
            'configuration': f'{twin} textures', 'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': '_make_kernel (pallas_receive.py:106), '
            'prim_tex 1 / 2 (:762-776, :1402, :1497-1510)',
            'main_path': f'receive(flagship_scene(ground_texture=...)), '
            f'checkerboard and bitmap, 2^{lanes.bit_length() - 1} samples, '
            f'depth {depth}' + (', coherent' if coh else ''),
            'launches': launches,
            'max_abs_err': max(c['err'] for c in errs),
            'parity': max(c['rel'] for c in errs),
            'philox_max_abs_err': max(c['err'] for c in errs[1::2]),
            'ms': med['checkerboard'], 'bitmap_ms': med['bitmap'],
            'untextured_ms': med[None], 'plain_ms': plain['checkerboard'],
            'plain_bitmap_ms': plain['bitmap'],
            'receive_ms': recv['checkerboard'],
            'receive_bitmap_ms': recv['bitmap'], **b, 'library_ms': None,
            **mix})
    return entries


PRIM_TARGETS = ('sphere', 'disk', 'cylinder')
PRIM_TEX = 'sphere_checker'    # the sphere over a checkerboard ground
PRIM_LANES = 1 << 28           # the flagship's width, depth 3
PRIM_COH_LANES = 1 << 24       # the coherent receive's, depth 2
PRIM_COH_DEPTH = 2
PRIM_PARITY_LANES = 1 << 18    # injected uniforms
PRIM_ANCHOR_LANES = 1 << 22    # the anchors' and the floor's calls
PRIM_MOVED = 100               # a target moves the grid > this x TOL
PRIM_PAIRS = 4                 # twin / rectangle kernel pairs on the plate
PRIM_CPI_PULSES = 4            # the sphere's CPI, one launch
PRIM_CPI_LANES = 1 << 20       # a pulse
# a lane's floor, x the largest lane, in the Doppler power prims twins'
# lane-by-lane parity (1e-6 elsewhere): a quadratic root's rounding slides
# a hit along a sphere or cylinder further than along a plane, and near a
# null of an aperture's sinc that moves the lane's value beyond 1e-4 of
# itself (1.5e-4 - 3.2e-4 seen in the g++ emulation)
PRIM_LANE_FLOOR = 1e-5


def _prim_scene(target):
    """The flagship scene with `target` ('plate' or a PRIM_TARGETS kind)
    at 4 m, PRIM_TEX the sphere over a checkerboard ground, or None: the
    flagship scene without a target."""
    from beifong_tpu_torch.scenes import flagship_scene
    if target == PRIM_TEX:
        return flagship_scene(target='sphere', ground_texture='checkerboard')
    s, rx = flagship_scene(target=target or 'plate')
    if target is None:
        del s.shapes[2]
    return s, rx


def prims(torch, bt, rk, dev, tag, pulse_compress, build_log: str,
          cubin: str) -> list:
    """K1's prims twins, receive_flagship_kernel<false, true> (power, the
    flagship's 2^28 lanes at depth 3) and receive_coherent_kernel<false,
    true> (I / Q, 2^24 lanes at depth 2), on the flagship scene with a
    sphere, a disk or a cylinder for its target, and the twins that also
    carry the texture codes (<true, true>) on the sphere over a
    checkerboard ground (PRIM_TEX): each against its plain
    version on injected uniforms and on the Philox stream at the main
    path's width (I / Q: the phase slack, each ill-conditioned
    connection's own slack from the plain version's `cond_out`, the
    reading without it printed beside, and each lane's amplitude sum, a
    phase-free check; a sphere CPI pulse by pulse);
    the anchors (each target's peak within [b - 1, b + 3] of the round
    trip b to its near surface, and each target moves the grid by more
    than PRIM_MOVED x the parity bound against the scene without it);
    receive() at full width, five calls a scene, every one launching its
    twin; each twin alone on each scene, and on the all-rectangle
    flagship scene beside the rectangle kernel (the cost of carrying the
    kinds; held there to the plain version); their bounds."""
    from beifong_tpu_torch.scenes import round_trip_bin, target_range
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = []
    for coh in (False, True):
        depth = PRIM_COH_DEPTH if coh else MAX_DEPTH
        lanes = PRIM_COH_LANES if coh else PRIM_LANES
        twin = 'coherent' if coh else 'flagship'
        cfg_name = f'{twin}_prims'
        scenes = PRIM_TARGETS + (PRIM_TEX,)
        tabs = _twin_tables(rk, dev, (None, 'plate') + scenes, _prim_scene)

        def kwargs(target):
            rx, t = tabs[target][2:]
            kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                      rx_kind='wigner', doppler=coh, coherent=coh)
            if t.textured:
                kw.update(tex=t.tex, bmp_meta=t.bmp_meta)
            return kw

        def call(target, n_lanes, u=None, prims=None, lane=None):
            t = tabs[target][3]
            return rk.receive_megakernel(t.params, t.prim, t.txp,
                                         n_lanes=n_lanes, seed=SEED,
                                         uniforms=u, prims=prims,
                                         lane_out=lane, **kwargs(target))

        def launched(what, target=None):
            if not rk.launched_prim_kernel(coh, target == PRIM_TEX):
                fail(f'{what}: the launch record does not show the prims '
                     'twin')

        def parity(target, n, u, what):
            # I / Q lane by lane, with each connection's own slack
            return _twin_parity(
                torch, rk, dev, tabs[target], kwargs(target), n, u,
                lambda: rk.launched_prim_kernel(coh, target == PRIM_TEX),
                what, tag, chunk=min(COH_PLAIN_CHUNK if coh else PLAIN_CHUNK,
                                     n), lanes=coh, cond=True, prims=True)

        # ---- 3. each twin against its plain version: injected uniforms,
        # then the Philox stream at the main path's width ----
        errs, plain, stats = [], {}, {}
        nd = rk.n_draws(depth)
        for target in scenes:
            for n, u in ((PRIM_PARITY_LANES, torch.rand(
                    (nd, PRIM_PARITY_LANES), generator=gen, device=dev)),
                    (lanes, None)):
                c, st, ms = parity(
                    target, n, u, f'{twin} prims ({target}) '
                    f'{"injected" if u is not None else "philox"} 2^'
                    f'{n.bit_length() - 1} lanes, depth {depth}')
                errs.append(c)
            stats[target], plain[target] = st, ms

        # ---- the anchors and the floor, on the card ----
        grids = {k: call(k, PRIM_ANCHOR_LANES)[0] for k in
                 (None,) + PRIM_TARGETS}
        torch.cuda.synchronize()
        base = grids[None]
        scale = float(base.abs().max())
        for target in PRIM_TARGETS:
            s, _, rx, _ = tabs[target]
            g = grids[target]
            prof = g[:, 0] if not coh else g[:, 0].square().sum(-1)
            b = int(round(round_trip_bin(
                s, rx, (0.0, -target_range(target), 0.0))))
            pk = int(prof.argmax())
            moved = float((g - base).abs().max()) / (TOL * scale)
            print(f'{twin} prims anchor {target}: peak bin {pk}, near-surface '
                  f'round trip {b} (window [{b - 1}, {b + 3}]); moves the '
                  f'grid {moved:.1f} x the parity bound {TOL} x max|acc| '
                  f'(floor {PRIM_MOVED}), 2^'
                  f'{PRIM_ANCHOR_LANES.bit_length() - 1} lanes')
            if not b - 1 <= pk <= b + 3:
                fail(f'{twin} {target}: peak at {pk}, anchor {b}')
            if not moved > PRIM_MOVED:
                fail(f'{twin} {target}: moves the grid by {moved:.1f} x '
                     'the parity bound only')

        # ---- 4. the main path: receive() of each target ----
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)
        recv = {}
        for target in scenes:
            s, sd, rx, _ = tabs[target]

            def run_main(seed, s=s, sd=sd, rx=rx):
                return bt.receive(s, sd, rx, seed=seed, spp=lanes,
                                  max_depth=depth, coherent=coh,
                                  time_sampling='gate', device=dev)

            run_main(1)
            call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 4)
            launched(f'receive() {target} {twin}', target)
            b = round(round_trip_bin(s, rx, (
                0.0, -target_range(target.split('_')[0]), 0.0)))
            sig = bt.develop_signal(adc, n, rx.adc)
            want = (rx.adc.n_time, 1, 2) if coh else (rx.adc.n_time, 1, 1)
            if tuple(sig.shape) != want or not bool(torch.isfinite(sig).all()):
                fail(f'{target} {twin}: signal {tuple(sig.shape)} not '
                     'finite / wrong shape')
            prof = sig[:, 0].square().sum(-1) if coh else sig[:, 0, 0]
            pk = int(prof.argmax())
            print(f'receive() {target} {twin}: peak bin {pk}, anchor {b}')
            if not b - 1 <= pk <= b + 3:
                fail(f'receive() {target} {twin}: peak at {pk}, anchor {b}')
            recv[target] = statistics.median(call_ms)
            print(f'receive() {target} {twin} 2^{lanes.bit_length() - 1} '
                  f'samples depth {depth}: median {recv[target]:.3f} '
                  f'ms/call ({lanes / (recv[target] * 1e-3):.4e} '
                  f'samples/s), calls {[round(x, 3) for x in call_ms]} '
                  f'{tag}')
        launches = rk.receive_megakernel.launches
        by_cfg = dict(rk.receive_megakernel.by_config)
        tex_name = f'{twin}_tex_prims'
        if launches != 20 or by_cfg[cfg_name] != 15 \
                or by_cfg[tex_name] != 5:
            fail(f'the {twin} prims path launched K1 {by_cfg} in 20 '
                 'receive() calls')
        cpi_launches = prim_cpi(torch, bt, rk, dev, tag, tabs['sphere'],
                                depth) if coh else None

        # ---- each twin alone on each target, and on the plate beside the
        # rectangle kernel (alternating, the same process) ----
        k_ms = {}
        for target in scenes:
            t_ms, _ = cuda_ms(lambda i: call(target, lanes), 5)
            k_ms[target] = statistics.median(t_ms[1:])
        med = _alternating({pr: (lambda pr=pr: call('plate', lanes,
                                                    prims=pr))
                            for pr in (True, False)}, PRIM_PAIRS)
        print(f'receive_megakernel ({twin}) 2^{lanes.bit_length() - 1} lanes '
              f'depth {depth}: ' + ', '.join(
                  f'{k} {v:.3f} ms' for k, v in k_ms.items())
              + f'; the plate: rectangle kernel {med[False]:.3f} ms, prims '
              f'twin {med[True]:.3f} ms ({med[True] / med[False]:.4f}) '
              f'{tag}')
        # the twin on the plate is held to the plain version (FMA
        # contraction may differ between the two instantiations: the
        # emulation, which contracts nothing, gives them bit for bit)
        what = (f'{twin} prims twin on the plate, philox 2^'
                f'{PRIM_ANCHOR_LANES.bit_length() - 1} lanes')
        errs.append(parity('plate', PRIM_ANCHOR_LANES, None, what)[0])
        a = call('plate', PRIM_ANCHOR_LANES, prims=True)[0]
        launched(f'plate {twin}')
        b2 = call('plate', PRIM_ANCHOR_LANES, prims=False)[0]
        print(f'{what}: against the rectangle kernel max diff '
              f'{float((a - b2).abs().max()) / float(b2.abs().max()):.3e} '
              f'of max, bit for bit {torch.equal(a, b2)}')

        # the bounds, from the sphere's stage counts on the main path's
        # stream (over the checkerboard: the texels read too)
        b, mix = {}, {}
        for target in ('sphere', PRIM_TEX):
            _, _, rx, t = tabs[target]
            kinds = {k: int((t.prim[:, 0] == code).sum()) for k, code in
                     (('sphere', 1), ('disk', 2), ('cylinder', 3))}
            n_rec = int(((t.prim[:, 0] >= 0) & (t.prim[:, 0] <= 3)).sum())
            n_bytes = 4 * (t.params.numel() + t.prim.numel() + t.txp.numel()
                           + (0 if t.tex is None else t.tex.numel())
                           + rx.adc.n_time * (2 if coh else 1)) + 8
            b[target] = bound(lane_ops(stats[target], n_rec, kinds=kinds),
                              n_bytes, f'{twin} prims ({target}) 2^'
                              f'{lanes.bit_length() - 1} lanes')
            geom = rk.launch_geometry(rx.adc.n_time, lanes,
                                      int(t.prim.shape[0]), doppler=coh,
                                      coherent=coh, tex=t.textured,
                                      prims=True)
            mix[target] = kernel_mix(dev, tag, build_log, cubin,
                                     f'{twin}_{target}', geom, sms)
            print(f'{twin} prims bounds ({target}): FP32 '
                  f'{b[target]["bound_ms"]:.4f} ms, issue slots '
                  f'{mix[target]["issue_slot_bound_ms"]:.4f} ms; kernel '
                  f'{k_ms[target]:.3f} ms {tag}')
        entries.append({
            'name': 'receive_megakernel',
            'configuration': f'{twin} prims', 'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': '_make_kernel (pallas_receive.py:106), '
            'intersect (:656-798) and occluded (:947-998), spheres, disks '
            'and cylinders',
            'main_path': f'receive(flagship_scene(target=...)), sphere, '
            f'disk and cylinder, 2^{lanes.bit_length() - 1} samples, depth '
            f'{depth}' + (', coherent' if coh else ''),
            'launches': by_cfg[cfg_name],
            'max_abs_err': max(c['err'] for c in errs[:6] + errs[8:]),
            'parity': max(c['rel'] for c in errs[:6] + errs[8:]),
            'philox_max_abs_err': max(c['err'] for c in errs[1:6:2]),
            'ms': k_ms['sphere'], 'disk_ms': k_ms['disk'],
            'cylinder_ms': k_ms['cylinder'], 'plate_ms': med[True],
            'plate_rect_kernel_ms': med[False],
            'plain_ms': plain['sphere'], 'plain_disk_ms': plain['disk'],
            'plain_cylinder_ms': plain['cylinder'],
            'receive_ms': recv['sphere'], 'receive_disk_ms': recv['disk'],
            'receive_cylinder_ms': recv['cylinder'], **b['sphere'],
            'library_ms': None, **mix['sphere']})
        if coh:
            entries[-1]['cpi_launches'] = cpi_launches
        entries.append({
            'name': 'receive_megakernel',
            'configuration': f'{twin} prims textures', 'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': '_make_kernel (pallas_receive.py:106), '
            'intersect (:656-798) and occluded (:947-998), spheres, disks '
            'and cylinders, with the texture twins\' codes',
            'main_path': f'receive(flagship_scene(target=\'sphere\', '
            f'ground_texture=\'checkerboard\')), 2^'
            f'{lanes.bit_length() - 1} samples, depth {depth}'
            + (', coherent' if coh else ''),
            'launches': by_cfg[tex_name],
            'max_abs_err': max(c['err'] for c in errs[6:8]),
            'parity': max(c['rel'] for c in errs[6:8]),
            'ms': k_ms[PRIM_TEX], 'plain_ms': plain[PRIM_TEX],
            'receive_ms': recv[PRIM_TEX], **b[PRIM_TEX], 'library_ms': None,
            **mix[PRIM_TEX]})
    print(f'prims phase wall {time.perf_counter() - t_phase:.1f} s {tag}')
    return entries


def prim_cpi(torch, bt, rk, dev, tag, tab, depth) -> int:
    """A coherent CPI of the sphere scene: receive_cpi() launches the
    coherent prims twin once a call (its pulse axis), and the launch is
    held pulse by pulse against the plain version on each pulse's Philox
    stream (the phase slack with the connections' own, the lanes'
    amplitude sums).  Returns the twin's CPI launches in three calls."""
    s, _, rx, _ = tab
    prf, seed = 100.0, SEED
    for fn in (rk.receive_megakernel, rk.receive_megakernel_cpi):
        fn.launches = 0
        fn.by_config = dict.fromkeys(rk.CONFIGS, 0)
    with _Wavefront(bt) as wfc:
        for i in range(3):
            cube, n = bt.receive_cpi(
                s, n_pulses=PRIM_CPI_PULSES, prf=prf, seed=seed + i,
                spp=PRIM_CPI_LANES, max_depth=depth, time_sampling='gate',
                device=dev)
    torch.cuda.synchronize()
    launches = rk.receive_megakernel_cpi.by_config['coherent_prims']
    if launches != 3 or rk.receive_megakernel_cpi.launches != 3 \
            or rk.receive_megakernel.launches or wfc.calls:
        fail(f'sphere CPI: {rk.receive_megakernel_cpi.by_config}, K1 alone '
             f'{rk.receive_megakernel.launches}, the wavefront {wfc.calls} '
             'times in 3 receive_cpi() calls')
    if not bool(torch.isfinite(cube).all()) \
            or cube.shape[0] != PRIM_CPI_PULSES:
        fail(f'sphere CPI: cube {tuple(cube.shape)} not finite / wrong shape')
    packed, rx, _ = rk.pack_cpi(s, PRIM_CPI_PULSES, prf)
    params, prim, txp = (torch.tensor(a, device=dev) for a in
                         (packed.params, packed.prim, packed.txp))
    params[:, 0] = rk.seed_slot(seed)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
              rx_kind='wigner', doppler=True, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, coherent=True,
              mirror=packed.mirror)
    step = 7919
    lane = torch.empty((PRIM_CPI_PULSES, PRIM_CPI_LANES), device=dev)
    acc, n_ev = rk.receive_megakernel_cpi(
        params, prim, txp, seed=seed, seed_step=step, lane_out=lane,
        n_lanes=PRIM_CPI_LANES, **kw)
    if not rk.launched_prim_kernel(True):
        fail('sphere CPI: the launch record does not show the coherent '
             'prims twin')
    slack = rk.phase_slack(s.band, rx.adc)
    worst = {'worst': 0.0, 'worst_plain': 0.0, 'flips': 0}
    for p in range(PRIM_CPI_PULSES):
        u = rk.philox_uniforms(seed + step * p, rk.n_draws(depth),
                               PRIM_CPI_LANES, device=dev)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=dev)
        cond = torch.zeros_like(amp)
        lane_ref = torch.empty(PRIM_CPI_LANES, device=dev)
        ref, n_ref = rk.receive_megakernel_ref(
            params[p], prim[p], txp[p], u, lane_out=lane_ref, amp_out=amp,
            cond_out=cond, **kw)
        c = compare_coherent(torch, acc[p], n_ev[p], ref, n_ref, amp, slack,
                             f'sphere CPI pulse {p}', lane[p], lane_ref,
                             depth=depth, quiet=True, cond=cond)
        worst = {k: max(worst[k], c[k]) for k in ('worst', 'worst_plain')} \
            | {'flips': worst['flips'] + c['flips']}
    print(f'parity sphere CPI launch (coherent prims twin), '
          f'{PRIM_CPI_PULSES} pulses x 2^{PRIM_CPI_LANES.bit_length() - 1} '
          f'philox lanes, depth {depth}: worst cell at '
          f'{worst["worst"]:.3f} of its bound ({worst["worst_plain"]:.3f} '
          f'without the connections\' own slack), {worst["flips"]} lanes '
          f'took another path; receive_cpi() launched the twin {launches} '
          f'times in 3 calls {tag}')
    return launches


# The Doppler configuration's twins: spheres, disks and cylinders and the
# textured grounds in K1's Doppler power configuration (the range-Doppler
# pulse's row: 2^24 lanes, depth 2), and the coherent prims twin under
# motion and a mirror
DP_LANES = 1 << 24             # samples a receive() call, Philox parity
DP_DEPTH = 2
DP_PARITY_LANES = 1 << 18      # injected uniforms
DP_PAIRS = 4                   # twin / rectangle kernel pairs on the plate
DP_CPI_PULSES = 8              # the closing sphere's CPI, one launch
DP_CPI_LANES = 1 << 20         # a pulse
DP_MIRROR_MIN = 8              # chains the metal sphere closes, at least
# the power scenes and the twin each launches (its launch record); the
# I / Q scenes of the coherent prims twin
DP_POWER = {'sphere': 'prims', 'disk': 'prims', 'cylinder': 'prims',
            'checker': 'tex', 'bitmap': 'tex', 'sphere_checker': 'tex_prims',
            'metal_sphere': 'prims', 'sonar_sphere': 'prims'}
DP_IQ = ('sphere', 'metal_sphere')
DP_GROUND = {'checker': 'checkerboard', 'bitmap': 'bitmap',
             'sphere_checker': 'checkerboard'}


def _dp_scene(name):
    """A scene of the doppler_prims phase: the range-Doppler pulse with
    its target ('plate', 'sphere', 'disk', 'cylinder') over a textured
    ground (DP_GROUND), the flagship's conductor sphere (the metal
    calibration target: mirror chains), golden config 2 with its
    calibration sphere (mix_resample), or ('ground') the pulse over an
    untextured ground."""
    from beifong_tpu_torch import scenes as S
    if name == 'metal_sphere':
        return S.flagship_scene(target='sphere', material='conductor')
    if name == 'sonar_sphere':
        return S.fmcw_sonar_scene(target='sphere')
    if name == 'ground':
        # the plate over the ground, untextured: the texture twin's
        # scene for the Doppler power kernel
        s, rx = S.range_doppler_scene(0)
        S.add_ground(s)
        return s, rx
    target = 'plate' if name in ('plate', 'checker', 'bitmap') \
        else name.split('_')[0]
    return S.range_doppler_scene(0, target, DP_GROUND.get(name))


def doppler_prims(torch, bt, rk, dev, tag, build_log: str,
                  cubin: str) -> list:
    """K1's Doppler power twins, receive_doppler_power_kernel<true>
    (textured rectangles), <false, true> (spheres, disks and cylinders)
    and <true, true> (both), and the coherent prims twin under motion and
    a mirror, at the range-Doppler pulse's width (2^24 lanes, depth 2):
    each against its plain version on injected uniforms and on the Philox
    stream (power lane by lane, a lane's floor PRIM_LANE_FLOOR; I / Q with
    each ill-conditioned connection's own phase slack, the reading
    without it beside); the anchors (the closing target's Doppler bin and
    its CA-CFAR cell, the static ground's ridge at 0 Hz, the metal
    sphere's range bin and its closed mirror chains, the sonar sphere's
    beat); receive() five calls a scene, each launching its twin; a
    closing sphere's CPI in one launch of the power and of the I / Q
    twin, held pulse by pulse; each twin alone, the prims twin on the
    plate beside the rectangle kernel; their bounds."""
    import numpy as np
    from beifong_tpu_torch.scenes import (FMCW_SONAR_R, RANGE_DOPPLER,
                                          fmcw_beat_hz, round_trip_bin,
                                          target_range)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tabs = _twin_tables(rk, dev, ('plate', 'ground') + tuple(DP_POWER),
                        _dp_scene)

    def kwargs(name, coh):
        _, _, rx, t = tabs[name]
        kw = dict(adc=rx.adc, max_depth=DP_DEPTH,
                  time_sampling='fixed' if name == 'sonar_sphere' else 'gate',
                  rx_kind='wigner', doppler=True, coherent=coh,
                  receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=t.mirror)
        if t.textured:
            kw.update(tex=t.tex, bmp_meta=t.bmp_meta)
        return kw

    def call(name, coh, n, u=None, prims=None, lane=None):
        t = tabs[name][3]
        return rk.receive_megakernel(t.params, t.prim, t.txp, n_lanes=n,
                                     seed=SEED, uniforms=u, prims=prims,
                                     lane_out=lane, **kwargs(name, coh))

    def record(name, coh):
        return rk.launched_prim_kernel(True) if coh \
            else rk.launched_doppler_power_kernel(DP_POWER[name])

    def launched(name, coh, what):
        if not record(name, coh):
            fail(f'{what}: the launch record does not show its twin')

    # ---- 3. each twin against its plain version: injected uniforms,
    #      then the Philox stream at the main path's width ----
    runs = [(n, False) for n in DP_POWER] + [(n, True) for n in DP_IQ]
    errs, plain, stats = {}, {}, {}
    nd = rk.n_draws(DP_DEPTH)
    for name, coh in runs:
        key = (name, coh)
        errs[key] = []
        mode = 'iq' if coh else 'power'
        for n_lanes, u in ((DP_PARITY_LANES, torch.rand(
                (nd, DP_PARITY_LANES), generator=gen, device=dev)),
                (DP_LANES, None)):
            what = (f'doppler_prims {name} {mode} '
                    f'{"injected" if u is not None else "philox"} 2^'
                    f'{n_lanes.bit_length() - 1} lanes, depth {DP_DEPTH}')
            c, st, ms = _twin_parity(
                torch, rk, dev, tabs[name], kwargs(name, coh), n_lanes, u,
                lambda: record(name, coh), what, tag, chunk=DOP_PLAIN_CHUNK,
                lanes=True, cond=True, floor=PRIM_LANE_FLOOR)
            errs[key].append(c)
        stats[key], plain[key] = st, ms
        hk = 'tex_hit' if name in ('checker', 'bitmap') else \
            ('cylinder_hit' if name == 'cylinder' else
             'disk_hit' if name == 'disk' else 'sphere_hit')
        print(f'doppler_prims {name} {mode}: {st.get(hk, 0)} of 2^'
              f'{DP_LANES.bit_length() - 1} Philox lanes hit ({hk})')
        if not st.get(hk, 0) > 0:
            fail(f'doppler_prims {name} {mode}: no lane hit ({hk})')

    # the metal sphere's mirror chains: direct transmitter hits after the
    # mirror bounce (those of depth 2 less those of depth 1)
    _, _, rx, t = tabs['metal_sphere']
    first: dict = {}
    for lane0 in range(0, DP_LANES, DOP_PLAIN_CHUNK):
        rk.receive_megakernel_ref(
            t.params, t.prim, t.txp, rk.philox_uniforms(
                SEED, rk.n_draws(1), DOP_PLAIN_CHUNK, device=dev,
                lane0=lane0), lane0=lane0, stats=first,
            **dict(kwargs('metal_sphere', False), max_depth=1))
    closed = stats[('metal_sphere', False)]['direct'] - first['direct']
    print(f'doppler_prims metal sphere: {closed} of 2^'
          f'{DP_LANES.bit_length() - 1} lanes closed a mirror chain on the '
          f'transmitter ({stats[("metal_sphere", False)]["mirror_bounce"]} '
          f'mirror bounces) {tag}')
    if closed < DP_MIRROR_MIN:
        fail(f'doppler_prims metal sphere: {closed} mirror chains closed')

    # ---- 4. the main path: receive() of each scene, and the anchors ----
    rk.receive_megakernel.launches = 0
    rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)
    recv, sigs = {}, {}
    with _Wavefront(bt) as wfc:
        for name, coh in runs:
            s, sd, rx, _ = tabs[name]
            ts = 'fixed' if name == 'sonar_sphere' else 'gate'

            def run_main(seed, s=s, sd=sd, rx=rx, coh=coh, ts=ts):
                return bt.receive(s, sd, rx, seed=seed, spp=DP_LANES,
                                  max_depth=DP_DEPTH, coherent=coh,
                                  time_sampling=ts, device=dev)

            run_main(1)
            call_ms, (adc, n) = cuda_ms(lambda i: run_main(2 + i), 4)
            launched(name, coh, f'receive() {name}')
            sig = bt.develop_signal(adc, n, rx.adc)
            want = (rx.adc.n_time, rx.adc.n_freq, 2 if coh else 1)
            if tuple(sig.shape) != want or not bool(torch.isfinite(sig).all()):
                fail(f'receive() doppler_prims {name}: signal '
                     f'{tuple(sig.shape)} not finite / wrong shape')
            sigs[(name, coh)] = sig.square().sum(-1) if coh else sig[..., 0]
            recv[(name, coh)] = statistics.median(call_ms)
            print(f'receive() doppler_prims {name} {"iq" if coh else "power"}'
                  f' 2^{DP_LANES.bit_length() - 1} samples depth {DP_DEPTH}: '
                  f'median {recv[(name, coh)]:.3f} ms/call '
                  f'({DP_LANES / (recv[(name, coh)] * 1e-3):.4e} samples/s) '
                  f'{tag}')
    by_cfg = dict(rk.receive_megakernel.by_config)
    want_cfg = {'doppler_prims': 25, 'doppler_tex': 10,
                'doppler_tex_prims': 5, 'coherent_prims': 10}
    if {k: by_cfg[k] for k in want_cfg} != want_cfg or wfc.calls \
            or rk.receive_megakernel.launches != 50:
        fail(f'the doppler_prims path launched K1 {by_cfg}, the wavefront '
             f'{wfc.calls} times in 50 receive() calls')
    # the anchors: each closing target's Doppler bin and CA-CFAR cell
    for name in ('sphere', 'disk', 'cylinder', 'sphere_checker', 'checker',
                 'bitmap'):
        s, _, rx, _ = tabs[name]
        check_range_doppler(torch, sigs[(name, False)], s, rx.adc,
                            f'receive() doppler_prims {name}')
    s, _, rx, _ = tabs['sphere']
    check_range_doppler(torch, sigs[('sphere', True)], s, rx.adc,
                        'receive() doppler_prims sphere I / Q |I + jQ|^2')
    # the static ground's ridge at 0 Hz (the bare pulse has none there)
    cfg = tabs['plate'][2].adc
    f0 = int(round(_bin_coord(40e3, cfg.freq_lo, cfg.freq_hi, cfg.n_freq)))
    bare = call('plate', False, DP_LANES)[0].sum(0)
    ridge = {}
    for name in ('checker', 'bitmap', 'sphere_checker'):
        spec = sigs[(name, False)].sum(0)
        ridge[name] = float(spec[f0 - 1:f0 + 2].abs().sum()
                            / spec.abs().max())
    bare_ridge = float(bare[f0 - 1:f0 + 2].abs().sum())
    print(f'doppler_prims static ground: |power| at 0 Hz (bins {f0 - 1}-'
          f'{f0 + 1}) over the spectrum\'s largest ' + json.dumps(
              {k: float(f'{v:.4e}') for k, v in ridge.items()})
          + f'; the bare pulse {bare_ridge:.3e}')
    if bare_ridge != 0.0 or not all(v > 0.0 for v in ridge.values()):
        fail(f'doppler_prims: the ground\'s 0 Hz ridge {ridge}, the bare '
             f'pulse {bare_ridge}')
    # the metal sphere's range bin, power and I / Q
    s, _, rx, _ = tabs['metal_sphere']
    b = int(round(round_trip_bin(s, rx, (0.0, -target_range('sphere'),
                                         0.0))))
    for coh in (False, True):
        pk = int(sigs[('metal_sphere', coh)][:, 0].argmax())
        print(f'receive() doppler_prims metal sphere '
              f'{"iq" if coh else "power"}: peak bin {pk}, near-surface '
              f'round trip {b}')
        if not b - 1 <= pk <= b + 3:
            fail(f'doppler_prims metal sphere: peak at {pk}, anchor {b}')
    # the sonar sphere's beat (its near surface at FMCW_SONAR_R)
    s, _, rx, _ = tabs['sonar_sphere']
    f_beat = fmcw_beat_hz(FMCW_SONAR_R)
    f_axis = (np.arange(rx.adc.n_freq) + 0.5) / rx.adc.n_freq * (4 * f_beat)
    want_b = int(np.argmin(np.abs(f_axis - f_beat)))
    pk = int(sigs[('sonar_sphere', False)].sum(0).argmax())
    print(f'receive() doppler_prims sonar sphere: beat peak bin {pk}, slope '
          f'2R/c at bin {want_b}')
    if abs(pk - want_b) > 2:
        fail(f'doppler_prims sonar sphere: beat peak at {pk}, want {want_b}')

    # ---- a closing sphere's CPI: one launch a call, power and I / Q ----
    s = tabs['sphere'][0]
    cpi = {}
    for coh in (False, True):
        for fn in (rk.receive_megakernel, rk.receive_megakernel_cpi):
            fn.launches = 0
            fn.by_config = dict.fromkeys(rk.CONFIGS, 0)
        with _Wavefront(bt) as wfc:
            cube, n = bt.receive_cpi(
                s, n_pulses=DP_CPI_PULSES, prf=RANGE_DOPPLER['prf'],
                seed=SEED, spp=DP_CPI_LANES, max_depth=DP_DEPTH,
                time_sampling='gate', coherent=coh, device=dev)
        torch.cuda.synchronize()
        cfg_name = 'coherent_prims' if coh else 'doppler_prims'
        cpi[coh] = rk.receive_megakernel_cpi.by_config[cfg_name]
        if cpi[coh] != 1 or rk.receive_megakernel_cpi.launches != 1 \
                or rk.receive_megakernel.launches or wfc.calls \
                or not bool(torch.isfinite(cube).all()):
            fail(f'doppler_prims sphere CPI: '
                 f'{rk.receive_megakernel_cpi.by_config}, K1 alone '
                 f'{rk.receive_megakernel.launches}, the wavefront '
                 f'{wfc.calls} times')
        packed, rx, _ = rk.pack_cpi(s, DP_CPI_PULSES, RANGE_DOPPLER['prf'])
        params, prim, txp = (torch.tensor(a, device=dev) for a in
                             (packed.params, packed.prim, packed.txp))
        params[:, 0] = rk.seed_slot(SEED)
        kw = dict(adc=rx.adc, max_depth=DP_DEPTH, time_sampling='gate',
                  rx_kind='wigner', doppler=True,
                  receive_type=rx.receive_type, has_lo=False, coherent=coh,
                  mirror=packed.mirror)
        lane = torch.empty((DP_CPI_PULSES, DP_CPI_LANES), device=dev)
        acc, n_ev = rk.receive_megakernel_cpi(
            params, prim, txp, seed=SEED, seed_step=7919, lane_out=lane,
            n_lanes=DP_CPI_LANES, **kw)
        launched('sphere', coh, 'doppler_prims sphere CPI')
        worst = 0.0
        for p in range(DP_CPI_PULSES):
            u = rk.philox_uniforms(SEED + 7919 * p, nd, DP_CPI_LANES,
                                   device=dev)
            lane_ref = torch.empty(DP_CPI_LANES, device=dev)
            amp = torch.zeros((rx.adc.n_time, rx.adc.n_freq),
                              dtype=torch.float64, device=dev)
            cond = torch.zeros_like(amp) if coh else None
            ref, n_ref = rk.receive_megakernel_ref(
                params[p], prim[p], txp[p], u, lane_out=lane_ref,
                amp_out=amp, cond_out=cond, **kw)
            what = f'doppler_prims sphere CPI pulse {p}'
            if coh:
                c = compare_coherent(
                    torch, acc[p], n_ev[p], ref, n_ref, amp,
                    rk.phase_slack(s.band, rx.adc), what, lane[p], lane_ref,
                    depth=DP_DEPTH, quiet=True, cond=cond)
            else:
                c = compare_lanes(acc[p], n_ev[p], lane[p], ref, n_ref,
                                  lane_ref, DP_DEPTH, what,
                                  floor=PRIM_LANE_FLOOR)
            worst = max(worst, c.get('worst', c['rel']))
        print(f'parity doppler_prims sphere CPI ({"iq" if coh else "power"}'
              f'), {DP_CPI_PULSES} pulses x 2^'
              f'{DP_CPI_LANES.bit_length() - 1} philox lanes in one launch: '
              f'worst {worst:.3e} {tag}')

    # ---- each twin alone, and the prims twin on the plate beside the
    #      rectangle kernel (alternating, the same process) ----
    k_ms = {}
    for name, coh in runs:
        t_ms, _ = cuda_ms(lambda i: call(name, coh, DP_LANES), 5)
        k_ms[(name, coh)] = statistics.median(t_ms[1:])
    med = _alternating({pr: (lambda pr=pr: call('plate', False, DP_LANES,
                                                prims=pr))
                        for pr in (True, False)}, DP_PAIRS)
    # over the grounds: the Doppler power kernel on the untextured one, the
    # texture twin and the textured prims twin (<true, true>) on the
    # checkerboard
    med_g = _alternating({g: (lambda g=g: call(
        g.split('_')[0], False, DP_LANES,
        prims=True if g == 'checker_prims' else None))
        for g in ('ground', 'checker', 'checker_prims')}, DP_PAIRS)
    print(f'receive_megakernel (doppler twins) 2^{DP_LANES.bit_length() - 1}'
          f' lanes depth {DP_DEPTH}: ' + ', '.join(
              f'{n}{" iq" if c else ""} {v:.3f} ms'
              for (n, c), v in k_ms.items())
          + f'; the plate: Doppler power kernel {med[False]:.3f} ms, prims '
          f'twin {med[True]:.3f} ms ({med[True] / med[False]:.4f}); over '
          f'an untextured ground the Doppler power kernel '
          f'{med_g["ground"]:.3f} ms, over the checkerboard the texture twin '
          f'{med_g["checker"]:.3f} ms '
          f'({med_g["checker"] / med_g["ground"]:.4f}) and the textured '
          f'prims twin {med_g["checker_prims"]:.3f} ms '
          f'({med_g["checker_prims"] / med_g["ground"]:.4f}) {tag}')

    # the bounds and the instruction mix of each new instantiation
    entries = []
    for name, cfg_name, label in (
            ('sphere', 'doppler_prims', 'doppler prims'),
            ('checker', 'doppler_tex', 'doppler textures'),
            ('sphere_checker', 'doppler_tex_prims',
             'doppler prims textures')):
        s, _, rx, t = tabs[name]
        key = (name, False)
        kinds = {k: int((t.prim[:, 0] == code).sum()) for k, code in
                 (('sphere', 1), ('disk', 2), ('cylinder', 3))}
        n_rec = int(((t.prim[:, 0] >= 0) & (t.prim[:, 0] <= 3)).sum())
        n_cells = rx.adc.n_time * rx.adc.n_freq
        n_bytes = 4 * (t.params.numel() + t.prim.numel() + t.txp.numel()
                       + (0 if t.tex is None else t.tex.numel())
                       + n_cells) + 8
        b = bound(lane_ops(stats[key], n_rec, kinds=kinds), n_bytes,
                  f'{label} ({name}) 2^{DP_LANES.bit_length() - 1} lanes')
        geom = rk.launch_geometry(rx.adc.n_time, DP_LANES,
                                  int(t.prim.shape[0]), n_freq=rx.adc.n_freq,
                                  doppler=True, tex=t.textured,
                                  prims=t.prims)
        mix = kernel_mix(dev, tag, build_log, cubin, f'doppler_{name}',
                         geom, sms)
        print(f'{label} bounds ({name}): FP32 {b["bound_ms"]:.4f} ms, issue '
              f'slots {mix["issue_slot_bound_ms"]:.4f} ms; kernel '
              f'{k_ms[key]:.3f} ms {tag}')
        names = [n for n, c in runs if not c and DP_POWER[n] ==
                 cfg_name[len('doppler_'):]]
        e = [c for n in names for c in errs[(n, False)]]
        entries.append({
            'name': 'receive_megakernel', 'configuration': label,
            'route': 'cuda',
            'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
            'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
            'tpu_function': '_make_kernel (pallas_receive.py:106) in its '
            'Doppler configuration (:624-629), intersect (:656-798) and '
            'occluded (:947-998)' + (', the texture codes (:762-776)'
                                     if 'tex' in cfg_name else ''),
            'main_path': 'receive() of ' + ', '.join(names) + f', 2^'
            f'{DP_LANES.bit_length() - 1} samples, depth {DP_DEPTH}',
            'launches': by_cfg[cfg_name] + (cpi[False] if cfg_name ==
                                            'doppler_prims' else 0),
            'max_abs_err': max(c['err'] for c in e),
            'parity': max(c['rel'] for c in e),
            'ms': k_ms[key], 'plain_ms': plain[key],
            'receive_ms': recv[key],
            'kernel_ms_by_scene': {n: k_ms[(n, False)] for n in names},
            **b, 'library_ms': None, **mix})
        if cfg_name == 'doppler_prims':
            entries[-1].update(plate_ms=med[True],
                               plate_rect_kernel_ms=med[False],
                               mirror_chains_closed=closed)
        if cfg_name == 'doppler_tex':
            entries[-1].update(checker_pairs_ms=med_g['checker'],
                               plain_ground_rect_kernel_ms=med_g['ground'])
        if cfg_name == 'doppler_tex_prims':
            entries[-1].update(checker_ms=med_g['checker_prims'],
                               plain_ground_rect_kernel_ms=med_g['ground'])
    e = [c for n in DP_IQ for c in errs[(n, True)]]
    entries.append({
        'name': 'receive_megakernel',
        'configuration': 'coherent prims, Doppler conditions',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106) coherent, '
        'moving and mirror, spheres (:656-798)',
        'main_path': 'receive(coherent=True) of the closing sphere and the '
        f'metal sphere, 2^{DP_LANES.bit_length() - 1} samples, depth '
        f'{DP_DEPTH}', 'launches': by_cfg['coherent_prims'] + cpi[True],
        'max_abs_err': max(c['err'] for c in e),
        'parity': max(c['rel'] for c in e),
        'worst_of_gate': max(c['worst'] for c in e),
        'worst_of_plain_gate': max(c['worst_plain'] for c in e),
        'ms': k_ms[('sphere', True)], 'metal_ms': k_ms[('metal_sphere',
                                                        True)],
        'plain_ms': plain[('sphere', True)],
        'receive_ms': recv[('sphere', True)],
        **bound(lane_ops(stats[('sphere', True)], 3, kinds={'sphere': 1}),
                4 * (tabs['sphere'][3].params.numel()
                     + tabs['sphere'][3].prim.numel()
                     + tabs['sphere'][3].txp.numel()
                     + 2 * tabs['sphere'][2].adc.n_time
                     * tabs['sphere'][2].adc.n_freq) + 8,
                'coherent prims (closing sphere)'),
        'library_ms': None})
    print(f'doppler_prims phase wall {time.perf_counter() - t_phase:.1f} s '
          f'{tag}')
    return entries


# MIMO receive: golden config 6 through K1's MIMO configuration
MIMO_PARITY_LANES = 1 << 14   # injected uniforms, all 2E channels
MIMO_LANES = 1 << 24          # receive_mimo() and the kernel alone
MIMO_BENCH_LANES = 1 << 22    # bench.py's _mimo_rate size
MIMO_WF_SAMPLES = 1 << 20     # K1 against the MIMO wavefront
MIMO_WF_CORR = 0.9            # their DAS azimuth spectra, correlated


def mimo(torch, bt, rk, dev, tag, build_log: str = '',
         cubin: str = '') -> list:
    """K1's MIMO configuration on golden config 6: parity, the anchors of
    receive_mimo() and the beamformers, the main path's times, the kernel
    alone, K1 against the MIMO wavefront."""
    import numpy as np
    from beifong_tpu_torch import scenes
    from beifong_tpu_torch.dsp import beamform as bf
    m = scenes.MIMO
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s, rx = scenes.mimo_beamform_scene()
    sd = s.compile(device=dev)
    packed = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                              rx.id))
    params = torch.tensor(packed.params, device=dev)
    params[0] = rk.seed_slot(SEED)
    prim = torch.tensor(packed.prim, device=dev)
    txp = torch.tensor(packed.txp, device=dev)
    rxph = torch.tensor(packed.rxph, device=dev)
    eoff = rk.array_offsets(s, sd, rx, dev)
    n_e = int(eoff.shape[0])
    depth = m['max_depth']
    # the tables' mirror flag, as the main path passes it (read back from
    # the card at each call otherwise: a host stall in the timed window)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
              rx_kind='phased', doppler=True, rxph=rxph, eoff=eoff,
              mirror=bool(packed.mirror))
    slack = rk.phase_slack(s.band, rx.adc, mimo=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, smem = rk.launch_geometry(
        rx.adc.n_time, MIMO_LANES, int(prim.shape[0]), doppler=True,
        coherent=True, n_elem=n_e)
    print(f'receive_megakernel (mimo) geometry at 2^24 lanes: {blocks} '
          f'blocks x {threads} threads, {smem} B shared each, '
          f'{blocks / sms:g} blocks per SM on {sms} SMs; grid mode '
          f'{rk.grid_mode(rx.adc.n_time, True, True, n_e)} '
          f'({rx.adc.n_time} x {2 * n_e} float64) {tag}')

    def reset():
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)

    # ---- 3. parity on injected uniforms, lane by lane ----
    n_l = MIMO_PARITY_LANES
    u = torch.rand((rk.n_draws(depth), n_l), generator=gen, device=dev)
    lane = torch.empty(n_l, device=dev)
    lane_ref = torch.empty(n_l, device=dev)
    amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64, device=dev)
    acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_l,
                                      uniforms=u, lane_out=lane, **kw)
    ref, n_ref = rk.receive_megakernel_ref(params, prim, txp, u,
                                           lane_out=lane_ref, amp_out=amp,
                                           **kw)
    if tuple(acc.shape) != (rx.adc.n_time, 1, 2 * n_e):
        fail(f'mimo: kernel grid {tuple(acc.shape)}')
    errs = [compare_coherent(torch, acc, n_ev, ref, n_ref, amp, slack,
                             'config 6 (MIMO, 16 channels) injected 2^14 '
                             'lanes, gate', lane, lane_ref, depth=depth)]

    # ---- 4. the main path: receive_mimo() and the beamformers ----
    def beamform(cube):
        B = bf.delay_and_sum(cube, eoff, dirs, m['fc'], s.band.c)
        das = (B.abs() ** 2).sum(dim=(1, 2))
        return B, das, bf.mvdr_spectrum(cube, eoff, dirs, m['fc'], s.band.c)

    az, dirs, want = scenes.mimo_azimuth_scan(device=dev)
    # each call's launch record: the MIMO array kernel
    record = []

    def receive_mimo(**k):
        out = bt.receive_mimo(s, sd, rx, max_depth=depth,
                              time_sampling='gate', device=dev, **k)
        record.append(rk.launched_mimo_kernel())
        return out

    reset()
    with _Wavefront(bt, '_receive_mimo_pass') as wfc:
        adc, n = receive_mimo(spp=m['spp'], seed=m['seed'])
        cube = bt.develop_mimo(adc, n, rx.adc)
        B, das, mvdr = beamform(cube)
        rates = {}
        for n_s in (MIMO_LANES, MIMO_BENCH_LANES):
            receive_mimo(spp=n_s, seed=1)
            rates[n_s] = cuda_ms(lambda i: receive_mimo(spp=n_s, seed=2 + i),
                                 5)[0]
    launches = rk.receive_megakernel.by_config['mimo']
    if launches != 13 or rk.receive_megakernel.launches != 13 or wfc.calls:
        fail(f'mimo path launched K1 {rk.receive_megakernel.by_config}, the '
             f'wavefront {wfc.calls} times in 13 receive_mimo() calls')
    print(f'mimo path launch record: receive_mimo_array_kernel on '
          f'{sum(record)} of {len(record)} receive_mimo() calls')
    if len(record) != 13 or not all(record):
        fail('mimo: the launch record does not show '
             'receive_mimo_array_kernel on all 13 receive_mimo() calls')
    if tuple(adc.shape) != (64, 1, 2 * n_e + 2) or not bool(
            torch.isfinite(adc).all()):
        fail(f'mimo: grid {tuple(adc.shape)} not finite / wrong shape')
    pk_das, pk_mvdr = int(das.argmax()), int(mvdr.argmax())
    sharp_das = float(das.max() / das.median())
    sharp_mvdr = float(mvdr.max() / mvdr.median())
    y = B[pk_das, :, 0].abs() ** 2
    cfg = rx.adc
    t_bin = int(y.argmax())
    want_t = (2 * m['R'] / s.band.c - cfg.sampling_start) \
        / cfg.sampling_time * cfg.n_time - 0.5
    print(f'receive_mimo() config 6, 2^13 samples depth 2, gate: DAS peak '
          f'bin {pk_das} ({np.degrees(az[pk_das]):.1f} deg), MVDR {pk_mvdr}, '
          f'the target at bin {want} ({m["az_deg"]} deg); peak / median '
          f'DAS {sharp_das:.1f}, MVDR {sharp_mvdr:.1f}; beamformed profile '
          f'peak bin {t_bin}, 2R/c at {want_t:.2f} {tag}')
    if abs(pk_das - want) > 2 or abs(pk_mvdr - want) > 2 \
            or not sharp_das > 5.0 or not sharp_mvdr > sharp_das \
            or abs(t_bin - want_t) > 2:
        fail('mimo: config 6 anchors missed')
    for n_s, times in rates.items():
        med = statistics.median(times)
        print(f'receive_mimo() config 6, 2^{n_s.bit_length() - 1} samples '
              f'depth 2, gate: median {med:.3f} ms/call '
              f'({n_s / (med * 1e-3):.4e} samples/s), calls '
              f'{[round(x, 3) for x in times]} {tag}')
    recv_ms = statistics.median(rates[MIMO_LANES])
    bf_ms, _ = cuda_ms(lambda i: beamform(cube), 6)
    bf_med = statistics.median(bf_ms[1:])
    print(f'beamform config 6 (delay-and-sum + MVDR spectrum, 81 '
          f'azimuths, 8 x 64 cube): median {bf_med:.3f} ms '
          f'{[round(x, 3) for x in bf_ms[1:]]} {tag}')

    # ---- the kernel alone and against the plain version on Philox ----
    k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
        params, prim, txp, n_lanes=MIMO_LANES, seed=SEED, **kw), 6)
    k_med = statistics.median(k_ms[1:])
    lane = torch.empty(MIMO_LANES, device=dev)
    lane_ref = torch.empty(MIMO_LANES, device=dev)
    acc1, n1 = rk.receive_megakernel(params, prim, txp, n_lanes=MIMO_LANES,
                                     seed=SEED, lane_out=lane, **kw)
    acc2, n2 = rk.receive_megakernel(params, prim, txp, n_lanes=MIMO_LANES,
                                     seed=SEED, **kw)
    ref, n_ref, amp, stats, plain_ms = _plain_philox(
        torch, rk, params, prim, txp, kw, MIMO_LANES, depth, dev,
        lane_ref=lane_ref)
    rep = float((acc1 - acc2).abs().max())
    amp_max = float(amp.max())
    print(f'parity config 6 philox 2^24 lanes: two calls differ by at most '
          f'{rep:.3e} ({rep / amp_max:.3e} of the largest amplitude sum) '
          f'per cell, events {int(n1)} / {int(n2)}')
    if not (rep <= REPEAT_TOL * amp_max and int(n1) == int(n2)):
        fail('mimo: two Philox-mode calls with one seed differ')
    c = compare_coherent(torch, acc1, n1, ref, n_ref, amp, slack,
                         'config 6 (MIMO) philox 2^24 lanes', lane, lane_ref,
                         depth=depth)
    print(f'receive_megakernel (mimo) 2^24 lanes depth 2: median '
          f'{k_med:.3f} ms ({MIMO_LANES / (k_med * 1e-3):.4e} samples/s) '
          f'{[round(x, 3) for x in k_ms[1:]]}; plain version {plain_ms:.1f} '
          f'ms {tag}')
    print('mimo stage lanes: ' + json.dumps(stats))
    mix = kernel_mix(dev, tag, build_log, cubin, 'mimo',
                     (blocks, threads, smem), sms) if cubin else {}

    # ---- K1 against the MIMO wavefront ----
    spec = {}
    for use in (True, False):
        ms, (a, n_w) = wall_ms(lambda: bt.receive_mimo(
            s, sd, rx, spp=MIMO_WF_SAMPLES, max_depth=depth, seed=3,
            time_sampling='gate', use_kernel=use,
            lanes_per_pass=KW_LANES_PER_PASS, device=dev))
        _, d_u, _ = beamform(bt.develop_mimo(a, n_w, rx.adc))
        spec[use] = d_u.cpu().double().numpy()
        print(f'receive_mimo config 6 use_kernel={use}: {ms:.1f} ms for '
              f'2^20 samples, DAS peak bin {int(d_u.argmax())} {tag}')
    corr = float(np.corrcoef(spec[True] / spec[True].max(),
                             spec[False] / spec[False].max())[0, 1])
    print(f'K1 against the MIMO wavefront, config 6 at 2^20 samples: DAS '
          f'azimuth spectra correlated {corr:.4f} (bound > {MIMO_WF_CORR})')
    if not corr > MIMO_WF_CORR:
        fail('mimo: K1 and the MIMO wavefront disagree')
    print(f'mimo phase wall {time.perf_counter() - t_phase:.1f} s {tag}')
    return [_kernel_entry(
        torch, rk, 'mimo', 'config 6 2^24 lanes',
        'receive_mimo(mimo_beamform_scene()), 2^13 samples for the anchors '
        'and 2^24 / 2^22 timed, depth 2, gate; develop_mimo, delay_and_sum, '
        'mvdr_spectrum', launches, errs + [c], k_med, plain_ms, recv_ms,
        stats, [params, prim, txp, rxph, eoff], rx.adc.n_time, 2 * n_e,
        dict(row='K1 MIMO', repeat_rel=rep / amp_max,
             lanes_on_another_path=c['flips'],
             receive_ms_2_22=statistics.median(rates[MIMO_BENCH_LANES]),
             beamform_ms=bf_med, k1_wavefront_corr=corr, **mix))]


MEDIA_PARITY_LANES = 1 << 14   # injected uniforms, each medium kind
MEDIA_LANES = 1 << 24          # Philox parity, receive() and the kernel
MEDIA_ANCHOR = 0.10            # attenuation against its closed form
MEDIA_WF_SAMPLES = 1 << 20     # the half-space grid through the wavefront
MEDIA_DEPTH = 2
# FP32 operations of one optical depth and its exp (counted by hand from
# seg_tau in csrc/receive_megakernel.cu as FP32_OPS is): homogeneous a
# product, its exp and the throughput's product; layered 10 a step (the
# edge, then sub, max, mul, add for each end) plus the ends and the
# division; a grid 19 a sample (coordinates, floors, the add) x 16
MEDIA_OPS = {'homogeneous': 3, 'grid': 16 * 19 + 7}


def media_ops(stats: dict, kind: str, k_layers: int = 0) -> float:
    per = 10 * k_layers + 1 if kind == 'layered' else MEDIA_OPS[kind]
    return (stats.get('med_seg', 0) + stats.get('med_conn', 0)) * per


def media(torch, bt, rk, dev, tag) -> list:
    """K1's media configuration on examples/stratified_medium.py's scene:
    the echo attenuation against its closed form (receive() at 2^14 and
    2^24), a uniform grid against the homogeneous medium, the half-space
    grid against the wavefront, each medium kind in the flagship and the
    coherent instantiations against the plain version (injected uniforms
    on the point target, Philox at 2^24 on the example), one receive_cpi
    through a medium, and the times of vacuum, K = 4, K = 32, homogeneous
    and the 8 x 8 x 128 grid at 2^24 samples."""
    import numpy as np
    from beifong_tpu_torch import scenes
    from beifong_tpu_torch import media as mt
    st = scenes.STRATIFIED
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kinds = {'homogeneous': scenes.stratified_homogeneous(),
             'layered': scenes.stratified_layers(4),
             'grid': scenes.medium_grid()}

    def reset():
        for fn in (rk.receive_megakernel, rk.receive_megakernel_cpi):
            fn.launches = 0
            fn.by_config = dict.fromkeys(rk.CONFIGS, 0)

    def media_launches():
        return sum(v for fn in (rk.receive_megakernel,
                                rk.receive_megakernel_cpi)
                   for k, v in fn.by_config.items() if k.endswith('_media'))

    def tables(s, rx, sd=None):
        sd = sd or s.compile(device=dev)
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                            rx.id))
        params = torch.tensor(p.params, device=dev)
        params[0] = rk.seed_slot(SEED)
        grid = None if p.grid is None else torch.tensor(p.grid, device=dev)
        return (params, torch.tensor(p.prim, device=dev),
                torch.tensor(p.txp, device=dev),
                dict(medium=p.medium, grid=grid))

    def profile(med, spp, **kw):
        s, rx = bt.stratified_medium_scene(med)
        a, n = bt.receive(s, receiver=rx, spp=spp, max_depth=MEDIA_DEPTH,
                          seed=st['seed'], device=dev, **kw)
        return bt.develop_signal(a, n, rx.adc)[:, 0, 0].cpu().numpy()

    s0, rx0 = bt.stratified_medium_scene()
    want = scenes.two_leg_transmittance(s0, rx0, kinds['layered'])
    # ---- 4. the main path: the example through receive(), its anchors ----
    reset()
    anchors = {}
    for spp in (st['spp'], MEDIA_LANES):
        att = scenes.echo_attenuation(profile(None, spp),
                                      profile(kinds['layered'], spp))
        anchors[spp] = att
        print(f'stratified_medium receive() 2^{spp.bit_length() - 1} '
              f'samples depth 2, fixed: echo attenuation {att:.4f}, the '
              f'closed form {want:.4f} ({att / want - 1:+.2%}) {tag}')
        if not (0.05 < att < 0.9 and abs(att / want - 1) < MEDIA_ANCHOR):
            fail(f'media: the example\'s attenuation {att:.4f} at {spp} '
                 f'samples misses {want:.4f}')
    out = {}
    for name, med in (('homogeneous', kinds['homogeneous']),
                      ('uniform grid', kinds['grid'])):
        s, rx = bt.stratified_medium_scene(med)
        out[name], _ = bt.receive(s, receiver=rx, spp=MEDIA_LANES,
                                  max_depth=MEDIA_DEPTH, seed=st['seed'],
                                  time_sampling='gate', device=dev)
    scale = float(out['homogeneous'][..., 0].abs().max())
    d_u = float((out['uniform grid'] - out['homogeneous'])[..., 0].abs()
                .max()) / scale
    print(f'uniform 8 x 8 x 128 grid against homogeneous sigma_t '
          f'{st["sigma_t"]}, 2^24 samples, gate: max cell difference '
          f'{d_u:.3e} of max (bound 1e-3)')
    if not d_u <= 1e-3:
        fail('media: a uniform grid differs from the homogeneous medium')
    half = scenes.medium_grid(half=True)
    ratios = {}
    for use, spp in ((True, MEDIA_LANES), (False, MEDIA_WF_SAMPLES)):
        ratios[use] = scenes.echo_attenuation(
            profile(None, spp, time_sampling='gate', use_kernel=use),
            profile(half, spp, time_sampling='gate', use_kernel=use))
    want_h = scenes.two_leg_transmittance(s0, rx0, half)
    print(f'half-space grid: K1 {ratios[True]:.4f} at 2^24, the wavefront '
          f'{ratios[False]:.4f} at 2^20, closed form {want_h:.4f}')
    if abs(ratios[True] / ratios[False] - 1) > MEDIA_ANCHOR:
        fail('media: the half-space grid differs between K1 and the '
             'wavefront')
    # vacuum twice at each anchor's size and once beside the half-space
    # grid; the medium in the other five calls
    path_launches = media_launches()
    if path_launches != 5 or rk.receive_megakernel.by_config['flagship'] \
            != 3 or rk.receive_megakernel.launches != 8:
        fail(f'media: the main path launched K1 '
             f'{rk.receive_megakernel.by_config} in 8 receive() calls')

    # ---- 3. each kind against the plain version ----
    errs, philox_stats, plain_ms = [], {}, {}
    sf, rxf = bt.flagship_scene(ground=False)
    se, rxe = bt.stratified_medium_scene()
    for kind, med in kinds.items():
        for coh in (False, True):
            what = f'{kind} {"coherent" if coh else "flagship"}'
            # the point target lies about z = 0: media it crosses
            sf.medium = scenes.seeded_medium(kind)
            params, prim, txp, mkw = tables(sf, rxf)
            kw = dict(adc=rxf.adc, max_depth=MEDIA_DEPTH,
                      time_sampling='gate', rx_kind='wigner',
                      doppler=coh, coherent=coh, **mkw)
            u = torch.rand((rk.n_draws(MEDIA_DEPTH), MEDIA_PARITY_LANES),
                           generator=gen, device=dev)
            acc, n_ev = rk.receive_megakernel(
                params, prim, txp, n_lanes=MEDIA_PARITY_LANES, uniforms=u,
                **kw)
            amp = torch.zeros((rxf.adc.n_time, 1), dtype=torch.float64,
                              device=dev)
            ref, n_ref = rk.receive_megakernel_ref(
                params, prim, txp, u, amp_out=amp if coh else None, **kw)
            slack = rk.phase_slack(sf.band, rxf.adc)
            errs.append(compare_coherent(
                torch, acc, n_ev, ref, n_ref, amp, slack,
                f'media {what}, point target, injected 2^14 lanes',
                depth=MEDIA_DEPTH) if coh else compare(
                acc, n_ev, ref, n_ref, f'media {what}, point target, '
                'injected 2^14 lanes'))
            # Philox at 2^24 on the example's scene: the flagship
            # instantiation in the example's fixed sampling (its stage
            # counts bound the timed runs below), the coherent one gated
            se.medium = med
            params, prim, txp, mkw = tables(se, rxe)
            kw = dict(adc=rxe.adc, max_depth=MEDIA_DEPTH,
                      time_sampling='gate' if coh else 'fixed',
                      rx_kind='omni', doppler=coh, coherent=coh, **mkw)
            lane = torch.empty(MEDIA_LANES, device=dev) if coh else None
            lane_ref = torch.empty(MEDIA_LANES, device=dev) if coh else None
            acc, n_ev = rk.receive_megakernel(
                params, prim, txp, n_lanes=MEDIA_LANES, seed=SEED,
                lane_out=lane, **kw)
            ref, n_ref, amp, stats, ms = _plain_philox(
                torch, rk, params, prim, txp, kw, MEDIA_LANES, MEDIA_DEPTH,
                dev, lane_ref=lane_ref)
            plain_ms[what] = ms
            if not coh:
                philox_stats[kind] = stats
            errs.append(compare_coherent(
                torch, acc, n_ev, ref, n_ref, amp,
                rk.phase_slack(se.band, rxe.adc), f'media {what}, example, '
                'philox 2^24 lanes', lane, lane_ref, depth=MEDIA_DEPTH)
                if coh else compare(acc, n_ev, ref, n_ref,
                                    f'media {what}, example, philox 2^24 '
                                    'lanes'))

    # one receive_cpi through a medium: config 5 with the homogeneous
    # medium, the launch against the plain version pulse by pulse
    md = scenes.MICRO_DOPPLER
    s5, _ = bt.micro_doppler_scene()
    s5.medium = kinds['homogeneous']
    reset()
    cube, n5 = bt.receive_cpi(s5, n_pulses=md['n_pulses'], prf=md['prf'],
                              seed=md['seed'], spp=md['spp'],
                              max_depth=md['max_depth'],
                              time_sampling='gate', device=dev)
    cpi_launches = rk.receive_megakernel_cpi.by_config['coherent_media']
    if cpi_launches != 1 or rk.receive_megakernel.launches:
        fail(f'media: receive_cpi launched '
             f'{rk.receive_megakernel_cpi.by_config}, receive '
             f'{rk.receive_megakernel.launches}')
    spec = scenes.micro_doppler_spectrum(cube, n5).double().cpu().numpy()
    comb = scenes.micro_doppler_comb_bins()
    if sorted(np.argsort(spec)[::-1][:len(comb)].tolist()) != comb:
        fail('media: config 5 through a medium left its comb')
    packed, rx5, _ = rk.pack_cpi(s5, md['n_pulses'], md['prf'])
    p_t = torch.tensor(packed.params, device=dev)
    p_t[:, 0] = rk.seed_slot(md['seed'])
    pr_t = torch.tensor(packed.prim, device=dev)
    tx_t = torch.tensor(packed.txp, device=dev)
    kw5 = dict(adc=rx5.adc, max_depth=md['max_depth'], time_sampling='gate',
               rx_kind='wigner', doppler=True, coherent=True,
               medium=packed.medium)
    acc5, ev5 = rk.receive_megakernel_cpi(p_t, pr_t, tx_t, n_lanes=md['spp'],
                                          seed=md['seed'], **kw5)
    worst5 = 0.0
    for p in range(md['n_pulses']):
        u = rk.philox_uniforms(md['seed'], rk.n_draws(md['max_depth']),
                               md['spp'], device=dev)
        amp = torch.zeros((rx5.adc.n_time, 1), dtype=torch.float64,
                          device=dev)
        ref, n_ref = rk.receive_megakernel_ref(p_t[p], pr_t[p], tx_t[p], u,
                                               amp_out=amp, **kw5)
        c = compare_coherent(torch, acc5[p], ev5[p], ref, n_ref, amp,
                             rk.phase_slack(s5.band, rx5.adc),
                             f'media config 5 pulse {p}', depth=1,
                             quiet=True)
        worst5 = max(worst5, c['worst'])
    print(f'parity media config 5 (homogeneous) receive_cpi: 64 pulses x '
          f'2^13 lanes in one launch, worst cell at {worst5:.3f} of its '
          f'bound; the comb on its bins')

    # ---- times at 2^24 samples, depth 2, on the example's scene: the
    #      five media in turn, then again in reverse order (each medium's
    #      calls from both passes), so that none is timed only first ----
    rows = {}
    runs = (('vacuum', None), ('layered K=4', kinds['layered']),
            ('layered K=32', scenes.stratified_layers(32)),
            ('homogeneous', kinds['homogeneous']),
            ('grid 8x8x128', kinds['grid']))
    base = philox_stats['layered']
    calls = {name: ([], []) for name, _ in runs}
    prepared = {}
    for name, med in runs:
        s, rx = bt.stratified_medium_scene(med)
        sd = s.compile(device=dev)
        params, prim, txp, mkw = tables(s, rx, sd)
        prepared[name] = (s, sd, rx, params, prim, txp, mkw)
        bt.receive(s, sd, rx, spp=MEDIA_LANES, max_depth=MEDIA_DEPTH, seed=1,
                   device=dev)
    for order in (runs, runs[::-1]):
        for name, _ in order:
            s, sd, rx, params, prim, txp, mkw = prepared[name]
            calls[name][0].extend(cuda_ms(lambda i: bt.receive(
                s, sd, rx, spp=MEDIA_LANES, max_depth=MEDIA_DEPTH,
                seed=2 + i, device=dev), 5)[0])
            kw = dict(adc=rx.adc, max_depth=MEDIA_DEPTH,
                      time_sampling='fixed', rx_kind='omni', **mkw)
            calls[name][1].extend(cuda_ms(lambda i: rk.receive_megakernel(
                params, prim, txp, n_lanes=MEDIA_LANES, seed=SEED, **kw),
                6)[0][1:])
    for name, med in runs:
        _, _, rx, params, prim, txp, mkw = prepared[name]
        call_ms, k_ms = calls[name]
        med_kind = None if med is None else {
            mt.HOMOGENEOUS: 'homogeneous', mt.LAYERED: 'layered',
            mt.GRID: 'grid'}[med.kind]
        ops = lane_ops(base, 2, 'ray_omni') + (
            0 if med is None
            else media_ops(base, med_kind, getattr(med, 'n_layers', 0)))
        n_bytes = 4 * (params.numel() + prim.numel() + txp.numel()
                       + rx.adc.n_time) + 8 + (
            0 if mkw['grid'] is None else 4 * mkw['grid'].numel())
        b = bound(ops, n_bytes, f'stratified {name} 2^24 lanes')
        k_med = statistics.median(k_ms)
        r_med = statistics.median(call_ms)
        rows[name] = dict(receive_ms=r_med, kernel_ms=k_med,
                          samples_per_s=MEDIA_LANES / (r_med * 1e-3),
                          bound_share=b['bound_ms'] / k_med,
                          grid_bytes=0 if mkw['grid'] is None
                          else 4 * mkw['grid'].numel(), **b)
        print(f'stratified {name}: receive() 2^24 samples depth 2, fixed: '
              f'median {r_med:.3f} ms ({MEDIA_LANES / (r_med * 1e-3):.4e} '
              f'samples/s); kernel {k_med:.3f} ms (both passes '
              f'{[round(x, 3) for x in k_ms]}), '
              f'{b["bound_ms"] / k_med:.1%} of its FP32 bound; grid '
              f'{rows[name]["grid_bytes"]} B {tag}')
    print('media stage lanes: ' + json.dumps(base))
    print(f'media phase wall {time.perf_counter() - t_phase:.1f} s {tag}')
    lay = rows['layered K=4']
    return [{
        'name': 'receive_megakernel', 'configuration': 'media',
        'route': 'cuda',
        'source': 'beifong_tpu_torch/csrc/receive_megakernel.cu',
        'replaces': 'beifong_tpu/integrators/pallas_receive.py:2983',
        'tpu_function': '_make_kernel (pallas_receive.py:106), absorbing '
        '/ layered / grid_meta', 'row': 'K1 media',
        'main_path': 'receive(stratified_medium_scene(med)), vacuum and '
        'K = 4 at 2^14 and 2^24 samples, homogeneous and a uniform grid at '
        '2^24, the half-space grid at 2^24, depth 2',
        'launches': path_launches,
        'max_abs_err': max(c['err'] for c in errs),
        'parity': max(c['rel'] for c in errs), 'ms': lay['kernel_ms'],
        'plain_ms': plain_ms['layered flagship'],
        'receive_ms': lay['receive_ms'], 'bound_ms': lay['bound_ms'],
        'bound_by': lay['bound_by'], 'library_ms': None,
        'anchors': {str(k): v for k, v in anchors.items()},
        'closed_form': want, 'uniform_grid_rel': d_u,
        'half_grid_k1': ratios[True], 'half_grid_wavefront': ratios[False],
        'cpi_worst': worst5, 'times': rows}]


PHASED_LANES = 1 << 24          # receive() and the kernel alone
PHASED_PARITY_LANES = 1 << 16   # injected uniforms
PHASED_DEPTH = 2
PHASED_WF_SAMPLES = 1 << 20     # K1 against the wavefront
PHASED_WF_BOUND = (0.2, 5.0)    # their window energies' ratio (the JAX
#                                 package's test_pallas_receive.py:1208)
PHASED_WF_SEEDS = 16            # coherent: seeds averaged on each route


def _range_profile(torch, bt, a, n, rx, coherent):
    """The range profile of a receive() grid: power, or |I + jQ|^2."""
    p = bt.develop_signal(a, n, rx.adc)[:, 0]
    p = (p[:, 0] ** 2 + p[:, 1] ** 2) if coherent else p[:, 0]
    return p.double().cpu().numpy()


def _bin_energy(p, centre, half=2):
    import numpy as np
    lo = max(int(centre) - half, 0)
    return float(np.abs(p[lo:int(centre) + half + 1]).sum())


def indexed_ops(stats: dict, n_rect: int) -> float:
    """lane_ops with the endpoint kernels' footprint index: its look-up a
    cross-WDF and the per-pair test on the pairs it visits, in place of
    the test on every pair."""
    return lane_ops(stats, n_rect) + FP32_OPS['pair_tests'] * (
        stats['pair_visits'] - stats['pair_tests']) \
        + FP32_OPS['pair_index'] * stats['pair_sums']


def phased(torch, bt, rk, dev, tag, build_log: str = '',
           cubin: str = '') -> list:
    """K1's endpoint twins on the endpoint scenes at full width (8-element
    phased arrays, four transmitters of three kinds): parity on injected
    uniforms and on Philox, receive() at 2^24 samples with the anchors of
    the JAX package's kernel tests, the kernel alone, K1 against the
    wavefront.  Each scene must run the analytic endpoint kernels
    (receive_endpoint_kernel, receive_endpoint_coherent_kernel: the launch
    record), whose registers, shared memory, spills, geometry and SASS mix
    it prints, with both FP32 bounds (every pair tested, and the
    footprint index's look-up and visited pairs) and the issue-slot
    bound."""
    import numpy as np
    from beifong_tpu_torch import scenes
    P = scenes.PHASED
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    st = scenes.steer_toward(P['tx'], scenes.phased_tx_target())
    cases = (('phased_tx', lambda sg=1.0: scenes.phased_tx_scene(sg * st),
              False),
             ('phased_rx',
              lambda sg=1.0: scenes.phased_rx_scene(sg * P['rx_az']), False),
             ('four_tx', lambda sg=1.0: scenes.four_tx_scene(), False),
             ('phased_tx coherent',
              lambda sg=1.0: scenes.phased_tx_scene(sg * st), True))

    def reset():
        rk.receive_megakernel.launches = 0
        rk.receive_megakernel.by_config = dict.fromkeys(rk.CONFIGS, 0)

    def tables(s, rx):
        sd = s.compile(device=dev)
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                            rx.id))
        t = [torch.tensor(a, device=dev) for a in (p.params, p.prim, p.txp,
                                                   p.php, p.rxph)]
        rx_kind = rk.rx_kind_of(rx)
        return sd, t, rx_kind, tuple(int(k) for k in p.txp[:, 27])

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for name, make, coh in cases:
        s, rx = make()
        sd, (params, prim, txp, php, rxph), rx_kind, kinds = tables(s, rx)
        params[0] = rk.seed_slot(SEED)
        n_tx = len(kinds)
        cfg_name = 'coherent_ep' if coh else 'flagship_ep'
        kw = dict(adc=rx.adc, max_depth=PHASED_DEPTH, time_sampling='gate',
                  rx_kind=rx_kind, doppler=coh, coherent=coh, php=php,
                  rxph=rxph if rx_kind == 'phased' else None)
        slack = rk.phase_slack(s.band, rx.adc)

        # ---- 3. parity on injected uniforms ----
        n_l = PHASED_PARITY_LANES
        u = torch.rand((rk.n_draws(PHASED_DEPTH, n_tx), n_l), generator=gen,
                       device=dev)
        lane = torch.empty(n_l, device=dev) if coh else None
        lane_ref = torch.empty(n_l, device=dev) if coh else None
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=dev)
        acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_l,
                                          uniforms=u, lane_out=lane, **kw)
        ref, n_ref = rk.receive_megakernel_ref(
            params, prim, txp, u, lane_out=lane_ref,
            amp_out=amp if coh else None, **kw)
        what = f'{name} ({cfg_name}, {n_tx} transmitter'
        what += 's' if n_tx > 1 else ''
        what += f', kinds {kinds}, rx {rx_kind})'
        errs = [compare_coherent(torch, acc, n_ev, ref, n_ref, amp, slack,
                                 f'{what} injected 2^16 lanes', lane,
                                 lane_ref, depth=PHASED_DEPTH) if coh
                else compare(acc, n_ev, ref, n_ref,
                             f'{what} injected 2^16 lanes')]

        # ---- 4. the main path: receive() at 2^24, its anchors ----
        sds = {}

        def call(sg, seed, spp=PHASED_LANES, **k):
            if sg not in sds:
                sds[sg] = make(sg)
                sds[sg] = sds[sg] + (sds[sg][0].compile(device=dev),)
            s_, rx_, sd_ = sds[sg]
            return bt.receive(s_, sd_, rx_, spp=spp, max_depth=PHASED_DEPTH,
                              seed=seed, time_sampling='gate', coherent=coh,
                              device=dev, **k)
        reset()
        with _Wavefront(bt) as wfc:
            a, n = call(1.0, 1)
            prof = _range_profile(torch, bt, a, n, rx, coh)
            times = cuda_ms(lambda i: call(1.0, 2 + i), 5)[0]
            prof_off = None
            if name in ('phased_tx', 'phased_rx'):
                a2, n2 = call(-1.0, 1)
                prof_off = _range_profile(torch, bt, a2, n2, rx, coh)
        n_calls = 6 + (prof_off is not None)
        launches = rk.receive_megakernel.by_config[cfg_name]
        if launches != n_calls or rk.receive_megakernel.launches != n_calls \
                or wfc.calls:
            fail(f'phased {name}: {n_calls} receive() calls launched '
                 f'{rk.receive_megakernel.by_config}, the wavefront '
                 f'{wfc.calls} times')
        if tuple(a.shape) != (rx.adc.n_time, 1, (2 if coh else 1) + 2) \
                or not np.isfinite(prof).all():
            fail(f'phased {name}: grid {tuple(a.shape)} not finite / wrong '
                 'shape')
        pk = int(np.abs(prof).argmax())
        anchor = {}
        if name.startswith('phased_tx'):
            want = scenes.round_trip_bin(s, rx, scenes.phased_tx_target())
            anchor = dict(peak=pk, round_trip=want)
            ok = abs(pk - want) <= 2
            if prof_off is not None:
                lo, hi = max(pk - 3, 0), pk + 4
                on = float(np.abs(prof[lo:hi]).sum())
                off = float(np.abs(prof_off[lo:hi]).sum())
                anchor['off_over_on'] = off / on
                ok = ok and off < 0.5 * on
        elif name == 'phased_rx':
            tgts = scenes.phased_rx_targets()
            want = [scenes.round_trip_bin(s, rx, t) for t in tgts]
            pk_off = int(np.abs(prof_off).argmax())
            r_on = _bin_energy(prof, round(want[1]) + 1) \
                / _bin_energy(prof, pk)
            r_off = _bin_energy(prof_off, round(want[0]) + 1) \
                / _bin_energy(prof_off, pk_off)
            anchor = dict(peaks=[pk, pk_off], round_trips=want,
                          other_over_steered=[r_on, r_off])
            ok = (abs(pk - want[0]) <= 2 and abs(pk_off - want[1]) <= 2
                  and r_on < 0.5 and r_off < 0.5)
        else:
            want = [scenes.round_trip_bin(s, rx, (0.0, -4.0, 0.0), t)
                    for t in s.transmitters]
            pks = []
            for w in want:
                lo = int(round(w)) - 2
                pks.append(lo + int(np.abs(prof[lo:lo + 5]).argmax()))
            anchor = dict(peaks=pks, round_trips=want)
            ok = all(abs(p_ - w) <= 2 and _bin_energy(prof, p_)
                     > 0.05 * float(np.abs(prof).max())
                     for p_, w in zip(pks, want))
        print(f'receive() {name} 2^24 samples depth 2, gate: anchors '
              f'{json.dumps(anchor)} {tag}')
        if not ok:
            fail(f'phased {name}: anchors missed')
        recv_ms = statistics.median(times)

        # ---- the kernel alone and the plain version on Philox ----
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
            params, prim, txp, n_lanes=PHASED_LANES, seed=SEED, **kw), 6)
        k_med = statistics.median(k_ms[1:])
        lane = torch.empty(PARITY_PHILOX_LANES, device=dev) if coh else None
        lane_ref = torch.empty(PARITY_PHILOX_LANES, device=dev) \
            if coh else None
        acc1, n1 = rk.receive_megakernel(params, prim, txp,
                                         n_lanes=PARITY_PHILOX_LANES,
                                         seed=SEED,
                                         lane_out=lane, **kw)
        lib = rk.LIBRARY.get()
        ran = rk.launched_endpoint_kernel(coh)
        want_k = 'receive_endpoint_' + ('coherent_' if coh else '') + 'kernel'
        geo = rk.launch_geometry(
            rx.adc.n_time, PHASED_LANES, int(prim.shape[0]),
            int(params.shape[0]), doppler=coh, coherent=coh, ep=True,
            n_tx=n_tx, n_pairs=(int(php.shape[1]) - 2) // 6,
            n_rx_pairs=(int(rxph.shape[1]) - 2) // 6
            if rx_kind == 'phased' else 0)
        print(f'{name}: rk_last_kernel {lib.rk_last_kernel():#x}, '
              f'{want_k} {lib.rk_endpoint_kernel(int(coh)):#x}; geometry '
              f'{geo[0]} blocks ({geo[0] / sms:.2f} an SM) x {geo[1]} '
              f'threads, {geo[2]} B of dynamic shared memory {tag}')
        if not ran:
            fail(f'phased {name}: the launch did not run {want_k}')
        ref, n_ref, amp, stats, plain_ms = _plain_philox(
            torch, rk, params, prim, txp, kw, PARITY_PHILOX_LANES,
            PHASED_DEPTH, dev, lane_ref=lane_ref)
        what_p = f'{name} philox 2^{PARITY_PHILOX_LANES.bit_length() - 1} ' \
            'lanes'
        errs.append(compare_coherent(
            torch, acc1, n1, ref, n_ref, amp, slack, what_p, lane, lane_ref,
            depth=PHASED_DEPTH) if coh else compare(
            acc1, n1, ref, n_ref, what_p))
        # the bound's stage counts, for the kernel's 2^24 lanes
        stats = scaled_stats(stats, PHASED_LANES // PARITY_PHILOX_LANES)

        # ---- K1 against the wavefront: the power profile of one seed;
        #      the coherent |I + jQ|^2 averaged over PHASED_WF_SEEDS seeds
        #      (the plate spans many wavelengths, so one seed's coherent
        #      echo is a speckle draw: its window energy varies ~10x
        #      between seeds on the CPU) ----
        prof_k = None
        n_seeds = PHASED_WF_SEEDS if coh else 1
        for use in (True, False):
            p_u = 0.0
            t_wf = 0.0
            for seed in range(3, 3 + n_seeds):
                ms, (a_u, n_u) = wall_ms(lambda: call(
                    1.0, seed, spp=PHASED_WF_SAMPLES, use_kernel=use,
                    lanes_per_pass=KW_LANES_PER_PASS))
                t_wf += ms
                p_u = p_u + _range_profile(torch, bt, a_u, n_u, rx,
                                           coh) / n_seeds
            print(f'receive() {name} use_kernel={use}: {t_wf:.1f} ms for '
                  f'{n_seeds} x 2^{PHASED_WF_SAMPLES.bit_length() - 1} '
                  f'samples, peak bin {int(np.abs(p_u).argmax())} {tag}')
            if use:
                prof_k = p_u
        pk_k, pk_w = int(np.abs(prof_k).argmax()), int(np.abs(p_u).argmax())
        ratio = _bin_energy(prof_k, pk_w, 3) / max(_bin_energy(p_u, pk_w, 3), 1e-300)
        print(f'K1 against the wavefront, {name} at {n_seeds} x '
              f'2^{PHASED_WF_SAMPLES.bit_length() - 1} samples: peak bins '
              f'{pk_k} / {pk_w}, window energy ratio {ratio:.3f} (bound '
              f'{PHASED_WF_BOUND})')
        if abs(pk_k - pk_w) > 2 or not (PHASED_WF_BOUND[0] < ratio
                                         < PHASED_WF_BOUND[1]):
            fail(f'phased {name}: K1 and the wavefront disagree')
        pair_share = (stats['pair_tests'] * FP32_OPS['pair_tests']
                      + stats['pair_terms'] * FP32_OPS['pair_terms']) \
            / lane_ops(stats, int((prim[:, 0] == 0).sum()))
        n_rect = int((prim[:, 0] == 0).sum())
        print(f'receive_megakernel ({cfg_name}) {name} 2^24 lanes depth 2: '
              f'median {k_med:.3f} ms ({PHASED_LANES / (k_med * 1e-3):.4e} '
              f'samples/s) {[round(x, 3) for x in k_ms[1:]]}; receive() '
              f'{recv_ms:.3f} ms; plain version {plain_ms:.1f} ms; pair sums '
              f'{pair_share:.1%} of the lanes\' FP32 operations; {n_rect} '
              f'rectangles {tag}')
        print(f'{name} stage lanes: ' + json.dumps(stats))
        entry = _kernel_entry(
            torch, rk, cfg_name, f'{name} 2^24 lanes',
            f'receive({name}_scene()), 2^24 samples, depth 2, gate'
            + (', coherent' if coh else ''), launches, errs, k_med,
            plain_ms, recv_ms, stats,
            [params, prim, txp, php] + ([rxph] if rx_kind == 'phased'
                                         else []),
            rx.adc.n_time, 2 if coh else 1,
            dict(row='K1 endpoints', scene=name, anchors=anchor,
                 k1_wavefront_ratio=ratio, pair_share=pair_share))
        n_bytes = 4 * (sum(t.numel() for t in [params, prim, txp, php]
                           + ([rxph] if rx_kind == 'phased' else []))
                       + rx.adc.n_time * (2 if coh else 1)) + 8
        b_ix = bound(indexed_ops(stats, n_rect), n_bytes,
                     f'{name} with the footprint index')
        lanes = stats['lanes']
        entry.update(bound_indexed_ms=b_ix['bound_ms'],
                     pair_tests_per_lane=stats['pair_tests'] / lanes,
                     pair_visits_per_lane=stats['pair_visits'] / lanes,
                     pair_terms_per_lane=stats['pair_terms'] / lanes,
                     kernel=want_k)
        config = 'ep_' + name.replace(' coherent', '_coh')
        mix = kernel_mix(dev, tag, build_log, cubin, config, geo, sms) \
            if cubin else {}
        entry.update({k: mix[k] for k in ('issue_slot_bound_ms',
                                          'thread_instructions_a_lane',
                                          'bound_instructions_a_lane')
                      if k in mix})
        issue = (f'; of the issue-slot bound '
                 f'({mix["issue_slot_bound_ms"]:.4f} ms) '
                 f'{mix["issue_slot_bound_ms"] / k_med:.1%}') if mix else ''
        print(f'share of the FP32 bound {name}: '
              f'{entry["bound_ms"] / k_med:.1%}; of the indexed bound '
              f'({b_ix["bound_ms"]:.4f} ms) {b_ix["bound_ms"] / k_med:.1%}'
              f'{issue}; pair tests a lane '
              f'{entry["pair_tests_per_lane"]:.3f}, visited '
              f'{entry["pair_visits_per_lane"]:.3f}, inside '
              f'{entry["pair_terms_per_lane"]:.3f} {tag}')
        out.append(entry)
    rule_parity(torch, rk, dev, tag, 'endpoint')
    print(f'phased phase wall {time.perf_counter() - t_phase:.1f} s {tag}')
    return out


RULE_PARITY_LANES = 1 << 16   # injected uniforms
RULE_PHILOX_LANES = 1 << 20   # the Philox stream


def rule_parity(torch, rk, dev, tag, which: str) -> None:
    """The receive rules in the analytic endpoint and lobe kernels (their
    C10 scenes): `which` 'endpoint' holds receive_endpoint_coherent_kernel
    on the analog phased receiver and on the phased transmitter under a
    mixer with an LO (`scenes.mixer_receiver`: a beat drawn a lane), 'lobe'
    receive_lobe_kernel on the rough plastic plate under that mixer, in
    power and I / Q; each on injected uniforms and the Philox stream,
    lane by lane against the plain version (I / Q with the phase slack),
    and the launch record; 'endpoint' also the phased transmitter with its
    target a GGX rough conductor closing at 5 m/s (C10's moving GGX
    path)."""
    from beifong_tpu_torch import scenes
    P = scenes.PHASED
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    st = scenes.steer_toward(P['tx'], scenes.phased_tx_target())
    if which == 'endpoint':
        cases = (('phased_rx I / Q', lambda: scenes.phased_rx_scene(
            P['rx_az']), True, 2),
                 ('phased_tx mixer I / Q', lambda: scenes.mixer_receiver(
                     *scenes.phased_tx_scene(st)), True, 2),
                 ('phased_tx moving GGX I / Q', lambda: scenes.phased_tx_scene(
                     st, moving_ggx=True), True, 2))
    else:
        cases = tuple((f'rough plastic mixer {"I / Q" if coh else "power"}',
                       lambda: scenes.mixer_receiver(
                           *scenes.plastic_scene('rough_plastic')), coh, 2)
                      for coh in (False, True))
    for what, make, coh, depth in cases:
        s, rx = make()
        p = rk.pack_scene(s.compile(device=dev), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
        params, prim, txp = (torch.tensor(a, device=dev)
                             for a in (p.params, p.prim, p.txp))
        params[0] = rk.seed_slot(SEED)
        rx_kind = rk.rx_kind_of(rx)
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind=rx_kind, doppler=True, coherent=coh,
                  receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror))
        if which == 'endpoint':
            kw.update(php=torch.tensor(p.php, device=dev),
                      rxph=torch.tensor(p.rxph, device=dev)
                      if rx_kind == 'phased' else None)
        else:
            kw['lobes'] = p.lobes
        nd = rk.n_draws(depth, int(txp.shape[0]),
                        **rk.lobe_draws(kw.get('lobes') or 0))
        for mode, n_l in (('injected', RULE_PARITY_LANES),
                          ('philox', RULE_PHILOX_LANES)):
            u = torch.rand((nd, n_l), generator=gen, device=dev) \
                if mode == 'injected' else \
                rk.philox_uniforms(SEED, nd, n_l, device=dev)
            lane = torch.empty(n_l, device=dev)
            acc, n_ev = rk.receive_megakernel(
                params, prim, txp, n_lanes=n_l, lane_out=lane,
                **(dict(uniforms=u) if mode == 'injected'
                   else dict(seed=SEED)), **kw)
            ran = rk.launched_endpoint_kernel(coh) if which == 'endpoint' \
                else rk.launched_lobe_kernel(coh)
            if not ran:
                fail(f'{what}: the launch record does not show the '
                     f'{which} kernel')
            lane_ref = torch.empty(n_l, device=dev)
            amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                              device=dev)
            # a lobe pick or a cosine's sign within the plain version's tie
            # margin may go the other way under FMA contraction
            ill = torch.zeros(n_l, dtype=torch.bool, device=dev)
            ref, n_ref = rk.receive_megakernel_ref(
                params, prim, txp, u, lane_out=lane_ref, amp_out=amp,
                ill_out=ill, **kw)
            name = f'{what} ({which} kernel) {mode} 2^' \
                f'{n_l.bit_length() - 1} lanes'
            if coh:
                compare_coherent(torch, acc, n_ev, ref, n_ref, amp,
                                 rk.phase_slack(s.band, rx.adc), name, lane,
                                 lane_ref, depth=depth, ill=ill)
            else:
                compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, depth,
                              name, ill=ill)
    print(f'receive rules in the {which} kernel: every case within its '
          f'gate {tag}')


LOBE_LANES = 1 << 24          # receive(), the kernel alone
LOBE_PARITY_LANES = 1 << 16   # injected uniforms
LOBE_WF_SAMPLES = 1 << 18     # K1 against the wavefront: samples a seed
LOBE_WF_SEEDS = 16            # seeds averaged on each route
LOBE_WF_BOUND = (0.2, 5.0)    # their window energies' ratio
LOBE_MASK_RATIO = (0.5, 0.3)  # e(0.4) / e(0.8): 0.5 +- 30%
LOBE_CPI_PULSES = 16
LOBE_CPI_SAMPLES = 1 << 20    # a pulse of the windowed corner's CPI
CORNER_FLOOR = 1e-4           # x the largest lane, the corner's chains
CORNER_FLOORS = (1e-6, 1e-5, 1e-4, 1e-3)


def _gate(acc, lane, ref, lane_ref, cell_slack, floor, ill=None):
    """(`compare_lanes`' verdict: passes?, the share of the lanes that
    took another path outside `ill`, the worst cell)."""
    b = lane_bound(acc, lane, ref, lane_ref, cell_slack, floor)
    out = b['flipped'] if ill is None else b['flipped'] & ~ill
    share = int(out.sum()) / lane.numel()
    return share <= EDGE_FLIPS and b['worst'] <= 1.0, share, b['worst']


def corner_readings(torch, acc, ref, amp, lane, lane_ref, ill, what,
                    controls=None) -> dict:
    """The corner's power bound read on both sides.  Three gates: the one
    held (lanes past TOL of themselves and CORNER_FLOOR of the largest
    lane took another path; each cell within TOL x max|acc|, those
    lanes' sums and TOL of its own |power| sum), the same with floor
    1e-3, and the unwidened one (floor 1e-6, no per-cell slack).  For
    each: does the kernel pass, its worst cell, and the least uniform
    scale error of its result (every lane and cell times 1 + delta, delta
    on a quarter-decade ladder from 1e-5) that the gate refuses.  Beside
    them the lanes each floor of CORNER_FLOORS counts, the worst cell
    against TOL x max|acc| alone, the largest share of its |power| sum
    that a cell moved; and `controls` {name: (acc, lane)}, the plain
    version on other inputs, against the held gate (the share of their
    lanes past its floor, its worst cell, and its worst cell without the
    sums of those lanes)."""
    slack = TOL * amp.float()
    diff = (acc - ref).abs()
    live = amp > 0
    scale = float(ref.abs().max())
    r = dict(
        flips={f'{f:g}': lane_bound(acc, lane, ref, lane_ref, 0.0,
                                    f)['n_flip'] for f in CORNER_FLOORS},
        worst_tol_max_only=float(diff.max()) / (TOL * scale),
        max_err_over_abs_power_sum=float((diff[live] / amp[live]).max()),
        abs_power_sum_over_peak_cell=float(amp.max()) / scale)
    for name, cs, floor in (('gate', slack, CORNER_FLOOR),
                            ('floor_1e-3', slack, 1e-3),
                            ('unwidened', 0.0, 1e-6)):
        ok, _, worst = _gate(acc, lane, ref, lane_ref, cs, floor, ill)
        r[name] = dict(kernel_passes=ok, worst_cell=worst,
                       scale_error_refused=next(
                           (d for d in (10.0 ** (-q / 4)
                                        for q in range(20, 3, -1))
                            if not _gate(acc * (1 + d), lane * (1 + d), ref,
                                         lane_ref, cs, floor, ill)[0]),
                           None))
    for name, (c_acc, c_lane) in (controls or {}).items():
        ok, share, worst = _gate(c_acc, c_lane, ref, lane_ref, slack,
                                 CORNER_FLOOR)
        r[f'control_{name}'] = dict(
            passes=ok, lanes_out=share, worst_cell=worst,
            worst_cell_without_lane_sums=float(
                ((c_acc - ref).abs() / (TOL * scale + slack)).max()))
    print(f'corner bound readings {what}: {json.dumps(r)}')
    return r


def lobes(torch, bt, rk, dev, tag, build_log: str, cubin: str) -> list:
    """K1's lobe twins (the analytic ones' receive_lobe_kernel<COH>, the
    mesh ones' LOB instantiations) on the JAX package's lobe kernel tests'
    scenes at full width: parity of each twin against its plain version on
    injected uniforms and on Philox (2^22, its stage counts scaled to the
    kernel's 2^24 lanes for the bound; the analytic twins' repeats
    bit-identical, their launch record the lobe kernel's, their registers,
    warps an SM and SASS mix), each through receive() at 2^24 samples
    with the anchors (the
    windowed corner on the bare corner's peak, the thin window's energy
    ratio beside its closed form, the plastics and GGX glass on their
    round-trip or one-way bins, a mask's echo in proportion to its
    opacity), the windowed corner's CPI in one launch, the kernel alone,
    and K1 against the wavefront on the windowed corner over 16 seeds."""
    import numpy as np
    from beifong_tpu_torch import scenes as S
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (twin, scene, the function that makes it, depth, coherent, a delta
    # chain)
    twins = (('doppler_lobes', 'window_corner_scene(thin)',
              lambda: S.window_corner_scene('thin'), 6, False, True),
             ('coherent_lobes', 'window_corner_scene(dielectric)',
              lambda: S.window_corner_scene('dielectric'), 6, True, True),
             ('doppler_mesh_lobes', 'mesh_scene(rough_plastic)',
              lambda: S.mesh_scene(material='rough_plastic'), 2, False,
              False),
             ('coherent_mesh_lobes', 'mesh_scene(rough_plastic)',
              lambda: S.mesh_scene(material='rough_plastic'), 2, True,
              False))

    def reset():
        for fn in (rk.receive_megakernel, rk.receive_megakernel_cpi):
            fn.launches = 0
            fn.by_config = dict.fromkeys(rk.CONFIGS, 0)

    def tables(s, rx, depth, coh):
        sd = s.compile(device=dev)
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                            rx.id))
        params = torch.tensor(p.params, device=dev)
        params[0] = rk.seed_slot(SEED)
        mesh = None if p.mesh is None else p.mesh.to(dev)
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind=rk.rx_kind_of(rx), mesh=mesh, doppler=True,
                  msh=None if mesh is None else torch.tensor(p.msh,
                                                             device=dev),
                  coherent=coh, mirror=p.mirror, lobes=p.lobes)
        return sd, params, torch.tensor(p.prim, device=dev), \
            torch.tensor(p.txp, device=dev), kw

    def check(acc, n_ev, ref, n_ref, amp, lane, lane_ref, ill, kw, chain,
              s, rx, what):
        depth = kw['max_depth']
        if kw['coherent']:
            return compare_coherent(torch, acc, n_ev, ref, n_ref, amp,
                                    rk.phase_slack(s.band, rx.adc), what,
                                    lane, lane_ref, depth=depth, ill=ill)
        # a corner's power cells sum signed WDF contributions that cancel
        # to 1/8-1/80 of their magnitudes: each cell may also move by TOL
        # of its own sum of |power|, the share a contribution may, and a
        # lane past CORNER_FLOOR of the largest took another path
        # (corner_readings reads this bound on both sides)
        return compare_lanes(acc, n_ev, lane, ref, n_ref, lane_ref, depth,
                             what, floor=CORNER_FLOOR if chain else 1e-6,
                             ill=ill,
                             cell_slack=TOL * amp.float() if chain else 0.0)

    def injected(s, rx, params, prim, txp, kw, chain, what):
        """Parity on LOBE_PARITY_LANES injected uniforms, lane by lane;
        on a corner's power chains also its bound's readings, with the
        plain version on the draws rounded to float16 and bfloat16 as
        controls."""
        n_l = LOBE_PARITY_LANES
        nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
        u = torch.rand((nd, n_l), generator=gen, device=dev)
        lane = torch.empty(n_l, device=dev)
        lane_ref = torch.empty(n_l, device=dev)
        ill = torch.zeros(n_l, dtype=torch.bool, device=dev)
        amp = torch.zeros((rx.adc.n_time, 1), dtype=torch.float64,
                          device=dev)
        acc, n_ev = rk.receive_megakernel(params, prim, txp, n_lanes=n_l,
                                          uniforms=u, lane_out=lane, **kw)
        ref, n_ref = rk.receive_megakernel_ref(
            params, prim, txp, u, lane_out=lane_ref, amp_out=amp,
            ill_out=ill, **kw)
        print(f'{what}: {int(ill.sum())} of {n_l} lanes at a lobe branch '
              f'tie (ill_out)')
        err = check(acc, n_ev, ref, n_ref, amp, lane, lane_ref, ill, kw,
                    chain, s, rx, f'{what} injected 2^16 lanes')
        if chain and not kw['coherent']:
            controls = {}
            for dt in (torch.float16, torch.bfloat16):
                c_lane = torch.empty(n_l, device=dev)
                c_acc, _ = rk.receive_megakernel_ref(
                    params, prim, txp,
                    u.to(dt).float().clamp(max=1.0 - 2.0 ** -24),
                    lane_out=c_lane, **kw)
                controls[f'plain_on_{str(dt)[6:]}_draws'] = (c_acc, c_lane)
            corner_readings(torch, acc, ref, amp, lane, lane_ref, ill,
                            f'{what} injected 2^16 lanes', controls)
        return err

    def profile(a, n, rx, coh):
        return _range_profile(torch, bt, a, n, rx, coh)

    out = []
    for cfg_name, scene, make, depth, coh, chain in twins:
        s, rx = make()
        sd, params, prim, txp, kw = tables(s, rx, depth, coh)
        what = f'{scene} ({cfg_name}, lobes {kw["lobes"]}, depth {depth})'

        # ---- 3. parity on injected uniforms, lane by lane ----
        errs = [injected(s, rx, params, prim, txp, kw, chain, what)]

        # ---- 4. the main path: receive() at 2^24, one warm-up, five
        #      timed calls ----
        def call(seed, spp=LOBE_LANES, **k):
            return bt.receive(s, sd, rx, spp=spp, max_depth=depth,
                              seed=seed, time_sampling='gate',
                              coherent=coh, device=dev, **k)
        reset()
        with _Wavefront(bt) as wfc:
            a, n = call(1)
            times = cuda_ms(lambda i: call(2 + i), 5)[0]
        launches = rk.receive_megakernel.by_config[cfg_name]
        if launches != 6 or rk.receive_megakernel.launches != 6 \
                or wfc.calls:
            fail(f'lobes {scene}: 6 receive() calls launched '
                 f'{rk.receive_megakernel.by_config}, the wavefront '
                 f'{wfc.calls} times')
        prof = profile(a, n, rx, coh)
        if tuple(a.shape) != (rx.adc.n_time, 1, (2 if coh else 1) + 2) \
                or not np.isfinite(prof).all():
            fail(f'lobes {scene}: grid {tuple(a.shape)} not finite / wrong '
                 'shape')
        recv_ms = statistics.median(times)

        # ---- the kernel alone, and the plain version on Philox ----
        k_kw = dict(kw)
        if kw['mesh'] is not None:
            k_kw['patch_p'] = rk.patch_p_for(LOBE_LANES)
        k_ms, _ = cuda_ms(lambda i: rk.receive_megakernel(
            params, prim, txp, n_lanes=LOBE_LANES, seed=SEED, **k_kw), 6)
        k_med = statistics.median(k_ms[1:])
        # the Philox parity at PARITY_PHILOX_LANES (the mesh twins' direction
        # strata are those of the parity call's own lanes)
        p_kw = dict(k_kw)
        if kw['mesh'] is not None:
            p_kw['patch_p'] = rk.patch_p_for(PARITY_PHILOX_LANES)
        lane = torch.empty(PARITY_PHILOX_LANES, device=dev)
        lane_ref = torch.empty(PARITY_PHILOX_LANES, device=dev)
        acc1, n1 = rk.receive_megakernel(params, prim, txp,
                                         n_lanes=PARITY_PHILOX_LANES,
                                         seed=SEED, lane_out=lane, **p_kw)
        analytic = kw['mesh'] is None
        record = rk.launched_lobe_kernel(coh)
        # the mesh lobe twins run the mesh Doppler kernel <coh, true>
        mdk = not analytic
        if rk.launched_mesh_doppler_kernel(True, coh) != mdk:
            fail(f'lobes {scene} ({cfg_name}): the launch record shows the '
                 f'mesh Doppler kernel <{str(coh).lower()}, true> {not mdk}')
        acc2, n2 = rk.receive_megakernel(params, prim, txp,
                                         n_lanes=PARITY_PHILOX_LANES,
                                         seed=SEED, **p_kw)
        ref, n_ref, amp, stats, plain_ms = _plain_philox(
            torch, rk, params, prim, txp, p_kw, PARITY_PHILOX_LANES, depth,
            dev, lane_ref=lane_ref, power_amp=chain)
        errs.append(check(acc1, n1, ref, n_ref, amp, lane, lane_ref, None,
                          p_kw, chain, s, rx, f'{scene} philox 2^'
                          f'{PARITY_PHILOX_LANES.bit_length() - 1} lanes'))
        # the bound's stage counts, for the kernel's 2^24 lanes
        stats = scaled_stats(stats, LOBE_LANES // PARITY_PHILOX_LANES)
        # the analytic twins run receive_lobe_kernel (the launch record)
        # and the mesh lobe twins the mesh Doppler kernel, whose warp rows
        # make Philox repeats bit-identical
        rows = (analytic or mdk) and rk.coherent_warp_rows(rx.adc, coh)
        rep = float((acc1 - acc2).abs().max())
        same = bool(torch.equal(acc1, acc2)) and int(n1) == int(n2)
        print(f'{scene} ({cfg_name}) philox repeat: lobe kernel launched '
              f'{record}, warp rows {rows}, bit-identical {same}, max '
              f'difference {rep:.3e} of {float(acc1.abs().max()):.3e}, '
              f'events {int(n1)} / {int(n2)}')
        if record != analytic:
            fail(f'lobes {scene}: receive_lobe_kernel launched {record}')
        if rows and not same:
            fail(f'lobes {scene}: two Philox-mode calls with one seed '
                 'differ')
        if chain and not coh:
            corner_readings(torch, acc1, ref, amp, lane, lane_ref, None,
                            f'{scene} philox 2^24 lanes')
        n_rect = int((prim[:, 0] == 0).sum())
        print(f'receive_megakernel ({cfg_name}) {scene} 2^24 lanes depth '
              f'{depth}: median {k_med:.3f} ms '
              f'({LOBE_LANES / (k_med * 1e-3):.4e} samples/s) '
              f'{[round(x, 3) for x in k_ms[1:]]}; receive() '
              f'{recv_ms:.3f} ms; plain version {plain_ms:.1f} ms; '
              f'{n_rect} rectangles {tag}')
        print(f'{scene} ({cfg_name}) stage lanes: ' + json.dumps(stats))
        mix = {}
        if analytic:
            mix = kernel_mix(
                dev, tag, build_log, cubin,
                'window_dielectric' if coh else 'window_thin',
                rk.launch_geometry(rx.adc.n_time, LOBE_LANES,
                                   int(prim.shape[0]),
                                   int(params.shape[-1]), doppler=True,
                                   coherent=coh, lobes=True),
                torch.cuda.get_device_properties(0).multi_processor_count)
            mix['kernel'] = f'receive_lobe_kernel<{str(coh).lower()}>'
        elif mdk and cubin:
            mix = kernel_mix(
                dev, tag, build_log, cubin,
                'mesh_lobes_iq' if coh else 'mesh_lobes_power',
                rk.launch_geometry(rx.adc.n_time, LOBE_LANES,
                                   int(prim.shape[0]),
                                   int(params.shape[-1]), mesh=True,
                                   n_msh=int(kw['msh'].shape[0]),
                                   doppler=True, coherent=coh, lobes=True),
                torch.cuda.get_device_properties(0).multi_processor_count)
            mix['kernel'] = (f'receive_mesh_doppler_kernel<'
                             f'{str(coh).lower()}, true>')
        entry = _kernel_entry(
            torch, rk, cfg_name, f'{scene} 2^24 lanes',
            f'receive({scene}), 2^24 samples, depth {depth}, gate'
            + (', coherent' if coh else ''), launches, errs, k_med,
            plain_ms, recv_ms, stats,
            [params, prim, txp] + ([] if kw['mesh'] is None else
                                   [kw['msh'], kw['mesh'].bbox,
                                    kw['mesh'].links, kw['mesh'].leaves]),
            rx.adc.n_time, 2 if coh else 1,
            dict(row='K1 lobes', scene=scene,
                 tpu_flags='diel/thin/plas/rplas/rdiel/has_blend/has_mask '
                 '(pallas_receive.py:188-224)', repeat_bit_identical=same,
                 **mix))
        print(f'share of the FP32 bound {scene} ({cfg_name}): '
              f'{entry["bound_ms"] / k_med:.1%} {tag}')
        out.append(entry)

    # ---- 3. the analytic twins' other lobes (the smooth dielectric
    #      window in power, plastic, GGX glass, blend, mask) against the
    #      plain version on injected uniforms ----
    for scene, make, chain in (
            ('window_corner_scene(dielectric)',
             lambda: S.window_corner_scene('dielectric'), True),
            ('plastic_scene(plastic)', lambda: S.plastic_scene('plastic'),
             False),
            ('rough_dielectric_scene(through)',
             lambda: S.rough_dielectric_scene('through'), False),
            ('composite_scene(blend)', lambda: S.composite_scene('blend'),
             False),
            ('composite_scene(mask, 0.4)',
             lambda: S.composite_scene('mask', 0.4), False)):
        s, rx = make()
        depth = 6 if chain else 2
        _, params, prim, txp, kw = tables(s, rx, depth, False)
        injected(s, rx, params, prim, txp, kw, chain,
                 f'{scene} (doppler_lobes, lobes {kw["lobes"]}, depth '
                 f'{depth})')

    # ---- 4. the other lobe scenes through receive() at 2^24: anchors;
    #      each launches the power lobe twin once, no wavefront pass ----
    anchors = {}
    reset()
    with _Wavefront(bt) as wfc:
        def run(s, rx, depth=2, seed=1, coh=False, spp=LOBE_LANES):
            a, n = bt.receive(s, s.compile(device=dev), rx, spp=spp,
                              max_depth=depth, seed=seed,
                              time_sampling='gate', coherent=coh,
                              device=dev)
            return profile(a, n, rx, coh)
        for name, make, case in (
                ('plastic', lambda: S.plastic_scene('plastic'), 'target'),
                ('rough_plastic', lambda: S.plastic_scene('rough_plastic'),
                 'target'),
                ('rough_dielectric target',
                 lambda: S.rough_dielectric_scene('target'), 'target'),
                ('rough_dielectric through',
                 lambda: S.rough_dielectric_scene('through'), 'through'),
                ('blend', lambda: S.composite_scene('blend'), 'target')):
            s, rx = make()
            p = run(s, rx)
            want = S.lobe_bin(s, rx, case)
            pk = int(np.abs(p).argmax())
            anchors[name] = dict(peak=pk, bin=round(want, 2))
            if not round(want) - 1 <= pk <= round(want) + 3:
                fail(f'lobes {name}: peak bin {pk}, its echo at {want:.2f}')
        e = {}
        for op in (0.8, 0.4):
            s, rx = S.composite_scene('mask', op)
            p = run(s, rx)
            e[op] = _bin_energy(p, int(p.argmax()), 3)
        mask_ratio = e[0.4] / e[0.8]
        anchors['mask'] = dict(e_04_over_08=mask_ratio)
        win = {}
        for w in ('thin', 'dielectric'):
            s, rx = S.window_corner_scene(w)
            win[w] = run(s, rx, depth=6)
        n_k1 = rk.receive_megakernel.by_config['doppler_lobes']
        k1_ok = n_k1 == 9 and not wfc.calls
    # the bare corner (the mirror chains, no lobe) for the window anchors
    s0, rx0 = S.window_corner_scene()
    bare = run(s0, rx0, depth=6)
    pk0 = int(np.abs(bare).argmax())
    ratio_thin = _bin_energy(win['thin'], pk0, 3) / _bin_energy(bare, pk0, 3)
    t_thin = S.thin_window_transmittance()
    anchors['window'] = dict(bare_peak=pk0, thin_peak=int(np.abs(
        win['thin']).argmax()), dielectric_peak=int(np.abs(
            win['dielectric']).argmax()), thin_energy_ratio=ratio_thin,
        closed_form_T2=t_thin)
    print(f'receive() lobe anchors at 2^24 samples: {json.dumps(anchors)}; '
          f'the thin window keeps {ratio_thin:.3f} of the bare corner\'s '
          f'window energy (closed form T^2 = {t_thin:.3f}, normal '
          f'incidence) {tag}')
    if not k1_ok:
        fail(f'lobes: the anchor scenes launched {n_k1} power lobe twins '
             f'(want 9), the wavefront {wfc.calls} times')
    if abs(anchors['window']['thin_peak'] - pk0) > 1 \
            or abs(anchors['window']['dielectric_peak'] - pk0) > 1:
        fail(f'lobes: windowed corner peaks {anchors["window"]} off the '
             f'bare corner\'s {pk0}')
    if abs(mask_ratio - LOBE_MASK_RATIO[0]) \
            > LOBE_MASK_RATIO[1] * LOBE_MASK_RATIO[0]:
        fail(f'lobes: mask e(0.4) / e(0.8) = {mask_ratio:.3f}')

    # ---- the windowed corner's CPI: one launch of the coherent twin ----
    s, rx = S.window_corner_scene('thin')
    reset()
    with _Wavefront(bt) as wfc:
        cpi_ms, (cube, n) = wall_ms(lambda: bt.receive_cpi(
            s, n_pulses=LOBE_CPI_PULSES, prf=10.0, seed=3,
            spp=LOBE_CPI_SAMPLES, max_depth=6, time_sampling='gate',
            device=dev))
    by = rk.receive_megakernel_cpi.by_config
    e_cpi = (cube[..., 0] ** 2 + cube[..., 1] ** 2).sum(0)[:, 0]
    pk_cpi = int(e_cpi.argmax())
    print(f'receive_cpi() windowed corner (thin) {LOBE_CPI_PULSES} pulses x '
          f'2^{LOBE_CPI_SAMPLES.bit_length() - 1} samples depth 6: '
          f'{cpi_ms:.1f} ms (set-up included), {by["coherent_lobes"]} '
          f'launch, peak bin {pk_cpi} (bare corner {pk0}) {tag}')
    if by['coherent_lobes'] != 1 or rk.receive_megakernel_cpi.launches != 1 \
            or wfc.calls or abs(pk_cpi - pk0) > 1 \
            or not bool(torch.isfinite(cube).all()):
        fail(f'lobes CPI: launches {by}, wavefront {wfc.calls}, peak '
             f'{pk_cpi}')

    # ---- K1 against the wavefront: the thin window's profile averaged
    #      over LOBE_WF_SEEDS seeds on each route ----
    s, rx = S.window_corner_scene('thin')
    sd = s.compile(device=dev)
    prof = {}
    for use in (True, False):
        acc_p, t_wf = 0.0, 0.0
        for seed in range(3, 3 + LOBE_WF_SEEDS):
            ms, (a, n) = wall_ms(lambda: bt.receive(
                s, sd, rx, spp=LOBE_WF_SAMPLES, max_depth=6, seed=seed,
                time_sampling='gate', use_kernel=use, device=dev,
                lanes_per_pass=KW_LANES_PER_PASS))
            t_wf += ms
            acc_p = acc_p + profile(a, n, rx, False) / LOBE_WF_SEEDS
        prof[use] = acc_p
        print(f'receive() windowed corner use_kernel={use}: {t_wf:.1f} ms '
              f'for {LOBE_WF_SEEDS} x 2^{LOBE_WF_SAMPLES.bit_length() - 1} '
              f'samples, peak bin {int(np.abs(acc_p).argmax())} {tag}')
    pk_w = int(np.abs(prof[False]).argmax())
    ratio = _bin_energy(prof[True], pk_w, 3) \
        / max(_bin_energy(prof[False], pk_w, 3), 1e-300)
    print(f'K1 against the wavefront, windowed corner (thin) at '
          f'{LOBE_WF_SEEDS} x 2^{LOBE_WF_SAMPLES.bit_length() - 1} samples: '
          f'peak bins {int(np.abs(prof[True]).argmax())} / {pk_w}, window '
          f'energy ratio {ratio:.3f} (bound {LOBE_WF_BOUND})')
    if not LOBE_WF_BOUND[0] < ratio < LOBE_WF_BOUND[1]:
        fail('lobes: K1 and the wavefront disagree on the windowed corner')
    for e_ in out:
        e_.update(anchors=anchors, k1_wavefront_ratio=ratio)
    rule_parity(torch, rk, dev, tag, 'lobe')
    print(f'lobes phase wall {time.perf_counter() - t_phase:.1f} s {tag}')
    return out


def rx_n_time(scene) -> int:
    return scene.receivers[0].adc.n_time

def compare_k1_wavefront_lo(torch, bt, dev, grids, tag):
    """K1 and the wavefront on fmcw_sonar (power: the beat spectrum summed
    over fast time, its peak bin and the energy of the five bins around
    the wavefront's peak) and pulse 0 of the train (I / Q: the summed
    I / Q's magnitude and phase), each at KW_SAMPLES."""
    import numpy as np
    for what, coh, ts, depth in (('fmcw_sonar', False, 'fixed', COH_DEPTH),
                                 ('pulse_train', True, 'gate', PULSE_DEPTH)):
        s, sd, rx = grids[what]
        n_s = KW_SAMPLES[what]
        out = {}
        for use in (True, False):
            ms, (a, n) = wall_ms(lambda: bt.receive(
                s, sd, rx, seed=3, spp=n_s, max_depth=depth, coherent=coh,
                time_sampling=ts, use_kernel=use,
                lanes_per_pass=KW_LANES_PER_PASS, device=dev))
            g = bt.develop_signal(a, n, rx.adc).cpu().double().numpy()
            out[use] = (g[..., 0] + 1j * g[..., 1]) if coh else g[..., 0]
            print(f'{what} use_kernel={use}: {ms:.1f} ms for '
                  f'2^{n_s.bit_length() - 1} samples {tag}')
        g1, gw = out[True], out[False]
        if coh:
            z1, zw = g1.sum(), gw.sum()
            mag = abs(z1) / abs(zw) - 1
            dph = float(np.angle(z1 * np.conj(zw)))
            print(f'K1 against the wavefront, {what}: summed I / Q '
                  f'{z1:.4e} / {zw:.4e}, magnitude {mag:+.3f} (bound '
                  f'+-{K1_WF_COH_BOUND}), phase {np.angle(z1):+.3f} / '
                  f'{np.angle(zw):+.3f} rad (difference {dph:+.3f}, bound '
                  f'{K1_WF_PHASE_BOUND})')
            ok = abs(mag) <= K1_WF_COH_BOUND and abs(dph) <= K1_WF_PHASE_BOUND
        else:
            m1, mw = g1.sum(0), gw.sum(0)
            p1, pw = int(m1.argmax()), int(mw.argmax())
            win = slice(max(pw - 2, 0), pw + 3)
            e1, ew = float(m1[win].sum()), float(mw[win].sum())
            print(f'K1 against the wavefront, {what}: beat peak bins {p1} / '
                  f'{pw}, window energy {e1:.4e} / {ew:.4e} '
                  f'({e1 / ew - 1:+.3f}; bound +-{K1_WF_COH_BOUND})')
            ok = abs(p1 - pw) <= 1 and abs(e1 - ew) <= K1_WF_COH_BOUND * ew
        if not ok:
            fail(f'{what}: K1 and the wavefront disagree')


def compare_k1_wavefront(torch, k1_grid, wf_grid, s, cfg):
    """K1 and the wavefront on multi_body at the same sample count: each
    body's peak cell within one bin, its window energy within
    K1_WF_BOUND."""
    g1 = k1_grid.cpu().double().numpy()
    gw = wf_grid.cpu().double().numpy()
    for name, t_bin, f_bin, _ in multi_body_anchors(s, cfg):
        rows = _window(g1, t_bin)
        p1 = divmod(int(g1[rows].argmax()), cfg.n_freq)
        pw = divmod(int(gw[rows].argmax()), cfg.n_freq)
        fc = int(round(f_bin))
        cols = slice(max(fc - 2, 0), fc + 3)
        e1, ew = float(g1[rows, cols].sum()), float(gw[rows, cols].sum())
        print(f'K1 against the wavefront, {name}: peak cells (time, '
              f'Doppler) {(rows.start + p1[0], p1[1])} / '
              f'{(rows.start + pw[0], pw[1])}, window energy {e1:.4e} / '
              f'{ew:.4e} ({e1 / ew - 1:+.3f}; bound +-{K1_WF_BOUND})')
        if abs(p1[0] - pw[0]) > 1 or abs(p1[1] - pw[1]) > 1 \
                or abs(e1 - ew) > K1_WF_BOUND * abs(ew):
            fail(f'multi_body {name}: K1 and the wavefront disagree')


def aperture_rays(torch, scene, rx, lo, hi, n, gen, dev):
    """n rays from uniform points of the receiver aperture toward uniform
    points of the box [lo, hi]."""
    i = scene.shape_index_of_endpoint('receiver', rx.id)
    m = torch.tensor(scene.shapes[i].to_world, device=dev)
    uv = 2.0 * torch.rand((n, 2), generator=gen, device=dev) - 1.0
    o = uv[:, :1] * m[:3, 0] + uv[:, 1:] * m[:3, 1] + m[:3, 3]
    tgt = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return o, tgt


def bvh_query_inputs(torch, dev):
    """(PackedBVH, o, d, maxt, (scene, receiver rays o1, their count)) of
    the BVH query on mesh_scene: N_RAYS rays, half from uniform points of
    the receiver aperture, half from a 3 m cube about the mesh, toward
    uniform points of the mesh's box; shadow lengths 0.8-1.2 of the
    distance."""
    from beifong_tpu_torch.geometry import bvh as bvh_mod
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    from beifong_tpu_torch.scenes import mesh_scene
    s, rx = mesh_scene()
    sd = s.compile(device=dev)
    tris = [x.cpu().numpy() for x in (sd.tris.v0, sd.tris.e1, sd.tris.e2)]
    pb = bk.pack(bvh_mod.build(*tris, align=True)).to(dev)
    v = sd.tris.v0
    lo, hi = v.min(0).values - 0.02, v.max(0).values + 0.02
    gen = torch.Generator(device=dev).manual_seed(SEED)
    half = N_RAYS // 2
    o1, t1 = aperture_rays(torch, s, rx, lo, hi, half, gen, dev)
    t2 = lo + (hi - lo) * torch.rand((half, 3), generator=gen, device=dev)
    o2 = (lo + hi) / 2 + 3.0 * (torch.rand((half, 3), generator=gen,
                                           device=dev) - 0.5)
    o, tgt = torch.cat([o1, o2]), torch.cat([t1, t2])
    d = tgt - o
    dist = d.norm(dim=1)
    d = (d / dist[:, None]).contiguous()
    o = o.contiguous()
    maxt = (dist * (0.8 + 0.4 * torch.rand(N_RAYS, generator=gen,
                                           device=dev))).contiguous()
    return pb, o, d, maxt, (s, o1, half)


def host_us(torch, fn, n: int = K4_QUEUED, reps: int = 5) -> float:
    """Host µs a call of fn(): the wrapper's Python, checks, allocation and
    launch, not the kernel: n calls enqueued behind a sleeping kernel (so
    that none waits for the card), the median over `reps` of their
    mean."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(K4_SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def bvh_issue(bk, bvh_mix, tag) -> dict:
    """Thread-instructions a slab test and a triangle test of K2 and K3,
    read from the library's SASS (`tools/bvh_mix.py`), and the card's top
    SM clock."""
    import k1_mix
    import k4_mix
    per = {k: bvh_mix.per_test(v) for k, v in bvh_mix.parse(k4_mix.listing(
        bk.build_library().path)).items()}
    clock = k1_mix.card_clock_mhz()[2]
    print('BVH SASS, thread-instructions a slab test and a triangle test: '
          + json.dumps({k: {x: v[x] for x in ('slab', 'slabs_a_step',
                                              'triangle')}
                        for k, v in per.items()})
          + f'; SM clock {clock:.0f} MHz {tag}')
    if any(v['slab'] is None or v['triangle'] is None
           for v in per.values()):
        fail(f'bvh_mix found no node step or triangle loop: {per}')
    return dict(per=per, clock=clock)


def queries(torch, bt, dev, tag, build_log: str) -> list:
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    regs, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*(bvh_\w+?)_kernel",
                      line)
        if m:
            fn = m.group(1)
        elif 'registers' in line and fn:
            regs[fn] = int(re.search(r'(\d+) registers', line).group(1))
    pb, o, d, maxt, (s, o1, half) = bvh_query_inputs(torch, dev)

    # ---- 3. parity ----
    t, idx, u, vv = bk.bvh_closest(pb, o, d)
    occ = bk.bvh_any(pb, o, d, maxt)
    st_c: dict = {}
    st_a: dict = {}
    pc_ms, (rt, ri, ru, rv) = wall_ms(lambda: bk.bvh_closest_ref(
        pb, o, d, stats=st_c))
    pa_ms, ro = wall_ms(lambda: bk.bvh_any_ref(pb, o, d, maxt, stats=st_a))
    flips = int((idx != ri).sum())
    same = (idx == ri) & (ri >= 0)
    t_rel = float(((t - rt).abs() / rt.abs())[same].max())
    du = float((u - ru).abs()[same].max())
    dv = float((vv - rv).abs()[same].max())
    occ_flips = int((occ != ro).sum())
    t_abs = float((t - rt).abs()[same].max())
    print(f'parity bvh_closest 2^20 rays: {int((ri >= 0).sum())} hits, '
          f'{flips} rays with another face (edge flips), on the same face '
          f'max t err {t_abs:.3e} ({t_rel:.3e} relative), max |du| '
          f'{du:.3e}, max |dv| {dv:.3e}')
    print(f'parity bvh_any 2^20 rays: {int(ro.sum())} occluded, '
          f'{N_RAYS - int(ro.sum())} free, {occ_flips} flags differ')
    if flips > EDGE_FLIPS * N_RAYS or occ_flips > EDGE_FLIPS * N_RAYS:
        fail(f'bvh kernels: {flips} / {occ_flips} rays differ from the '
             f'plain versions')
    if not (t_rel <= 1e-5 and 0 < int(ro.sum()) < N_RAYS):
        fail(f'bvh_closest: t differs by {t_rel:.3e} relative, or the '
             f'shadow rays are all free or all blocked')
    wt = bk.walk_tables(pb)
    print(f'plain versions: bvh_closest {pc_ms:.1f} ms, bvh_any '
          f'{pa_ms:.1f} ms {tag}; walk counts closest {json.dumps(st_c)}, '
          f'any {json.dumps(st_a)}; node pairs {wt.rec.shape[0]} '
          f'({4 * wt.rec.numel()} B), tree depth {wt.depth}')

    # ---- 4. the query path: receiver rays, then shadow rays to the tx ----
    ti = s.shape_index_of_endpoint('transmitter', s.transmitters[0].id)
    tx_pos = torch.tensor(s.shapes[ti].to_world[:3, 3], device=dev)
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    t_q, idx_q, _, _ = bk.bvh_closest(pb, o1.contiguous(),
                                      d[:half].contiguous())
    hit = idx_q >= 0
    p = o1[hit] + (t_q[hit, None] - 1e-4) * d[:half][hit]
    to_tx = tx_pos - p
    dist_tx = to_tx.norm(dim=1)
    occ_q = bk.bvh_any(pb, p.contiguous(),
                       (to_tx / dist_tx[:, None]).contiguous(),
                       dist_tx.contiguous())
    launches = (bk.bvh_closest.launches, bk.bvh_any.launches)
    torch.cuda.synchronize()
    if launches != (1, 1):
        fail(f'the query path launched bvh_closest / bvh_any {launches} '
             f'times')
    print(f'query path: {int(hit.sum())} of {half} receiver rays hit the '
          f'mesh, {int(occ_q.sum())} of those see no transmitter')

    # the kernels alone (launches here do not count) at 2^20 rays and at
    # the BVH wavefront's pass of 2^17 (every eighth ray: the same mix of
    # aperture and volume rays), with its own walk counts: device time
    # (calls queued behind a sleep), a call's time with its wrapper
    # (events around each call) and the wrapper's host µs
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import bvh_mix
    mix = bvh_issue(bk, bvh_mix, tag)
    tables = 4 * (pb.bbox.numel() + pb.links.numel() + pb.leaves.numel())
    out = {'closest': {}, 'any': {}}
    for shape, step in (('2^20', 1), ('2^17', N_RAYS // WF_PASS_RAYS)):
        oo, dd, mm = (x[::step].contiguous() for x in (o, d, maxt))
        n = int(oo.shape[0])
        st = {'closest': st_c, 'any': st_a} if step == 1 else \
            {'closest': {}, 'any': {}}
        plain_ms = {'closest': pc_ms, 'any': pa_ms}
        if step != 1:
            plain_ms['closest'], _ = wall_ms(lambda: bk.bvh_closest_ref(
                pb, oo, dd, stats=st['closest']))
            plain_ms['any'], _ = wall_ms(lambda: bk.bvh_any_ref(
                pb, oo, dd, mm, stats=st['any']))
        calls = {'closest': lambda: bk.bvh_closest(pb, oo, dd),
                 'any': lambda: bk.bvh_any(pb, oo, dd, mm)}
        for k, call in calls.items():
            call()
            q = queued_ms(torch, call)
            ev, _ = cuda_ms(lambda i: call(), 6)
            h = host_us(torch, call)
            c = st[k]
            b = bound(walk_ops(c), tables + n * ((24 + 16) if k == 'closest'
                                                 else (24 + 4 + 1)),
                      f'bvh_{k} {shape} rays')
            per = mix['per'][k]
            issue = bvh_mix.issue_slot_bound_ms(
                c['node_tests'], 8 * c['leaf_tests'], per, mix['clock'])
            r = dict(ms=statistics.median(q), queued_ms=q,
                     call_ms=statistics.median(ev[1:]), host_us=h,
                     plain_ms=plain_ms[k], issue_slot_bound_ms=issue, **b)
            print(f'bvh_{k} {shape} rays: device {r["ms"]:.4f} ms (queued '
                  f'{[round(x, 4) for x in q]}), a call with its wrapper '
                  f'{r["call_ms"]:.4f} ms, host {h:.1f} µs a call; bounds '
                  f'{b["bound_ms"]:.4e} ms ({b["bound_by"]}), issue slots '
                  f'{issue:.4e} ms ({per["slab"]} / {per["triangle"]} '
                  f'thread-instructions a slab / triangle test); plain '
                  f'version {plain_ms[k]:.1f} ms {tag}')
            out[k][shape] = r
    common = dict(route='cuda', source='beifong_tpu_torch/csrc/'
                  'bvh_kernels.cu', library_ms=None)

    def entry(k):
        a, b = out[k]['2^20'], out[k]['2^17']
        return dict(**a, ms_2_17=b['ms'], queued_ms_2_17=b['queued_ms'],
                    call_ms_2_17=b['call_ms'], host_us_2_17=b['host_us'],
                    plain_ms_2_17=b['plain_ms'], bound_ms_2_17=b['bound_ms'],
                    bound_by_2_17=b['bound_by'],
                    issue_slot_bound_ms_2_17=b['issue_slot_bound_ms'],
                    registers=regs.get(f'bvh_{k}'),
                    thread_instructions=mix['per'][k]['slab'],
                    thread_instructions_triangle=mix['per'][k]['triangle'])
    return [
        dict(name='bvh_closest', **common,
             replaces='beifong_tpu/geometry/pallas_bvh.py:380',
             tpu_function='_run_closest via bvh_closest (pallas_bvh.py:396)',
             launches=launches[0], max_abs_err=t_abs, parity=t_rel,
             edge_flips=flips, **entry('closest')),
        dict(name='bvh_any', **common,
             replaces='beifong_tpu/geometry/pallas_bvh.py:426',
             tpu_function='_run_any via bvh_any (pallas_bvh.py:437)',
             launches=launches[1], max_abs_err=float(occ_flips > 0),
             parity=occ_flips / N_RAYS, edge_flips=occ_flips,
             **entry('any')),
    ]


class Patch:
    """Replaces module attributes for the length of a `with` block (the
    hooks below time and record the K4 launches of a receive() call)."""

    def __init__(self, **targets):
        self.targets = targets    # 'label': (module, attribute, wrapper)
        self.saved = []

    def __enter__(self):
        for module, attr, make in self.targets.values():
            orig = getattr(module, attr)
            new = make(orig)
            if hasattr(orig, 'launches'):
                # the wrapped function counts its launches under its module
                # name, which now names the wrapper
                new.launches = orig.launches
            self.saved.append((module, attr, orig, new))
            setattr(module, attr, new)
        return self

    def __exit__(self, *exc):
        for module, attr, orig, new in self.saved:
            if hasattr(orig, 'launches'):
                orig.launches = new.launches
            setattr(module, attr, orig)
        return False


def _k4_cull_records(torch, v0, e1, e2):
    """The cull records that csrc/intersect_kernels.cu stages (centre,
    lambda^2 R^2, scaled normal, K R^2), in float32 tensor arithmetic
    (unfused: a count of kept pairs, not the kernel's own rounding)."""
    m = v0 + (e1 + e2) * (1.0 / 3.0)
    p = v0 - m
    r2 = torch.stack([(p * p).sum(1), ((p + e1) ** 2).sum(1),
                      ((p + e2) ** 2).sum(1)]).max(0).values * 1.0001
    nrm = (torch.linalg.cross(e1, e2)
           / (e1.norm(dim=1) * e2.norm(dim=1))[:, None])
    return m, 1.0405 * r2, nrm, 4e-8 * r2


def _k4_pair_counts(torch, ik, o, d, v0, e1, e2, maxt) -> dict:
    """(ray, triangle) pairs on this data: all of them and those the cull
    keeps (closest hit); each ray's triangles in index order up to and
    including its first blocker, all of them for a ray that nothing
    blocks, and those of them the cull keeps (shadow test)."""
    n, n_tris = int(o.shape[0]), int(v0.shape[0])
    limit = (maxt * (1.0 - 1e-3))[:, None]
    c, cw, nrm, nw = _k4_cull_records(torch, v0, e1, e2)
    h = d / d.norm(dim=1, keepdim=True)
    out = dict(pairs=n * n_tris, kept=0, any_pairs=0, any_kept=0)
    step = 1 << 12
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        first = torch.full((r1 - r0,), n_tris, dtype=torch.int64,
                           device=o.device)
        keeps = []
        for f0 in range(0, n_tris, ik.CHUNK_F):
            f1 = min(f0 + ik.CHUNK_F, n_tris)
            det, u, v, t = ik.moller_trumbore(o[r0:r1], d[r0:r1], v0[f0:f1],
                                              e1[f0:f1], e2[f0:f1])
            blk = ik.is_hit(det, u, v, t) & (t < limit[r0:r1])
            # argmax returns the first True of a row
            at = torch.where(blk.any(1), blk.to(torch.float32).argmax(1) + f0 + 1,
                             n_tris)
            first = torch.minimum(first, at)
            w = c[None, f0:f1] - o[r0:r1, None]
            b = (w * h[r0:r1, None]).sum(-1)
            ww = (w * w).sum(-1)
            rho2 = ww - b.clamp(min=0) ** 2
            g2 = (nrm[None, f0:f1] * h[r0:r1, None]).sum(-1) ** 2 \
                - 64 * 2.0 ** -24
            lo = rho2 - 2e-6 * ww
            far = lo > cw[None, f0:f1]
            steep = g2 * lo > 4e-8 * ww + nw[None, f0:f1]
            keeps.append(~(far & steep))
        keep = torch.cat(keeps, 1)
        out['kept'] += int(keep.sum())
        out['any_pairs'] += int(first.sum())
        upto = torch.arange(n_tris, device=o.device)[None] < first[:, None]
        out['any_kept'] += int((keep & upto).sum())
    return out


def k4_inputs(torch, dev, shape: str):
    """(o, d, v0, e1, e2, maxt) of K4 at one of K4_SHAPES: rays from
    uniform points of the receiver aperture toward uniform points of the
    soup's box (a quarter aimed past it: misses), shadow lengths 0.6-1.4x
    the distance to the target."""
    from beifong_tpu_torch.scenes import mesh_scene, multi_body_scene
    scene_fn, n_rays = {
        'wavefront': (multi_body_scene, K4_RAYS),
        'query': (mesh_scene, K4_QUERY_RAYS),
        'faces968': (lambda: mesh_scene(n_side=22), K4_RAYS)}[shape]
    s, rx = scene_fn()
    sd = s.compile(use_bvh=False, device=dev)
    v0, e1, e2 = (x.contiguous() for x in (sd.tris.v0, sd.tris.e1,
                                           sd.tris.e2))
    lo, hi = v0.min(0).values - 0.05, v0.max(0).values + 0.05
    gen = torch.Generator(device=dev).manual_seed(SEED)
    o, tgt = aperture_rays(torch, s, rx, lo, hi, n_rays, gen, dev)
    tgt[: n_rays // 4] += 3.0 * (hi - lo)
    d = tgt - o
    dist = d.norm(dim=1)
    d = (d / dist[:, None]).contiguous()
    maxt = (dist * (0.6 + 0.8 * torch.rand(n_rays, generator=gen,
                                            device=dev))).contiguous()
    return o.contiguous(), d, v0, e1, e2, maxt


# the wavefront's shape, the query shape, and the largest soup that
# Scene.compile(use_bvh='auto') leaves to K4 (scene.py: up to 1,024 faces)
K4_SHAPES = ('wavefront', 'query', 'faces968')


def queued_ms(torch, fn, n: int = K4_QUEUED, reps: int = 5) -> list:
    """Device ms a call of fn(): n calls queued behind a sleeping kernel,
    so that the card runs them back to back and the host's enqueue time
    stays out, CUDA events around the n; one number for each of `reps`
    runs."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(K4_SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return out


def _bits(torch, x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def k4_parity(torch, ik, dev, tag, build_log: str) -> list:
    """K4 against its plain version on the card, bit for bit, at
    K4_SHAPES; the kernels' times (queued, and a call with its wrapper),
    registers, shared memory, both bounds and the pairs the cull keeps,
    and the plain version's times."""
    regs, fn = {}, None
    for line in build_log.splitlines():
        if 'Compiling entry function' in line:
            fn = ('ray_triangle_any' if 'ILb1E' in line
                  else 'ray_triangle_closest')
        elif 'registers' in line and fn:
            regs[fn] = int(re.search(r'(\d+) registers', line).group(1))
    # thread-instructions of a culled triangle and of an exact test, read
    # from the library's SASS, and the card's top SM clock: the issue-slot
    # bound
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import k1_mix
    import k4_mix
    mix = {('ray_triangle_any' if k == 'any' else 'ray_triangle_closest'):
           k4_mix.per_pair(v) for k, v in k4_mix.parse(k4_mix.listing(
               ik.build_library().path)).items()}
    clock = k1_mix.card_clock_mhz()[2]
    per = {k: {'cull': v['cull'], 'exact': v['exact']}
           for k, v in mix.items()}
    print(f'K4 SASS, thread-instructions a culled triangle and an exact '
          f'test: {json.dumps(per)}; SM clock {clock:.0f} MHz {tag}')
    out = {'ray_triangle_closest': {}, 'ray_triangle_any': {}}
    for shape in K4_SHAPES:
        o, d, v0, e1, e2, maxt = k4_inputs(torch, dev, shape)
        n_rays, n_tris = int(o.shape[0]), int(v0.shape[0])
        got = (*ik.ray_triangle_closest(o, d, v0, e1, e2),
               ik.ray_triangle_any(o, d, v0, e1, e2, maxt))
        pc_ms, ref = wall_ms(
            lambda: ik.ray_triangle_closest_ref(o, d, v0, e1, e2))
        pa_ms, ro = wall_ms(
            lambda: ik.ray_triangle_any_ref(o, d, v0, e1, e2, maxt))
        ref = (*ref, ro)
        differ = {k: int((_bits(torch, a) != _bits(torch, b)).sum())
                  for k, a, b in zip(('t', 'idx', 'u', 'v', 'any'), got,
                                     ref)}
        hits, blocked = int((ref[1] >= 0).sum()), int(ro.sum())
        print(f'parity K4 {shape} {n_rays} rays x {n_tris} faces: {hits} '
              f'hits, {blocked} blocked; rays whose bits differ from the '
              f'plain version: {differ}')
        if any(differ.values()) or not (0 < hits < n_rays
                                        and 0 < blocked < n_rays):
            fail(f'K4 {shape}: the kernels differ from the plain version '
                 f'({differ}) or the rays are degenerate')
        c_ms = queued_ms(torch, lambda: ik.ray_triangle_closest(
            o, d, v0, e1, e2))
        a_ms = queued_ms(torch, lambda: ik.ray_triangle_any(
            o, d, v0, e1, e2, maxt))
        cc_ms, _ = cuda_ms(lambda i: ik.ray_triangle_closest(o, d, v0, e1,
                                                             e2), 6)
        ac_ms, _ = cuda_ms(lambda i: ik.ray_triangle_any(o, d, v0, e1, e2,
                                                         maxt), 6)
        c_med, a_med = statistics.median(c_ms), statistics.median(a_ms)
        cc_med, ac_med = (statistics.median(cc_ms[1:]),
                          statistics.median(ac_ms[1:]))
        smem = ik.shared_bytes(n_tris)
        print(f'K4 {shape} {n_rays} x {n_tris}: ray_triangle_closest '
              f'{c_med:.4f} ms ({K4_QUEUED} calls queued; {cc_med:.4f} ms a '
              f'call with its wrapper, CUDA events around each), '
              f'ray_triangle_any {a_med:.4f} ms ({ac_med:.4f}); plain '
              f'versions {pc_ms:.1f} / {pa_ms:.1f} ms; registers {regs}, '
              f'{smem} B of shared memory a block {tag}')
        cnt = _k4_pair_counts(torch, ik, o, d, v0, e1, e2, maxt)
        print(f'K4 {shape} pairs: {cnt["pairs"]} in all, {cnt["kept"]} kept '
              f'by the cull ({cnt["kept"] / cnt["pairs"]:.5f}); shadow test '
              f'up to each first blocker {cnt["any_pairs"]} '
              f'({cnt["any_pairs"] / cnt["pairs"]:.3f} of all), '
              f'{cnt["any_kept"]} kept')
        b_c = bound(float(cnt['pairs']) * K4_PAIR_OPS,
                    n_rays * (24 + 16) + 36 * n_tris,
                    f'ray_triangle_closest {shape} (every pair tested)')
        b_cc = bound(float(cnt['pairs']) * K4_CULL_OPS
                     + float(cnt['kept']) * K4_PAIR_OPS,
                     n_rays * (24 + 16) + 36 * n_tris,
                     f'ray_triangle_closest {shape} (the cull on every '
                     'pair, the test on the kept ones)')
        b_a = bound(float(cnt['any_pairs']) * K4_PAIR_OPS,
                    n_rays * (24 + 4 + 1) + 36 * n_tris,
                    f'ray_triangle_any {shape} (each ray up to its first '
                    'blocker)')
        b_ac = bound(float(cnt['any_pairs']) * K4_CULL_OPS
                     + float(cnt['any_kept']) * K4_PAIR_OPS,
                     n_rays * (24 + 4 + 1) + 36 * n_tris,
                     f'ray_triangle_any {shape} (the cull up to the first '
                     'blocker, the test on the kept pairs)')
        for name, ms, call, p_ms, b, bc, pairs, kept in (
                ('ray_triangle_closest', c_med, cc_med, pc_ms, b_c, b_cc,
                 cnt['pairs'], cnt['kept']),
                ('ray_triangle_any', a_med, ac_med, pa_ms, b_a, b_ac,
                 cnt['any_pairs'], cnt['any_kept'])):
            # every pair culled, the kept ones tested (a kernel without a
            # cull tests every pair)
            m = mix[name]
            instr = (pairs * m['cull'] + kept * m['exact'] if m['cull']
                     else pairs * m['exact'])
            slots = k4_mix.issue_slot_bound_ms(instr, clock)
            print(f'K4 {name} {shape}: {100 * b["bound_ms"] / ms:.1f}% of '
                  f'the 47-operation bound, {100 * bc["bound_ms"] / ms:.1f}% '
                  f'of the cull bound, {100 * slots / ms:.1f}% of the '
                  f'issue-slot bound ({slots:.4f} ms) {tag}')
            key = '' if shape == 'wavefront' else f'_{shape}'
            out[name].update({f'ms{key}': ms, f'call_ms{key}': call,
                              f'plain_ms{key}': p_ms,
                              f'bound_ms{key}': b['bound_ms'],
                              f'bound_by{key}': b['bound_by'],
                              f'cull_bound_ms{key}': bc['bound_ms'],
                              f'issue_slot_bound_ms{key}': slots,
                              f'kept_pairs{key}': kept,
                              f'max_abs_err{key}': 0.0,
                              f'shared_bytes{key}': smem,
                              f'shape{key}': [n_rays, n_tris]})
    common = dict(route='cuda',
                  source='beifong_tpu_torch/csrc/intersect_kernels.cu',
                  replaces='beifong_tpu/geometry/pallas_intersect.py:109',
                  library_ms=None)
    return [dict(name='ray_triangle_closest', **common,
                 registers=regs.get('ray_triangle_closest'),
                 tpu_function='_kernel (pallas_intersect.py:30) via '
                 'ray_triangle_closest (:77)', **out['ray_triangle_closest']),
            dict(name='ray_triangle_any', **common,
                 registers=regs.get('ray_triangle_any'),
                 tpu_function='_kernel (pallas_intersect.py:30) via '
                 'ray_triangle_any (:130)', **out['ray_triangle_any'])]


def _k4_timer(torch, ik, events: list):
    """Wrappers of the K4 entry points that bracket each launch with CUDA
    events (their sum is the K4 time inside a receive() call)."""
    def wrap(orig):
        def timed(*a):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            res = orig(*a)
            s1.record()
            events.append((s0, s1))
            return res
        return timed
    return Patch(c=(ik, 'ray_triangle_closest', wrap),
                 a=(ik, 'ray_triangle_any', wrap))


def _recorder(torch, ik, rp, rec: dict, n_lanes: int, dev):
    """Wrappers that record, per lane, the sum of |value| splatted and
    every K4 face and shadow flag (one pass of n_lanes lanes)."""
    rec['lane'] = torch.zeros(n_lanes, dtype=torch.float64, device=dev)
    rec['faces'], rec['flags'] = [], []

    def splat(orig):
        def hooked(adc, cfg, t_off, f_out, value, active, *a, **k):
            rec['lane'] += torch.where(active, value.abs(), 0.0).double()
            return orig(adc, cfg, t_off, f_out, value, active, *a, **k)
        return hooked

    def closest(orig):
        def hooked(*a):
            res = orig(*a)
            rec['faces'].append(res[1].cpu())
            return res
        return hooked

    def anyhit(orig):
        def hooked(*a):
            res = orig(*a)
            rec['flags'].append(res.cpu())
            return res
        return hooked

    return Patch(s=(rp, '_adc_splat', splat),
                 c=(ik, 'ray_triangle_closest', closest),
                 a=(ik, 'ray_triangle_any', anyhit))


def _profile(torch, run, what, tag):
    """One call under torch.profiler: device time by kernel, the device's
    busy share of the call, the top kernels (the table goes to
    chiprun_out/)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(run)
    rows = prof.key_averages()

    def dev_us(r):
        for attr in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(r, attr):
                return float(getattr(r, attr))
        return 0.0

    # kernel rows only: an operator's row repeats its kernels' device time
    kern = [(r.key, dev_us(r), r.count) for r in rows
            if str(getattr(r, 'device_type', '')).endswith('CUDA')
            and dev_us(r) > 0]
    busy = sum(k[1] for k in kern) / 1e3
    if not kern:
        print(f'profile {what}: no device time recorded (not measured)')
        return None
    groups = {'K4 ray_triangle': 0.0, 'K2/K3 bvh': 0.0,
              'splat index_add': 0.0, 'gathers': 0.0, 'matmul': 0.0,
              'elementwise and other': 0.0}
    for name, us, _ in kern:
        if 'ray_triangle' in name:
            groups['K4 ray_triangle'] += us
        elif 'bvh_' in name:
            groups['K2/K3 bvh'] += us
        elif 'indexFunc' in name:
            groups['splat index_add'] += us
        elif 'gather' in name or 'index_elementwise' in name:
            groups['gathers'] += us
        elif 'gemv' in name or 'gemm' in name or 'bmm' in name:
            groups['matmul'] += us
        else:
            groups['elementwise and other'] += us
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out',
                           f'profile_{what}.txt'), 'w') as f:
        f.write(rows.table(sort_by='self_device_time_total'
                           if hasattr(rows[0], 'self_device_time_total')
                           else 'self_cuda_time_total', row_limit=60))
    top = sorted(kern, key=lambda k: -k[1])[:8]
    print(f'profile {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms '
          f'({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), '
          f'{sum(k[2] for k in kern)} kernel launches; by group (ms): '
          + json.dumps({k: round(v / 1e3, 3) for k, v in groups.items()})
          + f' {tag}')
    for name, us, cnt in top:
        print(f'  {us / 1e3:9.3f} ms {cnt:6d}x {name[:90]}')
    return dict(wall_ms=wall, busy_ms=busy, groups_ms={
        k: v / 1e3 for k, v in groups.items()})


def _layers(torch, run, tag):
    """Host wall time of the wavefront's layers in one call, each call of
    a layer ended by a synchronise: intersect (closest hit and shadow
    test, K4 / K2 / K3 inside), BSDF (eval and sample), splat, sample
    stream (Philox); the rest (ray generation, NEE sampling, waveforms,
    Doppler) is the remainder."""
    from beifong_tpu_torch import scene as sc_mod
    from beifong_tpu_torch.core import rng
    from beifong_tpu_torch.integrators import radar_path as rp
    spent = {'intersect': 0.0, 'bsdf': 0.0, 'splat': 0.0, 'rng': 0.0}

    def timed(key):
        def make(orig):
            def f(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = orig(*a, **k)
                torch.cuda.synchronize()
                spent[key] += (time.perf_counter() - t0) * 1e3
                return res
            return f
        return make

    patch = Patch(ri=(sc_mod.SceneData, 'ray_intersect', timed('intersect')),
                  rt=(sc_mod.SceneData, 'ray_test', timed('intersect')),
                  be=(rp, 'bsdf_eval_pdf', timed('bsdf')),
                  bs=(rp, 'bsdf_sample', timed('bsdf')),
                  sp=(rp, '_adc_splat', timed('splat')),
                  rn=(rng.SampleStream, 'uniform', timed('rng')))
    with patch:
        wall, _ = wall_ms(run)
    rest = wall - sum(spent.values())
    print(f'layers of one wavefront call (host ms, synchronised): total '
          f'{wall:.1f}; ' + ', '.join(f'{k} {v:.1f} ({100 * v / wall:.1f}%)'
                                      for k, v in spent.items())
          + f', rest {rest:.1f} ({100 * rest / wall:.1f}%) {tag}')
    return dict(spent, total=wall)


def wavefront(torch, bt, ik, bk, rk, dev, tag, pulse_compress, k1_grid):
    """The eager wavefront's paths; `k1_grid` is K1's developed multi_body
    grid at WF_SAMPLES.  Returns (K4 launches on the multi_body path, K2 /
    K3 launches on the BVH path)."""
    from beifong_tpu_torch.integrators import radar_path as rp
    from beifong_tpu_torch.scenes import (flagship_scene, mesh_scene,
                                          multi_body_scene, round_trip_bin)
    s, rx = multi_body_scene()
    sd = s.compile(use_bvh=False, device=dev)
    cfg = rx.adc
    # multi_body is in K1's scope: use_kernel=False keeps it, and K4, here
    kw = dict(max_depth=WF_DEPTH, time_sampling='gate', use_kernel=False)
    if sd.bvh is not None:
        fail('multi_body: expected without the wavefront BVH')
    print(f'multi_body: {sd.tris.n_faces} faces, routed to the wavefront by '
          'use_kernel=False')

    # ---- the main path: receive() at 2^22 samples ----
    ik.ray_triangle_closest.launches = ik.ray_triangle_any.launches = 0
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    rk.receive_megakernel.launches = 0
    bt.receive(s, sd, rx, seed=1, spp=WF_SAMPLES, device=dev, **kw)
    events: list = []
    with _k4_timer(torch, ik, events):
        call_ms, (adc, n) = cuda_ms(lambda i: bt.receive(
            s, sd, rx, seed=2 + i, spp=WF_SAMPLES, device=dev, **kw), 5)
    torch.cuda.synchronize()
    k4_ms = sum(a.elapsed_time(b) for a, b in events) / 5
    k4 = {'ray_triangle_closest': ik.ray_triangle_closest.launches,
          'ray_triangle_any': ik.ray_triangle_any.launches}
    n_pass = WF_SAMPLES // (1 << 17)
    want = 6 * n_pass * WF_DEPTH
    if k4 != {'ray_triangle_closest': want, 'ray_triangle_any': want} \
            or rk.receive_megakernel.launches or bk.bvh_closest.launches \
            or n != WF_SAMPLES:
        fail(f'multi_body path launched K4 {k4} times in 6 calls (want '
             f'{want} each), K1 {rk.receive_megakernel.launches}, K2 '
             f'{bk.bvh_closest.launches}; {n} samples')
    med = statistics.median(call_ms)
    print(f'receive() multi_body wavefront 2^22 samples depth 2: median '
          f'{med:.2f} ms/call ({WF_SAMPLES / (med * 1e-3):.4e} samples/s), '
          f'calls {[round(x, 2) for x in call_ms]}; K4 launches per call: '
          f'{k4["ray_triangle_closest"] // 6} closest + '
          f'{k4["ray_triangle_any"] // 6} any ({n_pass} passes) {tag}')
    print(f'K4 inside the timed receive() calls: {len(events) // 5} launches '
          f'and {k4_ms:.3f} ms per call, {100 * k4_ms / med:.2f}% of the '
          f'median call (CUDA events around each launch) {tag}')
    # the time by kernel, over one call of PROFILE_SAMPLES (the passes are
    # alike; the profiler's own host cost would lengthen a full call)
    _profile(torch, lambda: bt.receive(s, sd, rx, seed=10,
                                       spp=PROFILE_SAMPLES, device=dev,
                                       **kw),
             'multi_body', tag)
    _layers(torch, lambda: bt.receive(s, sd, rx, seed=11,
                                      spp=PROFILE_SAMPLES, device=dev,
                                      **kw), tag)

    # the example's anchors: each body in its range gate at its Doppler,
    # and K1 at the same sample count
    grid = bt.develop_signal(adc, n, cfg)[..., 0]
    check_multi_body(torch, grid, s, cfg, 'wavefront')
    compare_k1_wavefront(torch, k1_grid, grid, s, cfg)

    # ---- the same scene on the card and on the CPU, one seed ----
    rec_gpu: dict = {}
    rec_cpu: dict = {}
    kw1 = dict(kw, seed=4, spp=WF_CPU_SAMPLES)
    with _recorder(torch, ik, rp, rec_gpu, WF_CPU_SAMPLES, dev):
        a_gpu, _ = bt.receive(s, sd, rx, device=dev, **kw1)
    sd_cpu = s.compile(use_bvh=False, device='cpu')
    cpu_ms, a_cpu = wall_ms(lambda: _cpu_receive(torch, bt, ik, rp, s, sd_cpu,
                                                 rx, rec_cpu, kw1))
    moved = torch.zeros(WF_CPU_SAMPLES, dtype=torch.bool)
    for a, b in zip(rec_gpu['faces'] + rec_gpu['flags'],
                    rec_cpu['faces'] + rec_cpu['flags']):
        moved |= a != b
    n_moved = int(moved.sum())
    lane = (rec_gpu['lane'].cpu() + rec_cpu['lane'])
    slack = float(lane[moved].sum())
    ref = a_cpu[..., 0].double()
    err = float((a_gpu[..., 0].cpu().double() - ref).abs().max())
    scale = float(ref.abs().max())
    n_calls = len(rec_gpu['faces']) + len(rec_gpu['flags'])
    print(f'wavefront card against CPU, {WF_CPU_SAMPLES} samples, seed 4: '
          f'max|acc| {scale:.6e}, max abs err {err:.3e} ({err / scale:.3e} '
          f'of max); {n_moved} lanes with another K4 face or flag in '
          f'{n_calls} K4 calls (their |values| {slack:.3e}); CPU run '
          f'{cpu_ms:.0f} ms')
    if n_moved > 1e-4 * WF_CPU_SAMPLES * n_calls \
            or not (scale > 0 and err <= TOL * scale + slack):
        fail(f'wavefront: card and CPU differ ({err:.3e} > {TOL} x '
             f'{scale:.3e} + {slack:.3e}; {n_moved} lanes moved)')

    # ---- the flagship through the kernel and through the wavefront ----
    fs, frx = flagship_scene()
    fsd = fs.compile(device=dev)
    profs = {}
    for use in (True, False):
        ms, (a, nn) = wall_ms(lambda: bt.receive(
            fs, fsd, frx, seed=3, spp=FLAG_SAMPLES, max_depth=FLAG_DEPTH,
            time_sampling='gate', use_kernel=use, device=dev))
        profs[use] = bt.develop_signal(a, nn, frx.adc)[:, 0, 0].cpu().double()
        print(f'flagship use_kernel={use}: {ms:.1f} ms for 2^22 samples, '
              f'depth 3 {tag}')
    tk, tw = profs[True], profs[False]
    pk_k, pk_w = int(tk.argmax()), int(tw.argmax())
    lo_, hi_ = max(pk_w - 3, 0), pk_w + 4
    e_k, e_w = float(tk[lo_:hi_].sum()), float(tw[lo_:hi_].sum())
    print(f'flagship kernel against wavefront: peak bins {pk_k} / {pk_w} '
          f'(2R/c {round_trip_bin(fs, frx):.2f}), peak-window energy '
          f'{e_k:.4e} / {e_w:.4e} ({e_k / e_w - 1:+.3f})')
    if abs(pk_k - pk_w) > 1 or abs(e_k - e_w) > 0.6 * abs(e_w):
        fail('flagship: kernel and wavefront disagree')

    # ---- mesh_scene through the wavefront: BVH queries on K2 / K3 ----
    ms_, mrx = mesh_scene()
    t0 = time.perf_counter()
    msd = ms_.compile(device=dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    if msd.bvh is None:
        fail('mesh_scene compiled without the wavefront BVH')
    bk.bvh_closest.launches = bk.bvh_any.launches = 0
    ik.ray_triangle_closest.launches = 0
    bvh_ms, (a, nn) = wall_ms(lambda: bt.receive(
        ms_, msd, mrx, seed=5, spp=BVH_WF_SAMPLES, max_depth=2,
        time_sampling='gate', use_kernel=False, device=dev))
    bvh_l = {'bvh_closest': bk.bvh_closest.launches,
             'bvh_any': bk.bvh_any.launches}
    n_pass = BVH_WF_SAMPLES // (1 << 17)
    if bvh_l != {'bvh_closest': 2 * n_pass, 'bvh_any': 2 * n_pass} \
            or ik.ray_triangle_closest.launches:
        fail(f'BVH wavefront launched K2 / K3 {bvh_l}, K4 '
             f'{ik.ray_triangle_closest.launches}')
    print(f'mesh_scene wavefront ({msd.tris.n_faces} faces, BVH '
          f'{msd.bvh.n_nodes} nodes, compile {build_ms:.0f} ms): 2^20 '
          f'samples depth 2 in {bvh_ms:.1f} ms; K2 / K3 launches {bvh_l} '
          f'{tag}')
    check_profile(torch, bt, a, nn, mrx, round_trip_bin(ms_, mrx),
                  pulse_compress, 'mesh_scene wavefront')
    return k4, bvh_l


def _cpu_receive(torch, bt, ik, rp, s, sd_cpu, rx, rec, kw1):
    with _recorder(torch, ik, rp, rec, WF_CPU_SAMPLES, 'cpu'):
        a, _ = bt.receive(s, sd_cpu, rx, device='cpu', **kw1)
    return a


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this script needs a card')
    sys.path.insert(0, HERE)
    import beifong_tpu_torch as bt
    from beifong_tpu_torch.dsp.pulse import pulse_compress
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    from beifong_tpu_torch.integrators import receive_kernel as rk

    # ---- 1. device ----
    t_start = time.perf_counter()
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f'device: {name}  ({torch.cuda.device_count()} visible)  torch '
          f'{torch.__version__}  CUDA {torch.version.cuda}')
    print(card)
    tag = f'[{card}]'

    # ---- 2. build: one nvcc per source, all started together ----
    builders = {'receive_megakernel': rk.build_library,
                'bvh_kernels': bk.build_library,
                'intersect_kernels': ik.build_library}
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(HERE, 'tools'))
    import k1_mix
    with ThreadPoolExecutor(len(builders) + 1) as ex:
        futures = {k: ex.submit(fn) for k, fn in builders.items()}
        # the flagship's -lineinfo cubin for its instruction mix
        cubin = ex.submit(k1_mix.build_cubin, HERE)
        infos = {k: f.result() for k, f in futures.items()}
        cubin = cubin.result()
    print_build(infos, tag)
    print(f'build wall {time.perf_counter() - t0:.1f} s {tag}')

    # ---- 3-4. each path: parity, then the path itself ----
    log = infos['receive_megakernel'].log
    walls = {'build': round(time.perf_counter() - t0, 1)}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 1)
        return out

    kernels = [phase('flagship', flagship, torch, bt, rk, dev, tag,
                     pulse_compress, log, cubin),
               phase('mesh', mesh, torch, bt, rk, dev, tag, pulse_compress,
                     log, cubin)]
    dop_kernels, k1_grid = phase('doppler', doppler, torch, bt, rk, ik, dev,
                                 tag, log, cubin)
    kernels += dop_kernels
    kernels += phase('coherent', coherent, torch, bt, rk, ik, dev, tag, log,
                     cubin)
    kernels += phase('cpi', cpi, torch, bt, rk, ik, dev, tag, log, cubin)
    kernels += phase('textures', textures, torch, bt, rk, dev, tag,
                     pulse_compress, log, cubin)
    kernels += phase('prims', prims, torch, bt, rk, dev, tag,
                     pulse_compress, log, cubin)
    kernels += phase('doppler_prims', doppler_prims, torch, bt, rk, dev, tag,
                     log, cubin)
    kernels += phase('mimo', mimo, torch, bt, rk, dev, tag, log, cubin)
    kernels += phase('media', media, torch, bt, rk, dev, tag)
    kernels += phase('phased', phased, torch, bt, rk, dev, tag, log, cubin)
    kernels += phase('lobes', lobes, torch, bt, rk, dev, tag, log, cubin)
    kernels += phase('queries', queries, torch, bt, dev, tag,
                     infos['bvh_kernels'].log)
    k4 = phase('k4', k4_parity, torch, ik, dev, tag,
               infos['intersect_kernels'].log)
    k4_launches, bvh_launches = phase('wavefront', wavefront, torch, bt, ik,
                                      bk, rk, dev, tag, pulse_compress,
                                      k1_grid)
    for k in k4:
        k['launches'] = k4_launches[k['name']]
    for k in kernels:
        if k['name'] in bvh_launches:
            k['wavefront_launches'] = bvh_launches[k['name']]
    kernels += k4

    # ---- 5. report ----
    for k in kernels:
        k['card'] = card
    print(f'phase walls (s): {json.dumps(walls)} {tag}')
    print(f'chip_smoke wall {time.perf_counter() - t_start:.1f} s {tag}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
