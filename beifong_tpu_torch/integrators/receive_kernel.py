"""Radar receive megakernel on Hopper: host side, plain PyTorch version and
the wrapper of the CUDA kernel in `csrc/receive_megakernel.cu`.

Counterpart of `beifong_tpu/integrators/pallas_receive.py` in two
configurations.  The flagship one: analytic rectangles, diffuse BSDFs,
one Wigner transmitter (CW / pulse / LFMCW), a Wigner or omni receiver,
raw receive without LO, fixed or gate time sampling, power accumulation
on a fast-time-only ADC (`n_freq == 1`), a static scene and no medium.
The mesh one adds diffuse triangle meshes (and rectangles demoted into
them past MAX_PRIMS) behind a BVH walk (`csrc/bvh_walk.cuh`) for the
closest hit and the shadow test, and the per-tile direction strata of
the receive rays.  Per lane the kernel generates the receive ray, finds
the closest hit, counts direct transmitter hits at depth 0, connects to
the transmitter (NEE) with the waveform and aperture Wigner weights and a
shadow test, tent-splats into the fast-time bins and makes the diffuse
bounce.

`receive_megakernel_ref` holds that arithmetic as vectorised torch ops
over lanes, in float32, consuming `uniforms (n_draws, n_lanes)` in the
kernel's positional draw order:

1. one time draw (a placeholder under gate sampling);
2. two (omni) or four (Wigner) receive-ray draws;
3. per depth: the direct-hit draw, then two transmitter-point draws and
   the emission-time draw (a placeholder under fixed sampling);
4. per depth but the last: two bounce draws.

`n_draws` over-allocates (26 rows at depth 3, of which 21 are read) and is
honoured as the layout stride.  `receive_megakernel` runs that plain
version for tensors on the CPU and the CUDA kernel for tensors on a card.

Direction strata (mesh scenes whose 1024-lane tiles tile a P x P grid,
P = 32 or 16): the lanes of tile `lane // 1024` draw their cosine-
hemisphere direction inside cell ((tile * 131 + int(params[0])) % P^2) of
the unit square, so a tile traces a narrow beam.  `params[0]` is the JAX
package's seed slot, float32(seed * 1_000_003 % 2^30), written per call.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _nvcc
from .._device import resolve_device
from ..bsdf.tables import DIFFUSE
from ..core.rng import MASK32, philox4x32_10
from ..geometry import bvh as bvh_mod
from ..geometry.bvh_kernel import PackedBVH, walk_ref, leaf_column, pack
from ..geometry.shapes import RECTANGLE, TRIANGLE
from ..radar.endpoints import ADCConfig, OMNI, WIGNER
from ..radar.waveform import CW, LINFMCW

MAX_PRIMS = 64          # prim rows held in shared memory
MAX_N_TIME = 512        # per-thread shared-memory histograms (see the .cu)
MAX_MEDIA_LAYERS = 32   # params layout: 45 + MAX_MEDIA_LAYERS slots
MAX_MESH_SHAPES = 64    # distinct mesh-shape rows (the JAX package's cap)
MESH_STRIDE = 96        # leaf rows: 80 + reflectance + shape-row payloads
# the BVH tables live in device memory and are indexed with int32: a leaf
# row's last float, leaf * 96 + 95, must stay below 2^31
MAX_MESH_TRIS = 8 * ((2 ** 31 - 1) // MESH_STRIDE)
TILE = 1024             # lanes per stratification tile (8 x 128 on the TPU)
PRIM_COLS = 34
TXP_COLS = 32

TWO_PI = 6.283185307179586
HALF_PI_F32 = 0.5 * float(np.float32(np.pi))


# ---------------------------------------------------------------------------
# scene pack (numpy only; bit-identical with the JAX package's _pack_scene
# on the scenes `supported` admits)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedScene:
    params: np.ndarray   # (77,) f32 scalars; [0] is the seed slot
    prim: np.ndarray     # (n_prims, 34) f32 prim rows
    txp: np.ndarray      # (n_tx, 32) f32 transmitter rows
    php: np.ndarray      # (n_tx, 2 + 6K) phased pair rows (zeros here)
    rxph: np.ndarray     # (1, 8) phased receiver row (zeros here)
    msh: np.ndarray      # (n_mesh_shapes, 8) f32 mesh-shape rows
    mesh: PackedBVH | None = None   # BVH over the mesh triangles (CPU)


def _demoted_rects(sd) -> list:
    """Shape rows of the plain rectangles moved into the triangle BVH when
    the analytic prim table would overflow MAX_PRIMS (two exact world-space
    triangles each).  Transmitter shapes, bsdf-less blockers (the receiver
    rectangle) and textured rectangles stay analytic."""
    kind_np = sd.shapes.kind.cpu().numpy()
    if int((kind_np == RECTANGLE).sum()) <= MAX_PRIMS:
        return []
    bsdf_idx = sd.shapes.bsdf_idx.cpu().numpy()
    tex_idx = sd.bsdfs.texture_idx.cpu().numpy()
    tx_shapes = set()
    if sd.transmitters is not None:
        tx_shapes = {int(x) for x in sd.transmitters.shape_idx.tolist()}
    return [i for i in range(len(kind_np))
            if int(kind_np[i]) == RECTANGLE and i not in tx_shapes
            and int(bsdf_idx[i]) >= 0 and int(tex_idx[bsdf_idx[i]]) < 0]


def _mesh_shape_rows(sd, mesh_shape_ids):
    """Deduplicated mesh-shape rows [vel(3), alpha, eta, k, type, 0]:
    shapes sharing them collapse to one row.  Returns (rows, row_of) with
    row_of: shape row -> mesh-shape row."""
    bsdf_idx = sd.shapes.bsdf_idx.cpu().numpy()
    shape_vel = sd.shapes.velocity.cpu().numpy()
    b_type = sd.bsdfs.type.cpu().numpy()
    b_alpha = sd.bsdfs.alpha.cpu().numpy()
    b_eta = sd.bsdfs.eta.cpu().numpy()
    b_k = sd.bsdfs.k.cpu().numpy()
    rows, key_of, row_of = [], {}, {}
    for s_i in sorted(mesh_shape_ids):
        bi = int(bsdf_idx[s_i])
        key = (float(shape_vel[s_i][0]), float(shape_vel[s_i][1]),
               float(shape_vel[s_i][2]),
               float(b_alpha[bi]) if bi >= 0 else 0.1,
               float(b_eta[bi, 0]) if bi >= 0 else 0.0,
               float(b_k[bi, 0]) if bi >= 0 else 0.0,
               float(b_type[bi]) if bi >= 0 else 0.0)
        if key not in key_of:
            key_of[key] = len(rows)
            rows.append(list(key) + [0.0])
        row_of[s_i] = key_of[key]
    return rows, row_of


def _mesh_faces(sd, demote):
    """(v0, e1, e2, shape row) of every triangle the BVH holds: the mesh
    faces, then two per demoted rectangle."""
    v0_a, e1_a, e2_a, sidx_a = [], [], [], []
    if sd.tris is not None:
        v0_a.append(sd.tris.v0.cpu().numpy())
        e1_a.append(sd.tris.e1.cpu().numpy())
        e2_a.append(sd.tris.e2.cpu().numpy())
        sidx_a.append(sd.tris.shape_idx.cpu().numpy())
    if demote:
        tw = sd.shapes.to_world.cpu().numpy()
        dv0, de1, de2, dsx = [], [], [], []
        for i in demote:
            m = tw[i]

            def corner(x, y, m=m):
                return m[:3, :3] @ np.array([x, y, 0.0]) + m[:3, 3]

            w00, w10 = corner(-1, -1), corner(1, -1)
            w01, w11 = corner(-1, 1), corner(1, 1)
            dv0 += [w00, w11]
            de1 += [w10 - w00, w01 - w11]
            de2 += [w01 - w00, w10 - w11]
            dsx += [i, i]
        v0_a.append(np.asarray(dv0, np.float32))
        e1_a.append(np.asarray(de1, np.float32))
        e2_a.append(np.asarray(de2, np.float32))
        sidx_a.append(np.asarray(dsx, np.int64))
    return (np.concatenate(v0_a), np.concatenate(e1_a), np.concatenate(e2_a),
            np.concatenate(sidx_a))


def pack_scene(scene_data, rx, shape_idx: int) -> PackedScene:
    """Flatten scene + receiver into the kernel's tables."""
    sd = scene_data
    shapes = sd.shapes
    kind_np = shapes.kind.cpu().numpy()
    n = int(kind_np.shape[0])
    demote = _demoted_rects(sd)
    keep = [i for i in range(n) if i not in set(demote)]
    to_obj = shapes.to_object.cpu().numpy()
    to_world = shapes.to_world.cpu().numpy()
    bsdf_idx = shapes.bsdf_idx.cpu().numpy()
    refl = sd.bsdfs.reflectance.cpu().numpy()
    b_type = sd.bsdfs.type.cpu().numpy()
    b_alpha = sd.bsdfs.alpha.cpu().numpy()
    b_eta = sd.bsdfs.eta.cpu().numpy()
    b_k = sd.bsdfs.k.cpu().numpy()
    shape_vel = shapes.velocity.cpu().numpy()

    tx = sd.transmitters
    tx_shapes = tx.shape_idx.cpu().numpy()
    shape_tx = {int(s): t for t, s in enumerate(tx_shapes)}

    prim = np.zeros((len(keep), PRIM_COLS), np.float32)
    for r, i in enumerate(keep):
        prim[r, 0] = kind_np[i]
        prim[r, 1:13] = to_obj[i, :3, :].reshape(-1)
        b = int(bsdf_idx[i])
        # the rx shape keeps refl = 0: it blocks rays and never scatters
        prim[r, 13] = refl[b, 0] if b >= 0 else 0.0
        prim[r, 14] = float(shape_tx.get(i, -1))
        prim[r, 15] = b_alpha[b] if b >= 0 else 0.1
        prim[r, 16] = b_eta[b, 0] if b >= 0 else 0.0
        prim[r, 17] = b_k[b, 0] if b >= 0 else 0.0
        prim[r, 18] = float(b_type[b]) if b >= 0 else 0.0
        # second-lobe columns of blend/mask composites: a plain lobe here
        prim[r, 28] = prim[r, 18]
        prim[r, 29] = prim[r, 13]
        prim[r, 30:33] = prim[r, 15:18]
        prim[r, 33] = 1.0
        prim[r, 19:22] = shape_vel[i]

    # per-tx rows; the phase pivots are computed in float64 on the host
    fc_ref = 0.5 * (sd.band.freq_min + sd.band.freq_max)
    n_tx = tx.n
    txp = np.zeros((n_tx, TXP_COLS), np.float32)
    tx_vel = tx.velocity.cpu().numpy()
    wf = {f: getattr(tx.wf, f).cpu().numpy().reshape(-1)
          for f in ('kind', 'amplitude', 'rep_freq', 't_ext', 'f_centre',
                    'f_ext', 'phi0')}
    gain = tx.gain.cpu().numpy().reshape(-1)
    tx_kind = tx.kind.cpu().numpy().reshape(-1)
    area = shapes.surface_area.cpu().numpy()
    for t in range(n_tx):
        ts = int(tx_shapes[t])
        m = to_world[ts][:3, :]
        txp[t, 0:12] = m.reshape(-1)
        txp[t, 12] = float(np.linalg.norm(m[:, 0]))
        txp[t, 13] = float(np.linalg.norm(m[:, 1]))
        txp[t, 14] = float(area[ts])
        txp[t, 15] = float(gain[t])
        txp[t, 16] = float(wf['kind'][t])
        txp[t, 17] = float(wf['amplitude'][t])
        txp[t, 18] = float(wf['rep_freq'][t])
        txp[t, 19] = float(wf['t_ext'][t])
        txp[t, 20] = float(wf['f_centre'][t])
        txp[t, 21] = float(wf['f_ext'][t])
        pri_f32 = np.float32(1.0 / max(np.float32(txp[t, 18]),
                                       np.float32(1e-12)))
        txp[t, 22] = np.float32(np.float64(fc_ref) * np.float64(pri_f32)
                                % 1.0)
        txp[t, 23] = np.float32(np.float64(txp[t, 20]) - np.float64(fc_ref))
        txp[t, 24:27] = tx_vel[t]
        txp[t, 27] = float(tx_kind[t])
        txp[t, 28] = float(wf['phi0'][t])

    K = int(tx.pair_mask.shape[1])
    php = np.zeros((n_tx, 2 + 6 * K), np.float32)
    e_wid = tx.elem_wid.cpu().numpy()
    for t in range(n_tx):
        php[t, 0], php[t, 1] = e_wid[t, 0], e_wid[t, 1]

    if shape_idx >= 0:
        rxm = to_world[shape_idx][:3, :].reshape(-1)
        rx_wx = float(np.linalg.norm(to_world[shape_idx][:3, 0]))
        rx_wy = float(np.linalg.norm(to_world[shape_idx][:3, 1]))
    else:
        rxm = np.asarray(rx.to_world)[:3, :].astype(np.float32).reshape(-1)
        rx_wx = rx_wy = 0.0
    rxph = np.zeros((1, 8), np.float32)

    params = np.zeros(45 + MAX_MEDIA_LAYERS, np.float32)
    params[0] = 0.0   # seed slot (set per call)
    params[1] = sd.band.c
    params[2:14] = rxm
    params[14], params[15] = rx_wx, rx_wy
    params[16] = sd.band.boundary_phase
    # fc_ref / c as a double-single split (coherent echo-phase pivot)
    fcc = np.float64(fc_ref) / np.float64(sd.band.c)
    params[17] = np.float32(fcc)
    params[18] = np.float32(fcc - np.float64(np.float32(fcc)))
    params[23:26] = np.asarray(rx.velocity, np.float32).reshape(3)
    params[32] = float(getattr(rx, 'gain', 1.0))

    # meshes (and demoted rectangles): the aligned BVH, per-face
    # reflectance at leaf column 80, the owning shape's mesh-shape row at 88
    mesh = None
    msh = np.zeros((1, 8), np.float32)
    if sd.tris is not None or demote:
        v0, e1, e2, sidx = _mesh_faces(sd, demote)
        b = bvh_mod.build(v0, e1, e2, align=True)
        b_of = bsdf_idx[sidx]
        payload = np.where(b_of >= 0, refl[np.maximum(b_of, 0), 0], 0.0)
        rows, row_of = _mesh_shape_rows(sd, set(int(x) for x in sidx))
        payload2 = np.asarray([row_of[int(x)] for x in sidx], np.float32)
        mesh = pack(b, payload=np.asarray(payload, np.float32),
                    payload2=payload2)
        msh = np.asarray(rows, np.float32)
    return PackedScene(params=params, prim=prim, txp=txp, php=php,
                       rxph=rxph, msh=msh, mesh=mesh)


# ---------------------------------------------------------------------------
# scope
# ---------------------------------------------------------------------------


def supported(scene_data, rx, reason: list | None = None) -> bool:
    """Can the port's kernel run this scene?  Appends the first rejection
    reason, with the ROADMAP item that lifts it, to `reason`."""

    def no(why: str) -> bool:
        if reason is not None:
            reason.append(why)
        return False

    sd = scene_data
    tx = sd.transmitters
    if tx is None or tx.n != 1:
        return no('the kernel takes exactly one transmitter (ROADMAP B6)')
    if int(tx.kind[0]) != WIGNER:
        return no('non-Wigner transmitter (ROADMAP B6)')
    if not bool(tx.resample.all()):
        return no('non-delta-resampled transmitter (ROADMAP B6)')
    if int(tx.shape_idx[0]) < 0:
        return no('free-standing transmitter: the kernel samples its '
                  'rectangle (ROADMAP B6)')
    kinds = set(sd.shapes.kind.tolist())
    if not kinds <= {-1, RECTANGLE, TRIANGLE}:
        return no(f'shape kinds {sorted(kinds)}: rectangles and triangle '
                  'meshes only (ROADMAP B5)')
    demote = _demoted_rects(sd)
    n_prims = int(sd.shapes.kind.shape[0]) - len(demote)
    if n_prims > MAX_PRIMS:
        return no(f'{n_prims} analytic shape rows > {MAX_PRIMS} after '
                  'demoting plain rectangles into the BVH (shared-memory '
                  'prim table; ROADMAP B5)')
    if sd.tris is not None or demote:
        n_tris = (sd.tris.n_faces if sd.tris is not None else 0) \
            + 2 * len(demote)
        if n_tris > MAX_MESH_TRIS:
            return no(f'{n_tris} mesh triangles > {MAX_MESH_TRIS} (int32 '
                      'indices into the BVH leaf table)')
        sidx = (sd.tris.shape_idx.tolist() if sd.tris is not None else [])
        if any(int(sd.shapes.bsdf_idx[i]) < 0 for i in set(sidx)):
            return no('mesh shape without a BSDF')
        rows, _ = _mesh_shape_rows(sd, set(sidx) | set(demote))
        if len(rows) > MAX_MESH_SHAPES:
            return no(f'{len(rows)} distinct mesh-shape rows > '
                      f'{MAX_MESH_SHAPES} (per-shape resolution)')
    if not set(sd.bsdfs.present) <= {DIFFUSE}:
        return no('BSDFs beyond diffuse, on meshes as on rectangles '
                  '(ROADMAP B5)')
    if bool((sd.bsdfs.texture_idx >= 0).any()):
        return no('textured BSDFs (ROADMAP B7)')
    if bool((sd.shapes.velocity != 0).any()) \
            or bool((tx.velocity != 0).any()) \
            or bool(np.any(np.asarray(rx.velocity) != 0)):
        return no('moving scene or mesh: the Doppler chain is ROADMAP B7')
    if rx.kind not in (WIGNER, OMNI):
        return no(f'receiver kind {rx.kind} (ROADMAP B6)')
    if rx.receive_type != 'raw' or rx.lo_waveform is not None:
        return no(f'receive_type {rx.receive_type!r} / LO (ROADMAP B3)')
    if rx.adc.n_freq != 1:
        return no('n_freq > 1: the 2-D splat is ROADMAP B2')
    if rx.adc.n_time > MAX_N_TIME:
        return no(f'n_time {rx.adc.n_time} > {MAX_N_TIME} (per-thread '
                  'shared histograms; the wide splat is ROADMAP B2)')
    return True


def n_draws(max_depth: int) -> int:
    """Uniform rows per lane (the layout stride of injected uniforms): the
    JAX package's count for one transmitter and plain diffuse lobes."""
    return 8 + 6 * max_depth


# ---------------------------------------------------------------------------
# the kernel's generator, drawn on the host
# ---------------------------------------------------------------------------


def philox_uniforms(seed: int, n_rows: int, n_lanes: int, device='cpu',
                    lane0: int = 0) -> torch.Tensor:
    """(n_rows, n_lanes) float32 uniforms in [0, 1) of lanes lane0 ..
    lane0 + n_lanes - 1, exactly as the kernel draws them: Philox4x32-10
    keyed by the 64-bit seed, counter (lane, row // 4), word row % 4, top
    24 bits scaled by 2^-24."""
    lane = torch.arange(lane0, lane0 + n_lanes, dtype=torch.int64,
                        device=device)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    rows = []
    for g in range((n_rows + 3) // 4):
        rows.extend(philox4x32_10(lane & MASK32, lane >> 32,
                                  torch.full_like(lane, g),
                                  torch.zeros_like(lane), k0, k1))
    u = torch.stack(rows[:n_rows]) >> 8
    return u.to(torch.float32) * (1.0 / float(1 << 24))


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _fast_sin(x):
    """Cycle reduction + smoothed parabola (rounding half to even)."""
    t = x * (1.0 / TWO_PI)
    t = t - torch.round(t)
    s = 16.0 * t * (0.5 - t.abs())
    return s * (0.775 + 0.225 * s.abs())


def _fast_cos(x):
    return _fast_sin(x + HALF_PI_F32)


def _sinc(x):
    big = x.abs() > 1e-8
    safe = torch.where(big, x, 1.0)
    return torch.where(big, _fast_sin(safe) / safe, 1.0)


def _tri(x):
    ax = x.abs()
    return torch.where(ax < 0.5, 1.0 - 2.0 * ax, 0.0)


def _mod(a, b):
    """Floored modulo built on fmod (the JAX package's jnp.mod)."""
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


def _sign(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def receive_megakernel_ref(params, prim, txp, uniforms, *, adc: ADCConfig,
                           max_depth: int, time_sampling: str, rx_kind: str,
                           mesh: PackedBVH | None = None, patch_p: int = 0,
                           lane0: int = 0, stats: dict | None = None,
                           lane_out=None):
    """Plain version of the kernel.  Returns (acc (n_time,) float32,
    n_events 0-d int64): the tent-splatted power and the count of nonzero
    contributions.

    `mesh`: the BVH tables of a mesh scene (stride 96; `pack_scene`), on
    the uniforms' device.  `patch_p` > 0 stratifies the Wigner receive
    directions over patch_p^2 cells per 1024-lane tile; the first lane is
    lane `lane0` of the call (tiles count from lane 0).  `lane_out`, if
    given, receives each lane's contribution sum (n_lanes,) float32.

    `stats`, if given, accumulates how many lanes reach each stage of the
    kernel (the work a run's data needs): keys 'lanes', 'strata' (lanes
    with stratified directions), 'trace', 'hit', 'direct', 'nee_geom',
    'nee', 'occ_tests', 'nee_splat', 'bounce', each summed over depths;
    with a mesh also 'walks', 'node_tests', 'leaf_tests' (BVH walks, slab
    tests, leaves entered) and 'mesh_hits' (closest hits on a triangle)."""
    counts = {k: 0 for k in ('lanes', 'strata', 'trace', 'hit', 'direct',
                             'nee_geom', 'nee', 'occ_tests', 'nee_splat',
                             'bounce', 'walks', 'node_tests', 'leaf_tests',
                             'mesh_hits')}

    def count(key, mask):
        if stats is not None:
            counts[key] += int(mask.sum())
    dev = uniforms.device
    n_lanes = int(uniforms.shape[1])
    gate = time_sampling == 'gate'
    n_time = adc.n_time

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    t_start, t_window = c(adc.sampling_start), c(adc.sampling_time)
    n_time_f = c(float(n_time))
    rows = iter(uniforms)

    def draw():
        return next(rows)

    sp = params
    cvel = sp[1]
    rxm = [sp[2 + i] for i in range(12)]
    rx_wx, rx_wy = sp[14], sp[15]
    tr = txp[0]
    m = [tr[i] for i in range(12)]
    wx, wy, area_tx, gain = tr[12], tr[13], tr[14], tr[15]
    wf, amp, prf, text, fc, fext = tr[16], tr[17], tr[18], tr[19], tr[20], \
        tr[21]
    prims = [prim[p] for p in range(prim.shape[0])
             if int(prim[p, 0]) == RECTANGLE]
    # the transmitter's own rectangle (transmitter index 0 in column 14)
    # never occludes its NEE; other geometry does
    blockers = [row for row in prims if float(row[14]) != 0.0]

    def inst_freq(t):
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        tm = _mod(t, pri)
        ti = 0.5 * text
        fi = fc + (fext / torch.clamp(text, min=1e-12)) * (tm - ti)
        return torch.where(wf == LINFMCW, fi, fc)

    def eval_wdf(t, f):
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        tm = _mod(t, pri)
        ti = 0.5 * text
        fi = inst_freq(t)
        x = (tm - ti) / torch.clamp(text, min=1e-12)
        tw = _tri(x)
        w = 2.0 * amp * amp * text * tw * _sinc(TWO_PI * (f - fi) * text * tw)
        w = torch.where(x.abs() < 0.5, w, 0.0)
        return torch.where(wf == CW, amp * amp, w)

    def emission(tau, u, t_rx0):
        """(t_emit, t_recv, gate weight) of a path of delay `tau`."""
        if not gate:
            return t_rx0 - tau, t_rx0, 1.0
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        is_cw = wf == CW
        sup = torch.where(is_cw, t_window, text)
        t_emit = torch.where(is_cw, t_start - tau, 0.0) + u * sup
        t_recv = tau + t_emit
        k = torch.ceil((t_start - t_recv) * prf)
        k = torch.where(is_cw, 0.0, torch.clamp(k, min=0.0))
        return t_emit, t_recv + k * pri, sup / t_window

    def tx_aperture(lx, ly, ex, ey, ez, lam):
        """Rect-aperture Wigner weight at local (lx, ly) in [-1, 1]^2 for
        radiation leaving along (ex, ey, ez)."""
        nu_x = -(m[0] * ex + m[4] * ey + m[8] * ez) \
            / torch.clamp(wx, min=1e-9) / lam
        nu_y = -(m[1] * ex + m[5] * ey + m[9] * ez) \
            / torch.clamp(wy, min=1e-9) / lam
        t_x, t_y = _tri(lx * 0.5), _tri(ly * 0.5)
        return 4.0 * t_x * t_y * _sinc(TWO_PI * nu_x * wx * t_x) \
            * _sinc(TWO_PI * nu_y * wy * t_y)

    # ---------------- receive-ray generation ----------------
    if gate:
        draw()   # keep the draw schedule aligned between modes
        t_rx0 = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    else:
        t_rx0 = t_start + draw() * t_window
    f_rx = c(0.5 * (adc.freq_lo + adc.freq_hi))
    if rx_kind == 'omni':
        ox = rxm[3].expand(n_lanes)
        oy = rxm[7].expand(n_lanes)
        oz = rxm[11].expand(n_lanes)
        u1, u2 = draw(), draw()
        z = 1.0 - 2.0 * u1
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        ph = TWO_PI * u2
        dx, dy, dz = r * _fast_cos(ph), r * _fast_sin(ph), z
        w0 = c(4.0 * np.pi) * sp[32]
        throughput = w0.expand(n_lanes)
    else:
        u1, u2 = draw(), draw()
        lx, ly = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
        ox = rxm[0] * lx + rxm[1] * ly + rxm[3]
        oy = rxm[4] * lx + rxm[5] * ly + rxm[7]
        oz = rxm[8] * lx + rxm[9] * ly + rxm[11]
        nzx, nzy, nzz = rxm[2], rxm[6], rxm[10]
        nn = torch.rsqrt(nzx * nzx + nzy * nzy + nzz * nzz)
        nzx, nzy, nzz = nzx * nn, nzy * nn, nzz * nn
        u3, u4 = draw(), draw()
        area = 4.0 * rx_wx * rx_wy
        if patch_p:
            # stratified cosine hemisphere: the tile's cell plus the lane's
            # jitter; cos pdf, weight pi * area
            counts['strata'] += n_lanes
            tile = torch.arange(lane0, lane0 + n_lanes, device=dev) // TILE
            patch = (tile * 131 + int(sp[0])) % (patch_p * patch_p)
            u3 = ((patch % patch_p).float() + u3) * (1.0 / patch_p)
            u4 = ((patch // patch_p).float() + u4) * (1.0 / patch_p)
            rr = torch.sqrt(u3)
            ph = TWO_PI * u4
            tx_, ty_ = rr * _fast_cos(ph), rr * _fast_sin(ph)
            tz_ = torch.sqrt(torch.clamp(1.0 - u3, min=0.0))
            w0 = (c(np.pi) * area).expand(n_lanes) * sp[32]
        else:
            lam0 = cvel / torch.clamp(f_rx, min=1e-6)
            w_mn = torch.minimum(rx_wx, rx_wy)
            q = 2.0 * w_mn / (0.6 * lam0)
            k_l = torch.clamp(2.0 * (q * q) - 2.0, min=0.0)
            pick = u3 >= 0.5
            u0m = torch.where(pick, 2.0 * u3 - 1.0, 2.0 * u3)
            ph = TWO_PI * u4
            ct_c = torch.sqrt(torch.clamp(1.0 - u0m, min=0.0))
            ct_l = torch.exp(torch.log(torch.clamp(u0m, min=1e-12))
                             / (k_l + 1.0))
            tz_ = torch.where(pick, ct_l, ct_c)
            st = torch.sqrt(torch.clamp(1.0 - tz_ * tz_, min=0.0))
            tx_, ty_ = st * _fast_cos(ph), st * _fast_sin(ph)
            cosk = torch.exp(k_l * torch.log(torch.clamp(tz_, min=1e-12)))
            pdf_d = (0.5 * tz_ * (1.0 / np.pi)
                     + 0.5 * (k_l + 1.0) * (1.0 / TWO_PI) * cosk)
            w0 = (tz_ / torch.clamp(pdf_d, min=1e-30)) * area * sp[32]
        sign = _sign(nzz)
        a = -1.0 / (sign + nzz)
        b = nzx * nzy * a
        s1x, s1y, s1z = 1.0 + sign * nzx * nzx * a, sign * b, -sign * nzx
        s2x, s2y, s2z = b, sign + nzy * nzy * a, -nzy
        dx = s1x * tx_ + s2x * ty_ + nzx * tz_
        dy = s1y * tx_ + s2y * ty_ + nzy * tz_
        dz = s1z * tx_ + s2z * ty_ + nzz * tz_
        lam = cvel / torch.clamp(f_rx, min=1e-6)
        nu_x = (rxm[0] * dx + rxm[4] * dy + rxm[8] * dz) \
            / torch.clamp(rx_wx, min=1e-9) / lam
        nu_y = (rxm[1] * dx + rxm[5] * dy + rxm[9] * dz) \
            / torch.clamp(rx_wy, min=1e-9) / lam
        trx, try_ = _tri(lx * 0.5), _tri(ly * 0.5)
        throughput = w0 * (4.0 * trx * try_
                           * _sinc(TWO_PI * nu_x * rx_wx * trx)
                           * _sinc(TWO_PI * nu_y * rx_wy * try_))
        ox = ox + 1e-4 * nzx
        oy = oy + 1e-4 * nzy
        oz = oz + 1e-4 * nzz

    # transmitter normal (to_world column 2, normalized)
    tnn = torch.rsqrt(torch.clamp(m[2] * m[2] + m[6] * m[6] + m[10] * m[10],
                                  min=1e-20))
    tnx, tny, tnz = m[2] * tnn, m[6] * tnn, m[10] * tnn

    # float64 sums: the plain version is the accurate side of the
    # comparison (each contribution is still computed in float32)
    acc = torch.zeros(n_time, dtype=torch.float64, device=dev)
    n_events = torch.zeros((), dtype=torch.int64, device=dev)

    lane_sum = torch.zeros(n_lanes, dtype=torch.float32, device=dev)

    def splat(val, yb, ok):
        nonlocal n_events, lane_sum
        n_events = n_events + (ok & (val != 0.0)).sum()
        lane_sum = lane_sum + val
        b0 = torch.floor(yb)
        for b in (b0, b0 + 1.0):
            w = torch.clamp(1.0 - (yb - b).abs(), min=0.0)
            keep = (val != 0.0) & (b >= 0.0) & (b < n_time_f)
            idx = torch.clamp(b, 0.0, n_time - 1.0).long()
            acc.index_add_(0, idx[keep], (val * w)[keep].double())

    def rect_t(p_row, cx, cy, cz, ddx, ddy, ddz):
        q = [p_row[1 + i] for i in range(12)]
        oox = q[0] * cx + q[1] * cy + q[2] * cz + q[3]
        ooy = q[4] * cx + q[5] * cy + q[6] * cz + q[7]
        ooz = q[8] * cx + q[9] * cy + q[10] * cz + q[11]
        odx = q[0] * ddx + q[1] * ddy + q[2] * ddz
        ody = q[4] * ddx + q[5] * ddy + q[6] * ddz
        odz = q[8] * ddx + q[9] * ddy + q[10] * ddz
        big = odz.abs() > 1e-12
        t_p = -ooz / torch.where(big, odz, 1e-12)
        px = oox + t_p * odx
        py = ooy + t_p * ody
        return t_p, big & (px.abs() <= 1.0) & (py.abs() <= 1.0), q

    cx, cy, cz = ox, oy, oz
    ddx, ddy, ddz = dx, dy, dz
    active = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    plen = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    count('lanes', active)
    for depth in range(max_depth):
        # ---- closest hit over the rectangles ----
        count('trace', active)
        tb = torch.full((n_lanes,), 3.4e38, dtype=torch.float32, device=dev)
        nx = torch.zeros_like(tb)
        ny = torch.zeros_like(tb)
        nz = torch.zeros_like(tb)
        rb = torch.zeros_like(tb)
        txc = torch.full_like(tb, -1.0)
        for row in prims:
            t_p, hit_p, q = rect_t(row, cx, cy, cz, ddx, ddy, ddz)
            rnorm = torch.rsqrt(torch.clamp(
                q[8] * q[8] + q[9] * q[9] + q[10] * q[10], min=1e-20))
            closer = hit_p & (t_p > 1e-4) & (t_p < tb)
            tb = torch.where(closer, t_p, tb)
            nx = torch.where(closer, q[8] * rnorm, nx)
            ny = torch.where(closer, q[9] * rnorm, ny)
            nz = torch.where(closer, q[10] * rnorm, nz)
            rb = torch.where(closer, row[13], rb)
            txc = torch.where(closer, row[14], txc)
        if mesh is not None:
            # mesh closest hit, pruned by the analytic best; the geometric
            # normal from the winner's edges, its reflectance from the leaf
            walk = active.nonzero().squeeze(1)
            w = walk_ref(mesh, cx[walk], cy[walk], cz[walk], ddx[walk],
                         ddy[walk], ddz[walk], tb[walk], anyhit=False,
                         stats=counts if stats is not None else None)
            e1x, e1y, e1z, e2x, e2y, e2z = (
                leaf_column(mesh, w.leaf, w.slot, col)
                for col in (24, 32, 40, 48, 56, 64))
            gnx = e1y * e2z - e1z * e2y
            gny = e1z * e2x - e1x * e2z
            gnz = e1x * e2y - e1y * e2x
            rn = torch.rsqrt(torch.clamp(gnx * gnx + gny * gny + gnz * gnz,
                                         min=1e-20))
            m_closer = w.t < tb[walk]
            count('mesh_hits', m_closer)
            sel = walk[m_closer]
            tb[sel] = w.t[m_closer]
            nx[sel] = (gnx * rn)[m_closer]
            ny[sel] = (gny * rn)[m_closer]
            nz[sel] = (gnz * rn)[m_closer]
            rb[sel] = leaf_column(mesh, w.leaf, w.slot, 80)[m_closer]
            txc[sel] = -1.0
        hit = tb < 3.4e37
        active = active & hit
        count('hit', active)
        tb = torch.where(hit, tb, 1.0)   # misses: keep dead lanes finite
        plen = plen + torch.where(active, tb, 0.0)
        hx = cx + tb * ddx
        hy = cy + tb * ddy
        hz = cz + tb * ddz

        # ---- direct transmitter hits (depth 0; NEE covers the rest) ----
        u_dh = draw()
        if depth == 0:
            cos_dh = -(ddx * tnx + ddy * tny + ddz * tnz)
            te_h, tr_h, wg_h = emission(plen / cvel, u_dh, t_rx0)
            fe_h = inst_freq(te_h)
            sig_h = eval_wdf(te_h, fe_h)
            lam_h = cvel / torch.clamp(fe_h, min=1e-6)
            lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                   + (hz - m[11]) * m[8]) / torch.clamp(wx * wx, min=1e-12)
            lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                   + (hz - m[11]) * m[9]) / torch.clamp(wy * wy, min=1e-12)
            ap_h = tx_aperture(lxh, lyh, ddx, ddy, ddz, lam_h)
            w_dh = sig_h * gain * ap_h * TWO_PI
            ok_h = active & (txc == 0.0) & (cos_dh > 0.0)
            count('direct', ok_h)
            val_h = torch.where(ok_h, throughput * w_dh * wg_h, 0.0)
            yb_h = (tr_h - t_start) / t_window * n_time_f - 0.5
            splat(val_h, yb_h, ok_h)

        # ---- NEE to the transmitter ----
        u5, u6 = draw(), draw()
        glx, gly = 2.0 * u5 - 1.0, 2.0 * u6 - 1.0
        qx = m[0] * glx + m[1] * gly + m[3]
        qy = m[4] * glx + m[5] * gly + m[7]
        qz = m[8] * glx + m[9] * gly + m[11]
        vx, vy, vz = qx - hx, qy - hy, qz - hz
        dist2 = vx * vx + vy * vy + vz * vz
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        inv_d = 1.0 / dist
        wx_, wy_, wz_ = vx * inv_d, vy * inv_d, vz * inv_d
        cos_tx = -(wx_ * tnx + wy_ * tny + wz_ * tnz)
        shade = active & (txc < 0.0)
        count('nee_geom', shade)
        shade = shade & (cos_tx > 1e-6)
        count('nee', shade)
        pdf_sa = torch.where(
            cos_tx > 1e-6,
            (1.0 / torch.clamp(area_tx, min=1e-12)) * dist2
            / torch.clamp(cos_tx, min=1e-6), 0.0)
        cos_s = wx_ * nx + wy_ * ny + wz_ * nz
        # diffuse f * cos toward the transmitter (wi = toward the receiver)
        sg = _sign(-ddx * nx + -ddy * ny + -ddz * nz)
        co = wx_ * (nx * sg) + wy_ * (ny * sg) + wz_ * (nz * sg)
        f_cos = rb * (1.0 / np.pi) * torch.clamp(co, min=0.0)
        u7 = draw()
        t_emit, t_recv, w_gate = emission((plen + dist) / cvel, u7, t_rx0)
        f_emit = inst_freq(t_emit)
        sig = eval_wdf(t_emit, f_emit)
        ap = tx_aperture(glx, gly, wx_, wy_, wz_,
                         cvel / torch.clamp(f_emit, min=1e-6))
        w_tx = sig * gain * ap * TWO_PI
        off = 1e-4 * torch.sign(cos_s)
        sx, sy, sz = hx + off * nx, hy + off * ny, hz + off * nz
        occ = torch.zeros_like(active)
        limit = dist * 0.999
        for row in blockers:
            count('occ_tests', shade & ~occ)
            t_p, hit_p, _ = rect_t(row, sx, sy, sz, wx_, wy_, wz_)
            occ = occ | (hit_p & (t_p > 1e-4) & (t_p < limit))
        if mesh is not None:
            # mesh any hit for the lanes the rectangles left unblocked
            walk = (shade & ~occ).nonzero().squeeze(1)
            w = walk_ref(mesh, sx[walk], sy[walk], sz[walk], wx_[walk],
                         wy_[walk], wz_[walk], limit[walk], anyhit=True,
                         stats=counts if stats is not None else None)
            occ[walk] = w.occ
        ok = active & ~occ & (pdf_sa > 0.0) & (cos_tx > 1e-6) & (txc < 0.0)
        count('nee_splat', ok)
        val = torch.where(ok, throughput * f_cos * w_tx * w_gate
                          / torch.clamp(pdf_sa, min=1e-30), 0.0)
        yb = (t_recv - t_start) / t_window * n_time_f - 0.5
        splat(val, yb, ok)

        if depth == max_depth - 1:
            break

        # ---- diffuse bounce: cosine hemisphere about the flipped normal ----
        u8, u9 = draw(), draw()
        count('bounce', active & (rb > 0.0) & (txc < 0.0))
        face = -(ddx * nx + ddy * ny + ddz * nz)
        sgn = _sign(face)
        fx, fy, fz = nx * sgn, ny * sgn, nz * sgn
        sign = _sign(fz)
        a2 = -1.0 / (sign + fz)
        b2 = fx * fy * a2
        s1x, s1y, s1z = 1.0 + sign * fx * fx * a2, sign * b2, -sign * fx
        s2x, s2y, s2z = b2, sign + fy * fy * a2, -fy
        rr2 = torch.sqrt(u8)
        ph2 = TWO_PI * u9
        bx_, by_ = rr2 * _fast_cos(ph2), rr2 * _fast_sin(ph2)
        bz_ = torch.sqrt(torch.clamp(1.0 - u8, min=0.0))
        ddx = s1x * bx_ + s2x * by_ + fx * bz_
        ddy = s1y * bx_ + s2y * by_ + fy * bz_
        ddz = s1z * bx_ + s2z * by_ + fz * bz_
        throughput = throughput * rb
        active = active & (rb > 0.0) & (txc < 0.0)
        cx = hx + 1e-4 * fx
        cy = hy + 1e-4 * fy
        cz = hz + 1e-4 * fz
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v
    if lane_out is not None:
        lane_out.copy_(lane_sum)
    return acc.float(), n_events


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------


def _bind(lib):
    vp, i32, i64, u64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_ulonglong,
                              ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rk_geometry.argtypes = [i32, i64, i32, i32, i32, ip, ip, ip]
    lib.rk_geometry.restype = i32
    lib.rk_launch.argtypes = [vp] * 11 + [
        i32, i32, vp, i64, u64, i32, i32, i32, i32, i32, i32, f32, f32, f32,
        i32, i32, i32, vp]
    lib.rk_launch.restype = i32


LIBRARY = _nvcc.Library('receive_megakernel', 'rk', _bind)


def build_library() -> _nvcc.BuildInfo:
    return _nvcc.build('receive_megakernel')


def launch_geometry(n_time: int, n_lanes: int, n_prims: int,
                    n_params: int = 45 + MAX_MEDIA_LAYERS,
                    mesh: bool = False):
    """(blocks, threads per block, dynamic shared bytes) of the trace
    kernel (its mesh configuration if `mesh`) on the current card: a
    persistent grid of as many blocks as fit on every SM at once, fewer
    when the lanes run out."""
    lib = LIBRARY.get()
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    LIBRARY.check(lib.rk_geometry(n_time, n_lanes, n_prims, n_params,
                                  int(mesh), ctypes.byref(blocks),
                                  ctypes.byref(threads), ctypes.byref(smem)),
                  'receive_megakernel geometry')
    return blocks.value, threads.value, smem.value


def patch_p_for(n_lanes: int) -> int:
    """The strata grid of a mesh call (the JAX package's rule): P = 32 if
    the 1024-lane tiles count a multiple of 1024, 16 if of 256, else 0
    (no strata: the lanes take the cosine / lobe mixture)."""
    n_tiles = max(n_lanes // TILE, 1)
    return next((p for p in (32, 16) if n_tiles % (p * p) == 0), 0)


def receive_megakernel(params, prim, txp, *, adc: ADCConfig, max_depth: int,
                       time_sampling: str, rx_kind: str, n_lanes: int,
                       seed: int = 0, uniforms=None,
                       mesh: PackedBVH | None = None, patch_p: int = 0,
                       lane_out=None):
    """Trace `n_lanes` receive samples.  Returns (acc (n_time,) float32,
    n_events 0-d int64) on the tables' device.

    `uniforms` (n_draws(max_depth), n_lanes) float32 feeds the draws
    (injected mode); without it the lanes draw from Philox4x32-10 keyed by
    `seed`.  `mesh` (BVH tables of stride 96, on the tables' device)
    selects the mesh configuration; `patch_p` its direction strata (0 =
    none; `patch_p_for`), read with the seed slot `params[0]`; a
    `lane_out` (n_lanes,) float32 tensor receives each lane's contribution
    sum there (parity runs: it shows which lanes a triangle edge flipped).
    Tables on
    the CPU run the plain version (`receive_megakernel_ref`, fed
    `philox_uniforms` in PRNG mode); tables on a card launch the CUDA
    kernel, which raises if it cannot build or launch."""
    dev = params.device
    if time_sampling not in ('fixed', 'gate'):
        raise ValueError(f'time_sampling {time_sampling!r}')
    if rx_kind not in ('wigner', 'omni'):
        raise ValueError(f'rx_kind {rx_kind!r}')
    if adc.n_freq != 1 or not 1 <= adc.n_time <= MAX_N_TIME:
        raise ValueError(f'ADC {adc.n_time}x{adc.n_freq}: the kernel takes '
                         f'n_freq == 1 and n_time <= {MAX_N_TIME}')
    n_prims = int(prim.shape[0])
    if not 1 <= n_prims <= MAX_PRIMS:
        raise ValueError(f'{n_prims} prim rows (1..{MAX_PRIMS})')
    for name, t, shape in (('params', params, (45 + MAX_MEDIA_LAYERS,)),
                           ('prim', prim, (n_prims, PRIM_COLS)),
                           ('txp', txp, (1, TXP_COLS))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name}: expected contiguous float32 {shape} '
                             f'on {dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
    nd = n_draws(max_depth)
    if uniforms is not None and (
            tuple(uniforms.shape) != (nd, n_lanes)
            or uniforms.dtype != torch.float32 or uniforms.device != dev
            or not uniforms.is_contiguous()):
        raise ValueError(f'uniforms: expected contiguous float32 '
                         f'({nd}, {n_lanes}) on {dev}')
    if mesh is not None:
        if mesh.stride != MESH_STRIDE or any(
                x.device != dev or not x.is_contiguous()
                for x in (mesh.bbox, mesh.links, mesh.leaves)):
            raise ValueError(f'mesh: expected contiguous stride-'
                             f'{MESH_STRIDE} tables on {dev}')
    if lane_out is not None and (
            mesh is None or tuple(lane_out.shape) != (n_lanes,)
            or lane_out.dtype != torch.float32 or lane_out.device != dev):
        raise ValueError(f'lane_out: expected float32 ({n_lanes},) on {dev}, '
                         'with a mesh')
    if patch_p and (mesh is None or rx_kind != 'wigner'):
        raise ValueError('direction strata need a mesh and a Wigner '
                         'receiver')
    if dev.type == 'cpu':
        u = uniforms if uniforms is not None else \
            philox_uniforms(seed, nd, n_lanes)
        return receive_megakernel_ref(params, prim, txp, u, adc=adc,
                                      max_depth=max_depth,
                                      time_sampling=time_sampling,
                                      rx_kind=rx_kind, mesh=mesh,
                                      patch_p=patch_p, lane_out=lane_out)
    if dev.type != 'cuda':
        raise ValueError(f'no receive kernel for device {dev}')
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        blocks, threads, smem = launch_geometry(
            adc.n_time, n_lanes, n_prims, int(params.shape[0]),
            mesh is not None)
        partial = torch.empty((blocks, adc.n_time), dtype=torch.float64,
                              device=dev)
        part_ev = torch.empty(blocks, dtype=torch.int64, device=dev)
        acc = torch.empty(adc.n_time, dtype=torch.float32, device=dev)
        n_events = torch.empty((), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        m = (None, None, None, 0) if mesh is None else (
            mesh.bbox.data_ptr(), mesh.links.data_ptr(),
            mesh.leaves.data_ptr(), mesh.stride)
        err = lib.rk_launch(
            params.data_ptr(), prim.data_ptr(), txp.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            partial.data_ptr(), part_ev.data_ptr(), acc.data_ptr(),
            n_events.data_ptr(), *m, patch_p,
            None if lane_out is None else lane_out.data_ptr(), n_lanes,
            seed & 0xFFFFFFFFFFFFFFFF, adc.n_time, max_depth,
            int(time_sampling == 'gate'), int(rx_kind == 'omni'), n_prims,
            int(params.shape[0]), adc.sampling_start, adc.sampling_time,
            0.5 * (adc.freq_lo + adc.freq_hi), blocks, threads, smem, stream)
        LIBRARY.check(err, 'receive_megakernel launch')
    receive_megakernel.launches += 1
    return acc, n_events


receive_megakernel.launches = 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A scene's kernel tables on one device."""

    params: torch.Tensor
    prim: torch.Tensor
    txp: torch.Tensor
    mesh: PackedBVH | None


def in_scope(scene, scene_data, rx, dev, reason: list) -> bool:
    """`supported(scene_data, rx, reason)`, decided once per (scene_data,
    rx) on `dev` and kept with the scene: the check reads tables back from
    the card, which would stall every call."""
    cache = scene.__dict__.setdefault('_receive_kernel_scope', {})
    key = (rx.id, dev)
    hit = cache.get(key)
    if hit is None or hit[0] is not scene_data or hit[1] is not rx:
        why: list = []
        hit = (scene_data, rx, supported(scene_data, rx, why), why)
        cache[key] = hit
    reason.extend(hit[3])
    return hit[2]


def _device_tables(scene, scene_data, rx, dev) -> DeviceTables:
    """The kernel tables of (scene_data, rx) on `dev`.  The scope check
    and the pack (and a mesh's BVH build) read the tables back from the
    card, so they run once per pair: the scene keeps the last pair of each
    receiver and device, and a call with the same objects launches without
    touching the host."""
    cache = scene.__dict__.setdefault('_receive_kernel_tables', {})
    key = (rx.id, dev)
    hit = cache.get(key)
    if hit is not None and hit[0] is scene_data and hit[1] is rx:
        return hit[2]
    why: list = []
    if not in_scope(scene, scene_data, rx, dev, why):
        raise NotImplementedError(
            "scene outside the receive kernel's scope: " + '; '.join(why))
    packed = pack_scene(scene_data, rx,
                        scene.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.as_tensor(a, device=dev).contiguous()
                         for a in (packed.params, packed.prim, packed.txp))
    tables = DeviceTables(params=params, prim=prim, txp=txp,
                          mesh=None if packed.mesh is None
                          else packed.mesh.to(dev))
    cache[key] = (scene_data, rx, tables)
    return tables


def seed_slot(seed: int) -> float:
    """The JAX package's per-call seed slot params[0]: float32 of
    seed * 1_000_003 % 2^30 (it offsets the direction strata)."""
    return float(np.float32(seed * 1_000_003 % (1 << 30)))


def receive_kernel(scene, scene_data, rx, spp: int, seed: int = 0,
                   max_depth: int = 3, time_sampling: str = 'gate',
                   device=None):
    """Run the receive kernel on `scene_data`'s tables.  Returns
    (signal (n_time, 1) float32 accumulated power, n_samples).

    n_samples is `spp`, rounded down to whole 1024-lane tiles (at least
    one) for mesh scenes, as the JAX package rounds its mesh lanes.  The
    lanes draw from Philox4x32-10 keyed by `seed`: the kernel's own
    generator on a card, `philox_uniforms` on the CPU, so one seed gives
    one stream on both.  Develop with `receive.develop_signal`
    (x n_time / n_samples)."""
    dev = resolve_device(device)
    tab = _device_tables(scene, scene_data, rx, dev)
    rx_kind = 'omni' if rx.kind == OMNI else 'wigner'
    n_lanes, patch_p, params = spp, 0, tab.params
    if tab.mesh is not None:
        n_lanes = max(TILE, (spp // TILE) * TILE)
        if rx_kind == 'wigner':
            patch_p = patch_p_for(n_lanes)
        params = params.clone()
        params[0] = seed_slot(seed)
    acc, _ = receive_megakernel(
        params, tab.prim, tab.txp, adc=rx.adc, max_depth=max_depth,
        time_sampling=time_sampling, rx_kind=rx_kind, n_lanes=n_lanes,
        seed=seed, mesh=tab.mesh, patch_p=patch_p)
    return acc.reshape(rx.adc.n_time, 1), n_lanes
