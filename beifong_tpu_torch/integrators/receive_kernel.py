"""Radar receive megakernel on Hopper: host side, plain PyTorch version and
the wrapper of the CUDA kernel in `csrc/receive_megakernel.cu`.

Counterpart of `beifong_tpu/integrators/pallas_receive.py` in its
configurations.  The flagship one: analytic rectangles, diffuse BSDFs,
one Wigner transmitter (CW / pulse / LFMCW), a Wigner or omni receiver,
raw receive without LO, fixed or gate time sampling, power accumulation
on a fast-time-only ADC (`n_freq == 1`, n_time <= MAX_N_TIME_ROWS), a
static scene and no medium.  The mesh one adds diffuse triangle meshes
(and rectangles demoted into them past MAX_PRIMS) behind a BVH walk
(`csrc/bvh_walk.cuh`) for the closest hit and the shadow test, and the
per-tile direction strata of the receive rays.  The Doppler one, on
rectangles and on meshes, adds what the JAX kernel bakes as `moving`,
`ggx` and its other splats: the first-order Doppler chain of moving
shapes, transmitter and receiver, the GGX rough conductor beside the
diffuse lobe (per prim row, and per mesh-shape row `msh` on meshes), a
per-lane frequency draw and the time x frequency tent splat for
`n_freq > 1`, fast-time grids past MAX_N_TIME_ROWS, and the receive
types with a local oscillator (LO): mix_resample, mixer and raw_resample
(`rx_rule`), and the mirror chains of smooth conductors (the JAX
kernel's `mirror`: specular bounces with the conductor's Fresnel weight,
no NEE from a mirror, a direct transmitter hit at the vertex after
one).  The coherent one is the Doppler configuration with two
channels: every connection splats sqrt(power) e^{i phase} as (I, Q),
with the JAX kernel's own float32 echo phase (`_frac_cycles`, `_h_cyc`,
`echo_phase`).  The MIMO one is the coherent configuration of a phased
receive array, on analytic scenes: the rays leave the array's origin,
weighted by one element's pattern, and every connection splats one I / Q
pair an element, 2E channels, each element's phase moved by the exact
spherical path difference of its position (the JAX kernel's `mimo_e`,
`eoff_ref`).  Every configuration has an endpoint twin, which runs it
with up to MAX_TX transmitters of mixed kinds (Wigner, phased arrays
whose aperture weight is the cross-WDF pair sum `_pair_sum`, and plain
area transmitters), a direct hit for the transmitter a lane hits and NEE
to each in row order, and, outside MIMO, an analog phased receiver
weighted by its own cross-WDF (the JAX kernel's n_tx, tx_kinds and
rx_kind 'phased').  Every configuration has a media twin, which runs it
through the scene's ambient medium (homogeneous, z-layered or a 3-D sigma
grid; `pack_medium`, `medium_tau`): every segment a lane crosses
multiplies its throughput, and every NEE connection its value, by
exp(-tau), as the JAX kernel's `absorbing`, `layered` and `grid_meta`
do.  The Doppler family's configurations have a lobe twin, which adds
the JAX kernel's `diel`, `thin`, `plas`, `rplas`, `rdiel`, `has_blend`
and `has_mask` lobes (`lobe_flags`): delta reflection or refraction by
the dielectric Fresnel (a thin sheet passes the ray), the plastics'
diffuse base under a smooth or GGX coat, GGX glass (Walter's reflection
and transmission lobes), and one level of blend or mask over them on a
rectangle (the second lobe in prim columns 27-33; NEE evaluates the mix,
the bounce picks a lobe, a mask's other lobe passes the ray on); a
refracted or passed ray leaves through the back face, and a lane a
delta lobe continued counts a direct transmitter hit at its next
vertex.  The flagship, Doppler power and coherent configurations have a
texture twin, which scales a diffuse rectangle's reflectance by its
checkerboard or bitmap texture at the hit's local uv (prim columns 22-26;
the bitmaps' texel rows `PackedScene.tex`), as the JAX kernel's
`prim_tex` does.  Per
lane the kernel generates the receive ray, finds the
closest hit, counts direct transmitter hits at depth 0, connects to the
transmitter (NEE) with the waveform and aperture Wigner weights and a
shadow test, tent-splats into the ADC grid and makes the BSDF bounce.

`receive_megakernel_ref` holds that arithmetic as vectorised torch ops
over lanes, in float32, consuming `uniforms (n_draws, n_lanes)` in the
kernel's positional draw order:

1. one time draw (a placeholder under gate sampling);
2. the frequency draw where the JAX kernel draws one: over the ADC's
   frequency window for raw receive (and raw_resample without an LO)
   when `n_freq > 1`, over the beat window for mixer whatever n_freq;
   none for mix_resample and raw_resample with an LO, whose receive
   frequency follows a waveform;
3. two (omni) or four (Wigner, phased) receive-ray draws (a phased
   array's first two, a point on its rectangle, are drawn and not used:
   MIMO rays leave the array's origin);
4. per depth: the direct-hit draw, then for each transmitter in row
   order two transmitter-point draws and the emission-time draw (a
   placeholder under fixed sampling);
5. per depth but the last: two bounce draws (the diffuse lobe and the
   GGX half-vector share them, as the lane's type is one or the other;
   a dielectric picks its reflection by the first), then the lobe pick
   of plastics and GGX glass and the lobe-mix pick of composites where
   the tables hold them (`lobe_draws`).

`n_draws(max_depth, n_tx, lobe_mix, blend_mix)` over-allocates (26 rows
at depth 3 with one transmitter, of which at most 22 are read) and is
honoured as the layout stride.  `receive_megakernel` runs
that plain version for tensors on the CPU and the CUDA kernel for tensors
on a card; `receive_megakernel_cpi` runs a coherent processing interval
(CPI), the tables of every pulse stacked (`pack_cpi`), in one launch
with the pulse a grid axis (the JAX package's `receive_cpi_pallas`).

Direction strata (mesh scenes whose 1024-lane tiles tile a P x P grid,
P = 32 or 16): the lanes of tile `lane // 1024` draw their cosine-
hemisphere direction inside cell ((tile * 131 + int(params[0])) % P^2) of
the unit square, so a tile traces a narrow beam.  `params[0]` is the JAX
package's seed slot, float32(seed * 1_000_003 % 2^30), written per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from .. import _nvcc
from .._device import resolve_device
from ..bsdf.tables import (BLEND, CONDUCTOR, DIELECTRIC, DIFFUSE, MASK,
                           PLASTIC, ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                           ROUGH_PLASTIC, THIN_DIELECTRIC)
from ..core.rng import MASK32, philox4x32_10
from ..geometry import bvh as bvh_mod
from ..geometry.bvh_kernel import PackedBVH, walk_ref, leaf_column, pack
from ..geometry.shapes import CYLINDER, DISK, RECTANGLE, SPHERE, TRIANGLE
from ..media import (GRID, HOMOGENEOUS, LAYERED, HeterogeneousMedium,
                     HomogeneousMedium, LayeredMedium)
from ..radar.endpoints import (ADCConfig, AREA, OMNI, PHASED, WIGNER,
                               _elem_locs, _phased_pairs, rx_elem_offsets)
from ..radar.waveform import CW, LINFMCW
from ..textures import BITMAP, CHECKERBOARD

MAX_PRIMS = 64          # prim rows held in shared memory
# the endpoint configuration's caps, the JAX package's (its NEE and its
# cross-WDF pair sums are unrolled): transmitters, a phased transmitter's
# n_tx x K pairs, a phased receiver's E^2 pairs
MAX_TX = 4
MAX_TX_PAIRS = 128
MAX_RX_PAIRS = 64
# ADC caps on the H100 (the TPU's VMEM / MXU caps and its 128-multiple
# rule do not apply; see the splat notes in the .cu):
# - flagship / mesh configurations: a private shared-memory row of
#   n_time floats per thread within 96 KB a block; at 512 bins that
#   leaves one warp a block;
MAX_N_TIME_ROWS = 512
# - Doppler configuration: one block-shared (n_time, n_freq) float grid
#   up to MAX_SMEM_CELLS (64 KB: with ~11 KB of tables, three blocks fit
#   an SM's 228 KB), past it a global float64 grid of atomics up to
#   MAX_ADC_CELLS (8 MB, which stays in the 50 MB L2);
# - coherent configuration: two floats (I, Q) a cell, so the same 64 KB
#   of shared memory holds MAX_SMEM_COH_CELLS, and the global grid of
#   MAX_ADC_CELLS cells takes 2 x 2^20 doubles (16 MB, still in L2);
MAX_SMEM_CELLS = 16384
MAX_SMEM_COH_CELLS = MAX_SMEM_CELLS // 2
MAX_ADC_CELLS = 1 << 20
# - the coherent kernel on analytic scenes (receive_coherent_kernel), the
#   analytic lobe twins' kernel (receive_lobe_kernel) and the analytic
#   Doppler power kernel (receive_doppler_power_kernel) sum a 1-D grid
#   of at most COH_ROW_VALS values (I and Q, or the power, of n_time
#   bins) into a row of doubles a warp, each bin's taps in lane order:
#   their repeats are bit-identical; larger grids keep the block's or the
#   global grid of atomics (coh_rows in the .cu)
COH_ROW_VALS = 512
# - bin coordinates are float32: at 2^16 bins a tent weight keeps 7
#   fraction bits (the JAX package's 1-D cap is the same 65,536)
MAX_N_TIME = 65536
MAX_N_FREQ = 65536
# - MIMO configuration: 2 <= E <= 8 elements (the JAX package's caps), a
#   fast-time grid of n_time x 2E float64 values, block-shared up to
#   MAX_SMEM_MIMO_VALS (64 KB, the other configurations' budget), past it
#   global, up to MAX_MIMO_N_TIME bins (1 MB at E = 8)
MAX_MIMO_ELEMS = 8
MAX_MIMO_N_TIME = 8192
MAX_SMEM_MIMO_VALS = 8192
# - ambient media, the JAX package's caps (kept, so that both packages
#   route a scene alike): a layered medium's K steps ride params[45:45+K]
#   (45 + MAX_MEDIA_LAYERS slots), a sigma grid of at most MAX_GRID3_ROWS
#   (D x H) rows of MAX_GRID3_W cells (32 KB, read through L1)
MAX_MEDIA_LAYERS = 32
MAX_GRID3_ROWS = 64
MAX_GRID3_W = 128
# the row at which the JAX package's texture table holds the sigma grid of
# an untextured scene (its table's 8 rows of zeros come first): params[52]
GRID3_TEX_ROW = 8
# bitmap textures, the JAX package's caps (its one-hot gather's cost),
# kept so that both packages route a textured scene alike: the texels of
# one bitmap, and the texel rows of the distinct bitmaps together (each
# padded to a multiple of 8 rows).  The texture twins read a texel with
# one load, so neither binds them here
MAX_BMP_TEXELS = 16384
MAX_BMP_ROWS = 512
TEX_LANE = 128          # texel rows are padded to a multiple of 128 texels
MAX_MESH_SHAPES = 64    # distinct mesh-shape rows (the JAX package's cap)
MESH_STRIDE = 96        # leaf rows: 80 + reflectance + shape-row payloads
# the BVH tables live in device memory and are indexed with int32: a leaf
# row's last float, leaf * 96 + 95, must stay below 2^31
MAX_MESH_TRIS = 8 * ((2 ** 31 - 1) // MESH_STRIDE)
TILE = 1024             # lanes per stratification tile (8 x 128 on the TPU)
PRIM_COLS = 34
# the analytic kinds the kernel's prim rows hold, and those beyond the
# rectangle (the prims twins)
ANALYTIC = (RECTANGLE, SPHERE, DISK, CYLINDER)
NON_RECT = (SPHERE, DISK, CYLINDER)
TXP_COLS = 32

TWO_PI = 6.283185307179586
MASK64 = 0xFFFFFFFFFFFFFFFF
HALF_PI_F32 = 0.5 * float(np.float32(np.pi))

# How the receive frequency and the frequency bins follow the receive type
# (the JAX kernel's `mix`, `mixer` and `rres_lo`, pallas_receive.py:
# 174-179, 429-452, 1615-1625):
RX_RAW = 0      # raw, and raw_resample without an LO: bin f_recv
RX_MIX = 1      # mix_resample: f_rx from the transmitter's chirp, bin the
#                 beat |f_recv - f_tx(t_recv)|
RX_MIXER = 2    # mixer: a beat draw, f_rx = f_LO - beat, bin f_LO - f_recv
RX_RAW_LO = 3   # raw_resample with an LO: f_rx from the LO, bin f_recv

# The lobe twins' flags, a bit mask (`lobe_flags`): the JAX kernel's static
# lobe flags beyond the diffuse, GGX-conductor and mirror lobes
# (pallas_receive.py:187-225), read from the packed tables
LOBE_DIEL = 1       # smooth dielectric: delta reflect / refract
LOBE_THIN = 2       # thin dielectric: delta reflect / pass
LOBE_PLAS = 4       # plastic: diffuse base under a smooth coat
LOBE_RPLAS = 8      # rough plastic: diffuse base plus a GGX coat
LOBE_RDIEL = 16     # rough dielectric: GGX glass (Walter 2007)
LOBE_BLEND = 32     # a blend or mask composite: a second lobe a prim
LOBE_MASK = 64      # a mask: its other lobe passes the ray straight on
LOBE_OF_TYPE = {DIELECTRIC: LOBE_DIEL, THIN_DIELECTRIC: LOBE_THIN,
                PLASTIC: LOBE_PLAS, ROUGH_PLASTIC: LOBE_RPLAS,
                ROUGH_DIELECTRIC: LOBE_RDIEL}
# the lobes that draw a lobe pick a bounce (the JAX kernel's `lobe_mix`)
LOBE_PICK = LOBE_PLAS | LOBE_RPLAS | LOBE_RDIEL


def rx_rule(receive_type: str, has_lo: bool) -> int:
    """The kernel's receive-frequency rule of a receiver (RX_*)."""
    if receive_type == 'mix_resample':
        return RX_MIX
    if receive_type == 'mixer':
        if not has_lo:
            raise ValueError('a mixer receiver needs an LO waveform')
        return RX_MIXER
    if receive_type == 'raw_resample' and has_lo:
        return RX_RAW_LO
    if receive_type not in ('raw', 'raw_resample'):
        raise ValueError(f'receive_type {receive_type!r}')
    return RX_RAW


# ---------------------------------------------------------------------------
# scene pack (numpy only; bit-identical with the JAX package's _pack_scene
# on the scenes `supported` admits)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedScene:
    params: np.ndarray   # (77,) f32 scalars; [0] is the seed slot
    prim: np.ndarray     # (n_prims, 34) f32 prim rows
    txp: np.ndarray      # (n_tx, 32) f32 transmitter rows
    php: np.ndarray      # (n_tx, 2 + 6K) phased pair rows: the element
    #                      half-widths, then K = max E^2 pairs
    rxph: np.ndarray     # (1, 2 + 6K) phased receiver row: the element
    #                      half-widths, then K = E^2 pairs (zeros (1, 8)
    #                      for any other receiver)
    msh: np.ndarray      # (n_mesh_shapes, 8) f32 mesh-shape rows
    mesh: PackedBVH | None = None   # BVH over the mesh triangles (CPU)
    rx_rule: int = RX_RAW           # the receiver's frequency rule
    medium: int = 0                 # media.HOMOGENEOUS / LAYERED / GRID
    grid: np.ndarray | None = None  # (D, H, W) f32 sigma cells (GRID)
    tex: np.ndarray | None = None   # (R, Wp) f32: the JAX package's texel
    #                                 rows (its sigma grid's rows last)
    bmp_meta: np.ndarray | None = None   # (n_prims, 3) int32: a bitmap
    #                                 rectangle's (first row, H, W) in
    #                                 `tex`, (-1, 0, 0) for the others

    @property
    def textured(self) -> bool:
        """A checkerboard or bitmap rectangle (prim column 26): the
        texture twins."""
        return bool((self.prim[:, 26] != 0).any())

    @property
    def prims(self) -> bool:
        """A sphere, disk or cylinder row (column 0): the prims twins."""
        return bool(np.isin(self.prim[:, 0], NON_RECT).any())

    @property
    def moving(self) -> bool:
        """Any shape, transmitter or receiver velocity (the JAX kernel's
        `moving` flag)."""
        return bool(np.abs(self.prim[:, 19:22]).max(initial=0.0) > 0.0
                    or np.abs(self.txp[:, 24:27]).max() > 0.0
                    or np.abs(self.params[23:26]).max() > 0.0
                    or np.abs(self.msh[:, 0:3]).max() > 0.0)

    def _has_type(self, code: int) -> bool:
        return bool((self.prim[:, [18, 28]] == code).any()
                    or (self.mesh is not None
                        and (self.msh[:, 6] == code).any()))

    @property
    def ggx(self) -> bool:
        """A GGX rough conductor on a rectangle or a mesh shape."""
        return self._has_type(ROUGH_CONDUCTOR)

    @property
    def mirror(self) -> bool:
        """A smooth conductor (a delta mirror) on a rectangle or a mesh
        shape: the JAX kernel's `mirror` flag."""
        return self._has_type(CONDUCTOR)

    @property
    def lobes(self) -> int:
        """The lobe twins' flags of the tables (`lobe_flags`)."""
        return lobe_flags(self.prim, self.msh if self.mesh is not None
                          else None)

    def doppler(self, adc: ADCConfig) -> bool:
        """Does this scene, receiver and ADC need the Doppler configuration
        (its power mode; coherent calls take the coherent one)?  Mirror
        chains run there only."""
        return needs_doppler(self, adc)


def needs_doppler(tables, adc: ADCConfig) -> bool:
    """The Doppler configuration's condition on a pack's flags (one pulse's
    or a CPI's) and the ADC.  The lobe twins are twins of the Doppler
    family."""
    return (tables.moving or tables.ggx or tables.mirror or bool(tables.lobes)
            or adc.n_freq != 1 or adc.n_time > MAX_N_TIME_ROWS
            or tables.rx_rule != RX_RAW)


def lobe_flags(prim, msh=None) -> int:
    """The lobe twins' flags (LOBE_*) of packed tables, numpy arrays or
    tensors, one pulse's or a CPI's stacked ones: the lobe types of the
    prim rows' two lobes (columns 18 and 28) and of the mesh-shape rows
    `msh` (column 6; None without a mesh), and the composites of the mix
    column 27 (1 blend, 2 mask).  Reads a card's tables back."""
    prim = torch.as_tensor(prim)
    types = set(prim[..., [18, 28]].reshape(-1).tolist())
    if msh is not None:
        types |= set(torch.as_tensor(msh)[..., 6].reshape(-1).tolist())
    flags = sum(bit for code, bit in LOBE_OF_TYPE.items() if code in types)
    mix = set(prim[..., 27].reshape(-1).tolist())
    if mix - {0.0}:
        flags |= LOBE_BLEND
    if 2.0 in mix:
        flags |= LOBE_MASK
    return flags


def _demoted_rects(sd) -> list:
    """Shape rows of the plain rectangles moved into the triangle BVH when
    the analytic prims (rectangles, spheres, disks, cylinders) would
    overflow MAX_PRIMS (two exact world-space triangles each), as the JAX
    package counts them.  Transmitter shapes, bsdf-less blockers (the
    receiver rectangle), textured rectangles and the other kinds stay
    analytic."""
    kind_np = sd.shapes.kind.cpu().numpy()
    if int(np.isin(kind_np, ANALYTIC).sum()) <= MAX_PRIMS:
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
    nested0 = sd.bsdfs.nested0.cpu().numpy()
    nested1 = sd.bsdfs.nested1.cpu().numpy()
    b_wt = sd.bsdfs.weight.cpu().numpy()
    shape_vel = shapes.velocity.cpu().numpy()
    tex_idx = sd.bsdfs.texture_idx.cpu().numpy()
    t_type = sd.textures.type.cpu().numpy()
    t_c0 = sd.textures.color0.cpu().numpy()
    t_c1 = sd.textures.color1.cpu().numpy()
    t_suv = sd.textures.scale_uv.cpu().numpy()
    bmp_of_prim = {}   # prim row -> texture row (bitmap rectangles)

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
        # blend / mask composites: column 27 the mix code (0 plain, 1
        # blend, 2 mask), 28 the second lobe's type, 29-32 its reflectance,
        # alpha, eta and k, 33 the weight of the first lobe (a blend's
        # weight, a mask's opacity); the first lobe, nested0, takes columns
        # 13 and 15-18.  A plain row repeats its lobe there with weight 1
        prim[r, 28] = prim[r, 18]
        prim[r, 29] = prim[r, 13]
        prim[r, 30:33] = prim[r, 15:18]
        prim[r, 33] = 1.0
        if b >= 0 and int(b_type[b]) in (MASK, BLEND):
            n0 = int(nested0[b])
            prim[r, 13] = refl[n0, 0]
            prim[r, 15] = b_alpha[n0]
            prim[r, 16] = b_eta[n0, 0]
            prim[r, 17] = b_k[n0, 0]
            prim[r, 18] = float(b_type[n0])
            prim[r, 33] = float(b_wt[b])
            if int(b_type[b]) == BLEND:
                n1 = int(nested1[b])
                prim[r, 27] = 1.0
                prim[r, 28] = float(b_type[n1])
                prim[r, 29] = refl[n1, 0]
                prim[r, 30] = b_alpha[n1]
                prim[r, 31] = b_eta[n1, 0]
                prim[r, 32] = b_k[n1, 0]
            else:
                # a mask's second lobe is a zero diffuse one: the kernel
                # passes the ray on where it picks it
                prim[r, 27] = 2.0
                prim[r, 28] = float(DIFFUSE)
                prim[r, 29:33] = 0.0
        prim[r, 19:22] = shape_vel[i]
        # the texture payload (rectangles; `supported` refuses the rest):
        # column 26 the code, 1 a checkerboard (its colours at 22, 23), 2
        # a bitmap (its texel rows in `tex`); its uv scale at 24, 25
        t_i = int(tex_idx[b]) if b >= 0 else -1
        if t_i >= 0 and int(t_type[t_i]) in (CHECKERBOARD, BITMAP):
            prim[r, 24:26] = t_suv[t_i]
            if int(t_type[t_i]) == CHECKERBOARD:
                prim[r, 22] = t_c0[t_i, 0]
                prim[r, 23] = t_c1[t_i, 0]
                prim[r, 26] = 1.0
            else:
                prim[r, 26] = 2.0
                bmp_of_prim[r] = t_i
    tex, bmp_meta = _pack_bitmaps(sd.textures, bmp_of_prim, len(keep))

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

    # the phased pair rows: element half-widths, then per virtual pair
    # (mid_s, mid_t, base_s, base_t, psi, valid) in the array's local frame
    K = int(tx.pair_mask.shape[1])
    php = np.zeros((n_tx, 2 + 6 * K), np.float32)
    php[:, 0:2] = tx.elem_wid.cpu().numpy()
    e_mid = tx.elem_mid.cpu().numpy()
    e_base = tx.elem_baseline.cpu().numpy()
    php[:, 2:].reshape(n_tx, K, 6)[:] = np.stack(
        [e_mid[..., 0], e_mid[..., 1], e_base[..., 0], e_base[..., 1],
         tx.psi.cpu().numpy(), tx.pair_mask.cpu().numpy().astype(np.float32)],
        -1)

    if shape_idx >= 0:
        rxm = to_world[shape_idx][:3, :].reshape(-1)
        rx_wx = float(np.linalg.norm(to_world[shape_idx][:3, 0]))
        rx_wy = float(np.linalg.norm(to_world[shape_idx][:3, 1]))
    else:
        rxm = np.asarray(rx.to_world)[:3, :].astype(np.float32).reshape(-1)
        rx_wx = rx_wy = 0.0
    # the phased receiver's row: element half-widths, then per virtual
    # pair (mid_s, mid_t, base_s, base_t, psi, valid), and the array's
    # in-plane half-extents
    rxph = np.zeros((1, 8), np.float32)
    rx_hx = rx_hy = 0.0
    if rx.kind == PHASED and rx.n_elems > 1:
        mids, bases, psis = _phased_pairs(
            rx, 0.5 * (sd.band.wavelength_min + sd.band.wavelength_max))
        kr = mids.shape[0]
        rxph = np.zeros((1, 2 + 6 * kr), np.float32)
        rxph[0, 0] = float(np.asarray(rx.elem_wid)[0])
        rxph[0, 1] = float(np.asarray(rx.elem_wid)[1])
        for k in range(kr):
            b = 2 + 6 * k
            rxph[0, b:b + 6] = (mids[k, 0], mids[k, 1], bases[k, 0],
                                bases[k, 1], psis[k], 1.0)
        locs = _elem_locs(rx)
        rx_hx = float(np.abs(locs[:, 0]).max()) \
            + float(np.asarray(rx.elem_wid)[0])
        rx_hy = float(np.abs(locs[:, 1]).max()) \
            + float(np.asarray(rx.elem_wid)[1])

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
    params[30], params[31] = rx_hx, rx_hy
    params[32] = float(getattr(rx, 'gain', 1.0))
    lo_wf = rx.lo_waveform
    if lo_wf is not None:
        # the LO waveform [33:39] and its coherent dechirp pivots, in
        # float64 on the host as for the transmitter's row
        for i, f in enumerate(('kind', 'amplitude', 'rep_freq', 't_ext',
                               'f_centre', 'f_ext')):
            params[33 + i] = float(getattr(lo_wf, f).reshape(-1)[0])
        pri_lo32 = np.float32(1.0 / max(np.float32(params[35]),
                                        np.float32(1e-12)))
        params[39] = np.float32(np.float64(fc_ref) * np.float64(pri_lo32)
                                % 1.0)
        params[40] = np.float32(np.float64(params[37]) - np.float64(fc_ref))
        params[41] = float(lo_wf.phi0.reshape(-1)[0])

    medium, grid = pack_medium(sd.medium, params, tex.shape[0])
    if grid is not None:
        # the JAX package's texture table carries the sigma grid's rows
        gd, gh, gw = grid.shape
        if gw > tex.shape[1]:
            tex = np.pad(tex, ((0, 0), (0, -(-gw // TEX_LANE) * TEX_LANE
                                        - tex.shape[1])))
        blk = np.zeros((-(-gd * gh // 8) * 8, tex.shape[1]), np.float32)
        blk[:gd * gh, :gw] = grid.reshape(gd * gh, gw)
        tex = np.concatenate([tex, blk])

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
                       rxph=rxph, msh=msh, mesh=mesh,
                       rx_rule=rx_rule(rx.receive_type, lo_wf is not None),
                       medium=medium, grid=grid, tex=tex, bmp_meta=bmp_meta)


def _pack_bitmaps(textures, bmp_of_prim: dict, n_prims: int):
    """The bitmap rectangles' texel rows as the JAX package packs them:
    channel 0 of each distinct bitmap, in texture-row order, a block of
    its rows padded to a multiple of 8, the width padded to a multiple of
    TEX_LANE (at least one); 8 rows of zeros without bitmaps.  Returns
    (tex (R, Wp) float32, bmp_meta (n_prims, 3) int32: (first row, H, W)
    of a bitmap rectangle's block, (-1, 0, 0) for the other rows)."""
    bmp_meta = np.tile(np.asarray([-1, 0, 0], np.int32), (n_prims, 1))
    if not bmp_of_prim:
        return np.zeros((8, TEX_LANE), np.float32), bmp_meta
    hw = textures.atlas_hw.cpu().numpy()
    atlas = textures.atlas.cpu().numpy()
    used = sorted(set(bmp_of_prim.values()))
    w_max = max(int(hw[t, 1]) for t in used)
    wp = max(TEX_LANE, -(-w_max // TEX_LANE) * TEX_LANE)
    blocks, off_of, off = [], {}, 0
    for t in used:
        h, w = int(hw[t, 0]), int(hw[t, 1])
        blk = np.zeros((-(-h // 8) * 8, wp), np.float32)
        blk[:h, :w] = atlas[t, :h, :w, 0]
        off_of[t] = (off, h, w)
        blocks.append(blk)
        off += blk.shape[0]
    for r, t in bmp_of_prim.items():
        bmp_meta[r] = off_of[t]
    return np.concatenate(blocks), bmp_meta


def pack_medium(med, params: np.ndarray, tex_rows: int = GRID3_TEX_ROW):
    """Write a scene's ambient medium into `params` as the JAX package's
    `_pack_scene` does, bit for bit, and return (kind, grid): 0 and None
    in vacuum; homogeneous sigma_t at [29]; layered K at [42], z_min and
    the layer thickness at [43:45], the K steps of the profile (taken in
    float64, then rounded) from [45]; a grid's box minimum [43:46],
    inverse extent [46:49], D, H, W [49:52] and its texture row [52]
    (`tex_rows`, the rows of the bitmaps packed ahead of it), with its
    (D, H, W) float32 cells returned apart (the rows the JAX package
    appends to its texture table).  The kind goes to the kernel
    on its own: params[49] > 0 does not tell a grid (a layered medium's
    fifth step sits there)."""
    if med is None:
        return 0, None
    if isinstance(med, HomogeneousMedium):
        params[29] = float(med.sigma_t.reshape(-1)[0])
        return HOMOGENEOUS, None
    if isinstance(med, LayeredMedium):
        k = med.n_layers
        sig = med.sigma.cpu().numpy().astype(np.float64).reshape(-1)
        z_min, z_max = float(med.z_min), float(med.z_max)
        params[42] = float(k)
        params[43] = z_min
        params[44] = (z_max - z_min) / k
        params[45] = sig[0]
        params[46:45 + k] = sig[1:] - sig[:-1]
        return LAYERED, None
    if isinstance(med, HeterogeneousMedium):
        grid = med.sigma_grid.cpu().numpy().astype(np.float32)
        bmn = med.box_min.cpu().numpy().astype(np.float32)
        bmx = med.box_max.cpu().numpy().astype(np.float32)
        params[43:46] = bmn
        params[46:49] = 1.0 / np.maximum(bmx - bmn, 1e-12)
        params[49:52] = grid.shape
        params[52] = tex_rows
        return GRID, np.ascontiguousarray(grid)
    raise NotImplementedError(f'ambient medium {type(med).__name__}')


# ---------------------------------------------------------------------------
# scope
# ---------------------------------------------------------------------------


def supported(scene_data, rx, reason: list | None = None,
              mimo: bool = False) -> bool:
    """Can the port's kernel run this scene (in its MIMO configuration
    with `mimo`)?  Appends the first rejection reason, with the ROADMAP
    item that lifts it, to `reason`."""

    def no(why: str) -> bool:
        if reason is not None:
            reason.append(why)
        return False

    sd = scene_data
    tx = sd.transmitters
    if tx is None:
        return no('no transmitters')
    if tx.n > MAX_TX:
        return no(f'{tx.n} transmitters > {MAX_TX} (unrolled NEE, the JAX '
                  'package\'s cap; the wavefront runs it)')
    if not bool(tx.resample.all()):
        return no('non-delta-resampled transmitter: wavefront-only, in the '
                  'JAX package as here (its kernel refuses it too)')
    kinds = set(tx.kind.tolist())
    if not kinds <= {WIGNER, PHASED, AREA}:
        return no(f'transmitter kinds {sorted(kinds)}: Wigner, phased or '
                  'area only')
    n_pairs = int(tx.pair_mask.shape[1])
    if PHASED in kinds and tx.n * n_pairs > MAX_TX_PAIRS:
        return no(f'phased pair unroll {tx.n}x{n_pairs} > {MAX_TX_PAIRS} '
                  '(in-kernel cross-WDF sum, the JAX package\'s cap; the '
                  'wavefront runs it)')
    if bool((tx.shape_idx < 0).any()):
        return no('free-standing transmitter: the kernel samples its '
                  'rectangle; wavefront-only, in the JAX package as here '
                  '(its kernel refuses it too)')
    if tx.n > 1 and rx.receive_type == 'mix_resample':
        return no('mix_resample with multiple transmitters (the LO is the '
                  'transmitter\'s chirp: ambiguous), in the JAX package as '
                  'here')
    kinds = set(sd.shapes.kind.tolist())
    if not kinds <= {-1, TRIANGLE, *ANALYTIC}:
        return no(f'shape kinds {sorted(kinds)}: rectangles, spheres, '
                  'disks, cylinders and triangle meshes only')
    if sd.has_shading_maps:
        return no('normal or bump maps: the kernel does not perturb the '
                  "shading frame (the JAX package's kernel admits such "
                  'scenes and drops the maps, ROADMAP C11); the wavefront '
                  'runs it')
    prims = bool(kinds & set(NON_RECT))
    demote = _demoted_rects(sd)
    n_prims = int(sd.shapes.kind.shape[0]) - len(demote)
    if n_prims > MAX_PRIMS:
        return no(f'{n_prims} analytic shape rows > {MAX_PRIMS} after '
                  'demoting plain rectangles into the BVH (shared-memory '
                  'prim table; ROADMAP A5)')
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
    present = set(sd.bsdfs.present)
    if not present <= BASE_BSDFS | {MASK, BLEND}:
        return no(f'BSDF types {sorted(present - BASE_BSDFS - {MASK, BLEND})}'
                  ': null and measured BSDFs are wavefront-only, in the JAX '
                  'package as here (its kernel refuses them too)')
    b_type = sd.bsdfs.type.tolist()
    if present & {MASK, BLEND}:
        # one level of blend / mask over the base lobes, on analytic
        # rectangles only (the JAX kernel's rules, pallas_receive.py:
        # 2760-2779)
        n0s, n1s = sd.bsdfs.nested0.tolist(), sd.bsdfs.nested1.tolist()
        for bi, t in enumerate(b_type):
            if t in (MASK, BLEND) and not (
                    b_type[n0s[bi]] in BASE_BSDFS
                    and (t == MASK or b_type[n1s[bi]] in BASE_BSDFS)):
                return no('blend / mask over a composite or a null or '
                          'measured BSDF: one level over the base lobes, '
                          'in the JAX package as here')
        for k, b in zip(sd.shapes.kind.tolist(), sd.shapes.bsdf_idx.tolist()):
            if k == TRIANGLE and b >= 0 and b_type[b] in (MASK, BLEND):
                return no('blend / mask on a triangle-mesh shape: the '
                          'kernels take composites on rectangles only, in '
                          'the JAX package as here')
    textured = _textured_scope(sd, no)
    if textured is None:
        return False
    lobes = bool(_lobe_types(sd) - {DIFFUSE, CONDUCTOR, ROUGH_CONDUCTOR})
    if mimo:
        if rx.kind != PHASED or rx.n_elems < 2:
            return no('MIMO receive needs a phased receiver with >= 2 '
                      'elements')
        if rx.n_elems > MAX_MIMO_ELEMS:
            return no(f'{rx.n_elems} MIMO elements > {MAX_MIMO_ELEMS} '
                      '(the JAX package\'s 2E-channel cap)')
        if rx.adc.n_freq != 1:
            return no('MIMO receive in the kernel is fast-time only '
                      '(n_freq == 1), as in the JAX package')
        if rx.adc.n_time > MAX_MIMO_N_TIME:
            return no(f'MIMO fast-time extent {rx.adc.n_time} > '
                      f'{MAX_MIMO_N_TIME} (the JAX package\'s cap)')
        if sd.tris is not None or demote:
            return no('MIMO receive of a mesh scene (ROADMAP B6): the '
                      'wavefront runs it')
        if lobes:
            return no('MIMO receive of dielectric, plastic or composite '
                      'lobes: the MIMO configuration has no lobe twin '
                      '(ROADMAP B5); the wavefront runs it')
    elif rx.kind == PHASED:
        if rx.n_elems ** 2 > MAX_RX_PAIRS:
            return no(f'phased rx pair unroll {rx.n_elems ** 2} > '
                      f'{MAX_RX_PAIRS} (in-kernel cross-WDF sum, the JAX '
                      'package\'s cap; the wavefront runs it)')
    elif rx.kind not in (WIGNER, OMNI):
        return no(f'receiver kind {rx.kind}')
    med = sd.medium
    # several transmitters, a phased or area one, an analog phased receiver
    endpoints = (tx.n > 1 or bool((tx.kind != WIGNER).any())
                 or (not mimo and rx.kind == PHASED and rx.n_elems > 1))
    if med is not None and endpoints:
        return no('these endpoints (several transmitters, a phased or '
                  'area transmitter, an analog phased receiver) through an '
                  'ambient medium: the kernel has no media twin of its '
                  'endpoint configuration (ROADMAP B6); the wavefront '
                  'runs it')
    if lobes and med is not None:
        return no('dielectric, plastic or composite lobes through an '
                  'ambient medium: the lobe twins run in vacuum (ROADMAP '
                  'B5); the wavefront runs it')
    if lobes and endpoints:
        return no('dielectric, plastic or composite lobes with these '
                  'endpoints (several transmitters, a phased or area '
                  'transmitter, an analog phased receiver): the lobe twins '
                  'have no endpoint twin (ROADMAP B5); the wavefront runs '
                  'it')
    if isinstance(med, LayeredMedium):
        if med.n_layers > MAX_MEDIA_LAYERS:
            return no(f'{med.n_layers} medium layers > {MAX_MEDIA_LAYERS} '
                      '(params slots, the JAX package\'s cap; ROADMAP B7)')
    elif isinstance(med, HeterogeneousMedium):
        gd, gh, gw = med.sigma_grid.shape
        if gd * gh > MAX_GRID3_ROWS or gw > MAX_GRID3_W:
            return no(f'3-D medium grid {gd}x{gh}x{gw} beyond the kernel\'s '
                      f'cap (D*H <= {MAX_GRID3_ROWS}, W <= {MAX_GRID3_W}, '
                      'the JAX package\'s; ROADMAP B7)')
    elif med is not None and not isinstance(med, HomogeneousMedium):
        return no(f'unknown ambient medium type {type(med).__name__}: the '
                  'kernel takes media.py\'s three')
    rt, has_lo = rx.receive_type, rx.lo_waveform is not None
    if rt not in ('raw', 'raw_resample', 'mix_resample') \
            and not (rt == 'mixer' and has_lo):
        return no(f'receive_type {rt!r}' + (' without an LO waveform'
                                             if rt == 'mixer' else ''))
    adc = rx.adc
    if adc.n_freq > MAX_N_FREQ:
        return no(f'n_freq {adc.n_freq} > {MAX_N_FREQ} (float32 bin '
                  'coordinates; ROADMAP A5)')
    if adc.n_time > MAX_N_TIME:
        return no(f'n_time {adc.n_time} > {MAX_N_TIME} (float32 bin '
                  'coordinates; ROADMAP A5)')
    if adc.n_time * adc.n_freq > MAX_ADC_CELLS:
        return no(f'ADC grid {adc.n_time} x {adc.n_freq} > {MAX_ADC_CELLS} '
                  'cells (the global accumulator, power or I / Q; '
                  'ROADMAP A5)')
    if adc.n_freq > 1 and not adc.freq_hi > adc.freq_lo:
        return no(f'n_freq {adc.n_freq} over an empty frequency window '
                  f'[{adc.freq_lo}, {adc.freq_hi}] (ROADMAP A5)')
    # the texture and prims twins: the flagship, the Doppler power and the
    # coherent configurations (motion, mirror chains, GGX, the LO receive
    # types, time x frequency and wide grids) of an analytic scene in
    # vacuum with one Wigner transmitter and diffuse or conductor lobes
    for on, what, item in ((textured, 'textures', 'B7'),
                           (prims, 'spheres, disks or cylinders',
                            'B1 (rest)')):
        if not on:
            continue
        if mimo:
            return no(f'{what} in MIMO receive: the MIMO configuration has '
                      f'no twin for them (ROADMAP {item}); the wavefront '
                      'runs it')
        if sd.tris is not None or demote:
            return no(f'{what} in a mesh scene: the mesh configurations '
                      f'have no twin for them (ROADMAP {item}); the '
                      'wavefront runs it')
        if lobes:
            return no(f'{what} with dielectric, plastic or composite '
                      'lobes: the lobe twins have no twin for them '
                      f'(ROADMAP {item}); the wavefront runs it')
        if endpoints:
            return no(f'{what} with these endpoints (several '
                      'transmitters, a phased or area transmitter, an '
                      'analog phased receiver): the endpoint twins have no '
                      f'twin for them (ROADMAP {item}); the wavefront runs '
                      'it')
        if med is not None:
            return no(f'{what} through an ambient medium: the media twins '
                      f'have no twin for them (ROADMAP {item}); the '
                      'wavefront runs it')
    return True


def _textured_scope(sd, no):
    """The JAX kernel's texture rules (pallas_receive.py:2780-2810): a
    textured BSDF takes a checkerboard or a bitmap, on rectangles only, a
    bitmap of at most MAX_BMP_TEXELS texels, and the distinct bitmaps at
    most MAX_BMP_ROWS packed rows.  Returns whether the scene has a
    texture, or None where it breaks a rule (after calling `no` with the
    reason)."""

    def refuse(why: str):
        no(why)
        return None

    tex_idx = sd.bsdfs.texture_idx.tolist()
    if max(tex_idx, default=-1) < 0:
        return False
    t_type = sd.textures.type.tolist()
    t_hw = sd.textures.atlas_hw.tolist()
    used = set()     # a shared bitmap's rows count once
    for k, b in zip(sd.shapes.kind.tolist(), sd.shapes.bsdf_idx.tolist()):
        if b < 0 or tex_idx[b] < 0:
            continue
        t = tex_idx[b]
        if t_type[t] not in (CHECKERBOARD, BITMAP):
            return refuse('textured BSDF beyond checkerboard / bitmap: '
                          'the kernel takes those two, as the JAX '
                          'package\'s does (ROADMAP B7)')
        if k != RECTANGLE:
            return refuse('texture on a non-rectangle shape: the kernel '
                          'takes uv from a rectangle\'s local coordinates, '
                          'as the JAX package\'s does (ROADMAP B7)')
        if t_type[t] == BITMAP:
            h, w = t_hw[t]
            if h * w > MAX_BMP_TEXELS:
                return refuse(f'bitmap texture {h}x{w} > '
                              f'{MAX_BMP_TEXELS} texels (the JAX '
                              'package\'s cap; ROADMAP A5)')
            used.add(t)
    rows = sum(-(-t_hw[t][0] // 8) * 8 for t in used)
    if rows > MAX_BMP_ROWS:
        return refuse(f'{rows} packed bitmap rows > {MAX_BMP_ROWS} (the '
                      'JAX package\'s cap; ROADMAP A5)')
    return True


# the lobes the kernel takes, and over which it takes one level of blend or
# mask (the JAX kernel's base set)
BASE_BSDFS = {DIFFUSE, CONDUCTOR, ROUGH_CONDUCTOR, DIELECTRIC,
              THIN_DIELECTRIC, PLASTIC, ROUGH_PLASTIC, ROUGH_DIELECTRIC}


def _lobe_types(sd) -> set:
    """The BSDF types on the scene's shapes, a composite's nested lobes
    and the composite's own type among them."""
    b_type = sd.bsdfs.type.tolist()
    n0s, n1s = sd.bsdfs.nested0.tolist(), sd.bsdfs.nested1.tolist()
    out = set()
    for b in set(sd.shapes.bsdf_idx.tolist()) - {-1}:
        out.add(b_type[b])
        for n in (n0s[b], n1s[b]) if b_type[b] in (MASK, BLEND) else ():
            if n >= 0:
                out.add(b_type[n])
    return out


def phase_slack(band, adc: ADCConfig, mimo: bool = False) -> float:
    """Phase error [rad] one coherent connection may carry between two
    float32 evaluations of the same path (the kernel and its plain version,
    or the JAX package): 4 ulps of the longest path whose echo lands in
    the ADC window, over the shortest wavelength.  The phase is 2 pi L /
    lambda, and FMA contraction or another library's rsqrt moves the path
    length L by ulps.  A MIMO channel adds its element's term, the
    difference of two lengths from the first vertex, each shorter than
    that path and each rounded from a vertex that moved by ulps: as much
    again."""
    l_max = band.c * (adc.sampling_start + adc.sampling_time)
    one = 2 * np.pi * 4 * float(np.spacing(np.float32(l_max))) \
        / band.wavelength_min
    return 2 * one if mimo else one


def coord_slack(adc: ADCConfig) -> float:
    """Share of a contribution by which a tent tap may move between two
    float32 evaluations of one path (the kernel and its plain version): 4
    ulps of the latest receive time in the ADC window over a time bin,
    plus 4 ulps of the highest frequency over a frequency bin on a time x
    frequency grid (a 2-D tap's weight is the product of the two).  On a
    sparse grid, whose cells hold a few lanes' taps, that moves a cell by
    more than 1e-4 of the largest one."""
    t_end = np.float32(adc.sampling_start + adc.sampling_time)
    s = 4 * float(np.spacing(t_end)) * adc.n_time / adc.sampling_time
    if adc.n_freq > 1:
        f_max = np.float32(max(abs(adc.freq_lo), abs(adc.freq_hi)))
        s += 4 * float(np.spacing(f_max)) * adc.n_freq \
            / (adc.freq_hi - adc.freq_lo)
    return s


def n_draws(max_depth: int, n_tx: int = 1, lobe_mix: bool = False,
            blend_mix: bool = False) -> int:
    """Uniform rows per lane (the layout stride of injected uniforms): the
    JAX package's count (pallas_receive.py:2893-2899) for `n_tx`
    transmitters: eight head rows (the time, frequency and ray draws),
    then per depth the direct-hit draw, three per transmitter, two bounce
    draws, the lobe pick of plastics and GGX glass (`lobe_mix`) and the
    composite pick of blends and masks (`blend_mix`)."""
    return 8 + ((4 if lobe_mix else 3) + (1 if blend_mix else 0)
                + 3 * n_tx) * max_depth


def lobe_draws(lobes: int) -> dict:
    """`n_draws`' lobe_mix and blend_mix of the lobe twins' flags."""
    return dict(lobe_mix=bool(lobes & LOBE_PICK),
                blend_mix=bool(lobes & LOBE_BLEND))


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


def _g1(ct, a2):
    """Smith GGX masking for |cos| ct."""
    t2 = (1.0 - ct * ct) / torch.clamp(ct * ct, min=1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * t2))


def _fres_cond(ci, eta, k):
    """Unpolarized conductor Fresnel (the JAX kernel's _fres_cond)."""
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a_ = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a_ * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rs + rp)


def _ggx_fcos(rb, ab, eb, kk, nx, ny, nz, wix, wiy, wiz, wox, woy, woz):
    """GGX rough-conductor f(wi, wo) |cos_o| in the frame flipped toward
    wi (the GGX branch of the JAX kernel's bsdf_eval_cos)."""
    ci_raw = wix * nx + wiy * ny + wiz * nz
    sg = _sign(ci_raw)
    fx, fy, fz = nx * sg, ny * sg, nz * sg
    ci = ci_raw * sg
    co = wox * fx + woy * fy + woz * fz
    hx, hy, hz = wix + wox, wiy + woy, wiz + woz
    hn = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    hx, hy, hz = hx * hn, hy * hn, hz * hn
    hc = hx * fx + hy * fy + hz * fz
    hsg = _sign(hc)
    hx, hy, hz, hc = hx * hsg, hy * hsg, hz * hsg, hc * hsg
    a2 = ab * ab
    dd = hc * hc * (a2 - 1.0) + 1.0
    d_ = a2 / torch.clamp(np.pi * dd * dd, min=1e-20)
    g_ = _g1(ci.abs(), a2) * _g1(co.abs(), a2)
    idoth = wix * hx + wiy * hy + wiz * hz
    f_ = _fres_cond(idoth.abs(), eb, kk)
    f_rc = rb * f_ * d_ * g_ / torch.clamp(4.0 * ci, min=1e-8)
    return torch.where((co > 0.0) & (ci > 0.0), f_rc, 0.0)


def _fres_diel_full(ci, eta):
    """Unpolarized dielectric Fresnel for the signed cos_i ci (the JAX
    kernel's _fres_diel, and its inline copies in the dielectric and GGX
    glass bounces): the relative IOR eta from the side ci >= 0, its
    inverse from the other; total internal reflection (cos_t^2 <= 0)
    gives 1.  Returns (F, the relative IOR, cos_t, cos_t^2)."""
    eta_s = torch.clamp(eta, min=1e-6)
    eta_it = torch.where(ci >= 0.0, eta_s, 1.0 / eta_s)
    c2t = 1.0 - (1.0 - ci * ci) / (eta_it * eta_it)
    cos_t = torch.sqrt(torch.clamp(c2t, min=0.0))
    aci = ci.abs()
    rs = (aci - eta_it * cos_t) / torch.clamp(aci + eta_it * cos_t,
                                              min=1e-20)
    rp = (eta_it * aci - cos_t) / torch.clamp(eta_it * aci + cos_t,
                                              min=1e-20)
    return (torch.where(c2t <= 0.0, 1.0, 0.5 * (rs * rs + rp * rp)),
            eta_it, cos_t, c2t)


def _fres_diel(ci, eta):
    return _fres_diel_full(ci, eta)[0]


def _unit(x, y, z):
    n = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * n, y * n, z * n


def _toward(x, y, z, fx, fy, fz):
    """(x, y, z) and its cosine with f, flipped onto f's side."""
    c = x * fx + y * fy + z * fz
    s = _sign(c)
    return x * s, y * s, z * s, c * s


def _rd_fcos_pdf(ci_raw, fx, fy, fz, eb, kk, rb, ab, wi, wo):
    """Rough-dielectric (GGX glass) f(wi, wo) |cos_o| and pdf in the
    frame f flipped toward wi, ci_raw the unflipped cosine (the JAX
    kernel's _rd_fcos_pdf): Walter 2007's reflection and transmission
    microfacet lobes with chi+ sidedness and the 1 / eta^2 radiance
    compression; k carries the transmittance."""
    wix, wiy, wiz = wi
    wox, woy, woz = wo
    sgr = _sign(ci_raw)
    ci = ci_raw.abs()
    co = wox * fx + woy * fy + woz * fz
    same = co > 0.0
    eta_s = torch.clamp(eb, min=1e-6)
    eta_it = torch.where(ci_raw >= 0.0, eta_s, 1.0 / eta_s)
    rhx, rhy, rhz, rhc = _toward(*_unit(wix + wox, wiy + woy, wiz + woz),
                                 fx, fy, fz)
    thx, thy, thz, thc = _toward(*_unit(-(wix + eta_it * wox),
                                        -(wiy + eta_it * woy),
                                        -(wiz + eta_it * woz)), fx, fy, fz)
    hdx = torch.where(same, rhx, thx)
    hdy = torch.where(same, rhy, thy)
    hdz = torch.where(same, rhz, thz)
    hdc = torch.where(same, rhc, thc)
    a2 = ab * ab
    dd = hdc * hdc * (a2 - 1.0) + 1.0
    d_ = a2 / torch.clamp(np.pi * dd * dd, min=1e-20)
    g_ = _g1(ci, a2) * _g1(co.abs(), a2)
    idh = wix * hdx + wiy * hdy + wiz * hdz
    odh = wox * hdx + woy * hdy + woz * hdz
    f_d = _fres_diel(idh * sgr, eb)
    aci = torch.clamp(ci, min=1e-6)
    den_t = idh + eta_it * odh
    jac_t = eta_it * eta_it * odh.abs() / torch.clamp(den_t * den_t,
                                                       min=1e-12)
    f_r = f_d * d_ * g_ / (4.0 * aci) * rb
    f_t = ((1.0 - f_d) * d_ * g_ * idh.abs() * jac_t / aci) \
        / (eta_it * eta_it) * kk
    live = (ci > 1e-6) & (idh > 0.0) & (odh * co > 0.0)
    f_cos = torch.where(live, torch.where(same, f_r, f_t), 0.0)
    pdf_h = d_ * hdc
    pdf = torch.where(same, f_d * pdf_h / torch.clamp(4.0 * odh.abs(),
                                                      min=1e-8),
                      (1.0 - f_d) * pdf_h * jac_t)
    return f_cos, torch.where(live, pdf, 0.0)


def _lobe_fcos(kb, rb, ab, eb, kk, nx, ny, nz, wi, wo, flags: dict):
    """f(wi, wo) |cos_o| of each lane's lobe, dispatched on its type (the
    JAX kernel's bsdf_eval_cos): diffuse, the GGX rough conductor, the
    plastic base (1 - Fi)(1 - Fo) x diffuse, the rough plastic's GGX coat
    with the dielectric Fresnel, GGX glass (`_rd_fcos_pdf`), and 0 for the
    delta lobes (mirror, smooth and thin dielectric); `flags` the table's
    static lobe flags (ggx, mirror, diel, thin, plas, rplas, rdiel)."""
    wix, wiy, wiz = wi
    wox, woy, woz = wo
    ci_raw = wix * nx + wiy * ny + wiz * nz
    sg = _sign(ci_raw)
    fx, fy, fz = nx * sg, ny * sg, nz * sg
    ci = ci_raw * sg
    co = wox * fx + woy * fy + woz * fz
    f_d = rb * (1.0 / np.pi) * torch.clamp(co, min=0.0)
    if flags['plas'] or flags['rplas']:
        f_pl = f_d * (1.0 - _fres_diel(ci, eb)) * (1.0 - _fres_diel(co, eb))
    out = f_d
    if flags['ggx']:
        hx, hy, hz, hc = _toward(*_unit(wix + wox, wiy + woy, wiz + woz),
                                 fx, fy, fz)
        a2 = ab * ab
        dd = hc * hc * (a2 - 1.0) + 1.0
        d_ = a2 / torch.clamp(np.pi * dd * dd, min=1e-20)
        g_ = _g1(ci.abs(), a2) * _g1(co.abs(), a2)
        idoth = wix * hx + wiy * hy + wiz * hz
        both = (co > 0.0) & (ci > 0.0)
        f_rc = rb * _fres_cond(idoth.abs(), eb, kk) * d_ * g_ \
            / torch.clamp(4.0 * ci, min=1e-8)
        out = torch.where(kb == float(ROUGH_CONDUCTOR),
                          torch.where(both, f_rc, 0.0), out)
    if flags['plas']:
        out = torch.where(kb == float(PLASTIC), f_pl, out)
    if flags['rplas']:
        coat = _fres_diel(idoth.abs(), eb) * d_ * g_ \
            / torch.clamp(4.0 * ci, min=1e-8)
        out = torch.where(kb == float(ROUGH_PLASTIC),
                          f_pl + torch.where(both, coat, 0.0), out)
    if flags['rdiel']:
        f_rd, _ = _rd_fcos_pdf(ci_raw, fx, fy, fz, eb, kk, rb, ab, wi, wo)
        out = torch.where(kb == float(ROUGH_DIELECTRIC), f_rd, out)
    for key, code in (('mirror', CONDUCTOR), ('diel', DIELECTRIC),
                      ('thin', THIN_DIELECTRIC)):
        if flags[key]:
            out = torch.where(kb == float(code), 0.0, out)
    return out


STAT_KEYS = ('lanes', 'strata', 'freq_draw', 'lo_freq', 'trace', 'hit',
             'direct', 'nee_geom', 'nee', 'ggx_nee', 'occ_tests', 'nee_splat',
             'splat_2d', 'lo_bin', 'phase', 'phase_lo', 'bounce',
             'ggx_bounce', 'mirror_bounce', 'dop_direct', 'dop_nee',
             'dop_bounce', 'walks', 'node_tests', 'leaf_tests', 'mesh_hits',
             'phased_ray', 'mimo_vertex', 'mimo_elem', 'med_seg', 'med_conn',
             'pair_tests', 'pair_terms', 'plas_nee', 'rplas_nee',
             'rdiel_nee', 'blend_nee', 'blend_pick', 'diel_bounce',
             'plas_bounce', 'rplas_bounce', 'rdiel_bounce', 'pass_bounce',
             'pair_sums', 'pair_visits', 'tex_hit', 'sphere_hit',
             'disk_hit', 'cylinder_hit', 'sphere_occ', 'disk_occ',
             'cylinder_occ')
# the incidence cosine below which a hit counts as grazing
# (`receive_megakernel_ref`'s `cond_out`), and the least cosine its error
# model divides by
GRAZE = 0.25
COS_FLOOR = 0.01
# the rounding of a sphere's or cylinder's root, in u, beyond which a hit
# carries it in `cond_out` in place of the 1 u of any hit, and counts as
# ill-conditioned: three times that 1 u, which with the phase slack's own
# absorbs the kernel's roots below it (a distant small sphere's
# discriminant cancels most: golden config 2's sonar sphere)
CURVED_ROOT_U = 3.0
# the prims twins' counts: closest hits on each kind beyond the rectangle,
# and the shadow tests of such blockers ('occ_tests' counts every one)
HIT_KEY = {SPHERE: 'sphere_hit', DISK: 'disk_hit', CYLINDER: 'cylinder_hit'}
OCC_KEY = {SPHERE: 'sphere_occ', DISK: 'disk_occ', CYLINDER: 'cylinder_occ'}

# the endpoint kernels' footprint index (csrc epx_header / epx_build):
# cells an axis
EPX_CELLS = 64


def pair_index(row, n_k: int, sn, tn, orig, reach):
    """The footprint index the analytic endpoint kernels build for a
    phased array of pair row `row` (the element half-widths, then n_k x
    (mid_s, mid_t, base_s, base_t, psi, valid)), frame `sn`, `tn`, centre
    `orig` (pair_sum's) and rectangle half-extents summing to `reach`,
    rounded as csrc/receive_megakernel.cu's epx_header rounds it: None
    where the kernel runs the full loop, else dict(lo, inv, n (cells
    along s and t), mask (2, EPX_CELLS, n_k) bool: the pairs each cell
    visits, plim: the point bound), with `sn`, `tn`, `orig`."""
    f = np.float32
    if isinstance(row, torch.Tensor):
        row = row.detach().cpu().numpy()
    row = np.asarray(row, np.float32)
    sn, tn, orig = (tuple(f(float(v)) for v in x) for x in (sn, tn, orig))
    if n_k == 0:
        return None
    wid_s, wid_t = f(row[0]), f(row[1])
    iws = f(1.0) / max(f(2.0) * wid_s, f(1e-20))
    iwt = f(1.0) / max(f(2.0) * wid_t, f(1e-20))
    w_s, w_t = f(0.5) / iws, f(0.5) / iwt
    pr = row[2:2 + 6 * n_k].reshape(n_k, 6)
    mid = pr[:, 0:2]
    valid = pr[:, 5] != 0.0
    with np.errstate(invalid='ignore', over='ignore'):
        fin = bool(np.isfinite(mid).all())
        ms, mt = (f(np.abs(mid[:, i]).max()) for i in (0, 1))
        o1 = (abs(orig[0]) + abs(orig[1])) + abs(orig[2])
        big = (o1 + ms) + mt
        plim = (o1 + f(4.0) * (((ms + mt) + w_s) + w_t)) + f(4.0) * f(reach)

        def dot(a, b):
            return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]
        ss, tt, st = dot(sn, sn), dot(tn, tn), dot(sn, tn)
        e16, e20 = f(1.0 / 65536.0), f(1.0 / 1048576.0)
        dst = abs(st) + e20
        ext = (((w_s + e16 * ((plim + big) + w_s))
                + f(2.0) * (ms * (abs(ss - f(1.0)) + e20) + mt * dst)),
               ((w_t + e16 * ((plim + big) + w_t))
                + f(2.0) * (mt * (abs(tt - f(1.0)) + e20) + ms * dst)))
        out = dict(sn=sn, tn=tn, orig=orig, plim=plim)
        if not valid.any():
            out.update(n=(0, 0), mask=np.zeros((2, EPX_CELLS, n_k), bool))
            return out
        lo, inv, n = [], [], []
        for a in (0, 1):
            m_a = mid[valid, a]
            lo_a, hi_a = m_a.min() - ext[a], m_a.max() + ext[a]
            lo.append(f(lo_a))
            inv.append(f(EPX_CELLS - 2) / f(hi_a - lo_a))
        if not (fin and all(np.isfinite(x) for x in (plim, *ext, *inv))
                and inv[0] > 0 and inv[1] > 0):
            return None
        mask = np.zeros((2, EPX_CELLS, n_k), bool)
        for a in (0, 1):
            m_a = mid[valid, a]
            hi_a = m_a.max() + ext[a]
            n.append(int(np.floor((f(hi_a) - lo[a]) * inv[a])) + 1)
            ca = np.floor(((mid[:, a] - ext[a]) - lo[a]) * inv[a])
            cb = np.floor(((mid[:, a] + ext[a]) - lo[a]) * inv[a])
            c = np.arange(EPX_CELLS, dtype=np.float32)[:, None]
            mask[a] = (ca <= c) & (c <= cb) & valid \
                & (np.arange(EPX_CELLS) < n[a])[:, None]
    out.update(lo=tuple(lo), inv=tuple(inv), n=tuple(n), mask=mask)
    return out


def pair_visits(ix, n_k: int, px, py, pz):
    """The pairs the endpoint kernels' cross-WDF tests at each point (px,
    py, pz) (float32 tensors) through index `ix` (`pair_index`): those of
    the point's two cells, n_k where the full loop runs (no index, or a
    point past its bound)."""
    if ix is None:
        return torch.full_like(px, n_k, dtype=torch.int64)
    ox, oy, oz = (float(v) for v in ix['orig'])
    ex, ey, ez = px - ox, py - oy, pz - oz
    out = torch.full_like(px, n_k, dtype=torch.int64)
    near = (px.abs() + py.abs()) + pz.abs() <= float(ix['plim'])
    if ix['n'] == (0, 0):
        return torch.where(near, 0, out)
    cells = []
    for a, ax in enumerate((ix['sn'], ix['tn'])):
        q = (ex * float(ax[0]) + ey * float(ax[1])) + ez * float(ax[2])
        cells.append(torch.floor((q - float(ix['lo'][a]))
                                 * float(ix['inv'][a])))
    ok = near & (cells[0] >= 0) & (cells[0] < ix['n'][0]) \
        & (cells[1] >= 0) & (cells[1] < ix['n'][1])
    m = torch.from_numpy(ix['mask']).to(px.device)
    cs = torch.where(ok, cells[0], 0).long()
    ct = torch.where(ok, cells[1], 0).long()
    hits = (m[0][cs] & m[1][ct]).sum(-1)
    return torch.where(ok, hits, torch.where(near, 0, out))


def _frac_cycles(f, t):
    """frac(f t) with a compensated product (f t may be >> 2^24): a
    Dekker split of both factors (the JAX kernel's _frac_cycles)."""
    c_ = f * 4097.0
    fh = c_ - (c_ - f)
    fl = f - fh
    ct = t * 4097.0
    th = ct - (ct - t)
    tl = t - th
    pp = f * t
    err = ((fh * th - pp) + fh * tl + fl * th) + fl * tl
    fr = (pp - torch.floor(pp)) + err
    return fr - torch.floor(fr)


def _h_cyc(w: dict, tm):
    """Small-argument waveform cycles h(tm) = g(tm) - fc_ref tm of waveform
    row `w` (keys wf, text, fc, fext, dfc; the JAX kernel's _h_cyc)."""
    cyc = _frac_cycles(w['dfc'], tm)
    ti = 0.5 * w['text']
    s = w['fext'] / torch.clamp(w['text'], min=1e-12)
    dtc = tm - ti
    extra = _frac_cycles(0.5 * s * dtc, dtc) - _frac_cycles(w['fc'], ti)
    return cyc + torch.where(w['wf'] == LINFMCW, extra, 0.0)


EPS32 = float(np.finfo(np.float32).eps)
ULPS4 = 4.0 * EPS32
# a lobe's branch (a Fresnel pick, total internal reflection, a cosine's
# sign) whose two sides lie within LOBE_TIE of each other: the kernel's
# contracted roundings may take the other side (`ill_out`)
LOBE_TIE = 1e-5


def medium_tau(sp, medium: int, grid=None, ill=None):
    """The kernel's optical depth of a segment, as a function tau(ox, oy,
    oz, dx, dy, dz, length, live) of lane tensors, for the medium packed in
    the params `sp` (None in vacuum), in the JAX kernel's float32
    arithmetic: homogeneous sigma_t length (sp[29]); layered, the closed
    form of the cumulative profile T(z) = c_0 (z - z_min) + sum_i c_i
    relu(z - z_i) from the steps c_i at sp[45:45+K] (`seg_tau`), or
    sigma(z_a) length where |d_z| <= 1e-5; a grid, the 16-point midpoint
    quadrature of its nearest cells, zero outside the box (`seg_tau3`).
    `ill(mask)`, if given, takes the `live` lanes whose evaluation 4 ulps
    of its inputs move by more than 1e-4: layered ones
    whose d_z is below 4 ulps of the two cumulative depths over 1e-4 (the
    closed form divides their difference by d_z), and grid samples whose
    cell coordinate lies within 4 ulps of its inputs of a cell's edge (an
    ulp moves them to the next cell)."""
    if medium == 0:
        return None
    ill = ill or (lambda mask: None)
    if medium == HOMOGENEOUS:
        return lambda ox, oy, oz, dx, dy, dz, ln, live: sp[29] * ln
    if medium == LAYERED:
        k, z0, dz_l = int(sp[42]), sp[43], sp[44]

        def tau_z(z):
            t = sp[45] * (z - z0)
            for i in range(1, k):
                t = t + sp[45 + i] * torch.clamp(z - (z0 + float(i) * dz_l),
                                                 min=0.0)
            return t

        def sigma_z(z):
            s = torch.zeros_like(z) + sp[45]
            for i in range(1, k):
                s = s + sp[45 + i] * torch.where(
                    z >= z0 + float(i) * dz_l, 1.0, 0.0)
            return s

        def layered(ox, oy, oz, dx, dy, dz, ln, live):
            steep = dz.abs() > 1e-5
            t_b, t_a = tau_z(oz + dz * ln), tau_z(oz)
            ill(live & steep & (
                ULPS4 * (t_a.abs() + t_b.abs()) > 1e-4 * dz.abs()))
            dtau = (t_b - t_a) / torch.where(steep, dz, 1.0)
            return torch.where(steep, dtau, sigma_z(oz) * ln)
        return layered
    if medium != GRID or grid is None or grid.dim() != 3:
        raise ValueError(f'medium {medium}: 1 homogeneous, 2 layered or 3 a '
                         'grid with its (D, H, W) cells')
    g_d, g_h, g_w = (int(x) for x in grid.shape)
    cells = grid.reshape(g_d * g_h, g_w)

    def near_edge(c, a, s, inv, n):
        # c = (a + s t - box_min) inv n, its inputs moved by 4 ulps
        tol = ULPS4 * ((a.abs() + s.abs()) * inv * n + c.abs())
        return (c - torch.round(c)).abs() <= tol

    def grid3(ax, ay, az, dx, dy, dz, ln, live):
        tot = torch.zeros_like(ln)
        for k in range(16):
            tk = (k + 0.5) * (1.0 / 16)
            qx = (ax + dx * ln * tk - sp[43]) * sp[46]
            qy = (ay + dy * ln * tk - sp[44]) * sp[47]
            qz = (az + dz * ln * tk - sp[45]) * sp[48]
            inside = ((qx >= 0.0) & (qx <= 1.0) & (qy >= 0.0) & (qy <= 1.0)
                      & (qz >= 0.0) & (qz <= 1.0))
            cx, cy, cz = qx * float(g_w), qy * float(g_h), qz * float(g_d)
            ill(live & inside & (
                near_edge(cx, ax, dx * ln, sp[46], g_w)
                | near_edge(cy, ay, dy * ln, sp[47], g_h)
                | near_edge(cz, az, dz * ln, sp[48], g_d)))
            ix = torch.clamp(torch.floor(cx), max=g_w - 1.0)
            iy = torch.clamp(torch.floor(cy), max=g_h - 1.0)
            iz = torch.clamp(torch.floor(cz), max=g_d - 1.0)
            row = iz * float(g_h) + iy
            sv = cells[torch.clamp(torch.where(inside, row, 0.0), 0.0,
                                   g_d * g_h - 1.0).long(),
                       torch.clamp(torch.where(inside, ix, 0.0), 0.0,
                                   g_w - 1.0).long()]
            tot = tot + torch.where(inside, sv, 0.0)
        return tot * ln * (1.0 / 16)
    return grid3


def _pair_sum(row, n_k: int, sn, tn, orig, px, py, pz, dex, dey, dez, lam,
              count=None, live=None, visit=None, reach=None):
    """A phased array's cross-WDF gain at points (px, py, pz) toward (dex,
    dey, dez) at wavelength lam (the JAX kernel's `_pair_sum`): over its
    pair row `row` (the element half-widths, then per pair (mid_s, mid_t,
    base_s, base_t, psi, valid) along the unit in-plane axes sn, tn from
    the array centre orig), in ascending pair order, each pair's element
    rectangle WDF inside its footprint times fast_cos of its interference
    phase.  `count(inside, live)` takes each pair's lanes inside its
    footprint, of the lanes `live` (None: all) on which the kernel
    evaluates the sum; `visit(pairs, live)` each lane's count of the pairs
    the endpoint kernels' index tests (`pair_visits`, the rectangle's
    half-extents summing to `reach`)."""
    if visit is not None:
        visit(pair_visits(pair_index(row, n_k, sn, tn, orig, reach), n_k,
                          px, py, pz), live)
    snx, sny, snz = sn
    tnx, tny, tnz = tn
    oxp, oyp, ozp = orig
    nu_x = (dex * snx + dey * sny + dez * snz) / lam
    nu_y = (dex * tnx + dey * tny + dez * tnz) / lam
    wid_s, wid_t = row[0], row[1]
    iws = 1.0 / torch.clamp(2.0 * wid_s, min=1e-20)
    iwt = 1.0 / torch.clamp(2.0 * wid_t, min=1e-20)
    total = torch.zeros_like(px)
    for k in range(n_k):
        mid_s, mid_t, base_s, base_t, psi_k, val_k = row[2 + 6 * k:8 + 6 * k]
        mx = oxp + mid_s * snx + mid_t * tnx
        my = oyp + mid_s * sny + mid_t * tny
        mz = ozp + mid_s * snz + mid_t * tnz
        rlx, rly, rlz = px - mx, py - my, pz - mz
        rx_ = (rlx * snx + rly * sny + rlz * snz) * iws
        ry_ = (rlx * tnx + rly * tny + rlz * tnz) * iwt
        inside = (rx_.abs() <= 0.5) & (ry_.abs() <= 0.5)
        if count is not None:
            count(inside & (val_k != 0.0), live)
        txr, tyr = _tri(rx_), _tri(ry_)
        w_rect = (4.0 * wid_s * wid_t * txr * tyr
                  * _sinc(TWO_PI * nu_x * wid_s * txr)
                  * _sinc(TWO_PI * nu_y * wid_t * tyr))
        ph_k = TWO_PI * (nu_x * base_s + nu_y * base_t) + psi_k
        total = total + torch.where(inside, w_rect * _fast_cos(ph_k),
                                    0.0) * val_k
    return total


def _tx_rows(txp) -> list:
    """Each transmitter row of `txp` as the fields the kernel reads: its
    to_world rows `m`, half-widths, area, gain, the waveform row (and its
    phase pivots), velocity, kind and unit normal."""
    out = []
    for tr in txp:
        m = [tr[i] for i in range(12)]
        tnn = torch.rsqrt(torch.clamp(
            m[2] * m[2] + m[6] * m[6] + m[10] * m[10], min=1e-20))
        out.append(dict(m=m, wx=tr[12], wy=tr[13], area=tr[14], gain=tr[15],
                        wf=tr[16], amp=tr[17], prf=tr[18], text=tr[19],
                        fc=tr[20], fext=tr[21], fcpri=tr[22], dfc=tr[23],
                        vel=tr[24:27], kind=int(tr[27]), phi0=tr[28],
                        n=(m[2] * tnn, m[6] * tnn, m[10] * tnn)))
    return out


def receive_megakernel_ref(params, prim, txp, uniforms, *, adc: ADCConfig,
                           max_depth: int, time_sampling: str, rx_kind: str,
                           mesh: PackedBVH | None = None, msh=None,
                           doppler: bool = False, patch_p: int = 0,
                           lane0: int = 0, stats: dict | None = None,
                           lane_out=None, receive_type: str = 'raw',
                           has_lo: bool = False, coherent: bool = False,
                           amp_out=None, mirror: bool | None = None,
                           rxph=None, eoff=None, medium: int = 0, grid=None,
                           ill_out=None, php=None, lobes: int | None = None,
                           tex=None, bmp_meta=None, cond_out=None):
    """Plain version of the kernel, in every configuration.  Returns (acc
    (n_time, n_freq) float32, n_events 0-d int64): the tent-splatted power
    and the count of nonzero contributions; with `coherent` acc is
    (n_time, n_freq, 2), the tent-splatted I and Q.

    `mesh`: the BVH tables of a mesh scene (stride 96; `pack_scene`), on
    the uniforms' device; `msh` its (n_mesh_shapes, 8) mesh-shape rows
    [vel(3), alpha, eta, k, type, 0] (None: diffuse, static).  `patch_p`
    > 0 stratifies the Wigner receive directions over patch_p^2 cells per
    1024-lane tile; the first lane is lane `lane0` of the call (tiles
    count from lane 0).  `lane_out`, if given, receives each lane's
    contribution sum (n_lanes,) float32.

    `doppler` runs the Doppler configuration: there velocities (prim
    columns 19-21, transmitter 24-26, receiver params 23-25, `msh` 0-2)
    switch the Doppler chain on and a ROUGH_CONDUCTOR type (prim column
    18, `msh` column 6) the GGX lobe, as the JAX kernel's static `moving`
    and `ggx` flags do; a static diffuse scene comes out as in the
    flagship and mesh configurations, which read neither (nor `msh`).
    There a CONDUCTOR type is a smooth conductor, a delta mirror: the
    bounce reflects specularly with the conductor's Fresnel weight, no NEE
    leaves it, and the lane it continued counts a direct transmitter hit
    at the next vertex (the JAX kernel's `mirror` flag).  `mirror` says
    whether the tables hold one (None: read them).
    `n_freq > 1` draws the receive frequency and splats over time x
    frequency.  `receive_type` and `has_lo` (the receiver has an LO
    waveform, packed at params[33:42]) pick the receive-frequency rule
    (`rx_rule`; anything but RX_RAW needs `doppler`).  `coherent` (with
    `doppler`) splats sqrt(max(power, 0)) times (cos, sin) of the echo
    phase; `amp_out`, a (n_time, n_freq) float64 tensor, then receives
    the same splat with every phase 0 (the per-cell sum of amplitudes
    that scales a phase error).  In power mode `amp_out` receives, per
    cell, the sum of |power| of the contributions whose taps reach it,
    whatever the tap's weight (a tap moved by `coord_slack` of a bin
    changes the cell by up to that share of it).

    `eoff` (E, 3), the world offsets of a phased array's elements from its
    origin, runs the MIMO configuration (with `doppler`, rx_kind
    'phased', `rxph` the packed receiver row, n_freq == 1): the rays
    leave the array's origin over the cosine hemisphere about its normal,
    weighted by one element's pattern (half-widths rxph[0, 0:2]); the
    first vertex x1 of the lane anchors each element's path difference
    dd_e = |x1 - o - r_e| - |x1 - o|, and every connection splats
    sqrt(max(power, 0)) (cos, sin) of its echo phase less 2 pi (f / c)
    dd_e into channels (2e, 2e + 1) of a (n_time, 1, 2E) grid; `amp_out`
    takes the amplitude sums as in the coherent configuration.

    `medium` (media.HOMOGENEOUS, LAYERED or GRID; 0 vacuum) runs any
    configuration through the ambient medium packed in `params`
    (`pack_medium`), the (D, H, W) sigma cells `grid` for GRID: every
    segment a live lane crosses multiplies its throughput, and every NEE
    connection its value, by exp(-tau) (`medium_tau`).  It takes no
    draws.  `ill_out`, if given, an (n_lanes,) bool tensor, is set on
    every lane with an optical depth that an ulp of its inputs moves by
    more than 1e-4 (see `medium_tau`): such a lane may differ from the
    kernel's, whose inputs FMA contraction moves by ulps, by more than
    1e-4 of itself.

    The endpoint configuration: `txp` (n_tx, 32) rows of up to MAX_TX
    transmitters of mixed kinds (txp[:, 27]: Wigner, phased or area),
    each with its direct hits and its own NEE (its draws, its shadow test,
    which its own rectangle never blocks, and its phase pivots); a phased
    transmitter's cross-WDF (`_pair_sum`) over its row of `php` (n_tx, 2
    + 6K).  rx_kind 'phased' without `eoff` is an
    analog phased receiver: the ray leaves a point uniform over the
    array's bounding rectangle (half-extents params[30:32]) over the
    cosine hemisphere, weighted by the array's cross-WDF over `rxph` (1,
    2 + 6K_rx).

    `stats`, if given, accumulates how many lanes reach each stage of the
    kernel (the work a run's data needs), each summed over depths: keys
    'lanes', 'strata' (lanes with stratified directions), 'freq_draw',
    'lo_freq' (receive frequencies read off a waveform), 'trace', 'hit',
    'direct', 'nee_geom', 'nee' (of which 'ggx_nee' with the GGX lobe),
    'occ_tests', 'nee_splat', 'splat_2d' (contributions splatted over time
    x frequency), 'lo_bin' (of those, binned at a beat), 'phase' (echo
    phases of coherent contributions), 'phase_lo' (of those, with the
    receive-side fold of a mix or LO dechirp), 'bounce' (diffuse),
    'ggx_bounce', 'dop_direct', 'dop_nee', 'dop_bounce' (Doppler factors
    of a moving scene); with a mesh also 'walks', 'node_tests',
    'leaf_tests' (BVH walks, slab tests, leaves entered) and 'mesh_hits'
    (closest hits on a triangle); in the MIMO configuration 'phased_ray'
    (rays from the array), 'mimo_vertex' (lanes whose first vertex
    anchors the element terms) and 'mimo_elem' (element channels of the
    contributions splatted); through a medium 'med_seg' and 'med_conn'
    (optical depths of segments and of connections); 'pair_tests' and
    'pair_terms' (phased pair terms evaluated, and of those inside their
    footprint), with 'phased_ray' also for an analog phased receiver's
    rays; 'tex_hit' (closest hits on a textured rectangle); 'sphere_hit',
    'disk_hit', 'cylinder_hit' (closest hits on those prims) and
    'sphere_occ', 'disk_occ', 'cylinder_occ' (their shadow tests, among
    'occ_tests').

    `tex` (R, Wp) float32 and `bmp_meta` (n_prims, 3) int32, the texel
    rows of `pack_scene`, feed the rectangles whose prim rows carry a
    texture (column 26: 1 a checkerboard, colours at 22 and 23; 2 a
    bitmap; its uv scale at 24 and 25): the hit rectangle's reflectance
    times the texture at its local uv = (p + 1) / 2, in the JAX kernel's
    arithmetic (the texture twins).

    `cond_out`, a (n_time, n_freq) float64 tensor (with `coherent`),
    receives the splat of amp x G of the connections whose phase is
    ill-conditioned: those from a grazing hit (incidence cosine below
    GRAZE) or a curved one whose root's rounding exceeds CURVED_ROOT_U u,
    and all made after one, and those made after a bounce off a sphere or
    cylinder.  G bounds, in units of the phase slack's path
    error u (4 ulps of the longest path), how far two float32 evaluations
    may move the connection's path, to first order: a hit reached along
    a ray whose origin is g_prev u off and whose direction is th u / m
    off lies (g_prev + th t + 1) u / cos off along the surface (cos its
    incidence cosine, at least COS_FLOOR; the 1 u the root's rounding dt
    where that exceeds CURVED_ROOT_U u); a bounce off a sphere or
    cylinder of curvature k turns the normal by k g u, and so the next
    ray by 2 k g u more; each vertex moves the path by at most twice its
    own error, so G = 2 sum_i g_i over the lane's vertices so far.  The
    connection's phase then stays within (1 + G) x `phase_slack`."""
    rule = rx_rule(receive_type, has_lo)
    mimo = eoff is not None
    if mimo and (rx_kind != 'phased' or coherent or not doppler):
        raise ValueError("MIMO (eoff) is its own accumulation mode of the "
                         "Doppler configuration: doppler=True, rx_kind "
                         "'phased', coherent=False")
    if rx_kind == 'phased' and rxph is None:
        raise ValueError("rx_kind 'phased' needs the receiver's pair row "
                         'rxph')
    coherent = coherent or mimo
    if (rule != RX_RAW or coherent) and not doppler:
        raise ValueError('LO receive types and coherent I / Q run in the '
                         'Doppler configuration (doppler=True)')
    counts = {k: 0 for k in STAT_KEYS}

    def count(key, mask):
        if stats is not None:
            counts[key] += int(mask.sum())
    dev = uniforms.device
    n_lanes = int(uniforms.shape[1])
    gate = time_sampling == 'gate'
    n_time, n_freq = adc.n_time, adc.n_freq
    grid2d = n_freq > 1

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    t_start, t_window = c(adc.sampling_start), c(adc.sampling_time)
    n_time_f, n_freq_f = c(float(n_time)), c(float(n_freq))
    f_lo, f_span = c(adc.freq_lo), c(adc.freq_hi - adc.freq_lo)
    f_den = c(max(adc.freq_hi - adc.freq_lo, 1e-30))
    rows = iter(uniforms)

    def draw():
        return next(rows)

    sp = params
    cvel = sp[1]
    rxm = [sp[2 + i] for i in range(12)]
    rx_wx, rx_wy = sp[14], sp[15]
    # the transmitters' rows (waveform rows with their phase pivots) and
    # the LO's
    txs = _tx_rows(txp)
    n_pairs = (int(php.shape[1]) - 2) // 6 if php is not None else 0
    if any(w['kind'] == PHASED for w in txs) and php is None:
        raise ValueError('a phased transmitter needs its pair rows php')
    pair_count = pair_visit = None
    if stats is not None:
        def pair_count(inside, live):
            if live is None:
                counts['pair_tests'] += int(inside.numel())
                counts['pair_terms'] += int(inside.sum())
            else:
                counts['pair_tests'] += int(live.sum())
                counts['pair_terms'] += int((inside & live).sum())

        def pair_visit(pairs, live):
            if live is None:
                counts['pair_sums'] += int(pairs.numel())
                counts['pair_visits'] += int(pairs.sum())
            else:
                counts['pair_sums'] += int(live.sum())
                counts['pair_visits'] += int(pairs[live].sum())
    lo_w = dict(wf=sp[33], prf=sp[35], text=sp[36], fc=sp[37], fext=sp[38],
                fcpri=sp[39], dfc=sp[40], phi0=sp[41])
    # the analytic prims in row order, each with its kind (the prims
    # twins' spheres, disks and cylinders beside the rectangles)
    prim_ids = [p for p in range(prim.shape[0])
                if int(prim[p, 0]) in ANALYTIC]
    prims = [prim[p] for p in prim_ids]
    kinds = [int(prim[p, 0]) for p in prim_ids]
    # the texture twins' codes of the rectangles (1 checkerboard, 2 bitmap)
    tex_code = [int(prim[p, 26]) for p in prim_ids]
    if 2 in tex_code and (tex is None or bmp_meta is None):
        raise ValueError('a bitmap rectangle needs the texel rows `tex` and '
                         'their `bmp_meta`')
    # transmitter t's own rectangle (t in column 14) never occludes its
    # NEE; other geometry, the other transmitters' rectangles included, does
    blockers = [[(k, row) for k, row in zip(kinds, prims)
                 if float(row[14]) != float(t)] for t in range(len(txs))]
    rows_m = msh if doppler and mesh is not None else None
    # the JAX kernel's static flags, read from the tables
    moving = doppler and bool(
        (prim[:, 19:22] != 0).any() or (txp[:, 24:27] != 0).any()
        or (sp[23:26] != 0).any()
        or (rows_m is not None and (rows_m[:, 0:3] != 0).any()))
    ggx = doppler and bool(
        (prim[:, 18:29:10] == ROUGH_CONDUCTOR).any()
        or (rows_m is not None and (rows_m[:, 6] == ROUGH_CONDUCTOR).any()))
    mirror = doppler and (has_mirror(prim, rows_m) if mirror is None
                          else mirror)
    # the lobe twins' flags (LOBE_*), the JAX kernel's static lobe flags
    lob = (lobe_flags(prim, rows_m) if lobes is None else lobes) \
        if doppler else 0
    fl = dict(ggx=ggx or bool(lob & (LOBE_RPLAS | LOBE_RDIEL)),
              mirror=mirror, diel=bool(lob & LOBE_DIEL),
              thin=bool(lob & LOBE_THIN), plas=bool(lob & LOBE_PLAS),
              rplas=bool(lob & LOBE_RPLAS), rdiel=bool(lob & LOBE_RDIEL))
    ggx = fl['ggx']
    blend, mask = bool(lob & LOBE_BLEND), bool(lob & LOBE_MASK)
    # direct hits after a delta bounce (the JAX kernel's `delta_any`), and
    # continuations that may leave through the back face
    delta_any = mirror or fl['diel'] or fl['thin']
    back_face = bool(lob & (LOBE_DIEL | LOBE_THIN | LOBE_RDIEL | LOBE_MASK))
    read_lobe = ggx or mirror or bool(lob)   # the hit's type, alpha, eta, k
    mark = None if ill_out is None else ill_out.logical_or_
    tau = medium_tau(sp, medium, grid, None if ill_out is None
                     else ill_out.logical_or_)

    def inst_freq(t, w):
        pri = 1.0 / torch.clamp(w['prf'], min=1e-12)
        tm = _mod(t, pri)
        ti = 0.5 * w['text']
        fi = w['fc'] + (w['fext'] / torch.clamp(w['text'], min=1e-12)) \
            * (tm - ti)
        return torch.where(w['wf'] == LINFMCW, fi, w['fc'])

    def eval_wdf(w, t, f):
        prf, text, amp = w['prf'], w['text'], w['amp']
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        tm = _mod(t, pri)
        ti = 0.5 * text
        fi = inst_freq(t, w)
        x = (tm - ti) / torch.clamp(text, min=1e-12)
        tw = _tri(x)
        v = 2.0 * amp * amp * text * tw * _sinc(TWO_PI * (f - fi) * text * tw)
        v = torch.where(x.abs() < 0.5, v, 0.0)
        return torch.where(w['wf'] == CW, amp * amp, v)

    def emission(w, tau, u, t_rx0):
        """(t_emit, t_recv, gate weight, whole PRIs the receive time was
        moved by) of a path of delay `tau` from transmitter row `w`."""
        if not gate:
            return t_rx0 - tau, t_rx0, 1.0, 0.0
        prf = w['prf']
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        is_cw = w['wf'] == CW
        sup = torch.where(is_cw, t_window, w['text'])
        t_emit = torch.where(is_cw, t_start - tau, 0.0) + u * sup
        t_recv = tau + t_emit
        k = torch.ceil((t_start - t_recv) * prf)
        k = torch.where(is_cw, 0.0, torch.clamp(k, min=0.0))
        return t_emit, t_recv + k * pri, sup / t_window, k

    def echo_phase(tx_w, dtot, t_emit, t_recv, k_pri):
        """Baseband phase [rad] of a connection of path length dtot from
        transmitter row `tx_w` (the JAX kernel's echo_phase): the
        transmitter's waveform cycles at emission less the fc_ref cycles of
        the delay, less the receive side's (the transmitter's chirp under
        mix_resample, else the LO's dechirp, its fold rebuilt from the
        delay when matched)."""
        prf = tx_w['prf']
        pri = 1.0 / torch.clamp(prf, min=1e-12)
        m_e = torch.floor(t_emit * prf)
        tm_e = t_emit - m_e * pri
        ct = _frac_cycles(sp[17], dtot) + dtot * sp[18]
        cyc = tx_w['phi0'] * (1.0 / TWO_PI) + _h_cyc(tx_w, tm_e) \
            - (ct - torch.floor(ct)) - (m_e + k_pri) * tx_w['fcpri']
        if rule == RX_MIX:
            m_r = torch.floor(t_recv * prf)
            jj = m_r - m_e - k_pri
            tm_r = tm_e + dtot / cvel - jj * pri
            cyc = cyc - tx_w['phi0'] * (1.0 / TWO_PI) - _h_cyc(tx_w, tm_r) \
                + m_r * tx_w['fcpri']
        elif has_lo:
            pri_lo = 1.0 / torch.clamp(lo_w['prf'], min=1e-12)
            m_r = torch.floor(t_recv * lo_w['prf'])
            tm_r0 = t_recv - m_r * pri_lo
            tau = dtot / cvel
            jr = (tau + tm_e - tm_r0) * lo_w['prf']
            jj = torch.round(jr)
            tm_hp = tm_e + tau - jj * pri_lo
            tm_r = torch.where((jr - jj).abs() < 1e-3, tm_hp, tm_r0)
            cyc = cyc - lo_w['phi0'] * (1.0 / TWO_PI) - _h_cyc(lo_w, tm_r) \
                + m_r * lo_w['fcpri']
        return TWO_PI * (cyc - torch.floor(cyc))

    def bin_freq(w, f_recv, t_recv):
        """The frequency a contribution from transmitter row `w` is binned
        at: the beat under mix_resample and mixer, else the received
        frequency."""
        if rule == RX_MIX:
            return (f_recv - inst_freq(t_recv, w)).abs()
        if rule == RX_MIXER:
            return inst_freq(t_recv, lo_w) - f_recv
        return f_recv

    def tx_aperture(t, lx, ly, px, py, pz, ex, ey, ez, lam, live):
        """Aperture weight of transmitter t for radiation leaving its point
        p = (px, py, pz), local (lx, ly) in [-1, 1]^2, along (ex, ey, ez):
        the rect Wigner weight, the phased cross-WDF or 1 (area); `live`
        the lanes the kernel evaluates it on (the stage counts)."""
        w = txs[t]
        m, wx, wy = w['m'], w['wx'], w['wy']
        if w['kind'] == AREA:
            return torch.ones_like(lx)
        if w['kind'] == PHASED:
            iwx = 1.0 / torch.clamp(wx, min=1e-20)
            iwy = 1.0 / torch.clamp(wy, min=1e-20)
            return _pair_sum(php[t], n_pairs,
                             (m[0] * iwx, m[4] * iwx, m[8] * iwx),
                             (m[1] * iwy, m[5] * iwy, m[9] * iwy),
                             (m[3], m[7], m[11]), px, py, pz, -ex, -ey, -ez,
                             lam, pair_count, live, pair_visit,
                             float(wx.abs() + wy.abs()))
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
    # the receive frequency by receive type, read at mid-window under gate
    # sampling
    t_mid = t_rx0 + (0.5 * t_window if gate else 0.0)
    if rule != RX_RAW:
        counts['lo_freq'] += n_lanes
    if rule == RX_MIX:
        f_rx = inst_freq(t_mid, txs[0])
    elif rule == RX_MIXER:
        counts['freq_draw'] += n_lanes
        f_rx = inst_freq(t_mid, lo_w) - (f_lo + draw() * f_span)
    elif rule == RX_RAW_LO:
        f_rx = inst_freq(t_mid, lo_w)
    elif grid2d:
        counts['freq_draw'] += n_lanes
        f_rx = f_lo + draw() * f_span
    else:
        f_rx = c(0.5 * (adc.freq_lo + adc.freq_hi))
    if rx_kind == 'phased':
        # a point uniform over the array's bounding rectangle; MIMO draws
        # it and does not use it: its rays leave the array's origin.  The
        # cosine hemisphere about the array's normal, weighted by one
        # element's pattern (MIMO) or by the array's cross-WDF (analog)
        counts['phased_ray'] += n_lanes
        u1, u2 = draw(), draw()
        iwxr = 1.0 / torch.clamp(rx_wx, min=1e-20)
        iwyr = 1.0 / torch.clamp(rx_wy, min=1e-20)
        snx, sny, snz = rxm[0] * iwxr, rxm[4] * iwxr, rxm[8] * iwxr
        tnx_, tny_, tnz_ = rxm[1] * iwyr, rxm[5] * iwyr, rxm[9] * iwyr
        if mimo:
            ox = rxm[3].expand(n_lanes)
            oy = rxm[7].expand(n_lanes)
            oz = rxm[11].expand(n_lanes)
        else:
            lxr = (2.0 * u1 - 1.0) * sp[30]
            lyr = (2.0 * u2 - 1.0) * sp[31]
            ox = rxm[3] + lxr * snx + lyr * tnx_
            oy = rxm[7] + lxr * sny + lyr * tny_
            oz = rxm[11] + lxr * snz + lyr * tnz_
        nzx, nzy, nzz = rxm[2], rxm[6], rxm[10]
        nn = torch.rsqrt(nzx * nzx + nzy * nzy + nzz * nzz)
        nzx, nzy, nzz = nzx * nn, nzy * nn, nzz * nn
        u3, u4 = draw(), draw()
        rr = torch.sqrt(u3)
        ph = TWO_PI * u4
        tx_, ty_ = rr * _fast_cos(ph), rr * _fast_sin(ph)
        tz_ = torch.sqrt(torch.clamp(1.0 - u3, min=0.0))
        sign = _sign(nzz)
        a = -1.0 / (sign + nzz)
        b = nzx * nzy * a
        s1x, s1y, s1z = 1.0 + sign * nzx * nzx * a, sign * b, -sign * nzx
        s2x, s2y, s2z = b, sign + nzy * nzy * a, -nzy
        dx = s1x * tx_ + s2x * ty_ + nzx * tz_
        dy = s1y * tx_ + s2y * ty_ + nzy * tz_
        dz = s1z * tx_ + s2z * ty_ + nzz * tz_
        lam_rx = cvel / torch.clamp(f_rx, min=1e-6)
        if mimo:
            wex, wey = rxph[0, 0], rxph[0, 1]
            nu_ex = (dx * snx + dy * sny + dz * snz) / lam_rx
            nu_ey = (dx * tnx_ + dy * tny_ + dz * tnz_) / lam_rx
            throughput = c(np.pi * 16.0) * wex * wey \
                * _sinc(TWO_PI * nu_ex * wex) * _sinc(TWO_PI * nu_ey * wey) \
                * sp[32]
        else:
            w0 = c(np.pi * 4.0) * sp[30] * sp[31] * sp[32]
        ox = ox + 1e-4 * nzx
        oy = oy + 1e-4 * nzy
        oz = oz + 1e-4 * nzz
        if not mimo:
            # the receiver's cross-WDF at the ray (signed)
            throughput = w0 * _pair_sum(
                rxph[0], (int(rxph.shape[1]) - 2) // 6, (snx, sny, snz),
                (tnx_, tny_, tnz_), (rxm[3], rxm[7], rxm[11]), ox, oy, oz,
                dx, dy, dz, lam_rx, pair_count, None, pair_visit,
                float(sp[30].abs() + sp[31].abs()))
    elif rx_kind == 'omni':
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

    # cumulative Doppler factor (f_received = f_emitted * dop), the
    # receiver's motion first
    dop = (1.0 + (dx * sp[23] + dy * sp[24] + dz * sp[25]) / cvel
           if moving else None)

    # float64 sums: the plain version is the accurate side of the
    # comparison (each contribution is still computed in float32)
    n_elem = int(eoff.shape[0]) if mimo else 0
    n_ch = 2 * n_elem if mimo else (2 if coherent else 1)
    elem_dd = None     # (E, n_lanes) element path differences (MIMO)
    acc = torch.zeros(n_ch, n_time * n_freq, dtype=torch.float64,
                      device=dev)
    n_events = torch.zeros((), dtype=torch.int64, device=dev)

    lane_sum = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    amp_flat = None if amp_out is None else amp_out.view(-1)
    cond_flat = None if cond_out is None else cond_out.view(-1)
    if cond_out is not None and not coherent:
        raise ValueError('cond_out: the coherent configuration only')
    # the lanes whose connections' phases are ill-conditioned (`cond_out`):
    # after a grazing hit or a bounce off a sphere or cylinder (`bent`),
    # and at a grazing hit (`bent_now`, this vertex's connections); the
    # current vertex's position error (g_pos u), the ray's direction error
    # (g_dir u / m) and the sum of the vertices' position errors (g_sum u)
    bent = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    bent_now = bent
    g_pos = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    g_dir = torch.zeros_like(g_pos)
    g_sum = torch.zeros_like(g_pos)
    # u in metres: `phase_slack`'s 4 ulps of the longest path
    u_len = None if cond_out is None else 4.0 * float(np.spacing(np.float32(
        float(params[1]) * (adc.sampling_start + adc.sampling_time))))

    def splat(w, val, yb, f_recv, t_recv, ok, ph=None):
        """Tent splat at time coordinate yb (and, on a 2-D grid, at the
        frequency coordinate of the bin frequency of a contribution from
        transmitter row `w`): of the power val, or of sqrt(max(val, 0))
        (cos, sin)(ph) if coherent."""
        nonlocal n_events, lane_sum
        nz = val != 0.0
        n_events = n_events + (ok & nz).sum()
        if coherent:
            count('phase', ok & nz)
            if rule == RX_MIX or has_lo:
                count('phase_lo', ok & nz)
            amp = torch.sqrt(torch.clamp(val, min=0.0))
            if mimo:
                count('mimo_elem', (ok & nz).unsqueeze(0).expand(n_elem, -1))
                kf = TWO_PI * (f_recv / cvel)
                chans = []
                for dd in elem_dd:
                    pe = ph - kf * dd
                    chans += [torch.where(ok, amp * _fast_cos(pe), 0.0),
                              torch.where(ok, amp * _fast_sin(pe), 0.0)]
            else:
                chans = [torch.where(ok, amp * _fast_cos(ph), 0.0),
                         torch.where(ok, amp * _fast_sin(ph), 0.0)]
            lane_sum = lane_sum + torch.where(ok, amp, 0.0)
            if amp_out is not None:
                chans.append(torch.where(ok, amp, 0.0))
            if cond_out is not None:
                chans.append(torch.where(ok & bent_now,
                                         amp * (2.0 * g_sum), 0.0))
        else:
            chans = [val]
            lane_sum = lane_sum + val
            if amp_out is not None:
                chans.append(val.abs())
        b0 = torch.floor(yb)
        if grid2d:
            count('splat_2d', ok & nz)
            if rule in (RX_MIX, RX_MIXER):
                count('lo_bin', ok & nz)
            xb = (bin_freq(w, f_recv, t_recv) - f_lo) / f_den * n_freq_f \
                - 0.5
            f0 = torch.floor(xb)
        for bt in (b0, b0 + 1.0):
            wt = torch.clamp(1.0 - (yb - bt).abs(), min=0.0)
            keep_t = nz & (bt >= 0.0) & (bt < n_time_f)
            it = torch.clamp(bt, 0.0, n_time - 1.0).long()
            if not grid2d:
                taps = [(it, keep_t, wt)]
            else:
                taps = []
                for bf in (f0, f0 + 1.0):
                    wf_ = torch.clamp(1.0 - (xb - bf).abs(), min=0.0)
                    keep = keep_t & (bf >= 0.0) & (bf < n_freq_f)
                    idx = it * n_freq \
                        + torch.clamp(bf, 0.0, n_freq - 1.0).long()
                    taps.append((idx, keep, (wt, wf_)))
            for idx, keep, w in taps:
                for ch, v in enumerate(chans):
                    # power mode's amp_out counts |val| whole at each tap
                    if ch < n_ch or coherent:
                        v = v * w if not grid2d else v * w[0] * w[1]
                    dst = acc[ch] if ch < n_ch else \
                        amp_flat if ch == n_ch else cond_flat
                    dst.index_add_(0, idx[keep], v[keep].double())

    def prim_t(kind, p_row, cx, cy, cz, ddx, ddy, ddz, normal=False):
        """The hit of the ray (c, dd) on one analytic prim, in the JAX
        kernel's arithmetic (pallas_receive.py:697-798; the shadow test's
        roots are the same): t, hit, the local (px, py) of a rectangle and
        with `normal` its unit world normal (a rectangle's or disk's rows
        8-10; M^T (px, py, 0) of a cylinder, M^T p of a sphere) and, for a
        sphere or cylinder, a first-order bound of how far float32
        rounding moves its root t (`dt`; `cond_out`): the discriminant
        b^2 - 4 a c cancels terms of size b^2 + 4 a (|c| + |o|^2), each
        rounded by an ulp, and its square root's error over 2 a moves t
        (sq held at COS_FLOOR |b|, a hit as grazing as COS_FLOOR)."""
        q = [p_row[1 + i] for i in range(12)]
        oox = q[0] * cx + q[1] * cy + q[2] * cz + q[3]
        ooy = q[4] * cx + q[5] * cy + q[6] * cz + q[7]
        ooz = q[8] * cx + q[9] * cy + q[10] * cz + q[11]
        odx = q[0] * ddx + q[1] * ddy + q[2] * ddz
        ody = q[4] * ddx + q[5] * ddy + q[6] * ddz
        odz = q[8] * ddx + q[9] * ddy + q[10] * ddz
        px = py = n = None
        if kind in (RECTANGLE, DISK):
            big = odz.abs() > 1e-12
            t_p = -ooz / torch.where(big, odz, 1e-12)
            px = oox + t_p * odx
            py = ooy + t_p * ody
            hit_p = big & ((px * px + py * py <= 1.0) if kind == DISK
                           else (px.abs() <= 1.0) & (py.abs() <= 1.0))
            if normal:
                rnorm = torch.rsqrt(torch.clamp(
                    q[8] * q[8] + q[9] * q[9] + q[10] * q[10], min=1e-20))
                n = (q[8] * rnorm, q[9] * rnorm, q[10] * rnorm)
            return t_p, hit_p, px, py, n, None
        if kind == CYLINDER:
            a_s = odx * odx + ody * ody
            b_s = 2.0 * (oox * odx + ooy * ody)
            c_s = oox * oox + ooy * ooy - 1.0
            disc = b_s * b_s - 4.0 * a_s * c_s
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            a_sf = torch.where(a_s.abs() > 1e-20, a_s, 1e-20)
            t0 = (-b_s - sq) / (2.0 * a_sf)
            t1 = (-b_s + sq) / (2.0 * a_sf)
            z0 = ooz + t0 * odz
            z1 = ooz + t1 * odz
            v0 = (disc >= 0.0) & (z0 >= 0.0) & (z0 <= 1.0) & (t0 > 0.0)
            v1 = (disc >= 0.0) & (z1 >= 0.0) & (z1 <= 1.0) & (t1 > 0.0)
            t_p = torch.where(v0, t0, t1)
            hit_p = v0 | v1
            if normal:
                cpx = oox + t_p * odx
                cpy = ooy + t_p * ody
                sn = (q[0] * cpx + q[4] * cpy, q[1] * cpx + q[5] * cpy,
                      q[2] * cpx + q[6] * cpy)
        else:
            a_s = odx * odx + ody * ody + odz * odz
            b_s = 2.0 * (oox * odx + ooy * ody + ooz * odz)
            c_s = oox * oox + ooy * ooy + ooz * ooz - 1.0
            disc = b_s * b_s - 4.0 * a_s * c_s
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            qq = -0.5 * (b_s + torch.where(b_s >= 0.0, 1.0, -1.0) * sq)
            t0 = qq / torch.where(a_s.abs() > 1e-20, a_s, 1e-20)
            t1 = c_s / torch.where(qq.abs() > 1e-20, qq, 3.4e38)
            tn = torch.minimum(t0, t1)
            tf = torch.maximum(t0, t1)
            t_p = torch.where(tn > 0.0, tn, tf)
            hit_p = (disc >= 0.0) & (t_p > 0.0)
            if normal:
                spx = oox + t_p * odx
                spy = ooy + t_p * ody
                spz = ooz + t_p * odz
                sn = (q[0] * spx + q[4] * spy + q[8] * spz,
                      q[1] * spx + q[5] * spy + q[9] * spz,
                      q[2] * spx + q[6] * spy + q[10] * spz)
        dt = None
        if normal:
            nn = torch.rsqrt(torch.clamp(sn[0] * sn[0] + sn[1] * sn[1]
                                         + sn[2] * sn[2], min=1e-20))
            n = (sn[0] * nn, sn[1] * nn, sn[2] * nn)
            o2 = c_s + 1.0
            dt = EPS32 * (b_s * b_s + 4.0 * a_s * (c_s.abs() + o2)) / (
                4.0 * torch.clamp(a_s, min=1e-20)
                * torch.maximum(sq, COS_FLOOR * b_s.abs()).clamp(min=1e-20))
        return t_p, hit_p, px, py, n, dt

    cx, cy, cz = ox, oy, oz
    ddx, ddy, ddz = dx, dy, dz
    active = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    wdel = torch.zeros_like(active)   # the last bounce was a mirror
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
        # the hit's lobe (type, GGX alpha, conductor eta / k) and velocity
        kb = torch.zeros_like(tb)
        ab = torch.full_like(tb, 0.1)
        eb = torch.zeros_like(tb)
        kk = torch.zeros_like(tb)
        vb = [torch.zeros_like(tb) for _ in range(3)]
        if blend:
            # a composite's second lobe (type, reflectance, alpha, eta, k),
            # the first lobe's weight and the mask mark
            lobe1 = [torch.zeros_like(tb), torch.zeros_like(tb),
                     torch.full_like(tb, 0.1), torch.zeros_like(tb),
                     torch.zeros_like(tb)]
            wmx = torch.ones_like(tb)
            mskf = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        tex_w = torch.zeros_like(active)    # the winner is textured
        if 2 in tex_code:
            # the bitmap rectangle a lane hit (its prim row, -1 none) and
            # the fraction of its scaled uv: its texel is read after the
            # loop (the JAX kernel's bub, bvb, bpid)
            bpid = torch.full((n_lanes,), -1, dtype=torch.long, device=dev)
            bub = torch.zeros_like(tb)
            bvb = torch.zeros_like(tb)
        if stats is not None or cond_out is not None:
            kind_w = torch.full((n_lanes,), -1, dtype=torch.int8,
                                device=dev)
            kap_w = torch.zeros_like(tb)
            dt_w = torch.zeros_like(tb)
        for p_id, kind, code, row in zip(prim_ids, kinds, tex_code, prims):
            t_p, hit_p, px, py, n_p, dt_p = prim_t(kind, row, cx, cy, cz,
                                                   ddx, ddy, ddz,
                                                   normal=True)
            closer = hit_p & (t_p > 1e-4) & (t_p < tb)
            tb = torch.where(closer, t_p, tb)
            nx = torch.where(closer, n_p[0], nx)
            ny = torch.where(closer, n_p[1], ny)
            nz = torch.where(closer, n_p[2], nz)
            if stats is not None or cond_out is not None:
                kind_w = torch.where(closer, kind, kind_w)
                if kind in (SPHERE, CYLINDER):
                    # the curvature: the larger of the object rows' x and
                    # y scales (a sphere's or cylinder's 1 / radius)
                    kap = torch.maximum(
                        torch.sqrt(row[1] ** 2 + row[2] ** 2 + row[3] ** 2),
                        torch.sqrt(row[5] ** 2 + row[6] ** 2 + row[7] ** 2))
                    kap_w = torch.where(closer, kap, kap_w)
                    dt_w = torch.where(closer, dt_p, dt_w)
                else:
                    dt_w = torch.where(closer, 0.0, dt_w)
            rb_p = row[13]
            if code:
                # the texture at the rectangle's uv = (p_local + 1) / 2,
                # scaled, in the JAX kernel's arithmetic
                uu = (px + 1.0) * 0.5 * row[24]
                vv = (py + 1.0) * 0.5 * row[25]
                if code == 1:
                    cs = torch.floor(uu) + torch.floor(vv)
                    par = cs - 2.0 * torch.floor(cs * 0.5)
                    rb_p = rb_p * torch.where(par < 0.5, row[22], row[23])
                else:
                    bub = torch.where(closer, uu - torch.floor(uu), bub)
                    bvb = torch.where(closer, vv - torch.floor(vv), bvb)
            if 2 in tex_code:
                bpid = torch.where(closer, p_id if code == 2 else -1, bpid)
            if any(tex_code):
                tex_w = torch.where(closer, code != 0, tex_w)
            rb = torch.where(closer, rb_p, rb)
            txc = torch.where(closer, row[14], txc)
            if read_lobe:
                kb = torch.where(closer, row[18], kb)
                ab = torch.where(closer, row[15], ab)
                eb = torch.where(closer, row[16], eb)
                kk = torch.where(closer, row[17], kk)
            if blend:
                lobe1 = [torch.where(closer, row[28 + i], v)
                         for i, v in enumerate(lobe1)]
                wmx = torch.where(closer, row[33], wmx)
                mskf = torch.where(closer, row[27] == 2.0, mskf)
            if moving:
                vb = [torch.where(closer, row[19 + i], vb[i])
                      for i in range(3)]
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
            if stats is not None or cond_out is not None:
                kind_w[sel] = -1
                kap_w[sel] = 0.0
                dt_w[sel] = 0.0
            tex_w[sel] = False
            if 2 in tex_code:
                bpid[sel] = -1
            tb[sel] = w.t[m_closer]
            nx[sel] = (gnx * rn)[m_closer]
            ny[sel] = (gny * rn)[m_closer]
            nz[sel] = (gnz * rn)[m_closer]
            rb[sel] = leaf_column(mesh, w.leaf, w.slot, 80)[m_closer]
            txc[sel] = -1.0
            # the triangle's shape row (second leaf payload): lobe and
            # velocity of its mesh
            if rows_m is not None:
                sid = leaf_column(mesh, w.leaf, w.slot, 88)[m_closer].long()
                row = rows_m[sid]
                kb[sel] = row[:, 6]
                if read_lobe:
                    ab[sel], eb[sel], kk[sel] = row[:, 3], row[:, 4], \
                        row[:, 5]
                if blend:
                    # mesh lobes are plain: one lobe of weight 1
                    lobe1[0][sel] = row[:, 6]
                    wmx[sel] = 1.0
                    mskf[sel] = False
                if moving:
                    for i in range(3):
                        vb[i][sel] = row[:, i]
            else:
                kb[sel] = float(DIFFUSE)
                for i in range(3):
                    vb[i][sel] = 0.0
        if 2 in tex_code:
            # the bitmap rectangles' texels: nearest, the fraction's
            # floor(f * W) held below W (the JAX kernel's _bitmap_fetch)
            bm = bmp_meta.to(device=dev, dtype=torch.long)[
                torch.clamp(bpid, min=0)]
            w_f, h_f = bm[:, 2].float(), bm[:, 1].float()
            ix = torch.minimum(torch.floor(bub * w_f), w_f - 1.0).long()
            iy = torch.minimum(torch.floor(bvb * h_f), h_f - 1.0).long()
            on = bpid >= 0
            texel = tex[torch.where(on, bm[:, 0] + iy, 0),
                        torch.where(on, ix, 0)]
            rb = torch.where(on, rb * texel, rb)
        hit = tb < 3.4e37
        active = active & hit
        count('hit', active)
        count('tex_hit', active & tex_w)
        if stats is not None:
            for kind, key in HIT_KEY.items():
                count(key, active & (kind_w == kind))
        if cond_out is not None:
            curved = (kind_w == SPHERE) | (kind_w == CYLINDER)
            cos_i = (ddx * nx + ddy * ny + ddz * nz).abs()
            # a curved hit's root moves by dt_w: beyond CURVED_ROOT_U u it
            # takes the place of the 1 u of any hit
            big = dt_w > CURVED_ROOT_U * u_len
            root = torch.where(big, dt_w / u_len, 1.0)
            bent_now = bent | (active & ((cos_i < GRAZE) | big))
            bent = bent_now | (active & curved)
            g_pos = torch.where(active, (g_pos + g_dir * tb + root)
                                / torch.clamp(cos_i, min=COS_FLOOR), g_pos)
            g_sum = g_sum + torch.where(active, g_pos, 0.0)
            g_dir = g_dir + torch.where(active & curved,
                                        2.0 * kap_w * g_pos, 0.0)
        tb = torch.where(hit, tb, 1.0)   # misses: keep dead lanes finite
        plen = plen + torch.where(active, tb, 0.0)
        if tau is not None:
            # ambient absorption along the segment (dead lanes: exp(0))
            count('med_seg', active)
            throughput = throughput * torch.exp(-tau(
                cx, cy, cz, ddx, ddy, ddz, torch.where(active, tb, 0.0),
                active))
        hx = cx + tb * ddx
        hy = cy + tb * ddy
        hz = cz + tb * ddz
        if mimo and depth == 0:
            # each element's last-segment path difference from the first
            # vertex (misses: the point one unit along the ray)
            count('mimo_vertex', active)
            v0x, v0y, v0z = hx - ox, hy - oy, hz - oz
            r0 = torch.sqrt(torch.clamp(v0x * v0x + v0y * v0y + v0z * v0z,
                                        min=1e-20))
            elem_dd = []
            for e in range(n_elem):
                vex = v0x - eoff[e, 0]
                vey = v0y - eoff[e, 1]
                vez = v0z - eoff[e, 2]
                elem_dd.append(torch.sqrt(torch.clamp(
                    vex * vex + vey * vey + vez * vez, min=1e-20)) - r0)
        is_ggx = kb == float(ROUGH_CONDUCTOR)
        is_m = (kb == float(CONDUCTOR)) if mirror else torch.zeros_like(hit)
        # the delta lobes: no NEE leaves them (their f is 0 toward a
        # transmitter; a composite's other lobe may still connect)
        is_delta = is_m
        for key, code in (('diel', DIELECTRIC), ('thin', THIN_DIELECTRIC)):
            if fl[key]:
                is_delta = is_delta | (kb == float(code))
        one_lobe = (wmx >= 1.0) if blend else torch.ones_like(hit)

        # ---- direct transmitter hits: at depth 0, and on lanes whose last
        #      bounce was a delta one (a mirror, a dielectric, a mask's
        #      pass; NEE covers the rest); the transmitter the lane hit ----
        u_dh = draw()
        for t, w in enumerate(txs if depth == 0 or delta_any else ()):
            m, tnx, tny, tnz = w['m'], *w['n']
            cos_dh = -(ddx * tnx + ddy * tny + ddz * tnz)
            te_h, tr_h, wg_h, k_h = emission(w, plen / cvel, u_dh, t_rx0)
            fe_h = inst_freq(te_h, w)
            sig_h = eval_wdf(w, te_h, fe_h)
            lam_h = cvel / torch.clamp(fe_h, min=1e-6)
            lxh = ((hx - m[3]) * m[0] + (hy - m[7]) * m[4]
                   + (hz - m[11]) * m[8]) / torch.clamp(w['wx'] * w['wx'],
                                                        min=1e-12)
            lyh = ((hx - m[3]) * m[1] + (hy - m[7]) * m[5]
                   + (hz - m[11]) * m[9]) / torch.clamp(w['wy'] * w['wy'],
                                                        min=1e-12)
            ok_h = active & (txc == float(t)) & (cos_dh > 0.0)
            if depth > 0:
                ok_h = ok_h & wdel
            ap_h = tx_aperture(t, lxh, lyh, hx, hy, hz, ddx, ddy, ddz, lam_h,
                               ok_h)
            w_dh = sig_h * w['gain'] * ap_h * TWO_PI
            count('direct', ok_h)
            val_h = torch.where(ok_h, throughput * w_dh * wg_h, 0.0)
            yb_h = (tr_h - t_start) / t_window * n_time_f - 0.5
            if moving:
                count('dop_direct', ok_h)
                fe_h = fe_h * dop
            splat(w, val_h, yb_h, fe_h, tr_h, ok_h,
                  echo_phase(w, plen, te_h, tr_h, k_h) if coherent else None)

        # ---- NEE to every transmitter, in row order: its point, direction
        #      and gate draws, its own shadow test ----
        # no NEE from a mirror or a dielectric: a delta lobe has no
        # density toward a transmitter (the JAX kernel's f_cos is 0 there)
        shade0 = active & (txc < 0.0) & ~(is_delta & one_lobe)
        for t, w in enumerate(txs):
            m, tnx, tny, tnz = w['m'], *w['n']
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
            count('nee_geom', shade0)
            shade = shade0 & (cos_tx > 1e-6)
            count('nee', shade)
            pdf_sa = torch.where(
                cos_tx > 1e-6,
                (1.0 / torch.clamp(w['area'], min=1e-12)) * dist2
                / torch.clamp(cos_tx, min=1e-6), 0.0)
            cos_s = wx_ * nx + wy_ * ny + wz_ * nz
            # diffuse f * cos toward the transmitter (wi = toward the
            # receiver)
            sg = _sign(-ddx * nx + -ddy * ny + -ddz * nz)
            co = wx_ * (nx * sg) + wy_ * (ny * sg) + wz_ * (nz * sg)
            f_cos = rb * (1.0 / np.pi) * torch.clamp(co, min=0.0)
            if lob:
                # every lobe of the table, and a composite's mix w f0 +
                # (1 - w) f1 (a mask's f1 is 0)
                count('ggx_nee', shade & is_ggx)
                count('plas_nee', shade & (kb == float(PLASTIC)))
                count('rplas_nee', shade & (kb == float(ROUGH_PLASTIC)))
                count('rdiel_nee', shade & (kb == float(ROUGH_DIELECTRIC)))
                wi_, wo_ = (-ddx, -ddy, -ddz), (wx_, wy_, wz_)
                f_cos = _lobe_fcos(kb, rb, ab, eb, kk, nx, ny, nz, wi_, wo_,
                                   fl)
                if blend:
                    two = shade & ~one_lobe
                    count('blend_nee', two)
                    for key, code in (('ggx_nee', ROUGH_CONDUCTOR),
                                      ('plas_nee', PLASTIC),
                                      ('rplas_nee', ROUGH_PLASTIC),
                                      ('rdiel_nee', ROUGH_DIELECTRIC)):
                        count(key, two & (lobe1[0] == float(code)))
                    f_cos = wmx * f_cos + (1.0 - wmx) * _lobe_fcos(
                        *lobe1, nx, ny, nz, wi_, wo_, fl)
            elif ggx:
                count('ggx_nee', shade & is_ggx)
                f_cos = torch.where(is_ggx, _ggx_fcos(
                    rb, ab, eb, kk, nx, ny, nz, -ddx, -ddy, -ddz,
                    wx_, wy_, wz_), f_cos)
            u7 = draw()
            t_emit, t_recv, w_gate, k_nee = emission(
                w, (plen + dist) / cvel, u7, t_rx0)
            f_emit = inst_freq(t_emit, w)
            sig = eval_wdf(w, t_emit, f_emit)
            ap = tx_aperture(t, glx, gly, qx, qy, qz, wx_, wy_, wz_,
                             cvel / torch.clamp(f_emit, min=1e-6), shade)
            w_tx = sig * w['gain'] * ap * TWO_PI
            off = 1e-4 * torch.sign(cos_s)
            sx, sy, sz = hx + off * nx, hy + off * ny, hz + off * nz
            occ = torch.zeros_like(active)
            limit = dist * 0.999
            for kind, row in blockers[t]:
                count('occ_tests', shade & ~occ)
                if kind != RECTANGLE:
                    count(OCC_KEY[kind], shade & ~occ)
                t_p, hit_p, *_ = prim_t(kind, row, sx, sy, sz, wx_, wy_,
                                        wz_)
                occ = occ | (hit_p & (t_p > 1e-4) & (t_p < limit))
            if mesh is not None:
                # mesh any hit for the lanes the rectangles left unblocked
                # (not from a delta lobe: the JAX kernel's walk skips them)
                walk = (shade & ~occ & ~is_delta).nonzero().squeeze(1)
                wk = walk_ref(mesh, sx[walk], sy[walk], sz[walk], wx_[walk],
                              wy_[walk], wz_[walk], limit[walk], anyhit=True,
                              stats=counts if stats is not None else None)
                occ[walk] = wk.occ
            ok = active & ~occ & (pdf_sa > 0.0) & (cos_tx > 1e-6) \
                & (txc < 0.0) & ~(is_delta & one_lobe)
            count('nee_splat', ok)
            val = torch.where(ok, throughput * f_cos * w_tx * w_gate
                              / torch.clamp(pdf_sa, min=1e-30), 0.0)
            if tau is not None:
                count('med_conn', ok)
                val = val * torch.exp(-tau(hx, hy, hz, wx_, wy_, wz_, dist,
                                           ok))
            yb = (t_recv - t_start) / t_window * n_time_f - 0.5
            f_recv = f_emit
            if moving:
                # connection Doppler: the vertex's bounce and the
                # transmitter's motion
                count('dop_nee', ok)
                dop_vtx = 1.0 + ((wx_ - ddx) * vb[0] + (wy_ - ddy) * vb[1]
                                 + (wz_ - ddz) * vb[2]) / cvel
                vel = w['vel']
                dop_tx = 1.0 - (wx_ * vel[0] + wy_ * vel[1]
                                + wz_ * vel[2]) / cvel
                f_recv = f_emit * dop * dop_vtx * dop_tx
            # the NEE phase adds the boundary phase of depth + 1 vertices
            splat(w, val, yb, f_recv, t_recv, ok,
                  echo_phase(w, plen + dist, t_emit, t_recv, k_nee)
                  + (depth + 1) * sp[16] if coherent else None)

        if depth == max_depth - 1:
            break

        # ---- bounce: cosine hemisphere (diffuse), a GGX half vector, a
        #      delta reflection or refraction, about the flipped normal; a
        #      composite first picks its lobe ----
        u8, u9 = draw(), draw()
        u_pick = draw() if lob & LOBE_PICK else None
        pass_thru = None
        if blend:
            # lobe 0 with probability w, else lobe 1; a mask's lobe 1 passes
            # the ray straight on (a delta null transmission, weight 1)
            u_mix = draw()
            pick0 = u_mix < wmx
            count('blend_pick', active & (txc < 0.0) & ~one_lobe)
            pass_thru = mskf & ~pick0
            kb, rb, ab, eb, kk = (torch.where(pick0, a, b) for a, b in
                                  zip((kb, rb, ab, eb, kk), lobe1))
            is_ggx = kb == float(ROUGH_CONDUCTOR)
            is_m = (kb == float(CONDUCTOR)) if mirror else is_m
        cont = active & (txc < 0.0)

        def tie(mask, *gaps):
            # lanes whose branch a few roundings may flip (`ill_out`)
            if mark is not None:
                for g in gaps:
                    mark(cont & mask & (g.abs() <= LOBE_TIE))
        if lob:
            other = is_ggx | is_m
            for key, code in (('diel_bounce', DIELECTRIC),
                              ('diel_bounce', THIN_DIELECTRIC),
                              ('plas_bounce', PLASTIC),
                              ('rplas_bounce', ROUGH_PLASTIC),
                              ('rdiel_bounce', ROUGH_DIELECTRIC)):
                lane_k = (kb == float(code)) & ~(pass_thru if mask
                                                 else torch.zeros_like(hit))
                count(key, cont & lane_k)
                other = other | lane_k
            if mask:
                count('pass_bounce', cont & pass_thru)
                other = other | pass_thru
            count('bounce', cont & (rb > 0.0) & ~other)
        else:
            count('bounce', cont & (rb > 0.0) & ~is_ggx & ~is_m)
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
        cos2, sin2 = _fast_cos(ph2), _fast_sin(ph2)
        bx_, by_ = rr2 * cos2, rr2 * sin2
        bz_ = torch.sqrt(torch.clamp(1.0 - u8, min=0.0))
        wdx = s1x * bx_ + s2x * by_ + fx * bz_
        wdy = s1y * bx_ + s2y * by_ + fy * bz_
        wdz = s1z * bx_ + s2z * by_ + fz * bz_
        ndx, ndy, ndz = wdx, wdy, wdz
        w_b = rb
        if ggx:
            # GGX half-vector sample; weight refl F G (wi.h) / (cos_i h.n)
            count('ggx_bounce', cont & is_ggx)
            ag2 = ab * ab
            tan2 = ag2 * u8 / torch.clamp(1.0 - u8, min=1e-12)
            cth = torch.rsqrt(1.0 + tan2)
            sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
            hlx, hly = sth * cos2, sth * sin2
            hwx = s1x * hlx + s2x * hly + fx * cth
            hwy = s1y * hlx + s2y * hly + fy * cth
            hwz = s1z * hlx + s2z * hly + fz * cth
            ci_b = face.abs()
            idoth = -ddx * hwx + -ddy * hwy + -ddz * hwz
            wgx = 2.0 * idoth * hwx + ddx
            wgy = 2.0 * idoth * hwy + ddy
            wgz = 2.0 * idoth * hwz + ddz
            co_g = wgx * fx + wgy * fy + wgz * fz
            f_b = _fres_cond(idoth.abs(), eb, kk)
            g_b = _g1(ci_b, ag2) * _g1(co_g.abs(), ag2)
            w_g = rb * f_b * g_b * idoth / torch.clamp(ci_b * cth, min=1e-8)
            w_g = torch.where((co_g > 0.0) & (idoth > 0.0), w_g, 0.0)
            ndx = torch.where(is_ggx, wgx, ndx)
            ndy = torch.where(is_ggx, wgy, ndy)
            ndz = torch.where(is_ggx, wgz, ndz)
            w_b = torch.where(is_ggx, w_g, w_b)
        if fl['plas'] or fl['rplas']:
            # plastics: the coat with probability spec_w, else the diffuse
            # base; the weight is f / pdf of the two-lobe model
            ci_b2 = face.abs()
            fi_p = _fres_diel(ci_b2, eb)
            spec_w = torch.clamp(fi_p, 0.05, 0.95)
            pick_s = u_pick < spec_w
        if fl['plas']:
            # smooth coat: the mirror direction about the flipped normal
            is_p = kb == float(PLASTIC)
            dn2 = ddx * fx + ddy * fy + ddz * fz
            pxd = torch.where(pick_s, ddx - 2.0 * dn2 * fx, wdx)
            pyd = torch.where(pick_s, ddy - 2.0 * dn2 * fy, wdy)
            pzd = torch.where(pick_s, ddz - 2.0 * dn2 * fz, wdz)
            co_p = pxd * fx + pyd * fy + pzd * fz
            w_p = rb * (1.0 - fi_p) * (1.0 - _fres_diel(co_p, eb)) \
                / torch.clamp(1.0 - spec_w, min=1e-6)
            tie(is_p, u_pick - spec_w, co_p)
            ndx = torch.where(is_p, pxd, ndx)
            ndy = torch.where(is_p, pyd, ndy)
            ndz = torch.where(is_p, pzd, ndz)
            w_b = torch.where(is_p, torch.where(co_p > 0.0, w_p, 0.0), w_b)
        if fl['rplas']:
            # GGX coat: the rough conductor's sample direction
            is_rp = kb == float(ROUGH_PLASTIC)
            rx2 = torch.where(pick_s, wgx, wdx)
            ry2 = torch.where(pick_s, wgy, wdy)
            rz2 = torch.where(pick_s, wgz, wdz)
            co_r = rx2 * fx + ry2 * fy + rz2 * fz
            hx2, hy2, hz2, hc2 = _toward(*_unit(-ddx + rx2, -ddy + ry2,
                                                -ddz + rz2), fx, fy, fz)
            ar2 = ab * ab
            dd2 = hc2 * hc2 * (ar2 - 1.0) + 1.0
            d_r = ar2 / torch.clamp(np.pi * dd2 * dd2, min=1e-20)
            g_r = _g1(ci_b2, ar2) * _g1(co_r.abs(), ar2)
            idoth2 = -ddx * hx2 + -ddy * hy2 + -ddz * hz2
            f_val = (rb * (1.0 / np.pi) * torch.clamp(co_r, min=0.0)
                     * (1.0 - fi_p) * (1.0 - _fres_diel(co_r, eb))
                     + _fres_diel(idoth2.abs(), eb) * d_r * g_r
                     / torch.clamp(4.0 * ci_b2, min=1e-8))
            odoth2 = (rx2 * hx2 + ry2 * hy2 + rz2 * hz2).abs()
            pdf_r = ((1.0 - spec_w) * torch.clamp(co_r, min=0.0)
                     * (1.0 / np.pi)
                     + spec_w * d_r * hc2 / torch.clamp(4.0 * odoth2,
                                                        min=1e-8))
            w_rp = torch.where((co_r > 0.0) & (ci_b2 > 1e-6),
                               f_val / torch.clamp(pdf_r, min=1e-20), 0.0)
            tie(is_rp, u_pick - spec_w, co_r)
            ndx = torch.where(is_rp, rx2, ndx)
            ndy = torch.where(is_rp, ry2, ndy)
            ndz = torch.where(is_rp, rz2, ndz)
            w_b = torch.where(is_rp, w_rp, w_b)
        if fl['rdiel']:
            # GGX glass: reflect or refract through the sampled half vector
            # by its Fresnel; the weight is the eval-consistent f cos / pdf
            is_rd = kb == float(ROUGH_DIELECTRIC)
            # the relative IOR by the side the ray came from (idoth rides
            # the flipped frame; sgn carries the side)
            f_h, eta_i2, cost_h, c2t_h = _fres_diel_full(idoth * sgn, eb)
            inv_e2 = 1.0 / eta_i2
            coef_t = (inv_e2 * idoth.abs() - cost_h) * _sign(idoth)
            ttx, tty, ttz = _unit(coef_t * hwx - (-ddx) * inv_e2,
                                  coef_t * hwy - (-ddy) * inv_e2,
                                  coef_t * hwz - (-ddz) * inv_e2)
            pick_rf = u_pick < f_h
            rdx = torch.where(pick_rf, wgx, ttx)
            rdy = torch.where(pick_rf, wgy, tty)
            rdz = torch.where(pick_rf, wgz, ttz)
            f_c, p_c = _rd_fcos_pdf(face, fx, fy, fz, eb, kk, rb, ab,
                                    (-ddx, -ddy, -ddz), (rdx, rdy, rdz))
            co_rd = rdx * fx + rdy * fy + rdz * fz
            odh_s = rdx * hwx + rdy * hwy + rdz * hwz
            rd_ok = ((torch.where(pick_rf, co_rd, -co_rd) > 0.0)
                     & (idoth > 0.0) & (odh_s * co_rd > 0.0))
            tie(is_rd, u_pick - f_h, c2t_h, idoth, co_rd, odh_s)
            ndx = torch.where(is_rd, rdx, ndx)
            ndy = torch.where(is_rd, rdy, ndy)
            ndz = torch.where(is_rd, rdz, ndz)
            w_b = torch.where(is_rd, torch.where(
                rd_ok & (p_c > 0.0), f_c / torch.clamp(p_c, min=1e-20), 0.0),
                w_b)
        new_wdel = torch.zeros_like(active)
        if mirror:
            # smooth conductor: the specular reflection about the flipped
            # normal, weight refl x conductor Fresnel (a delta lobe)
            count('mirror_bounce', cont & is_m)
            dn_ = ddx * fx + ddy * fy + ddz * fz
            ndx = torch.where(is_m, ddx - 2.0 * dn_ * fx, ndx)
            ndy = torch.where(is_m, ddy - 2.0 * dn_ * fy, ndy)
            ndz = torch.where(is_m, ddz - 2.0 * dn_ * fz, ndz)
            w_b = torch.where(is_m, rb * _fres_cond(dn_.abs(), eb, kk), w_b)
            new_wdel = new_wdel | is_m
        if fl['diel'] or fl['thin']:
            # smooth / thin dielectric: reflect or refract (thin: pass) by
            # the dielectric Fresnel of the unflipped cosine, picked by u8
            ci_u = face
            f_d, eta_it, cos_t, c2t = _fres_diel_full(ci_u, eb)
            rxd = ddx + 2.0 * ci_u * nx
            ryd = ddy + 2.0 * ci_u * ny
            rzd = ddz + 2.0 * ci_u * nz
        if fl['diel']:
            is_d = kb == float(DIELECTRIC)
            scl = 1.0 / eta_it
            coef = scl * ci_u - _sign(ci_u) * cos_t
            pick_r = u8 < f_d
            tie(is_d, u8 - f_d, c2t)
            ndx = torch.where(is_d, torch.where(pick_r, rxd, scl * ddx
                                                + coef * nx), ndx)
            ndy = torch.where(is_d, torch.where(pick_r, ryd, scl * ddy
                                                + coef * ny), ndy)
            ndz = torch.where(is_d, torch.where(pick_r, rzd, scl * ddz
                                                + coef * nz), ndz)
            # refraction: the transmittance (k) x the radiance compression
            w_b = torch.where(is_d, torch.where(pick_r, rb, kk * scl * scl),
                              w_b)
            new_wdel = new_wdel | is_d
        if fl['thin']:
            # the interference-free internal series: R' = 2F / (1 + F)
            is_t = kb == float(THIN_DIELECTRIC)
            r_p = torch.where(f_d < 1.0, 2.0 * f_d / (1.0 + f_d), 1.0)
            pick_rt = u8 < r_p
            tie(is_t, u8 - r_p, c2t)
            ndx = torch.where(is_t, torch.where(pick_rt, rxd, ddx), ndx)
            ndy = torch.where(is_t, torch.where(pick_rt, ryd, ddy), ndy)
            ndz = torch.where(is_t, torch.where(pick_rt, rzd, ddz), ndz)
            w_b = torch.where(is_t, 1.0, w_b)
            new_wdel = new_wdel | is_t
        if mask:
            ndx = torch.where(pass_thru, ddx, ndx)
            ndy = torch.where(pass_thru, ddy, ndy)
            ndz = torch.where(pass_thru, ddz, ndz)
            w_b = torch.where(pass_thru, 1.0, w_b)
            new_wdel = new_wdel | pass_thru
        if delta_any or mask:
            wdel = new_wdel
        if moving:
            # bounce Doppler of the continued path
            count('dop_bounce', cont & (w_b > 0.0))
            dop = dop * (1.0 + ((ndx - ddx) * vb[0] + (ndy - ddy) * vb[1]
                                + (ndz - ddz) * vb[2]) / cvel)
        off = 1e-4
        if back_face:
            # a refracted or passed ray leaves through the back face
            cos_n = ndx * fx + ndy * fy + ndz * fz
            tie(w_b > 0.0, cos_n)
            off = torch.where(cos_n >= 0.0, 1e-4, -1e-4)
        ddx, ddy, ddz = ndx, ndy, ndz
        throughput = throughput * w_b
        active = active & (w_b > 0.0) & (txc < 0.0)
        cx = hx + off * fx
        cy = hy + off * fy
        cz = hz + off * fz
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v
    if lane_out is not None:
        lane_out.copy_(lane_sum)
    if coherent:
        return acc.t().float().reshape(n_time, n_freq, n_ch), n_events
    return acc[0].float().reshape(n_time, n_freq), n_events


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------


def _bind(lib):
    vp, i32, i64, u64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_ulonglong,
                              ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rk_geometry.argtypes = [i32] * 2 + [i64] + [i32] * 16 + [ip] * 3
    lib.rk_geometry.restype = i32
    lib.rk_launch.argtypes = [vp] * 12 + [i32, i32, vp, i64, u64] \
        + [i32] * 13 + [f32] * 6 + [i32, u64] + [i64] * 4 + [i32] * 3 \
        + [vp, vp, i32] + [i32, vp, i32, i32, i32] + [i32, i32, vp, i32] \
        + [i32, i32] + [i32] + [vp, i32, i32] + [vp]
    lib.rk_launch.restype = i32
    lib.rk_last_kernel.argtypes = []
    lib.rk_last_kernel.restype = vp
    lib.rk_lobe_kernel.argtypes = [i32]
    lib.rk_lobe_kernel.restype = vp
    lib.rk_endpoint_kernel.argtypes = [i32]
    lib.rk_endpoint_kernel.restype = vp
    lib.rk_doppler_power_kernel.argtypes = [i32]
    lib.rk_doppler_power_kernel.restype = vp
    lib.rk_mesh_doppler_kernel.argtypes = [i32, i32]
    lib.rk_mesh_doppler_kernel.restype = vp
    lib.rk_mimo_kernel.argtypes = []
    lib.rk_mimo_kernel.restype = vp
    lib.rk_mesh_kernel.argtypes = []
    lib.rk_mesh_kernel.restype = vp
    lib.rk_tex_kernel.argtypes = [i32]
    lib.rk_tex_kernel.restype = vp
    lib.rk_prim_kernel.argtypes = [i32, i32]
    lib.rk_prim_kernel.restype = vp


LIBRARY = _nvcc.Library('receive_megakernel', 'rk', _bind)


def build_library() -> _nvcc.BuildInfo:
    return _nvcc.build('receive_megakernel')


def launched_lobe_kernel(coherent: bool) -> bool:
    """Whether the last launch on a card ran the analytic lobe twins'
    kernel (receive_lobe_kernel) of the power or the I / Q configuration:
    the library's launch record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_lobe_kernel(int(coherent))


def launched_endpoint_kernel(coherent: bool) -> bool:
    """Whether the last launch on a card ran the analytic endpoint twins'
    kernel (receive_endpoint_kernel, power, or
    receive_endpoint_coherent_kernel, I / Q): the library's launch
    record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_endpoint_kernel(int(coherent))


def launched_doppler_power_kernel(twin: str = '') -> bool:
    """Whether the last launch on a card ran the analytic Doppler power
    configuration's kernel (receive_doppler_power_kernel<false>), or with
    `twin` 'media' / 'ep' that configuration's grid-stride media or
    endpoint twin (receive_doppler_kernel<false, false, MED, EP>), or
    'tex' / 'prims' / 'tex_prims' its texture twin
    (receive_doppler_power_kernel<true>), its prims twin (<false, true>)
    or the prims twin that also carries the texture codes (<true, true>):
    the library's launch record."""
    lib = LIBRARY.get()
    which = {'': 0, 'media': 1, 'ep': 2, 'tex': 3, 'prims': 4,
             'tex_prims': 5}[twin]
    return lib.rk_last_kernel() == lib.rk_doppler_power_kernel(which)


def launched_mesh_doppler_kernel(lobes: bool = False,
                                 coherent: bool | None = None) -> bool:
    """Whether the last launch on a card ran the mesh Doppler kernel
    (receive_mesh_doppler_kernel<coherent, lobes>) of a vacuum mesh
    configuration of the Doppler family: the Doppler mesh in power, the
    coherent mesh (`coherent`), the power mesh lobe twin (`lobes`,
    `coherent` False) or the mesh lobe twin in I / Q (`lobes`);
    `coherent` defaults to `lobes`.  The library's launch record."""
    lib = LIBRARY.get()
    coh = lobes if coherent is None else coherent
    return lib.rk_last_kernel() == lib.rk_mesh_doppler_kernel(int(coh),
                                                              int(lobes))


def launched_mimo_kernel() -> bool:
    """Whether the last launch on a card ran the MIMO array kernel
    (receive_mimo_array_kernel) of the vacuum MIMO configuration: the
    library's launch record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_mimo_kernel()


def launched_mesh_kernel() -> bool:
    """Whether the last launch on a card ran the mesh kernel
    (receive_mesh_kernel) of the vacuum mesh configuration in power: the
    library's launch record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_mesh_kernel()


def launched_tex_kernel(coherent: bool) -> bool:
    """Whether the last launch on a card ran a texture twin: the flagship
    kernel's (receive_flagship_kernel<true>, power) or the coherent
    kernel's (receive_coherent_kernel<true>, I / Q).  The library's launch
    record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_tex_kernel(int(coherent))


def launched_prim_kernel(coherent: bool, textured: bool = False) -> bool:
    """Whether the last launch on a card ran a prims twin (spheres, disks
    and cylinders beside the rectangles): the flagship kernel's
    (receive_flagship_kernel<false, true>, power) or the coherent
    kernel's (receive_coherent_kernel<false, true>, I / Q), or with
    `textured` the one that also carries the texture twins' codes
    (<true, true>, a textured scene's).  The library's launch record."""
    lib = LIBRARY.get()
    return lib.rk_last_kernel() == lib.rk_prim_kernel(int(coherent),
                                                       int(textured))


def grid_mode(n_cells: int, doppler: bool, coherent: bool = False,
              n_elem: int = 0) -> int:
    """How the kernel accumulates an ADC grid of `n_cells`: 0 private
    per-thread rows (flagship and mesh configurations), 1 a block-shared
    grid of shared-memory atomics, 2 a global float64 grid of atomics
    (Doppler, coherent and, with `n_elem` elements, MIMO configurations,
    by size)."""
    if n_elem:
        return 1 if n_cells * 2 * n_elem <= MAX_SMEM_MIMO_VALS else 2
    if coherent:
        return 1 if n_cells <= MAX_SMEM_COH_CELLS else 2
    if not doppler:
        return 0
    return 1 if n_cells <= MAX_SMEM_CELLS else 2


def coherent_warp_rows(adc: ADCConfig, coherent: bool = True) -> bool:
    """Whether a coherent call on an analytic scene, or (`coherent` False)
    a power call of an analytic lobe twin or of the analytic Doppler
    configuration, sums its grid in warp rows
    (bit-identical repeats): a 1-D grid of at most COH_ROW_VALS / 2 bins
    (COH_ROW_VALS in power)."""
    return adc.n_freq == 1 \
        and (2 if coherent else 1) * adc.n_time <= COH_ROW_VALS


def launch_geometry(n_time: int, n_lanes: int, n_prims: int,
                    n_params: int = 45 + MAX_MEDIA_LAYERS,
                    mesh: bool = False, n_freq: int = 1, n_msh: int = 0,
                    doppler: bool = False, coherent: bool = False,
                    n_pulses: int = 1, n_elem: int = 0, medium: int = 0,
                    ep: bool = False, lobes: bool = False, n_tx: int = 1,
                    n_pairs: int = 0, n_rx_pairs: int = 0,
                    tex: bool = False, prims: bool = False):
    """(blocks a pulse, threads per block, dynamic shared bytes) of the
    trace kernel (its mesh, Doppler and / or coherent configuration, or
    the MIMO one of `n_elem` elements; its media twin with `medium`, its
    endpoint twin with `ep`, a Doppler configuration's lobe twin with
    `lobes`) on the current card: a persistent
    grid of as many blocks as fit on every SM at once, fewer when a
    pulse's lanes run out.  The `n_pulses` pulses of a CPI share that grid
    in the Doppler family; in the flagship and mesh configurations each
    pulse gets it (they run in waves, each summing in the order of one
    call).  The endpoint twin's analytic kernels size their footprint
    index by `n_tx`, the pairs a phased transmitter's row `n_pairs` and an
    analog phased receiver's `n_rx_pairs`.  `tex` asks for the texture twin
    of the flagship, the analytic Doppler power or the coherent
    configuration, `prims` for its prims twin (spheres, disks and
    cylinders; with `tex`, the twin that also carries the texture
    codes)."""
    lib = LIBRARY.get()
    mode = grid_mode(n_time * n_freq, doppler, coherent, n_elem)
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    LIBRARY.check(lib.rk_geometry(n_time, n_freq, n_lanes, n_prims, n_params,
                                  n_msh, int(mesh), mode, int(coherent),
                                  n_pulses, n_elem, int(medium > 0), int(ep),
                                  int(bool(lobes)), n_tx, n_pairs,
                                  n_rx_pairs, int(tex), int(prims),
                                  ctypes.byref(blocks),
                                  ctypes.byref(threads), ctypes.byref(smem)),
                  'receive_megakernel geometry')
    return blocks.value, threads.value, smem.value


def patch_p_for(n_lanes: int) -> int:
    """The strata grid of a mesh call (the JAX package's rule): P = 32 if
    the 1024-lane tiles count a multiple of 1024, 16 if of 256, else 0
    (no strata: the lanes take the cosine / lobe mixture)."""
    n_tiles = max(n_lanes // TILE, 1)
    return next((p for p in (32, 16) if n_tiles % (p * p) == 0), 0)


def _check_adc(adc: ADCConfig, doppler: bool):
    if not doppler:
        if adc.n_freq != 1 or not 1 <= adc.n_time <= MAX_N_TIME_ROWS:
            raise ValueError(
                f'ADC {adc.n_time}x{adc.n_freq}: the flagship and mesh '
                f'configurations take n_freq == 1 and n_time <= '
                f'{MAX_N_TIME_ROWS} (doppler=True takes more)')
        return
    if not (1 <= adc.n_time <= MAX_N_TIME and 1 <= adc.n_freq <= MAX_N_FREQ
            and adc.n_time * adc.n_freq <= MAX_ADC_CELLS):
        raise ValueError(f'ADC {adc.n_time}x{adc.n_freq}: the Doppler '
                         f'configuration takes n_time <= {MAX_N_TIME}, '
                         f'n_freq <= {MAX_N_FREQ}, <= {MAX_ADC_CELLS} cells')
    if adc.n_freq > 1 and not adc.freq_hi > adc.freq_lo:
        raise ValueError(f'n_freq {adc.n_freq} over an empty frequency '
                         'window')


# values read back from tables, kept by the tensors' ids while they live
# and until one changes in place (its version counter moves)
_READ_BACK: dict = {}


def _read_back(what: str, tensors: tuple, fn):
    """fn(*tensors) (None among them allowed), computed once for these
    tensors (on a card, a read-back: a stall before the launch), then
    kept."""
    key = (what,) + tuple(id(t) for t in tensors)
    ver = tuple(None if t is None else t._version for t in tensors)
    hit = _READ_BACK.get(key)
    if hit is None or hit[1] != ver or any(
            (r is None) != (t is None) or (r is not None and r() is not t)
            for r, t in zip(hit[0], tensors)):
        for k in [k for k, v in _READ_BACK.items()
                  if any(r is not None and r() is None for r in v[0])]:
            del _READ_BACK[k]
        refs = tuple(None if t is None else weakref.ref(t) for t in tensors)
        hit = _READ_BACK[key] = (refs, ver, fn(*tensors))
    return hit[2]


def _table_tx_kinds(txp, n_tx: int) -> tuple:
    """The kinds txp[..., 27] of a table's (first pulse's) transmitter
    rows: read back once a tensor (a stall on a card), then kept."""
    return _read_back('tx_kinds', (txp,), lambda t: tuple(
        int(k) for k in t.reshape(-1, n_tx, TXP_COLS)[0, :, 27].tolist()))


def _check_call(params, prim, txp, uniforms, mesh, msh, lane_out, lead, *,
                adc, max_depth, time_sampling, rx_kind, n_lanes, doppler,
                patch_p, receive_type, has_lo, coherent, rxph=None,
                eoff=None, medium=0, grid=None, php=None, lobes=0, tex=None,
                bmp_meta=None, textured=None, prims=None):
    """Validate a call's arguments; `lead` is () for one pulse, (P,) for a
    CPI of P pulses (every table, the uniforms and the lane sums then have
    that leading axis, the BVH tables (P, n) rows).  `eoff` (with `rxph`)
    asks for the MIMO configuration (one pulse).  `medium` and `grid`: the
    medium's kind and, for a grid, its (D, H, W) cells, one tensor every
    pulse of a CPI shares; so do `php`, the phased pair rows, and `rxph`.
    Returns (the receive-frequency rule, the transmitters' kinds (read
    from txp, `_table_tx_kinds`), whether the call needs the endpoint
    configuration, whether its prim rows carry textures: `textured`, or
    where it is None, `_textured`, and whether they hold a sphere, disk or
    cylinder: `prims`, or where it is None, `_has_prims`).
    `lobes`, the call's lobe twins' flags (`_lobe_flag`), set the
    uniforms' stride.  Textured tables take their texel rows `tex` (R, Wp)
    float32 and `bmp_meta` (n_prims, 3) int32 (`pack_scene`), and run in
    the texture twins only: one pulse of the flagship, the Doppler power or
    the coherent configuration on an analytic scene in vacuum, with one
    Wigner transmitter and no lobe twin.  Spheres, disks and cylinders run
    in the prims twins of those three configurations only, a CPI's pulses
    too where they carry no texture."""
    dev = params.device
    n_tx = int(txp.shape[-2]) if txp.dim() >= 2 else 0
    if not 1 <= n_tx <= MAX_TX:
        raise ValueError(f'{n_tx} transmitter rows (1..{MAX_TX})')
    tx_kinds = _table_tx_kinds(txp, n_tx)
    if not set(tx_kinds) <= {WIGNER, PHASED, AREA}:
        raise ValueError(f'txp[:, 27] {tx_kinds}: one of Wigner {WIGNER}, '
                         f'phased {PHASED}, area {AREA} a transmitter row')
    ep = n_tx > 1 or set(tx_kinds) != {WIGNER} or (
        rx_kind == 'phased' and eoff is None)
    if ep and medium:
        raise ValueError('the endpoint configuration has no media twin '
                         '(ROADMAP B6)')
    if lobes and (medium or ep or eoff is not None):
        raise ValueError('the lobe twins run in vacuum, with one Wigner '
                         'transmitter and no phased receiver (ROADMAP B5)')
    if PHASED in tx_kinds:
        k = (int(php.shape[1]) - 2) // 6 if php is not None \
            and php.dim() == 2 else 0
        if (k < 1 or tuple(php.shape) != (n_tx, 2 + 6 * k)
                or n_tx * k > MAX_TX_PAIRS or php.dtype != torch.float32
                or php.device != dev or not php.is_contiguous()):
            raise ValueError(f'php: a phased transmitter needs contiguous '
                             f'float32 (n_tx, 2 + 6K) pair rows on {dev}, '
                             f'n_tx K <= {MAX_TX_PAIRS}')
    if medium not in (0, HOMOGENEOUS, LAYERED, GRID):
        raise ValueError(f'medium {medium}: 0 vacuum, {HOMOGENEOUS} '
                         f'homogeneous, {LAYERED} layered, {GRID} grid')
    if (grid is not None) != (medium == GRID):
        raise ValueError('a grid medium takes its (D, H, W) cells `grid`, '
                         'no other medium one')
    if grid is not None and (
            grid.dim() != 3 or grid.dtype != torch.float32
            or grid.device != dev or not grid.is_contiguous()
            or grid.shape[0] * grid.shape[1] > MAX_GRID3_ROWS
            or not 1 <= grid.shape[2] <= MAX_GRID3_W or grid.numel() < 1):
        raise ValueError(f'grid: expected contiguous float32 (D, H, W) on '
                         f'{dev}, D * H <= {MAX_GRID3_ROWS}, W <= '
                         f'{MAX_GRID3_W}')
    if time_sampling not in ('fixed', 'gate'):
        raise ValueError(f'time_sampling {time_sampling!r}')
    if eoff is not None:
        n_e = int(eoff.shape[0]) if eoff.dim() == 2 else 0
        if (lead or not doppler or coherent or mesh is not None
                or rx_kind != 'phased' or adc.n_freq != 1
                or adc.n_time > MAX_MIMO_N_TIME
                or not 2 <= n_e <= MAX_MIMO_ELEMS):
            raise ValueError(
                "MIMO (eoff): one pulse, doppler=True, coherent=False, no "
                f"mesh, rx_kind 'phased', n_freq == 1, n_time <= "
                f'{MAX_MIMO_N_TIME}, 2..{MAX_MIMO_ELEMS} elements')
        for name, t, ok in (
                ('eoff (E, 3)', eoff, tuple(eoff.shape) == (n_e, 3)),
                ('rxph (1, 2 + 6K)', rxph, rxph is not None
                 and rxph.dim() == 2 and rxph.shape[0] == 1
                 and rxph.shape[1] >= 2)):
            if not ok or t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f'{name}: expected contiguous float32 on '
                                 f'{dev}')
    elif rx_kind == 'phased':
        k = (int(rxph.shape[1]) - 2) // 6 if rxph is not None \
            and rxph.dim() == 2 else 0
        if (k < 1 or tuple(rxph.shape) != (1, 2 + 6 * k)
                or k > MAX_RX_PAIRS or rxph.dtype != torch.float32
                or rxph.device != dev or not rxph.is_contiguous()):
            raise ValueError(f'rxph: an analog phased receiver needs its '
                             f'contiguous float32 (1, 2 + 6K) pair row on '
                             f'{dev}, K <= {MAX_RX_PAIRS}')
    elif rx_kind not in ('wigner', 'omni'):
        raise ValueError(f'rx_kind {rx_kind!r}')
    rule = rx_rule(receive_type, has_lo)
    if (rule != RX_RAW or coherent) and not doppler:
        raise ValueError('LO receive types and coherent I / Q run in the '
                         'Doppler configuration (doppler=True)')
    _check_adc(adc, doppler)
    n_prims = int(prim.shape[-2]) if prim.dim() >= 2 else 0
    if not 1 <= n_prims <= MAX_PRIMS:
        raise ValueError(f'{n_prims} prim rows (1..{MAX_PRIMS})')
    tables = [('params', params, lead + (45 + MAX_MEDIA_LAYERS,)),
              ('prim', prim, lead + (n_prims, PRIM_COLS)),
              ('txp', txp, lead + (n_tx, TXP_COLS))]
    if msh is not None:
        n_msh = int(msh.shape[-2])
        if not (doppler and mesh is not None
                and 1 <= n_msh <= MAX_MESH_SHAPES):
            raise ValueError(f'msh: 1..{MAX_MESH_SHAPES} mesh-shape rows, '
                             'read by the Doppler configuration of a mesh')
        tables.append(('msh', msh, lead + (n_msh, 8)))
    elif doppler and mesh is not None:
        raise ValueError('the Doppler configuration of a mesh needs its '
                         'mesh-shape rows msh')
    for name, t, shape in tables:
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name}: expected contiguous float32 {shape} '
                             f'on {dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
    nd = n_draws(max_depth, n_tx, **lobe_draws(lobes))
    if uniforms is not None and (
            tuple(uniforms.shape) != lead + (nd, n_lanes)
            or uniforms.dtype != torch.float32 or uniforms.device != dev
            or not uniforms.is_contiguous()):
        raise ValueError(f'uniforms: expected contiguous float32 '
                         f'{lead + (nd, n_lanes)} on {dev}')
    if mesh is not None:
        if mesh.stride != MESH_STRIDE or any(
                x.device != dev or not x.is_contiguous()
                or x.dim() != 1 + len(lead) or tuple(x.shape[:-1]) != lead
                for x in (mesh.bbox, mesh.links, mesh.leaves)):
            raise ValueError(f'mesh: expected contiguous stride-'
                             f'{MESH_STRIDE} tables {lead + ("n",)} on '
                             f'{dev}')
    if lane_out is not None and (
            (mesh is None and not doppler)
            or tuple(lane_out.shape) != lead + (n_lanes,)
            or lane_out.dtype != torch.float32 or lane_out.device != dev
            or not lane_out.is_contiguous()):
        raise ValueError(f'lane_out: expected float32 {lead + (n_lanes,)} '
                         f'on {dev}, with a mesh or in the Doppler '
                         'configuration')
    if patch_p and (mesh is None or rx_kind != 'wigner'):
        raise ValueError('direction strata need a mesh and a Wigner '
                         'receiver')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'no receive kernel for device {dev}')
    textured = _textured(prim) if textured is None else bool(textured)
    if textured:
        if (lead or mesh is not None or eoff is not None or medium or ep
                or lobes):
            raise ValueError('textured tables run in the flagship, the '
                             'Doppler power and the coherent configurations '
                             'alone: one pulse, an analytic scene in vacuum, '
                             'one Wigner transmitter, no lobe twin (ROADMAP '
                             'B7)')
        if (tex is None or bmp_meta is None or tex.dim() != 2
                or tex.dtype != torch.float32 or tex.device != dev
                or not tex.is_contiguous() or tex.numel() < 1
                or tuple(bmp_meta.shape) != (n_prims, 3)
                or bmp_meta.dtype != torch.int32
                or bmp_meta.device != dev):
            raise ValueError(f'textured tables need their texel rows tex '
                             f'(contiguous float32 (R, Wp)) and bmp_meta '
                             f'(int32 ({n_prims}, 3)) on {dev}')
    prims = _has_prims(prim) if prims is None else bool(prims)
    if prims and (mesh is not None or eoff is not None or medium or ep
                  or lobes):
        raise ValueError('spheres, disks and cylinders run in the flagship, '
                         'the Doppler power and the coherent configurations '
                         'alone: an analytic scene in vacuum, one Wigner '
                         'transmitter, no lobe twin (ROADMAP B1 (rest))')
    return rule, tx_kinds, ep, textured, prims


def _textured(prim) -> bool:
    """Do the prim rows carry a checkerboard or bitmap texture (column
    26)?  Read back once a tensor (a stall on a card), then kept."""
    return _read_back('textured', (prim,),
                      lambda t: bool((t[..., 26] != 0).any()))


def _has_prims(prim) -> bool:
    """Do the prim rows hold a sphere, disk or cylinder (column 0)?  Read
    back once a tensor (a stall on a card), then kept."""
    return _read_back('prims', (prim,), lambda t: bool(
        torch.isin(t[..., 0], torch.tensor(NON_RECT, dtype=t.dtype,
                                           device=t.device)).any()))


def _tex_buffer(tex, bmp_meta):
    """The texture twins' buffer on the tables' device: four floats a prim
    row (a bitmap rectangle's first texel row, H and W, then 0), then the
    texel rows; made once for these tensors."""
    def make(tex, bmp_meta):
        head = torch.zeros((bmp_meta.shape[0], 4), dtype=torch.float32,
                           device=tex.device)
        head[:, :3] = bmp_meta.float()
        return torch.cat([head.reshape(-1), tex.reshape(-1)])
    return _read_back('tex_buffer', (tex, bmp_meta), make)


def has_mirror(prim, msh) -> bool:
    """Do the tables (one pulse's or a CPI's) hold a smooth conductor,
    on a prim row (either lobe of a composite: columns 18 and 28, a
    strided view, so a card runs one compare) or a mesh-shape row?
    Reads them back from a card."""
    return bool((prim[..., 18:29:10] == CONDUCTOR).any()) or (
        msh is not None and bool((msh[..., 6] == CONDUCTOR).any()))


def _mirror_flag(mirror, prim, msh, doppler) -> bool:
    """The kernel's mirror flag: only the Doppler family reads it, and
    None reads the tables (a stall on a card)."""
    if not doppler:
        return False
    return has_mirror(prim, msh) if mirror is None else bool(mirror)


def _lobe_flag(lobes, prim, msh, doppler) -> int:
    """The lobe twins' flags of a call: only the Doppler family runs them,
    and None reads the tables, once while they live (`_read_back`)."""
    if not doppler:
        return 0
    if lobes is None:
        return _read_back('lobes', (prim, msh), lobe_flags)
    return int(lobes)


def _launch(params, prim, txp, msh, uniforms, mesh, lane_out, *, n_pulses,
            adc, max_depth, time_sampling, rx_kind, n_lanes, seed, seed_step,
            doppler, patch_p, rule, has_lo, coherent, mirror, rxph=None,
            eoff=None, medium=0, grid=None, ep=False, php=None, lobes=0,
            tex=None, bmp_meta=None, prims=False):
    """The CUDA kernel and its reduce over `n_pulses` pulses of stacked
    tables on a card: (acc (n_pulses, n_cells x n_ch) float32, n_events
    (n_pulses,) int64).  `eoff` launches the MIMO configuration, `medium`
    a configuration's media twin, `ep` its endpoint twin (the pair rows
    `php` of its phased transmitters, the pair row `rxph` of an analog
    phased receiver), `lobes` (LOBE_* flags) a Doppler configuration's
    lobe twin, `tex` (with `bmp_meta`) the flagship's, the Doppler power
    or the coherent configuration's texture twin, `prims` their prims twin
    (with `tex`, the one that also reads the texture codes)."""
    dev = params.device
    lib = LIBRARY.get()
    n_elem = 0 if eoff is None else int(eoff.shape[0])
    coherent = coherent or n_elem > 0
    n_ch = 2 * n_elem if n_elem else (2 if coherent else 1)
    n_cells = adc.n_time * adc.n_freq
    mode = grid_mode(n_cells, doppler, coherent, n_elem)
    n_prims = int(prim.shape[-2])
    n_tx = int(txp.shape[-2])
    n_msh = 0 if msh is None else int(msh.shape[-2])
    analog = rx_kind == 'phased' and eoff is None
    n_pairs = 0 if php is None else (int(php.shape[1]) - 2) // 6
    n_rx_pairs = (int(rxph.shape[1]) - 2) // 6 if analog else 0
    with torch.cuda.device(dev):
        blocks, threads, smem = launch_geometry(
            adc.n_time, n_lanes, n_prims, int(params.shape[-1]),
            mesh is not None, adc.n_freq, n_msh, doppler, coherent, n_pulses,
            n_elem, medium, ep, lobes, n_tx, n_pairs, n_rx_pairs,
            tex is not None, prims)
        tex_buf = None if tex is None else _tex_buffer(tex, bmp_meta)
        # per-block partial grids of each pulse (I and Q interleaved per
        # cell when coherent); one global grid of atomics a pulse in mode 2
        partial = torch.empty(
            (n_pulses * (1 if mode == 2 else blocks), n_cells * n_ch),
            dtype=torch.float64, device=dev)
        part_ev = torch.empty(n_pulses * blocks, dtype=torch.int64,
                              device=dev)
        acc = torch.empty((n_pulses, n_cells * n_ch), dtype=torch.float32,
                          device=dev)
        n_events = torch.empty(n_pulses, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        m = (None, None, None, 0) if mesh is None else (
            mesh.bbox.data_ptr(), mesh.links.data_ptr(),
            mesh.leaves.data_ptr(), mesh.stride)
        m_strides = (0, 0, 0) if mesh is None or n_pulses == 1 else tuple(
            int(x.shape[-1]) for x in (mesh.bbox, mesh.links, mesh.leaves))
        f_lo, f_hi = adc.freq_lo, adc.freq_hi
        err = lib.rk_launch(
            params.data_ptr(), prim.data_ptr(), txp.data_ptr(),
            None if msh is None else msh.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            partial.data_ptr(), part_ev.data_ptr(), acc.data_ptr(),
            n_events.data_ptr(), *m, patch_p,
            None if lane_out is None else lane_out.data_ptr(), n_lanes,
            seed & MASK64, adc.n_time, adc.n_freq, max_depth,
            int(time_sampling == 'gate'), int(rx_kind == 'omni'), n_prims,
            int(params.shape[-1]), n_msh, mode, int(coherent), rule,
            int(has_lo), int(mirror), adc.sampling_start,
            adc.sampling_time, 0.5 * (f_lo + f_hi), f_lo, f_hi - f_lo,
            max(f_hi - f_lo, 1e-30),
            n_pulses, seed_step & MASK64,
            n_draws(max_depth, n_tx, **lobe_draws(lobes)) * n_lanes,
            *m_strides, blocks, threads, smem,
            None if rxph is None else rxph.data_ptr(),
            None if eoff is None else eoff.data_ptr(), n_elem, medium,
            None if grid is None else grid.data_ptr(),
            *((0, 0, 0) if grid is None else grid.shape), n_tx, int(ep),
            None if php is None else php.data_ptr(),
            0 if php is None else int(php.shape[1]), int(analog),
            n_rx_pairs, lobes, None if tex is None else tex_buf.data_ptr(),
            0 if tex is None else int(tex.shape[1]), int(prims), stream)
        LIBRARY.check(err, 'receive_megakernel launch')
    return acc, n_events


def receive_megakernel(params, prim, txp, *, adc: ADCConfig, max_depth: int,
                       time_sampling: str, rx_kind: str, n_lanes: int,
                       seed: int = 0, uniforms=None,
                       mesh: PackedBVH | None = None, msh=None,
                       doppler: bool = False, patch_p: int = 0,
                       lane_out=None, receive_type: str = 'raw',
                       has_lo: bool = False, coherent: bool = False,
                       mirror: bool | None = None, rxph=None, eoff=None,
                       medium: int = 0, grid=None, php=None,
                       lobes: int | None = None, tex=None, bmp_meta=None,
                       textured: bool | None = None,
                       prims: bool | None = None):
    """Trace `n_lanes` receive samples.  Returns (acc (n_time, n_freq)
    float32, (n_time, n_freq, 2) I / Q with `coherent`, or (n_time, 1, 2E)
    with `eoff`, n_events 0-d int64) on the tables' device.

    `uniforms` (n_draws(max_depth), n_lanes) float32 feeds the draws
    (injected mode); without it the lanes draw from Philox4x32-10 keyed by
    `seed`.  `mesh` (BVH tables of stride 96, on the tables' device)
    selects the mesh configuration; `patch_p` its direction strata (0 =
    none; `patch_p_for`), read with the seed slot `params[0]`.
    `doppler` selects the Doppler configuration (`PackedScene.doppler`
    says which scenes need it), which takes a mesh's shape rows `msh`
    (n_mesh_shapes, 8) float32 and runs the mirror chains of smooth
    conductors; the flagship and mesh configurations read no velocity, no
    lobe but the diffuse one and no `msh`.  A `lane_out` (n_lanes,)
    float32 tensor receives each lane's contribution sum there (parity
    runs: it shows which lanes a triangle edge flipped), in the mesh and
    Doppler configurations (in the coherent one the sum of the lane's
    amplitudes sqrt(max(power, 0))).  `receive_type` and `has_lo` (an LO
    waveform packed at params[33:42]) pick the receive-frequency rule; a
    rule other than raw needs the Doppler configuration.  `coherent` (with
    `doppler`) selects the coherent configuration, which splats I / Q with
    the echo phase.  `mirror` says whether the tables hold a smooth
    conductor (`PackedScene.mirror`); None reads it from them, a stall on
    a card.  `eoff` (E, 3) float32, the element offsets of a phased
    array, with its packed receiver row `rxph` (1, 2 + 6K), selects the
    MIMO configuration (rx_kind 'phased', `doppler`, not `coherent`: it
    is its own I / Q mode, 2E channels).  `medium` (media.HOMOGENEOUS,
    LAYERED or GRID, packed in `params` by `pack_medium`; 0 vacuum)
    launches the configuration's media twin, which takes a GRID's (D, H,
    W) float32 cells `grid` on the tables' device.  `txp` (n_tx, 32)
    holds up to MAX_TX transmitter rows; several of them, a phased or area
    transmitter (their kinds txp[:, 27], read back from a card the first
    time a tensor is seen), or
    rx_kind 'phased' without `eoff` (an analog phased receiver, its pair
    row `rxph` (1, 2 + 6K)) launch the configuration's endpoint twin; a
    phased transmitter needs its pair rows `php` (n_tx, 2 + 6K).  `lobes`
    (LOBE_* flags, `PackedScene.lobes`; None reads them from the tables, a
    stall on a card) launches the Doppler configuration's lobe twin: the
    dielectric, plastic, GGX glass and composite lobes, and the draw
    stride `n_draws(max_depth, 1, **lobe_draws(lobes))`.  Prim rows with
    textures (column 26: 1 a checkerboard, 2 a bitmap) take the texel rows
    `tex` (R, Wp) float32 and `bmp_meta` (n_prims, 3) int32 of
    `pack_scene` and launch the flagship's, the Doppler power or the
    coherent configuration's texture twin (no other configuration has
    one); `textured` says whether
    they do (`PackedScene.textured`), and None reads column 26 back from
    the tables, a stall on a card the first time a tensor is seen.
    Spheres, disks and cylinders (column 0) launch the flagship's, the
    Doppler power or the coherent configuration's prims twin, the one that
    also carries the
    texture codes where the rows hold textures; `prims` says whether the
    rows hold one (`PackedScene.prims`),
    None reads column 0 back as `textured` does.  Tables
    on the CPU run the plain version (`receive_megakernel_ref`, fed
    `philox_uniforms` in PRNG mode); tables on a card launch the CUDA
    kernel, which raises if it cannot build or launch."""
    lobes = _lobe_flag(lobes, prim, msh, doppler)
    rule, tx_kinds, ep, textured, prims = _check_call(
        params, prim, txp, uniforms, mesh, msh, lane_out, (), adc=adc,
        max_depth=max_depth, time_sampling=time_sampling, rx_kind=rx_kind,
        n_lanes=n_lanes, doppler=doppler, patch_p=patch_p,
        receive_type=receive_type, has_lo=has_lo, coherent=coherent,
        rxph=rxph, eoff=eoff, medium=medium, grid=grid, php=php,
        lobes=lobes, tex=tex, bmp_meta=bmp_meta, textured=textured,
        prims=prims)
    if not textured:
        tex = bmp_meta = None
    n_tx = len(tx_kinds)
    if params.device.type == 'cpu':
        u = uniforms if uniforms is not None else philox_uniforms(
            seed, n_draws(max_depth, n_tx, **lobe_draws(lobes)), n_lanes)
        return receive_megakernel_ref(params, prim, txp, u, adc=adc,
                                      max_depth=max_depth,
                                      time_sampling=time_sampling,
                                      rx_kind=rx_kind, mesh=mesh, msh=msh,
                                      doppler=doppler, patch_p=patch_p,
                                      lane_out=lane_out,
                                      receive_type=receive_type,
                                      has_lo=has_lo, coherent=coherent,
                                      mirror=mirror, rxph=rxph, eoff=eoff,
                                      medium=medium, grid=grid, php=php,
                                      lobes=lobes, tex=tex,
                                      bmp_meta=bmp_meta)
    acc, n_events = _launch(
        params, prim, txp, msh, uniforms, mesh, lane_out, n_pulses=1,
        adc=adc, max_depth=max_depth, time_sampling=time_sampling,
        rx_kind=rx_kind, n_lanes=n_lanes, seed=seed, seed_step=0,
        doppler=doppler, patch_p=patch_p, rule=rule, has_lo=has_lo,
        coherent=coherent, mirror=_mirror_flag(mirror, prim, msh, doppler),
        rxph=rxph, eoff=eoff, medium=medium, grid=grid, ep=ep, php=php,
        lobes=lobes, tex=tex, bmp_meta=bmp_meta, prims=prims)
    receive_megakernel.launches += 1
    receive_megakernel.by_config[config_name(
        mesh is not None, doppler, coherent, eoff is not None,
        medium > 0, ep, lobes > 0, textured, prims)] += 1
    if eoff is not None:
        shape = (adc.n_time, adc.n_freq, 2 * int(eoff.shape[0]))
    else:
        shape = (adc.n_time, adc.n_freq) + ((2,) if coherent else ())
    return acc.view(shape), n_events[0]


def pulse_mesh(mesh: PackedBVH | None, p: int) -> PackedBVH | None:
    """Pulse p's BVH of a CPI's stacked tables."""
    if mesh is None:
        return None
    return dataclasses.replace(mesh, bbox=mesh.bbox[p], links=mesh.links[p],
                               leaves=mesh.leaves[p])


def receive_megakernel_cpi(params, prim, txp, *, adc: ADCConfig,
                           max_depth: int, time_sampling: str, rx_kind: str,
                           n_lanes: int, seed: int = 0, seed_step: int = 0,
                           uniforms=None, mesh: PackedBVH | None = None,
                           msh=None, doppler: bool = False, patch_p: int = 0,
                           lane_out=None, receive_type: str = 'raw',
                           has_lo: bool = False, coherent: bool = False,
                           mirror: bool | None = None, medium: int = 0,
                           grid=None, rxph=None, php=None,
                           lobes: int | None = None,
                           prims: bool | None = None):
    """A coherent processing interval (CPI) of P pulses in one launch: the
    pulse is a grid axis of the kernel.  The tables carry a leading pulse
    axis (params (P, 77), prim (P, n_prims, 34), txp (P, n_tx, 32), msh (P,
    n_msh, 8), the BVH tables (P, n) rows: `pack_cpi`), as do `uniforms`
    (P, n_draws, n_lanes) and `lane_out` (P, n_lanes).  Pulse p's lanes
    0 .. n_lanes - 1 draw Philox keyed by seed + seed_step * p (seed_step
    0: common random numbers, every pulse the same stream).  Otherwise as
    `receive_megakernel`, per pulse.  Returns (acc (P, n_time, n_freq) or
    (P, n_time, n_freq, 2), n_events (P,) int64).  The medium is one
    scene-wide row, the same in every pulse's params, and every pulse
    reads the one (D, H, W) `grid` of a GRID medium; so do the pair rows
    `php` of phased transmitters and `rxph` of an analog phased receiver
    (they follow from the specs, the same in every pulse).  Spheres,
    disks and cylinders (`prims`, as in `receive_megakernel`) launch the
    prims twin of the flagship, the Doppler power or the coherent
    configuration.  On the CPU
    the plain version runs pulse by pulse."""
    n_pulses = int(params.shape[0]) if params.dim() == 2 else 0
    if n_pulses < 1:
        raise ValueError('params: expected (n_pulses, 77)')
    lobes = _lobe_flag(lobes, prim, msh, doppler)
    rule, tx_kinds, ep, _, prims = _check_call(
        params, prim, txp, uniforms, mesh, msh, lane_out, (n_pulses,),
        adc=adc, max_depth=max_depth, time_sampling=time_sampling,
        rx_kind=rx_kind, n_lanes=n_lanes, doppler=doppler, patch_p=patch_p,
        receive_type=receive_type, has_lo=has_lo, coherent=coherent,
        medium=medium, grid=grid, rxph=rxph, php=php, lobes=lobes,
        prims=prims)
    n_tx = len(tx_kinds)
    nd = n_draws(max_depth, n_tx, **lobe_draws(lobes))
    shape = (n_pulses, adc.n_time, adc.n_freq) + ((2,) if coherent else ())
    if params.device.type == 'cpu':
        accs, evs = [], []
        for p in range(n_pulses):
            u = uniforms[p] if uniforms is not None else philox_uniforms(
                seed + seed_step * p, nd, n_lanes)
            a, n = receive_megakernel_ref(
                params[p], prim[p], txp[p], u, adc=adc, max_depth=max_depth,
                time_sampling=time_sampling, rx_kind=rx_kind,
                mesh=pulse_mesh(mesh, p),
                msh=None if msh is None else msh[p], doppler=doppler,
                patch_p=patch_p,
                lane_out=None if lane_out is None else lane_out[p],
                receive_type=receive_type, has_lo=has_lo, coherent=coherent,
                mirror=mirror, medium=medium, grid=grid, rxph=rxph, php=php,
                lobes=lobes)
            accs.append(a)
            evs.append(n)
        return torch.stack(accs).view(shape), torch.stack(evs)
    acc, n_events = _launch(
        params, prim, txp, msh, uniforms, mesh, lane_out, n_pulses=n_pulses,
        adc=adc, max_depth=max_depth, time_sampling=time_sampling,
        rx_kind=rx_kind, n_lanes=n_lanes, seed=seed, seed_step=seed_step,
        doppler=doppler, patch_p=patch_p, rule=rule, has_lo=has_lo,
        coherent=coherent, mirror=_mirror_flag(mirror, prim, msh, doppler),
        medium=medium, grid=grid, rxph=rxph, ep=ep, php=php, lobes=lobes,
        prims=prims)
    receive_megakernel_cpi.launches += 1
    receive_megakernel_cpi.by_config[config_name(
        mesh is not None, doppler, coherent, medium=medium > 0, ep=ep,
        lobes=lobes > 0, prims=prims)] += 1
    return acc.view(shape), n_events


VACUUM_CONFIGS = ('flagship', 'mesh', 'doppler', 'doppler_mesh', 'coherent',
                  'coherent_mesh', 'mimo')
# every configuration has a media twin (the kernel's MED instantiations)
# and an endpoint twin (EP: several transmitters, phased or area ones, an
# analog phased receiver), in vacuum; the Doppler family has a lobe twin
# (LOB: the dielectric, plastic, GGX glass and composite lobes), in vacuum
LOBE_CONFIGS = ('doppler', 'doppler_mesh', 'coherent', 'coherent_mesh')
# the flagship and the analytic Doppler and coherent configurations have a
# texture twin (TEX: checkerboard and bitmap rectangles), in vacuum
# and a prims twin (spheres, disks and cylinders), and a textured scene's
# prims twin, which also carries the texture codes (_tex_prims)
TEX_CONFIGS = ('flagship', 'doppler', 'coherent')
CONFIGS = VACUUM_CONFIGS + tuple(c + '_media' for c in VACUUM_CONFIGS) \
    + tuple(c + '_ep' for c in VACUUM_CONFIGS) \
    + tuple(c + '_lobes' for c in LOBE_CONFIGS) \
    + tuple(c + '_tex' for c in TEX_CONFIGS) \
    + tuple(c + '_prims' for c in TEX_CONFIGS) \
    + tuple(c + '_tex_prims' for c in TEX_CONFIGS)


def config_name(mesh: bool, doppler: bool, coherent: bool = False,
                mimo: bool = False, medium: bool = False,
                ep: bool = False, lobes: bool = False,
                tex: bool = False, prims: bool = False) -> str:
    name = 'mimo' if mimo else VACUUM_CONFIGS[
        int(mesh) + (4 if coherent else 2 * int(doppler))]
    return name + ('_media' if medium else '') + ('_ep' if ep else '') \
        + ('_lobes' if lobes else '') + ('_tex' if tex else '') \
        + ('_prims' if prims else '')


# launches of the CUDA kernel, in all and by configuration: one receive
# call, and one CPI (every pulse in one launch)
receive_megakernel.launches = 0
receive_megakernel.by_config = dict.fromkeys(CONFIGS, 0)
receive_megakernel_cpi.launches = 0
receive_megakernel_cpi.by_config = dict.fromkeys(CONFIGS, 0)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A scene's kernel tables on one device, and the configuration their
    power calls need (coherent calls take the coherent one)."""

    params: torch.Tensor
    prim: torch.Tensor
    txp: torch.Tensor
    msh: torch.Tensor | None      # mesh-shape rows (meshes only)
    mesh: PackedBVH | None
    doppler: bool
    mirror: bool      # a smooth conductor: the mirror chains
    rxph: torch.Tensor            # the receiver's phased row (1, 2 + 6K)
    php: torch.Tensor             # the transmitters' pair rows (n_tx, 2 + 6K)
    medium: int = 0               # the ambient medium's kind (0: vacuum)
    grid: torch.Tensor | None = None   # a grid medium's (D, H, W) cells
    lobes: int = 0                # the lobe twins' flags (LOBE_*)
    tex: torch.Tensor | None = None       # texel rows (textured scenes
    #                                       and the prims twins' scenes)
    bmp_meta: torch.Tensor | None = None  # their bitmap rectangles' rows
    textured: bool = False        # a checkerboard or bitmap rectangle
    prims: bool = False           # a sphere, disk or cylinder


def in_scope(scene, scene_data, rx, dev, reason: list,
             mimo: bool = False) -> bool:
    """`supported(scene_data, rx, reason, mimo)`, decided once per
    (scene_data, rx) on `dev` and kept with the scene: the check reads
    tables back from the card, which would stall every call.  A phased
    receive array (MIMO or analog) also needs a shape (the kernel takes
    its frame from it)."""
    cache = scene.__dict__.setdefault('_receive_kernel_scope', {})
    key = (rx.id, dev, mimo)
    hit = cache.get(key)
    if hit is None or hit[0] is not scene_data or hit[1] is not rx:
        why: list = []
        ok = supported(scene_data, rx, why, mimo)
        if ok and rx_kind_of(rx) == 'phased' and \
                scene.shape_index_of_endpoint('receiver', rx.id) < 0:
            ok = False
            why.append('a free-standing phased receiver: the kernel takes '
                       "the array's frame from its rectangle; the "
                       'wavefront runs it')
        hit = (scene_data, rx, ok, why)
        cache[key] = hit
    reason.extend(hit[3])
    return hit[2]


def _device_tables(scene, scene_data, rx, dev,
                   mimo: bool = False) -> DeviceTables:
    """The kernel tables of (scene_data, rx) on `dev`.  The scope check
    and the pack (and a mesh's BVH build) read the tables back from the
    card, so they run once per pair: the scene keeps the last pair of each
    receiver and device, and a call with the same objects launches without
    touching the host."""
    cache = scene.__dict__.setdefault('_receive_kernel_tables', {})
    key = (rx.id, dev, mimo)
    hit = cache.get(key)
    if hit is not None and hit[0] is scene_data and hit[1] is rx:
        return hit[2]
    why: list = []
    if not in_scope(scene, scene_data, rx, dev, why, mimo):
        raise NotImplementedError(
            "scene outside the receive kernel's scope: " + '; '.join(why))
    packed = pack_scene(scene_data, rx,
                        scene.shape_index_of_endpoint('receiver', rx.id))
    doppler = packed.doppler(rx.adc)
    params, prim, txp, php = (torch.as_tensor(a, device=dev).contiguous()
                              for a in (packed.params, packed.prim,
                                        packed.txp, packed.php))
    tables = DeviceTables(
        params=params, prim=prim, txp=txp,
        msh=torch.as_tensor(packed.msh, device=dev).contiguous()
        if packed.mesh is not None else None,
        mesh=None if packed.mesh is None else packed.mesh.to(dev),
        doppler=doppler, mirror=packed.mirror,
        rxph=torch.as_tensor(packed.rxph, device=dev).contiguous(),
        php=php,
        medium=packed.medium, grid=None if packed.grid is None
        else torch.as_tensor(packed.grid, device=dev).contiguous(),
        lobes=packed.lobes,
        tex=torch.as_tensor(packed.tex, device=dev).contiguous()
        if packed.textured else None,
        bmp_meta=torch.as_tensor(packed.bmp_meta, device=dev)
        if packed.textured else None,
        textured=packed.textured, prims=packed.prims)
    cache[key] = (scene_data, rx, tables)
    return tables


def rx_kind_of(rx) -> str:
    """The kernel's receiver kind of a spec: 'omni', 'phased' (an array of
    more than one element: MIMO, or analog with its cross-WDF) or
    'wigner'."""
    if rx.kind == OMNI:
        return 'omni'
    return 'phased' if rx.kind == PHASED and rx.n_elems > 1 else 'wigner'


def seed_slot(seed: int) -> float:
    """The JAX package's per-call seed slot params[0]: float32 of
    seed * 1_000_003 % 2^30 (it offsets the direction strata)."""
    return float(np.float32(seed * 1_000_003 % (1 << 30)))


def array_offsets(scene, scene_data, rx, dev) -> torch.Tensor:
    """(E, 3) float32 world offsets of the receive elements on `dev`
    (`rx_elem_offsets`), cached per (scene_data, rx) as the JAX package
    caches them: deriving them reads the receiver's shape back."""
    cache = scene.__dict__.setdefault('_receive_kernel_eoff', {})
    key = (rx.id, dev)
    hit = cache.get(key)
    if hit is None or hit[0] is not scene_data or hit[1] is not rx:
        si = scene.shape_index_of_endpoint('receiver', rx.id)
        eo = rx_elem_offsets(scene_data, rx, si)
        hit = (scene_data, rx, eo.to(device=dev,
                                     dtype=torch.float32).contiguous())
        cache[key] = hit
    return hit[2]


def receive_kernel(scene, scene_data, rx, spp: int, seed: int = 0,
                   max_depth: int = 3, time_sampling: str = 'gate',
                   coherent: bool = False, mimo: bool = False,
                   elem_offsets=None, device=None):
    """Run the receive kernel on `scene_data`'s tables, in the
    configuration they and the call need.  Returns (signal (n_time,
    n_freq) float32 accumulated power, (n_time, n_freq, 2) I / Q with
    `coherent`, or (n_time, 1, 2E) per-element I / Q with `mimo`,
    n_samples).  `mimo` runs the MIMO configuration of a phased receiver,
    its element offsets `elem_offsets` (E, 3) or, by default, the
    receiver spec's grid (`array_offsets`, cached).

    n_samples is `spp`, rounded down to whole 1024-lane tiles (at least
    one) for mesh scenes, as the JAX package rounds its mesh lanes.  The
    lanes draw from Philox4x32-10 keyed by `seed`: the kernel's own
    generator on a card, `philox_uniforms` on the CPU, so one seed gives
    one stream on both.  Develop with `receive.develop_signal`
    (x n_time / n_samples)."""
    dev = resolve_device(device)
    if mimo and coherent:
        raise ValueError('mimo is its own I / Q mode: drop coherent')
    tab = _device_tables(scene, scene_data, rx, dev, mimo)
    if mimo:
        eoff = array_offsets(scene, scene_data, rx, dev) if \
            elem_offsets is None else torch.as_tensor(
                elem_offsets, dtype=torch.float32, device=dev).contiguous()
        acc, _ = receive_megakernel(
            tab.params, tab.prim, tab.txp, adc=rx.adc, max_depth=max_depth,
            time_sampling=time_sampling, rx_kind='phased', n_lanes=spp,
            seed=seed, doppler=True, receive_type=rx.receive_type,
            has_lo=rx.lo_waveform is not None, mirror=tab.mirror,
            rxph=tab.rxph, eoff=eoff, medium=tab.medium, grid=tab.grid,
            php=tab.php, lobes=tab.lobes, textured=False, prims=False)
        return acc, spp
    rx_kind = rx_kind_of(rx)
    n_lanes, patch_p, params = spp, 0, tab.params
    if tab.mesh is not None:
        n_lanes = max(TILE, (spp // TILE) * TILE)
        if rx_kind == 'wigner':
            patch_p = patch_p_for(n_lanes)
        params = params.clone()
        params[0] = seed_slot(seed)
    doppler = tab.doppler or coherent
    acc, _ = receive_megakernel(
        params, tab.prim, tab.txp, adc=rx.adc, max_depth=max_depth,
        time_sampling=time_sampling, rx_kind=rx_kind, n_lanes=n_lanes,
        seed=seed, mesh=tab.mesh, msh=tab.msh if doppler else None,
        doppler=doppler, patch_p=patch_p, receive_type=rx.receive_type,
        has_lo=rx.lo_waveform is not None, coherent=coherent,
        mirror=tab.mirror, medium=tab.medium, grid=tab.grid,
        rxph=tab.rxph if rx_kind == 'phased' else None, php=tab.php,
        lobes=tab.lobes if doppler else 0, tex=tab.tex,
        bmp_meta=tab.bmp_meta, textured=tab.textured, prims=tab.prims)
    return acc, n_lanes


# ---------------------------------------------------------------------------
# the coherent processing interval (CPI): every pulse in one launch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedCPI:
    """The kernel tables of a CPI's pulse snapshots, stacked on a leading
    pulse axis (numpy; `mesh` on the CPU), and the static flags ORed over
    the pulses, as the JAX package's scan bakes them."""

    params: np.ndarray   # (P, 77) f32; [p, 0] is pulse p's seed slot
    prim: np.ndarray     # (P, n_prims, 34)
    txp: np.ndarray      # (P, n_tx, 32)
    msh: np.ndarray      # (P, n_mesh_shapes, 8)
    php: np.ndarray      # (n_tx, 2 + 6K) pair rows, every pulse's
    rxph: np.ndarray     # (1, 2 + 6K_rx) the receiver's pair row
    mesh: PackedBVH | None   # BVH tables (P, n) rows
    rx_rule: int
    moving: bool
    ggx: bool
    mirror: bool
    medium: int = 0                 # the scene's medium, as in every pulse
    grid: np.ndarray | None = None  # its (D, H, W) cells, shared (GRID)
    lobes: int = 0                  # the lobe twins' flags (LOBE_*)

    @property
    def n_pulses(self) -> int:
        return int(self.params.shape[0])

    def doppler(self, adc: ADCConfig) -> bool:
        return needs_doppler(self, adc)


def stack_meshes(meshes: list) -> PackedBVH:
    """One pulse axis over per-pulse BVH tables.  Rigid motion keeps a
    tree's shape, so the tables stack; a change of topology raises."""
    m0 = meshes[0]
    for m in meshes[1:]:
        if (m.bbox.shape != m0.bbox.shape or m.links.shape != m0.links.shape
                or m.leaves.shape != m0.leaves.shape
                or m.stride != m0.stride):
            raise ValueError(
                'per-pulse mesh BVH tables do not stack (topology changed '
                "across the CPI) — use receive_cpi(engine='loop')")
    return dataclasses.replace(
        m0, bbox=torch.stack([m.bbox for m in meshes]),
        links=torch.stack([m.links for m in meshes]),
        leaves=torch.stack([m.leaves for m in meshes]))


def pack_cpi_tables(snapshots: list, rx, shape_idx: int) -> PackedCPI:
    """Pack each pulse's compiled snapshot (SceneData) with the receiver
    `rx` and stack the tables.  The pulses must share their static scene
    configuration (prim kinds and lobes, mesh presence and shape rows)."""
    packs = [pack_scene(sd, rx, shape_idx) for sd in snapshots]
    p0 = packs[0]
    for pk in packs[1:]:
        if pk.prim.shape != p0.prim.shape or pk.msh.shape != p0.msh.shape \
                or not np.array_equal(pk.prim[:, [0, 14, 18, 27, 28]],
                                      p0.prim[:, [0, 14, 18, 27, 28]]) \
                or not np.array_equal(pk.msh[:, 6], p0.msh[:, 6]):
            raise ValueError('pulse snapshots must share static scene config')
        if (pk.mesh is None) != (p0.mesh is None):
            raise ValueError('pulse snapshots must agree on mesh presence')
        if pk.txp.shape != p0.txp.shape \
                or not np.array_equal(pk.txp[:, 27], p0.txp[:, 27]) \
                or not np.array_equal(pk.php, p0.php):
            raise ValueError('pulse snapshots must share their transmitters '
                             '(kinds and pair rows)')
        if pk.medium != p0.medium or pk.params[29] != p0.params[29] \
                or not np.array_equal(pk.params[42:], p0.params[42:]) \
                or (pk.grid is not None
                    and not np.array_equal(pk.grid, p0.grid)):
            raise ValueError('pulse snapshots must share the medium')
    return PackedCPI(
        params=np.stack([pk.params for pk in packs]),
        prim=np.stack([pk.prim for pk in packs]),
        txp=np.stack([pk.txp for pk in packs]),
        msh=np.stack([pk.msh for pk in packs]), php=p0.php, rxph=p0.rxph,
        mesh=None if p0.mesh is None else stack_meshes(
            [pk.mesh for pk in packs]),
        rx_rule=p0.rx_rule, moving=any(pk.moving for pk in packs),
        ggx=any(pk.ggx for pk in packs),
        mirror=any(pk.mirror for pk in packs), medium=p0.medium,
        grid=p0.grid, lobes=p0.lobes)


def cpi_receiver(snapshot, receiver_id: str | None):
    rxs = snapshot.receivers
    return rxs[0] if receiver_id is None else next(
        r for r in rxs if r.id == receiver_id)


def pack_cpi(scene, n_pulses: int, prf: float, t0: float = 0.0,
             receiver_id: str | None = None):
    """The CPI's tables: `scene.at_time(t0 + p / prf)` packed for every
    pulse p with the first snapshot's receiver, stacked.  Returns
    (PackedCPI, receiver spec, receiver shape row).  Cached on the scene
    per (pulse grid, receiver), as the JAX package caches its packs: edit
    a scene through its builders, which make new objects.  The medium, a
    plain field of the scene, is checked on every call: a pack of another
    medium is made anew.  Raises `NotImplementedError` outside the
    kernel's scope."""
    cache = scene.__dict__.setdefault('_receive_cpi_pack', {})
    key = (n_pulses, float(prf), float(t0), receiver_id)
    hit = cache.get(key)
    if hit is None or hit[3] is not scene.medium:
        snaps = [scene.at_time(t0 + p / prf) for p in range(n_pulses)]
        rx = cpi_receiver(snaps[0], receiver_id)
        sds = [sn.compile(use_bvh=False, device='cpu') for sn in snaps]
        why: list = []
        if not supported(sds[0], rx, why):
            raise NotImplementedError(
                "scene outside the receive kernel's scope: "
                + '; '.join(why))
        if _textured_scope(sds[0], why.append):
            raise NotImplementedError(
                'a textured CPI: the texture twins run one pulse (ROADMAP '
                'B7); the per-pulse loop runs it')
        si = snaps[0].shape_index_of_endpoint('receiver', rx.id)
        hit = cache[key] = (pack_cpi_tables(sds, rx, si), rx, si,
                            scene.medium)
    return hit[:3]


def cpi_seeds(seed: int, n_pulses: int, common_random_numbers: bool):
    """Each pulse's seed: `seed`, or seed + 7919 p without common random
    numbers (the JAX package's rule)."""
    step = 0 if common_random_numbers else 7919
    return [seed + step * p for p in range(n_pulses)], step


def receive_kernel_cpi(scene, n_pulses: int, prf: float, t0: float = 0.0,
                       seed: int = 0, spp: int = 1 << 20,
                       max_depth: int = 3, time_sampling: str = 'gate',
                       coherent: bool = True,
                       common_random_numbers: bool = True,
                       receiver_id: str | None = None, device=None):
    """A CPI through the kernel: `pack_cpi`, then every pulse in one launch
    (`receive_megakernel_cpi`).  Returns (cube (n_pulses, n_time, n_freq)
    power, or (n_pulses, n_time, n_freq, 2) I / Q with `coherent`,
    samples a pulse); samples as in `receive_kernel`."""
    dev = resolve_device(device)
    packed, rx, si = pack_cpi(scene, n_pulses, prf, t0, receiver_id)
    cache = scene.__dict__.setdefault('_receive_cpi_tables', {})
    key = (n_pulses, float(prf), float(t0), receiver_id, dev)
    tab = cache.get(key)
    if tab is None or tab[0] is not packed:
        tab = (packed, *(torch.as_tensor(a, device=dev).contiguous()
                         for a in (packed.params, packed.prim, packed.txp,
                                   packed.msh, packed.php, packed.rxph)),
               None if packed.mesh is None else packed.mesh.to(dev),
               None if packed.grid is None
               else torch.as_tensor(packed.grid, device=dev).contiguous())
        cache[key] = tab
    _, params, prim, txp, msh, php, rxph, mesh, grid = tab
    seeds, step = cpi_seeds(seed, n_pulses, common_random_numbers)
    rx_kind = rx_kind_of(rx)
    n_lanes, patch_p = spp, 0
    if mesh is not None:
        n_lanes = max(TILE, (spp // TILE) * TILE)
        if rx_kind == 'wigner':
            patch_p = patch_p_for(n_lanes)
    # each pulse's seed slot (the direction strata's offset)
    params = params.clone()
    params[:, 0] = torch.tensor([seed_slot(s) for s in seeds],
                                dtype=torch.float32, device=dev)
    doppler = packed.doppler(rx.adc) or coherent
    acc, _ = receive_megakernel_cpi(
        params, prim, txp, adc=rx.adc, max_depth=max_depth,
        time_sampling=time_sampling, rx_kind=rx_kind, n_lanes=n_lanes,
        seed=seed, seed_step=step, mesh=mesh,
        msh=msh if doppler and mesh is not None else None, doppler=doppler,
        patch_p=patch_p, receive_type=rx.receive_type,
        has_lo=rx.lo_waveform is not None, coherent=coherent,
        mirror=packed.mirror, medium=packed.medium, grid=grid,
        rxph=rxph if rx_kind == 'phased' else None, php=php,
        lobes=packed.lobes if doppler else 0)
    return acc, n_lanes
