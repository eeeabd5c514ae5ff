"""BVH queries on Hopper: packed tables, plain PyTorch walks and the
wrappers of the CUDA kernels in `csrc/bvh_kernels.cu` (counterpart of
`beifong_tpu/geometry/pallas_bvh.py`).

`pack` flattens a threaded BVH (`geometry/bvh.py`) into the flat tables
the kernels read, bit for bit as the JAX package packs them: bbox
(N*6 + 16*6,) f32 (16 inverted pad boxes, which the TPU's DFS window
reads past the last node and this walk never does), links (N*3,) i32
[hit_link, miss_link, leaf_id], leaves (L*stride,) f32 with 8 triangles a
row (stride 80, +8 per payload channel).

`bvh_closest` (K2) and `bvh_any` (K3) run their plain versions for
tensors on the CPU and the CUDA kernels for tensors on a card.  The plain
versions walk per ray, as the kernels do: every ray follows its own hit /
miss links (`walk_ref`, lanes still walking compacted at each step).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _nvcc
from .bvh import BVH, safe_inv

K_LEAF = 8
_INF = 3.4e38
_PAD_BOXES = 16   # the JAX package's max(WINDOW, 16) inverted boxes


@dataclasses.dataclass(frozen=True)
class PackedBVH:
    """Kernel-ready flat tables on one device."""

    bbox: torch.Tensor     # (N*6 + 96,) f32: [bbmin(3), bbmax(3)] per node
    links: torch.Tensor    # (N*3,) i32: [hit_link, miss_link, leaf_id]
    leaves: torch.Tensor   # (L*stride,) f32: v0x*8 v0y*8 v0z*8 e1*24 e2*24
    #                        idx*8 [payload*8 at 80][payload2*8 at 88]
    n_nodes: int
    n_leaves: int
    stride: int = 80

    def to(self, device) -> "PackedBVH":
        return dataclasses.replace(
            self, bbox=self.bbox.to(device), links=self.links.to(device),
            leaves=self.leaves.to(device))


def pack(bvh: BVH, payload=None, payload2=None) -> PackedBVH:
    """Flatten a threaded BVH, padding every leaf to K_LEAF triangles
    (zero-edge pads with index -1 never hit).  `payload`: optional (T,) f32
    per original face (the reflectance in the receive kernel) at column
    80; `payload2` a second one at 88 (the owning shape's row), which
    needs `payload`.  Tables on the CPU."""
    if payload2 is not None and payload is None:
        raise ValueError('payload2 needs payload')
    n = bvh.n_nodes
    bbox = np.concatenate([bvh.bb_min, bvh.bb_max], axis=1).astype(np.float32)
    bbox = np.concatenate([bbox, np.tile(
        np.array([[_INF, _INF, _INF, -_INF, -_INF, -_INF]], np.float32),
        (_PAD_BOXES, 1))], axis=0)
    links = np.stack([bvh.hit_link, bvh.miss_link,
                      np.full(n, -1, np.int32)], axis=1).astype(np.int32)
    stride = 80 + (0 if payload is None else 8) \
        + (0 if payload2 is None else 8)
    leaf_nodes = np.nonzero(bvh.leaf_offset >= 0)[0]
    rows = np.zeros((max(len(leaf_nodes), 1), stride), np.float32)
    for li, ni in enumerate(leaf_nodes):
        links[ni, 2] = li
        off, cnt = int(bvh.leaf_offset[ni]), int(bvh.leaf_count[ni])
        row = rows[li]
        row[72:80] = -1.0
        for k in range(min(cnt, K_LEAF)):
            for c, arr in enumerate((bvh.v0, bvh.e1, bvh.e2)):
                for ax in range(3):
                    row[24 * c + 8 * ax + k] = arr[off + k, ax]
            f = int(bvh.perm[off + k])
            row[72 + k] = float(f)
            if payload is not None:
                row[80 + k] = float(payload[f])
            if payload2 is not None:
                row[88 + k] = float(payload2[f])
    return PackedBVH(bbox=torch.from_numpy(bbox.reshape(-1)),
                     links=torch.from_numpy(links.reshape(-1)),
                     leaves=torch.from_numpy(rows.reshape(-1)),
                     n_nodes=n, n_leaves=rows.shape[0], stride=stride)


# ---------------------------------------------------------------------------
# plain PyTorch walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WalkResult:
    """Per ray: closest t (3.4e38 if none), its leaf row and slot (-1 / 0
    if none) and u, v; or the occlusion flag of an any-hit walk."""

    t: torch.Tensor
    leaf: torch.Tensor
    slot: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    occ: torch.Tensor


def walk_ref(pb: PackedBVH, ox, oy, oz, dx, dy, dz, limit, anyhit: bool,
             stats: dict | None = None, visits=None) -> WalkResult:
    """Per-ray stackless walk of every ray (1-D float32 tensors).

    Closest hit (`anyhit=False`): a box must be entered before
    min(best t, `limit`), and a triangle wins if its t is below the ray's
    best (the kernel's K2 rule with `limit` = 3.4e38, and K1's mesh hit
    pruned by the analytic best).  Any hit: a box must be entered before
    `limit`, a triangle with t < `limit` occludes, and the ray stops there.

    `stats`, if given, accumulates 'node_tests' (slab tests) and
    'leaf_tests' (leaves entered, 8 triangle tests each); `visits`, an
    (n, 2) int64 tensor, each ray's slab tests and leaves entered."""
    dev = ox.device
    n = int(ox.shape[0])
    bbox = pb.bbox.view(-1, 6)
    links = pb.links.view(-1, 3)
    leaves = pb.leaves.view(-1, pb.stride)
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    leaf_b = torch.full((n,), -1, dtype=torch.long, device=dev)
    slot_b = torch.zeros(n, dtype=torch.long, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    cur = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    n_nodes = n_leaves = 0
    while cur.numel():
        b = bbox[node]
        ox_c, oy_c, oz_c = ox[cur], oy[cur], oz[cur]
        tx0 = (b[:, 0] - ox_c) * ix[cur]
        tx1 = (b[:, 3] - ox_c) * ix[cur]
        ty0 = (b[:, 1] - oy_c) * iy[cur]
        ty1 = (b[:, 4] - oy_c) * iy[cur]
        tz0 = (b[:, 2] - oz_c) * iz[cur]
        tz1 = (b[:, 5] - oz_c) * iz[cur]
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        tb = limit[cur] if anyhit else torch.minimum(t[cur], limit[cur])
        enter = (tf >= torch.clamp(tn, min=0.0)) & (tn < tb)
        lk = links[node]
        at_leaf = enter & (lk[:, 2] >= 0)
        n_nodes += int(cur.numel())
        li = cur[at_leaf]
        if visits is not None:
            visits[cur, 0] += 1
            visits[li, 1] += 1
        if li.numel():
            n_leaves += int(li.numel())
            lid = lk[at_leaf, 2].long()
            rows = leaves[lid]
            rox, roy, roz = ox[li], oy[li], oz[li]
            rdx, rdy, rdz = dx[li], dy[li], dz[li]
            lim = limit[li]
            for k in range(K_LEAF):
                (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                 tri) = (rows[:, 8 * c + k] for c in range(10))
                px = rdy * e2z - rdz * e2y
                py = rdz * e2x - rdx * e2z
                pz = rdx * e2y - rdy * e2x
                det = e1x * px + e1y * py + e1z * pz
                big = det.abs() > 1e-12
                inv = torch.where(big, 1.0, 0.0) / torch.where(big, det, 1.0)
                tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
                uu = (tvx * px + tvy * py + tvz * pz) * inv
                qx = tvy * e1z - tvz * e1y
                qy = tvz * e1x - tvx * e1z
                qz = tvx * e1y - tvy * e1x
                vv = (rdx * qx + rdy * qy + rdz * qz) * inv
                tt = (e2x * qx + e2y * qy + e2z * qz) * inv
                hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                       & (tt > 1e-4) & (tri >= 0.0))
                if anyhit:
                    occ[li] = occ[li] | (hit & (tt < lim))
                    continue
                tl = t[li]
                better = hit & (tt < tl)
                t[li] = torch.where(better, tt, tl)
                u[li] = torch.where(better, uu, u[li])
                v[li] = torch.where(better, vv, v[li])
                leaf_b[li] = torch.where(better, lid, leaf_b[li])
                slot_b[li] = torch.where(better, k, slot_b[li])
        nxt = torch.where(enter, lk[:, 0], lk[:, 1]).long()
        keep = nxt >= 0
        if anyhit:
            keep = keep & ~occ[cur]
        cur, node = cur[keep], nxt[keep]
    if stats is not None:
        stats['walks'] = stats.get('walks', 0) + n
        stats['node_tests'] = stats.get('node_tests', 0) + n_nodes
        stats['leaf_tests'] = stats.get('leaf_tests', 0) + n_leaves
    return WalkResult(t=t, leaf=leaf_b, slot=slot_b, u=u, v=v, occ=occ)


def leaf_column(pb: PackedBVH, leaf, slot, col: int):
    """Column `col` (+ slot) of leaf row `leaf` per ray (0 where leaf < 0)."""
    rows = pb.leaves.view(-1, pb.stride)
    val = rows[leaf.clamp(min=0), col + slot]
    return torch.where(leaf >= 0, val, 0.0)


def _split(x):
    return x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2].contiguous()


def bvh_closest_ref(pb: PackedBVH, o, d, stats: dict | None = None):
    """Plain version of K2: (t, face index, u, v) per (R, 3) ray; t = inf
    and index -1 on a miss."""
    n = int(o.shape[0])
    lim = torch.full((n,), _INF, dtype=torch.float32, device=o.device)
    w = walk_ref(pb, *_split(o), *_split(d), lim, anyhit=False,
                 stats=stats)
    miss = w.t >= _INF
    idx = torch.where(miss, -1, leaf_column(pb, w.leaf, w.slot, 72))
    return (torch.where(miss, float('inf'), w.t), idx.to(torch.int32),
            w.u, w.v)


def bvh_any_ref(pb: PackedBVH, o, d, maxt, stats: dict | None = None):
    """Plain version of K3: True where a triangle blocks a (R, 3) ray
    before maxt (1 - 1e-3)."""
    w = walk_ref(pb, *_split(o), *_split(d), maxt * (1.0 - 1e-3),
                 anyhit=True, stats=stats)
    return w.occ


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

STACK = 64   # csrc/bvh_kernels.cu: deferred children a ray may hold


@dataclasses.dataclass(frozen=True)
class WalkTables:
    """The kernels' layout of a PackedBVH, derived from its tables on their
    device: `rec` (n_inner + 1, 16) f32 node pairs, record 0 the root's
    box and reference (and at 11 the number of records), record j > 0
    the j-th inner node (in the tables' order) as [left min xyz, left
    ref, left max xyz, 0, right min xyz, right ref, right max xyz, 0], a
    ref (int32 bits) j > 0 for an inner child and ~(leaf row * 8 + count
    - 1) for a leaf; `tri` (L*8, 12) f32, each leaf slot as [v0 xyz, face
    index, e1 xyz, 0, e2 xyz, 0]."""

    rec: torch.Tensor
    tri: torch.Tensor
    depth: int


def tree_depth(links: np.ndarray, n_nodes: int) -> int:
    """Nodes on the longest root-to-leaf path of the threaded tables'
    tree ((N*3,) int32 links)."""
    lk = links.reshape(-1, 3)[:n_nodes]
    depth, level = 0, np.zeros(1, np.int64)
    while level.size:
        depth += 1
        inner = level[lk[level, 2] < 0]
        left = lk[inner, 0].astype(np.int64)
        level = np.concatenate([left, lk[left, 1].astype(np.int64)])
    return depth


def walk_tables(pb: PackedBVH) -> WalkTables:
    """The node pairs and float4 triangles of `pb` on its device, derived
    once a PackedBVH (cached on it)."""
    cached = pb.__dict__.get('_walk_tables')
    if cached is not None:
        return cached
    dev = pb.bbox.device
    n = pb.n_nodes
    depth = tree_depth(pb.links.cpu().numpy(), n)
    if depth - 1 > STACK:
        raise ValueError(f'BVH of depth {depth}: the kernels hold at most '
                         f'{STACK} deferred children')
    links = pb.links.view(-1, 3)[:n].long()
    box = pb.bbox.view(-1, 6)[:n].contiguous().view(torch.int32)
    rows = pb.leaves.view(-1, pb.stride)
    count = (rows[:, 72:80] >= 0).sum(1).clamp(min=1)
    inner = links[:, 2] < 0
    rec_of = torch.cumsum(inner.long(), 0)
    leaf = links[:, 2].clamp(min=0)
    ref = torch.where(inner, rec_of,
                      -(leaf * 8 + count[leaf] - 1) - 1).to(torch.int32)
    left = links[inner, 0]
    rec = torch.zeros((int(inner.sum()) + 1, 4, 4), dtype=torch.int32,
                      device=dev)
    root = torch.zeros(1, dtype=torch.long, device=dev)
    for rows_, s, nodes in ((slice(0, 1), 0, root), (slice(1, None), 0, left),
                            (slice(1, None), 2, links[left, 1])):
        rec[rows_, s, :3] = box[nodes, :3]
        rec[rows_, s, 3] = ref[nodes]
        rec[rows_, s + 1, :3] = box[nodes, 3:]
    rec[0, 2, 3] = rec.shape[0]
    tri = torch.zeros((rows.shape[0], 8, 3, 4), dtype=torch.float32,
                      device=dev)
    for c in range(3):           # v0, e1, e2
        for ax in range(3):
            tri[:, :, c, ax] = rows[:, 24 * c + 8 * ax:24 * c + 8 * ax + 8]
    tri[:, :, 0, 3] = rows[:, 72:80]
    out = WalkTables(rec=rec.view(torch.float32).reshape(-1, 16),
                     tri=tri.reshape(-1, 12), depth=depth)
    pb.__dict__['_walk_tables'] = out
    return out


def _bind(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.bvh_closest_launch.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp,
                                       vp, vp]
    lib.bvh_closest_launch.restype = ctypes.c_int
    lib.bvh_any_launch.argtypes = [vp, vp, vp, vp, vp, i64, vp, vp, vp]
    lib.bvh_any_launch.restype = ctypes.c_int


LIBRARY = _nvcc.Library('bvh_kernels', 'bvh', _bind)


def build_library() -> _nvcc.BuildInfo:
    return _nvcc.build('bvh_kernels')


def _check(name, t, dev, shape):
    if t.shape != shape or t.dtype != torch.float32 or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f'{name}: expected contiguous float32 {shape} on '
                         f'{dev}, got {t.dtype} {tuple(t.shape)} on '
                         f'{t.device}')


def _check_inputs(pb: PackedBVH, o, d, maxt=None):
    dev = pb.bbox.device
    n = o.shape[0]
    _check('o', o, dev, (n, 3))
    _check('d', d, dev, (n, 3))
    if maxt is not None:
        _check('maxt', maxt, dev, (n,))
    if pb.links.device != dev or pb.leaves.device != dev:
        raise ValueError('the BVH tables lie on different devices')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'no BVH kernel for device {dev}')
    return dev, n


def bvh_closest(pb: PackedBVH, o, d):
    """Closest hit of (R, 3) rays: (t, face index int32, u, v) as
    `pallas_bvh.bvh_closest` returns them (t = inf, index -1 on a miss).
    Tables and rays on the CPU run the plain version; on a card, K2, whose
    four outputs are views of one buffer."""
    dev, n = _check_inputs(pb, o, d)
    if dev.type == 'cpu':
        return bvh_closest_ref(pb, o, d)
    lib = LIBRARY.get()
    wt = walk_tables(pb)
    with torch.cuda.device(dev):
        buf = torch.empty(4 * n + 2, dtype=torch.float32, device=dev)
        p = buf.data_ptr()    # t, idx, u, v, then the launch's counter
        err = lib.bvh_closest_launch(
            wt.rec.data_ptr(), wt.tri.data_ptr(), o.data_ptr(),
            d.data_ptr(), n, p, p + 4 * n, p + 8 * n, p + 12 * n,
            p + 16 * n, torch.cuda.current_stream(dev).cuda_stream)
        LIBRARY.check(err, 'bvh_closest launch')
    bvh_closest.launches += 1
    t, idx, u, v = buf[:4 * n].view(4, n).unbind(0)
    return t, idx.view(torch.int32), u, v


bvh_closest.launches = 0


def bvh_any(pb: PackedBVH, o, d, maxt):
    """Occlusion of (R, 3) rays: True where a triangle blocks before
    maxt (1 - 1e-3), as `pallas_bvh.bvh_any`.  Tables and rays on the CPU
    run the plain version; on a card, K3, whose flags are a view of its
    buffer."""
    dev, n = _check_inputs(pb, o, d, maxt)
    if dev.type == 'cpu':
        return bvh_any_ref(pb, o, d, maxt)
    lib = LIBRARY.get()
    wt = walk_tables(pb)
    with torch.cuda.device(dev):
        head = (n + 7) // 8 * 8
        buf = torch.empty(head + 8, dtype=torch.bool, device=dev)
        p = buf.data_ptr()    # the flags, then the launch's counter
        err = lib.bvh_any_launch(
            wt.rec.data_ptr(), wt.tri.data_ptr(), o.data_ptr(),
            d.data_ptr(), maxt.data_ptr(), n, p, p + head,
            torch.cuda.current_stream(dev).cuda_stream)
        LIBRARY.check(err, 'bvh_any launch')
    bvh_any.launches += 1
    return buf[:n]


bvh_any.launches = 0
