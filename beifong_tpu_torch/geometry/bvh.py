"""Threaded BVH over a triangle soup: host build and plain traversal
(counterpart of `beifong_tpu/geometry/bvh.py`).

`build` is the JAX package's numpy median-split builder (its C++ builder
in `native/` waits: the kernel path builds with `align=True`, which never
takes it).  The tree is threaded: every node carries a `hit_link` (next
node when its box is entered) and a `miss_link` (next node when it is
skipped, -1 = done), so a walk needs no stack.  `traverse_closest` and
`traverse_any` are the JAX package's lock-step wavefront walks, written
in PyTorch; the tests use them as a second reference for the kernels in
`geometry/bvh_kernel.py`.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

LEAF_SIZE = 8


@dataclasses.dataclass(frozen=True)
class BVH:
    """Host-side tables (numpy)."""

    bb_min: np.ndarray       # (N, 3) float32
    bb_max: np.ndarray       # (N, 3) float32
    hit_link: np.ndarray     # (N,) int32: first child; leaves: miss_link
    miss_link: np.ndarray    # (N,) int32: next node when missed (-1 = done)
    leaf_offset: np.ndarray  # (N,) int32 into the reordered faces (-1 inner)
    leaf_count: np.ndarray   # (N,) int32
    # reordered faces, padded so a leaf can gather LEAF_SIZE rows
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    perm: np.ndarray         # (T + LEAF_SIZE,) original face index (-1 pad)

    @property
    def n_nodes(self) -> int:
        return int(self.bb_min.shape[0])


def build(v0, e1, e2, leaf_size: int = LEAF_SIZE,
          align: bool = False) -> BVH:
    """Median-split BVH build on the host, O(T log T).

    `align=True` keeps every split a multiple of `leaf_size`, so every leaf
    but the last holds exactly `leaf_size` faces (fewer leaves and nodes
    for the kernels' 8-wide leaf rows)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    centroid = 0.5 * (lo + hi)

    nodes = []   # dicts: bbmin, bbmax, left, right, start, count
    order: list[int] = []

    def rec(idx: np.ndarray) -> int:
        ni = len(nodes)
        nodes.append(None)
        bmin = lo[idx].min(axis=0)
        bmax = hi[idx].max(axis=0)
        if len(idx) <= leaf_size:
            start = len(order)
            order.extend(idx.tolist())
            nodes[ni] = dict(bbmin=bmin, bbmax=bmax, left=-1, right=-1,
                             start=start, count=len(idx))
            return ni
        axis = int(np.argmax(bmax - bmin))
        if align:
            # sort by centroid and split at a leaf_size-aligned median
            ordc = np.argsort(centroid[idx, axis], kind='stable')
            half = len(idx) // 2
            half = max(leaf_size, (half // leaf_size) * leaf_size)
            left, right = idx[ordc[:half]], idx[ordc[half:]]
        else:
            med = np.median(centroid[idx, axis])
            mask = centroid[idx, axis] < med
            if mask.all() or not mask.any():
                mask = np.zeros(len(idx), bool)
                mask[: len(idx) // 2] = True
            left, right = idx[mask], idx[~mask]
        l_i = rec(left)
        r_i = rec(right)
        nodes[ni] = dict(bbmin=bmin, bbmax=bmax, left=l_i, right=r_i,
                         start=-1, count=0)
        return ni

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.arange(len(v0)))
    finally:
        sys.setrecursionlimit(old)

    n = len(nodes)
    hit_link = np.full(n, -1, np.int32)
    miss_link = np.full(n, -1, np.int32)
    leaf_off = np.full(n, -1, np.int32)
    leaf_cnt = np.zeros(n, np.int32)

    # thread the tree: node creation order is DFS order (parent before
    # children, left before right)
    def thread(ni: int, escape: int):
        nd = nodes[ni]
        miss_link[ni] = escape
        if nd['left'] < 0:
            leaf_off[ni] = nd['start']
            leaf_cnt[ni] = nd['count']
            hit_link[ni] = escape      # leaf: after its faces, continue
        else:
            hit_link[ni] = nd['left']
            thread(nd['left'], nd['right'])
            thread(nd['right'], escape)

    thread(0, -1)
    perm = np.asarray(order + [-1] * leaf_size, np.int32)
    pad = np.zeros((leaf_size, 3), np.float32)
    return BVH(bb_min=np.stack([nd['bbmin'] for nd in nodes]),
               bb_max=np.stack([nd['bbmax'] for nd in nodes]),
               hit_link=hit_link, miss_link=miss_link, leaf_offset=leaf_off,
               leaf_count=leaf_cnt,
               v0=np.concatenate([v0[order], pad]),
               e1=np.concatenate([e1[order], pad]),
               e2=np.concatenate([e2[order], pad]),
               perm=perm)


def _tables(bvh: BVH, device):
    return {f.name: torch.as_tensor(getattr(bvh, f.name), device=device)
            for f in dataclasses.fields(bvh)}


def safe_inv(v):
    """1 / v with |v| kept above 1e-12 (the sign of v, +0 counting as +)."""
    tiny = torch.where(v >= 0.0, 1e-12, -1e-12)
    return 1.0 / torch.where(v.abs() > 1e-12, v, tiny)


def _leaf_batch(b, node, o, d, leaf_size):
    """Möller-Trumbore of every ray against its node's (up to) leaf_size
    faces: (offs, cnt_ok, det, u, v, t), each (n, leaf_size)."""
    k = torch.arange(leaf_size, device=o.device)
    offs = b['leaf_offset'][node].clamp(min=0).long()[:, None] + k[None, :]
    cnt_ok = k[None, :] < b['leaf_count'][node][:, None]
    v0, e1, e2 = b['v0'][offs], b['e1'][offs], b['e2'][offs]
    dd = d[:, None, :].expand_as(e2)
    pvec = torch.linalg.cross(dd, e2)
    det = (e1 * pvec).sum(-1)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0
    uu = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    vv = (dd * qvec).sum(-1) * inv_det
    tt = (e2 * qvec).sum(-1) * inv_det
    return offs, cnt_ok, det, uu, vv, tt


def _slab(b, node, o, inv_d):
    bmin = b['bb_min'][node]
    bmax = b['bb_max'][node]
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return tn, tf


def traverse_closest(bvh: BVH, o, d, tmin: float = 1e-4,
                     max_iters: int = 4096, leaf_size: int = LEAF_SIZE):
    """Lock-step wavefront closest hit of (R, 3) rays: (t (inf on a miss),
    face index in the original numbering (-1), u, v)."""
    b = _tables(bvh, o.device)
    n = o.shape[0]
    inv_d = safe_inv(d)
    node = torch.zeros(n, dtype=torch.long, device=o.device)
    t_best = torch.full((n,), float('inf'), device=o.device)
    idx_best = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros(n, device=o.device)
    v_best = torch.zeros(n, device=o.device)
    rows = torch.arange(n, device=o.device)
    for _ in range(max_iters):
        active = node >= 0
        if not bool(active.any()):
            break
        ni = node.clamp(min=0)
        tn, tf = _slab(b, ni, o, inv_d)
        bbox_hit = (tf >= tn.clamp(min=0.0)) & (tn < t_best) & active
        test_leaf = bbox_hit & (b['leaf_offset'][ni] >= 0)
        offs, cnt_ok, det, uu, vv, tt = _leaf_batch(b, ni, o, d, leaf_size)
        hit = (cnt_ok & test_leaf[:, None] & (det.abs() > 1e-12)
               & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > tmin)
               & (tt < t_best[:, None]))
        tt = torch.where(hit, tt, float('inf'))
        tj, aj = tt.min(dim=1)
        better = tj < t_best
        t_best = torch.where(better, tj, t_best)
        flat = offs[rows, aj]
        idx_best = torch.where(better, b['perm'][flat], idx_best)
        u_best = torch.where(better, uu[rows, aj], u_best)
        v_best = torch.where(better, vv[rows, aj], v_best)
        node = torch.where(active, torch.where(
            bbox_hit, b['hit_link'][ni].long(), b['miss_link'][ni].long()),
            node)
    return t_best, idx_best, u_best, v_best


def traverse_any(bvh: BVH, o, d, maxt, tmin: float = 1e-4,
                 max_iters: int = 4096, leaf_size: int = LEAF_SIZE):
    """Lock-step shadow walk: True where a face blocks before
    maxt (1 - 1e-3); a ray stops at its first blocker."""
    b = _tables(bvh, o.device)
    n = o.shape[0]
    inv_d = safe_inv(d)
    limit = maxt * (1.0 - 1e-3)
    node = torch.zeros(n, dtype=torch.long, device=o.device)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    for _ in range(max_iters):
        active = node >= 0
        if not bool(active.any()):
            break
        ni = node.clamp(min=0)
        tn, tf = _slab(b, ni, o, inv_d)
        bbox_hit = (tf >= tn.clamp(min=0.0)) & (tn < limit) & active
        test_leaf = bbox_hit & (b['leaf_offset'][ni] >= 0)
        _, cnt_ok, det, uu, vv, tt = _leaf_batch(b, ni, o, d, leaf_size)
        hit = (cnt_ok & test_leaf[:, None] & (det.abs() > 1e-12)
               & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > tmin)
               & (tt < limit[:, None]))
        occ = occ | hit.any(dim=1)
        node = torch.where(active & ~occ, torch.where(
            bbox_hit, b['hit_link'][ni].long(), b['miss_link'][ni].long()),
            -1)
    return occ
