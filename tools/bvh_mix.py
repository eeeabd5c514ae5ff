#!/usr/bin/env python3
"""K2 and K3, the BVH walks of `csrc/bvh_kernels.cu`: thread-instructions
a slab test and a triangle test read from the machine code, the issue-slot
bound they give at the plain version's walk counts, and SIMT models of the
walks from the plain version's per-ray counts.

    python3 tools/bvh_mix.py --sass DIR     (the card's machine: nvcc,
                                             cuobjdump, nvidia-smi)
    python3 tools/bvh_mix.py --listing FILE (a listing saved by --sass)
    python3 tools/bvh_mix.py --simt [--rays 16]   (the CPU is enough)
    python3 tools/bvh_mix.py --coherence DIR (the card)

--sass builds DIR's BVH library, saves `cuobjdump -sass` of it as
chiprun_out/bvh_sass_<basename of DIR>.txt and prints, for each kernel,
its loops (a backward branch and its target) with their instructions by
class, and:
  * a triangle test: the innermost loop holding the IEEE reciprocal's
    MUFU.RCP (one triangle an iteration);
  * a slab test: a node step over its slab tests.  The node step is the
    loop whose own body (less the loops inside it) holds four 128-bit
    loads, a node pair, two slab tests a step; in a walk without it (the
    threaded walk of bvh_walk.cuh) the smallest loop around the triangle
    loop, less it, one slab test a step (its leaf set-up counted in).
`issue_slot_bound_ms` turns the thread-instructions of a count of slab
and triangle tests into the least time to issue them as full warps, one
a cycle on each of an SM's four schedulers.

--simt models, on the CPU, chip_smoke.py's query rays on mesh_scene
(2^rays of them, the same mix of aperture and volume rays) walked by the
plain version (`walk_ref(..., visits=)`): each ray's slab tests and
leaves, weighted by the thread-instructions a slab test and a triangle
test (`--weights`, default the parent's measured ones), and the SIMT
efficiency (used over issued slots) of
  * grid_stride: a warp walks 32 consecutive rays, each round as long as
    its longest walk (k1_mix.walk_simt's model);
  * refill: a warp's lanes take the next ray of the warp's share when
    their walk ends (the while-while loop with dynamic fetch), the warp
    as long as its busiest lane;
  * sorted: the grid-stride warp over the rays sorted by a Morton code of
    origin and direction;
and the kernels' own walk counts (`pair_walk_counts`: K3's near-first
order and node pairs test both children of an entered node).

--coherence times DIR's K2 and K3 on the card on the query rays as given
and sorted by that Morton code: what coherent rays would buy.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import re
import statistics
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'tools'))

import k4_mix  # noqa: E402  (classify, loops, listing)

# thread-instructions of one slab test and one triangle test of the
# threaded grid-stride walk that the node-pair walk replaced (bvh_walk.cuh's
# walk in bvh_kernels.cu), read from its SASS by --sass on an NVIDIA H100
# 80GB HBM3
PARENT_WEIGHTS = {'closest': (60.0, 79.0), 'any': (60.0, 76.0)}


def parse(text: str) -> dict:
    """{'closest' | 'any': [(address, opcode, instruction)]}."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r'Function : \S*bvh_(closest|any)_kernel', ln)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        if 'Function :' in ln:
            cur = None
            continue
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', ln)
        if m and cur is not None:
            ins = re.sub(r'^@!?U?P\w+\s+', '', m.group(2))
            funcs[cur].append((int(m.group(1), 16), ins.split()[0], ins))
    return funcs


def _wide(txt: str) -> bool:
    return bool(re.match(r'(LDG|LDS|LD)\S*\.128', txt))


def per_test(ins: list) -> dict:
    """Thread-instructions of one slab test and one triangle test, and
    the loops read."""
    found = k4_mix.loops(ins)

    def own(c):
        lo_c, hi_c = found[c]
        inner = {i for j, (lo, hi) in enumerate(found) if j != c
                 and lo_c <= lo and hi <= hi_c and (lo, hi) != (lo_c, hi_c)
                 for i in range(lo, hi + 1)}
        return [i for i in range(lo_c, hi_c + 1) if i not in inner]

    desc = []
    for c, (lo, hi) in enumerate(found):
        body = [ins[i] for i in own(c)]
        desc.append(dict(first=hex(ins[lo][0]), last=hex(ins[hi][0]),
                         n=hi - lo + 1, own=len(body),
                         rcp=sum('MUFU.RCP' in t for _, _, t in body),
                         wide_loads=sum(_wide(t) for _, _, t in body),
                         classes=k4_mix.classify([op for _, op, _ in body])))
    out = dict(loops=desc, triangle=None, slab=None, slabs_a_step=None)
    tri = [c for c, d in enumerate(desc) if d['rcp']]
    if not tri:
        return out
    t = min(tri, key=lambda c: desc[c]['n'])
    out['triangle'] = desc[t]['n'] / desc[t]['rcp']
    pairs = [c for c, d in enumerate(desc) if d['wide_loads'] >= 4
             and not d['rcp'] and c != t]
    if pairs:
        s = min(pairs, key=lambda c: desc[c]['own'])
        out['slab'] = desc[s]['own'] / 2
        out['slabs_a_step'] = 2
        return out
    lo_t, hi_t = found[t]
    around = [c for c, (lo, hi) in enumerate(found)
              if lo <= lo_t and hi_t <= hi and c != t]
    if around:
        s = min(around, key=lambda c: desc[c]['n'])
        out['slab'] = desc[s]['n'] - desc[t]['n']
        out['slabs_a_step'] = 1
    return out


def issue_slot_bound_ms(slab_tests: float, tri_tests: float, per: dict,
                        clock_mhz: float, sms: int = 132) -> float:
    """The least time to issue the walks' thread-instructions as full
    warps at `per`'s counts a slab test and a triangle test."""
    return k4_mix.issue_slot_bound_ms(
        slab_tests * per['slab'] + tri_tests * per['triangle'], clock_mhz,
        sms)


# ---------------------------------------------------------------------------
# SIMT models from the plain version's per-ray counts
# ---------------------------------------------------------------------------


def _eff(cost: np.ndarray, groups) -> float:
    issued = sum(32.0 * float(cost[g].max()) for g in groups if len(g))
    return float(cost.sum()) / issued if issued else 1.0


def refill_eff(cost: np.ndarray, warps: int) -> float:
    """Used over issued slots of warps whose lanes each take the next ray
    of the warp's share (consecutive rays, in order) when their walk
    ends; a warp lasts as long as its busiest lane."""
    used, issued = 0.0, 0.0
    for share in np.array_split(cost, warps):
        lanes = [0.0] * 32
        heapq.heapify(lanes)
        for c in share:
            heapq.heappush(lanes, heapq.heappop(lanes) + float(c))
        used += float(share.sum())
        issued += 32.0 * max(lanes)
    return used / issued


def morton_order(o: np.ndarray, d: np.ndarray, bits: int = 5) -> np.ndarray:
    """The rays' order along a Morton code of their origin (bits a
    coordinate) and direction (bits - 2)."""
    def quant(x, b):
        lo, hi = x.min(0), x.max(0)
        q = (x - lo) / np.maximum(hi - lo, 1e-12) * ((1 << b) - 1)
        return q.round().astype(np.int64)
    code = np.zeros(len(o), np.int64)
    for b, q in ((bits, quant(o, bits)), (bits - 2, quant(d, bits - 2))):
        for k in range(b):
            for ax in range(3):
                code = (code << 1) | ((q[:, ax] >> (b - 1 - k)) & 1)
    return np.argsort(code, kind='stable')


def _tri_hits(ox, oy, oz, dx, dy, dz, rows, k):
    """walk_ref's triangle test of slot k of each ray's leaf row: (hit, t)."""
    import torch
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
     tri) = (rows[:, 8 * c + k] for c in range(10))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = det.abs() > 1e-12
    inv = torch.where(big, 1.0, 0.0) / torch.where(big, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 1e-4)
           & (tri >= 0.0))
    return hit, tt


def pair_walk_counts(pb, o, d, limit, anyhit: bool) -> dict:
    """Slab tests, leaves and steps a ray of the kernels' node-pair walk
    (csrc/bvh_kernels.cu: K2 left child first, K3 the nearer child first),
    a model on CPU tensors: walk_ref's arithmetic, the kernels' order."""
    import torch
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    wt = bk.walk_tables(pb)
    rec = wt.rec.reshape(-1, 4, 4)
    bits = rec.view(torch.int32)
    rows = pb.leaves.view(-1, pb.stride)
    n = int(o.shape[0])
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    ix, iy, iz = (bk.safe_inv(x) for x in (dx, dy, dz))
    best = limit.clone()
    stk = torch.zeros((n, bk.STACK), dtype=torch.long)
    stn = torch.zeros((n, bk.STACK))
    sp = torch.zeros(n, dtype=torch.long)
    counts = dict(slab_tests=n, leaves=0, steps=0)

    def slab(r, box):
        t = [(box[:, s, a] - oa[r]) * ia[r] for s in (0, 1)
             for a, (oa, ia) in enumerate(((ox, ix), (oy, iy), (oz, iz)))]
        tn = torch.maximum(torch.maximum(torch.minimum(t[0], t[3]),
                                         torch.minimum(t[1], t[4])),
                           torch.minimum(t[2], t[5]))
        tf = torch.minimum(torch.minimum(torch.maximum(t[0], t[3]),
                                         torch.maximum(t[1], t[4])),
                           torch.maximum(t[2], t[5]))
        return (tf >= tn.clamp(min=0.0)) & (tn < best[r]), tn

    root, _ = slab(torch.arange(n), rec[:1].expand(n, 4, 4))
    cur = torch.where(root, bits[0, 0, 3].long(), 0)
    popping = torch.zeros(n, dtype=torch.bool)
    while True:
        # a ray at 0 with deferred children pops the next one still entered
        popping = (cur == 0) & (sp > 0)
        r = torch.nonzero(popping)[:, 0]
        if r.numel():
            sp[r] -= 1
            e, et = stk[r, sp[r]], stn[r, sp[r]]
            ok = torch.ones_like(et, dtype=torch.bool) if anyhit \
                else et < best[r]
            cur[r] = torch.where(ok, e, 0)
            continue
        r = torch.nonzero(cur > 0)[:, 0]
        if r.numel():
            counts['steps'] += int(r.numel())
            counts['slab_tests'] += 2 * int(r.numel())
            q = rec[cur[r]]
            el, tl = slab(r, q[:, 0:2])
            er, tr = slab(r, q[:, 2:4])
            cl, cr = bits[cur[r], 0, 3].long(), bits[cur[r], 2, 3].long()
            swap = (tr < tl) if anyhit else torch.zeros_like(el)
            both = el & er
            near = torch.where(swap, cr, cl)
            far, tfar = torch.where(swap, cl, cr), torch.where(swap, tl, tr)
            rb = r[both]
            stk[rb, sp[rb]] = far[both]
            stn[rb, sp[rb]] = tfar[both]
            sp[rb] += 1
            cur[r] = torch.where(both, near, torch.where(
                el, cl, torch.where(er, cr, 0)))
        r = torch.nonzero(cur < 0)[:, 0]
        if r.numel():
            counts['leaves'] += int(r.numel())
            code = ~cur[r]
            lr = rows[code >> 3]
            cnt = (code & 7) + 1
            blocked = torch.zeros(r.numel(), dtype=torch.bool)
            for k in range(8):
                hit, tt = _tri_hits(ox[r], oy[r], oz[r], dx[r], dy[r],
                                    dz[r], lr, k)
                hit = hit & (tt < best[r]) & (k < cnt) & ~blocked
                if anyhit:
                    blocked |= hit
                else:
                    best[r] = torch.where(hit, tt, best[r])
            cur[r] = 0
            if anyhit:
                sp[r[blocked]] = 0
        if not bool(((cur != 0) | (sp > 0)).any()):
            break
    return {k: v / n for k, v in counts.items()}


def simt(n_log2: int = 16, weights: dict | None = None, warps=None) -> dict:
    """The models above on 2^n_log2 query rays of mesh_scene."""
    import torch
    sys.path.insert(0, HERE)
    import bvh_emulate
    from beifong_tpu_torch.geometry import bvh as bvh_mod
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    (v0, e1, e2), s, rx = bvh_emulate.mesh_tris(71)
    pb = bk.pack(bvh_mod.build(v0, e1, e2, align=True))
    n = 1 << n_log2
    o, d, maxt = bvh_emulate.query_rays(s, rx, v0, n, 7)
    ot, dt, mt = (torch.from_numpy(np.ascontiguousarray(x, np.float32))
                  for x in (o, d, maxt))
    order = morton_order(o, d)
    # the persistent grid's warps at 2^20 rays: 132 SMs x 32 warps
    warps = warps or max(1, (132 * 32 * n) >> 20)
    out = dict(rays=n, warps_for_refill=warps)
    for name, anyhit in (('closest', False), ('any', True)):
        vis = torch.zeros((n, 2), dtype=torch.long)
        lim = mt * (1.0 - 1e-3) if anyhit else torch.full((n,), 3.4e38)
        bk.walk_ref(pb, *bk._split(ot), *bk._split(dt), lim, anyhit=anyhit,
                    visits=vis)
        v = vis.numpy().astype(np.float64)
        w_slab, w_tri = (weights or PARENT_WEIGHTS)[name]
        res = dict(slab_tests_a_ray=float(v[:, 0].mean()),
                   leaves_a_ray=float(v[:, 1].mean()),
                   weights=[w_slab, w_tri])
        for m, c in (('slabs', v[:, 0]), ('leaves', v[:, 1]),
                     ('cost', v[:, 0] * w_slab + 8 * v[:, 1] * w_tri)):
            gs = [np.arange(i, i + 32) for i in range(0, n, 32)]
            res[m] = dict(
                grid_stride=_eff(c, gs),
                refill=refill_eff(c, warps),
                sorted=_eff(c[order], gs))
        # the kernels' own walk on every 2^(rays - 12)-th ray
        sel = slice(None, None, max(1, n >> 12))
        res['pair_walk_2_12'] = pair_walk_counts(
            pb, ot[sel], dt[sel], lim[sel].clone(), anyhit)
        res['walk_ref_2_12'] = dict(slab_tests=float(v[sel, 0].mean()),
                                    leaves=float(v[sel, 1].mean()))
        out[name] = res
    return out


def coherence(tree: str) -> dict:
    """Device ms (queued, chip_smoke.queued_ms) of the tree's K2 and K3 on
    chip_smoke.py's query rays at 2^20 and 2^17 in their own order and
    sorted by `morton_order` (the same rays: what ray coherence alone
    would buy)."""
    sys.path.insert(0, tree)
    import torch
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    dev = torch.device('cuda')
    pb, o, d, maxt, _ = cs.bvh_query_inputs(torch, dev)
    out = dict(card=cs.card_line(), tree=tree)
    for shape, step in (('2_20', 1), ('2_17', cs.N_RAYS // cs.WF_PASS_RAYS)):
        oo, dd, mm = (x[::step].contiguous() for x in (o, d, maxt))
        order = torch.from_numpy(morton_order(oo.cpu().numpy(),
                                              dd.cpu().numpy())).to(dev)
        for how, (a, b, c) in (('given', (oo, dd, mm)),
                               ('sorted', (x[order].contiguous()
                                           for x in (oo, dd, mm)))):
            for k, call in (('closest', lambda: bk.bvh_closest(pb, a, b)),
                            ('any', lambda: bk.bvh_any(pb, a, b, c))):
                call()
                out[f'{k}_{shape}_{how}_ms'] = statistics.median(
                    cs.queued_ms(torch, call))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sass', metavar='DIR')
    ap.add_argument('--listing', metavar='FILE')
    ap.add_argument('--simt', action='store_true')
    ap.add_argument('--coherence', metavar='DIR',
                    help="(card) DIR's kernels on the query rays as given "
                    'and Morton-sorted')
    ap.add_argument('--rays', type=int, default=16, help='log2 of the rays')
    ap.add_argument('--weights', help='JSON {"closest": [slab, triangle], '
                    '"any": [...]}: thread-instructions a test')
    args = ap.parse_args()
    if args.coherence:
        print('COHERENCE ' + json.dumps(coherence(
            os.path.abspath(args.coherence))))
        return 0
    if args.simt:
        w = json.loads(args.weights) if args.weights else None
        print('SIMT ' + json.dumps(simt(args.rays, w)))
        return 0
    if args.listing:
        with open(args.listing) as f:
            text = f.read()
    elif args.sass:
        tree = os.path.abspath(args.sass)
        sys.path.insert(0, tree)
        from beifong_tpu_torch.geometry import bvh_kernel as bk
        info = bk.build_library()
        for ln in info.log.splitlines():
            if 'entry function' in ln or 'registers' in ln or 'spill' in ln:
                print('ptxas ' + ln.strip())
        text = k4_mix.listing(info.path)
        out = os.path.join(HERE, 'chiprun_out',
                           f'bvh_sass_{os.path.basename(tree)}.txt')
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, 'w') as f:
            f.write(text)
        print(f'listing: {out}')
    else:
        ap.error('--sass DIR, --listing FILE or --simt')
    for name, ins in parse(text).items():
        res = per_test(ins)
        print(f'MIX {name}: ' + json.dumps(
            {'instructions': len(ins), 'slab': res['slab'],
             'slabs_a_step': res['slabs_a_step'],
             'triangle': res['triangle']}))
        for d in res['loops']:
            print('  loop ' + json.dumps(d))
    return 0


if __name__ == '__main__':
    sys.exit(main())
