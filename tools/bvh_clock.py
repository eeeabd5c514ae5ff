#!/usr/bin/env python3
"""Where K2 / K3's cycles go, by the SM's clock: a copy of a checkout's BVH
kernels whose walk reads clock64() at its stages' boundaries, each
thread's cycles summed into global counters, at chip_smoke.py's query
shape (2^20 rays on mesh_scene, and the wavefront pass's 2^17).

Run from the repository root on the card's machine:

    python3 tools/bvh_clock.py [DIR]

It copies DIR's (default: this checkout's) `beifong_tpu_torch` into
`beifong_tpu_torch/_build/bvh_clock/` (ignored by git) and instruments
the walk it finds there:
  * the threaded walk of `bvh_walk.cuh` (one thread a ray in a grid-stride
    loop): `slab` from the top of a step (after the loop's branch on the
    node, which waits for the link load) to the branch on the slab test
    (the box's six loads and the test), `leaf` the leaf id's load and the
    leaf's triangle tests, `link` from there to the next step's top (the
    hit or miss link's load);
  * the node-pair walk of `csrc/bvh_kernels.cu` (persistent warps that
    refill their lanes): `refill` the top of a round (results written,
    the lanes' new rays and their root tests), `steps` the node pairs
    walked until every lane stands at a leaf or is done, `leaf` the
    leaves' triangle tests and the pops after them;
and prints one line `CLK {json}` a kernel and shape: each stage's share
of the threads' cycles, the cycles a ray and a slab test (the plain
version's counts), and the call's time.  The clock reads cost cycles of
their own: read the shares, not the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4   # counters: three stages and the steps

GLOBALS = '''
__device__ unsigned long long bvh_clk[4];
__device__ __forceinline__ void bvh_clk_add(unsigned long long a,
                                            unsigned long long b,
                                            unsigned long long c,
                                            unsigned long long s) {
    atomicAdd(&bvh_clk[0], a);
    atomicAdd(&bvh_clk[1], b);
    atomicAdd(&bvh_clk[2], c);
    atomicAdd(&bvh_clk[3], s);
}
'''

READ = '''
extern "C" int bvh_clock_read(unsigned long long* out) {{
    cudaDeviceSynchronize();
    return (int)cudaMemcpyFromSymbol(out, {sym}, sizeof({sym}));
}}
extern "C" int bvh_clock_reset() {{
    unsigned long long z[4] = {{0, 0, 0, 0}};
    return (int)cudaMemcpyToSymbol({sym}, z, sizeof(z));
}}
'''

# the threaded walk (bvh_walk.cuh): stages slab, leaf, link
THREADED = (('''    int node = 0;
    while (node >= 0) {
        const int* lk = t.links + 3 * node;
        if (slab(t.bbox + 6 * node, r, v.tbest())) {
            int leaf = __ldg(lk + 2);''', '''    int node = 0;
    unsigned long long k0 = 0, k1 = 0, k2 = 0, ks = 0;
    long long cp = clock64();
    while (node >= 0) {
        const long long c0 = clock64();
        k2 += c0 - cp;
        ++ks;
        const int* lk = t.links + 3 * node;
        if (slab(t.bbox + 6 * node, r, v.tbest())) {
            const long long c1 = clock64();
            k0 += c1 - c0;
            int leaf = __ldg(lk + 2);'''),
            ('''                        if (v.done()) return;''',
             '''                        if (v.done()) {
                            bvh_clk_add(k0, k1 + (clock64() - c1), k2, ks);
                            return;
                        }'''),
            ('''            node = __ldg(lk);
        } else {
            node = __ldg(lk + 1);
        }
    }
}''', '''            const long long c2 = clock64();
            k1 += c2 - c1;
            cp = c2;
            node = __ldg(lk);
        } else {
            const long long c1 = clock64();
            k0 += c1 - c0;
            cp = c1;
            node = __ldg(lk + 1);
        }
    }
    bvh_clk_add(k0, k1, k2 + (clock64() - cp), ks);
}'''))

# the node-pair walk (bvh_kernels.cu): stages refill, steps, leaf
PAIRS = (('''    long long i = -1;
    while (true) {''', '''    long long i = -1;
    unsigned long long k0 = 0, k1 = 0, k2 = 0, ks = 0;
    long long cp = clock64();
    while (true) {'''),
         ('''        if (!__any_sync(FULL, i >= 0)) break;
        while (L.cur > 0) L.step(w.rec, stk);
        if (L.cur < 0) L.leaf(w.tri, stk);
    }
}''',
          '''        if (!__any_sync(FULL, i >= 0)) break;
        const long long c0 = clock64();
        k0 += c0 - cp;
        while (L.cur > 0) {
            L.step(w.rec, stk);
            ++ks;
        }
        const long long c1 = clock64();
        k1 += c1 - c0;
        if (L.cur < 0) L.leaf(w.tri, stk);
        cp = clock64();
        k2 += cp - c1;
    }
    bvh_clk_add(k0, k1, k2, ks);
}'''),
         ('''template <bool ANY>
__device__ __forceinline__ void walk_rays(''', GLOBALS + '''
template <bool ANY>
__device__ __forceinline__ void walk_rays('''))

STAGES = {'threaded': ('slab', 'leaf', 'link'),
          'pairs': ('refill', 'steps', 'leaf')}


def _apply(path: str, edits) -> None:
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f'{path}: anchor not found once: {old[:60]!r}')
        src = src.replace(old, new)
    with open(path, 'w') as f:
        f.write(src)


def instrument(tree: str) -> tuple:
    """(the copy's root, 'threaded' | 'pairs')."""
    dst = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'bvh_clock')
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    csrc = os.path.join(dst, 'beifong_tpu_torch', 'csrc')
    kern = os.path.join(csrc, 'bvh_kernels.cu')
    with open(kern) as f:
        pairs = 'walk_rays' in f.read()
    if pairs:
        _apply(kern, PAIRS)
    else:
        walk = os.path.join(csrc, 'bvh_walk.cuh')
        _apply(walk, THREADED + (('namespace bvh {\n',
                                  'namespace bvh {\n' + GLOBALS),))
    with open(kern, 'a') as f:
        f.write(READ.format(sym='bvh_clk' if pairs else 'bvh::bvh_clk'))
    return dst, 'pairs' if pairs else 'threaded'


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    root, kind = instrument(tree)
    sys.path.insert(0, root)
    import torch
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    assert os.path.dirname(bk.__file__).startswith(root)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    info = bk.build_library()
    lib = ctypes.CDLL(info.path)
    buf = (ctypes.c_ulonglong * N)()
    dev = torch.device('cuda')
    pb, o, d, maxt, _ = cs.bvh_query_inputs(torch, dev)
    card = cs.card_line()
    for shape, step in (('2^20', 1), ('2^17', cs.N_RAYS // cs.WF_PASS_RAYS)):
        oo, dd, mm = (x[::step].contiguous() for x in (o, d, maxt))
        for name in ('closest', 'any'):
            st: dict = {}
            call = (lambda: bk.bvh_closest(pb, oo, dd)) if name == 'closest' \
                else (lambda: bk.bvh_any(pb, oo, dd, mm))
            (bk.bvh_closest_ref(pb, oo, dd, stats=st) if name == 'closest'
             else bk.bvh_any_ref(pb, oo, dd, mm, stats=st))
            call()
            if lib.bvh_clock_reset():
                raise SystemExit('reset failed')
            ms = cs.queued_ms(torch, call, n=1, reps=1)[0]
            if lib.bvh_clock_read(buf):
                raise SystemExit('read failed')
            c = [float(x) for x in buf]
            total = sum(c[:3])
            n = int(oo.shape[0])
            print('CLK ' + json.dumps(dict(
                kernel=name, walk=kind, shape=shape, tree=tree, card=card,
                ms=ms, shares={s: c[k] / total for k, s in
                               enumerate(STAGES[kind])},
                thread_cycles_a_ray=total / n,
                steps_a_ray=c[3] / n,
                slab_tests_a_ray=st['node_tests'] / n,
                leaves_a_ray=st['leaf_tests'] / n,
                cycles_a_slab_test=total / st['node_tests'])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
