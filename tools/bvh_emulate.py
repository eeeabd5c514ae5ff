#!/usr/bin/env python3
"""K2 and K3, the BVH walks of `csrc/bvh_kernels.cu`, on the CPU in a g++
emulation of the CUDA runtime, held bit for bit against the plain
versions (`bvh_closest_ref`, `bvh_any_ref`) and, with --other, against
another checkout's kernels: the check of a redesign before its first chip
call.

Run from the repository root (g++ with C++20; no card, no nvcc):

    python3 tools/bvh_emulate.py [--other DIR] [--this DIR2]

Each tree's source is compiled by g++ against the stub
`tools/emu/cuda_runtime.h` (each block as blockDim.x std::threads, a
barrier a warp for the votes and shuffles) with -ffp-contract=off; its
`<<<...>>>` launches and shared arrays are rewritten for it.  Its C entry
points are called through ctypes on CPU tensors: a tree whose launch takes
the packed tables (bbox, links, leaves, stride: the grid-stride walk of
`bvh_walk.cuh`) gets them, a later one the node pairs and triangles of
`bvh_kernel.walk_tables`.  For each case of `cases()` it prints the rays
whose t, face index, u, v or shadow flag differ from the plain version's
in any bit (a ray that a redesign's walk order moves at a box-rounding
edge would show here, counted).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(HERE, 'tools', 'emu')


def emulate(tree: str, out: str) -> str:
    """A shared library of the tree's K2 / K3 source built by g++ with the
    stub runtime."""
    csrc = os.path.join(tree, 'beifong_tpu_torch', 'csrc')
    with open(os.path.join(csrc, 'bvh_kernels.cu')) as f:
        cu = f.read()
    cu = re.sub(r'extern __shared__ (\w+) (\w+)\[\];',
                r'\1* \2 = reinterpret_cast<\1*>(emu::cur_smem());', cu)
    cu = re.sub(r'\b__shared__\b', 'static', cu)
    cu = re.sub(r'(bvh_\w+_kernel(?:<[^<>]*>)?)\s*<<<(.*?)>>>\(',
                r'emu::launch(\1, \2, ', cu, flags=re.S)
    if '<<<' in cu:
        raise SystemExit(f'{tree}: a launch the emulation does not rewrite')
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out + '.cpp', 'w') as f:
        f.write(cu)
    subprocess.run(['g++', '-std=c++20', '-O2', '-pthread', '-shared',
                    '-fPIC', '-ffp-contract=off', '-w', '-I', STUB, '-I',
                    csrc, '-o', out, out + '.cpp'], check=True)
    return out


class Emulated:
    """The emulated library of one tree and the interface its launches
    take: 'tables' (the packed tables) or 'walk' (walk_tables)."""

    def __init__(self, path: str, tree: str):
        with open(os.path.join(tree, 'beifong_tpu_torch', 'csrc',
                               'bvh_kernels.cu')) as f:
            src = f.read()
        self.kind = 'tables' if 'const int* links' in src else 'walk'
        self.lib = lib = ctypes.CDLL(path)
        if self.kind == 'walk':
            sys.path.insert(0, HERE)
            from beifong_tpu_torch.geometry import bvh_kernel as bk
            bk._bind(lib)
            return
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bvh_closest_launch.argtypes = [vp, vp, vp, i32, vp, vp, i64, vp,
                                           vp, vp, vp, vp]
        lib.bvh_any_launch.argtypes = [vp, vp, vp, i32, vp, vp, vp, i64, vp,
                                       vp]
        lib.bvh_closest_launch.restype = i32
        lib.bvh_any_launch.restype = i32

    def run(self, pb, o, d, maxt):
        """(t, face index, u, v, shadow flags) of the emulated kernels on
        CPU tensors."""
        import torch
        sys.path.insert(0, HERE)
        from beifong_tpu_torch.geometry import bvh_kernel as bk
        n = int(o.shape[0])
        t = torch.empty(n, dtype=torch.float32)
        idx = torch.empty(n, dtype=torch.int32)
        u = torch.empty(n, dtype=torch.float32)
        v = torch.empty(n, dtype=torch.float32)
        occ = torch.empty(n, dtype=torch.uint8)
        counter = torch.zeros(2, dtype=torch.int64)
        out = [x.data_ptr() for x in (t, idx, u, v)]
        if self.kind == 'tables':
            tab = (pb.bbox.data_ptr(), pb.links.data_ptr(),
                   pb.leaves.data_ptr(), pb.stride)
            err = self.lib.bvh_closest_launch(*tab, o.data_ptr(),
                                              d.data_ptr(), n, *out, None)
            err = err or self.lib.bvh_any_launch(
                *tab, o.data_ptr(), d.data_ptr(), maxt.data_ptr(), n,
                occ.data_ptr(), None)
        else:
            wt = bk.walk_tables(pb)
            tab = (wt.rec.data_ptr(), wt.tri.data_ptr())
            err = self.lib.bvh_closest_launch(
                *tab, o.data_ptr(), d.data_ptr(), n, *out,
                counter.data_ptr(), None)
            err = err or self.lib.bvh_any_launch(
                *tab, o.data_ptr(), d.data_ptr(), maxt.data_ptr(), n,
                occ.data_ptr(), counter.data_ptr(), None)
        if err:
            raise RuntimeError(f'emulated launch failed: {err}')
        return t, idx, u, v, occ.bool()


def plain(pb, o, d, maxt):
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    return (*bk.bvh_closest_ref(pb, o, d), bk.bvh_any_ref(pb, o, d, maxt))


def differing(a, b) -> dict:
    """{output: rays whose bits differ} of the outputs that differ."""
    import torch
    out = {}
    for name, x, y in zip(('t', 'idx', 'u', 'v', 'any'), a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            out[name] = int((x != y).sum())
    return out


# ---------------------------------------------------------------------------
# the cases: a BVH and rays built to break a walk order, the tie rule, the
# pad slots or the lane refill
# ---------------------------------------------------------------------------


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pack(v0, e1, e2, align=True, payloads=0):
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.geometry import bvh as bvh_mod
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    v0, e1, e2 = (np.ascontiguousarray(x, np.float32) for x in (v0, e1, e2))
    g = np.random.default_rng(len(v0))
    p = [g.uniform(0, 1, len(v0)) for _ in range(payloads)]
    return bk.pack(bvh_mod.build(v0, e1, e2, align=align), *p)


def _rays(o, d, maxt):
    import torch
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                 for x in (o, d, maxt))


def _plane_grid(n, origin, ax, ay, h=1.0):
    """n x n squares (2 n^2 triangles sharing edges) spanned by ax, ay at
    `origin`, the vertices rounded to float32."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    p = origin + h * (i.reshape(-1, 1) * ax + j.reshape(-1, 1) * ay)
    p00, p10, p01, p11 = (np.float32(p + h * s) for s in
                          (0 * ax, ax, ay, ax + ay))
    v0 = np.concatenate([p00, p11])
    e1 = np.concatenate([p10 - p00, p01 - p11])
    e2 = np.concatenate([p01 - p00, p10 - p11])
    return v0, e1, e2


def mesh_tris(n_side: int = 23):
    """(v0, e1, e2) of mesh_scene(n_side) in world space, and its scene."""
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.scenes import mesh_scene
    s, rx = mesh_scene(n_side=n_side)
    sd = s.compile(use_bvh=False, device='cpu')
    return [x.numpy() for x in (sd.tris.v0, sd.tris.e1, sd.tris.e2)], s, rx


def query_rays(s, rx, v0, n: int, seed: int):
    """chip_smoke.py's query rays on the CPU: half from uniform points of
    the receiver aperture, half from a 3 m cube about the mesh, toward
    uniform points of the mesh's box; shadow lengths 0.8-1.2 of the
    distance."""
    import torch
    lo, hi = v0.min(0) - 0.02, v0.max(0) + 0.02
    g = np.random.default_rng(seed)
    half = n // 2
    m = s.shapes[s.shape_index_of_endpoint('receiver', rx.id)].to_world
    uv = g.uniform(-1, 1, (half, 2))
    o1 = uv[:, :1] * m[:3, 0] + uv[:, 1:] * m[:3, 1] + m[:3, 3]
    o2 = (lo + hi) / 2 + 3.0 * (g.uniform(0, 1, (n - half, 3)) - 0.5)
    o = np.concatenate([o1, o2])
    d = lo + (hi - lo) * g.uniform(0, 1, (n, 3)) - o
    dist = np.linalg.norm(d, axis=1)
    return o, d / dist[:, None], dist * g.uniform(0.8, 1.2, n)


def edge_maxt(t, maxt):
    """maxt of each ray that hits (closest t) by its index mod 4: 0, t,
    the largest float whose limit maxt (1 - 1e-3) is not above t (free),
    and the next float (blocked)."""
    import torch
    eps = np.float32(1.0 - 1e-3)
    up = np.float32(np.inf)
    m = np.asarray(maxt, np.float32).copy()
    for i in np.flatnonzero(np.isfinite(t)):
        x = np.float32(t[i] / eps)
        while np.float32(x * eps) > t[i]:
            x = np.nextafter(x, np.float32(0))
        while np.float32(np.nextafter(x, up) * eps) <= t[i]:
            x = np.nextafter(x, up)
        m[i] = (np.float32(0), t[i], x, np.nextafter(x, up))[i % 4]
    return torch.from_numpy(m)


CASES = ('mesh_queries', 'mesh_wavefront_tree', 'zero_directions',
         'inside_root', 'flat_grid_ties', 'one_leaf', 'maxt_edges',
         'all_miss', 'stride88', 'stride96')


def cases(seed: int = 0) -> dict:
    """name: (PackedBVH, o, d, maxt) on the CPU."""
    import torch
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    g = np.random.default_rng(seed)
    (v0, e1, e2), s, rx = mesh_tris()
    out = {}
    # the query rays on mesh_scene(n_side=23), 968 faces; a ray count
    # that is not a multiple of 32 or of the refill chunk
    pb = _pack(v0, e1, e2)
    out['mesh_queries'] = (pb, *_rays(*query_rays(s, rx, v0, 3001, seed)))
    # the wavefront's tree (no aligned splits: leaves of 1-8 faces, pad
    # slots skipped)
    out['mesh_wavefront_tree'] = (_pack(v0, e1, e2, align=False),
                                  *_rays(*query_rays(s, rx, v0, 2050,
                                                     seed + 1)))
    # zero direction components (safe_inv's 1e12), along the axes
    o, d, m = query_rays(s, rx, v0, 1024, seed + 2)
    d = np.where(g.uniform(0, 1, d.shape) < 0.35, 0.0, d)
    d[np.all(d == 0, axis=1), 1] = 1.0
    d[:64] = np.eye(3)[g.integers(0, 3, 64)] * g.choice([-1, 1], (64, 1))
    out['zero_directions'] = (pb, *_rays(o, d, m))
    # origins inside the root box and inside leaf boxes
    lo, hi = v0.min(0), v0.max(0)
    o = lo + (hi - lo) * g.uniform(0, 1, (1000, 3))
    o[:300] = v0[g.integers(0, len(v0), 300)] + 0.3 * e1[:300] \
        + 0.3 * e2[:300]
    d = _unit(g.normal(size=(1000, 3)))
    out['inside_root'] = (pb, *_rays(o, d, g.uniform(0.01, 3.0, 1000)))
    # an axis-aligned flat grid and a tilted one, each face twice (in
    # other leaves), rays at shared vertices and edges: exact ties of t
    ax, ay = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
    fv0, fe1, fe2 = _plane_grid(8, np.array([-2.0, -2.0, 0.5]), ax, ay, 0.5)
    tx = _unit(np.array([1.0, 0.3, 0.2]))
    ty = _unit(np.cross(np.array([0.1, 0.2, 1.0]), tx))
    tv0, te1, te2 = _plane_grid(8, np.array([-2.0, -2.0, -1.0]), tx, ty,
                                0.5)
    gv0 = np.concatenate([fv0, tv0, fv0[::-1], tv0[::-1]])
    ge1 = np.concatenate([fe1, te1, fe1[::-1], te1[::-1]])
    ge2 = np.concatenate([fe2, te2, fe2[::-1], te2[::-1]])
    verts = np.concatenate([gv0, gv0 + ge1, gv0 + ge2, gv0 + 0.5 * ge1,
                            gv0 + 0.5 * ge2, gv0 + 0.5 * (ge1 + ge2)])
    tgt = verts[g.integers(0, len(verts), 1500)]
    o = g.uniform(-3, 3, (1500, 3)) + np.array([0.0, 0.0, 4.0])
    d = _unit(tgt - o)
    out['flat_grid_ties'] = (_pack(gv0, ge1, ge2, align=False),
                             *_rays(o, d, g.uniform(0.5, 9.0, 1500)))
    # a tree of one leaf (five faces, three pad slots)
    sv0, se1, se2 = (x[:5] for x in (v0, e1, e2))
    c = sv0.mean(0)
    o = c + _unit(g.normal(size=(500, 3))) * 0.5
    d = _unit(c + g.normal(0, 0.05, (500, 3)) - o)
    out['one_leaf'] = (_pack(sv0, se1, se2), *_rays(o, d,
                                                    np.full(500, 2.0)))
    # maxt 0, the closest hit's own t, and the largest maxt whose limit
    # maxt (1 - 1e-3) is not above it and the next float (blocked)
    o, d, m = query_rays(s, rx, v0, 1200, seed + 3)
    rays = _rays(o, d, m)
    out['maxt_edges'] = (pb, rays[0], rays[1], edge_maxt(
        bk.bvh_closest_ref(pb, rays[0], rays[1])[0].numpy(), m))
    # rays that miss: from outside the mesh's box, away from it
    o = _unit(g.normal(size=(700, 3))) * 8.0
    d = _unit(o + g.normal(0, 0.5, (700, 3)))
    out['all_miss'] = (pb, *_rays(o, d, np.full(700, 5.0)))
    # the tables with one and two payload columns (stride 88, 96)
    for k_, name in ((1, 'stride88'), (2, 'stride96')):
        out[name] = (_pack(v0, e1, e2, payloads=k_),
                     *_rays(*query_rays(s, rx, v0, 999, seed + 4 + k_)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', help='another checkout to compare with')
    ap.add_argument('--this', default=HERE)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    build = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'bvh_emulate')
    trees = {'this': os.path.abspath(args.this)}
    if args.other:
        trees['other'] = os.path.abspath(args.other)
    libs = {w: Emulated(emulate(t, os.path.join(build, f'{w}.so')), t)
            for w, t in trees.items()}
    bad = 0
    for name, (pb, o, d, maxt) in cases().items():
        ref = plain(pb, o, d, maxt)
        got = {w: lib.run(pb, o, d, maxt) for w, lib in libs.items()}
        diff = {w: differing(x, ref) for w, x in got.items()}
        bad += sum(len(x) for x in diff.values())
        print(f'{name}: {len(o)} rays, {pb.n_nodes} nodes, stride '
              f'{pb.stride}, {int((ref[1] >= 0).sum())} hit, '
              f'{int(ref[4].sum())} blocked; rays that differ from the plain '
              'version: ' + '; '.join(f'{w} {x or "none"}'
                                      for w, x in diff.items()), flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
