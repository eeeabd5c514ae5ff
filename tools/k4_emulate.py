#!/usr/bin/env python3
"""K4, the ray / triangle kernels of `csrc/intersect_kernels.cu`, on the
CPU in a g++ emulation of the CUDA runtime, held bit for bit against the
plain version (and, with --other, against another checkout's kernels):
the check of a redesign before its first chip call.

Run from the repository root (g++ with C++20; no card, no nvcc):

    python3 tools/k4_emulate.py [--other DIR] [--this DIR2]

Each tree's source is compiled by g++ against the stub
`tools/emu/cuda_runtime.h` (each block as blockDim.x std::threads, a
barrier a block for __syncthreads and one a warp for the votes), with
-ffp-contract=off; the `<<<...>>>` launches and the shared arrays are
rewritten for it.  The C entry points are called through ctypes on CPU
tensors.  For each soup of `cases()` (built to break a cull or the tie
rule) it prints whether t, the face index, u, v and the shadow flags
equal the plain version's bit for bit.
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
    """A shared library of the tree's K4 source built by g++ with the stub
    runtime."""
    csrc = os.path.join(tree, 'beifong_tpu_torch', 'csrc')
    with open(os.path.join(csrc, 'intersect_kernels.cu')) as f:
        cu = f.read()
    cu = re.sub(r'extern __shared__ (\w+) (\w+)\[\];',
                r'\1* \2 = reinterpret_cast<\1*>(emu::cur_smem());', cu)
    # a static shared array: one a kernel, since the blocks run in turn
    cu = re.sub(r'\b__shared__\b', 'static', cu)
    cu = re.sub(r'(ray_triangle_kernel<\w+>)\s*<<<(.*?)>>>\(',
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


def load(path: str):
    """The emulated library with the wrappers' ctypes signatures."""
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    lib = ctypes.CDLL(path)
    try:
        ik._bind(lib)
    except AttributeError:   # a tree without ik_shared_bytes
        pass
    return lib


def run(lib, o, d, v0, e1, e2, maxt):
    """(t, face index, u, v, shadow flags) of the emulated kernels on CPU
    tensors."""
    import torch
    n, n_tris = int(o.shape[0]), int(v0.shape[0])
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    u = torch.empty(n, dtype=torch.float32)
    v = torch.empty(n, dtype=torch.float32)
    occ = torch.empty(n, dtype=torch.uint8)
    ptr = [x.data_ptr() for x in (o, d, v0, e1, e2)]
    err = lib.ik_closest_launch(*ptr, n, n_tris, t.data_ptr(),
                                idx.data_ptr(), u.data_ptr(), v.data_ptr(),
                                None)
    err = err or lib.ik_any_launch(*ptr, maxt.data_ptr(), n, n_tris,
                                   occ.data_ptr(), None)
    if err:
        raise RuntimeError(f'emulated launch failed: {err}')
    return t, idx, u, v, occ.bool()


def plain(o, d, v0, e1, e2, maxt):
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    return (*ik.ray_triangle_closest_ref(o, d, v0, e1, e2),
            ik.ray_triangle_any_ref(o, d, v0, e1, e2, maxt))


def differing(a, b) -> list:
    """Names of the outputs that differ in any bit."""
    import torch
    names = ('t', 'idx', 'u', 'v', 'any')
    out = []
    for name, x, y in zip(names, a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            out.append(f'{name} ({int((x != y).sum())} rays)')
    return out


# ---------------------------------------------------------------------------
# soups built to break a cull or the tie rule
# ---------------------------------------------------------------------------


def _f32(*xs):
    return [np.ascontiguousarray(x, dtype=np.float32) for x in xs]


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _random_soup(g, n, spread=2.0, size=0.3):
    c = g.uniform(-spread, spread, (n, 3))
    return c, g.normal(0, size, (n, 3)), g.normal(0, size, (n, 3))


def _toward(g, o, v0, e1, e2, faces):
    """Rays from o to uniform points of the given faces."""
    a, b = g.uniform(0, 1, (2, len(faces)))
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    tgt = v0[faces] + a[:, None] * e1[faces] + b[:, None] * e2[faces]
    return _unit(tgt - o)


def _plane_grid(n, origin, ax, ay, h=1.0):
    """A grid of n x n squares (2 n^2 triangles sharing edges) spanned by
    ax, ay at `origin`, with the vertices rounded to float32."""
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    p = (origin + h * (i.reshape(-1, 1) * ax + j.reshape(-1, 1) * ay))
    p00, p10, p01, p11 = (np.float32(p + h * s) for s in
                          (0 * ax, ax, ay, ax + ay))
    v0 = np.concatenate([p00, p11])
    e1 = np.concatenate([p10 - p00, p01 - p11])
    e2 = np.concatenate([p01 - p00, p10 - p11])
    return v0, e1, e2


def with_edge_maxt(case):
    """maxt of every ray that hits set to the floats whose shadow limit
    maxt (1 - 1e-3) lies at or just below its closest t (even rays: not
    blocked) and just above it (odd rays: blocked)."""
    import torch
    o, d, v0, e1, e2, maxt = case
    t = plain(*(torch.from_numpy(x) for x in case))[0].numpy()
    eps = np.float32(1.0 - 1e-3)
    up, down = np.float32(np.inf), np.float32(0)
    m = maxt.copy()
    for i in np.flatnonzero(np.isfinite(t)):
        x = np.float32(t[i] / eps)
        while np.float32(x * eps) > t[i]:
            x = np.nextafter(x, down)
        while np.float32(np.nextafter(x, up) * eps) <= t[i]:
            x = np.nextafter(x, up)
        # x is the largest maxt whose limit is not above t
        m[i] = x if i % 2 == 0 else np.nextafter(x, up)
    return o, d, v0, e1, e2, m


CASES = ('duplicates', 'vertices_edges', 'grazing', 'tiny_far', 'on_face',
         'maxt_edges', 'all_miss')


def cases(seed: int = 0) -> dict:
    """name: (o, d, v0, e1, e2, maxt) as contiguous float32 arrays."""
    g = np.random.default_rng(seed)
    out = {}

    def maxt_of(o, v0):
        # shadow lengths that leave some hits blocked and some free
        return g.uniform(0.5, 8.0, len(o))

    # duplicate faces inside a tile and across the 512-face tile boundary
    v0, e1, e2 = _random_soup(g, 1100)
    for dst, src in ((11, 10), (520, 10), (1099, 10), (513, 511)):
        v0[dst], e1[dst], e2[dst] = v0[src], e1[src], e2[src]
    v0[600:700], e1[600:700], e2[600:700] = v0[0:100], e1[0:100], e2[0:100]
    # the same triangle with its vertices in another order
    v0[700], e1[700], e2[700] = v0[20] + e1[20], e2[20] - e1[20], -e1[20]
    o = g.uniform(-3, 3, (600, 3))
    faces = g.choice([10, 511, 20, 5, 50, 99, 640], 600)
    d = _toward(g, o, v0, e1, e2, faces)
    out['duplicates'] = _f32(o, d, v0, e1, e2, maxt_of(o, v0))

    # rays through a tilted grid's vertices and along and across its edges
    ax = _unit(np.array([1.0, 0.3, 0.2]))
    ay = _unit(np.cross(np.array([0.1, 0.2, 1.0]), ax))
    v0, e1, e2 = _plane_grid(12, np.array([-3.0, -2.0, 0.5]), ax, ay, 0.5)
    verts = np.concatenate([v0, v0 + e1, v0 + e2,
                            v0 + 0.5 * e1, v0 + 0.5 * e2,
                            v0 + 0.5 * (e1 + e2)])
    tgt = verts[g.integers(0, len(verts), 500)]
    o = g.uniform(-4, 4, (500, 3)) + np.array([0.0, 0.0, 3.0])
    d = _unit(tgt - o)
    out['vertices_edges'] = _f32(o, d, v0, e1, e2, maxt_of(o, v0))

    # grazing rays: origins and directions in a tilted grid's plane, and
    # tilted out of it by 1e-7 .. 1e-2 rad (the rounded test gets noise
    # for det, u, v and t; a cull without its grazing bound drops hits)
    nrm = np.cross(ax, ay)
    p = (np.array([-3.0, -2.0, 0.5]) + g.uniform(0, 6, (600, 1)) * ax
         + g.uniform(0, 6, (600, 1)) * ay)
    q = (np.array([-3.0, -2.0, 0.5]) + g.uniform(0, 6, (600, 1)) * ax
         + g.uniform(0, 6, (600, 1)) * ay)
    tilt = np.where(g.uniform(0, 1, 600) < 0.5, 0.0,
                    10.0 ** g.uniform(-7, -2, 600))
    d = _unit(_unit(q - p) + (tilt * g.choice([-1, 1], 600))[:, None] * nrm)
    o = p + (g.choice([0.0, 1e-6, -1e-6, 1e-3], 600))[:, None] * nrm
    out['grazing'] = _f32(o, d, v0, e1, e2, maxt_of(o, v0))

    # tiny faces far from the origin, and far from the coordinates' origin
    base = np.array([900.0, -700.0, 500.0])
    v0 = base + g.uniform(-20, 20, (400, 3))
    e1, e2 = g.normal(0, 1e-3, (400, 3)), g.normal(0, 1e-3, (400, 3))
    o = np.concatenate([g.uniform(-1, 1, (300, 3)),
                        base + g.uniform(-30, 30, (300, 3))])
    faces = g.integers(0, 400, 600)
    d = _toward(g, o, v0, e1, e2, faces)
    out['tiny_far'] = _f32(o, d, v0, e1, e2, g.uniform(500, 2000, 600))

    # origins on a face and 1e-4 .. 3e-4 off it (t near tmin = 1e-4)
    v0, e1, e2 = _random_soup(g, 300, spread=1.5, size=0.5)
    faces = g.integers(0, 300, 600)
    a, b = g.uniform(0, 0.5, (2, 600))
    fn = _unit(np.cross(e1[faces], e2[faces]))
    off = g.choice([0.0, 0.9e-4, 1e-4, 1.1e-4, 2e-4, -1e-4], 600)
    o = (v0[faces] + a[:, None] * e1[faces] + b[:, None] * e2[faces]
         + off[:, None] * fn)
    d = np.where(g.uniform(0, 1, (600, 1)) < 0.5, -fn,
                 _unit(g.normal(size=(600, 3))))
    out['on_face'] = _f32(o, d, v0, e1, e2, maxt_of(o, v0))

    # maxt just below and just above the first hit (set from the plain
    # version below); a ragged last tile of 3 and ragged rays (300)
    v0, e1, e2 = _random_soup(g, 1027)
    v0[1025], e1[1025], e2[1025] = v0[3], 0.0, 0.0   # degenerate faces
    e2[1026] = e1[1026]
    o = g.uniform(-3, 3, (300, 3))
    d = _toward(g, o, v0, e1, e2, g.integers(0, 1027, 300))
    d[7] = 0.0                                        # a zero direction
    out['maxt_edges'] = with_edge_maxt(_f32(o, d, v0, e1, e2,
                                            maxt_of(o, v0)))

    # rays that miss everything: from outside the soup's box, away from it
    v0, e1, e2 = _random_soup(g, 200)
    o = _unit(g.normal(size=(300, 3))) * 6.0
    d = _unit(o + g.normal(0, 0.5, (300, 3)))
    out['all_miss'] = _f32(o, d, v0, e1, e2, maxt_of(o, v0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', help='another checkout to compare with')
    ap.add_argument('--this', default=HERE)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    build = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'k4_emulate')
    trees = {'this': args.this}
    if args.other:
        trees['other'] = args.other
    libs = {w: load(emulate(os.path.abspath(t),
                            os.path.join(build, f'{w}.so')))
            for w, t in trees.items()}
    bad = 0
    for name, case in cases().items():
        ts = [torch.from_numpy(x) for x in case]
        ref = plain(*ts)
        got = {w: run(lib, *ts) for w, lib in libs.items()}
        diff = {w: differing(g, ref) for w, g in got.items()}
        bad += sum(map(len, diff.values()))
        hits = int((ref[1] >= 0).sum())
        print(f'{name}: {len(case[0])} rays x {len(case[2])} faces, {hits} '
              f'hit, {int(ref[4].sum())} blocked; against the plain '
              'version: ' + '; '.join(
                  f'{w} ' + ('bit-equal' if not d
                             else 'differs in ' + ', '.join(d))
                  for w, d in diff.items()), flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
