"""K4's CUDA source (`csrc/intersect_kernels.cu`) on the CPU: compiled by
g++ against the CUDA runtime stub `tools/emu/cuda_runtime.h` (each block
as std::threads, barriers for __syncthreads and the warp votes) and held
bit for bit against the plain version on soups built to break its cull or
the tie rule (`tools/k4_emulate.py`).  Skips where g++ is absent."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))

import k4_emulate  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to compile the CUDA source against the stub')
    out = str(tmp_path_factory.mktemp('k4_emulate') / 'k4.so')
    return k4_emulate.load(k4_emulate.emulate(ROOT, out))


@pytest.fixture(scope='module')
def cases():
    return k4_emulate.cases()


def _far_hits(case, idx):
    """Hits whose ray passes farther than 1.5 R from the face's centroid
    (R: the centroid's largest distance to a vertex): the rounded test
    accepted them, and a cull without a rounding margin would drop them."""
    o, d, v0, e1, e2, _ = case
    hit = idx >= 0
    f = idx[hit]
    c = v0 + (e1 + e2) / 3
    r = np.sqrt(np.max([((v0 - c) ** 2).sum(1), ((v0 + e1 - c) ** 2).sum(1),
                        ((v0 + e2 - c) ** 2).sum(1)], axis=0))
    w = c[f] - o[hit]
    h = d[hit] / np.linalg.norm(d[hit], axis=1, keepdims=True)
    b = np.maximum((w * h).sum(1), 0)
    rho = np.sqrt(np.maximum((w * w).sum(1) - b * b, 0))
    return int((rho > 1.5 * r[f]).sum())


@pytest.mark.parametrize('name', k4_emulate.CASES)
def test_emulated_k4_equals_plain_version(lib, cases, name):
    case = cases[name]
    ts = [torch.from_numpy(x) for x in case]
    ref = k4_emulate.plain(*ts)
    got = k4_emulate.run(lib, *ts)
    assert k4_emulate.differing(got, ref) == []
    idx, occ = ref[1].numpy(), ref[4].numpy()
    n = len(idx)
    if name == 'all_miss':
        assert (idx == -1).all() and not occ.any()
        return
    assert 0 < (idx >= 0).sum() and 0 < occ.sum() < n
    if name == 'duplicates':
        # the lowest index wins a tie: no winner is a later copy
        later = {11, 520, 1099, 513} | set(range(600, 700))
        assert not set(idx.tolist()) & later
        assert {10, 511, 5, 50} <= set(idx.tolist())
    if name in ('grazing', 'tiny_far'):
        assert _far_hits(case, idx) > 0
    if name == 'maxt_edges':
        # limits at the first hit: even rays free, odd rays blocked
        hit = idx >= 0
        odd = np.arange(n) % 2 == 1
        assert (occ[hit & odd]).all() and not occ[hit & ~odd].any()
    if name == 'on_face':
        t = ref[0].numpy()
        assert ((t > 1e-4) & (t < 2e-4)).sum() > 0


def test_emulated_cases_cover_a_ragged_last_tile():
    """maxt_edges: 1027 faces, a last tile of 3 past two of 512 (the
    kernel's TILE), with degenerate faces and a zero direction."""
    case = k4_emulate.cases()['maxt_edges']
    assert len(case[2]) == 2 * 512 + 3
    assert (case[1] == 0).all(1).any()
    assert (case[3] == 0).all(1).any()


def test_k4_ablations_apply_to_the_source():
    """Each edit of tools/k1_ablate.py's ablations of the culling kernel
    (D3's warp queue among them) finds its text once in
    csrc/intersect_kernels.cu."""
    import k1_ablate
    with open(os.path.join(ROOT, 'beifong_tpu_torch', 'csrc',
                           'intersect_kernels.cu')) as f:
        src = f.read()
    for name, edits in k1_ablate.K4_ABLATIONS.items():
        if name in k1_ablate.K4_PARENT:
            continue
        for edit in edits:   # (old, new) or a span (first, end, new)
            assert all(src.count(x) == 1 for x in edit[:-1]), name


def test_k4_mix_reads_loops_of_a_listing():
    """tools/k4_mix.py on a made-up listing: an exact test's loop (two
    MUFU.RCP in 10 instructions) nested in a cull loop of 4 LDS.128 (two
    triangles) and 13 instructions of its own."""
    import k4_mix
    ops = (['LDS.128 R0, [R1]'] * 4 + ['FFMA R2, R3, R4, R5'] * 8
           + ['MUFU.RCP R6, R7'] * 2 + ['FMUL R8, R9, R10'] * 7)
    n = len(ops)
    ops += [f'@P0 BRA 0x{16 * 12:x}', '@P1 BRA 0x0']
    lines = ['        Function : _Z19ray_triangle_kernelILb0EEvPKf']
    lines += [f'        /*{16 * i:04x}*/    {op} ;'
              for i, op in enumerate(ops)]
    funcs = k4_mix.parse('\n'.join(lines))
    res = k4_mix.per_pair(funcs['closest'])
    assert res['exact'] == 10 / 2
    assert res['cull'] == (n + 2 - 10) / 2
