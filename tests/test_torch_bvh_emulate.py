"""K2 and K3's CUDA source (`csrc/bvh_kernels.cu`) on the CPU: compiled by
g++ against the CUDA runtime stub `tools/emu/cuda_runtime.h` (each block
as std::threads, barriers for the warp votes and shuffles) and held bit
for bit against the plain versions on cases built to break the walk
order, the tie rule, the pad slots or the lane refill
(`tools/bvh_emulate.py`); and the kernels' node pairs and triangles
against the packed tables they are derived from.  The emulation skips
where g++ is absent."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))

import bvh_emulate  # noqa: E402
from beifong_tpu_torch.geometry import bvh as bvh_mod  # noqa: E402
from beifong_tpu_torch.geometry import bvh_kernel as bk  # noqa: E402
from beifong_tpu_torch.geometry import intersect_kernel as ik  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to compile the CUDA source against the stub')
    out = str(tmp_path_factory.mktemp('bvh_emulate') / 'bvh.so')
    return bvh_emulate.Emulated(bvh_emulate.emulate(ROOT, out), ROOT)


@pytest.fixture(scope='module')
def cases():
    return bvh_emulate.cases()


def _tied_rays(pb, o, d, idx):
    """Rays whose closest t is also another face's t, bit for bit."""
    bvh_faces = pb.leaves.view(-1, pb.stride)
    f = bvh_faces[:, 72:80].reshape(-1).long()
    keep = f >= 0
    cols = [bvh_faces[:, 8 * c:8 * c + 8].reshape(-1)[keep]
            for c in range(9)]
    v0, e1, e2 = (torch.stack(cols[3 * k:3 * k + 3], 1) for k in range(3))
    det, u, v, t = ik.moller_trumbore(o, d, v0, e1, e2)
    t = torch.where(ik.is_hit(det, u, v, t), t, float('inf'))
    best = t.min(1).values
    return int(((t == best[:, None]).sum(1) > 1)[idx >= 0].sum())


@pytest.mark.parametrize('name', bvh_emulate.CASES)
def test_emulated_walks_equal_plain_versions(lib, cases, name):
    pb, o, d, maxt = cases[name]
    ref = bvh_emulate.plain(pb, o, d, maxt)
    got = lib.run(pb, o, d, maxt)
    assert bvh_emulate.differing(got, ref) == {}
    idx, occ = ref[1].numpy(), ref[4].numpy()
    n = len(idx)
    assert n % 32 != 0 or name in ('zero_directions',)
    if name == 'all_miss':
        assert (idx == -1).all() and not occ.any()
        return
    assert 0 < (idx >= 0).sum()
    if name == 'maxt_edges':
        # by ray index mod 4: maxt 0, t, the largest free maxt, the next
        # float: only the last is blocked (by its closest face)
        hit = idx >= 0
        k = np.arange(n) % 4
        assert occ[hit & (k == 3)].all() and not occ[hit & (k < 3)].any()
        return
    assert 0 < occ.sum() < n
    if name == 'flat_grid_ties':
        assert _tied_rays(pb, o, d, ref[1]) > 100
    if name == 'mesh_wavefront_tree':
        counts = (pb.leaves.view(-1, pb.stride)[:, 72:80] >= 0).sum(1)
        assert int(counts.min()) < 8
    if name == 'one_leaf':
        assert pb.n_nodes == 1


def tables_of_walk(wt) -> tuple:
    """(bbox without its pad boxes, links) given back from the node pairs
    of `bk.walk_tables`: the nodes numbered in DFS order, left child
    first, and threaded again."""
    rec = wt.rec.cpu().reshape(-1, 4, 4)
    bits = rec.view(torch.int32)
    bbox, kids, leaf = [], [], []

    def visit(j, s):             # slot s (0 left, 2 right) of record j
        i = len(bbox)
        bbox.append(torch.cat([rec[j, s, :3], rec[j, s + 1, :3]]))
        kids.append(None)
        ref = int(bits[j, s, 3])
        leaf.append((~ref) >> 3 if ref < 0 else -1)
        if ref > 0:
            kids[i] = (visit(ref, 0), visit(ref, 2))
        return i

    visit(0, 0)
    hit, miss = [0] * len(bbox), [0] * len(bbox)

    def thread(i, escape):
        miss[i] = escape
        if kids[i] is None:
            hit[i] = escape
        else:
            hit[i] = kids[i][0]
            thread(kids[i][0], kids[i][1])
            thread(kids[i][1], escape)

    thread(0, -1)
    return (torch.stack(bbox).reshape(-1),
            torch.tensor([hit, miss, leaf], dtype=torch.int32).T.reshape(-1))


@pytest.mark.parametrize('align', [True, False])
def test_walk_tables_give_back_the_packed_tables(align):
    """The node pairs renumbered in DFS order and threaded again give
    back bbox and links bit for bit; each leaf code's count is the row's
    real faces; the float4 triangles are the leaf columns."""
    (v0, e1, e2), _, _ = bvh_emulate.mesh_tris(9)
    pb = bk.pack(bvh_mod.build(v0, e1, e2, align=align),
                 payload=np.arange(len(v0), dtype=np.float32))
    wt = bk.walk_tables(pb)
    assert bk.walk_tables(pb) is wt
    bbox, links = tables_of_walk(wt)
    n = pb.n_nodes
    assert torch.equal(bbox.view(torch.int32),
                       pb.bbox[:6 * n].view(torch.int32))
    assert torch.equal(links, pb.links)
    assert wt.depth == bk.tree_depth(pb.links.numpy(), n)
    rows = pb.leaves.view(-1, pb.stride)
    bits = wt.rec.view(torch.int32).reshape(-1, 4, 4)
    refs = torch.cat([bits[:1, 0, 3], bits[1:, 0, 3], bits[1:, 2, 3]])
    code = ~refs[refs < 0]
    real = (rows[:, 72:80] >= 0).sum(1)
    assert torch.equal((code & 7) + 1, real[code >> 3].int())
    assert sorted((code >> 3).tolist()) == list(range(pb.n_leaves))
    tri = wt.tri.view(-1, 8, 3, 4)
    for c in range(3):
        for ax in range(3):
            assert torch.equal(tri[:, :, c, ax],
                               rows[:, 24 * c + 8 * ax:24 * c + 8 * ax + 8])
    assert torch.equal(tri[:, :, 0, 3], rows[:, 72:80])


def test_walk_tables_refuse_a_tree_deeper_than_the_stack():
    """A threaded tree whose right spine is 70 inner nodes deep (each
    with a one-face leaf on its left): a walk may defer one child at each
    inner node of its path, more than the kernels' stack of 64 holds, so
    walk_tables raises rather than let a kernel overrun it."""
    k = 70
    n = 2 * k + 1                 # inner 2j, its leaf 2j + 1, last leaf 2k
    hit = np.arange(1, n + 1, dtype=np.int32)
    hit[-1] = -1
    miss = np.where(np.arange(n) % 2 == 0, -1, np.arange(1, n + 1))
    leaf = np.arange(n) % 2 == 1
    leaf[-1] = True
    off = np.where(leaf, np.cumsum(leaf) - 1, -1).astype(np.int32)
    faces = np.zeros((k + 1 + 8, 3), np.float32)
    b = bvh_mod.BVH(bb_min=np.zeros((n, 3), np.float32),
                    bb_max=np.ones((n, 3), np.float32),
                    hit_link=hit, miss_link=miss.astype(np.int32),
                    leaf_offset=off, leaf_count=leaf.astype(np.int32),
                    v0=faces, e1=faces, e2=faces,
                    perm=np.r_[np.arange(k + 1), -np.ones(8)].astype(
                        np.int32))
    pb = bk.pack(b)
    assert bk.tree_depth(pb.links.numpy(), n) == k + 1
    with pytest.raises(ValueError, match='deferred children'):
        bk.walk_tables(pb)


def _ablated(tmp, name):
    """A tree under `tmp` holding csrc/ with tools/k1_ablate.py's edits
    of ablation `name` applied to bvh_kernels.cu."""
    import k1_ablate
    csrc = os.path.join(ROOT, 'beifong_tpu_torch', 'csrc')
    dst = os.path.join(tmp, name, 'beifong_tpu_torch', 'csrc')
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, 'bvh_kernels.cu')
    with open(path) as f:
        src = f.read()
    for old, new in k1_ablate.BVH_ABLATIONS[name]:
        assert src.count(old) == 1, name
        src = src.replace(old, new)
    with open(path, 'w') as f:
        f.write(src)
    return os.path.join(tmp, name)


def test_bvh_ablations_apply_to_the_source():
    """Each edit of tools/k1_ablate.py's K2 / K3 ablations finds its text
    once in csrc/bvh_kernels.cu."""
    import k1_ablate
    with open(os.path.join(ROOT, 'beifong_tpu_torch', 'csrc',
                           'bvh_kernels.cu')) as f:
        src = f.read()
    for name, edits in k1_ablate.BVH_ABLATIONS.items():
        assert all(src.count(old) == 1 for old, _ in edits), name


@pytest.mark.parametrize('name', ['bvh_lockstep', 'bvh_any_left'])
def test_emulated_ablations_equal_plain_versions(lib, cases, tmp_path,
                                                 name):
    """The walk without its lane refill, and K3 entering the left child
    first, give the same bits (they change only which lane walks which ray
    when, and K3's order)."""
    tree = _ablated(str(tmp_path), name)
    ab = bvh_emulate.Emulated(bvh_emulate.emulate(
        tree, str(tmp_path / f'{name}.so')), tree)
    pb, o, d, maxt = cases['mesh_queries']
    ref = bvh_emulate.plain(pb, o, d, maxt)
    assert bvh_emulate.differing(ab.run(pb, o, d, maxt), ref) == {}


def _listing(name, blocks):
    """A made-up cuobjdump listing of kernel `name`: `blocks` a list of
    opcodes and ('loop', start index) markers closing a loop there."""
    lines = [f'        Function : _ZN12_GLOBAL__N_1{len(name)}{name}E']
    ops = []
    for b in blocks:
        if isinstance(b, tuple):
            ops.append(f'@P0 BRA 0x{16 * b[1]:x}')
        else:
            ops.append(b)
    lines += [f'        /*{16 * i:04x}*/    {op} ;' for i, op in enumerate(ops)]
    return '\n'.join(lines)


def test_bvh_mix_reads_node_steps_and_triangles():
    """tools/bvh_mix.py on made-up listings: the node-pair walk (a step
    loop of four LDG.E.128 and 30 other instructions around a pop loop of
    3, beside a triangle loop of 40 with one MUFU.RCP) and the threaded
    walk (a step loop of 25 instructions of its own around the triangle
    loop)."""
    import bvh_mix
    tri = ['LDG.E.128 R0, [R2]'] * 3 + ['MUFU.RCP R6, R7'] \
        + ['FFMA R2, R3, R4, R5'] * 35
    pairs = (['IADD3 R1, R1, 1'] * 5                     # 0-4: refill
             + ['LDG.E.128 R8, [R2]'] * 4 + ['FMNMX R1, R2, R3'] * 26
             + ['LDL.64 R4, [R1]', 'ISETP.GE P0, R1, 0']  # 35-36: pop
             + [('loop', 35)]                              # 37
             + ['ISETP.GT P0, R1, 0', ('loop', 5)]        # 38-39
             + tri + [('loop', 40)]                        # 40-79
             + [('loop', 0)])
    text = _listing('bvh_closest_kernel', pairs)
    res = bvh_mix.per_test(bvh_mix.parse(text)['closest'])
    assert res['triangle'] == 40
    assert res['slabs_a_step'] == 2
    assert res['slab'] == (40 - 5 - 3) / 2
    threaded = (['LDG.E.CONSTANT R0, [R2]'] * 9 + ['FMNMX R1, R2, R3'] * 10
                + tri + [('loop', 19)] + ['IADD3 R1, R1, 1'] * 5
                + [('loop', 0)])
    text = _listing('bvh_any_kernel', threaded)
    res = bvh_mix.per_test(bvh_mix.parse(text)['any'])
    assert res['triangle'] == 40
    assert res['slabs_a_step'] == 1
    assert res['slab'] == 19 + 5 + 1
