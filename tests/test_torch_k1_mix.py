"""tools/k1_mix.py on the CPU: the stage masks it reads from the plain
version's counts (the flagship's, the coherent configuration's, the
analytic lobe twins', the analytic Doppler power configuration's, the
mesh Doppler kernel's, the mesh configuration's in power and the MIMO
configuration's main paths, with each BVH walk's visits), the SIMT
models built on them, and the stage tags of the flagship, coherent,
lobe, Doppler power, mesh Doppler, mesh and MIMO array kernels' source
that its instruction mix reads; the anchors by which tools/k1_clock.py
instruments that source, and the edits of tools/k1_ablate.py."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))

import k1_ablate  # noqa: E402
import k1_clock  # noqa: E402
import k1_mix  # noqa: E402
from beifong_tpu_torch.integrators import receive_kernel as rk  # noqa: E402
from beifong_tpu_torch.scenes import flagship_scene  # noqa: E402

N = 1 << 10


@pytest.fixture(scope='module')
def lanes():
    masks, n_rect = k1_mix.stage_masks(N)
    return masks, n_rect, k1_mix.per_lane(masks, N)


def test_stage_masks_sum_to_the_plain_versions_stats(lanes):
    masks, n_rect, a = lanes
    s, rx = flagship_scene()
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp,
                              rk.philox_uniforms(7, rk.n_draws(3), N),
                              adc=rx.adc, max_depth=3, time_sampling='gate',
                              rx_kind='wigner', stats=stats)
    assert n_rect == int((prim[:, 0] == 0).sum())
    for key, v in a.items():
        assert int(v.sum()) == stats[key], key
    # one trace a depth at most, a hit only where a trace was
    assert int(a['trace'].max()) == 1
    assert bool((a['hit'] <= a['trace']).all())


def test_philox_blocks_follow_the_positional_draws(lanes):
    _, _, a = lanes
    phx = k1_mix.philox_blocks(a)
    # the ray's draws 1-4 span blocks 0 and 1; three depths of six draws
    # from 5 reach block 5 at most
    assert phx.min() >= 2 and phx.max() <= 6
    dead = a['hit'][:, 0] == 0
    assert bool((phx[dead] == 2).all())


def test_simt_models_bound_their_work(lanes):
    _, n_rect, a = lanes
    w = k1_mix.stage_weights_fp32(n_rect)
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    assert 0 < m['grid_stride_efficiency'] <= 1
    assert 0 < m['refill_efficiency'] <= 1
    assert m['grid_stride_slots_a_lane'] >= m['used_slots_a_lane']
    p = k1_mix.pool_model(a, w, lanes_per_thread=8)
    assert p['efficiency'] <= 1
    # a pool of 64 paths fills its turns better than one lane a thread
    assert p['slots_a_lane'] < m['grid_stride_slots_a_lane']
    assert p['turns']['ray'] == N // 32


@pytest.mark.parametrize('splat, kernel', [
    (False, 'receive_flagship_kernel'), (True, 'receive_flagship_kernel'),
    (False, 'receive_coherent_kernel'), (False, 'receive_lobe_kernel'),
    (False, 'receive_endpoint_kernel'),
    (False, 'receive_endpoint_coherent_kernel'),
    (False, 'receive_doppler_power_kernel'),
    (False, 'receive_mesh_doppler_kernel'), (False, 'receive_mesh_kernel'),
    (False, 'receive_mimo_array_kernel')])
def test_clock_probe_anchors_appear_once(splat, kernel):
    """k1_clock patches the kernel's source by exact text: each of its
    anchors lies in the current source once (the warp loop's in the
    kernel's body; else it raises)."""
    with open(k1_mix.source_of(ROOT)) as f:
        src = f.read()
    out = k1_clock.instrument(src, splat, kernel)
    assert out.count('__device__ unsigned long long k1_clk[16];') == 1
    assert out.count('clock64()') > src.count('clock64()')


@pytest.mark.parametrize('config', ['pulse_train', 'dechirp'])
def test_coherent_masks_sum_to_the_plain_versions_stats(config):
    """The coherent configuration's masks: each stat key's per-lane counts
    sum to the plain version's, the SIMT models take them, and a pool of
    64 paths a warp issues fewer slots than the grid-stride loop."""
    n = 1 << 10
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    kw = k1_mix.ref_kw(config, rx, p)
    assert a['trace'].shape == (n, kw['max_depth'])
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp,
                              rk.philox_uniforms(7, rk.n_draws(
                                  kw['max_depth']), n), stats=stats, **kw)
    for key, v in a.items():
        assert int(v.sum()) == stats[key], key
    assert int(a['phase'].sum()) > 0
    w = k1_mix.stage_weights_fp32(n_rect, config)
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    assert 0 < m['grid_stride_efficiency'] <= 1
    pm = k1_mix.pool_model(a, w, lanes_per_thread=8, fused=True)
    assert pm['efficiency'] <= 1
    assert pm['slots_a_lane'] < m['grid_stride_slots_a_lane']


def _body_lines(lines, head):
    """(first, last) lines of the function whose definition starts with
    `head` at a line's start."""
    a = next(i for i, ln in enumerate(lines, 1) if ln.startswith(head))
    b = next(i for i, ln in enumerate(lines, 1) if i > a and ln == '}')
    return a, b


def test_coherent_source_carries_every_stage_tag():
    """The coherent kernel's tags: each stage that k1_mix reads lies in
    its body, and the helpers of its draws, phase and splats are found."""
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    a = next(i for i, ln in enumerate(lines, 1)
             if ln.startswith('receive_coherent_kernel('))
    b = next(i for i, ln in enumerate(lines, 1) if i > a and ln == '}')
    stages = {st for ln, st in k1_mix.line_stages(src).items() if a < ln < b}
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
            'phase', 'splat', 'bounce', 'trace', 'closest'} <= stages
    helpers = k1_mix.func_ranges(src)
    assert {'draws_coh', 'splat_c', 'splat_g', 'phase', 'phase_f',
            'phase_h', 'phase_c'} <= set(helpers)


def test_flagship_source_carries_every_stage_tag():
    src = k1_mix.source_of(ROOT)
    stages = set(k1_mix.line_stages(src).values())
    assert {'ray', 'closest', 'hit', 'direct', 'nee', 'shadow', 'bounce',
            'sched'} <= stages
    helpers = k1_mix.func_ranges(src)
    assert {'draws', 'draws_get', 'splat', 'splat_w'} <= set(helpers)


@pytest.mark.parametrize('op, cls', [('FFMA', 'fp32'), ('FADD.FTZ', 'fp32'),
                                     ('MUFU.RSQ', 'mufu'),
                                     ('IMAD.WIDE.U32', 'imad'),
                                     ('LDS.128', 'lds'), ('BRA', 'branch'),
                                     ('F2I.FLOOR.NTZ', 'convert'),
                                     ('MATCH.ANY', 'move_select')])
def test_classify(op, cls):
    assert k1_mix.classify(op) == cls


def test_issue_slot_bound():
    # 32 thread-instructions a lane: one warp instruction a lane
    ms = k1_mix.issue_slot_bound_ms(32.0, 132 * 4 * 1e6, 1000.0)
    assert np.isclose(ms, 1.0)


def _window(config, n):
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    return a, n_rect, p, k1_mix.ref_kw(config, rx, p)


@pytest.mark.parametrize('config', ['window_thin', 'window_dielectric'])
def test_window_masks_sum_to_the_plain_versions_stats(config):
    """The analytic lobe twins' windowed corner (depth 6, the thin window
    in power, the smooth one in I / Q): each stat key's per-lane counts
    sum to the plain version's, its lanes run delta chains (mirror and
    dielectric bounces, direct hits), and both Philox models count their
    blocks."""
    n = 1 << 10
    a, _, p, kw = _window(config, n)
    assert kw['lobes'] == p.lobes and kw['max_depth'] == 6
    assert kw['coherent'] == (config == 'window_dielectric')
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    stats: dict = {}
    nd = rk.n_draws(6, 1, **rk.lobe_draws(p.lobes))
    rk.receive_megakernel_ref(params, prim, txp,
                              rk.philox_uniforms(7, nd, n), stats=stats,
                              **kw)
    for key, v in a.items():
        assert int(v.sum()) == stats[key], key
    for key in ('mirror_bounce', 'diel_bounce', 'direct'):
        assert int(a[key].sum()) > 0, key
    stride, pick = k1_mix.draw_stride(kw)
    assert (stride, pick) == (6, 0)
    phx = k1_mix.philox_blocks(a, False, stride, pick)
    blocks = k1_mix.stage_blocks(a, direct=True, stride=stride)
    assert phx.min() >= 2 and blocks.min() >= 2
    assert bool((blocks == 2 + 2 * a['hit'].sum(1) + a['direct'].sum(1))
                .all())


def test_simt_models_bound_their_work_on_a_window_scene():
    """The SIMT models weigh the lobe keys on the thin windowed corner:
    the grid-stride loop and the pool issue at least what they use, and a
    pool of 64 paths a warp fewer slots than the grid-stride loop."""
    a, n_rect, _, _ = _window('window_thin', 1 << 10)
    w = k1_mix.stage_weights_fp32(n_rect, 'window_thin')
    assert w['diel_bounce'] > 0 and w['mirror_bounce'] > 0
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    assert 0 < m['grid_stride_efficiency'] <= 1
    assert m['grid_stride_slots_a_lane'] >= m['used_slots_a_lane']
    pm = k1_mix.pool_model(a, w, lanes_per_thread=8, fused=True)
    assert 0 < pm['efficiency'] <= 1
    assert pm['slots_a_lane'] < m['grid_stride_slots_a_lane']


def test_lobe_source_carries_every_stage_tag():
    """Every stage k1_mix reads lies in the lobe kernel's body, the lobe
    stages also in trace_lane's lobe path (the mesh lobe twins'), and the
    power splat's helper is found."""
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    a, b = _body_lines(lines, 'receive_lobe_kernel(')
    st = k1_mix.line_stages(src)
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
            'phase', 'splat', 'trace', 'closest'} \
        <= {v for ln, v in st.items() if a < ln < b}
    lobe = {'lobe_nee', 'pick', 'mirror', 'diel', 'ggx', 'diffuse',
            'bounce'}
    for head in ('receive_lobe_kernel(', '__device__ float trace_lane('):
        a, b = _body_lines(lines, head)
        assert lobe <= {v for ln, v in st.items() if a < ln < b}, head
    assert 'splat_p' in k1_mix.func_ranges(src)


def test_ablations_apply_to_the_source():
    """Each edit of tools/k1_ablate.py finds its text once in the source
    (the grid-stride lobe twins' code stays for the mesh twins); the
    stage tags, which the source already carries, once as edited."""
    with open(k1_mix.source_of(ROOT)) as f:
        src = f.read()
    for name, edits in k1_ablate.ABLATIONS.items():
        body, head, tail = k1_ablate.scoped(src, name)
        for old, new in edits:
            assert body.count(new if name == 'tags' else old) == 1, name
        for old, _ in k1_ablate.OUTSIDE.get(name, ()):
            assert (head + tail).count(old) == 1, name


@pytest.mark.parametrize('config', ['ep_phased_tx', 'ep_phased_rx',
                                    'ep_four_tx', 'ep_phased_tx_coh'])
def test_endpoint_masks_sum_to_the_plain_versions_stats(config):
    """The endpoint configurations' masks sum to the plain version's stage
    counts (n_draws of the scene's transmitters), their cross-WDF totals
    come with them (the index visits at most the pairs tested, at least
    those inside), and both Philox models count the ray's two blocks."""
    n = 1 << 10
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    pairs = k1_mix.pair_totals(masks)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    kw = k1_mix.ref_kw(config, rx, p)
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp, rk.philox_uniforms(
        7, rk.n_draws(2, int(txp.shape[0])), n), stats=stats, **kw)
    for key, v in a.items():
        assert int(v.sum()) == stats[key], key
    assert pairs['n_tx'] == int(txp.shape[0])
    assert pairs['pair_terms'] <= pairs['pair_visits'] <= pairs['pair_tests']
    assert pairs['pair_tests'] > 0
    for turns in (False, True):
        b = k1_mix.ep_blocks(a, pairs['n_tx'], turns)
        assert b.shape == (n,) and b.min() >= 2


def test_endpoint_source_carries_every_stage_tag():
    """The endpoint kernels' tags: each stage that k1_mix reads lies in
    their bodies, and the footprint index's in pair_sum_epx."""
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    tags = k1_mix.line_stages(src)
    for kernel in ('receive_endpoint_kernel(',
                   'receive_endpoint_coherent_kernel('):
        a, b = _body_lines(lines, kernel)
        stages = {st for ln, st in tags.items() if a < ln < b}
        assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
                'nee_pairs', 'splat', 'bounce', 'trace',
                'closest'} <= stages, kernel
    a, b = _body_lines(lines, '__device__ float pair_sum_epx(')
    assert {'pairs', 'pair_index'} <= {st for ln, st in tags.items()
                                       if a < ln < b}
    assert 'pairs' in k1_mix.func_ranges(src)


@pytest.mark.parametrize('config', ['range_doppler', 'fmcw_sonar'])
def test_doppler_power_masks_sum_to_the_plain_versions_stats(config):
    """The analytic Doppler power configurations (the range-Doppler
    pulse, golden config 2 under mix_resample): each stat key's per-lane
    counts sum to the plain version's in power, their contributions splat
    over time x frequency (fmcw_sonar's at a beat), the SIMT models take
    them, a pool of 64 paths a warp issues fewer slots than the
    grid-stride loop, and the kernel's Philox blocks (two for the ray, two
    a hit, one a direct hit) count from the same masks."""
    n = 1 << 10
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    kw = k1_mix.ref_kw(config, rx, p)
    assert kw['coherent'] is False and kw['doppler'] is True
    assert kw['time_sampling'] == k1_mix.CONFIGS[config]['ts']
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp,
                              rk.philox_uniforms(7, rk.n_draws(2), n),
                              stats=stats, **kw)
    for key, v in a.items():
        assert int(v.sum()) == stats[key], key
    assert int(a['phase'].sum()) == 0 and int(a['splat_2d'].sum()) > 0
    assert (int(a['lo_bin'].sum()) > 0) == (config == 'fmcw_sonar')
    w = k1_mix.stage_weights_fp32(n_rect, config)
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    assert 0 < m['grid_stride_efficiency'] <= 1
    pm = k1_mix.pool_model(a, w, lanes_per_thread=8, fused=True)
    assert 0 < pm['efficiency'] <= 1
    assert pm['slots_a_lane'] < m['grid_stride_slots_a_lane']
    blocks = k1_mix.stage_blocks(a, direct=True)
    assert bool((blocks == 2 + 2 * a['hit'].sum(1) + a['direct'].sum(1))
                .all())


def test_doppler_power_source_carries_every_stage_tag():
    """The Doppler power kernel's tags: each stage that k1_mix reads lies
    in its body (no echo phase in power), and its splats' helpers are
    found; the kernel pattern names it and the grid-stride instantiation
    it replaced."""
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    a, b = _body_lines(lines, 'receive_doppler_power_kernel(')
    stages = {st for ln, st in k1_mix.line_stages(src).items() if a < ln < b}
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
            'splat', 'bounce', 'trace', 'closest'} <= stages
    assert 'phase' not in stages
    helpers = k1_mix.func_ranges(src)
    assert {'splat_p', 'splat_g'} <= set(helpers)
    import re
    for name in ('receive_doppler_power_kernel',
                 'receive_doppler_kernelILb0ELb0ELb0ELb0ELb0E'):
        assert re.search(k1_mix.DPW_KERNEL, name)
    assert not re.search(k1_mix.DPW_KERNEL,
                         'receive_doppler_kernelILb0ELb0ELb1ELb0ELb0E')


@pytest.mark.parametrize('config', ['multi_body', 'mesh_lobes_iq',
                                    'mesh_lobes_power', 'coherent_mesh'])
def test_mesh_masks_sum_to_the_plain_versions_stats(config):
    """The mesh configurations (multi_body in power, the rough-plastic mesh
    in I / Q and in power, the diffuse mesh in I / Q, with the main path's
    direction strata): each stat key's
    per-lane counts sum to the plain version's, each walk's recorded slab
    tests and leaves to its node and leaf tests, RAY's walks are the
    depth-0 ones, the walk models' efficiencies lie in (0, 1], and the
    pool and SIMT models take the walks' costs."""
    n = 1 << 12
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    params[0] = rk.seed_slot(k1_mix.SEED)
    kw = k1_mix.ref_kw(config, rx, p)
    assert kw['patch_p'] == 32 and kw['mesh'] is not None
    assert kw['coherent'] == k1_mix.MESH_COHERENT[config]
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp, rk.philox_uniforms(
        k1_mix.SEED, rk.n_draws(2, 1, **rk.lobe_draws(kw['lobes'])), n),
        stats=stats, **kw)
    for key in k1_mix.KEYS:
        assert int(a[key].sum()) == stats[key], key
    nodes = sum(int(a[f'node_{w}'].sum()) for w in k1_mix.WALKS)
    leaves = sum(int(a[f'leaf_{w}'].sum()) for w in k1_mix.WALKS)
    assert nodes == stats['node_tests'] and leaves == stats['leaf_tests']
    # every lane walks at depth 0 (RAY's first hit) and only there
    assert int((a['node_ray'][:, 0] > 0).sum()) == n
    assert int(a['node_ray'][:, 1:].sum()) == 0
    assert int(a['node_bounce'][:, 0].sum()) == 0
    w = k1_mix.stage_weights_fp32(n_rect, config)
    for v in k1_mix.walk_simt(a, w).values():
        assert 0 < v['grid_stride_efficiency'] <= 1
        assert 0 < v['wavefront_efficiency'] <= 1
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    pm = k1_mix.pool_model(a, w, lanes_per_thread=8, fused=True)
    assert 0 < m['grid_stride_efficiency'] <= 1
    assert 0 < pm['efficiency'] <= 1
    assert m['used_slots_a_lane'] > w['ray']


def test_mesh_doppler_source_carries_every_stage_tag():
    """The mesh Doppler kernel's tags: each stage that k1_mix reads lies
    in its body, its walks' own (walk, shadow_walk) among them; the kernel
    patterns name its four instantiations and the grid-stride ones they
    replaced (and no other), and a listing's walk lines
    (csrc/bvh_walk.cuh) read as the walk's triangle or node code at the
    call site's stage."""
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    a, b = _body_lines(lines, 'receive_mesh_doppler_kernel(')
    stages = {st for ln, st in k1_mix.line_stages(src).items() if a < ln < b}
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'lobe_nee',
            'shadow', 'shadow_walk', 'phase', 'splat', 'bounce', 'pick',
            'mirror', 'diel', 'ggx', 'diffuse', 'trace', 'closest',
            'walk'} <= stages
    import re
    for pat, names in (
            (k1_mix.MDK_KERNEL, ('receive_mesh_doppler_kernelILb0ELb0E',
                                 'receive_doppler_kernelILb1ELb0ELb0ELb0E'
                                 'Lb0E')),
            (k1_mix.MDK_LOB_KERNEL, ('receive_mesh_doppler_kernelILb1ELb1E',
                                     'receive_doppler_kernelILb1ELb1ELb0E'
                                     'Lb0ELb1E')),
            (k1_mix.MDK_POW_LOB_KERNEL,
             ('receive_mesh_doppler_kernelILb0ELb1E',
              'receive_doppler_kernelILb1ELb0ELb0ELb0ELb1E')),
            (k1_mix.MDK_COH_KERNEL, ('receive_mesh_doppler_kernelILb1ELb0E',
                                     'receive_doppler_kernelILb1ELb1ELb0E'
                                     'Lb0ELb0E'))):
        for name in names:
            assert re.search(pat, name)
    pats = (k1_mix.MDK_KERNEL, k1_mix.MDK_LOB_KERNEL,
            k1_mix.MDK_POW_LOB_KERNEL, k1_mix.MDK_COH_KERNEL)
    for i, pat in enumerate(pats):
        for j, other in enumerate(pats):
            for name in other.split('|'):
                assert bool(re.search(pat, name)) == (i == j), (pat, name)
    # the media twins are none of them
    assert not any(re.search(p, 'receive_doppler_kernelILb1ELb1ELb1ELb0E'
                             'Lb0E') for p in pats)
    tri = k1_mix.walk_triangle_lines(ROOT)
    assert tri[0] > 0 and tri[1] > tri[0]
    walk = next(ln for ln, st in k1_mix.line_stages(src).items()
                if a < ln < b and st == 'walk')
    listing = ('\t.text.f:\n'
               f'\t//## File "x/bvh_walk.cuh", line {tri[0] + 2} inlined at '
               f'"x/receive_megakernel.cu", line {walk}\n'
               '\t/*0010*/ FFMA R1, R2, R3, R4 ;\n')
    (op, chain), = k1_mix.parse_functions(listing)['f']
    assert op == 'FFMA' and chain == [-(tri[0] + 2), walk]


@pytest.mark.parametrize('config', ['multi_body', 'mesh_lobes_iq',
                                    'mesh_lobes_power', 'coherent_mesh'])
def test_clock_reads_each_mesh_configuration_on_its_kernel(config):
    """k1_clock instruments the mesh Doppler kernel's turns for every mesh
    configuration of this source (rk_launch launches its instantiation),
    and the grid-stride body's lanes for a source whose configuration
    still runs the grid-stride instantiation."""
    with open(k1_mix.source_of(ROOT)) as f:
        src = f.read()
    assert k1_clock.mdk_runs(src, config)
    out = k1_clock.instrument(src, False, k1_clock.MDK_KERNEL, config)
    assert 'k1_acc' not in out and 'ck[12] += clock64() - q0;' in out
    old = src.replace(k1_clock.MDK_LAUNCH[config], 'launch(other')
    assert not k1_clock.mdk_runs(old, config)
    out = k1_clock.instrument(old, False, k1_clock.MDK_KERNEL, config)
    assert 'k1_acc[1][threadIdx.x]' in out


@pytest.mark.parametrize('config', ['mesh', 'mimo'])
def test_mesh_power_and_mimo_masks_sum_to_the_plain_versions_stats(config):
    """The mesh configuration in power (the diffuse mesh_scene, the main
    path's strata) and the MIMO configuration (golden config 6): each stat
    key's per-lane counts sum to the plain version's (MIMO's element
    channels, counted over the elements, among them), the mesh's walks to
    its node and leaf tests, and the SIMT and pool models take them (the
    element loop and the walks weighted)."""
    n = 1 << 12
    masks, n_rect = k1_mix.stage_masks(n, config=config)
    a = k1_mix.per_lane(masks, n)
    s, rx = k1_mix.scene_of(config)
    p = rk.pack_scene(s.compile(device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(x) for x in (p.params, p.prim, p.txp))
    if p.mesh is not None:
        params[0] = rk.seed_slot(k1_mix.SEED)
    kw = k1_mix.ref_kw(config, rx, p)
    assert kw['max_depth'] == 2 and kw['time_sampling'] == 'gate'
    stats: dict = {}
    rk.receive_megakernel_ref(params, prim, txp, rk.philox_uniforms(
        k1_mix.SEED, rk.n_draws(2), n), stats=stats, **kw)
    for key in k1_mix.KEYS:
        assert int(a[key].sum()) == stats[key], key
    if config == 'mesh':
        assert kw['patch_p'] == 32 and not kw.get('doppler')
        nodes = sum(int(a[f'node_{w}'].sum()) for w in k1_mix.WALKS)
        assert nodes == stats['node_tests'] > 0
        assert int(a['phase'].sum()) == 0
    else:
        assert int(kw['eoff'].shape[0]) == 8 and kw['rx_kind'] == 'phased'
        assert int(a['mimo_elem'].sum()) == 8 * int(a['phase'].sum()) > 0
        assert 'node_ray' not in a
    w = k1_mix.stage_weights_fp32(n_rect, config)
    assert (w.get('mimo_elem', 0) > 0) == (config == 'mimo')
    m = k1_mix.simt(a, w, lanes_per_thread=8)
    pm = k1_mix.pool_model(a, w, lanes_per_thread=8, fused=True)
    assert 0 < m['grid_stride_efficiency'] <= 1
    assert 0 < pm['efficiency'] <= 1
    # at 4,096 lanes few of the mesh's warps meet a hit: the pool issues at
    # most the grid-stride loop's slots
    assert pm['slots_a_lane'] <= m['grid_stride_slots_a_lane']


def test_mesh_and_mimo_sources_carry_every_stage_tag():
    """The mesh kernel's and the MIMO array kernel's tags: each stage that
    k1_mix reads lies in their bodies (the mesh kernel's walks, no echo
    phase in power), the element loops (mimo_splat's, the grid-stride
    twins', and the MIMO array kernel's warp taps) are found, and each kernel
    pattern names the kernel and the grid-stride instantiation it replaced
    (and not the media or endpoint twins)."""
    import re
    src = k1_mix.source_of(ROOT)
    with open(src) as f:
        lines = f.read().splitlines()
    st = k1_mix.line_stages(src)
    a, b = _body_lines(lines, 'receive_mesh_kernel(')
    stages = {v for ln, v in st.items() if a < ln < b}
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
            'shadow_walk', 'splat', 'bounce', 'trace', 'closest',
            'walk'} <= stages
    assert 'phase' not in stages
    a, b = _body_lines(lines, 'receive_mimo_array_kernel(')
    assert {'draws', 'sched', 'ray', 'hit', 'direct', 'nee', 'shadow',
            'splat', 'bounce', 'trace', 'closest'} \
        <= {v for ln, v in st.items() if a < ln < b}
    helpers = k1_mix.func_ranges(src)
    assert {'splat_m', 'elem', 'splat_p', 'splat_s', 'elem_w'} \
        <= set(helpers)
    m0, m1 = helpers['splat_m']
    assert m0 < helpers['elem'][0] < helpers['elem'][1] < m1
    # the MIMO array kernel stages its taps and spreads them over the warp
    a, b = _body_lines(lines, 'receive_mimo_array_kernel(')
    body = '\n'.join(lines[a - 1:b])
    assert 'mimo_stage(' in body and 'mimo_warp_taps(' in body
    assert 'mimo_splat(' not in body
    for pat, names, not_names in (
            (k1_mix.MSK_KERNEL, ('receive_mesh_kernel',
                                 'receive_trace_kernelILb1ELb0ELb0EEv'),
             ('receive_trace_kernelILb1ELb1ELb0EEv',
              'receive_trace_kernelILb1ELb0ELb1EEv',
              'receive_mesh_doppler_kernelILb0ELb0E')),
            (k1_mix.MAK_KERNEL, ('receive_mimo_array_kernel',
                                 'receive_mimo_kernelILb0ELb0EEv'),
             ('receive_mimo_kernelILb1ELb0EEv',
              'receive_mimo_kernelILb0ELb1EEv'))):
        for name in names:
            assert re.search(pat, name), (pat, name)
        for name in not_names:
            assert not re.search(pat, name), (pat, name)


@pytest.mark.parametrize('kernel', ['receive_mesh_kernel',
                                    'receive_mimo_array_kernel'])
def test_clock_reads_the_mesh_and_mimo_kernels_or_their_parents(kernel):
    """k1_clock instruments the new kernel's turns (its walks, or its
    connections' splats, read per thread), and in a source without it
    the grid-stride instantiation's lanes."""
    with open(k1_mix.source_of(ROOT)) as f:
        src = f.read()
    out = k1_clock.instrument(src, False, kernel)
    assert 'k1_acc' not in out
    assert ('ck[12] += clock64() - q0;' in out) \
        == (kernel == 'receive_mesh_kernel')
    assert ('ck[14] += clock64() - q2;' in out) \
        == (kernel == 'receive_mimo_array_kernel')
    old = src.replace(f'{kernel}(const float', 'other_kernel(const float')
    out = k1_clock.instrument(old, False, kernel)
    assert 'k1_acc[0][threadIdx.x]' in out
    assert ('k1_acc[1][threadIdx.x]' in out) \
        == (kernel == 'receive_mesh_kernel')
    assert ('k1_acc[4][threadIdx.x] += (unsigned)(clock64() - k1_m0)'
            in out) == (kernel == 'receive_mimo_array_kernel')
