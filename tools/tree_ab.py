#!/usr/bin/env python3
"""A/B of the receive megakernel's flagship, mesh and Doppler
configurations in two checkouts of the repository on one card: this tree
against another (a parent commit unpacked with `git archive`).

Run from the repository root:

    python3 tools/tree_ab.py --other DIR [--pairs 3]

Each tree runs in processes of its own, in pairs whose order alternates
(other, this, this, other, ...).  A process imports `beifong_tpu_torch`
from its tree, builds the kernel there, and times with CUDA events the
kernel alone at the main paths' shapes: the flagship at 2^28 Philox
lanes, depth 3, the mesh scene at 2^24 lanes, depth 2, and the Doppler
configuration on multi_body (mesh) and the range-Doppler pulse
(analytic), 2^24 lanes, depth 2, and the coherent configuration on pulse
0 of the pulse train (analytic, depth 1) and the mesh scene (depth 2),
2^24 lanes, on the dechirp and the FMCW mixer (analytic, depth 2, 2^24
lanes) and on the CPIs of the corner (64 pulses x 2^16 lanes, depth 4,
fixed sampling) and of the micro-Doppler plate (64 x 2^13, depth 1) in
one launch each, and the analytic lobe twins on the lobe scenes at 2^24
lanes: the windowed corner (depth 6; the thin window in power, the
smooth one in I / Q), the depth-2 plastic, rough plastic, GGX glass
(target and through, the latter also in I / Q), blend and mask scenes in
power, and the windowed corner's 16-pulse CPI (2^20 lanes a pulse) in
one launch (one warm-up, then ten calls each), the endpoint twins on
the endpoint scenes at 2^24 Philox lanes, depth 2, gate (ep_phased_tx,
ep_phased_rx, ep_four_tx in power, ep_phased_tx_coh in I / Q: the
analytic endpoint kernels, or in a tree before them the grid-stride
twins), the analytic Doppler power configuration on golden config 2
(fmcw_sonar: mix_resample, 2^24 Philox lanes, depth 2, fixed sampling,
with a hash of its result, as the range-Doppler pulse above), the mesh
Doppler kernel's other paths, the rough-plastic mesh_scene in I / Q and
in power (mesh_lobes_iq, mesh_lobes_power: 2^24 Philox lanes, depth 2,
gate, the main path's direction strata; with multi_body, the coherent
mesh and the mesh scene in power above, a hash of each result), the
MIMO configuration on golden config 6 (mimo: 2^24 Philox lanes, depth 2,
gate, with a hash of its result), K4's
closest-hit and
shadow kernels at chip_smoke.K4_SHAPES (the wavefront's 2^17 rays x 324
faces, the query's 2^18 x 10,082 and 2^17 x 968: twenty calls queued
behind a sleeping kernel, five times), K2 / K3 (bvh_closest, bvh_any) on
chip_smoke.py's query rays at 2^20 and at the wavefront pass's 2^17
(queued as K4's, beside a call with its wrapper, the wrapper's host time
a call, enqueued behind a sleep, and a hash of the results' bits), the BVH wavefront's receive on
mesh_scene (bvh_wavefront: 2^20 samples, depth 2, three calls' wall
time), and the host time of ten
more calls of the wrapper, each from an idle card (the Python and launch
work inside the timed window), and for the Doppler family the host time of
its table lookups alone (the lobe flags and the transmitter kinds, read
back once a tensor and then kept).
Prints one JSON line per process, then a summary:
per tree the median of the processes' medians and their spread, the
ratio this / other, the pairs this tree won, and the host times.

    python3 tools/tree_ab.py --other DIR --this DIR2 --only flagship

times DIR2 in place of this tree, and only the named configurations
(comma-separated; an ablation's pairs need only the flagship; the mesh
Doppler kernel's are multi_body, coherent_mesh, mesh_lobes_iq and
mesh_lobes_power; the lobe
twins' are window_thin, window_dielectric, lobe_plastic,
lobe_rough_plastic, lobe_rough_dielectric, lobe_through,
lobe_through_iq, lobe_blend, lobe_mask and window_cpi; the endpoint
twins' ep_phased_tx, ep_phased_rx, ep_four_tx and ep_phased_tx_coh; the
Doppler power kernel's twins' doppler_sphere, doppler_checker and
doppler_sphere_checker (a tree whose range_doppler_scene takes them);
K4's are k4_closest and k4_any, which build only K4's library; K2 / K3's
bvh_closest, bvh_any and bvh_wavefront).

    python3 tools/tree_ab.py --other DIR --sass

compares instead the machine code of K1's kernels and of K2 / K3's and
K4's in the two trees (`cuobjdump -sass` of each tree's libraries; a
kernel that gained a
template flag is matched to its old name) and prints, per kernel, the
instruction counts and the instructions that differ once addresses and
encodings are dropped.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CALLS = 10
LOOKUPS = 400


def timed_configs(cs, flagship, mesh, multi_body, range_doppler, pulse_train):
    """(name, scene, lanes, depth, Doppler family, coherent) of each timed
    configuration."""
    return (('flagship', flagship, cs.N_LANES, cs.MAX_DEPTH, False, False),
            ('mesh', mesh, cs.MESH_LANES, cs.MESH_DEPTH, False, False),
            ('multi_body', multi_body, cs.DOP_LANES, cs.DOP_DEPTH, True,
             False),
            ('range_doppler', range_doppler, cs.DOP_LANES, cs.DOP_DEPTH,
             True, False),
            ('coherent', pulse_train, cs.COH_LANES, cs.PULSE_DEPTH, True,
             True),
            ('coherent_mesh', mesh, cs.COH_LANES, cs.COH_DEPTH, True,
             True))


# the coherent configuration's other main paths (one receive call each)
# and its CPIs (64 pulses in one launch), timed by child()
COH_PATHS = ('dechirp', 'mixer')
CPI_PATHS = ('corner_cpi', 'micro_cpi')
CPI_PULSES = 64
# the analytic lobe twins' scenes: (scenes' function, its argument,
# depth, coherent), and the windowed corner's CPI
LOBE_PATHS = {'window_thin': ('window_corner_scene', 'thin', 6, False),
              'window_dielectric': ('window_corner_scene', 'dielectric', 6,
                                    True),
              'lobe_plastic': ('plastic_scene', 'plastic', 2, False),
              'lobe_rough_plastic': ('plastic_scene', 'rough_plastic', 2,
                                     False),
              'lobe_rough_dielectric': ('rough_dielectric_scene', 'target',
                                        2, False),
              'lobe_through': ('rough_dielectric_scene', 'through', 2,
                               False),
              'lobe_through_iq': ('rough_dielectric_scene', 'through', 2,
                                  True),
              'lobe_blend': ('composite_scene', 'blend', 2, False),
              'lobe_mask': ('composite_scene', 'mask', 2, False)}
WINDOW_CPI_PULSES = 16

# the endpoint scenes: (scenes' function, coherent)
EP_PATHS = {'ep_phased_tx': ('phased_tx_scene', False),
            'ep_phased_rx': ('phased_rx_scene', False),
            'ep_four_tx': ('four_tx_scene', False),
            'ep_phased_tx_coh': ('phased_tx_scene', True)}
EP_LANES = 1 << 24
EP_DEPTH = 2
# the mesh Doppler kernel's paths timed beside multi_body and the coherent
# mesh: the mesh lobe twins in I / Q and in power on the rough-plastic
# mesh_scene
MDK_PATHS = ('mesh_lobes_iq', 'mesh_lobes_power')
# each mesh Doppler kernel path's scene: (scenes' function, its keywords,
# coherent)
MDK_SCENES = {'multi_body': ('multi_body_scene', {}, False),
              'coherent_mesh': ('mesh_scene', {}, True),
              'mesh_lobes_iq': ('mesh_scene', {'material': 'rough_plastic'},
                                True),
              'mesh_lobes_power': ('mesh_scene',
                                   {'material': 'rough_plastic'}, False)}
# the analytic Doppler power scenes timed here beside range_doppler:
# (scenes' function, time sampling)
# (scenes' function, time sampling, its keywords): golden config 2, and the
# Doppler power kernel's prims, texture and textured prims twins on the
# range-Doppler pulse (a tree whose scenes take a target and a ground)
DPW_PATHS = {'fmcw_sonar': ('fmcw_sonar_scene', 'fixed', {}),
             'doppler_sphere': ('range_doppler_scene', 'gate',
                                {'target': 'sphere'}),
             'doppler_checker': ('range_doppler_scene', 'gate',
                                 {'ground_texture': 'checkerboard'}),
             'doppler_sphere_checker': ('range_doppler_scene', 'gate',
                                        {'target': 'sphere',
                                         'ground_texture': 'checkerboard'})}
DPW_SCENES = {'range_doppler': ('range_doppler_scene', 'gate', {}),
              **DPW_PATHS}

K4_NAMES = ('k4_closest', 'k4_any')
# K2 / K3 on chip_smoke.py's query rays, and the BVH wavefront's receive
BVH_NAMES = ('bvh_closest', 'bvh_any', 'bvh_wavefront')
NAMES = ('flagship', 'mesh', 'multi_body', 'range_doppler', 'coherent',
         'coherent_mesh') + COH_PATHS + CPI_PATHS + tuple(LOBE_PATHS) \
    + ('window_cpi',) + tuple(EP_PATHS) + tuple(DPW_PATHS) \
    + tuple(MDK_PATHS) + ('mimo',) + K4_NAMES + BVH_NAMES


def doppler_power_call(rk, scenes, name: str, dev):
    """(params, prim, txp, keyword arguments) of receive_megakernel on an
    analytic Doppler power scene (DPW_SCENES) at chip_smoke.py's shapes
    (2^24 Philox lanes, depth 2), in the imported tree."""
    import torch
    fn, ts, args = DPW_SCENES[name]
    s, rx = getattr(scenes, fn)(**args)
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    kw = dict(adc=rx.adc, max_depth=EP_DEPTH, time_sampling=ts,
              rx_kind='wigner', n_lanes=EP_LANES, doppler=True,
              coherent=False, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror))
    if p.textured:
        kw.update(tex=torch.tensor(p.tex, device=dev),
                  bmp_meta=torch.tensor(p.bmp_meta, device=dev))
    return params, prim, txp, kw


def mesh_doppler_call(rk, scenes, name: str, dev):
    """(params, prim, txp, keyword arguments) of receive_megakernel on the
    mesh Doppler kernel's paths at chip_smoke.py's shapes (2^24 Philox
    lanes, depth 2, gate, the main path's strata), in the imported tree:
    a scene of MDK_SCENES."""
    import torch
    fn, kw_s, coh = MDK_SCENES[name]
    s, rx = getattr(scenes, fn)(**kw_s)
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    params[0] = rk.seed_slot(7)
    kw = dict(adc=rx.adc, max_depth=EP_DEPTH, time_sampling='gate',
              rx_kind='wigner', n_lanes=EP_LANES, doppler=True,
              coherent=coh, mirror=bool(p.mirror), mesh=p.mesh.to(dev),
              msh=torch.tensor(p.msh, device=dev),
              patch_p=rk.patch_p_for(EP_LANES))
    if p.lobes:
        kw['lobes'] = p.lobes
    return params, prim, txp, kw


def mimo_call(rk, scenes, dev):
    """(params, prim, txp, keyword arguments) of receive_megakernel on
    golden config 6 (the MIMO configuration) at chip_smoke.py's shapes
    (2^24 Philox lanes, depth 2, gate), in the imported tree."""
    import torch
    s, rx = scenes.mimo_beamform_scene()
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    kw = dict(adc=rx.adc, max_depth=EP_DEPTH, time_sampling='gate',
              rx_kind='phased', n_lanes=EP_LANES, doppler=True,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
              rxph=torch.tensor(p.rxph, device=dev),
              eoff=rk.array_offsets(s, sd, rx, dev))
    return params, prim, txp, kw


def mesh_call(rk, scenes, dev, cs):
    """(params, prim, txp, keyword arguments) of receive_megakernel on
    the mesh scene in power (the mesh configuration) at chip_smoke.py's
    shapes (2^24 lanes, depth 2, gate, the main path's strata), in the
    imported tree."""
    import torch
    s, rx = scenes.mesh_scene()
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=dev)
                         for a in (p.params, p.prim, p.txp))
    params[0] = rk.seed_slot(cs.SEED)
    kw = dict(adc=rx.adc, max_depth=cs.MESH_DEPTH, time_sampling='gate',
              rx_kind='wigner', n_lanes=cs.MESH_LANES, mesh=p.mesh.to(dev),
              patch_p=rk.patch_p_for(cs.MESH_LANES))
    return params, prim, txp, kw


def endpoint_call(rk, scenes, name: str, dev):
    """(params, prim, txp, keyword arguments) of receive_megakernel on an
    endpoint scene at chip_smoke.py's shapes, in the imported tree."""
    import torch
    fn, coh = EP_PATHS[name]
    P = scenes.PHASED
    arg = {'phased_tx_scene': (scenes.steer_toward(
        P['tx'], scenes.phased_tx_target()),),
        'phased_rx_scene': (P['rx_az'],)}.get(fn, ())
    s, rx = getattr(scenes, fn)(*arg)
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    rx_kind = rk.rx_kind_of(rx)
    params, prim, txp, php, rxph = (torch.tensor(a, device=dev) for a in (
        p.params, p.prim, p.txp, p.php, p.rxph))
    kw = dict(adc=rx.adc, max_depth=EP_DEPTH, time_sampling='gate',
              rx_kind=rx_kind, n_lanes=EP_LANES, doppler=coh, coherent=coh,
              php=php, rxph=rxph if rx_kind == 'phased' else None)
    return params, prim, txp, kw


def k4_child(cs, only: tuple) -> dict:
    """K4's kernels of the imported tree at chip_smoke.K4_SHAPES."""
    import torch
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    out = dict(k4_ptxas=[ln.strip() for ln in ik.build_library().log
                         .splitlines() if 'registers' in ln])
    dev = torch.device('cuda')
    for shape in cs.K4_SHAPES:
        o, d, v0, e1, e2, maxt = cs.k4_inputs(torch, dev, shape)
        calls = {'k4_closest': lambda: ik.ray_triangle_closest(o, d, v0, e1,
                                                               e2),
                 'k4_any': lambda: ik.ray_triangle_any(o, d, v0, e1, e2,
                                                       maxt)}
        for name in only:
            if name in calls:
                calls[name]()    # warm-up
                out[f'{name}_{shape}_ms'] = cs.queued_ms(torch, calls[name])
    return out


def bvh_child(cs, only: tuple) -> dict:
    """K2 / K3 of the imported tree on chip_smoke.py's query rays at 2^20
    and at the wavefront pass's 2^17 (device time: twenty calls queued
    behind a sleeping kernel, five times), a call with its wrapper (events
    around each), the wrapper's host time a call and a hash of the
    results' bits; and the BVH wavefront's receive on mesh_scene (2^20
    samples, depth 2: three calls' wall time after a warm-up)."""
    import torch
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    out = dict(bvh_ptxas=[ln.strip() for ln in bk.build_library().log
                          .splitlines() if 'registers' in ln])
    dev = torch.device('cuda')
    pb, o, d, maxt, _ = cs.bvh_query_inputs(torch, dev)
    for shape, step in (('2_20', 1), ('2_17', cs.N_RAYS // cs.WF_PASS_RAYS)):
        oo, dd, mm = (x[::step].contiguous() for x in (o, d, maxt))
        calls = {'bvh_closest': lambda: bk.bvh_closest(pb, oo, dd),
                 'bvh_any': lambda: bk.bvh_any(pb, oo, dd, mm)}
        for name in only:
            if name not in calls:
                continue
            res = calls[name]()
            res = res if isinstance(res, tuple) else (res,)
            out[f'{name}_{shape}_sha'] = hashlib.sha1(b''.join(
                x.cpu().numpy().tobytes() for x in res)).hexdigest()[:16]
            out[f'{name}_{shape}_ms'] = cs.queued_ms(torch, calls[name])
            ev, _ = cs.cuda_ms(lambda i: calls[name](), CALLS + 1)
            out[f'{name}_{shape}_call_ms'] = ev[1:]
            out[f'{name}_{shape}_host_ms'] = [
                cs.host_us(torch, calls[name], reps=1) * 1e-3
                for _ in range(CALLS)]
    if 'bvh_wavefront' in only:
        import beifong_tpu_torch as bt
        from beifong_tpu_torch.scenes import mesh_scene
        s, rx = mesh_scene()
        sd = s.compile(device=dev)

        def call():
            return bt.receive(s, sd, rx, seed=5, spp=cs.BVH_WF_SAMPLES,
                              max_depth=2, time_sampling='gate',
                              use_kernel=False, device=dev)
        call()
        out['bvh_wavefront_wall_ms'] = [cs.wall_ms(call)[0]
                                        for _ in range(3)]
    return out


def child(root: str, only: tuple = NAMES) -> dict:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a card')
    import beifong_tpu_torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    from beifong_tpu_torch.scenes import (flagship_scene, mesh_scene,
                                          multi_body_scene,
                                          pulse_train_scene,
                                          range_doppler_scene)
    from beifong_tpu_torch import scenes
    assert os.path.dirname(beifong_tpu_torch.__file__).startswith(root)
    sys.path.insert(0, HERE)
    import chip_smoke  # noqa: E402  (cuda_ms, the main paths' sizes, SEED)

    dev = torch.device('cuda')
    out = dict(tree=root)
    cs = chip_smoke   # the main paths' sizes
    if set(only) & set(K4_NAMES):
        out.update(k4_child(cs, only))
    if set(only) & set(BVH_NAMES):
        out.update(bvh_child(cs, only))
    if set(only) <= set(K4_NAMES + BVH_NAMES):
        return out
    out['ptxas'] = [ln.strip() for ln in rk.build_library().log.splitlines()
                    if 'registers' in ln]
    paths = {'dechirp': (scenes.fmcw_dechirp_scene, cs.COH_LANES,
                         cs.COH_DEPTH, 'gate'),
             'mixer': (lambda: scenes.fmcw_scene('mixer'), cs.COH_LANES,
                       cs.COH_DEPTH, 'gate')}
    cpis = {'corner_cpi': (scenes.corner_scene, scenes.CORNER['prf'],
                           cs.CPI_CONFIGS['corner']),
            'micro_cpi': (scenes.micro_doppler_scene,
                          scenes.MICRO_DOPPLER['prf'],
                          cs.CPI_CONFIGS['micro_doppler'])}
    for name in only:
        if name not in paths and name not in cpis:
            continue
        if name in paths:
            scene, n_lanes, depth, ts = paths[name]
            s, rx = scene()
            p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                              s.shape_index_of_endpoint('receiver', rx.id))
            fn, lead = rk.receive_megakernel, {}
        else:
            scene, prf, c = cpis[name]
            s, _ = scene()
            p, rx, _ = rk.pack_cpi(s, CPI_PULSES, prf)
            n_lanes, depth, ts = c['spp'], c['max_depth'], c['time_sampling']
            fn, lead = rk.receive_megakernel_cpi, {'seed_step': 7919}
        params, prim, txp = (torch.tensor(a, device=dev)
                             for a in (p.params, p.prim, p.txp))
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
                  rx_kind='wigner', n_lanes=n_lanes, seed=cs.SEED,
                  doppler=True, coherent=True, receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
                  **lead)
        ms, _ = cs.cuda_ms(lambda i: fn(params, prim, txp, **kw), CALLS + 1)
        out[f'{name}_ms'] = ms[1:]
    for name in only:
        if name not in LOBE_PATHS and name != 'window_cpi':
            continue
        fn_name, arg, depth, coh = LOBE_PATHS.get(
            name, ('window_corner_scene', 'thin', 6, True))
        s, rx = getattr(scenes, fn_name)(arg)
        if name == 'window_cpi':
            p, rx, _ = rk.pack_cpi(s, WINDOW_CPI_PULSES, 10.0)
            fn, lead = rk.receive_megakernel_cpi, {'seed_step': 7919}
            n_lanes = cs.LOBE_CPI_SAMPLES
        else:
            p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                              s.shape_index_of_endpoint('receiver', rx.id))
            fn, lead, n_lanes = rk.receive_megakernel, {}, cs.LOBE_LANES
        params, prim, txp = (torch.tensor(a, device=dev)
                             for a in (p.params, p.prim, p.txp))
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind=rk.rx_kind_of(rx), n_lanes=n_lanes, seed=cs.SEED,
                  doppler=True, coherent=coh, receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
                  lobes=p.lobes, **lead)
        ms, _ = cs.cuda_ms(lambda i: fn(params, prim, txp, **kw), CALLS + 1)
        out[f'{name}_ms'] = ms[1:]
    for name in only:
        if name not in EP_PATHS and name not in DPW_PATHS \
                and name not in MDK_PATHS and name != 'mimo':
            continue
        if name == 'mimo':
            params, prim, txp, kw = mimo_call(rk, scenes, dev)
        else:
            params, prim, txp, kw = (
                endpoint_call if name in EP_PATHS else mesh_doppler_call
                if name in MDK_PATHS else doppler_power_call)(rk, scenes,
                                                              name, dev)
        ms, _ = cs.cuda_ms(lambda i: rk.receive_megakernel(
            params, prim, txp, seed=cs.SEED, **kw), CALLS + 1)
        out[f'{name}_ms'] = ms[1:]
        # the result's bits (a repeat, and a tree that differs only in how
        # it sums, give the same hash where the sums are in a fixed order)
        acc, n_ev = rk.receive_megakernel(params, prim, txp, seed=cs.SEED,
                                          **kw)
        out[f'{name}_sha'] = hashlib.sha1(
            acc.cpu().numpy().tobytes()
            + n_ev.cpu().numpy().tobytes()).hexdigest()[:16]
    for name, scene, n_lanes, depth, doppler, coherent in timed_configs(
            chip_smoke, flagship_scene, mesh_scene, multi_body_scene,
            range_doppler_scene, pulse_train_scene):
        if name not in only:
            continue
        s, rx = scene()
        sd = s.compile(use_bvh=False, device='cpu')
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                             rx.id))
        params, prim, txp = (torch.tensor(a, device=dev)
                             for a in (p.params, p.prim, p.txp))
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind='wigner', n_lanes=n_lanes, seed=chip_smoke.SEED)
        if doppler:
            kw['doppler'] = True
            kw['coherent'] = coherent
            if 'mirror' in inspect.signature(
                    rk.receive_megakernel).parameters:
                kw['mirror'] = False   # these scenes hold no mirror
        if 'textured' in inspect.signature(rk.receive_megakernel).parameters:
            kw['textured'] = False     # nor a texture, as receive() says
        if p.mesh is not None:
            params[0] = rk.seed_slot(chip_smoke.SEED)
            kw.update(mesh=p.mesh.to(dev), patch_p=rk.patch_p_for(n_lanes))
            if doppler:
                kw['msh'] = torch.tensor(p.msh, device=dev)
        ms, _ = chip_smoke.cuda_ms(
            lambda i: rk.receive_megakernel(params, prim, txp, **kw),
            CALLS + 1)
        out[f'{name}_ms'] = ms[1:]
        if name in ('range_doppler', 'multi_body', 'coherent_mesh', 'mesh'):
            acc, n_ev = rk.receive_megakernel(params, prim, txp, **kw)
            out[f'{name}_sha'] = hashlib.sha1(
                acc.cpu().numpy().tobytes()
                + n_ev.cpu().numpy().tobytes()).hexdigest()[:16]
        # the wrapper's host time a call, the card idle before each
        host = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            rk.receive_megakernel(params, prim, txp, **kw)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        out[f'{name}_host_ms'] = host
        if doppler:
            msh = kw.get('msh')
            look = []
            for _ in range(LOOKUPS):
                t0 = time.perf_counter()
                rk._lobe_flag(None, prim, msh, True)
                rk._table_tx_kinds(txp, 1)
                look.append((time.perf_counter() - t0) * 1e3)
            out[f'{name}_lookup_ms'] = look
    return out


def library(root: str) -> str:
    """The receive kernel's (K1), the BVH kernels' (K2, K3) and the
    ray / triangle kernels' (K4) libraries built from the tree at `root`,
    their paths joined by commas."""
    sys.path.insert(0, root)
    from beifong_tpu_torch.geometry import bvh_kernel as bk
    from beifong_tpu_torch.geometry import intersect_kernel as ik
    from beifong_tpu_torch.integrators import receive_kernel as rk
    return ','.join(m.build_library().path for m in (rk, bk, ik))


def sass_of(paths: str) -> dict:
    """{kernel: [instructions]} of the libraries' kernels (K1's, K2 / K3's,
    K4's; `paths` joined by commas), without addresses or encodings, keyed
    by name and template flags (the mangled name carries a hash of the
    source's path)."""
    cuda = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    out = '\n'.join(subprocess.run(
        [os.path.join(cuda, 'bin', 'cuobjdump'), '-sass', path],
        capture_output=True, text=True, check=True).stdout
        for path in paths.split(','))
    funcs, key = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : \S*?(receive_[a-z_]+_kernel|bvh_[a-z]+'
                      r'_kernel|ray_triangle_kernel)'
                      r'(I((?:Lb[01]E)+)E)?', line)
        if m:
            flags = re.findall(r'Lb([01])E', m.group(3) or '')
            key = f'{m.group(1)}<{",".join(flags)}>'
            funcs[key] = []
            continue
        if 'Function :' in line:
            key = None
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;', line)
        if m and key is not None:
            funcs[key].append(m.group(1))
    return funcs


def sass_compare(other: str, this: str = HERE) -> dict:
    paths = {}
    for which, root in (('other', other), ('this', this)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--lib', root], capture_output=True,
                             text=True, cwd=HERE, timeout=900, check=True)
        paths[which] = [ln for ln in res.stdout.splitlines()
                        if ln.startswith('LIB ')][-1][4:]
    a, b = sass_of(paths['other']), sass_of(paths['this'])
    # a kernel that gained trailing template flags (the media twins' MED,
    # the endpoint twins' EP, the lobe twins' LOB, the texture and prims
    # twins' TEX and PRIM) keeps its old key where the flags are false
    def old_key(k):
        while k not in a and k.endswith('0>'):
            k = k[:-3] + '>' if k.endswith(',0>') else k[:-2] + '>'
        return k
    b = {(old_key(k) if old_key(k) in a else k): v for k, v in b.items()}
    out = {}
    for name in sorted(set(a) & set(b)):
        diff = [(x, y) for x, y in zip(a[name], b[name]) if x != y]
        out[name] = dict(other=len(a[name]), this=len(b[name]),
                         differ=len(diff) + abs(len(a[name]) - len(b[name])),
                         first=diff[:5])
    out['only_this'] = sorted(set(b) - set(a))
    out['only_other'] = sorted(set(a) - set(b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', help='root of the other checkout')
    ap.add_argument('--this', default=HERE,
                    help='root of the checkout timed as this (default: '
                    'the one the script lies in)')
    ap.add_argument('--only', default=','.join(NAMES),
                    help='comma-separated configurations to time')
    ap.add_argument('--pairs', type=int, default=3)
    ap.add_argument('--sass', action='store_true',
                    help="compare K1's machine code instead of timing")
    ap.add_argument('--child', help='(internal) time the tree at this root')
    ap.add_argument('--lib', help="(internal) build the tree's K1 library")
    args = ap.parse_args()
    only = tuple(args.only.split(','))
    if not set(only) <= set(NAMES):
        ap.error(f'--only: configurations among {NAMES}')
    if args.child:
        print('RESULT ' + json.dumps(child(os.path.abspath(args.child),
                                           only)))
        return 0
    if args.lib:
        print('LIB ' + library(os.path.abspath(args.lib)))
        return 0
    if not args.other:
        ap.error('--other DIR is required')
    if args.sass:
        for name, d in sass_compare(os.path.abspath(args.other),
                                     os.path.abspath(args.this)).items():
            print(f'SASS {name}: {json.dumps(d)}')
        return 0
    sys.path.insert(0, HERE)
    import chip_smoke
    card = chip_smoke.card_line()
    print(card)
    trees = {'other': os.path.abspath(args.other),
             'this': os.path.abspath(args.this)}
    runs = {'other': [], 'this': []}
    for i in range(args.pairs):
        order = ('other', 'this') if i % 2 == 0 else ('this', 'other')
        for which in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--child',
                 trees[which], '--only', ','.join(only)],
                capture_output=True, text=True, cwd=HERE,
                timeout=600)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith('RESULT ')][-1]
            r = json.loads(line[len('RESULT '):])
            r.update(pair=i, which=which)
            print(json.dumps(r), flush=True)
            runs[which].append(r)

    summary = {'card': card, 'pairs': args.pairs}
    # one timed number a configuration (K4: a configuration and shape)
    metrics = [k[:-3] for k in runs['this'][0] if k.endswith('_ms')
               and not k.endswith(('_host_ms', '_lookup_ms', '_call_ms'))]
    for name in metrics:
        meds = {w: [statistics.median(r[f'{name}_ms']) for r in rs]
                for w, rs in runs.items()}
        for w, m in meds.items():
            summary[f'{name}_{w}_ms'] = statistics.median(m)
            summary[f'{name}_{w}_spread_ms'] = max(m) - min(m)
        summary[f'{name}_this_over_other'] = (summary[f'{name}_this_ms']
                                              / summary[f'{name}_other_ms'])
        summary[f'{name}_pairs_won_by_this'] = sum(
            b < a for a, b in zip(meds['other'], meds['this']))
        if f'{name}_sha' in runs['this'][0]:
            shas = {w: {r[f'{name}_sha'] for r in rs}
                    for w, rs in runs.items()}
            summary[f'{name}_repeats_equal'] = {w: len(v) == 1
                                                for w, v in shas.items()}
            summary[f'{name}_trees_bit_equal'] = shas['this'] == shas['other']
        for w, rs in runs.items():
            for k in ('host', 'lookup', 'call'):
                if f'{name}_{k}_ms' in rs[0]:
                    summary[f'{name}_{w}_{k}_ms'] = statistics.median(
                        statistics.median(r[f'{name}_{k}_ms']) for r in rs)
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
