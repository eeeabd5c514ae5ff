#!/usr/bin/env python3
"""The receive megakernel (K1) of two checkouts on the CPU, in a g++
emulation of the CUDA runtime, held lane by lane against each other:
the check of a redesign's arithmetic before its first chip call.

Run from the repository root (g++ with C++20; no card, no nvcc):

    python3 tools/k1_emulate.py --other DIR [--this DIR2] [--lanes 4096]
                                [--cases window_thin,...] [--grids]

Each tree's `csrc/receive_megakernel.cu` is compiled by g++ against the
stub `tools/emu/cuda_runtime.h`, which runs each block as blockDim.x
std::threads (a barrier a block for __syncthreads, one a warp for
__syncwarp and the warp votes, real atomics), with -ffp-contract=off;
the `<<<...>>>` launches, `extern __shared__` arrays and the pulse's asm
read are rewritten for it.  The library is called through
`receive_kernel._launch` with CPU tensors (two SMs of one block each).
For each lobe scene (CASES; rough_plastic_mixer under a mixer with an
LO, `scenes.mixer_receiver`), power and I / Q, on injected uniforms and
on Philox, it prints whether every lane's sum (`lane_out`) is equal bit
for bit, the event counts and the largest grid difference over max|acc|
(the grids sum in another order); `--grids` runs the thin windowed
corner on a 2-D grid (n_freq 8, the block's grid), a global one (n_freq
300) and a 4-pulse CPI instead.  The endpoint scenes (EP_CASES: the
phased transmitter, the analog phased receiver and four transmitters in
power, the three in I / Q, the phased transmitter's 4-pulse CPI, and the
phased transmitter on a 2-D grid and a global one in I / Q, and under a
mixer with an LO in I / Q, and in I / Q with its target a moving GGX
rough conductor) run the endpoint
twins: `--cases ep_phased_tx,...` (depth 2, gate); the power twin
writes no lane sums, so its grids are compared bit for bit.  The
Doppler power scenes (DOP_CASES: the range-Doppler pulse's 8 x 128 grid,
golden config 2's mix_resample 16 x 256, the FMCW mixer (an LO and a
beat drawn a lane), the flagship on 1,024 bins, the range-Doppler pulse
on a global grid and with a GGX plate, a pulse of config 3 on warp rows,
and the corner's 4-pulse CPI of mirror chains) run the analytic Doppler
power configuration: `--cases dop_range_doppler,...`.  The mesh
scenes (MESH_CASES: multi_body in power with the main path's direction
strata and without, its 4-pulse CPI, multi_body in I / Q (its 16 x 32
grid in the block's floats), the rough-plastic mesh in I / Q and in
power, the diffuse mesh in I / Q with strata and without, its 4-pulse
CPI, and the diffuse mesh in I / Q and the rough-plastic one in power on
a global grid of 64 x 300 cells) run the mesh Doppler kernel's four configurations (the Doppler mesh
in power, the coherent mesh, the power mesh lobe twin and the mesh lobe
twin in I / Q): `--cases mesh_multi_body,...`.  The mesh scene in power
(MESH_POWER_CASES: the diffuse mesh with the main path's direction strata
and without, and its 4-pulse CPI) runs the mesh kernel (mesh_power_mdk:
this tree's mesh Doppler kernel on the Doppler mesh's tables, the
ablation msk_mdk's route), and golden config
6 (MIMO_CASES: in gate sampling at depth 2, in fixed sampling at depth 3,
and on 1,024 bins, the global grid) the MIMO array kernel: `--cases
mesh_power,...,mimo_config6,...`.  The prims twins (PRIM_CASES: the
flagship scene with a sphere, disk or cylinder target, power at depth 3
or I / Q at depth 2) run this tree's twin against the plain version (I /
Q lane by lane within 1e-4 of each lane and 1e-6 of the largest), and
the twin on the all-rectangle scene against the other tree's rectangle
kernel, bit for bit: `--cases prim_sphere,prim_sphere_iq,...`.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import os
import re
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(HERE, 'tools', 'emu')


def emulate(tree: str, out: str, opt: str = '-O2') -> str:
    """A shared library of the tree's K1 source built by g++ with the
    stub runtime (`opt`: g++'s optimisation level; -O1 builds in half
    the time and runs the same arithmetic)."""
    csrc = os.path.join(tree, 'beifong_tpu_torch', 'csrc')
    with open(os.path.join(csrc, 'receive_megakernel.cu')) as f:
        cu = f.read()
    cu = cu.replace('asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(p));',
                    'p = blockIdx.y;')
    cu = re.sub(r'extern __shared__ (\w+) (\w+)\[\];',
                r'\1* \2 = reinterpret_cast<\1*>(emu::cur_smem());', cu)
    cu = re.sub(r'(receive_mimo_kernel<MED, EP>)\s*<<<([^>]*)>>>\(',
                r'emu::launch(\1, \2, ', cu)
    cu = re.sub(r'(\bkernel|receive_reduce_kernel)<<<([^>]*)>>>\(',
                r'emu::launch(\1, \2, ', cu)
    if '<<<' in cu:
        raise SystemExit(f'{tree}: a launch the emulation does not rewrite')
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + '.cpp', 'w') as f:
        f.write(cu)
    subprocess.run(['g++', '-std=c++20', opt, '-pthread', '-shared',
                    '-fPIC', '-ffp-contract=off', '-w', '-I', STUB, '-I',
                    csrc, '-o', out, out + '.cpp'], check=True)
    return out


def _library(path: str):
    sys.path.insert(0, HERE)
    from beifong_tpu_torch import _nvcc
    from beifong_tpu_torch.integrators import receive_kernel as rk

    class Emulated(_nvcc.Library):
        def get(self):
            if self._lib is None:
                lib = ctypes.CDLL(path)
                lib.rk_error_string.argtypes = [ctypes.c_int]
                lib.rk_error_string.restype = ctypes.c_char_p
                try:
                    rk._bind(lib)
                except AttributeError:   # a tree without the launch record
                    pass
                try:
                    lib.rk_prim_kernel
                except AttributeError:
                    # a tree before the prims twins: rk_geometry and
                    # rk_launch without their `prims` flag (never set for
                    # such a tree)
                    geo0, run0 = lib.rk_geometry, lib.rk_launch
                    geo0.argtypes = geo0.argtypes[:18] + geo0.argtypes[19:]
                    run0.argtypes = run0.argtypes[:-2] + run0.argtypes[-1:]
                    lib.rk_geometry = lambda *a: geo0(*(a[:18] + a[19:]))
                    lib.rk_launch = lambda *a: run0(*(a[:-2] + a[-1:]))
                try:
                    lib.rk_endpoint_kernel
                except AttributeError:
                    # a tree before the endpoint kernels: rk_geometry
                    # without the index's three sizes
                    geo = lib.rk_geometry
                    geo.argtypes = geo.argtypes[:14] + geo.argtypes[17:]
                    lib.rk_geometry = \
                        lambda *a: geo(*(a[:14] + a[17:]))
                self._lib = lib
            return self._lib
    return Emulated('receive_megakernel', 'rk', rk._bind)


# each lobe scene: (scenes' function, its argument, depth)
CASES = {'window_thin': ('window_corner_scene', 'thin', 6),
         'window_dielectric': ('window_corner_scene', 'dielectric', 6),
         'plastic': ('plastic_scene', 'plastic', 2),
         'rough_plastic': ('plastic_scene', 'rough_plastic', 2),
         'rough_dielectric': ('rough_dielectric_scene', 'target', 2),
         'through': ('rough_dielectric_scene', 'through', 2),
         'blend': ('composite_scene', 'blend', 2),
         'mask': ('composite_scene', 'mask', 2),
         # under a mixer with the transmitter's waveform as its LO
         'rough_plastic_mixer': ('plastic_scene', 'rough_plastic', 2)}


# the endpoint scenes: (scenes' function, coherent, pulses, n_freq)
EP_CASES = {'ep_phased_tx': ('phased_tx_scene', False, 1, 1),
            'ep_phased_rx': ('phased_rx_scene', False, 1, 1),
            'ep_four_tx': ('four_tx_scene', False, 1, 1),
            'ep_phased_tx_coh': ('phased_tx_scene', True, 1, 1),
            'ep_phased_rx_coh': ('phased_rx_scene', True, 1, 1),
            'ep_four_tx_coh': ('four_tx_scene', True, 1, 1),
            'ep_phased_tx_cpi': ('phased_tx_scene', True, 4, 1),
            'ep_phased_tx_2d': ('phased_tx_scene', True, 1, 8),
            'ep_phased_tx_global': ('phased_tx_scene', True, 1, 300),
            # a mixer with the transmitter's waveform as its LO
            'ep_phased_tx_mixer': ('phased_tx_scene', True, 1, 1),
            # the target a GGX rough conductor closing at 5 m/s
            'ep_phased_tx_ggx': ('phased_tx_scene', True, 1, 1)}


# the analytic Doppler power scenes: (scenes' function and arguments, the
# ADC's changes, depth, time sampling, pulses)
DOP_CASES = {'dop_range_doppler': ('range_doppler_scene', (0,), {}, 2,
                                   'gate', 1),
             'dop_fmcw_sonar': ('fmcw_sonar_scene', (), {}, 2, 'fixed', 1),
             'dop_mixer': ('fmcw_scene', ('mixer',), {}, 2, 'fixed', 1),
             'dop_wide': ('flagship_scene', (), {'n_time': 1024}, 3, 'gate',
                          1),
             'dop_global': ('range_doppler_scene', (0,),
                            {'n_time': 256, 'n_freq': 128}, 2, 'gate', 1),
             'dop_ggx': ('range_doppler_scene', ('ggx',), {}, 2, 'gate', 1),
             'dop_rows': ('pulse_train_scene', (0,), {}, 1, 'gate', 1),
             'dop_corner_cpi': ('corner_scene', (), {}, 4, 'fixed', 4)}


# the mesh Doppler kernel's scenes: (scenes' function and its keywords,
# coherent, depth, time sampling, pulses, direction strata P): multi_body
# (its GGX body moving) in power with the main path's strata and without,
# its 4-pulse CPI, and in I / Q (the 2-D coherent grid); the rough-plastic
# mesh in I / Q and in power, and the diffuse mesh in I / Q (the coherent
# mesh) with strata and without and its 4-pulse CPI (23 x 23 vertices:
# 968 triangles, the main path's surface at a tenth of its faces)
ROUGH = dict(n_side=23, material='rough_plastic')
MESH_CASES = {'mesh_multi_body': ('multi_body_scene', {}, False, 2, 'gate',
                                  1, 32),
              'mesh_multi_body_p0': ('multi_body_scene', {}, False, 2,
                                     'gate', 1, 0),
              'mesh_multi_body_cpi': ('multi_body_scene', {}, False, 2,
                                      'gate', 4, 16),
              'mesh_multi_body_iq': ('multi_body_scene', {}, True, 2,
                                     'gate', 1, 32),
              'mesh_rough_plastic_iq': ('mesh_scene', ROUGH, True, 2, 'gate',
                                        1, 32),
              'mesh_rough_plastic_power': ('mesh_scene', ROUGH, False, 2,
                                           'gate', 1, 32),
              'mesh_coherent': ('mesh_scene', dict(n_side=23), True, 2,
                                'gate', 1, 32),
              'mesh_coherent_p0': ('mesh_scene', dict(n_side=23), True, 2,
                                   'gate', 1, 0),
              'mesh_coherent_cpi': ('mesh_scene', dict(n_side=23), True, 2,
                                    'gate', 4, 16),
              'mesh_coherent_global': ('mesh_scene', dict(n_side=23), True,
                                       2, 'gate', 1, 32),
              'mesh_rough_plastic_global': ('mesh_scene', ROUGH, False, 2,
                                            'gate', 1, 32)}
# the ADC changes of a mesh case: 300 frequency bins put the coherent
# mesh's and the power mesh lobe twin's grids past the block's shared
# memory, into the global float64 grid (mode 2)
MESH_ADC = {'mesh_coherent_global': dict(n_freq=300),
            'mesh_rough_plastic_global': dict(n_freq=300)}


# the mesh kernel's scenes (the mesh configuration in power, mode 0): the
# diffuse mesh_scene at 23 x 23 vertices (968 triangles) with the main
# path's direction strata P 32 and without (P 0), its 4-pulse CPI (P 16),
# and on the omni receiver: (scenes' keywords, pulses, direction strata P)
MESH_POWER_CASES = {'mesh_power': (dict(n_side=23), 1, 32),
                    'mesh_power_p0': (dict(n_side=23), 1, 0),
                    'mesh_power_cpi': (dict(n_side=23), 4, 16),
                    'mesh_power_mdk': (dict(n_side=23), 1, 32)}
# the cases whose `this` side runs the mesh Doppler kernel's route (the
# ablation tools/k1_ablate.py msk_mdk: the Doppler mesh's tables, one
# static diffuse mesh-shape row, the block's grid)
MDK_ROUTE = ('mesh_power_mdk',)


def mesh_power_tables(name: str, device='cpu'):
    """(params, prim, txp, mesh, keyword arguments of
    receive_megakernel(_cpi) less the lanes, pulses) of a mesh case in
    power: the main path's tables (no mesh-shape rows in mode 0)."""
    import torch
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    kw_s, n_p, patch_p = MESH_POWER_CASES[name]
    s, rx = S.mesh_scene(**kw_s)
    if n_p > 1:
        p, rx, _ = rk.pack_cpi(s, n_p, 10.0)
    else:
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    if n_p == 1:
        # under strata, a seed slot whose first tiles' beams meet the target
        params[0] = rk.seed_slot(32 if patch_p else 3)
    kw = dict(adc=rx.adc, max_depth=2, time_sampling='gate',
              rx_kind=rk.rx_kind_of(rx), doppler=False, coherent=False,
              receive_type=rx.receive_type, has_lo=False, mirror=False,
              patch_p=patch_p)
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), p.mesh.to(device), kw, n_p)


def compare_mesh_power(libs, name: str, n: int, gen) -> dict:
    """One mesh case in power in both trees on injected uniforms and on
    Philox: {'injected' / 'philox': (lanes equal, events equal, grids
    equal, largest grid difference over max|acc|)}."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    params, prim, txp, mesh, kw, n_p = mesh_power_tables(name)
    out = {}
    for mode in ('injected', 'philox'):
        nd = rk.n_draws(kw['max_depth'])
        shape = (n_p, nd, n) if n_p > 1 else (nd, n)
        u = torch.rand(shape, generator=gen) if mode == 'injected' else None
        res = []
        for which in ('other', 'this'):
            rk.LIBRARY = libs[which]
            lane = torch.zeros((n_p, n) if n_p > 1 else n)
            k, msh = launch_kw(kw), None
            if which == 'this' and name in MDK_ROUTE:
                k['doppler'] = True
                msh = torch.zeros(tuple(params.shape[:-1]) + (1, 8))
            acc, ev = rk._launch(
                params, prim, txp, msh, u, mesh, lane, n_pulses=n_p,
                n_lanes=n, seed=13, seed_step=7919 if n_p > 1 else 0, **k)
            res.append((acc, ev, lane))
        (a0, e0, l0), (a1, e1, l1) = res
        scale = float(a0.abs().max()) or 1.0
        out[mode] = (torch.equal(l0, l1), torch.equal(e0, e1),
                     torch.equal(a0, a1),
                     float((a0 - a1).abs().max()) / scale)
        print(f'{name} {mode}: events {e1.tolist()}, lanes with a '
              f'contribution {int((l1 != 0).sum())}', flush=True)
    return out


# the MIMO array kernel's scenes: golden config 6 (the block's grid),
# in fixed sampling at depth 3, and on 1,024 fast-time bins (1,024 x 16
# values: the global grid, mode 2), as tests/test_torch_gpu.py MIMO_SCENES:
# (the ADC's changes, time sampling, depth)
MIMO_CASES = {'mimo_config6': ({}, 'gate', 2),
              'mimo_config6_fixed_d3': ({}, 'fixed', 3),
              'mimo_global_grid': ({'n_time': 1024}, 'gate', 2)}


def mimo_tables(name: str, device='cpu'):
    """(params, prim, txp, keyword arguments of receive_megakernel less
    the lanes, the scene's band) of a MIMO case."""
    import torch
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    adc, ts, depth = MIMO_CASES[name]
    s, rx = S.mimo_beamform_scene()
    if adc:
        rx = dataclasses.replace(rx, adc=dataclasses.replace(rx.adc, **adc))
        s.receivers[0] = rx
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    params[0] = rk.seed_slot(3)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind='phased', doppler=True, coherent=False,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
              rxph=torch.tensor(p.rxph, device=device),
              eoff=rk.array_offsets(s, sd, rx, device))
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw, s.band)


def compare_mimo(libs, name: str, n: int, gen) -> dict:
    """One MIMO case in both trees on injected uniforms and on Philox:
    {'injected' / 'philox': (lanes equal, events equal, grids equal,
    largest grid difference over max|acc|)}."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    params, prim, txp, kw, _ = mimo_tables(name)
    out = {}
    for mode in ('injected', 'philox'):
        nd = rk.n_draws(kw['max_depth'])
        u = torch.rand((nd, n), generator=gen) if mode == 'injected' \
            else None
        res = []
        for which in ('other', 'this'):
            rk.LIBRARY = libs[which]
            lane = torch.zeros(n)
            acc, ev = rk._launch(params, prim, txp, None, u, None, lane,
                                 n_pulses=1, n_lanes=n, seed=13,
                                 seed_step=0, patch_p=0, **launch_kw(kw))
            res.append((acc, ev, lane))
        (a0, e0, l0), (a1, e1, l1) = res
        scale = float(a0.abs().max()) or 1.0
        out[mode] = (torch.equal(l0, l1), torch.equal(e0, e1),
                     torch.equal(a0, a1),
                     float((a0 - a1).abs().max()) / scale)
        print(f'{name} {mode}: events {e1.tolist()}, lanes with a '
              f'contribution {int((l1 != 0).sum())}', flush=True)
    return out


def mesh_tables(name: str, device='cpu'):
    """(params, prim, txp, msh, mesh, keyword arguments of
    receive_megakernel(_cpi) less the lanes, pulses, the scene's band) of
    a mesh case."""
    import torch
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    fn, kw_s, coh, depth, ts, n_p, patch_p = MESH_CASES[name]
    s, rx = getattr(S, fn)(**kw_s)
    if name in MESH_ADC:
        rx = dataclasses.replace(
            rx, adc=dataclasses.replace(rx.adc, **MESH_ADC[name]))
        s.receivers[0] = rx
    if n_p > 1:
        p, rx, _ = rk.pack_cpi(s, n_p, 10.0)
    else:
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    if n_p == 1:
        # under strata, a seed slot whose first tiles' beams meet the
        # targets (seed 3's miss them at a few thousand lanes)
        params[0] = rk.seed_slot(32 if patch_p else 3)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind=rk.rx_kind_of(rx), doppler=True, coherent=coh,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
              lobes=int(p.lobes), patch_p=patch_p)
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device),
            torch.tensor(p.msh, device=device), p.mesh.to(device), kw, n_p,
            s.band)


def compare_mesh(libs, name: str, n: int, gen) -> dict:
    """One mesh case in both trees on injected uniforms and on Philox:
    {'injected' / 'philox': (lanes equal, events equal, grids equal,
    largest grid difference over max|acc|)}."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    params, prim, txp, msh, mesh, kw, n_p, _ = mesh_tables(name)
    out = {}
    for mode in ('injected', 'philox'):
        nd = rk.n_draws(kw['max_depth'], 1, **rk.lobe_draws(kw['lobes']))
        shape = (n_p, nd, n) if n_p > 1 else (nd, n)
        u = torch.rand(shape, generator=gen) if mode == 'injected' else None
        res = []
        for which in ('other', 'this'):
            rk.LIBRARY = libs[which]
            lane = torch.zeros((n_p, n) if n_p > 1 else n)
            acc, ev = rk._launch(
                params, prim, txp, msh, u, mesh, lane, n_pulses=n_p,
                n_lanes=n, seed=13, seed_step=7919 if n_p > 1 else 0,
                **launch_kw(kw))
            res.append((acc, ev, lane))
        (a0, e0, l0), (a1, e1, l1) = res
        scale = float(a0.abs().max()) or 1.0
        out[mode] = (torch.equal(l0, l1), torch.equal(e0, e1),
                     torch.equal(a0, a1),
                     float((a0 - a1).abs().max()) / scale)
        print(f'{name} {mode}: events {e1.tolist()}, lanes with a '
              f'contribution {int((l1 != 0).sum())}', flush=True)
    return out


def doppler_scene(name: str):
    """(scene, receiver) of a Doppler power case, its ADC changed; 'ggx'
    gives the range-Doppler pulse a rough conductor plate."""
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.bsdf.tables import rough_conductor
    fn, args, adc, *_ = DOP_CASES[name]
    ggx = args == ('ggx',)
    s, rx = getattr(S, fn)(*((0,) if ggx else args))
    if ggx:
        s.bsdfs[0] = rough_conductor('mat', specular_reflectance=1.0,
                                     alpha=0.3, eta=0.2, k=3.0,
                                     twosided=True)
    if adc:
        rx = dataclasses.replace(rx, adc=dataclasses.replace(rx.adc, **adc))
        s.receivers[0] = rx
    return s, rx


def doppler_tables(name: str, device='cpu'):
    """(params, prim, txp, keyword arguments of receive_megakernel(_cpi)
    less the lanes, pulses) of a Doppler power case."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    _, _, _, depth, ts, n_p = DOP_CASES[name]
    s, rx = doppler_scene(name)
    if n_p > 1:
        p, rx, _ = rk.pack_cpi(s, n_p, 10.0)
    else:
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
    params = torch.tensor(p.params, device=device)
    if n_p == 1:
        params[0] = rk.seed_slot(3)
    kw = dict(adc=rx.adc, max_depth=depth, time_sampling=ts,
              rx_kind=rk.rx_kind_of(rx), doppler=True, coherent=False,
              receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror))
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw, n_p)


def launch_kw(kw: dict) -> dict:
    """receive_megakernel's keywords of a case as `_launch` takes them."""
    from beifong_tpu_torch.integrators import receive_kernel as rk
    out = {k: v for k, v in kw.items() if k != 'receive_type'}
    out['rule'] = rk.rx_rule(kw['receive_type'], kw['has_lo'])
    return out


def compare_doppler(libs, name: str, n: int, gen) -> dict:
    """One Doppler power case in both trees on injected uniforms and on
    Philox: {'injected' / 'philox': (lanes equal, events equal, grids
    equal, largest grid difference over max|acc|)}."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    params, prim, txp, kw, n_p = doppler_tables(name)
    out = {}
    for mode in ('injected', 'philox'):
        nd = rk.n_draws(kw['max_depth'])
        shape = (n_p, nd, n) if n_p > 1 else (nd, n)
        u = torch.rand(shape, generator=gen) if mode == 'injected' else None
        res = []
        for which in ('other', 'this'):
            rk.LIBRARY = libs[which]
            lane = torch.zeros((n_p, n) if n_p > 1 else n)
            acc, ev = rk._launch(
                params, prim, txp, None, u, None, lane, n_pulses=n_p,
                n_lanes=n, seed=13, seed_step=7919 if n_p > 1 else 0,
                patch_p=0, **launch_kw(kw))
            res.append((acc, ev, lane))
        (a0, e0, l0), (a1, e1, l1) = res
        scale = float(a0.abs().max()) or 1.0
        out[mode] = (torch.equal(l0, l1), torch.equal(e0, e1),
                     torch.equal(a0, a1),
                     float((a0 - a1).abs().max()) / scale)
    return out


def endpoint_tables(name: str, device='cpu'):
    """(params, prim, txp, keyword arguments of receive_megakernel(_cpi)
    less the lanes, pulses, the scene's band) of an endpoint case."""
    import torch
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    fn, coh, n_p, n_freq = EP_CASES[name]
    P = S.PHASED
    arg = {'phased_tx_scene': S.steer_toward(P['tx'], S.phased_tx_target()),
           'phased_rx_scene': P['rx_az']}.get(fn)
    s, rx = getattr(S, fn)(*(() if arg is None else (arg,)),
                           **({'moving_ggx': True}
                              if name.endswith('_ggx') else {}))
    if name.endswith('_mixer'):
        s, rx = S.mixer_receiver(s, rx)
    if n_p > 1:
        p, rx, _ = rk.pack_cpi(s, n_p, 10.0)
    else:
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
    adc = dataclasses.replace(rx.adc, n_freq=n_freq)
    rx_kind = rk.rx_kind_of(rx)
    params = torch.tensor(p.params, device=device)
    if n_p == 1:
        params[0] = rk.seed_slot(3)
    kw = dict(adc=adc, max_depth=2, time_sampling='gate', rx_kind=rx_kind,
              doppler=coh, coherent=coh, receive_type=rx.receive_type,
              has_lo=rx.lo_waveform is not None, mirror=bool(p.mirror),
              php=None if p.php is None else torch.tensor(p.php,
                                                          device=device),
              rxph=torch.tensor(p.rxph, device=device)
              if rx_kind == 'phased' else None)
    return (params, torch.tensor(p.prim, device=device),
            torch.tensor(p.txp, device=device), kw, n_p, s.band)


def compare_endpoint(libs, name: str, n: int, gen) -> dict:
    """One endpoint case in both trees on injected uniforms and on Philox:
    {'injected' / 'philox': (lanes equal, events equal, grids equal,
    largest grid difference over max|acc|)}."""
    import torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    params, prim, txp, kw, n_p, _ = endpoint_tables(name)
    n_tx = int(txp.shape[-2])
    out = {}
    for mode in ('injected', 'philox'):
        shape = (n_p, rk.n_draws(2, n_tx), n) if n_p > 1 \
            else (rk.n_draws(2, n_tx), n)
        u = torch.rand(shape, generator=gen) if mode == 'injected' else None
        res = []
        for which in ('other', 'this'):
            rk.LIBRARY = libs[which]
            lane = torch.zeros((n_p, n) if n_p > 1 else n)
            acc, ev = rk._launch(
                params, prim, txp, None, u, None,
                lane if kw['doppler'] else None, n_pulses=n_p, n_lanes=n,
                seed=13, seed_step=7919 if n_p > 1 else 0, patch_p=0,
                ep=True, **launch_kw(kw))
            res.append((acc, ev, lane))
        (a0, e0, l0), (a1, e1, l1) = res
        scale = float(a0.abs().max()) or 1.0
        out[mode] = (torch.equal(l0, l1), torch.equal(e0, e1),
                     torch.equal(a0, a1),
                     float((a0 - a1).abs().max()) / scale)
    return out


# the prims twins' scenes: the flagship scene's target, and coherent
PRIM_CASES = {f'prim_{t}{"_iq" if c else ""}': (t, c)
              for t in ('sphere', 'disk', 'cylinder') for c in (False, True)}


def compare_prims(libs, name: str, n: int, gen) -> dict:
    """This tree's prims twin on the flagship scene with a sphere, disk
    or cylinder target against the plain version (power: the grid, events;
    I / Q: lane by lane, the grid), on injected uniforms and Philox; then
    the twin on the all-rectangle scene against the other tree's
    rectangle kernel, bit for bit.  {mode: (lanes equal (against the
    plain version: how many are off), events equal, grids equal, grid max
    diff / max|acc|)}."""
    import torch
    sys.path.insert(0, HERE)
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    target, coh = PRIM_CASES[name]
    depth = 2 if coh else 3
    out = {}

    def tables(tgt):
        s, rx = S.flagship_scene(target=tgt)
        tab = rk._device_tables(s, s.compile(device='cpu'), rx, 'cpu')
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind='wigner', doppler=coh, coherent=coh, mirror=False,
                  rule=0, has_lo=False)
        return tab, kw

    def launch(which, tab, kw, u, prims):
        rk.LIBRARY = libs[which]
        lane = torch.zeros(n) if coh else None
        acc, ev = rk._launch(tab.params, tab.prim, tab.txp, None, u, None,
                             lane, n_pulses=1, n_lanes=n, seed=13,
                             seed_step=0, patch_p=0, prims=prims, **kw)
        return acc, ev, lane

    tab, kw = tables(target)
    nd = rk.n_draws(depth)
    for u in (torch.rand((nd, n), generator=gen), None):
        acc, ev, lane = launch('this', tab, kw, u, True)
        uu = u if u is not None else rk.philox_uniforms(13, nd, n)
        lane_ref = torch.zeros(n) if coh else None
        ref, n_ref = rk.receive_megakernel_ref(
            tab.params, tab.prim, tab.txp, uu, lane_out=lane_ref,
            **{k: v for k, v in kw.items() if k != 'rule'})
        ref = ref.reshape(acc.shape)
        scale = float(ref.abs().max()) or 1.0
        # I / Q: the lanes beyond 1e-4 of themselves and 1e-6 of the
        # largest (a grazing root may take another path, as a mesh edge)
        off = None if lane is None else (lane - lane_ref).abs() > (
            1e-4 * lane_ref.abs() + 1e-6 * float(lane_ref.abs().max()))
        lanes = None if off is None else f'{int(off.sum())} of {n} off'
        out[f'{"injected" if u is not None else "philox"} vs plain'] = (
            lanes, int(ev[0]) == int(n_ref), bool(torch.equal(acc, ref)),
            float((acc - ref).abs().max()) / scale)
    tab, kw = tables('plate')
    (a0, e0, l0), (a1, e1, l1) = (launch('other', tab, kw, None, False),
                                  launch('this', tab, kw, None, True))
    out['plate: twin vs the other rectangle kernel'] = (
        l0 is None or bool(torch.equal(l0, l1)), bool(torch.equal(e0, e1)),
        bool(torch.equal(a0, a1)),
        float((a0 - a1).abs().max()) / (float(a0.abs().max()) or 1.0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--other', required=True)
    ap.add_argument('--this', default=HERE)
    ap.add_argument('--lanes', type=int, default=4096)
    ap.add_argument('--cases', default=','.join(CASES),
                    help=f'of {tuple(CASES) + tuple(EP_CASES)}'
                    f' + {tuple(DOP_CASES)} + {tuple(MESH_CASES)}'
                    f' + {tuple(MESH_POWER_CASES)} + {tuple(MIMO_CASES)}'
                    f' + {tuple(PRIM_CASES)}')
    ap.add_argument('--grids', action='store_true')
    args = ap.parse_args()
    import torch
    sys.path.insert(0, HERE)
    from beifong_tpu_torch import scenes as S
    from beifong_tpu_torch.integrators import receive_kernel as rk
    # the wrapper's CUDA calls, on CPU tensors
    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.current_stream = \
        lambda d=None: types.SimpleNamespace(cuda_stream=0)
    build = os.path.join(HERE, 'beifong_tpu_torch', '_build', 'k1_emulate')
    libs = {w: _library(emulate(os.path.abspath(t),
                                os.path.join(build, f'{w}.so')))
            for w, t in (('other', args.other), ('this', args.this))}
    n = args.lanes
    gen = torch.Generator().manual_seed(5)

    def tables(scene, arg, depth, coh, adc=None, mixer=False):
        s, rx = getattr(S, scene)(arg)
        if mixer:
            s, rx = S.mixer_receiver(s, rx)
        p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                          s.shape_index_of_endpoint('receiver', rx.id))
        params = torch.tensor(p.params)
        params[0] = rk.seed_slot(3)
        kw = dict(adc=adc or rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind=rk.rx_kind_of(rx), coherent=coh, mirror=p.mirror,
                  lobes=p.lobes,
                  rule=rk.rx_rule(rx.receive_type,
                                  rx.lo_waveform is not None),
                  has_lo=rx.lo_waveform is not None)
        return params, torch.tensor(p.prim), torch.tensor(p.txp), kw

    def run(which, params, prim, txp, kw, u, n_pulses=1, seed=13):
        rk.LIBRARY = libs[which]
        lane = torch.zeros((n_pulses, n) if n_pulses > 1 else n)
        acc, ev = rk._launch(
            params, prim, txp, None, u, None, lane, n_pulses=n_pulses,
            n_lanes=n, seed=seed, seed_step=7919 if n_pulses > 1 else 0,
            doppler=True, patch_p=0, **kw)
        return acc, ev, lane

    def compare(what, args_, u, **k):
        (a0, e0, l0), (a1, e1, l1) = (run(w, *args_, u, **k)
                                      for w in ('other', 'this'))
        scale = float(a0.abs().max()) or 1.0
        print(f'{what} {"injected" if u is not None else "philox"}: '
              f'lanes bit-equal {torch.equal(l0, l1)} '
              f'({int((l0 != l1).sum())} of {l0.numel()} differ), events '
              f'{e0.tolist()} / {e1.tolist()}, grid max diff '
              f'{float((a0 - a1).abs().max()) / scale:.3e} of max|acc|',
              flush=True)

    if args.grids:
        for n_freq in (8, 300):
            for coh in (False, True):
                p = tables('window_corner_scene', 'thin', 6, coh)
                p[3]['adc'] = dataclasses.replace(p[3]['adc'], n_freq=n_freq)
                nd = rk.n_draws(6, 1, **rk.lobe_draws(p[3]['lobes']))
                for u in (torch.rand((nd, n), generator=gen), None):
                    compare(f'window_thin n_freq {n_freq} '
                            f'{"iq" if coh else "power"}', p, u)
        s, _ = S.window_corner_scene('thin')
        pc, rx, _ = rk.pack_cpi(s, 4, 10.0)
        kw = dict(adc=rx.adc, max_depth=6, time_sampling='gate',
                  rx_kind=rk.rx_kind_of(rx), coherent=True,
                  mirror=bool(pc.mirror), lobes=pc.lobes,
                  rule=rk.rx_rule(rx.receive_type,
                                  rx.lo_waveform is not None),
                  has_lo=rx.lo_waveform is not None)
        p = tuple(torch.tensor(a) for a in (pc.params, pc.prim, pc.txp)) \
            + (kw,)
        nd = rk.n_draws(6, 1, **rk.lobe_draws(kw['lobes']))
        for u in (torch.rand((4, nd, n), generator=gen), None):
            compare('window_thin CPI 4 pulses', p, u, n_pulses=4, seed=3)
        return 0
    for name in args.cases.split(','):
        if name in EP_CASES or name in DOP_CASES or name in MESH_CASES \
                or name in MESH_POWER_CASES or name in MIMO_CASES \
                or name in PRIM_CASES:
            fn = compare_endpoint if name in EP_CASES else \
                compare_prims if name in PRIM_CASES else \
                compare_mesh if name in MESH_CASES else \
                compare_mesh_power if name in MESH_POWER_CASES else \
                compare_mimo if name in MIMO_CASES else compare_doppler
            for mode, (lanes, evs, grids, diff) in fn(
                    libs, name, n, gen).items():
                print(f'{name} {mode}: lanes bit-equal {lanes}, events '
                      f'equal {evs}, grids bit-equal {grids}, grid max diff '
                      f'{diff:.3e} of max|acc|', flush=True)
            continue
        scene, arg, depth = CASES[name]
        for coh in (False, True):
            p = tables(scene, arg, depth, coh, mixer=name.endswith('_mixer'))
            nd = rk.n_draws(depth, 1, **rk.lobe_draws(p[3]['lobes']))
            for u in (torch.rand((nd, n), generator=gen), None):
                compare(f'{name} {"iq" if coh else "power"}', p, u)
    return 0


if __name__ == '__main__':
    sys.exit(main())
