#!/usr/bin/env python3
"""What the flagship, coherent and lobe configurations of the receive
megakernel (K1) spend their issue slots on: the instruction mix of its
machine code by stage, the
thread-instructions a lane that the plain version's stage counts imply,
the issue-slot bound beside the FP32 bound, and the SIMT efficiency of a
warp's 32 lanes (arithmetic from the plain version, not a device reading).

Run from the repository root:

    python3 tools/k1_mix.py --simt [--lanes 16] [--config NAME]
        (CPU or card) the SIMT efficiency of the grid-stride loop (a warp
        traces 32 consecutive lanes, each to its end) and of a warp-uniform
        vertex loop that refills a thread whose path ended with its next
        lane, and of a pool of 64 paths a warp, from per-lane stage masks
        of the plain version at 2^lanes lanes, weighted by
        chip_smoke.FP32_OPS;

    python3 tools/k1_mix.py --sass DIR [--listing FILE] [--config NAME]
        (the card's machine: nvcc, nvdisasm, nvidia-smi) compiles DIR's
        csrc/receive_megakernel.cu to a cubin with -lineinfo (the library's
        flags otherwise), attributes each instruction of the flagship kernel
        to the stage of the lane its source line lies in (the tags
        "[k1 stage: NAME]" in the source, or the parent's section
        comments), counts them by class, weights each stage by its
        executions a lane (the same plain-version masks; Philox by the
        blocks a lane draws), and prints thread-instructions a lane and the
        issue-slot bound at the main path's lanes: 132 SMs x 4 schedulers x one warp
        instruction a cycle at the card's maximum SM clock, for the fewest
        thread-instructions a lane measured for the lane stages alone
        (`bound_instructions`: the loops' and turns' bookkeeping left out,
        so a kernel that issues more does not raise its own bound).  The
        full disassembly of the kernel goes to
        chiprun_out/k1_sass_<tree>_<config>.txt.

NAME is one of CONFIGS: the flagship (its scene, depth 3, 2^28 lanes:
the grid-stride receive_trace_kernel<false> or receive_flagship_kernel
that replaced it), the coherent configuration's main paths (the
grid-stride receive_doppler_kernel<false, true, ...> or
receive_coherent_kernel that replaced it): the pulse train
(pulse 0, depth 1, 2^24 lanes), the dechirp (depth 2, 2^24) and the
corner CPI's pulse 0 (mirror chains, depth 4, fixed sampling, 64 x 2^16
lanes), or the analytic lobe twins' windowed corner (depth 6, gate, 2^24
lanes: the grid-stride receive_doppler_kernel<false, COH, false, false,
true> or receive_lobe_kernel<COH> that replaced it): window_thin (the
thin window, power) and window_dielectric (the smooth one, I / Q), or the
analytic Doppler configuration in power (depth 2, 2^24 lanes: the
grid-stride receive_doppler_kernel<false, false, false, false> or
receive_doppler_power_kernel that replaced it): range_doppler (pulse 0 of
the range-Doppler example, gate) and fmcw_sonar (golden config 2,
mix_resample, fixed sampling), the mesh configuration in power
(`mesh`: the diffuse mesh_scene, depth 2, gate, 2^24 lanes, the main
path's direction strata: the grid-stride receive_trace_kernel<true> or
receive_mesh_kernel that replaced it) and the MIMO configuration (`mimo`:
golden config 6, depth 2, gate, 2^24 lanes: the grid-stride
receive_mimo_kernel<false, false> or receive_mimo_array_kernel that
replaced it; its element loop the stage `elem`).  The
lanes' stage masks come from the plain version on the configuration's
scene (Wigner receiver) with Philox seed 7; the pool model is the
kernels' pool of 64 paths a warp.

Each mode prints one line `RESULT {json}`.  Estimates, stated as such:
every instruction of a stage is counted once per entry of the stage (the
rectangle loops once per rectangle tested), and the SIMT models charge a
warp a stage's cost whenever any of its threads runs the stage.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPTH = 3
SEED = 7
MAIN_LANES = 1 << 28
POOL = 64                    # paths a warp in the flagship kernel
# the flagship kernel of a tree: the grid-stride instantiation or the
# warp-wavefront kernel that replaced it; the same for the coherent one
# (a tree with texture twins: their untextured instantiation, <false>; with
# prims twins, <false, false>)
KERNEL = (r'receive_trace_kernelILb0ELb0ELb0E|'
          r'receive_flagship_kernel(?!ILb1E|ILb0ELb1E)')
COH_KERNEL = (r'receive_doppler_kernelILb0ELb1ELb0ELb0ELb0E|'
              r'receive_coherent_kernel(?!ILb1E|ILb0ELb1E)')
# the texture twins of the two (a tree with prims twins: <true, false>),
# their prims twins (<false, true>) and a textured scene's (<true, true>)
FLAG_TEX_KERNEL = r'receive_flagship_kernelILb1E(?!Lb1E)'
COH_TEX_KERNEL = r'receive_coherent_kernelILb1E(?!Lb1E)'
FLAG_PRIM_KERNEL = r'receive_flagship_kernelILb0ELb1E'
COH_PRIM_KERNEL = r'receive_coherent_kernelILb0ELb1E'
FLAG_PRIM_TEX_KERNEL = r'receive_flagship_kernelILb1ELb1E'
COH_PRIM_TEX_KERNEL = r'receive_coherent_kernelILb1ELb1E'
# each configuration: depth, time sampling, the main path's lanes, its
# kernels
LOBE_KERNEL = (r'receive_doppler_kernelILb0ELb0ELb0ELb0ELb1E|'
               r'receive_lobe_kernelILb0E')
LOBE_COH_KERNEL = (r'receive_doppler_kernelILb0ELb1ELb0ELb0ELb1E|'
                   r'receive_lobe_kernelILb1E')
# the endpoint twins on analytic scenes: the grid-stride instantiations or
# the endpoint kernels that replaced them
EP_KERNEL = r'receive_trace_kernelILb0ELb0ELb1EE|receive_endpoint_kernel'
EP_COH_KERNEL = (r'receive_doppler_kernelILb0ELb1ELb0ELb1ELb0E|'
                 r'receive_endpoint_coherent_kernel')
# the analytic Doppler configuration in power: the grid-stride
# instantiation or the kernel that replaced it (a tree with its texture and
# prims twins: <false, false>), its texture twin (<true, false>), its prims
# twin (<false, true>) and a textured scene's (<true, true>)
DPW_KERNEL = (r'receive_doppler_kernelILb0ELb0ELb0ELb0ELb0E|'
              r'receive_doppler_power_kernel(?!ILb1E|ILb0ELb1E)')
DPW_TEX_KERNEL = r'receive_doppler_power_kernelILb1E(?!Lb1E)'
DPW_PRIM_KERNEL = r'receive_doppler_power_kernelILb0ELb1E'
DPW_PRIM_TEX_KERNEL = r'receive_doppler_power_kernelILb1ELb1E'
# the Doppler mesh in power and the mesh lobe twin in I / Q: the
# grid-stride instantiations or the mesh Doppler kernel that replaced them
MDK_KERNEL = (r'receive_doppler_kernelILb1ELb0ELb0ELb0ELb0E|'
              r'receive_mesh_doppler_kernelILb0ELb0E')
MDK_LOB_KERNEL = (r'receive_doppler_kernelILb1ELb1ELb0ELb0ELb1E|'
                  r'receive_mesh_doppler_kernelILb1ELb1E')
# the power mesh lobe twin and the coherent mesh: the grid-stride
# instantiations or the mesh Doppler kernel's that replaced them
MDK_POW_LOB_KERNEL = (r'receive_doppler_kernelILb1ELb0ELb0ELb0ELb1E|'
                      r'receive_mesh_doppler_kernelILb0ELb1E')
MDK_COH_KERNEL = (r'receive_doppler_kernelILb1ELb1ELb0ELb0ELb0E|'
                  r'receive_mesh_doppler_kernelILb1ELb0E')
# the mesh configuration in power and the MIMO configuration: the
# grid-stride instantiations or the kernels that replaced them
MSK_KERNEL = r'receive_trace_kernelILb1ELb0ELb0EE|receive_mesh_kernel'
MAK_KERNEL = r'receive_mimo_kernelILb0ELb0EE|receive_mimo_array_kernel'
CONFIGS = {'flagship': dict(depth=DEPTH, ts='gate', lanes=MAIN_LANES,
                            kernel=KERNEL),
           'range_doppler': dict(depth=2, ts='gate', lanes=1 << 24,
                                 kernel=DPW_KERNEL),
           'fmcw_sonar': dict(depth=2, ts='fixed', lanes=1 << 24,
                              kernel=DPW_KERNEL),
           'pulse_train': dict(depth=1, ts='gate', lanes=1 << 24,
                               kernel=COH_KERNEL),
           'dechirp': dict(depth=2, ts='gate', lanes=1 << 24,
                           kernel=COH_KERNEL),
           'corner': dict(depth=4, ts='fixed', lanes=64 << 16,
                          kernel=COH_KERNEL),
           'window_thin': dict(depth=6, ts='gate', lanes=1 << 24,
                               kernel=LOBE_KERNEL),
           'window_dielectric': dict(depth=6, ts='gate', lanes=1 << 24,
                                     kernel=LOBE_COH_KERNEL),
           'ep_phased_tx': dict(depth=2, ts='gate', lanes=1 << 24,
                                kernel=EP_KERNEL),
           'ep_phased_rx': dict(depth=2, ts='gate', lanes=1 << 24,
                                kernel=EP_KERNEL),
           'ep_four_tx': dict(depth=2, ts='gate', lanes=1 << 24,
                              kernel=EP_KERNEL),
           'ep_phased_tx_coh': dict(depth=2, ts='gate', lanes=1 << 24,
                                    kernel=EP_COH_KERNEL),
           'multi_body': dict(depth=2, ts='gate', lanes=1 << 24,
                              kernel=MDK_KERNEL),
           'mesh_lobes_iq': dict(depth=2, ts='gate', lanes=1 << 24,
                                 kernel=MDK_LOB_KERNEL),
           'mesh_lobes_power': dict(depth=2, ts='gate', lanes=1 << 24,
                                    kernel=MDK_POW_LOB_KERNEL),
           'coherent_mesh': dict(depth=2, ts='gate', lanes=1 << 24,
                                 kernel=MDK_COH_KERNEL),
           'mesh': dict(depth=2, ts='gate', lanes=1 << 24,
                        kernel=MSK_KERNEL),
           'mimo': dict(depth=2, ts='gate', lanes=1 << 24,
                        kernel=MAK_KERNEL),
           'flagship_checker': dict(depth=DEPTH, ts='gate',
                                    lanes=MAIN_LANES, kernel=FLAG_TEX_KERNEL),
           'flagship_bitmap': dict(depth=DEPTH, ts='gate', lanes=MAIN_LANES,
                                   kernel=FLAG_TEX_KERNEL),
           'coherent_checker': dict(depth=2, ts='gate', lanes=1 << 24,
                                    kernel=COH_TEX_KERNEL),
           'coherent_bitmap': dict(depth=2, ts='gate', lanes=1 << 24,
                                   kernel=COH_TEX_KERNEL),
           **{f'flagship_{t}': dict(depth=DEPTH, ts='gate',
                                    lanes=MAIN_LANES, kernel=FLAG_PRIM_KERNEL)
              for t in ('sphere', 'disk', 'cylinder')},
           **{f'coherent_{t}': dict(depth=2, ts='gate', lanes=1 << 24,
                                    kernel=COH_PRIM_KERNEL)
              for t in ('sphere', 'disk', 'cylinder')},
           'flagship_sphere_checker': dict(depth=DEPTH, ts='gate',
                                           lanes=MAIN_LANES,
                                           kernel=FLAG_PRIM_TEX_KERNEL),
           'coherent_sphere_checker': dict(depth=2, ts='gate',
                                           lanes=1 << 24,
                                           kernel=COH_PRIM_TEX_KERNEL),
           **{f'doppler_{t}': dict(depth=2, ts='gate', lanes=1 << 24,
                                   kernel=DPW_PRIM_KERNEL)
              for t in ('sphere', 'disk', 'cylinder')},
           **{f'doppler_{g}': dict(depth=2, ts='gate', lanes=1 << 24,
                                   kernel=DPW_TEX_KERNEL)
              for g in ('checker', 'bitmap')},
           'doppler_sphere_checker': dict(depth=2, ts='gate', lanes=1 << 24,
                                          kernel=DPW_PRIM_TEX_KERNEL)}
# the texture twins' configurations: the flagship scene's ground texture,
# and whether the twin is the coherent kernel's (I / Q)
TEX_CONFIGS = {'flagship_checker': ('checkerboard', False),
               'flagship_bitmap': ('bitmap', False),
               'coherent_checker': ('checkerboard', True),
               'coherent_bitmap': ('bitmap', True)}
# the prims twins' configurations: the flagship scene's target, whether
# the twin is the coherent kernel's (I / Q), and the ground's texture (the
# sphere over a checkerboard: the twin that carries the texture codes)
PRIM_CONFIGS = {**{f'{k}_{t}': (t, k == 'coherent', None)
                   for k in ('flagship', 'coherent')
                   for t in ('sphere', 'disk', 'cylinder')},
                'flagship_sphere_checker': ('sphere', False, 'checkerboard'),
                'coherent_sphere_checker': ('sphere', True, 'checkerboard')}
# the endpoint configurations: (scenes' function, coherent)
EP_SCENES = {'ep_phased_tx': ('phased_tx_scene', False),
             'ep_phased_rx': ('phased_rx_scene', False),
             'ep_four_tx': ('four_tx_scene', False),
             'ep_phased_tx_coh': ('phased_tx_scene', True)}
# the configurations of the lobe twins, and whether each is the I / Q twin
LOBE_COHERENT = {'window_thin': False, 'window_dielectric': True}
# the analytic Doppler power configurations; its twins' (the range-Doppler
# pulse's target and static ground texture)
DPW_TWIN_CONFIGS = {'doppler_sphere': ('sphere', None),
                    'doppler_disk': ('disk', None),
                    'doppler_cylinder': ('cylinder', None),
                    'doppler_checker': ('plate', 'checkerboard'),
                    'doppler_bitmap': ('plate', 'bitmap'),
                    'doppler_sphere_checker': ('sphere', 'checkerboard')}
DPW_CONFIGS = ('range_doppler', 'fmcw_sonar') + tuple(DPW_TWIN_CONFIGS)
# the mesh configurations, and whether each is in I / Q: the Doppler mesh
# on multi_body, the rough-plastic mesh_scene in I / Q and in power, the
# diffuse mesh_scene in I / Q; their lanes take the main path's direction
# strata (patch_p_for of its lanes)
MESH_COHERENT = {'multi_body': False, 'mesh_lobes_iq': True,
                 'mesh_lobes_power': False, 'coherent_mesh': True}
# every configuration on a mesh: those and the mesh configuration in power
# (the diffuse mesh_scene, mode 0), whose lanes take the strata too
MESH_CONFIGS = tuple(MESH_COHERENT) + ('mesh',)
# the BVH walks of a mesh lane: RAY's first hit (depth 0), a bounce's
# closest hit (depth > 0), NEE's any hit
WALKS = ('ray', 'bounce', 'shadow')
# the stages that are bookkeeping, not a lane's work: the warp wavefront's
# turns, the grid-stride loop, the block's set-up
BOOKKEEPING = ('sched', 'lane', 'block')
# the fewest thread-instructions a lane measured for the lane stages of
# each configuration's function (stage masks above): the flagship's
# receive_flagship_kernel 2,399.0 (the grid-stride kernel before it
# 2,507.2); the coherent configuration's, receive_coherent_kernel's
# second design (the grid-stride instantiation before it 2,974.0,
# 1,954.9, 4,170.8); the lobe twins' windowed corner, the second design
# of receive_lobe_kernel (Philox blocks by need; the grid-stride
# instantiations before it 4,987.8, 5,765.2); the endpoint scenes', the
# endpoint kernels held to six blocks an SM with 64 cells an axis (the
# grid-stride twins before them 2,194.4, 4,377.7, 4,716.2, 3,329.6); the
# mesh configurations', the mesh Doppler kernel (the grid-stride
# instantiations before it 2,601.4, 2,295.0, 2,252.4, 2,196.9); the mesh
# configuration in power's, the mesh kernel (the grid-stride kernel before
# it 1,646.9), and the MIMO configuration's, the MIMO array kernel at four
# blocks an SM (the grid-stride kernel before it 1,311.0)
LEAST_STAGE_INSTRUCTIONS = {'flagship': 2399.0, 'pulse_train': 2341.9,
                            'dechirp': 1639.5, 'corner': 3462.6,
                            'window_thin': 3461.6,
                            'window_dielectric': 3904.9,
                            'ep_phased_tx': 1545.0, 'ep_phased_rx': 3638.7,
                            'ep_four_tx': 4014.8,
                            'ep_phased_tx_coh': 2336.7,
                            'multi_body': 2316.9, 'mesh_lobes_iq': 1992.6,
                            'mesh_lobes_power': 1996.8,
                            'coherent_mesh': 1965.5, 'mesh': 1482.5,
                            'mimo': 1036.8}

# the stages of a flagship lane and the plain version's stat key that counts
# the entries of each ('rect' and 'occ' per rectangle tested)
# (the lobe twins': the hit's lobe f cos in NEE, a composite's pick, and
# the bounce's branches by lobe, beside its common frame and spawn)
STAGES = ('ray', 'trace', 'closest', 'hit', 'direct', 'nee', 'shadow',
          'phase', 'splat', 'bounce', 'draws', 'sched', 'lane', 'block',
          'lobe_nee', 'pick', 'mirror', 'diel', 'ggx', 'diffuse',
          'rx_pairs', 'rx_terms', 'rx_calls', 'nee_pairs', 'nee_terms',
          'nee_calls', 'direct_pairs', 'direct_terms', 'direct_calls',
          'walk', 'walk_node', 'walk_tri', 'shadow_walk', 'shadow_node',
          'shadow_tri', 'elem')
# the plain version's stat keys a lane's masks are read for (its receive
# frequency's, counted for every lane, are the ray's: stage_weights_fp32)
KEYS = ('trace', 'hit', 'direct', 'nee_geom', 'nee', 'occ_tests',
        'nee_splat', 'bounce', 'ggx_nee', 'ggx_bounce', 'mirror_bounce',
        'dop_direct', 'dop_nee', 'dop_bounce', 'splat_2d', 'lo_bin', 'phase',
        'phase_lo', 'plas_nee', 'rplas_nee', 'rdiel_nee', 'blend_nee',
        'blend_pick', 'diel_bounce', 'plas_bounce', 'rplas_bounce',
        'rdiel_bounce', 'pass_bounce', 'mimo_elem')
# the lobe twins' bounce keys, each in place of the diffuse bounce
LOBE_BOUNCES = ('diel_bounce', 'plas_bounce', 'rplas_bounce', 'rdiel_bounce',
                'pass_bounce')
# the SIMT models' stage columns after the ray's: each a sum of stat keys
COLUMNS = (('trace',), ('hit',), ('direct', 'dop_direct'), ('nee_geom',),
           ('nee', 'ggx_nee', 'dop_nee'), ('occ_tests',),
           ('nee_splat', 'splat_2d', 'lo_bin'), ('phase', 'phase_lo'),
           ('bounce', 'ggx_bounce', 'dop_bounce'), ('mirror_bounce',),
           ('plas_nee', 'rplas_nee', 'rdiel_nee', 'blend_nee'),
           ('blend_pick',), ('diel_bounce',), ('plas_bounce',),
           ('rplas_bounce',), ('rdiel_bounce',), ('pass_bounce',),
           ('mimo_elem',))
# the parent's section comments inside trace_lane, in source order, and
# the tags of a body written with them
MARKERS = ((r'-- receive-ray generation', 'ray'),
           (r'-- closest hit over the rectangles', 'closest'),
           (r'if \(!\(tb < F\(3\.4e37\)\)\) break;', 'hit'),
           (r'-- direct transmitter hits', 'direct'),
           (r'-- NEE to the transmitter', 'nee'),
           (r'bool occ = false;', 'shadow'),
           (r'if \(!occ && pdf_sa > 0\.0f\)', 'nee'),
           (r'if \(depth == cfg\.max_depth - 1\) break;', 'bounce'),
           (r'return lane_sum;', None),
           (r'for \(long long lane = \(long long\)blockIdx\.x \* T \+ tid;',
            'lane'),
           (r"// the pulse's partial rows", None),
           (r'\[k1 stage: (\w+)\]', 'tag'))
CLASSES = (('fp32', r'^(FFMA|FADD|FMUL)(\.|$)'),
           ('fp32_other', r'^(FSETP|FMNMX|FSEL|FCHK|FSET|FSWZADD)'),
           ('mufu', r'^MUFU'),
           ('imad', r'^IMAD'),
           ('int_other', r'^(IADD3|LOP3|SHF|ISETP|LEA|IABS|IMNMX|POPC|FLO|'
                         r'BREV|PRMT|SGXT|VIADD|VIMNMX|BMSK|ULOP|UIADD|UMOV|'
                         r'USHF|UISETP|UIMAD|ULEA|USEL|UPRMT|UFLO|UPOPC|'
                         r'UBMSK|USGXT|UBREV|ULDC|S2UR|R2UR|VOTEU|IDP)'),
           ('lds', r'^LDS'),
           ('sts', r'^STS'),
           ('global_const_local', r'^(LDG|STG|LDC|LDL|STL|LD\b|ST\b|RED|ATOM)'),
           ('branch', r'^(BRA|BSSY|BSYNC|CALL|RET|EXIT|WARPSYNC|BREAK|JMP|'
                      r'BAR|BPT|NANOSLEEP|YIELD|KILL)'),
           ('convert', r'^(F2I|I2F|F2F|FRND|I2I|F2FP)'),
           ('move_select', r'^(MOV|SEL|P2R|R2P|S2R|CS2R|PLOP3|SHFL|VOTE|'
                           r'MATCH|REDUX|FMNMX)'),
           ('other', r'.'))


def scene_of(config: str):
    """(scene, receiver) of a configuration: a snapshot for the corner."""
    sys.path.insert(0, HERE)
    from beifong_tpu_torch import scenes
    if config in EP_SCENES:
        fn = EP_SCENES[config][0]
        P = scenes.PHASED
        arg = {'phased_tx_scene': (scenes.steer_toward(
            P['tx'], scenes.phased_tx_target()),),
            'phased_rx_scene': (P['rx_az'],)}.get(fn, ())
        return getattr(scenes, fn)(*arg)
    if config in LOBE_COHERENT:
        return scenes.window_corner_scene(config[len('window_'):])
    if config == 'multi_body':
        return scenes.multi_body_scene()
    if config in ('mesh_lobes_iq', 'mesh_lobes_power'):
        return scenes.mesh_scene(material='rough_plastic')
    if config in ('coherent_mesh', 'mesh'):
        return scenes.mesh_scene()
    if config == 'mimo':
        return scenes.mimo_beamform_scene()
    if config in TEX_CONFIGS:
        return scenes.flagship_scene(ground_texture=TEX_CONFIGS[config][0])
    if config in PRIM_CONFIGS:
        target, _, ground = PRIM_CONFIGS[config]
        return scenes.flagship_scene(target=target, ground_texture=ground)
    if config == 'flagship':
        return scenes.flagship_scene()
    if config == 'pulse_train':
        return scenes.pulse_train_scene(0)
    if config == 'dechirp':
        return scenes.fmcw_dechirp_scene()
    if config == 'range_doppler':
        return scenes.range_doppler_scene(0)
    if config in DPW_TWIN_CONFIGS:
        target, ground = DPW_TWIN_CONFIGS[config]
        return scenes.range_doppler_scene(0, target, ground)
    if config == 'fmcw_sonar':
        return scenes.fmcw_sonar_scene()
    s, rx = scenes.corner_scene()
    return s.at_time(0.0), rx


def ref_kw(config: str, rx, packed) -> dict:
    """The plain version's keywords of a configuration (the Wigner
    receiver)."""
    kw = dict(adc=rx.adc, max_depth=CONFIGS[config]['depth'],
              time_sampling=CONFIGS[config]['ts'], rx_kind='wigner')
    if config == 'mesh':
        sys.path.insert(0, HERE)
        from beifong_tpu_torch.integrators import receive_kernel as rk
        kw.update(mesh=packed.mesh,
                  patch_p=rk.patch_p_for(CONFIGS[config]['lanes']))
        return kw
    if config == 'mimo':
        import torch
        sys.path.insert(0, HERE)
        from beifong_tpu_torch.integrators import receive_kernel as rk
        s, _ = scene_of(config)
        kw.update(rx_kind='phased', doppler=True,
                  receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, mirror=packed.mirror,
                  rxph=torch.tensor(packed.rxph),
                  eoff=rk.array_offsets(s, s.compile(use_bvh=False,
                                                     device='cpu'), rx,
                                        'cpu'))
        return kw
    if config in TEX_CONFIGS:
        import torch
        coh = TEX_CONFIGS[config][1]
        kw.update(doppler=coh, coherent=coh, tex=torch.tensor(packed.tex),
                  bmp_meta=torch.tensor(packed.bmp_meta))
        return kw
    if config in PRIM_CONFIGS:
        _, coh, ground = PRIM_CONFIGS[config]
        kw.update(doppler=coh, coherent=coh)
        if ground is not None:
            import torch
            kw.update(tex=torch.tensor(packed.tex),
                      bmp_meta=torch.tensor(packed.bmp_meta))
        return kw
    if config in EP_SCENES:
        import torch
        sys.path.insert(0, HERE)
        from beifong_tpu_torch.integrators import receive_kernel as rk
        coh = EP_SCENES[config][1]
        kw.update(rx_kind=rk.rx_kind_of(rx), doppler=coh, coherent=coh,
                  php=torch.tensor(packed.php),
                  rxph=torch.tensor(packed.rxph)
                  if rk.rx_kind_of(rx) == 'phased' else None)
        return kw
    if config != 'flagship':
        kw.update(doppler=True, receive_type=rx.receive_type,
                  has_lo=rx.lo_waveform is not None, coherent=True,
                  mirror=packed.mirror)
    if config in LOBE_COHERENT:
        kw.update(coherent=LOBE_COHERENT[config], lobes=packed.lobes)
    if config in DPW_CONFIGS:
        kw['coherent'] = False
    if config in DPW_TWIN_CONFIGS and DPW_TWIN_CONFIGS[config][1]:
        import torch
        kw.update(tex=torch.tensor(packed.tex),
                  bmp_meta=torch.tensor(packed.bmp_meta))
    if config in MESH_COHERENT:
        import torch
        from beifong_tpu_torch.integrators import receive_kernel as rk
        kw.update(coherent=MESH_COHERENT[config], mesh=packed.mesh,
                  msh=torch.tensor(packed.msh), lobes=packed.lobes,
                  patch_p=rk.patch_p_for(CONFIGS[config]['lanes']))
    return kw


def draw_stride(kw: dict) -> tuple:
    """(draws a depth, the offset of a composite's pick after the lobe
    pick's) of the plain version's keywords: six, plus the lobe pick and
    the composite pick where the lobe twins' flags hold them."""
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.integrators import receive_kernel as rk
    d = rk.lobe_draws(kw.get('lobes') or 0)
    return 6 + d['lobe_mix'] + d['blend_mix'], int(d['lobe_mix'])


def lobe_kw(config: str) -> dict:
    """{'lobes': the lobe twins' flags} of a configuration's tables (0
    outside the lobe twins)."""
    if config not in LOBE_COHERENT and config not in MESH_COHERENT:
        return {}
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.integrators import receive_kernel as rk
    s, rx = scene_of(config)
    p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                      s.shape_index_of_endpoint('receiver', rx.id))
    return {'lobes': p.lobes}


def stage_masks(n_lanes: int, device: str = 'cpu',
                config: str = 'flagship'):
    """[(key, depth, bool mask (n_lanes,))] of every stage count the plain
    version takes on the configuration's scene, read from its `count`
    calls, and the number of rectangles."""
    import torch
    from torch.overrides import TorchFunctionMode
    sys.path.insert(0, HERE)
    from beifong_tpu_torch.integrators import receive_kernel as rk

    out = []
    d = [-1]

    class Capture(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.sum and not kwargs and len(args) == 1:
                f = sys._getframe(1)
                while f is not None and f.f_code.co_name != 'count':
                    f = f.f_back
                if f is not None and 'key' in f.f_locals:
                    key = f.f_locals['key']
                    if key == 'trace':
                        d[0] += 1
                    out.append((key, d[0], args[0].detach().cpu().numpy()
                                .astype(bool).copy()))
            return func(*args, **(kwargs or {}))

    s, rx = scene_of(config)
    sd = s.compile(use_bvh=False, device='cpu')
    p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver', rx.id))
    params, prim, txp = (torch.tensor(a, device=device)
                         for a in (p.params, p.prim, p.txp))
    if p.mesh is not None:
        params[0] = rk.seed_slot(SEED)
    kw = {k: v.to(device) if isinstance(v, torch.Tensor)
          or k == 'mesh' else v
          for k, v in ref_kw(config, rx, p).items()}
    walk_ref = rk.walk_ref

    def walk_rec(pb, ox, *a, anyhit, stats=None):
        """the plain version's walk, recording each ray's slab tests and
        leaves against its lane (the caller's `walk` indices) and kind"""
        v = torch.zeros((int(ox.shape[0]), 2), dtype=torch.long,
                        device=ox.device)
        r = walk_ref(pb, ox, *a, anyhit=anyhit, stats=stats, visits=v)
        lanes = sys._getframe(1).f_locals['walk']
        kind = 'shadow' if anyhit else 'ray' if d[0] == 0 else 'bounce'
        out.append((f'_walk_{kind}', d[0], (lanes.cpu().numpy().copy(),
                                            v.cpu().numpy())))
        return r
    u = rk.philox_uniforms(SEED, rk.n_draws(kw['max_depth'],
                                            int(txp.shape[0]),
                                            **rk.lobe_draws(kw.get('lobes')
                                                            or 0)),
                           n_lanes, device=device)
    stats: dict = {}
    rk.walk_ref = walk_rec
    try:
        with Capture():
            rk.receive_megakernel_ref(params, prim, txp, u, stats=stats,
                                      **kw)
    finally:
        rk.walk_ref = walk_ref
    # the analytic prim records each trace tests (rectangles; with the
    # prims twins, spheres, disks and cylinders too)
    n_rect = int(((prim[:, 0] >= 0) & (prim[:, 0] <= 3)).sum())
    # the cross-WDFs' totals (not masks): pair sums, pairs tested, pairs
    # the endpoint kernels' index visits
    out.append(('_pairs', -1, dict({k: stats.get(k, 0) for k in (
        'pair_sums', 'pair_tests', 'pair_visits', 'pair_terms',
        'phased_ray')}, n_tx=int(txp.shape[0]))))
    return out, n_rect


def per_lane(masks, n_lanes: int):
    """(n_lanes, depth) arrays of each stage's entries (KEYS), and on a
    mesh of each walk's slab tests and leaves (`node_<walk>`,
    `leaf_<walk>`, WALKS)."""
    depth = max(1, max(d for _, d, _ in masks) + 1)
    a = {k: np.zeros((n_lanes, depth), np.int32) for k in KEYS}
    if any(key.startswith('_walk_') for key, _, _ in masks):
        for w in WALKS:
            a[f'node_{w}'] = np.zeros((n_lanes, depth), np.int64)
            a[f'leaf_{w}'] = np.zeros((n_lanes, depth), np.int64)
    for key, d, m in masks:
        if key in a and isinstance(m, np.ndarray) and m.shape == (n_lanes,):
            a[key][:, d] += m
        elif key in a and isinstance(m, np.ndarray) \
                and m.shape[-1:] == (n_lanes,):
            # a count over rows of lanes (MIMO: one row an element)
            a[key][:, d] += m.reshape(-1, n_lanes).sum(axis=0)
        elif key.startswith('_walk_'):
            lanes, v = m
            w = key[len('_walk_'):]
            np.add.at(a[f'node_{w}'][:, d], lanes, v[:, 0])
            np.add.at(a[f'leaf_{w}'][:, d], lanes, v[:, 1])
    return a


def pair_totals(masks) -> dict:
    """The plain version's cross-WDF totals of a stage_masks run (pair
    sums, tests, visits, terms, phased rays) and its transmitters."""
    return next((m for key, _, m in masks if key == '_pairs'), {})


def philox_blocks(a: dict, fixed: bool = False, stride: int = 6,
                  pick: int = 0) -> np.ndarray:
    """Philox4x32-10 blocks each lane computes: the kernel's Draws caches
    one block of four words, so a block is computed where a draw's index /
    4 differs from the last one's (gate sampling: ray draws 1-4, `fixed`
    the time draw 0 first; then `stride` a depth from 5: direct d0, NEE
    d0+1, d0+2 (+ d0+3 past the cosine test), bounce d0+4, d0+5, a
    mirror's too; the lobe twins' composite pick d0+6+`pick`, then a
    plastic's or GGX glass's lobe pick d0+6)."""
    n, depth = a['trace'].shape
    bounce = a['bounce'] + a['ggx_bounce'] + a['mirror_bounce'] \
        + sum(a[k] for k in LOBE_BOUNCES)
    lobe_pick = a['plas_bounce'] + a['rplas_bounce'] + a['rdiel_bounce']
    seqs = []
    for lane in range(n):
        idx = [0, 1, 2, 3, 4] if fixed else [1, 2, 3, 4]
        for d in range(depth):
            d0 = 5 + stride * d
            if a['direct'][lane, d]:
                idx.append(d0)
            if a['nee_geom'][lane, d]:
                idx += [d0 + 1, d0 + 2]
            if a['nee'][lane, d]:
                idx.append(d0 + 3)
            if bounce[lane, d] or a['blend_pick'][lane, d]:
                idx += [d0 + 4, d0 + 5]
            if a['blend_pick'][lane, d]:
                idx.append(d0 + 6 + pick)
            if lobe_pick[lane, d]:
                idx.append(d0 + 6)
        g = [i >> 2 for i in idx]
        seqs.append(1 + sum(x != y for x, y in zip(g, g[1:])))
    return np.asarray(seqs, np.float64)


def stage_blocks(a: dict, direct: bool = False,
                 stride: int = 6) -> np.ndarray:
    """Philox blocks each lane computes in the flagship, coherent and lobe
    kernels, whose stages take their draws' blocks at their start: two
    for the ray, two at each hit (the lobe kernel's: those of draws d0+1
    .. d0+stride-1, three where they span three); with `direct`, one more
    for each direct hit's draw (at depth 0 and after a delta bounce)."""
    n, depth = a['hit'].shape
    per = np.asarray([2.0 if stride == 6 else
                      float(((5 + stride * d + stride - 1) >> 2)
                            - ((6 + stride * d) >> 2) + 1)
                      for d in range(depth)])
    b = 2.0 + (a['hit'] * per).sum(axis=1).astype(np.float64)
    if direct:
        b += a['direct'].sum(axis=1)
    return b


def ep_blocks(a: dict, n_tx: int, turns: bool) -> np.ndarray:
    """Philox blocks each lane computes in the endpoint twins (gate
    sampling, draws 5 + (3 + 3 n_tx) d on at depth d): the grid-stride
    twins' cached block (a block where a draw's index / 4 differs from the
    last one's: direct d0, transmitter t's NEE d0 + 1 + 3 t, + 2 (+ 3 past
    its cosine test), the bounce d0 + 1 + 3 n_tx, + 2), or (`turns`) the
    endpoint kernels': two for the ray, one or two for each NEE's three
    draws and for the bounce's, one for a direct hit.  The plain version
    counts a depth's NEEs, not which transmitters: the first ones are
    taken."""
    n, depth = a['trace'].shape
    stride = 3 + 3 * n_tx
    bounce = a['bounce'] + a['ggx_bounce'] + a['mirror_bounce']

    def span(first, k):
        return 1 + ((first + k - 1) >> 2) - (first >> 2)
    if turns:
        b = np.full(n, 2.0)
        for d in range(depth):
            d0 = 5 + stride * d
            b += a['direct'][:, d]
            for t in range(n_tx):
                b += (a['nee_geom'][:, d] > t) * span(d0 + 1 + 3 * t, 3)
            b += bounce[:, d] * span(d0 + 1 + 3 * n_tx, 3)
        return b
    seqs = []
    for lane in range(n):
        idx = [1, 2, 3, 4]
        for d in range(depth):
            d0 = 5 + stride * d
            if a['direct'][lane, d]:
                idx.append(d0)
            for t in range(min(n_tx, int(a['nee_geom'][lane, d]))):
                idx += [d0 + 1 + 3 * t, d0 + 2 + 3 * t]
                if t < a['nee'][lane, d]:
                    idx.append(d0 + 3 + 3 * t)
            if bounce[lane, d]:
                idx += [d0 + 1 + 3 * n_tx, d0 + 2 + 3 * n_tx]
        g = [i >> 2 for i in idx]
        seqs.append(1 + sum(x != y for x, y in zip(g, g[1:])))
    return np.asarray(seqs, np.float64)


def stage_weights_fp32(n_rect: int, config: str = 'flagship') -> dict:
    """FP32 operations of each stat key's entry (chip_smoke.FP32_OPS, as
    chip_smoke.lane_ops counts them); 'ray' the receive ray's, with its
    receive frequency read off a waveform or drawn."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from beifong_tpu_torch.integrators import receive_kernel as rk
    f = cs.FP32_OPS
    w = {'ray': f['ray_wigner'], 'trace': n_rect * f['rect_test'],
         'hit': f['hit'], 'direct': f['direct'], 'nee_geom': f['nee_geom'],
         'nee': f['nee'], 'occ_tests': f['rect_test'],
         'nee_splat': f['nee_splat'], 'bounce': f['bounce']}
    if config != 'flagship':
        w.update({k: f[k] for k in (
            'ggx_nee', 'ggx_bounce', 'mirror_bounce', 'dop_direct',
            'dop_nee', 'dop_bounce', 'splat_2d', 'lo_bin', 'phase',
            'phase_lo')})
        w.update({k: f.get(k, 0.0) for k in KEYS
                  if k.startswith(('plas_', 'rplas_', 'rdiel_', 'blend_',
                                   'diel_', 'pass_'))})
        _, rx = scene_of(config)
        rule = rk.rx_rule(rx.receive_type, rx.lo_waveform is not None)
        if rule in (rk.RX_MIX, rk.RX_MIXER, rk.RX_RAW_LO):
            w['ray'] += f['lo_freq']
        if rule == rk.RX_MIXER or (rule == rk.RX_RAW
                                   and rx.adc.n_freq > 1):
            w['ray'] += f['freq_draw']
        if config in ('dechirp', 'corner'):
            # a chirp's echo phase adds the quadratic term to each h
            w['phase'] += f['h_chirp']
            w['phase_lo'] += f['h_chirp']
    if config in MESH_CONFIGS:
        # the strata's ray; each walk's slab tests and leaves (walk_cost)
        w['ray'] += f['ray_strata'] - f['ray_wigner']
        w.update(node_test=f['node_test'], leaf_test=f['leaf_test'])
    if config == 'mimo':
        # the array's ray; each connection's element terms
        w['ray'] += f['ray_phased'] - f['ray_wigner']
        w['mimo_elem'] = f['mimo_elem']
    return w


def walk_cost(a: dict, w: dict, walk: str) -> np.ndarray:
    """(n_lanes, depth) cost of a lane's `walk` (WALKS) at each depth: its
    slab tests and leaves at the weights w['node_test'], w['leaf_test']
    (0 on an analytic configuration)."""
    if f'node_{walk}' not in a:
        return np.zeros(a['trace'].shape)
    return (a[f'node_{walk}'] * w.get('node_test', 0.0)
            + a[f'leaf_{walk}'] * w.get('leaf_test', 0.0))


def _vertex_table(a: dict, w: dict):
    """(n_lanes, depth, 1 + len(COLUMNS)) per-vertex costs of each stage
    (the ray's at depth 0); a mesh lane's closest-hit walks join its trace
    column, its shadow walks the shadow tests'."""
    n, depth = a['trace'].shape
    t = np.zeros((n, depth, len(COLUMNS) + 1))
    t[:, 0, 0] = w['ray']
    for j, keys in enumerate(COLUMNS):
        t[:, :, j + 1] = sum(a[k] * w.get(k, 0.0) for k in keys)
    t[:, :, 1] += walk_cost(a, w, 'ray') + walk_cost(a, w, 'bounce')
    t[:, :, 1 + COLUMNS.index(('occ_tests',))] += walk_cost(a, w, 'shadow')
    return t


def _eff(groups) -> float:
    """used over issued slots of groups of up to 32 costs, each issued as
    32 x its largest"""
    used = sum(float(g.sum()) for g in groups)
    issued = sum(32.0 * float(g.max()) for g in groups if len(g))
    return used / issued if issued else 1.0


def walk_simt(a: dict, w: dict) -> dict:
    """SIMT efficiency of the BVH walks (used over issued slots, each
    group of 32 issued as 32 x its largest walk), by walk (RAY's first
    hit, a bounce's closest hit, NEE's shadow) and measure (slab tests,
    leaves, their FP32 cost at the weights w): for the grid-stride loop (a
    warp's 32 consecutive lanes, each walk at its depth) and for the warp
    wavefront (RAY's walks over 32 consecutive lanes; a SHADE turn's
    shadow walks, and the bounce walks it traces, over 32 paths that hit
    at that depth, taken in lane order)."""
    n, depth = a['trace'].shape
    hit = a['hit'] > 0
    out = {}
    for walk in WALKS:
        meas = {'nodes': a[f'node_{walk}'].astype(np.float64),
                'leaves': a[f'leaf_{walk}'].astype(np.float64),
                'fp32': walk_cost(a, w, walk)}
        for m, v in meas.items():
            gs = [v[i:i + 32, d] for d in range(depth)
                  for i in range(0, n - n % 32, 32)]
            wf = []
            for d in range(depth):
                if walk == 'ray' and d == 0:
                    wf += [v[i:i + 32, 0] for i in range(0, n - n % 32, 32)]
                    continue
                # the SHADE turn of the hits at depth d (shadow) or d - 1
                # (the bounce it traces)
                src = d if walk == 'shadow' else d - 1
                if src < 0:
                    continue
                paths = np.nonzero(hit[:, src])[0]
                wf += [v[paths[i:i + 32], d]
                       for i in range(0, len(paths), 32)]
            out[f'{walk}_{m}'] = dict(
                per_lane=float(v.sum()) / n,
                grid_stride_efficiency=_eff(gs),
                wavefront_efficiency=_eff(wf))
    return out


def simt(a: dict, w: dict, lanes_per_thread: int = 64) -> dict:
    """Used over issued slots of the grid-stride loop (a warp's 32
    consecutive lanes each to its end, every stage of a depth issued if
    any lane needs it, the shadow loop as long as its longest lane) and of
    a warp-uniform vertex loop with lane refill (every thread one vertex
    an iteration; a thread whose path ended starts its next lane, ray
    included, in the next iteration)."""
    t = _vertex_table(a, w)
    n, depth, ns = t.shape
    used = t.sum()
    # grid-stride: warps of 32 consecutive lanes; a stage's issue is the
    # max over the warp (the shadow loop's length too)
    nw = n // 32
    tw = t[: nw * 32].reshape(nw, 32, depth, ns)
    issued_gs = 32 * tw.max(axis=1).sum()
    # refill: thread j of warp g takes lanes g * 32 + j + k * stride
    n_threads = n // lanes_per_thread
    n_threads -= n_threads % 32
    stride = n_threads
    alive = t[:, :, 1] > 0                       # a vertex that traces
    issued_rf, used_rf = 0.0, 0.0
    for g in range(n_threads // 32):
        seqs = []
        for j in range(32):
            rows = []
            for k in range(lanes_per_thread):
                lane = g * 32 + j + k * stride
                for d in range(depth):
                    if alive[lane, d]:
                        rows.append(t[lane, d])
            seqs.append(np.asarray(rows).reshape(-1, ns))
        L = max(len(s) for s in seqs)
        pad = np.zeros((32, L, ns))
        for j, s in enumerate(seqs):
            pad[j, : len(s)] = s
        issued_rf += 32 * pad.max(axis=0).sum()
        used_rf += pad.sum()
    return {'used_slots_a_lane': used / n,
            'grid_stride_slots_a_lane': issued_gs / (nw * 32),
            'grid_stride_efficiency': used / issued_gs * (nw * 32) / n,
            'refill_slots_a_lane': issued_rf / (n_threads * lanes_per_thread),
            'refill_efficiency': used_rf / issued_rf,
            'refill_over_grid_stride': (issued_rf / used_rf)
            / (issued_gs / (t[: nw * 32].sum()))}


def pool_model(a: dict, w: dict, lanes_per_thread: int = 64,
               fused: bool = False) -> dict:
    """Used over issued slots of a warp-level wavefront: each warp keeps
    POOL paths and each turn runs one stage over 32 of them in slot
    order (SHADE when 32 wait for it, else TRACE when 32 do, else RAY for
    the warp's next 32 lanes when they fit, else the fuller of SHADE and
    TRACE), a stage's sub-stages issued if any of its paths needs them.
    `fused`: a turn traces the rays it makes, RAY its new lanes' and
    SHADE its bounces', so the pool holds only paths waiting for SHADE
    (SHADE when 32 wait, else RAY, else the rest).  The turns' own
    bookkeeping is not counted."""
    t = _vertex_table(a, w)
    n, depth, ns = t.shape
    n_threads = n // lanes_per_thread
    n_threads -= n_threads % 32
    stride = n_threads
    trace = t[:, :, 1] > 0
    hit = a['hit'] > 0
    used = issued = 0.0
    turns = {'ray': 0, 'trace': 0, 'shade': 0}
    full = dict.fromkeys(turns, 0)

    def trace_cost(go):
        """issued and used slots of tracing the paths `go` (the rectangles
        and, on a mesh, each path's own walk: the warp issues its
        longest)"""
        if not go:
            return 0.0, 0.0
        c = np.asarray([t[ln, d, 1] for ln, d in go])
        return 32.0 * float(c.max()), float(c.sum())

    for g in range(n_threads // 32):
        lanes = [g * 32 + j + k * stride for k in range(lanes_per_thread)
                 for j in range(32)]
        qi, tr, sh = 0, [], []
        while True:
            free = POOL - len(tr) - len(sh)
            n_new = min(32, len(lanes) - qi)
            if len(sh) >= 32:
                st = 'shade'
            elif len(tr) >= 32:
                st = 'trace'
            elif n_new > 0 and free >= n_new:
                st = 'ray'
            elif not tr and not sh:
                break
            else:
                st = 'shade' if len(sh) >= len(tr) else 'trace'
            turns[st] += 1
            if st == 'ray':
                new = [(ln, 0) for ln in lanes[qi:qi + n_new]]
                qi += n_new
                issued += 32 * t[0, 0, 0]
                used += n_new * t[0, 0, 0]
                full[st] += n_new
                if fused:
                    i_, u_ = trace_cost(new)
                    issued, used = issued + i_, used + u_
                    sh += [(ln, d) for ln, d in new if hit[ln, d]]
                else:
                    tr += new
            elif st == 'trace':
                go, tr = tr[:32], tr[32:]
                i_, u_ = trace_cost(go)
                issued, used = issued + i_, used + u_
                full[st] += len(go)
                sh += [(ln, d) for ln, d in go if hit[ln, d]]
            else:
                go, sh = sh[:32], sh[32:]
                rows = np.asarray([t[ln, d, 2:] for ln, d in go])
                issued += 32 * rows.max(axis=0).sum()
                used += rows.sum()
                full[st] += len(go)
                cont = [(ln, d + 1) for ln, d in go
                        if d + 1 < depth and trace[ln, d + 1]]
                if fused:
                    i_, u_ = trace_cost(cont)
                    issued, used = issued + i_, used + u_
                    sh += [(ln, d) for ln, d in cont if hit[ln, d]]
                else:
                    tr += cont
    return {'pool': POOL, 'fused': fused,
            'slots_a_lane': issued / (n_threads * lanes_per_thread),
            'efficiency': used / issued, 'turns': turns,
            'turns_a_lane': sum(turns.values()) / (n_threads
                                                   * lanes_per_thread),
            'turn_fill': {k: full[k] / (32 * max(turns[k], 1))
                          for k in turns}}


# ---------------------------------------------------------------------------
# machine code


def line_stages(source: str) -> dict:
    """{line: stage} of the lines inside the marked sections of a lane's
    work, from the first parent marker (the ray's) or tag on: each marker
    or tag opens its stage, 'end' (or a closing marker) closes it."""
    out, cur, started = {}, None, False
    with open(source) as f:
        lines = f.read().splitlines()
    for i, ln in enumerate(lines, 1):
        for pat, st in MARKERS:
            m = re.search(pat, ln)
            if not m:
                continue
            if st == 'tag':
                st = None if m.group(1) == 'end' else m.group(1)
                started = True
            if st == 'ray':
                started = True
            if started:
                cur = st
            break
        if cur is not None:
            out[i] = cur
    return out


def func_ranges(source: str) -> dict:
    """{name: (first, last)} lines of the helpers whose inlined code is
    its own stage: Philox and the draws, the tent splats, the echo phase
    (conn_splat's, less its grid splat), the cross-WDFs (pair_sum, its
    loop over the pairs, pair_sum_epx, pair_sum_warp)."""
    with open(source) as f:
        lines = f.read().splitlines()
    out = {}
    for name, pat in (('pairs', r'float pair_sum\(const float'),
                      ('pairs_loop', r'for \(int k = 0; k < n_k; \+\+k\) \{'),
                      ('pairs_term', r'const float val_k = __ldg\(q \+ 5\);'),
                      ('pairs_x', r'float pair_sum_epx\('),
                      ('pairs_w', r'float pair_sum_warp\('),
                      ('draws', r'uint4 philox4x32_10\('),
                      ('draws_flag', r'uint4 flag_block\('),
                      ('draws_coh', r'uint4 coh_block\('),
                      ('draws_get', r'__device__ float get\(int idx\)'),
                      ('splat', r'void splat\(float\* hist'),
                      ('splat_w', r'\[k1 splat\]'),
                      ('splat_c', r'void coh_splat_rows\('),
                      ('splat_p', r'void pow_splat_rows\('),
                      ('splat_m', r'float mimo_splat\('),
                      ('splat_s', r'float mimo_stage\('),
                      ('elem', r'for \(int e = 0; e < cfg\.n_elem; \+\+e\) \{'),
                      ('elem_w', r'void mimo_warp_taps\('),
                      ('splat_g', r'void grid_splat\('),
                      ('splat_a', r'void add\(int cell, float v\) const'),
                      ('phase', r'float echo_phase\('),
                      ('phase_f', r'float frac_cycles\('),
                      ('phase_h', r'float h_cyc\('),
                      ('phase_c', r'float conn_splat\(')):
        for i, ln in enumerate(lines, 1):
            if re.search(pat, ln):
                depth, j = 0, i
                while j <= len(lines):
                    depth += lines[j - 1].count('{') - lines[j - 1].count('}')
                    if depth == 0 and '}' in lines[j - 1]:
                        break
                    j += 1
                out[name] = (i, j)
                break
    return out


def walk_triangle_lines(tree: str) -> tuple:
    """(first, last) line of bvh::triangle in the tree's
    csrc/bvh_walk.cuh: the walk's per-triangle code (the rest of a walk
    runs once a node)."""
    path = os.path.join(os.path.dirname(source_of(tree)), 'bvh_walk.cuh')
    if not os.path.exists(path):
        return (0, -1)
    with open(path) as f:
        lines = f.read().splitlines()
    for i, ln in enumerate(lines, 1):
        if re.search(r'bool triangle\(', ln):
            depth, j = 0, i
            while j <= len(lines):
                depth += lines[j - 1].count('{') - lines[j - 1].count('}')
                if depth == 0 and '}' in lines[j - 1]:
                    break
                j += 1
            return (i, j)
    return (0, -1)


def classify(op: str) -> str:
    for name, pat in CLASSES:
        if re.search(pat, op):
            return name
    return 'other'


def source_of(tree: str) -> str:
    return os.path.join(tree, 'beifong_tpu_torch', 'csrc',
                        'receive_megakernel.cu')


def build_cubin(tree: str) -> str:
    """A cubin of the tree's receive kernel with -lineinfo and otherwise
    the library's flags (-lineinfo leaves the machine code as it is);
    ptxas's report goes to the cubin's path + '.log'.  A cubin of the same
    source and flags is reused."""
    import hashlib
    sys.path.insert(0, tree)
    from beifong_tpu_torch import _nvcc
    flags = [f for f in _nvcc.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    digest = hashlib.sha256(' '.join(flags).encode())
    for path in [source_of(tree)] + sorted(glob.glob(os.path.join(
            os.path.dirname(source_of(tree)), '*.cuh'))):
        with open(path, 'rb') as f:
            digest.update(f.read())
    cubin = os.path.join(tree, 'beifong_tpu_torch', '_build',
                         f'k1_mix_{digest.hexdigest()[:16]}.cubin')
    if os.path.exists(cubin) and os.path.exists(cubin + '.log'):
        return cubin
    os.makedirs(os.path.dirname(cubin), exist_ok=True)
    res = subprocess.run([_nvcc._nvcc(), *flags, '-cubin', '-lineinfo', '-o',
                          cubin, source_of(tree)], check=True,
                         capture_output=True, text=True)
    with open(cubin + '.log', 'w') as f:
        f.write(res.stdout + res.stderr)
    return cubin


def ptxas_of(log: str, kernel: str) -> list:
    """ptxas's lines (registers, spills) of the kernels that match the
    regex `kernel` in a build's report."""
    fn, out = '?', []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        elif re.search(kernel, fn) and ('registers' in line
                                        or 'spill' in line):
            out.append(line.strip())
    return out


def tree_geometry(tree: str, config: str) -> dict:
    """The launch geometry of a configuration's kernel in the tree (its
    own wrapper, in a process of its own): blocks a pulse, threads,
    shared bytes, and blocks and warps an SM (the card)."""
    code = f"""
import json, sys
sys.path.insert(0, {tree!r})
sys.path.insert(0, {os.path.join(HERE, 'tools')!r})
import torch, k1_mix
from beifong_tpu_torch.integrators import receive_kernel as rk
s, rx = k1_mix.scene_of({config!r})
p = rk.pack_scene(s.compile(use_bvh=False, device='cpu'), rx,
                  s.shape_index_of_endpoint('receiver', rx.id))
kw = k1_mix.ref_kw({config!r}, rx, p)
lob = {{'lobes': True}} if kw.get('lobes') else {{}}
if p.mesh is not None:
    lob.update(mesh=True, n_msh=p.msh.shape[0])
if kw.get('eoff') is not None:
    lob.update(n_elem=int(kw['eoff'].shape[0]))
if kw.get('tex') is not None:
    lob.update(tex=True)
if getattr(p, 'prims', False):
    lob.update(prims=True)
if {config!r} in k1_mix.EP_SCENES:
    import inspect
    lob = {{'ep': True}}
    if 'n_pairs' in inspect.signature(rk.launch_geometry).parameters:
        lob.update(n_tx=p.txp.shape[0], n_pairs=(p.php.shape[1] - 2) // 6,
                   n_rx_pairs=(p.rxph.shape[1] - 2) // 6
                   if kw['rx_kind'] == 'phased' else 0)
n_pulses = 64 if {config!r} == 'corner' else 1
g = rk.launch_geometry(rx.adc.n_time, k1_mix.CONFIGS[{config!r}]['lanes']
                       // n_pulses, p.prim.shape[0], p.params.shape[-1],
                       n_freq=rx.adc.n_freq,
                       doppler=kw.get('doppler', False),
                       coherent=kw.get('coherent', False)
                       or kw.get('eoff') is not None,
                       n_pulses=n_pulses, **lob)
sms = torch.cuda.get_device_properties(0).multi_processor_count
print('GEOM ' + json.dumps(dict(blocks=g[0], threads=g[1], smem=g[2],
      blocks_an_sm=g[0] * n_pulses / sms,
      warps_an_sm=g[0] * n_pulses * g[1] / 32 / sms)))
"""
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=HERE)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith('GEOM ')]
    return json.loads(line[-1][5:]) if line else {'error': res.stderr[-800:]}


def parse_functions(text: str) -> dict:
    """{function: [(opcode, [source lines of its inline chain])]} of an
    nvdisasm listing with line info (each instruction takes the '//##'
    lines above it, or its predecessor's where none are); a line of
    csrc/bvh_walk.cuh is negative (the walk's own lines, inlined at a
    line of the kernel's source)."""
    funcs, cur, chain, fresh = {}, None, [], False
    for ln in text.splitlines():
        m = re.match(r'\s*\.text\.(\S+):', ln)
        if m:
            cur, chain, fresh = m.group(1), [], False
            funcs[cur] = []
            continue
        if cur is None:
            continue
        if '//##' in ln:
            if not fresh:
                chain, fresh = [], True
            refs = re.findall(r'"([^"]*)",\s*line (\d+)', ln)
            chain = chain + ([-int(x) if f.endswith('bvh_walk.cuh')
                              else int(x) for f, x in refs] if refs else
                             [int(x) for x in re.findall(r'line (\d+)', ln)])
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;', ln)
        if m:
            ins = re.sub(r'^@!?U?P\w+\s+', '', m.group(1))
            funcs[cur].append((ins.split()[0] if ins else '', chain))
            fresh = False
    return funcs


def disassemble(cubin: str, kernel: str, out_txt: str):
    """(name, [(opcode, [source lines])]) of the kernel's instructions in
    a -lineinfo cubin (or, for a .txt, a listing saved by this function);
    its listing goes to out_txt."""
    if cubin.endswith('.txt'):
        with open(cubin) as f:
            text = f.read()
    else:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        nvd = os.path.join(home, 'bin', 'nvdisasm')
        res = subprocess.run([nvd, '-g', '-gi', '-c', cubin],
                             capture_output=True, text=True)
        if res.returncode != 0:
            res = subprocess.run([nvd, '-g', '-c', cubin],
                                 capture_output=True, text=True, check=True)
        text = res.stdout
    funcs = parse_functions(text)
    names = [k for k in funcs if re.search(kernel, k)]
    if len(names) != 1:
        raise SystemExit(f'kernel {kernel!r}: {len(names)} matches among '
                         f'{list(funcs)[:40]}')
    name = names[0]
    if out_txt != cubin:
        os.makedirs(os.path.dirname(out_txt), exist_ok=True)
        keep, on = [], False
        for ln in text.splitlines():
            if re.match(r'\s*\.text\.', ln):
                on = name in ln
            if on:
                keep.append(ln)
        with open(out_txt, 'w') as f:
            f.write('\n'.join(keep))
    return name, funcs[name]


def sass_mix(cubin: str, src: str, kernel: str, a: dict, n_rect: int,
             out_txt: str, config: str = 'flagship',
             pairs: dict | None = None) -> dict:
    """The kernel's instruction mix by stage and class, and its
    thread-instructions a lane under the stage entries `a`."""
    name, ins = disassemble(cubin, kernel, out_txt)
    ep = config in EP_SCENES
    # the Philox blocks a lane computes: the grid-stride kernel's Draws
    # cache one block, the flagship, coherent and lobe kernels' stages
    # take theirs at their start
    stride, pick = draw_stride(lobe_kw(config))
    if ep:
        phx = ep_blocks(a, pairs['n_tx'], 'endpoint' in name)
    elif 'receive_flagship_kernel' in name:
        phx = stage_blocks(a)
    elif 'receive_coherent_kernel' in name \
            or 'receive_doppler_power_kernel' in name:
        phx = stage_blocks(a, direct=True)
    elif 'receive_lobe_kernel' in name \
            or 'receive_mesh_doppler_kernel' in name:
        phx = stage_blocks(a, direct=True, stride=stride)
    elif 'receive_mesh_kernel' in name \
            or 'receive_mimo_array_kernel' in name:
        phx = stage_blocks(a, direct=True)
    else:
        phx = philox_blocks(a, CONFIGS[config]['ts'] == 'fixed', stride,
                            pick)
    stages = line_stages(src)
    helpers = func_ranges(src)
    tri = walk_triangle_lines(os.path.dirname(os.path.dirname(
        os.path.dirname(src))))

    def walk_stage(chain):
        """A BVH walk's instruction (a line of bvh_walk.cuh in its chain):
        the closest-hit walks' or the shadow walk's (by the stage of its
        site in the kernel), a triangle test's or a node's."""
        walk = [-x for x in chain if x < 0]
        if not walk:
            return None
        site = next((stages[x] for x in chain if x in stages), 'closest')
        kind = 'shadow' if site in ('shadow', 'shadow_walk') else 'walk'
        part = 'tri' if any(tri[0] <= x <= tri[1] for x in walk) else 'node'
        return f'{kind}_{part}'

    def in_helper(ln, h):
        r = helpers.get(h)
        return r is not None and r[0] <= ln <= r[1]

    def in_pairs(x):
        return in_helper(x, 'pairs') or in_helper(x, 'pairs_x') \
            or in_helper(x, 'pairs_w')

    def pair_stage(chain):
        """A cross-WDF's instruction: its copy's site (the receiver's ray,
        a direct hit, an NEE) and part (a pair's test and term, or the
        sum's set-up and, in the endpoint kernels, the index's look-up)."""
        if not any(in_pairs(x) for x in chain):
            return None
        up = next((stages[x] for x in chain if x in stages
                   and not in_pairs(x)), 'ray')
        site = 'rx' if up in ('ray', 'rx_pairs') else \
            'direct' if up == 'direct' else 'nee'
        if any(in_helper(x, 'pairs') for x in chain):
            part = 'terms' if any(in_helper(x, 'pairs_term')
                                  and in_helper(x, 'pairs_loop')
                                  for x in chain) else \
                'pairs' if any(in_helper(x, 'pairs_loop')
                               for x in chain) else 'calls'
        else:
            tag = next((stages[x] for x in chain if x in stages and (
                in_helper(x, 'pairs_x') or in_helper(x, 'pairs_w'))), None)
            part = {'pairs': 'pairs', 'pair_terms': 'terms'}.get(tag,
                                                                 'calls')
        return f'{site}_{part}'

    by = {s: {} for s in STAGES}
    rcp = dict.fromkeys(STAGES, 0)   # division sequences (MUFU.RCP) a stage
    for op, chain in ins:
        if any(in_helper(x, h) for x in chain
               for h in ('draws', 'draws_get', 'draws_flag', 'draws_coh')):
            st = 'draws'
        elif any(in_helper(x, h) for x in chain
                 for h in ('splat', 'splat_w', 'splat_c', 'splat_p',
                           'splat_g', 'splat_a')):
            st = 'splat'
        elif any(in_helper(x, h) for x in chain
                 for h in ('phase', 'phase_f', 'phase_h', 'phase_c')):
            st = 'phase'
        elif any(in_helper(x, h) for x in chain for h in ('elem', 'elem_w')):
            # MIMO: an element's term and its I / Q taps (mimo_splat's
            # loop, or the warp's items)
            st = 'elem'
        elif any(in_helper(x, h) for x in chain
                 for h in ('splat_m', 'splat_s')):
            st = 'splat'
        elif pair_stage(chain) is not None:
            st = pair_stage(chain)
        elif walk_stage(chain) is not None:
            st = walk_stage(chain)
        else:
            st = next((stages[x] for x in chain if x in stages), 'block')
            if st not in by:
                st = 'block'
        c = classify(op)
        by[st][c] = by[st].get(c, 0) + 1
        rcp[st] += op.startswith('MUFU.RCP')
    n = a['trace'].shape[0]
    z = np.zeros(1)
    # a lane's connections (each one echo phase and tent splat)
    conns = (a['nee_splat'].sum() + a['direct'].sum()) / n
    # entries of each stage a lane
    ex = {'ray': 1.0,
          'trace': a['trace'].sum() / n,
          'closest': a['trace'].sum() * n_rect / n,
          'hit': a['hit'].sum() / n,
          'direct': a['direct'].sum() / n,
          'nee': a['nee_geom'].sum() / n,
          'shadow': a['occ_tests'].sum() / n,
          'phase': conns,
          'splat': conns,
          'bounce': (a['bounce'] + a['ggx_bounce'] + a['mirror_bounce']
                     + sum(a[k] for k in LOBE_BOUNCES)).sum() / n,
          # the lobe twins: the hit's lobe f cos past the cosine test, a
          # composite's pick, the bounce's branch by lobe
          'lobe_nee': a['nee'].sum() / n,
          'pick': a['blend_pick'].sum() / n,
          'mirror': a['mirror_bounce'].sum() / n,
          'diel': a['diel_bounce'].sum() / n,
          'ggx': (a['ggx_bounce'] + a['rplas_bounce']
                  + a['rdiel_bounce']).sum() / n,
          'diffuse': (a['bounce'] + a['plas_bounce']).sum() / n,
          # the BVH walks: their set-up once a walk (the closest hit's at
          # every trace of a mesh lane, the shadow's at each NEE that
          # walks), a node's code once a slab test, a triangle's once a
          # triangle (8 a leaf entered)
          'walk': float(a['trace'].sum()) / n if 'node_ray' in a else 0.0,
          'shadow_walk': float((a.get('node_shadow', z) > 0).sum()) / n,
          'walk_node': sum(float(a.get(f'node_{w}', z).sum())
                           for w in ('ray', 'bounce')) / n,
          'walk_tri': 8.0 * sum(float(a.get(f'leaf_{w}', z).sum())
                                for w in ('ray', 'bounce')) / n,
          'shadow_node': float(a.get('node_shadow', z).sum()) / n,
          'shadow_tri': 8.0 * float(a.get('leaf_shadow', z).sum()) / n,
          # MIMO: the element loop, once an element of a connection
          'elem': float(a['mimo_elem'].sum()) / n,
          # the warp wavefront's turns for 32 lanes: one RAY, and a SHADE
          # for every 32 hits (each turn traces the rays it makes)
          'sched': (n + a['hit'].sum()) / n,
          # the grid-stride loop's own instructions, once a lane; the
          # block's set-up and row sums, once a block (none a lane)
          'lane': 1.0,
          'block': 0.0}
    # Philox: the blocks a lane computes, each one inlined copy's length
    draws_static = sum(by['draws'].values())
    copies = max(1, round(draws_static / 110))   # ~110 instructions a block
    ex['draws'] = float(phx.mean()) / copies
    # a rectangle loop the compiler unrolled holds one division (rect_hit's
    # t) a copy of its body: each copy runs for a part of the tests
    for st in ('closest', 'shadow'):
        ex[st] /= max(1, rcp[st])
    # the cross-WDFs by copy: a pair's test once a pair tested (the
    # grid-stride twins: every pair; the endpoint kernels: the pairs the
    # index visits), its term once a pair inside its footprint, the
    # set-up once a sum.  The endpoint scenes' phased arrays are the
    # receiver's or the transmitters', never both; a direct hit's sum is
    # taken as long as an NEE's
    pr = pairs or {}
    sums = pr.get('pair_sums', 0)
    per = {'pairs': pr.get('pair_visits', 0) if 'endpoint' in name
           else pr.get('pair_tests', 0),
           'terms': pr.get('pair_terms', 0), 'calls': sums}
    for k in ('rx', 'direct', 'nee'):
        for part in per:
            ex[f'{k}_{part}'] = 0.0
    d = 0.0 if pr.get('phased_ray', 0) or not sums \
        else float(min(a['direct'].sum(), sums))
    for part, v in per.items():
        if pr.get('phased_ray', 0):
            ex[f'rx_{part}'] = v / n
        elif sums:
            ex[f'direct_{part}'] = d * v / sums / n
            ex[f'nee_{part}'] = (v - d * v / sums) / n
    totals = {s: sum(v.values()) for s, v in by.items()}
    per_lane = {s: totals[s] * ex[s] for s in STAGES}
    stage_ti = sum(v for s, v in per_lane.items() if s not in BOOKKEEPING)
    cls = {}
    for s in STAGES:
        for c, k in by[s].items():
            cls[c] = cls.get(c, 0.0) + k * ex[s]
    return {'kernel': name, 'instructions': len(ins),
            'loop_copies': {st: max(1, rcp[st]) for st in ('closest',
                                                             'shadow')},
            'static_by_stage': totals, 'static_by_stage_class': by,
            'entries_a_lane': ex, 'philox_blocks_a_lane': float(phx.mean()),
            'philox_copies': copies,
            'thread_instructions_a_lane_by_stage': per_lane,
            'thread_instructions_a_lane_by_class': cls,
            'thread_instructions_a_lane': sum(per_lane.values()),
            'stage_instructions_a_lane': stage_ti,
            'bound_instructions_a_lane': min(
                stage_ti, LEAST_STAGE_INSTRUCTIONS.get(config, stage_ti)),
            'disassembly': os.path.relpath(out_txt, HERE)}


def issue_slot_bound_ms(thread_instr_a_lane: float, lanes: float,
                        clock_mhz: float, sms: int = 132) -> float:
    """The least time to issue the lanes' warp instructions (a full warp
    each) at one a cycle on each of an SM's four schedulers."""
    return lanes * thread_instr_a_lane / 32 / (sms * 4 * clock_mhz * 1e6) \
        * 1e3


def card_clock_mhz() -> tuple:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,'
                          'clocks.max.sm,clocks.sm', '--format=csv,noheader,'
                          'nounits'], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    name, limit, mx, now = [x.strip() for x in out.split(',')]
    return name, limit, float(mx), float(now)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--simt', action='store_true')
    ap.add_argument('--sass', metavar='DIR')
    ap.add_argument('--listing', help='a listing saved by --sass (in '
                    'chiprun_out/) to read instead of compiling DIR')
    ap.add_argument('--lanes', type=int, default=16, help='log2 lanes')
    ap.add_argument('--config', default='flagship', choices=tuple(CONFIGS))
    ap.add_argument('--clock-mhz', type=float, default=1980.0,
                    help="with --listing: the card's maximum SM clock")
    args = ap.parse_args()
    n = 1 << args.lanes
    cfg = CONFIGS[args.config]
    masks, n_rect = stage_masks(n, config=args.config)
    a = per_lane(masks, n)
    stride, pick = draw_stride(lobe_kw(args.config))
    pairs = pair_totals(masks)
    phx = ep_blocks(a, pairs['n_tx'], False) \
        if args.config in EP_SCENES \
        else philox_blocks(a, stride=stride, pick=pick)
    res = {'config': args.config, 'lanes': n, 'depth': cfg['depth'],
           'seed': SEED,
           'n_rect': n_rect,
           'per_lane': {k: float(v.sum()) / n for k, v in a.items()},
           'pairs_a_lane': {k: v / n for k, v in pairs.items()
                            if k != 'n_tx'},
           'philox_blocks_a_lane': float(phx.mean())}
    if args.config in MESH_CONFIGS:
        res['walks_a_lane'] = {f'{k}_{w}': float(a[f'{k}_{w}'].sum()) / n
                               for w in WALKS for k in ('node', 'leaf')}
    if args.simt:
        res['fp32_weights'] = w = stage_weights_fp32(n_rect, args.config)
        res['simt_fp32'] = simt(a, w)
        if args.config in MESH_CONFIGS:
            res['walk_simt'] = walk_simt(a, w)
        res['pool_fp32'] = pool_model(a, w)
        res['pool_fused_fp32'] = pool_model(a, w, fused=True)
    if args.sass:
        tag = os.path.basename(os.path.abspath(args.sass)) or 'tree'
        cubin = args.listing or build_cubin(args.sass)
        mix = sass_mix(cubin,
                       source_of(args.sass), cfg['kernel'], a, n_rect,
                       os.path.join(HERE, 'chiprun_out',
                                    f'k1_sass_{tag}_{args.config}.txt'),
                       args.config, pairs)
        res['sass'] = mix
        if not args.listing:
            with open(cubin + '.log') as f:
                res['ptxas'] = ptxas_of(f.read(), cfg['kernel'])
            res['geometry'] = tree_geometry(os.path.abspath(args.sass),
                                            args.config)
        name, limit, mx, now = card_clock_mhz() if not args.listing \
            else ('(listing)', '?', args.clock_mhz, args.clock_mhz)
        res['card'] = f'{name}, {limit} W, SM clock max {mx:g} MHz (now '\
                      f'{now:g})'
        res['issue_slot_bound_ms'] = issue_slot_bound_ms(
            mix['bound_instructions_a_lane'], cfg['lanes'], mx)
        # the SIMT model weighted by this kernel's own stage lengths
        st = mix['thread_instructions_a_lane_by_stage']
        ex = mix['entries_a_lane']
        per = {s: (st[s] / ex[s] if ex[s] else 0.0) for s in st}
        w = {'ray': per['ray'],
             'trace': per['trace'] + per['closest'] * n_rect,
             'hit': per['hit'], 'direct': per['direct'],
             'nee_geom': per['nee'], 'nee': 0.0,
             'occ_tests': per['shadow'],
             'nee_splat': per['splat'] + per['phase'],
             'bounce': per['bounce'] + per['diffuse'],
             'ggx_bounce': per['bounce'] + per['ggx'],
             'mirror_bounce': per['bounce'] + per['mirror'],
             'plas_nee': per['lobe_nee'], 'rplas_nee': per['lobe_nee'],
             'rdiel_nee': per['lobe_nee'], 'blend_nee': per['lobe_nee'],
             'blend_pick': per['pick'],
             'diel_bounce': per['bounce'] + per['diel'],
             'plas_bounce': per['bounce'] + per['diffuse'],
             'rplas_bounce': per['bounce'] + per['ggx'],
             'rdiel_bounce': per['bounce'] + per['ggx'],
             'pass_bounce': per['bounce'],
             'node_test': per['walk_node'],
             'leaf_test': 8.0 * per['walk_tri'],
             'mimo_elem': per['elem']}
        res['simt_sass'] = simt(a, w)
        res['pool_sass'] = pool_model(a, w)
        res['pool_fused_sass'] = pool_model(a, w, fused=True)
    print('RESULT ' + json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
