#!/usr/bin/env python3
"""Time the receive megakernel (K1) of one checkout of the repository at a
small and a large lane count: the small call shows K1's fixed costs (the
host's share of the call, the launch, the reduce), the large one the lane
loop.

Run from the repository root, once per checkout to compare, alternating
the checkouts in turn:

    python3 tools/k1_probe.py DIR

DIR is the root of the checkout whose `beifong_tpu_torch` is imported
(this one, or a parent commit unpacked with `git archive`).  The
range-Doppler pulse and multi_body (the Doppler configuration, depth 2)
are timed at 2^10 and 2^24 lanes, the flagship (depth 3) at 2^10 and
2^26, each the median of 14 calls after a warm-up, with CUDA events
around the whole call.  Prints one line `RESULT {json}` with the ptxas
registers of the six instantiations and the reduce, and the times in ms.
"""

import inspect
import json
import os
import statistics
import sys


def cuda_ms(torch, fn, n):
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else '.')
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a card')
    import beifong_tpu_torch
    from beifong_tpu_torch.integrators import receive_kernel as rk
    from beifong_tpu_torch.scenes import (flagship_scene, multi_body_scene,
                                          range_doppler_scene)
    assert os.path.dirname(beifong_tpu_torch.__file__).startswith(root)
    dev = torch.device('cuda')
    regs = [ln.split('Used ')[1].split(' reg')[0]
            for ln in rk.build_library().log.splitlines()
            if 'registers' in ln]
    out = {'tree': os.path.basename(root), 'registers': regs}
    # a tree whose wrapper takes the mirror flag is told these scenes
    # hold no mirror (else it reads the tables back before each call)
    takes_mirror = 'mirror' in inspect.signature(
        rk.receive_megakernel).parameters
    for name, scene, depth, doppler, large in (
            ('range_doppler', range_doppler_scene, 2, True, 24),
            ('multi_body', multi_body_scene, 2, True, 24),
            ('flagship', flagship_scene, 3, False, 26)):
        s, rx = scene()
        sd = s.compile(use_bvh=False, device='cpu')
        p = rk.pack_scene(sd, rx, s.shape_index_of_endpoint('receiver',
                                                             rx.id))
        params, prim, txp = (torch.tensor(a, device=dev)
                             for a in (p.params, p.prim, p.txp))
        kw = dict(adc=rx.adc, max_depth=depth, time_sampling='gate',
                  rx_kind='wigner', seed=7)
        if doppler:
            kw['doppler'] = True
            if takes_mirror:
                kw['mirror'] = False
        if p.mesh is not None:
            params[0] = rk.seed_slot(7)
            kw.update(mesh=p.mesh.to(dev),
                      msh=torch.tensor(p.msh, device=dev))
        for lg in (10, large):
            n = 1 << lg
            if p.mesh is not None:
                kw['patch_p'] = rk.patch_p_for(n)

            def call():
                return rk.receive_megakernel(params, prim, txp, n_lanes=n,
                                             **kw)
            call()
            torch.cuda.synchronize()
            out[f'{name}_2^{lg}_ms'] = statistics.median(
                cuda_ms(torch, call, 15)[1:])
    print('RESULT ' + json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
