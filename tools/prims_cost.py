#!/usr/bin/env python3
"""What the flagship's prims twins cost on the all-rectangle flagship
scene, and what the texture codes add: receive_flagship_kernel<false,
false> (the rectangle kernel), <false, true> (the prims twin, which an
untextured scene of spheres, disks or cylinders launches) and <true,
true> (the twin that also carries the texture codes, which a textured
one launches; here handed a texel buffer of no texture, so that it runs
the same scene).

Run from the repository root on the card's machine:

    python3 tools/prims_cost.py [--rounds 8] [--no-clock]

It times with CUDA events, in one process, the plate at 2^28 Philox
lanes, depth 3, through the three kernels in rounds whose order rotates,
after a warm-up, and prints one line `COST {json}`: each kernel's median
and its ratio to the rectangle kernel's, with the card's name and power
limit.  Unless --no-clock, it then runs tools/k1_clock.py on this tree
(flagship, flagship_prims and flagship_prims_tex, one build): each part's
share of the warps' cycles and the warp cycles a lane, `CLK {json}` a
kernel, to show where the twins' extra cycles go.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 1 << 28
DEPTH = 3
CALLS = 3            # timed calls a kernel a round
KERNELS = ('rectangle', 'prims', 'prims_tex')


def blank_texels(rk, n_prims: int, dev) -> dict:
    """A texel buffer of no texture (the keywords that launch the prims
    twin with the texture codes on an untextured scene)."""
    import torch
    return dict(tex=torch.zeros((8, rk.TEX_LANE), dtype=torch.float32,
                                device=dev),
                bmp_meta=torch.tensor([[-1, 0, 0]] * n_prims,
                                      dtype=torch.int32, device=dev),
                textured=True)


def main() -> int:
    argv = sys.argv[1:]
    rounds = int(argv[argv.index('--rounds') + 1]) \
        if '--rounds' in argv else 8
    sys.path.insert(0, HERE)
    import torch
    from beifong_tpu_torch import scenes
    from beifong_tpu_torch.integrators import receive_kernel as rk
    dev = torch.device('cuda')
    s, rx = scenes.flagship_scene()
    tab = rk._device_tables(s, s.compile(device='cpu'), rx, dev)
    kw = dict(adc=rx.adc, max_depth=DEPTH, time_sampling='gate',
              rx_kind='wigner', n_lanes=LANES, seed=7)
    extra = {'rectangle': dict(prims=False), 'prims': dict(prims=True),
             'prims_tex': dict(prims=True, **blank_texels(
                 rk, int(tab.prim.shape[0]), dev))}
    launched = {'rectangle': lambda: not rk.launched_prim_kernel(False)
                and not rk.launched_prim_kernel(False, True),
                'prims': lambda: rk.launched_prim_kernel(False),
                'prims_tex': lambda: rk.launched_prim_kernel(False, True)}

    def call(k):
        return rk.receive_megakernel(tab.params, tab.prim, tab.txp,
                                     **extra[k], **kw)

    grids = {}
    for k in KERNELS:
        grids[k] = call(k)[0]
        torch.cuda.synchronize()
        if not launched[k]():
            raise SystemExit(f'{k}: the launch record shows another kernel')
    ms = {k: [] for k in KERNELS}
    for r in range(rounds):
        for k in KERNELS[r % 3:] + KERNELS[:r % 3]:
            for _ in range(CALLS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call(k)
                b.record()
                torch.cuda.synchronize()
                ms[k].append(a.elapsed_time(b))
    med = {k: statistics.median(v) for k, v in ms.items()}
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    scale = float(grids['rectangle'].abs().max())
    print('COST ' + json.dumps({
        'card': card, 'lanes': LANES, 'depth': DEPTH,
        'calls_each': rounds * CALLS,
        'ms': med, 'ratio': {k: med[k] / med['rectangle'] for k in KERNELS},
        'grid_diff_of_max': {k: float((grids[k] - grids['rectangle'])
                                      .abs().max()) / scale
                             for k in KERNELS[1:]}}), flush=True)
    if '--no-clock' in argv:
        return 0
    res = subprocess.run([sys.executable,
                          os.path.join(HERE, 'tools', 'k1_clock.py'), HERE,
                          '--config', 'flagship,flagship_prims,'
                          'flagship_prims_tex'],
                         capture_output=True, text=True)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-2000:])
    return res.returncode


if __name__ == '__main__':
    sys.exit(main())
