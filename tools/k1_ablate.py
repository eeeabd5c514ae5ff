#!/usr/bin/env python3
"""Ablation trees of the receive megakernel (K1) for paired timing: a copy
of a checkout's `beifong_tpu_torch` under `_archive/NAME/` (ignored by
git) with one named edit of
`csrc/receive_megakernel.cu`, to time against the unedited tree with
`tools/tree_ab.py --other TREE --this _archive/NAME --only ...`.

Run from the repository root:

    python3 tools/k1_ablate.py TREE NAME [NAME ...]

Each NAME is one of ABLATIONS; each edit is exact text that must appear
once in TREE's source.  The edits of the grid-stride lobe twins
(receive_doppler_kernel<..., LOB>, the parent of receive_lobe_kernel):
  no_splat     the splat's atomics skipped (its tent arithmetic kept: a
               grid whose two pointers never meet returns first);
  hash         Philox4x32 with one round in place of ten (a cheap hash:
               every draw moves, the work a lane does hardly);
  draws_false  Draws<false> (the pulse read at each draw, as the
               flagship's grid-stride kernel did);
  lb3, lb5, lb6  the Doppler family's launch bounds (128, 3 / 5 / 6) in
               place of (128, 4);
  phase0       the echo phase 0 (I / Q twins: no phase arithmetic);
and of receive_lobe_kernel:
  lob_lb5, lob_lb6  its blocks an SM, 5 / 6 in place of 4;
  lob_mixed    its SHADE turns of mixed kinds (no turn by kind);
and, no ablation, `tags`: the stage tags of trace_lane's lobe path added
to a parent that predates them (comments only: its machine code is the
parent's), for tools/k1_mix.py --sass.
"""

from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ABLATIONS = {
    'no_splat': ((
        '''    __device__ void add(int cell, float v) const {
        if (v == 0.0f) return;
        if (s != nullptr)''',
        '''    __device__ void add(int cell, float v) const {
        if (v == 0.0f || (const void*)s == (const void*)g) return;
        if (s != nullptr)'''),),
    'hash': (('    for (int r = 0; r < 10; ++r) {',
              '    for (int r = 0; r < 1; ++r) {'),),
    'draws_false': (('Draws<DOP>& dr,', 'Draws<false>& dr,'),
                    ('    Draws<DOP> dr;', '    Draws<false> dr;')),
    'phase0': ((
        '''    if constexpr (COH) {
        float ph = echo_phase(tx.w, lo, cfg, sp, dtot, t_emit, t_recv, k_pri);''',
        '''    if constexpr (COH) {
        float ph = 0.0f;'''),),
}
# the stage tags of trace_lane's lobe path, as comments: a parent that
# predates them gets the SASS mix by stage of tools/k1_mix.py --sass
ABLATIONS['tags'] = (
    ('                if constexpr (LOB) {\n'
     '                    // the hit\'s lobe; a composite\'s mix',
     '                if constexpr (LOB) {\n'
     '                    // [k1 stage: lobe_nee]\n'
     '                    // the hit\'s lobe; a composite\'s mix'),
    ('                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;\n'
     '                    }\n'
     '                } else if (is_ggx) {',
     '                        f_cos = wmx * f_cos + (1.0f - wmx) * f1;\n'
     '                    }\n'
     '                    // [k1 stage: nee]\n'
     '                } else if (is_ggx) {'),
    ('            bool pass = false;\n            if (wmx < 1.0f',
     '            bool pass = false;\n            // [k1 stage: pick]\n'
     '            if (wmx < 1.0f'),
    ('                kk = r1[32];\n            }\n            float face',
     '                kk = r1[32];\n            }\n'
     '            // [k1 stage: bounce]\n            float face'),
    ('            } else if (cfg.mirror && kb == CONDUCTOR) {\n'
     '                float dn',
     '            } else if (cfg.mirror && kb == CONDUCTOR) {\n'
     '                // [k1 stage: mirror]\n                float dn'),
    ('            } else if (kb == DIELECTRIC || kb == THIN_DIELECTRIC) {\n'
     '                // the Fresnel',
     '            } else if (kb == DIELECTRIC || kb == THIN_DIELECTRIC) {\n'
     '                // [k1 stage: diel]\n                // the Fresnel'),
    ('                       || kb == ROUGH_DIELECTRIC) {\n'
     '                // the GGX half vector',
     '                       || kb == ROUGH_DIELECTRIC) {\n'
     '                // [k1 stage: ggx]\n'
     '                // the GGX half vector'),
    ('            } else {\n'
     '                // the cosine hemisphere: diffuse, and',
     '            } else {\n                // [k1 stage: diffuse]\n'
     '                // the cosine hemisphere: diffuse, and'),
    ('            if (!(w_b > 0.0f)) break;                   // absorbed\n'
     '            // direct hits',
     '            // [k1 stage: bounce]\n'
     '            if (!(w_b > 0.0f)) break;                   // absorbed\n'
     '            // direct hits'))
for _n in (3, 5, 6):
    ABLATIONS[f'lb{_n}'] = ((
        '__global__ void __launch_bounds__(DOP_THREADS, 4)\n'
        'receive_doppler_kernel(',
        f'__global__ void __launch_bounds__(DOP_THREADS, {_n})\n'
        'receive_doppler_kernel('),)
for _n in (5, 6):
    ABLATIONS[f'lob_lb{_n}'] = (('constexpr int LOB_MIN_BLOCKS = 4;',
                                 f'constexpr int LOB_MIN_BLOCKS = {_n};'),)
# the lobe kernel's SHADE turns of mixed kinds (no turn of 32 paths on the
# transmitter or 32 off it: the parent's slot order)
ABLATIONS['lob_mixed'] = (
    ('        if (shade && n_sh - n_tx >= 32) {',
     '        if (shade && n_sh - n_tx >= 32 && false) {'),
    ('        } else if (shade && n_tx >= 32) {',
     '        } else if (shade && n_tx >= 32 && false) {'))


def make(tree: str, name: str) -> str:
    """_archive/NAME: TREE's package with the ablation's edits."""
    dst = os.path.join(HERE, '_archive', name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, 'beifong_tpu_torch'),
                    os.path.join(dst, 'beifong_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    src = os.path.join(dst, 'beifong_tpu_torch', 'csrc',
                       'receive_megakernel.cu')
    with open(src) as f:
        s = f.read()
    for old, new in ABLATIONS[name]:
        if s.count(old) != 1:
            raise SystemExit(f'{name}: edit not found once: {old[:60]!r}')
        s = s.replace(old, new)
    with open(src, 'w') as f:
        f.write(s)
    return dst


def main() -> int:
    if len(sys.argv) < 3 or not set(sys.argv[2:]) <= set(ABLATIONS):
        raise SystemExit(f'usage: k1_ablate.py TREE NAME..., NAME among '
                         f'{sorted(ABLATIONS)}')
    tree = os.path.abspath(sys.argv[1])
    for name in sys.argv[2:]:
        print(make(tree, name))
    return 0


if __name__ == '__main__':
    sys.exit(main())
