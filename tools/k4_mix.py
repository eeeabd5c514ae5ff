#!/usr/bin/env python3
"""The machine code of K4, the ray / triangle kernels of
`csrc/intersect_kernels.cu`: instructions a (ray, triangle) pair, read
from the SASS listing's loops, and the issue-slot bound they give.

    python3 tools/k4_mix.py --sass DIR     (the card's machine: nvcc,
                                            cuobjdump)
    python3 tools/k4_mix.py --listing FILE (a listing saved by --sass)

--sass builds DIR's K4 library, saves `cuobjdump -sass` of it as
chiprun_out/k4_sass_<basename of DIR>.txt and prints, for each kernel, its
loops (a backward branch and its target) with their instructions by
class, and the thread-instructions of one exact test (the innermost loop
holding the IEEE reciprocal's MUFU.RCP, over the count of those) and,
where the kernel culls, of one culled triangle (the loop with the most
LDS.128, less the loops inside it, over half its LDS.128: two cull
records a triangle).  A warp issues one instruction a cycle on each of
an SM's four schedulers, so `issue_slot_bound_ms` turns a count of
thread-instructions into the least time to issue them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSES = (('fp32', r'^F(ADD|MUL|FMA|MNMX|SETP|SET|SEL|CHK)\b'),
           ('mufu', r'^MUFU\b'),
           ('shared', r'^(LDS|STS)\b'),
           ('global', r'^(LDG|STG|LD|ST)\b'),
           ('integer', r'^(I|LOP|SHF|LEA|FLO|POPC|BREV|SEL|PRMT|IMAD)'),
           ('control', r'^(BRA|BSSY|BSYNC|BAR|EXIT|CALL|RET|WARPSYNC|'
                       r'BREAK|NOP|YIELD|VOTE|SYNCS)'),
           ('move', r'^(MOV|S2R|CS2R|S2UR|R2UR|ULDC|UMOV|P2R|R2P|PLOP3)'))


def listing(lib: str) -> str:
    cuda = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return subprocess.run([os.path.join(cuda, 'bin', 'cuobjdump'), '-sass',
                           lib], capture_output=True, text=True,
                          check=True).stdout


def parse(text: str) -> dict:
    """{'closest' | 'any': [(address, opcode, instruction)]}."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r'Function : \S*ray_triangle_kernelILb([01])E', ln)
        if m:
            cur = 'any' if m.group(1) == '1' else 'closest'
            funcs[cur] = []
            continue
        if 'Function :' in ln:
            cur = None
            continue
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', ln)
        if m and cur is not None:
            ins = re.sub(r'^@!?U?P\w+\s+', '', m.group(2))
            funcs[cur].append((int(m.group(1), 16), ins.split()[0], ins))
    return funcs


def classify(ops) -> dict:
    out = {k: 0 for k, _ in CLASSES}
    out['other'] = 0
    for op in ops:
        for k, pat in CLASSES:
            if re.match(pat, op):
                out[k] += 1
                break
        else:
            out['other'] += 1
    return out


def loops(ins: list) -> list:
    """(first, last) instruction indices of each backward branch's loop."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    out = []
    for i, (a, op, txt) in enumerate(ins):
        m = re.search(r'\bBRA\b.*?(0x[0-9a-f]+)', txt)
        if op == 'BRA' and m and int(m.group(1), 16) <= a \
                and int(m.group(1), 16) in at:
            out.append((at[int(m.group(1), 16)], i))
    return sorted(set(out))


def per_pair(ins: list) -> dict:
    """Thread-instructions of one exact test and of one culled triangle
    (None where the kernel tests every pair), with the loops read."""
    found = loops(ins)
    desc = []
    for lo, hi in found:
        body = ins[lo:hi + 1]
        desc.append(dict(first=hex(ins[lo][0]), last=hex(ins[hi][0]),
                         n=len(body),
                         rcp=sum('MUFU.RCP' in t for _, _, t in body),
                         lds128=sum(t.startswith('LDS.128')
                                    for _, _, t in body),
                         classes=classify([op for _, op, _ in body])))
    out = dict(loops=desc, exact=None, cull=None)
    exact = [i for i, d in enumerate(desc) if d['rcp']]
    if not exact:
        return out
    e = min(exact, key=lambda i: desc[i]['n'])
    out['exact'] = desc[e]['n'] / desc[e]['rcp']
    # the cull loop: the one whose own LDS.128 (outside the loops inside
    # it) are the most, two a culled triangle
    best = None
    for c, (lo_c, hi_c) in enumerate(found):
        inner = {i for j, (lo, hi) in enumerate(found) if j != c
                 and lo_c <= lo and hi <= hi_c for i in range(lo, hi + 1)}
        own = [i for i in range(lo_c, hi_c + 1) if i not in inner]
        lds = sum(ins[i][2].startswith('LDS.128') for i in own)
        if lds >= 4 and (best is None or lds > best[0]):
            best = (lds, len(own))
    if best is not None:
        out['cull'] = best[1] / (best[0] / 2)
    return out


def issue_slot_bound_ms(thread_instructions: float, clock_mhz: float,
                        sms: int = 132) -> float:
    """The least time to issue the thread-instructions as full warps, one
    a cycle on each of an SM's four schedulers."""
    return thread_instructions / 32 / (sms * 4 * clock_mhz * 1e6) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sass', metavar='DIR')
    ap.add_argument('--listing', metavar='FILE')
    args = ap.parse_args()
    if args.listing:
        with open(args.listing) as f:
            text = f.read()
    elif args.sass:
        tree = os.path.abspath(args.sass)
        sys.path.insert(0, tree)
        from beifong_tpu_torch.geometry import intersect_kernel as ik
        info = ik.build_library()
        for ln in info.log.splitlines():   # empty where it was built before
            if 'entry function' in ln or 'registers' in ln or 'spill' in ln:
                print('ptxas ' + ln.strip())
        text = listing(info.path)
        out = os.path.join(HERE, 'chiprun_out',
                           f'k4_sass_{os.path.basename(tree)}.txt')
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, 'w') as f:
            f.write(text)
        print(f'listing: {out}')
    else:
        ap.error('--sass DIR or --listing FILE')
    for name, ins in parse(text).items():
        res = per_pair(ins)
        print(f'{name}: {len(ins)} instructions; exact test '
              f'{res["exact"]} thread-instructions, culled triangle '
              f'{res["cull"]}')
        for d in res['loops']:
            print('  loop ' + json.dumps(d))
    return 0


if __name__ == '__main__':
    sys.exit(main())
