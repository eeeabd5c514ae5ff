"""Build a CUDA source of `csrc/` into a shared library with a plain C
interface, and load it with ctypes (nvcc by hand: no PyTorch headers, so a
build takes seconds).

A library is rebuilt only when its source, the headers of `csrc/` or the
flags change: the file name carries their hash.  The build goes into
`_build/` beside the package, which git ignores.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')
# no --use_fast_math: expf / logf / sqrtf / division stay IEEE, as in the
# plain versions.  FMA contraction stays on (nvcc's default): it moves the
# receive kernel from its plain version by ~1e-7 of max|acc| and makes it
# 6.6% faster (tools/fmad_ab.py, PERF.md)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC', '-Xptxas',
              '-v')


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall time (0.0 when the library was there)
    log: str           # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    return path if os.path.exists(path) else 'nvcc'


def build(name: str) -> BuildInfo:
    """Compile `csrc/<name>.cu` into `_build/` unless a library built from
    the same source, headers and flags is there already."""
    source = os.path.join(CSRC, f'{name}.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, '*.cuh'))):
        with open(path, 'rb') as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f'{name}_{digest.hexdigest()[:16]}.so')
    if os.path.exists(path):
        return BuildInfo(path=path, seconds=0.0, log='')
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, source],
                         capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f'nvcc {name}.cu failed ({res.returncode}):\n'
                           f'{res.stderr}')
    os.replace(tmp, path)
    return BuildInfo(path=path, seconds=secs, log=res.stdout + res.stderr)


class Library:
    """A kernel library, built and loaded on first use.  `bind(lib)` sets
    the ctypes signatures; every library exports `<prefix>_error_string`."""

    def __init__(self, name: str, prefix: str, bind):
        self.name, self.prefix, self._bind = name, prefix, bind
        self._lock = threading.Lock()
        self._lib = None

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.name).path)
                err = getattr(lib, f'{self.prefix}_error_string')
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._bind(lib)
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str):
        if err != 0:
            msg = getattr(self.get(), f'{self.prefix}_error_string')(err)
            raise RuntimeError(f'{what}: CUDA error {err} ({msg.decode()})')
