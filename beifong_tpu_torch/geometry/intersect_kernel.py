"""Brute-force ray / triangle intersection on Hopper: the plain PyTorch
version and the wrappers of the CUDA kernel in `csrc/intersect_kernels.cu`
(counterpart of `beifong_tpu/geometry/pallas_intersect.py`, K4).

`ray_triangle_closest(o, d, v0, e1, e2)` returns the closest hit of (R, 3)
rays over a (T, 3) triangle soup: t (+inf on a miss), the face index
(int32, -1 on a miss) and u, v (0 on a miss); `ray_triangle_any(..., maxt)`
is True where that t is below maxt (1 - 1e-3).  tmin is 1e-4 and the
determinant threshold 1e-12, fixed as in the TPU kernel.  The lowest index
wins a tie.

The plain version is also the eager wavefront's dense triangle test: it
runs the JAX package's `intersect.triangle_ts` arithmetic over tiles of at
most CHUNK_F triangles and a bounded number of rays, keeping a running
(t, index, u, v) minimum, as `intersect._triangle_closest_chunked` does.
Tensors on the CPU take it; tensors on a card launch the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _nvcc

CHUNK_F = 2048          # triangles per tile of the plain version
_PAIRS = 1 << 23        # (ray, triangle) pairs per tile of the plain version
_SHADOW_EPS = 1.0 - 1e-3


def moller_trumbore(o, d, v0, e1, e2):
    """(det, u, v, t) of every (ray, triangle) pair, (R, F) each, with the
    TPU kernel's operations in its order (sums left to right)."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = (v0[None, :, k] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return det, u, v, t


def is_hit(det, u, v, t):
    """The TPU kernel's hit test on `moller_trumbore`'s output."""
    return ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-4))


def ray_triangle_closest_ref(o, d, v0, e1, e2):
    """Plain version of K4's closest hit (see the module docstring)."""
    n, n_tris = int(o.shape[0]), int(v0.shape[0])
    t_out = torch.full((n,), float('inf'), dtype=torch.float32,
                       device=o.device)
    idx_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_out = torch.zeros(n, dtype=torch.float32, device=o.device)
    v_out = torch.zeros(n, dtype=torch.float32, device=o.device)
    step = max(1, _PAIRS // max(min(n_tris, CHUNK_F), 1))
    for r0 in range(0, n, step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        rows = torch.arange(int(oc.shape[0]), device=o.device)
        best_t = t_out[r0:r0 + step]
        best_i = idx_out[r0:r0 + step]
        best_u = u_out[r0:r0 + step]
        best_v = v_out[r0:r0 + step]
        for f0 in range(0, n_tris, CHUNK_F):
            f1 = min(f0 + CHUNK_F, n_tris)
            det, u, v, t = moller_trumbore(oc, dc, v0[f0:f1], e1[f0:f1],
                                           e2[f0:f1])
            t = torch.where(is_hit(det, u, v, t), t, float('inf'))
            j = torch.argmin(t, dim=1)
            tj = t[rows, j]
            better = tj < best_t
            best_t.copy_(torch.where(better, tj, best_t))
            best_i.copy_(torch.where(better, (j + f0).to(torch.int32),
                                     best_i))
            best_u.copy_(torch.where(better, u[rows, j], best_u))
            best_v.copy_(torch.where(better, v[rows, j], best_v))
    return t_out, idx_out, u_out, v_out


def ray_triangle_any_ref(o, d, v0, e1, e2, maxt):
    """Plain version of K4's shadow test: closest hit, then t < maxt
    (1 - 1e-3)."""
    t, _, _, _ = ray_triangle_closest_ref(o, d, v0, e1, e2)
    return t < maxt * _SHADOW_EPS


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ik_closest_launch.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp, vp,
                                      vp, vp, vp]
    lib.ik_closest_launch.restype = i32
    lib.ik_any_launch.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, vp, vp]
    lib.ik_any_launch.restype = i32
    lib.ik_shared_bytes.argtypes = [i32]
    lib.ik_shared_bytes.restype = i32


LIBRARY = _nvcc.Library('intersect_kernels', 'ik', _bind)


def build_library() -> _nvcc.BuildInfo:
    return _nvcc.build('intersect_kernels')


def shared_bytes(n_tris: int) -> int:
    """Dynamic shared memory a block of either kernel asks for over a soup
    of n_tris triangles."""
    return int(LIBRARY.get().ik_shared_bytes(n_tris))


def _check(tensors: dict):
    dev = tensors['o'].device
    n = int(tensors['o'].shape[0])
    n_tris = int(tensors['v0'].shape[0])
    for name, t in tensors.items():
        shape = {'maxt': (n,), 'v0': (n_tris, 3), 'e1': (n_tris, 3),
                 'e2': (n_tris, 3)}.get(name, (n, 3))
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name}: expected contiguous float32 {shape} '
                             f'on {dev}, got {t.dtype} {tuple(t.shape)} on '
                             f'{t.device}')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'no ray / triangle kernel for device {dev}')
    if max(n, n_tris) >= 2 ** 31 // 3:
        raise ValueError(f'{n} rays / {n_tris} triangles: the kernel '
                         'indexes them with int32')
    return dev, n, n_tris


def ray_triangle_closest(o, d, v0, e1, e2):
    """Closest hit of (R, 3) rays over (T, 3) triangles: (t, face index
    int32, u, v).  Tensors on the CPU run the plain version; on a card,
    K4."""
    dev, n, n_tris = _check(dict(o=o, d=d, v0=v0, e1=e1, e2=e2))
    if dev.type == 'cpu':
        return ray_triangle_closest_ref(o, d, v0, e1, e2)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        t = torch.empty(n, dtype=torch.float32, device=dev)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        err = lib.ik_closest_launch(
            o.data_ptr(), d.data_ptr(), v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), n, n_tris, t.data_ptr(), idx.data_ptr(),
            u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        LIBRARY.check(err, 'ray_triangle_closest launch')
    ray_triangle_closest.launches += 1
    return t, idx, u, v


ray_triangle_closest.launches = 0


def ray_triangle_any(o, d, v0, e1, e2, maxt):
    """True where a triangle blocks a (R, 3) ray before maxt (1 - 1e-3).
    Tensors on the CPU run the plain version; on a card, K4."""
    dev, n, n_tris = _check(dict(o=o, d=d, v0=v0, e1=e1, e2=e2, maxt=maxt))
    if dev.type == 'cpu':
        return ray_triangle_any_ref(o, d, v0, e1, e2, maxt)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        occ = torch.empty(n, dtype=torch.uint8, device=dev)
        err = lib.ik_any_launch(
            o.data_ptr(), d.data_ptr(), v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), maxt.data_ptr(), n, n_tris, occ.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        LIBRARY.check(err, 'ray_triangle_any launch')
    ray_triangle_any.launches += 1
    return occ.bool()


ray_triangle_any.launches = 0
