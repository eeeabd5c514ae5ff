"""Digital beamforming over MIMO channel cubes (counterpart of
`beifong_tpu/dsp/beamform.py`).

`receive_mimo` gives one complex channel an element; `develop_mimo` turns
it into a cube (E, n_time, n_freq), which these functions combine: the
conventional delay-and-sum beamformer and the adaptive MVDR (Capon) one.
They are small complex64 products and solves (E <= 8 channels), done with
`torch.einsum` and `torch.linalg.solve` on the cube's device.

Phase convention: the receive path gives element e the phase
-k (|x1 - (o + r_e)| - |x1 - o|), which for a far-field source in unit
direction d (array -> source) is +k d.r_e; the steering vector mirrors it.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x, device=None) -> torch.Tensor:
    """x as float32 on `device` (a tensor's own when None)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def ula_directions(az_rad, elevation_rad=0.0, axis=(1.0, 0.0, 0.0),
                   normal=(0.0, 0.0, 1.0), device='cpu') -> torch.Tensor:
    """Unit direction grid (A, 3) for azimuths measured from the array's
    broadside (`normal`) toward its `axis` (positive toward +axis), at
    elevation `elevation_rad` toward normal x axis."""
    ax = np.asarray(axis, np.float32)
    ax = ax / max(np.linalg.norm(ax), 1e-20)
    nn = np.asarray(normal, np.float32)
    nn = nn / max(np.linalg.norm(nn), 1e-20)
    up = np.cross(nn, ax)
    az = torch.atleast_1d(_f32(az_rad, device))
    el = torch.broadcast_to(_f32(elevation_rad, device), az.shape)
    ax_t, nn_t, up_t = (_f32(v, device) for v in (ax, nn, up))
    return (torch.sin(az)[:, None] * torch.cos(el)[:, None] * ax_t[None]
            + torch.sin(el)[:, None] * up_t[None]
            + torch.cos(az)[:, None] * torch.cos(el)[:, None] * nn_t[None])


def steering_matrix(elem_offsets, directions, freq, c) -> torch.Tensor:
    """a[A, E] = exp(+j k d_a . r_e), complex64: the per-element phase a
    far-field plane wave from direction d_a imprints on the channels."""
    d = _f32(directions)
    k = 2.0 * np.pi * freq / c
    proj = torch.einsum('aj,ej->ae', d, _f32(elem_offsets, d.device))
    return torch.exp(torch.complex(torch.zeros_like(proj), k * proj))


def delay_and_sum(cube, elem_offsets, directions, freq, c, weights=None):
    """Conventional (Bartlett) beamformer: the coherent channel sum in each
    look direction.  cube (E, n_time, n_freq) complex; directions (A, 3);
    `weights` an optional (E,) taper.  Returns (A, n_time, n_freq)."""
    a = steering_matrix(elem_offsets, _f32(directions, cube.device), freq, c)
    w = torch.conj(a)
    if weights is not None:
        w = w * _f32(weights, cube.device)[None, :]
        w = w / torch.abs(w).sum(dim=1, keepdim=True) * a.shape[1]
    return torch.einsum('ae,etf->atf', w, cube.to(w.dtype)) / a.shape[1]


def sample_covariance(cube, diag_load: float = 1e-3) -> torch.Tensor:
    """Spatial covariance R (E, E) over every (time, freq) snapshot, with
    diagonal loading relative to its mean power."""
    x = cube.reshape(cube.shape[0], -1)
    r = (x @ torch.conj(x).T) / x.shape[1]
    tr = torch.real(torch.trace(r)) / r.shape[0]
    eye = torch.eye(r.shape[0], dtype=r.dtype, device=r.device)
    return r + diag_load * torch.clamp(tr, min=1e-30) * eye


def mvdr_weights(R, a) -> torch.Tensor:
    """MVDR (Capon) weights w = R^-1 a / (a^H R^-1 a) for steering rows a
    (A, E); returns (A, E)."""
    ri_a = torch.linalg.solve(R, a.T).T
    denom = torch.einsum('ae,ae->a', torch.conj(a), ri_a)
    return ri_a / torch.clamp(torch.real(denom), min=1e-30)[:, None]


def mvdr_spectrum(cube, elem_offsets, directions, freq, c,
                  diag_load: float = 1e-3) -> torch.Tensor:
    """Capon spatial spectrum P(d) = 1 / (a^H R^-1 a), (A,) float32."""
    a = steering_matrix(elem_offsets, _f32(directions, cube.device), freq, c)
    R = sample_covariance(cube.to(a.dtype), diag_load)
    ri_a = torch.linalg.solve(R, a.T).T
    denom = torch.real(torch.einsum('ae,ae->a', torch.conj(a), ri_a))
    return 1.0 / torch.clamp(denom, min=1e-30)


def mvdr_beamform(cube, elem_offsets, directions, freq, c,
                  diag_load: float = 1e-3) -> torch.Tensor:
    """The cube beamformed with the MVDR weights of each look direction:
    (A, n_time, n_freq)."""
    a = steering_matrix(elem_offsets, _f32(directions, cube.device), freq, c)
    cube = cube.to(a.dtype)
    w = mvdr_weights(sample_covariance(cube, diag_load), a)
    return torch.einsum('ae,etf->atf', torch.conj(w), cube)
