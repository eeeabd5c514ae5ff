"""Ambient media of the radar chain (counterpart of the radar part of
`beifong_tpu/media.py`).

A scene's medium models atmospheric or water-column absorption: every
path segment and every transmitter connection is attenuated by
exp(-tau), tau the optical depth along it.  Three media, each carrying
its kind (`kind`, the receive kernel's `Cfg.medium`) so nothing
downstream reads the kind off the packed scalars:

- `HomogeneousMedium`: tau = sigma_t d;
- `LayeredMedium`: sigma_t piecewise constant over K equal layers in z
  (constant outside), tau in the exact two-gather closed form
  (T(z_b) - T(z_a)) / d_z of the cumulative profile T;
- `HeterogeneousMedium`: a (D, H, W) sigma_t grid over an axis-aligned
  box (nearest cell, zero outside), tau by a 16-point midpoint
  quadrature.

Every medium holds float32 tensors on one device (`make(..., device)`,
the CPU by default, as a scene's other specs are host data);
`Scene.compile` moves it to the scene's device.  The volumetric path
tracer's distance sampling, ratio tracking and phase functions are not
ported (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

HOMOGENEOUS = 1
LAYERED = 2
GRID = 3


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _moved(medium, device):
    return dataclasses.replace(medium, **{
        f.name: getattr(medium, f.name).to(device)
        for f in dataclasses.fields(medium)})


@dataclasses.dataclass(frozen=True)
class HomogeneousMedium:
    """sigma_t: extinction [1/m]; albedo = sigma_s / sigma_t and g (the
    Henyey-Greenstein mean cosine) ride along for the volumetric tracer."""

    sigma_t: torch.Tensor
    albedo: torch.Tensor
    g: torch.Tensor
    kind = HOMOGENEOUS

    @staticmethod
    def make(sigma_t=0.0, albedo=0.0, g=0.0,
             device='cpu') -> "HomogeneousMedium":
        return HomogeneousMedium(sigma_t=_f32(sigma_t, device),
                                 albedo=_f32(albedo, device),
                                 g=_f32(g, device))

    def to(self, device) -> "HomogeneousMedium":
        return _moved(self, device)

    def transmittance(self, dist):
        return torch.exp(-self.sigma_t * dist)

    def attenuation(self, o, d, dist):
        """Transmittance along the segment o + t d, t in [0, dist)."""
        return torch.exp(-self.sigma_t * dist)


@dataclasses.dataclass(frozen=True)
class HeterogeneousMedium:
    """A (D, H, W) sigma_t grid over the box [box_min, box_max]: cell
    (iz, iy, ix) spans the box's z, y and x in D, H and W equal steps."""

    sigma_grid: torch.Tensor   # (D, H, W) extinction [1/m]
    albedo: torch.Tensor
    g: torch.Tensor
    box_min: torch.Tensor      # (3,)
    box_max: torch.Tensor      # (3,)
    majorant: torch.Tensor     # () max sigma
    kind = GRID

    @staticmethod
    def make(sigma_grid, albedo=0.5, g=0.0, box_min=(-1, -1, -1),
             box_max=(1, 1, 1), device='cpu') -> "HeterogeneousMedium":
        sg = _f32(sigma_grid, device)
        if sg.dim() != 3:
            raise ValueError(f'sigma_grid: expected (D, H, W), got '
                             f'{tuple(sg.shape)}')
        return HeterogeneousMedium(
            sigma_grid=sg, albedo=_f32(albedo, device), g=_f32(g, device),
            box_min=_f32(box_min, device), box_max=_f32(box_max, device),
            majorant=sg.max())

    def to(self, device) -> "HeterogeneousMedium":
        return _moved(self, device)

    def sigma_at(self, p):
        """Nearest-cell sigma_t at world points (n, 3); zero outside the
        box."""
        ext = self.box_max - self.box_min
        q = (p - self.box_min) / torch.clamp(ext, min=1e-12)
        inside = ((q >= 0.0) & (q <= 1.0)).all(dim=-1)
        D, H, W = self.sigma_grid.shape
        iz = torch.clamp((q[..., 2] * D).to(torch.int32), 0, D - 1).long()
        iy = torch.clamp((q[..., 1] * H).to(torch.int32), 0, H - 1).long()
        ix = torch.clamp((q[..., 0] * W).to(torch.int32), 0, W - 1).long()
        return torch.where(inside, self.sigma_grid[iz, iy, ix], 0.0)

    def optical_depth(self, o, d, dist):
        """16-point midpoint quadrature of the integral of sigma(o + t d)
        over [0, dist] (the receive kernel's `seg_tau3`): exact for a
        segment inside one cell."""
        taus = 0.0
        for i in range(16):
            t = (i + 0.5) / 16 * dist
            taus = taus + self.sigma_at(o + t[..., None] * d)
        return taus * dist / 16

    def attenuation(self, o, d, dist):
        return torch.exp(-self.optical_depth(o, d, dist))


def _sum_terms(x):
    """Sum over the last axis from left to right, the order in which the
    JAX package's reduction adds the layer terms on the CPU: a
    near-horizontal segment divides a difference of two such sums by d_z,
    so another order would move its optical depth by far more than an
    ulp."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        s = s + x[..., i]
    return s


@dataclasses.dataclass(frozen=True)
class LayeredMedium:
    """sigma_t piecewise constant over K equal-thickness layers spanning
    [z_min, z_max] (layer 0 at the bottom), constant-extended outside.
    The optical depth of a segment is exact:

        tau = (T(z_b) - T(z_a)) / d_z,   T(z) = int_{z_min}^{z} sigma dz,

    T a sum of a linear term and K - 1 ReLU steps."""

    sigma: torch.Tensor     # (K,) per-layer extinction [1/m], bottom-up
    z_min: torch.Tensor
    z_max: torch.Tensor
    albedo: torch.Tensor
    g: torch.Tensor
    kind = LAYERED

    @staticmethod
    def make(sigma, z_min=0.0, z_max=1.0, albedo=0.0, g=0.0,
             device='cpu') -> "LayeredMedium":
        sg = _f32(sigma, device)
        if sg.dim() != 1 or sg.shape[0] < 1:
            raise ValueError(f'sigma: expected (K,), got {tuple(sg.shape)}')
        return LayeredMedium(sigma=sg, z_min=_f32(z_min, device),
                             z_max=_f32(z_max, device),
                             albedo=_f32(albedo, device), g=_f32(g, device))

    def to(self, device) -> "LayeredMedium":
        return _moved(self, device)

    @property
    def n_layers(self) -> int:
        return int(self.sigma.shape[0])

    def _edges_and_steps(self):
        k = self.n_layers
        dz = (self.z_max - self.z_min) / k
        edges = self.z_min + dz * torch.arange(k, dtype=torch.float32,
                                               device=self.sigma.device)
        steps = torch.cat([self.sigma[:1], self.sigma[1:] - self.sigma[:-1]])
        return edges, steps

    def tau_z(self, z):
        """Cumulative optical depth T(z), with linear tails outside
        [z_min, z_max]."""
        edges, steps = self._edges_and_steps()
        return steps[0] * (z - edges[0]) + _sum_terms(
            steps[1:] * torch.clamp(z[..., None] - edges[1:], min=0.0))

    def sigma_at(self, p):
        """sigma_t at world points (n, 3): a function of z only."""
        edges, steps = self._edges_and_steps()
        z = p[..., 2]
        return steps[0] + _sum_terms(steps[1:] * (z[..., None] >= edges[1:]))

    def optical_depth(self, o, d, dist):
        """Exact integral of sigma along o + t d, t in [0, dist): the
        two-gather closed form, and sigma(z_a) dist for near-horizontal
        segments (|d_z| <= 1e-5)."""
        z_a = o[..., 2]
        d_z = d[..., 2]
        z_b = z_a + d_z * dist
        steep = d_z.abs() > 1e-5
        dtau = (self.tau_z(z_b) - self.tau_z(z_a)) \
            / torch.where(steep, d_z, 1.0)
        return torch.where(steep, dtau, self.sigma_at(o) * dist)

    def attenuation(self, o, d, dist):
        return torch.exp(-self.optical_depth(o, d, dist))

    @property
    def majorant(self):
        return self.sigma.max()


def atmospheric_attenuation_db_per_km(freq_hz):
    """Rough clear-air absorption of millimetre-wave radar bands [dB/km]:
    an ITU-like table through the 35 / 77 / 94 GHz windows and the 60 GHz
    oxygen line, interpolated linearly in frequency (constant beyond its
    ends)."""
    f = torch.as_tensor(freq_hz, dtype=torch.float32) / 1e9
    pts_f = torch.tensor([1., 10., 24., 35., 50., 60., 70., 77., 94., 140.,
                          220.], device=f.device)
    pts_a = torch.tensor([0.01, 0.02, 0.15, 0.1, 0.4, 15.0, 1.0, 0.35, 0.45,
                          1.5, 4.0], device=f.device)
    i = torch.clamp(torch.searchsorted(pts_f, f, right=True), 1,
                    len(pts_f) - 1)
    f0, f1 = pts_f[i - 1], pts_f[i]
    a0, a1 = pts_a[i - 1], pts_a[i]
    a = a0 + (f - f0) * (a1 - a0) / (f1 - f0)
    return torch.where(f <= pts_f[0], pts_a[0],
                       torch.where(f >= pts_f[-1], pts_a[-1], a))
