"""BSDF parameter tables (counterpart of `beifong_tpu/bsdf/tables.py`).

Host-side constructors build `BSDFSpec`s; `BSDFTable.build` flattens them
into one structure-of-arrays table that `bsdf/eval.py` dispatches over by
type code.  Textured reflectance and the normal / bump maps wait for the
texture constructors (ROADMAP B7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DIFFUSE = 0
CONDUCTOR = 1          # smooth mirror with complex Fresnel (delta lobe)
ROUGH_CONDUCTOR = 2    # GGX microfacet
DIELECTRIC = 3         # smooth glass (delta reflect + refract)
THIN_DIELECTRIC = 4
PLASTIC = 5            # diffuse base + smooth dielectric coat
ROUGH_PLASTIC = 6      # diffuse base + GGX coat
NULL = 7               # pass-through
MASK = 8               # opacity-weighted nested BSDF
BLEND = 9              # convex blend of two nested BSDFs
ROUGH_DIELECTRIC = 10  # GGX microfacet glass
MEASURED = 11          # tabulated isotropic BRDF (theta_i, theta_o, dphi)

MAX_C = 3  # parameter channels (rgb); mono scenes use channel 0


@dataclasses.dataclass
class BSDFSpec:
    """Host-side BSDF description."""

    id: str
    type: int
    reflectance: np.ndarray          # (MAX_C,)
    alpha: float = 0.1               # roughness
    eta: Optional[np.ndarray] = None  # (MAX_C,) real IOR (or ratio)
    k: Optional[np.ndarray] = None   # (MAX_C,) imaginary IOR / transmittance
    twosided: bool = False
    nested0: Optional[str] = None    # nested BSDF ids (mask / blend)
    nested1: Optional[str] = None
    weight: float = 0.5              # blend weight / mask opacity
    brdf_grid: Optional[np.ndarray] = None   # MEASURED only


def _c(v, default=1.0) -> np.ndarray:
    a = np.asarray(default if v is None else v, np.float32).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, MAX_C)
    if a.size != MAX_C:
        raise ValueError(f'expected 1 or {MAX_C} channels, got {a.size}')
    return a


def diffuse(id, reflectance=0.5, twosided=False) -> BSDFSpec:
    """Lambertian."""
    return BSDFSpec(id=id, type=DIFFUSE, reflectance=_c(reflectance),
                    twosided=twosided)


def conductor(id, eta=0.2, k=3.0, specular_reflectance=1.0,
              twosided=False) -> BSDFSpec:
    """Smooth conductor."""
    return BSDFSpec(id=id, type=CONDUCTOR,
                    reflectance=_c(specular_reflectance), eta=_c(eta),
                    k=_c(k), twosided=twosided)


def rough_conductor(id, alpha=0.1, eta=0.2, k=3.0, specular_reflectance=1.0,
                    twosided=False) -> BSDFSpec:
    """GGX rough conductor."""
    return BSDFSpec(id=id, type=ROUGH_CONDUCTOR,
                    reflectance=_c(specular_reflectance), alpha=float(alpha),
                    eta=_c(eta), k=_c(k), twosided=twosided)


def dielectric(id, int_ior=1.5046, ext_ior=1.000277,
               specular_reflectance=1.0,
               specular_transmittance=1.0) -> BSDFSpec:
    """Smooth dielectric; the transmittance is kept in `k`."""
    return BSDFSpec(id=id, type=DIELECTRIC,
                    reflectance=_c(specular_reflectance),
                    eta=_c(int_ior / ext_ior), k=_c(specular_transmittance),
                    twosided=True)


def rough_dielectric(id, alpha=0.1, int_ior=1.5046, ext_ior=1.000277,
                     specular_reflectance=1.0,
                     specular_transmittance=1.0) -> BSDFSpec:
    """GGX rough glass."""
    return BSDFSpec(id=id, type=ROUGH_DIELECTRIC,
                    reflectance=_c(specular_reflectance), alpha=float(alpha),
                    eta=_c(int_ior / ext_ior), k=_c(specular_transmittance),
                    twosided=True)


def thin_dielectric(id, int_ior=1.5046, ext_ior=1.000277) -> BSDFSpec:
    return BSDFSpec(id=id, type=THIN_DIELECTRIC, reflectance=_c(1.0),
                    eta=_c(int_ior / ext_ior), k=_c(1.0), twosided=True)


def plastic(id, diffuse_reflectance=0.5, int_ior=1.49, ext_ior=1.000277,
            twosided=False) -> BSDFSpec:
    return BSDFSpec(id=id, type=PLASTIC, reflectance=_c(diffuse_reflectance),
                    eta=_c(int_ior / ext_ior), twosided=twosided)


def rough_plastic(id, diffuse_reflectance=0.5, alpha=0.1, int_ior=1.49,
                  ext_ior=1.000277, twosided=False) -> BSDFSpec:
    return BSDFSpec(id=id, type=ROUGH_PLASTIC,
                    reflectance=_c(diffuse_reflectance), alpha=float(alpha),
                    eta=_c(int_ior / ext_ior), twosided=twosided)


def measured(id, brdf_grid, twosided=False) -> BSDFSpec:
    """Tabulated isotropic BRDF: `brdf_grid` (n_theta_i, n_theta_o,
    n_dphi[, C]) of f_r (without the cosine) on uniform grids theta in
    [0, pi/2], dphi in [0, pi].  One measured table per scene."""
    g = np.asarray(brdf_grid, np.float32)
    if g.ndim == 3:
        g = np.repeat(g[..., None], MAX_C, -1)
    return BSDFSpec(id=id, type=MEASURED, reflectance=_c(1.0),
                    twosided=twosided, brdf_grid=g)


def null(id='null') -> BSDFSpec:
    return BSDFSpec(id=id, type=NULL, reflectance=_c(0.0), twosided=True)


def mask(id, nested, opacity=0.5) -> BSDFSpec:
    return BSDFSpec(id=id, type=MASK, reflectance=_c(opacity),
                    nested0=nested, weight=float(opacity), twosided=True)


def blend(id, bsdf0, bsdf1, weight=0.5) -> BSDFSpec:
    return BSDFSpec(id=id, type=BLEND, reflectance=_c(weight),
                    nested0=bsdf0, nested1=bsdf1, weight=float(weight))


def normalmap(id, nested, texture):
    raise NotImplementedError('normal maps need the texture constructors '
                              '(ROADMAP A10 / B7)')


def bumpmap(id, nested, texture, scale: float = 1.0):
    raise NotImplementedError('bump maps need the texture constructors '
                              '(ROADMAP A10 / B7)')


@dataclasses.dataclass(frozen=True)
class BSDFTable:
    type: torch.Tensor          # (B,) int32
    reflectance: torch.Tensor   # (B, MAX_C)
    alpha: torch.Tensor         # (B,)
    eta: torch.Tensor           # (B, MAX_C)
    k: torch.Tensor             # (B, MAX_C)
    twosided: torch.Tensor      # (B,) bool
    texture_idx: torch.Tensor   # (B,) int32, -1: constant reflectance
    nested0: torch.Tensor       # (B,) int32, -1 none
    nested1: torch.Tensor       # (B,) int32
    weight: torch.Tensor        # (B,)
    present: tuple = ()         # type codes present in the table
    measured_grid: Optional[torch.Tensor] = None   # (Nti, Nto, Ndp, MAX_C)

    @staticmethod
    def build(specs: list[BSDFSpec], device) -> "BSDFTable":
        n = max(len(specs), 1)
        ids = {s.id: i for i, s in enumerate(specs)}

        def col(fn, shape, dtype=np.float32, fill=0):
            a = np.full((n, *shape), fill, dtype)
            for i, s in enumerate(specs):
                a[i] = fn(s)
            return torch.as_tensor(a, device=device)

        grid = next((s.brdf_grid for s in specs if s.brdf_grid is not None),
                    None)
        return BSDFTable(
            type=col(lambda s: s.type, (), np.int32),
            reflectance=col(lambda s: s.reflectance, (MAX_C,)),
            alpha=col(lambda s: max(s.alpha, 1e-3), ()),
            eta=col(lambda s: _c(s.eta, 1.5), (MAX_C,)),
            k=col(lambda s: _c(s.k, 0.0 if s.type != DIELECTRIC else 1.0),
                  (MAX_C,)),
            twosided=col(lambda s: s.twosided, (), bool),
            texture_idx=col(lambda s: -1, (), np.int32, -1),
            nested0=col(lambda s: ids.get(s.nested0, -1), (), np.int32, -1),
            nested1=col(lambda s: ids.get(s.nested1, -1), (), np.int32, -1),
            weight=col(lambda s: s.weight, ()),
            present=tuple(sorted({s.type for s in specs})),
            measured_grid=None if grid is None
            else torch.as_tensor(grid, device=device))
