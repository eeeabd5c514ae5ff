"""BSDF parameter tables (counterpart of `beifong_tpu/bsdf/tables.py`).

This slice builds diffuse BSDFs only; the type codes of the other lobes
are kept so the packed tables read the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DIFFUSE = 0
CONDUCTOR = 1
ROUGH_CONDUCTOR = 2
DIELECTRIC = 3
THIN_DIELECTRIC = 4
PLASTIC = 5
ROUGH_PLASTIC = 6
NULL = 7
MASK = 8
BLEND = 9
ROUGH_DIELECTRIC = 10
MEASURED = 11

MAX_C = 3  # parameter channels (rgb); mono scenes use channel 0


@dataclasses.dataclass
class BSDFSpec:
    """Host-side BSDF description."""

    id: str
    type: int
    reflectance: np.ndarray          # (MAX_C,)
    alpha: float = 0.1
    eta: Optional[np.ndarray] = None
    k: Optional[np.ndarray] = None
    twosided: bool = False
    weight: float = 0.5


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

    @staticmethod
    def build(specs: list[BSDFSpec], device) -> "BSDFTable":
        n = max(len(specs), 1)

        def col(fn, shape, dtype=np.float32, fill=0):
            a = np.full((n, *shape), fill, dtype)
            for i, s in enumerate(specs):
                a[i] = fn(s)
            return torch.as_tensor(a, device=device)

        return BSDFTable(
            type=col(lambda s: s.type, (), np.int32),
            reflectance=col(lambda s: s.reflectance, (MAX_C,)),
            alpha=col(lambda s: max(s.alpha, 1e-3), ()),
            eta=col(lambda s: _c(s.eta, 1.5), (MAX_C,)),
            k=col(lambda s: _c(s.k, 0.0), (MAX_C,)),
            twosided=col(lambda s: s.twosided, (), bool),
            texture_idx=col(lambda s: -1, (), np.int32, -1),
            nested0=col(lambda s: -1, (), np.int32, -1),
            nested1=col(lambda s: -1, (), np.int32, -1),
            weight=col(lambda s: s.weight, ()),
            present=tuple(sorted({s.type for s in specs})))
