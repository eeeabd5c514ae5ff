"""The triangle table of a compiled scene (counterpart of the `TriData`
part of `beifong_tpu/geometry/intersect.py`).  The analytic intersectors
of that module are ROADMAP A4."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TriData:
    """Pre-transformed triangle soup (world space), one row per face."""

    v0: torch.Tensor          # (F, 3) float32
    e1: torch.Tensor          # (F, 3) v1 - v0
    e2: torch.Tensor          # (F, 3) v2 - v0
    n: torch.Tensor           # (F, 3) geometric normal (normalised)
    shape_idx: torch.Tensor   # (F,) int32 row in the scene's shape table

    @property
    def n_faces(self) -> int:
        return int(self.v0.shape[0])
