"""Texture table (counterpart of `beifong_tpu/textures.py`).

The flagship has no textures: this slice builds the one-row empty table
that scene compile and the kernel's scene pack read (the JAX package's
table for a scene without textures).  Textured BSDFs follow in ROADMAP
B7.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_C = 3
CURVE_K = 64


@dataclasses.dataclass(frozen=True)
class TextureTable:
    type: torch.Tensor        # (T,) int32
    color0: torch.Tensor      # (T, MAX_C)
    color1: torch.Tensor      # (T, MAX_C)
    scale_uv: torch.Tensor    # (T, 2)
    atlas: torch.Tensor       # (T, H, W, MAX_C)
    atlas_hw: torch.Tensor    # (T, 2) int32
    curve_ext: torch.Tensor   # (T, 2)
    curve_vals: torch.Tensor  # (T, CURVE_K)

    @staticmethod
    def empty(device) -> "TextureTable":
        def t(a):
            return torch.as_tensor(a, device=device)

        return TextureTable(
            type=t(np.zeros(1, np.int32)),
            color0=t(np.ones((1, MAX_C), np.float32)),
            color1=t(np.zeros((1, MAX_C), np.float32)),
            scale_uv=t(np.ones((1, 2), np.float32)),
            atlas=t(np.zeros((1, 1, 1, MAX_C), np.float32)),
            atlas_hw=t(np.ones((1, 2), np.int32)),
            curve_ext=t(np.zeros((1, 2), np.float32)),
            curve_vals=t(np.zeros((1, CURVE_K), np.float32)))
