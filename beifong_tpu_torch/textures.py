"""Texture table and its lookup (counterpart of `beifong_tpu/textures.py`).

`Scene.compile` builds the one-row empty table of a scene without
textures; `texture_eval` reads any table, such as one carried over from
the JAX package by `interop`.  The texture constructors and mesh-attribute
textures follow in ROADMAP B7.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CONSTANT = 0
CHECKERBOARD = 1
BITMAP = 2
MESH_ATTRIBUTE = 3
SPECTRUM_CURVE = 4

MAX_C = 3
CURVE_K = 64     # spectral curves are resampled onto this regular grid


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


def texture_eval(table: TextureTable, idx, uv, wl=None):
    """Texture values (n, C) of rows idx (n,) at uv (n, 2); idx = -1 gives
    1.0.  `wl` (n,) wavelengths [m] feed SPECTRUM_CURVE rows (without it a
    curve row gives its band-mean color0)."""
    i = torch.clamp(idx, min=0).long()
    typ = table.type[i]
    u = uv * table.scale_uv[i]
    cell = (torch.floor(u[..., 0]).long() + torch.floor(u[..., 1]).long()) % 2
    chk = torch.where((cell == 0)[..., None], table.color0[i],
                      table.color1[i])
    # bitmap: nearest texel
    hw = table.atlas_hw[i].long()
    px = torch.minimum(torch.clamp(
        (torch.remainder(u[..., 0], 1.0) * hw[..., 1]).long(), min=0),
        hw[..., 1] - 1)
    py = torch.minimum(torch.clamp(
        (torch.remainder(u[..., 1], 1.0) * hw[..., 0]).long(), min=0),
        hw[..., 0] - 1)
    bmp = table.atlas[i, py, px]
    out = torch.where((typ == CHECKERBOARD)[..., None], chk,
                      torch.where((typ == BITMAP)[..., None], bmp,
                                  table.color0[i]))
    if wl is not None:
        lo, hi = table.curve_ext[i, 0], table.curve_ext[i, 1]
        x = (wl - lo) / torch.clamp(hi - lo, min=1e-30) * (CURVE_K - 1)
        inb = (x >= 0.0) & (x <= CURVE_K - 1) & (hi > lo)
        xc = torch.clamp(x, 0.0, CURVE_K - 1)
        x0 = torch.clamp(xc.long(), 0, CURVE_K - 2)
        fr = xc - x0
        v = (table.curve_vals[i, x0] * (1.0 - fr)
             + table.curve_vals[i, x0 + 1] * fr)
        v = torch.where(inb, v, 0.0)
        out = torch.where((typ == SPECTRUM_CURVE)[..., None], v[..., None],
                          out)
    return torch.where((idx >= 0)[..., None], out, 1.0)
