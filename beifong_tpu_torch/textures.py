"""Textures: their constructors, the texture table and its lookup
(counterpart of `beifong_tpu/textures.py`).

`TextureSpec`s come from `constant`, `checkerboard`, `bitmap`,
`spectrum_curve` and `mesh_attribute`; `Scene.compile` flattens them into
a `TextureTable` (`TextureTable.build`; one empty row without textures),
which `texture_eval` reads per lane.  Bitmaps share one atlas padded to the
largest bitmap; a mesh-attribute texture keeps its per-face values apart
(`face_attr`, one such texture a scene).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

CONSTANT = 0
CHECKERBOARD = 1
BITMAP = 2
MESH_ATTRIBUTE = 3
SPECTRUM_CURVE = 4

MAX_C = 3
CURVE_K = 64     # spectral curves are resampled onto this regular grid


@dataclasses.dataclass
class TextureSpec:
    id: str
    type: int
    color0: np.ndarray
    color1: np.ndarray = None
    scale_uv: tuple = (1.0, 1.0)
    data: Optional[np.ndarray] = None   # (H, W, 3) for bitmaps
    curve_lo: float = 0.0               # SPECTRUM_CURVE grid extent [m]
    curve_hi: float = 0.0
    curve: Optional[np.ndarray] = None  # (CURVE_K,) regular samples
    face_values: Optional[np.ndarray] = None   # (F, 3) MESH_ATTRIBUTE


def _c(v) -> np.ndarray:
    a = np.asarray(v, np.float32).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, MAX_C)
    return a


def constant(id, value=1.0) -> TextureSpec:
    return TextureSpec(id=id, type=CONSTANT, color0=_c(value))


def checkerboard(id, color0=0.4, color1=0.2,
                 scale_uv=(1.0, 1.0)) -> TextureSpec:
    """color0 on the cells whose floor(u) + floor(v) is even, color1 on
    the others, uv scaled by `scale_uv`."""
    return TextureSpec(id=id, type=CHECKERBOARD, color0=_c(color0),
                       color1=_c(color1), scale_uv=scale_uv)


def bitmap(id, data, scale_uv=(1.0, 1.0)) -> TextureSpec:
    """An (H, W) or (H, W, 3) image, looked up nearest-texel at the scaled
    uv's fraction."""
    d = np.asarray(data, np.float32)
    if d.ndim == 2:
        d = np.repeat(d[..., None], MAX_C, -1)
    return TextureSpec(id=id, type=BITMAP, color0=_c(1.0), data=d,
                       scale_uv=scale_uv)


def spectrum_curve(id, wavelengths=None, values=None, lambda_min=None,
                   lambda_max=None, band=None) -> TextureSpec:
    """A wavelength-dependent value: `values` regular on [lambda_min,
    lambda_max], or at the given `wavelengths` (linear between them), in
    metres; either is resampled onto CURVE_K regular points, and reads 0
    outside its extent.  `color0`, the value a lookup without a
    wavelength gives, is the curve's mean over `band` (a
    `core.config.Band`; the overlap's mean times the share of the band it
    covers) or, without a band, the mean of the resampled points."""
    if wavelengths is not None:
        wl = np.asarray(wavelengths, np.float64)
        v = np.asarray(values, np.float64)
        order = np.argsort(wl)
        wl, v = wl[order], v[order]
        lo, hi = float(wl[0]), float(wl[-1])
    else:
        v = np.asarray(values, np.float64)
        lo, hi = float(lambda_min), float(lambda_max)
        wl = np.linspace(lo, hi, v.size)
    if hi <= lo:                       # one point: a tiny flat segment
        hi = lo + max(abs(lo), 1.0) * 1e-6
    grid = np.linspace(lo, hi, CURVE_K)
    cv = np.interp(grid, wl, v).astype(np.float32)
    if band is not None:
        blo, bhi = band.wavelength_min, band.wavelength_max
        glo, ghi = max(lo, blo), min(hi, bhi)
        if ghi > glo:
            xs = np.linspace(glo, ghi, 257)
            ys = np.interp(xs, wl, v)
            mean = float(((ys[1:] + ys[:-1]) * 0.5 * np.diff(xs)).sum()
                         / (ghi - glo))
            mean *= (ghi - glo) / (bhi - blo)
        else:
            mean = 0.0
    else:
        mean = float(cv.mean())
    return TextureSpec(id=id, type=SPECTRUM_CURVE, color0=_c(mean),
                       curve_lo=lo, curve_hi=hi, curve=cv)


def mesh_attribute(id, values) -> TextureSpec:
    """Per-face values (F,) or (F, C) in the scene's concatenated triangle
    order: a lookup reads the hit triangle's row."""
    v = np.asarray(values, np.float32)
    if v.ndim == 1:
        v = np.repeat(v[:, None], MAX_C, 1)
    return TextureSpec(id=id, type=MESH_ATTRIBUTE, color0=_c(1.0),
                       face_values=v)


@dataclasses.dataclass(frozen=True)
class TextureTable:
    type: torch.Tensor        # (T,) int32
    color0: torch.Tensor      # (T, MAX_C)
    color1: torch.Tensor      # (T, MAX_C)
    scale_uv: torch.Tensor    # (T, 2)
    atlas: torch.Tensor       # (T, H, W, MAX_C)
    atlas_hw: torch.Tensor    # (T, 2) int32 each bitmap's (h, w)
    curve_ext: torch.Tensor   # (T, 2) a curve's [lo, hi] [m]
    curve_vals: torch.Tensor  # (T, CURVE_K)
    face_attr: Optional[torch.Tensor] = None   # (F, MAX_C) per-face values
    face_attr_row: Optional[int] = None        # the row that reads them

    @staticmethod
    def build(specs: list, device) -> "TextureTable":
        """The table of `specs` on `device` (one row of a constant 1
        without specs)."""
        n = max(len(specs), 1)
        typ = np.zeros(n, np.int32)
        c0 = np.ones((n, MAX_C), np.float32)
        c1 = np.zeros((n, MAX_C), np.float32)
        suv = np.ones((n, 2), np.float32)
        hs = [s.data.shape[0] for s in specs if s.data is not None]
        ws = [s.data.shape[1] for s in specs if s.data is not None]
        H, W = (max(hs), max(ws)) if hs else (1, 1)
        atlas = np.zeros((n, H, W, MAX_C), np.float32)
        hw = np.ones((n, 2), np.int32)
        cext = np.zeros((n, 2), np.float32)
        cvals = np.zeros((n, CURVE_K), np.float32)
        face_attr = face_row = None
        for i, s in enumerate(specs):
            typ[i] = s.type
            c0[i] = s.color0
            c1[i] = s.color1 if s.color1 is not None else 0.0
            suv[i] = s.scale_uv
            if s.data is not None:
                h, w = s.data.shape[:2]
                atlas[i, :h, :w] = s.data
                hw[i] = (h, w)
            if s.curve is not None:
                cext[i] = (s.curve_lo, s.curve_hi)
                cvals[i] = s.curve
            if s.face_values is not None:
                face_attr = torch.as_tensor(s.face_values, device=device)
                face_row = i

        def t(a):
            return torch.as_tensor(a, device=device)

        return TextureTable(type=t(typ), color0=t(c0), color1=t(c1),
                            scale_uv=t(suv), atlas=t(atlas), atlas_hw=t(hw),
                            curve_ext=t(cext), curve_vals=t(cvals),
                            face_attr=face_attr, face_attr_row=face_row)

    @staticmethod
    def empty(device) -> "TextureTable":
        """The table of a scene without textures."""
        return TextureTable.build([], device)


def texture_eval(table: TextureTable, idx, uv, prim_idx=None, wl=None):
    """Texture values (n, C) of rows idx (n,) at uv (n, 2); idx = -1 gives
    1.0.  `prim_idx` (n,), the hit triangle (-1 none), feeds a
    MESH_ATTRIBUTE row; `wl` (n,) wavelengths [m] feed SPECTRUM_CURVE rows
    (without it a curve row gives its band-mean color0)."""
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
    if table.face_attr is not None and prim_idx is not None:
        f = table.face_attr[torch.clamp(prim_idx.long(), 0,
                                        table.face_attr.shape[0] - 1)]
        attr = (typ == MESH_ATTRIBUTE) & (prim_idx >= 0)
        out = torch.where(attr[..., None], f, out)
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
