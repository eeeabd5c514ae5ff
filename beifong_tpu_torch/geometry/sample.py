"""Uniform-area position sampling on analytic shapes, for transmitter NEE
(counterpart of `beifong_tpu/geometry/sample.py`)."""

from __future__ import annotations

import torch

from ..core import warp
from ..core.math import normalize, TwoPi
from .shapes import SPHERE, DISK, CYLINDER, ShapeTable


def _apply(m3, v):
    """m3 (n, 3, 3) @ v (n, 3), summed over columns in order."""
    p = m3 * v[:, None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def sample_position(table: ShapeTable, idx, u):
    """Uniform position on shape rows `idx` (n,) from u (n, 2).

    Returns (p_world (n, 3), n_world (n, 3), pdf_area (n,) = 1 / area,
    uv (n, 2))."""
    tw = table.to_world[idx]
    to = table.to_object[idx]
    kind = table.kind[idx]
    flip = table.flip[idx]
    zeros = torch.zeros_like(u[..., 0])

    p_rect = torch.stack([2 * u[..., 0] - 1, 2 * u[..., 1] - 1, zeros], -1)
    n_rect = torch.stack([zeros, zeros, torch.ones_like(zeros)], -1)
    d_sph = warp.square_to_uniform_sphere(u)
    pd = warp.square_to_uniform_disk_concentric(u)
    p_disk = torch.cat([pd, zeros[..., None]], -1)
    phi = TwoPi * u[..., 0]
    p_cyl = torch.stack([torch.cos(phi), torch.sin(phi), u[..., 1]], -1)
    n_cyl = torch.stack([torch.cos(phi), torch.sin(phi), zeros], -1)

    def sel(a, b, c, d):
        return torch.where((kind == SPHERE)[..., None], b,
                           torch.where((kind == DISK)[..., None], c,
                                       torch.where((kind == CYLINDER)[
                                           ..., None], d, a)))

    p_o = sel(p_rect, d_sph, p_disk, p_cyl)
    n_o = sel(n_rect, d_sph, n_rect, n_cyl)
    p_w = _apply(tw[:, :3, :3], p_o) + tw[:, :3, 3]
    n_w = normalize(_apply(to[:, :3, :3].transpose(1, 2), n_o)) \
        * flip[..., None]
    pdf = 1.0 / torch.clamp(table.surface_area[idx], min=1e-20)
    return p_w, n_w, pdf, u
