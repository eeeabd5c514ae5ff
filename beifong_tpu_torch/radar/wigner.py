"""Wigner distribution of a rectangular antenna aperture (counterpart of
`beifong_tpu/radar/wigner.py`).

For a rectangle of physical half-widths (wx, wy) (the norms of its
to_world x and y columns; the unit rectangle spans [-1, 1]^2):

    r_hat  = to_object @ p / 2          (in [-1/2, 1/2] on the aperture)
    nu     = (s_hat . d, t_hat . d) / wavelength
    W = 4 tri(rx) tri(ry) sinc(2 pi nu_x wx tri(rx)) sinc(2 pi nu_y wy tri(ry))

The phased-array cross-WDF is ROADMAP B6.
"""

from __future__ import annotations

import torch

from ..core.math import tri, sinc, TwoPi
from ..geometry.shapes import ShapeTable, aperture_extents


def rect_aperture_gain(shapes: ShapeTable, idx, p_world, d_world,
                       wavelength):
    """WDF directional gain of rectangle rows idx (n,) at points p_world
    (n, 3) toward unit directions d_world (n, 3), wavelength (n,) [m]."""
    to_obj = shapes.to_object[idx]
    tw = shapes.to_world[idx]
    r = (torch.einsum('nij,nj->ni', to_obj[:, :3, :3], p_world)
         + to_obj[:, :3, 3]) * 0.5
    s, t = tw[:, :3, 0], tw[:, :3, 1]
    wx, wy = aperture_extents(shapes, idx)
    sn = s / torch.clamp(wx, min=1e-20)[:, None]
    tn = t / torch.clamp(wy, min=1e-20)[:, None]
    nu_x = (sn * d_world).sum(-1) / wavelength
    nu_y = (tn * d_world).sum(-1) / wavelength
    tx, ty = tri(r[:, 0]), tri(r[:, 1])
    return (4.0 * tx * ty * sinc(TwoPi * nu_x * wx * tx)
            * sinc(TwoPi * nu_y * wy * ty))


def phased_aperture_gain(*args, **kw):
    raise NotImplementedError('the phased-array cross-WDF is ROADMAP B6')
