"""Wigner distribution of a rectangular antenna aperture (counterpart of
`beifong_tpu/radar/wigner.py`).

For a rectangle of physical half-widths (wx, wy) (the norms of its
to_world x and y columns; the unit rectangle spans [-1, 1]^2):

    r_hat  = to_object @ p / 2          (in [-1/2, 1/2] on the aperture)
    nu     = (s_hat . d, t_hat . d) / wavelength
    W = 4 tri(rx) tri(ry) sinc(2 pi nu_x wx tri(rx)) sinc(2 pi nu_y wy tri(ry))

A phased array's gain is the cross-WDF: a sum over its virtual element
pairs (midpoint, baseline) of each element's rectangle WDF at the point
relative to the pair's midpoint, times the interference term
cos(2 pi nu . baseline + psi) of the pair's steering phase psi.
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


def phased_aperture_gain(elem_mid, elem_baseline, psi, pair_mask, frame_s,
                         frame_t, elem_wid, array_origin, p_world, d_world,
                         wavelength):
    """Cross-WDF gain of a phased array at points p_world (n, 3) toward
    unit directions d_world (n, 3), wavelength (n,) [m].  The array: pair
    midpoints and baselines in world offsets (K, 3), steering phases psi
    (K,), the valid-pair mask (K,), the normalised in-plane axes frame_s /
    frame_t (3,), the element half-widths elem_wid (2,) and the array
    centre (3,); each may carry a leading lane axis (n, ...).  Signed:
    the pair terms cancel."""
    fs = frame_s.unsqueeze(-2)                          # (..., 1, 3)
    ft = frame_t.unsqueeze(-2)
    rel = p_world[:, None, :] - (array_origin.unsqueeze(-2) + elem_mid)
    ws, wt = elem_wid[..., 0:1], elem_wid[..., 1:2]     # (..., 1)
    rx = (rel * fs).sum(-1) / torch.clamp(2.0 * ws, min=1e-20)
    ry = (rel * ft).sum(-1) / torch.clamp(2.0 * wt, min=1e-20)
    inside = (rx.abs() <= 0.5) & (ry.abs() <= 0.5)
    nu_x = (d_world * frame_s).sum(-1) / wavelength
    nu_y = (d_world * frame_t).sum(-1) / wavelength
    tx, ty = tri(rx), tri(ry)
    w_rect = (4.0 * ws * wt * tx * ty
              * sinc(TwoPi * nu_x[:, None] * ws * tx)
              * sinc(TwoPi * nu_y[:, None] * wt * ty))
    nu_dot = (nu_x[:, None] * (elem_baseline * fs).sum(-1)
              + nu_y[:, None] * (elem_baseline * ft).sum(-1))
    contrib = torch.where(inside & pair_mask, w_rect
                          * torch.cos(TwoPi * nu_dot + psi), 0.0)
    return contrib.sum(-1)
