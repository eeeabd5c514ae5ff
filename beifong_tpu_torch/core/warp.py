"""Sample warping functions: unit square -> distributions on disks,
hemispheres, spheres, cones, triangles and microfacet normals, each with
its pdf (counterpart of `beifong_tpu/core/warp.py`).  `u` has shape
(..., 2); outputs keep the leading shape."""

from __future__ import annotations

import torch

from .math import Pi, TwoPi, InvPi, InvTwoPi, InvFourPi, safe_sqrt


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping (low distortion)."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    zero = (x == 0.0) & (y == 0.0)
    quad_x = x.abs() > y.abs()
    r = torch.where(quad_x, x, y)
    sx = torch.where(x.abs() > 1e-20, x, 1e-20)
    sy = torch.where(y.abs() > 1e-20, y, 1e-20)
    phi = torch.where(quad_x, (Pi / 4.0) * (y / sx),
                      (Pi / 2.0) - (Pi / 4.0) * (x / sy))
    r = torch.where(zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_concentric_pdf(p):
    inside = (p * p).sum(-1) <= 1.0
    return torch.where(inside, InvPi, 0.0)


def square_to_cosine_hemisphere(u):
    """Cosine-weighted hemisphere: concentric disk lifted onto +z."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - (p * p).sum(-1))
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * InvPi


def square_to_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TwoPi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0.0, InvTwoPi, 0.0)


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TwoPi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(d):
    return torch.full(d.shape[:-1], InvFourPi, dtype=d.dtype, device=d.device)


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction within a cone of half-angle acos(cos_cutoff)."""
    ct = (1.0 - u[..., 0]) + u[..., 0] * cos_cutoff
    st = safe_sqrt(1.0 - ct * ct)
    phi = TwoPi * u[..., 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_uniform_cone_pdf(d, cos_cutoff):
    return torch.where(d[..., 2] >= cos_cutoff,
                       InvTwoPi / max(1.0 - cos_cutoff, 1e-12), 0.0)


def square_to_uniform_triangle(u):
    t = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - t, t * u[..., 1]], dim=-1)


def square_to_beckmann(u, alpha):
    """Beckmann microfacet normal sampling."""
    phi = TwoPi * u[..., 1]
    tan2 = -alpha * alpha * torch.log(torch.clamp(1.0 - u[..., 0], min=1e-20))
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_beckmann_pdf(d, alpha):
    ct = d[..., 2]
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / torch.clamp(ct2, min=1e-20)
    a2 = alpha * alpha
    p = torch.exp(-tan2 / a2) / (Pi * a2 * torch.clamp(ct2 * ct, min=1e-20))
    return torch.where(ct > 1e-6, p, 0.0)


def square_to_ggx(u, alpha):
    """GGX / Trowbridge-Reitz microfacet normal sampling."""
    phi = TwoPi * u[..., 1]
    tan2 = alpha * alpha * u[..., 0] / torch.clamp(1.0 - u[..., 0], min=1e-20)
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_ggx_pdf(d, alpha):
    ct = d[..., 2]
    a2 = alpha * alpha
    denom = ct * ct * (a2 - 1.0) + 1.0
    p = a2 * ct / torch.clamp(Pi * denom * denom, min=1e-20)
    return torch.where(ct > 1e-6, p, 0.0)


def interval_to_tent(u):
    """[0, 1) -> tent on [-1, 1]."""
    u = 2.0 * u
    return torch.where(u < 1.0, torch.sqrt(torch.clamp(u, min=0.0)) - 1.0,
                       1.0 - torch.sqrt(torch.clamp(2.0 - u, min=0.0)))


def square_to_tent(u):
    return torch.stack([interval_to_tent(u[..., 0]),
                        interval_to_tent(u[..., 1])], dim=-1)


def square_to_tent_pdf(p):
    inside = (p[..., 0].abs() <= 1.0) & (p[..., 1].abs() <= 1.0)
    return torch.where(inside, (1.0 - p[..., 0].abs())
                       * (1.0 - p[..., 1].abs()), 0.0)
