"""Wavefront BSDF evaluation and sampling with masked type dispatch
(counterpart of `beifong_tpu/bsdf/eval.py`).

Every lobe family is computed for every lane and the per-lane type code
selects one, as in the JAX package.  Directions are in the local shading
frame (+z = normal); values include the cosine foreshortening factor.
"""

from __future__ import annotations

import torch

from ..core import warp
from ..core.math import Pi, InvPi, safe_sqrt, normalize
from .tables import (BSDFTable, DIFFUSE, CONDUCTOR, ROUGH_CONDUCTOR,
                     DIELECTRIC, THIN_DIELECTRIC, PLASTIC, ROUGH_PLASTIC,
                     NULL, MASK, BLEND, ROUGH_DIELECTRIC, MEASURED)


def _sum3(a, b):
    return (a * b).sum(-1)


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel reflectance; eta, k (..., C)."""
    c = cos_i.abs()[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rs + rp)


def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel reflectance, cos of the transmitted
    angle and the relative IOR on cos_i's side."""
    out = cos_i >= 0.0
    eta_it = torch.where(out, eta, 1.0 / eta)
    c2t = 1.0 - (1.0 - cos_i * cos_i) / (eta_it * eta_it)
    tir = c2t <= 0.0
    cos_t = safe_sqrt(c2t)
    ci = cos_i.abs()
    rs = (ci - eta_it * cos_t) / torch.clamp(ci + eta_it * cos_t, min=1e-20)
    rp = (eta_it * ci - cos_t) / torch.clamp(eta_it * ci + cos_t, min=1e-20)
    f = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return f, cos_t, eta_it


def ggx_ndf(h, alpha):
    ct = h[..., 2]
    a2 = alpha * alpha
    d = ct * ct * (a2 - 1.0) + 1.0
    return torch.where(ct > 0.0, a2 / torch.clamp(Pi * d * d, min=1e-20),
                       0.0)


def ggx_g1(v, alpha):
    ct = v[..., 2].abs()
    a2 = alpha * alpha
    t2 = (1.0 - ct * ct) / torch.clamp(ct * ct, min=1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * t2))


def _reflect(wi, h):
    return 2.0 * _sum3(wi, h)[..., None] * h - wi


def _gather(table: BSDFTable, idx):
    i = torch.clamp(idx, min=0).long()
    return dict(type=table.type[i], refl=table.reflectance[i],
                alpha=table.alpha[i], eta=table.eta[i], k=table.k[i],
                twosided=table.twosided[i], weight=table.weight[i],
                nested0=table.nested0[i], nested1=table.nested1[i])


def _resolve_nested(table: BSDFTable, idx, u):
    """One level of MASK / BLEND: (effective idx, pass-through mask).
    MASK passes straight through with probability 1 - opacity; BLEND picks
    a nested lobe by weight."""
    g = _gather(table, idx)
    is_mask = g['type'] == MASK
    is_blend = g['type'] == BLEND
    pass_through = is_mask & (u >= g['weight'])
    idx2 = torch.where(is_mask & ~pass_through, g['nested0'], idx)
    pick1 = is_blend & (u >= g['weight'])
    idx2 = torch.where(is_blend, torch.where(pick1, g['nested1'],
                                             g['nested0']), idx2)
    return idx2, pass_through


def bsdf_eval_pdf(table: BSDFTable, idx, wi, wo, refl_scale=None):
    """f(wi, wo) cos(theta_o) (n, C) and the sampling pdf (n,).  Delta
    lobes give (0, 0).  One level of BLEND evaluates both lobes; MASK
    scales its nested lobe by the opacity."""
    if table.present and not ({MASK, BLEND} & set(table.present)):
        return _eval_pdf_basic(table, idx, wi, wo, refl_scale)
    g = _gather(table, idx)
    is_blend = g['type'] == BLEND
    is_mask = g['type'] == MASK
    idx_a = torch.where(is_blend | is_mask, g['nested0'], idx)
    f_a, pdf_a = _eval_pdf_basic(table, idx_a, wi, wo, refl_scale)
    f_b, pdf_b = _eval_pdf_basic(
        table, torch.where(is_blend, g['nested1'], idx_a), wi, wo,
        refl_scale)
    w = g['weight']
    f = torch.where(is_blend[..., None],
                    w[..., None] * f_a + (1 - w[..., None]) * f_b,
                    torch.where(is_mask[..., None], w[..., None] * f_a, f_a))
    pdf = torch.where(is_blend, w * pdf_a + (1 - w) * pdf_b,
                      torch.where(is_mask, w * pdf_a, pdf_a))
    return f, pdf


def _eval_pdf_basic(table: BSDFTable, idx, wi, wo, refl_scale):
    g = _gather(table, idx)
    refl = g['refl'] if refl_scale is None else g['refl'] * refl_scale
    ci, co = wi[..., 2], wo[..., 2]
    front = (ci > 0.0) & (co > 0.0)
    # two-sided materials: flip to the upper hemisphere when hit from behind
    flip = g['twosided'] & (ci < 0.0)
    s = torch.where(flip, -1.0, 1.0)[..., None]
    wi_f, wo_f = wi * s, wo * s
    ci_f, co_f = wi_f[..., 2], wo_f[..., 2]
    both_up = (ci_f > 0.0) & (co_f > 0.0)

    # diffuse
    f_diff = refl * InvPi * torch.clamp(co_f, min=0.0)[..., None]
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_f)
    if table.present and set(table.present) <= {DIFFUSE}:
        live = torch.where(g['twosided'], both_up, front)
        return (torch.where(live[..., None], f_diff, 0.0),
                torch.where(live, pdf_diff, 0.0))

    # rough conductor (GGX)
    h = normalize(wi_f + wo_f)
    h = h * torch.sign(h[..., 2:3])
    d_ = ggx_ndf(h, g['alpha'])
    g_ = ggx_g1(wi_f, g['alpha']) * ggx_g1(wo_f, g['alpha'])
    f_c = fresnel_conductor(_sum3(wi_f, h), g['eta'], g['k'])
    denom = torch.clamp(4.0 * ci_f, min=1e-8)
    f_rc = refl * f_c * (d_ * g_ / denom)[..., None]
    doth = _sum3(wo_f, h).abs()
    pdf_rc = d_ * h[..., 2].abs() / torch.clamp(4.0 * doth, min=1e-8)

    # (rough) plastic: diffuse base (1 - F_i)(1 - F_o) + GGX coat
    fi, _, _ = fresnel_dielectric(ci_f, g['eta'][..., 0])
    fo, _, _ = fresnel_dielectric(co_f, g['eta'][..., 0])
    f_pl_diff = refl * InvPi * torch.clamp(co_f, min=0.0)[..., None] \
        * ((1.0 - fi) * (1.0 - fo))[..., None]
    fh, _, _ = fresnel_dielectric(_sum3(wi_f, h), g['eta'][..., 0])
    f_rpl = f_pl_diff + (fh * d_ * g_ / denom)[..., None]
    spec_w = torch.clamp(fi, 0.05, 0.95)
    pdf_rpl = (1 - spec_w) * pdf_diff + spec_w * pdf_rc

    # rough dielectric (GGX glass), in the unflipped frame
    eta_s = g['eta'][..., 0]
    ci_u, co_u = wi[..., 2], wo[..., 2]
    same_side = ci_u * co_u > 0.0
    eta_it_u = torch.where(ci_u > 0.0, eta_s, 1.0 / eta_s)
    h_r = normalize(wi + wo)
    h_r = h_r * torch.sign(h_r[..., 2:3])
    # transmission half-vector -(wi + eta wo), normalised (Walter 2007)
    h_t = normalize(-(wi + wo * eta_it_u[..., None]))
    h_t = h_t * torch.sign(h_t[..., 2:3])
    h_d = torch.where(same_side[..., None], h_r, h_t)
    d_d = ggx_ndf(h_d, g['alpha'])
    g_d = ggx_g1(wi, g['alpha']) * ggx_g1(wo, g['alpha'])
    idoth = _sum3(wi, h_d)
    odoth = _sum3(wo, h_d)
    f_d, _, _ = fresnel_dielectric(idoth, eta_s)
    aci = torch.clamp(ci_u.abs(), min=1e-6)
    f_rd_refl = f_d * d_d * g_d / (4.0 * aci)
    denom_t = idoth + eta_it_u * odoth
    jac_t = (eta_it_u * eta_it_u * odoth.abs()
             / torch.clamp(denom_t * denom_t, min=1e-12))
    f_rd_trans = ((1.0 - f_d) * d_d * g_d * idoth.abs() * jac_t
                  / aci) / (eta_it_u * eta_it_u)
    f_rd = torch.where(same_side, f_rd_refl, f_rd_trans)[..., None] \
        * torch.where(same_side[..., None], refl, g['k'])
    pdf_h = d_d * h_d[..., 2].abs()
    pdf_rd = torch.where(
        same_side, f_d * pdf_h / torch.clamp(4.0 * odoth.abs(), min=1e-8),
        (1.0 - f_d) * pdf_h * jac_t)
    # Walter's chi+ sidedness: each direction on the same side of the
    # microfacet as of the macro normal
    chi_rd = (idoth * ci_u > 0.0) & (odoth * co_u > 0.0)
    valid_rd = (ci_u.abs() > 1e-6) & chi_rd

    typ = g['type']
    f = torch.where((typ == DIFFUSE)[..., None], f_diff,
        torch.where((typ == ROUGH_CONDUCTOR)[..., None], f_rc,  # noqa: E128
        torch.where((typ == PLASTIC)[..., None], f_pl_diff,  # noqa: E128
        torch.where((typ == ROUGH_PLASTIC)[..., None], f_rpl,  # noqa: E128
                    0.0))))
    pdf = torch.where(typ == DIFFUSE, pdf_diff,
          torch.where(typ == ROUGH_CONDUCTOR, pdf_rc,  # noqa: E128
          torch.where(typ == PLASTIC, (1 - spec_w) * pdf_diff,  # noqa: E128
          torch.where(typ == ROUGH_PLASTIC, pdf_rpl, 0.0))))  # noqa: E128

    # measured: nearest cell of (theta_i, theta_o, delta phi), sampled
    # with the cosine hemisphere
    if MEASURED in table.present and table.measured_grid is not None:
        gm = table.measured_grid
        nti, nto, ndp = gm.shape[:3]
        half_pi = 0.5 * Pi
        ti = torch.arccos(torch.clamp(ci_f, 0.0, 1.0))
        to = torch.arccos(torch.clamp(co_f, 0.0, 1.0))
        phi_i = torch.atan2(wi_f[..., 1], wi_f[..., 0])
        phi_o = torch.atan2(wo_f[..., 1], wo_f[..., 0])
        dphi = (phi_o - phi_i).abs()
        dphi = torch.where(dphi > Pi, 2 * Pi - dphi, dphi)
        ii = torch.clamp((ti / half_pi * nti).long(), 0, nti - 1)
        io = torch.clamp((to / half_pi * nto).long(), 0, nto - 1)
        ip = torch.clamp((dphi / Pi * ndp).long(), 0, ndp - 1)
        f_meas = gm[ii, io, ip][..., :refl.shape[-1]] * refl \
            * torch.clamp(co_f, min=0.0)[..., None]
        is_meas = typ == MEASURED
        f = torch.where(is_meas[..., None], f_meas, f)
        pdf = torch.where(is_meas, pdf_diff, pdf)

    live = torch.where(g['twosided'], both_up, front)
    f = torch.where(live[..., None], f, 0.0)
    pdf = torch.where(live, pdf, 0.0)
    # rough dielectric bypasses the hemisphere gating (it transmits)
    is_rd = typ == ROUGH_DIELECTRIC
    f = torch.where(is_rd[..., None],
                    torch.where(valid_rd[..., None], f_rd, 0.0), f)
    pdf = torch.where(is_rd, torch.where(valid_rd, pdf_rd, 0.0), pdf)
    return f, pdf


def bsdf_sample(table: BSDFTable, idx, wi, u_lobe, u_dir, refl_scale=None):
    """Sample an outgoing direction.  Returns (wo (n, 3), weight f cos /
    pdf (n, C), pdf (n,), is_delta (n,), eta_scale (n,))."""
    idx, pass_through = _resolve_nested(table, idx, u_lobe)
    g = _gather(table, idx)
    refl = g['refl'] if refl_scale is None else g['refl'] * refl_scale
    ci = wi[..., 2]

    if table.present and set(table.present) <= {DIFFUSE}:
        flip_d = g['twosided'] & (ci < 0.0)
        s_d = torch.where(flip_d, -1.0, 1.0)[..., None]
        wo_d = warp.square_to_cosine_hemisphere(u_dir) * s_d
        f_s, pdf_s = _eval_pdf_basic(table, idx, wi, wo_d, refl_scale)
        w_s = f_s / torch.clamp(pdf_s, min=1e-20)[..., None]
        live_d = pdf_s > 0.0
        return (wo_d, torch.where(live_d[..., None], w_s, 0.0), pdf_s,
                torch.zeros_like(live_d), torch.ones_like(pdf_s))
    flip = g['twosided'] & (ci < 0.0)
    s = torch.where(flip, -1.0, 1.0)[..., None]
    wi_f = wi * s
    ci_f = wi_f[..., 2]
    typ = g['type']

    wo_diff = warp.square_to_cosine_hemisphere(u_dir)
    h = warp.square_to_ggx(u_dir, g['alpha'])
    wo_ggx = _reflect(wi_f, h)
    wo_mirror = torch.stack([-wi_f[..., 0], -wi_f[..., 1], wi_f[..., 2]], -1)

    # smooth dielectric: reflect or refract by Fresnel
    f_, cos_t, eta_it = fresnel_dielectric(ci, g['eta'][..., 0])
    do_reflect = u_lobe < f_
    wo_refl_d = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    scale = 1.0 / eta_it
    wo_refr = torch.stack([-wi[..., 0] * scale, -wi[..., 1] * scale,
                           -torch.sign(ci) * cos_t], -1)
    wo_diel = torch.where(do_reflect[..., None], wo_refl_d, wo_refr)
    # radiance scaling on refraction (solid-angle compression)
    eta_sc = torch.where((typ == DIELECTRIC) & ~do_reflect, 1.0 / eta_it,
                         1.0)

    # plastic lobe choice
    fi, _, _ = fresnel_dielectric(ci_f, g['eta'][..., 0])
    spec_w = torch.clamp(fi, 0.05, 0.95)
    pick_spec = u_lobe < spec_w
    is_rpl = typ == ROUGH_PLASTIC
    is_pl = typ == PLASTIC
    wo_pl = torch.where((is_rpl & pick_spec)[..., None], wo_ggx,
                        torch.where((is_pl & pick_spec)[..., None],
                                    wo_mirror, wo_diff))

    # rough dielectric: reflect / refract through the sampled microfacet
    # (unflipped frame; the relative IOR from the geometric side of wi)
    h_u = h * torch.where(ci < 0.0, -1.0, 1.0)[..., None]
    idoth_u = _sum3(wi, h_u)
    f_rd, cos_t_h, eta_it_h = fresnel_dielectric(
        idoth_u * torch.where(ci >= 0.0, 1.0, -1.0), g['eta'][..., 0])
    refl_rd = u_lobe < f_rd
    wo_rd_refl = _reflect(wi, h_u)
    inv_eta = 1.0 / eta_it_h
    wo_rd_refr = normalize((inv_eta * idoth_u.abs() - cos_t_h)[..., None]
                           * h_u * torch.sign(idoth_u)[..., None]
                           - wi * inv_eta[..., None])
    wo_rd = torch.where(refl_rd[..., None], wo_rd_refl, wo_rd_refr)
    is_rd = typ == ROUGH_DIELECTRIC
    # sampling-side chi+ rejection
    co_rd = wo_rd[..., 2]
    rd_side_ok = torch.where(refl_rd, ci * co_rd > 0.0, ci * co_rd < 0.0)
    rd_chi = ((_sum3(wi, h) * ci > 0.0) & (_sum3(wo_rd, h) * co_rd > 0.0))
    rd_ok = rd_side_ok & rd_chi

    wo_f = torch.where((typ == DIFFUSE)[..., None], wo_diff,
           torch.where((typ == ROUGH_CONDUCTOR)[..., None], wo_ggx,  # noqa
           torch.where((typ == CONDUCTOR)[..., None], wo_mirror,  # noqa
           torch.where((is_pl | is_rpl)[..., None], wo_pl,  # noqa
                       wo_diff))))
    wo = wo_f * s
    wo = torch.where(is_rd[..., None], wo_rd, wo)
    # dielectric / thin / null work in the unflipped frame
    wo = torch.where((typ == DIELECTRIC)[..., None], wo_diel, wo)
    wo = torch.where((typ == THIN_DIELECTRIC)[..., None],
                     torch.where(do_reflect[..., None], wo_refl_d, -wi), wo)
    wo = torch.where(((typ == NULL) | pass_through)[..., None], -wi, wo)

    is_delta = ((typ == CONDUCTOR) | (typ == DIELECTRIC)
                | (typ == THIN_DIELECTRIC) | (typ == NULL) | pass_through)

    f_s, pdf_s = _eval_pdf_basic(table, idx, wi, wo, refl_scale)
    w_smooth = f_s / torch.clamp(pdf_s, min=1e-20)[..., None]

    fc = fresnel_conductor(ci.abs(), g['eta'], g['k'])
    w_mirror = refl * fc
    w_diel = torch.where(do_reflect[..., None], refl,
                         g['k'] * (eta_sc * eta_sc)[..., None])
    # thin dielectric: the internal bounce series R' = 2F / (1 + F)
    rp = torch.where(f_ < 1.0, 2.0 * f_ / (1.0 + f_), 1.0)
    do_reflect_thin = u_lobe < rp

    weight = torch.where((typ == CONDUCTOR)[..., None], w_mirror,
             torch.where((typ == DIELECTRIC)[..., None], w_diel,  # noqa
             torch.where((typ == THIN_DIELECTRIC)[..., None],  # noqa
                         torch.ones_like(refl),
             torch.where(((typ == NULL) | pass_through)[..., None],  # noqa
                         1.0, w_smooth))))
    wo = torch.where((typ == THIN_DIELECTRIC)[..., None],
                     torch.where(do_reflect_thin[..., None], wo_refl_d, -wi),
                     wo)

    pdf = torch.where(is_delta, 1.0, pdf_s)
    pdf = torch.where(is_rd & ~rd_ok, 0.0, pdf)
    live = pdf > 0.0
    weight = torch.where(live[..., None], weight, 0.0)
    return wo, weight, pdf, is_delta, eta_sc
