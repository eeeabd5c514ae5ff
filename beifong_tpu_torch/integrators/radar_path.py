"""The eager receive wavefront (counterpart of
`beifong_tpu/integrators/radar_path.py`): reverse tracing from the
receiver with retarded time, per-bounce Doppler, transmitter NEE and
direct transmitter hits, every connection splatted into the ADC grid at
its own receive time and frequency.

It runs as plain PyTorch ops over a wavefront of lanes, on the CPU or on a
card; its triangle closest-hit and shadow tests are the hand-written
kernels (`geometry/intersect.py`).  Coherent I/Q phase comes from the
double-single path length (`core/math.py`), exact to a small fraction of a
cycle over long paths.  MIMO receive splats every connection into one
I / Q pair an element, each with the exact spherical phase of its
position.  The scene's ambient medium (`media.py`) attenuates every
segment and every transmitter connection by exp(-tau).  Polarized
transport is ROADMAP A10 and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import film as film_mod
from ..bsdf.eval import bsdf_eval_pdf, bsdf_sample
from ..core import math as m
from ..radar.endpoints import (ADCConfig, tx_eval, tx_pdf_direction,
                               tx_sample_direction, tx_sample_geom)
from ..radar.waveform import CW, LINFMCW
from ..textures import texture_eval


def _adc_splat(adc, cfg: ADCConfig, t_off, f_out, value, active, phase=None,
               coherent: bool = False, elem_dphase=None):
    """Splat one batch of connections into adc (n_time, n_freq, C + 2) at
    receive-time offset t_off [s] and frequency f_out [Hz]; in coherent
    mode two channels (I, Q) take sqrt(power) e^{i phase}.  With
    `elem_dphase` (n, E), the per-element phase offsets of MIMO receive,
    2E channels [I_0, Q_0, I_1, Q_1, ...] take sqrt(power)
    e^{i (phase + elem_dphase[:, e])}."""
    x = (f_out - cfg.freq_lo) / max(cfg.freq_hi - cfg.freq_lo, 1e-30) \
        * cfg.n_freq
    y = t_off / cfg.sampling_time * cfg.n_time
    pos = torch.stack([x, y], -1)
    if elem_dphase is not None:
        amp = torch.sqrt(torch.clamp(value, min=0.0))[:, None]
        ph_e = phase[:, None] + elem_dphase
        vals = torch.stack([amp * torch.cos(ph_e), amp * torch.sin(ph_e)],
                           -1).reshape(value.shape[0], -1)
    elif coherent:
        amp = torch.sqrt(torch.clamp(value, min=0.0))
        vals = torch.stack([amp * torch.cos(phase), amp * torch.sin(phase)],
                           -1)
    else:
        vals = value[:, None]
    return film_mod.splat(adc, pos, vals, active, cfg.rfilter)


def _side_sign(si):
    """+1 where the two-sided shading frame kept the geometric orientation,
    -1 where closest_hit flipped it toward the ray: BSDFs are evaluated in
    the unflipped frame (transmissive lobes read the side off wi.z)."""
    s = (si.sh_frame[:, 2, :] * si.n).sum(-1)
    return torch.where(s < 0.0, -1.0, 1.0)


def _flip_z(v, sgn):
    """Flip the z component of local directions by the per-lane sign."""
    return v * torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn],
                           -1)


def _h_cycles(kind, fc_x, t_ext, f_ext, tm_ds, fc_ref_ds):
    """Small-argument waveform cycles h(tm) = g(tm) - fc_ref tm (mod 1) of
    the folded carrier / chirp cycle count g, every big product an exact
    two_prod: tone (fc_x - fc_ref) tm; chirp (fc_x - fc_ref) tm - fc_x ti
    + s (tm - ti)^2 / 2.  `tm_ds` is the folded time as a (hi, lo) pair."""
    tm_hi, tm_lo = tm_ds
    fr_hi, fr_lo = fc_ref_ds
    df_hi = fc_x - fr_hi     # Sterbenz-exact when close
    p, e = m.two_prod(df_hi, tm_hi)
    cyc = (p - torch.floor(p)) + (e + df_hi * tm_lo - fr_lo * (tm_hi + tm_lo))
    ti = 0.5 * t_ext
    s = f_ext / torch.clamp(t_ext, min=1e-12)
    d0, e0 = m.two_sum(tm_hi, -ti)
    dtc_hi, dtc_lo = d0, e0 + tm_lo
    p2, e2 = m.two_prod(fc_x, ti)
    sd_hi, sd_lo = m.two_prod(s, dtc_hi)
    q_hi, q_lo = m.two_prod(sd_hi, 0.5 * dtc_hi)
    chirp_extra = ((q_hi - torch.floor(q_hi)) + q_lo
                   + 0.5 * sd_lo * dtc_hi + sd_hi * dtc_lo
                   - ((p2 - torch.floor(p2)) + e2))
    cyc = cyc + torch.where(kind == LINFMCW, chirp_extra, 0.0)
    return cyc - torch.floor(cyc)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _echo_phase(scene, tx_row, lo_wf, plen_ds, extra_dist, t_emit, k_pri,
                t_recv, n_boundary, boundary_phase):
    """Coherent baseband phase [rad] of one transmitter connection:
    wf.phase(t_emit) - ref_phase(t_recv) (mod 2 pi), computed from the
    propagation delay (plen + extra_dist) / c through the double-single
    path length, so no cycle is lost at large f t.  In cycles, mod 1:
      phi0_tx - phi0_lo + h_tx(tm_e) - h_lo(tm_r) - frac(fc_ref tau)
        - (m_e + k_pri) frac(fc_ref PRI_tx) + m_r frac(fc_ref PRI_lo)
    with tm / m the PRI folds of emission / receive time and fc_ref the
    band centre.  `k_pri` counts the whole PRIs gate sampling shifted
    t_recv by (0 under fixed sampling)."""
    band = scene.band
    c = band.c
    fc_ref = 0.5 * (band.freq_min + band.freq_max)
    fc_ref_ds = m.ds_const(fc_ref)
    wfr = scene.transmitters.wf.row(tx_row)
    prf = torch.clamp(wfr.rep_freq, min=1e-12)
    pri = 1.0 / prf
    hi = plen_ds[0]
    extra = torch.as_tensor(extra_dist, dtype=torch.float32,
                            device=hi.device).expand_as(hi)

    # tau cycles at fc_ref from the compensated path length
    inv_wl = m.ds_const(fc_ref / c)
    acc = m.wlfrac_zero(hi.shape, device=hi.device)
    acc = m.wlfrac_add_dist(acc, hi, inv_wl)
    acc = m.wlfrac_add_dist(acc, extra, inv_wl)
    # the low word on its own: adding it to extra_dist first rounds it away
    acc = m.wlfrac_add_dist(acc, plen_ds[1], inv_wl)
    cyc_tau = m._frac_renorm(*acc)[0]

    # emission fold
    m_e = torch.floor(t_emit * prf)
    tm_e = t_emit - m_e * pri
    cyc = (wfr.phi0 * _f32(m.InvTwoPi)
           + _h_cycles(wfr.kind, wfr.f_centre, wfr.t_ext, wfr.f_ext,
                       (tm_e, torch.zeros_like(tm_e)), fc_ref_ds)
           - cyc_tau
           - (m_e + k_pri) * m.cyc_frac_prod(fc_ref_ds, pri))

    if lo_wf is not None:
        prf_lo = torch.clamp(lo_wf.rep_freq, min=1e-12)
        pri_lo = 1.0 / prf_lo
        m_r = torch.floor(t_recv * prf_lo)
        tm_r0 = t_recv - m_r * pri_lo
        # when tau + tm_e - tm_r is a whole number of LO PRIs (a matched
        # dechirp), rebuild tm_r from the double-single delay
        tau_f = (plen_ds[0] + plen_ds[1] + extra) / c
        jr = (tau_f + tm_e - tm_r0) * prf_lo
        j = torch.round(jr)
        tau_ds = m.ds_mul(m.ds_add_f(plen_ds, extra), m.ds_const(1.0 / c))
        jp_hi, jp_lo = m.two_prod(j, pri_lo.expand_as(j))
        delta = m.ds_add(tau_ds, (-jp_hi, -jp_lo))
        hp_hi, hp_e = m.two_sum(tm_e, delta[0])
        use_hp = (jr - j).abs() < 1e-3
        tm_r = (torch.where(use_hp, hp_hi, tm_r0),
                torch.where(use_hp, hp_e + delta[1], 0.0))
        cyc = (cyc
               - lo_wf.phi0 * _f32(m.InvTwoPi)
               - _h_cycles(lo_wf.kind, lo_wf.f_centre, lo_wf.t_ext,
                           lo_wf.f_ext, tm_r, fc_ref_ds)
               + m_r * m.cyc_frac_prod(fc_ref_ds, pri_lo.expand_as(m_r)))

    bnd = np.float32(n_boundary) * (np.float32(boundary_phase)
                                    * np.float32(m.InvTwoPi))
    cyc = cyc + float(bnd)
    return m.TwoPi * (cyc - torch.floor(cyc))


def radar_receive_trace(scene, stream, o, d, t_rx, f_rx, ray_weight, adc,
                        cfg: ADCConfig, receive_type: str, lo_wf,
                        rx_velocity, max_depth: int = 4,
                        coherent: bool = False, time_sampling: str = 'fixed',
                        polarized: bool = False, elem_offsets=None):
    """Trace one wavefront of receive rays, splatting every transmitter
    connection into `adc` (in place).  Returns (adc, stream).

    o, d: (n, 3) receive rays; t_rx: (n,) absolute receive time [s];
    f_rx: (n,) sampled receive frequency [Hz]; ray_weight: (n,) receiver
    importance weight.  `stream` has `next_1d` / `next_2d` and is consumed
    in the JAX package's order.

    time_sampling 'fixed': t_rx was drawn uniformly over the ADC window.
    'gate': deferred time-gated sampling of a static scene: at every
    connection an emission time is drawn uniformly within the waveform's
    pulse support and the receive time follows as t_emit + delay (+ whole
    PRIs into the window); needs window <= PRI; the caller passes t_rx = 0.

    `elem_offsets` (E, 3): world-frame offsets of the receive elements from
    the ray origin (MIMO receive; needs `coherent`).  The adc then holds
    2E channels: element e takes each contribution with the extra phase
    of the exact spherical wavefront at its position.  Every connection of
    a lane shares the first path vertex x1, so an element's path differs
    only in its last segment, by |x1 - (o + r_e)| - |x1 - o| (the plane-
    wave steering phase -k d.r_e in the far field).
    """
    if polarized:
        raise NotImplementedError('polarized (Stokes) receive (ROADMAP A10)')
    if elem_offsets is not None and not coherent:
        raise ValueError('MIMO element channels need coherent=True')
    n = int(o.shape[0])
    dev = o.device
    c = scene.band.c
    gate = time_sampling == 'gate'
    rx_vel = torch.as_tensor(np.asarray(rx_velocity, np.float32),
                             device=dev)

    throughput = ray_weight
    active = torch.ones(n, dtype=torch.bool, device=dev)
    time = t_rx                                       # runs backward
    plen = m.ds(torch.zeros(n, dtype=torch.float32, device=dev))
    # Doppler: f_received = f_emitted * dop; receiver motion along -d
    dop = 1.0 + (d * rx_vel[None, :]).sum(-1) / c
    d_cur = d
    si = scene.ray_intersect(o, d)
    active = active & si.valid
    emission_weight = torch.ones(n, dtype=torch.float32, device=dev)
    med = scene.medium

    elem_dd = None
    if elem_offsets is not None:
        # each element's last-segment path difference, anchored at the
        # lane's first vertex (shared by every connection of the lane)
        eo = torch.as_tensor(elem_offsets, dtype=torch.float32, device=dev)
        x1 = torch.where(si.valid[:, None], si.p, o + d)
        r0 = torch.linalg.norm(x1 - o, dim=-1)
        re = torch.linalg.norm(x1[:, None, :] - (o[:, None, :] + eo[None]),
                               dim=-1)
        elem_dd = re - r0[:, None]                        # (n, E) [m]

    def elem_dphase(f_recv):
        if elem_dd is None:
            return None
        return -m.TwoPi * (f_recv / c)[:, None] * elem_dd

    def lo_freq(t):
        return torch.zeros_like(t) if lo_wf is None else lo_wf.inst_freq(t)

    def bin_freq(f_recv, t_rx_conn):
        """Frequency-axis coordinate per receive type: raw / raw_resample
        the received frequency; mix_resample |f_recv - f_LO|; mixer the
        signed beat f_LO - f_recv."""
        if receive_type == 'mix_resample':
            return (f_recv - lo_freq(t_rx_conn)).abs()
        if receive_type == 'mixer':
            return lo_freq(t_rx_conn) - f_recv
        return f_recv

    def gate_times(tau, tx_row, u_g):
        """Deferred emission-time sample for delay tau: (t_emit, t_recv,
        weight factor, whole PRIs the receive time was shifted by)."""
        wf = scene.transmitters.wf
        t_ext = wf.t_ext[tx_row]
        prf = wf.rep_freq[tx_row]
        window = cfg.sampling_time
        is_cw = wf.kind[tx_row] == CW   # support: the whole window
        sup = torch.where(is_cw, window, t_ext)
        t_emit0 = torch.where(is_cw, cfg.sampling_start - tau, 0.0) \
            + u_g * sup
        t_recv = tau + t_emit0
        k = torch.ceil((cfg.sampling_start - t_recv) * prf)
        k = torch.where(is_cw, 0.0, torch.clamp(k, min=0.0))
        t_recv = t_recv + k / torch.clamp(prf, min=1e-12)
        return t_emit0, t_recv, sup / window, k

    for depth in range(max_depth):
        # advance to the hit (backward time)
        dt = torch.where(active, si.t, 0.0)
        time = time - dt / c
        plen = m.ds_add_f(plen, dt)
        if med is not None:
            # ambient absorption along the segment (dead lanes: dt = 0,
            # exp(0))
            throughput = throughput * med.attenuation(
                si.p - d_cur * dt[:, None], d_cur, dt)
        bnd = scene.band.boundary_phase

        # direct transmitter hit
        tx_idx = scene.transmitter_of(si.shape_idx)
        cos_hit = (-d_cur * si.n).sum(-1)
        hit_tx = active & (tx_idx >= 0)
        f_at_tx = f_rx / torch.clamp(dop, min=1e-6)
        tx_row = torch.clamp(tx_idx, min=0).long()
        if gate:
            u_g, stream = stream.next_1d()
            t_emit_hit, t_rx_hit, w_gate, k_hit = gate_times(-time, tx_row,
                                                             u_g)
        else:
            t_emit_hit, t_rx_hit, w_gate, k_hit = time, t_rx, 1.0, 0.0
        w_hit, f_emit_hit = tx_eval(scene, tx_idx, si.p, -d_cur, cos_hit,
                                    t_emit_hit, f_at_tx,
                                    c / torch.clamp(f_at_tx, min=1e-6))
        f_recv_hit = f_emit_hit * dop
        val_hit = throughput * emission_weight * w_hit * w_gate
        ph_hit = _echo_phase(scene, tx_row, lo_wf, plen, 0.0, t_emit_hit,
                             k_hit, t_rx_hit, depth, bnd) \
            if coherent else None
        _adc_splat(adc, cfg, t_rx_hit - cfg.sampling_start,
                   bin_freq(f_recv_hit, t_rx_hit), val_hit,
                   hit_tx & (val_hit != 0.0), ph_hit, coherent,
                   elem_dphase(f_recv_hit))

        # NEE toward the transmitters
        bsdf_idx = scene.bsdf_of(si.shape_idx)
        has_bsdf = bsdf_idx >= 0
        tex_idx = scene.bsdfs.texture_idx[torch.clamp(bsdf_idx, min=0).long()]
        refl_scale = texture_eval(scene.textures, tex_idx, si.uv,
                                  si.prim_idx,
                                  wl=c / torch.clamp(f_rx, min=1e-20))
        u_sel, stream = stream.next_1d()
        u_pos, stream = stream.next_2d()
        vel_here = scene.velocity_of(si.shape_idx)
        f_at_ref = f_rx / torch.clamp(dop, min=1e-6)
        if gate:
            ds, tx_row_g, _ = tx_sample_geom(scene, si.p, u_sel, u_pos)
            tau_nee = -time + ds.dist / c
            u_g2, stream = stream.next_1d()
            t_emit_s, t_rx_nee, w_gate_nee, k_nee = gate_times(
                tau_nee, tx_row_g, u_g2)
            ds, w_nee, f_emit_nee, t_emit, tx_row = tx_sample_direction(
                scene, si.p, time, f_at_ref, u_sel, u_pos,
                t_emit_override=t_emit_s)
        else:
            ds, w_nee, f_emit_nee, t_emit, tx_row = tx_sample_direction(
                scene, si.p, time, f_at_ref, u_sel, u_pos)
            t_rx_nee, w_gate_nee, k_nee = t_rx, 1.0, 0.0
        # per-connection Doppler: the vertex bounce and the tx motion
        dop_vtx = 1.0 + ((ds.d - d_cur) * vel_here).sum(-1) / c
        tx_vel = scene.transmitters.velocity[tx_row]
        dop_tx = 1.0 - (ds.d * tx_vel).sum(-1) / c
        f_recv_nee = f_emit_nee * (dop * dop_vtx * dop_tx)

        occluded = scene.ray_test(si.spawn_origin(ds.d), ds.d, ds.dist)
        wo_nee = si.to_local(ds.d)
        # the NEE vertex's spectral reflectance at the connection's own
        # frequency
        refl_nee = texture_eval(scene.textures, tex_idx, si.uv, si.prim_idx,
                                wl=c / torch.clamp(f_recv_nee, min=1e-20))
        sgn_geo = _side_sign(si)
        f_b, pdf_b_nee = bsdf_eval_pdf(scene.bsdfs, bsdf_idx,
                                       _flip_z(si.wi, sgn_geo),
                                       _flip_z(wo_nee, sgn_geo), refl_nee)
        mis = m.mis_weight(ds.pdf, pdf_b_nee)
        nee_ok = active & has_bsdf & ~occluded & (ds.pdf > 0.0)
        val_nee = throughput * f_b[:, 0] * w_nee * mis * w_gate_nee
        if med is not None:
            val_nee = val_nee * med.attenuation(si.p, ds.d, ds.dist)
        ph_nee = _echo_phase(scene, tx_row, lo_wf, plen, ds.dist, t_emit,
                             k_nee, t_rx_nee, depth + 1, bnd) \
            if coherent else None
        _adc_splat(adc, cfg, t_rx_nee - cfg.sampling_start,
                   bin_freq(f_recv_nee, t_rx_nee), val_nee,
                   nee_ok & (val_nee != 0.0), ph_nee, coherent,
                   elem_dphase(f_recv_nee))

        if depth == max_depth - 1:
            break

        # BSDF continuation
        u_lobe, stream = stream.next_1d()
        u_dir, stream = stream.next_2d()
        wo, w_b, pdf_b, is_delta, _ = bsdf_sample(
            scene.bsdfs, bsdf_idx, _flip_z(si.wi, sgn_geo), u_lobe, u_dir,
            refl_scale)
        throughput = torch.where(active, throughput * w_b[:, 0], throughput)
        alive = active & has_bsdf & (pdf_b > 0.0) & (throughput != 0.0)
        d_new = si.to_world(_flip_z(wo, sgn_geo))
        dop = dop * (1.0 + ((d_new - d_cur) * vel_here).sum(-1) / c)
        si2 = scene.ray_intersect(si.spawn_origin(d_new), d_new)
        # MIS weight of a transmitter hit on the continued ray
        tx2 = scene.transmitter_of(si2.shape_idx)
        cos2 = (-d_new * si2.n).sum(-1)
        pdf_tx = tx_pdf_direction(scene, tx2, si2.t, cos2)
        emission_weight = torch.where(is_delta, 1.0,
                                      m.mis_weight(pdf_b, pdf_tx))
        active = alive & si2.valid
        si = si2
        d_cur = d_new

    return adc, stream
