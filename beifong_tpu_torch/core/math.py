"""Radar math helpers on tensors (counterpart of `beifong_tpu/core/math.py`):
sinc / tri / rect, the clamped square roots, the MIS power heuristic and
the double-single (two-float) arithmetic of the coherent phase.

The double-single helpers are error-free transforms: they hold only when
every float32 operation is rounded on its own.  Eager PyTorch rounds each
op (one elementwise kernel per op, no FMA contraction across ops), so they
hold on the CPU and on a card; never fuse them into a kernel that
contracts multiply-adds.
"""

from __future__ import annotations

import numpy as np
import torch

Pi = 3.141592653589793
TwoPi = 6.283185307179586
InvPi = 1.0 / Pi
InvTwoPi = 1.0 / TwoPi
InvFourPi = 1.0 / (4.0 * Pi)

# Propagation speeds [m/s].
C_VACUUM = 299792458.0
C_AIR_SOUND = 340.0
C_WATER_SOUND = 1480.0


def sinc(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized sinc sin(x)/x with sinc(0) = 1."""
    big = x.abs() > 1e-8
    safe = torch.where(big, x, torch.ones_like(x))
    return torch.where(big, torch.sin(safe) / safe, torch.ones_like(x))


def tri(x: torch.Tensor) -> torch.Tensor:
    """Triangle of base 1: 1 - 2|x| on |x| < 1/2, else 0."""
    ax = x.abs()
    return torch.where(ax < 0.5, 1.0 - 2.0 * ax, torch.zeros_like(x))


def rect(x: torch.Tensor) -> torch.Tensor:
    """Rectangular window of width 1."""
    return torch.where(x.abs() < 0.5, torch.ones_like(x), torch.zeros_like(x))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 (the value of the JAX package's double-where)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(torch.clamp(x, min=1e-30))


def safe_acos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b along the last axis of (..., 3) tensors, summed x + y + z."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def normalize(a: torch.Tensor) -> torch.Tensor:
    """a / |a| along the last axis."""
    return a * safe_rsqrt((a * a).sum(-1, keepdim=True))


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta = 2)."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    w = pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)


# ---------------------------------------------------------------------------
# Double-single arithmetic: a value is (hi, lo) with value = hi + lo.
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def ds(hi, lo=None):
    hi = torch.as_tensor(hi, dtype=torch.float32)
    if lo is None:
        lo = torch.zeros_like(hi)
    return hi, lo


def ds_add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return two_sum(s, e)


def ds_add_f(x, y):
    """(hi, lo) + float32 -> (hi, lo)."""
    s, e = two_sum(x[0], y)
    e = e + x[1]
    return two_sum(s, e)


def _split(a):
    """Veltkamp split of a float32 into two 12-bit halves (exact)."""
    c = a * 4097.0   # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, no FMA).  A
    Python float operand is taken as float32 (it must be representable)."""
    if not isinstance(a, torch.Tensor):
        a = _like(a, b)
    if not isinstance(b, torch.Tensor):
        b = _like(b, a)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_inv(b):
    """Double-single reciprocal of float32 b: hi + lo ~= 1 / b to ~2^-46."""
    b = torch.as_tensor(b, dtype=torch.float32)
    inv_hi = 1.0 / b
    p, pe = two_prod(inv_hi, b)
    r = (1.0 - p) - pe
    return inv_hi, r / b


def ds_mul(x, y):
    """(hi, lo) * (hi, lo) -> (hi, lo) (~2^-46 relative)."""
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return two_sum(p, e)


def ds_const(v: float):
    """A Python float split into float32 (hi, lo) Python floats, hi + lo ==
    v to ~2^-48 relative (each exactly representable in float32)."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)


def wlfrac_zero(shape=(), device=None):
    """Fractional wavelength-count accumulator, value in [0, 1) cycles."""
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return z, torch.zeros_like(z)


def _frac_renorm(hi, lo):
    """Renormalize a ds pair into ([0, 1) hi, tiny lo)."""
    h = hi - torch.floor(hi)
    h2, l2 = two_sum(h, lo)
    return h2 - torch.floor(h2), l2


def wlfrac_add_dist(acc, dist, inv_wl_ds):
    """acc += frac(dist / wavelength), error-free in float32 pairs;
    `inv_wl_ds` is (hi, lo) of 1 / wavelength."""
    ih, il = inv_wl_ds
    p1, e1 = two_prod(dist, ih)
    q_hi, q_lo = two_sum(p1, e1 + dist * il)
    f_hi = q_hi - torch.floor(q_hi)          # exact (Sterbenz)
    h, lo = two_sum(acc[0], f_hi)
    lo = lo + acc[1] + q_lo
    return _frac_renorm(h, lo)


def wlfrac_phase(acc):
    """Accumulated phase in radians, in [0, 2 pi)."""
    return TwoPi * _frac_renorm(*acc)[0]


def wlfrac_add_phase(acc, phase_rad):
    """Add a raw phase offset [rad] to the cycle accumulator."""
    h, lo = two_sum(acc[0], phase_rad * InvTwoPi)
    return _frac_renorm(h, lo + acc[1])


def cyc_frac_prod(a_ds, b):
    """frac((a_hi + a_lo) * b) for a float32 tensor b, in [0, 1)."""
    ah, al = a_ds
    p, e = two_prod(ah, b)
    fr = (p - torch.floor(p)) + (e + al * b)
    return fr - torch.floor(fr)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """`v` (a float or a tensor) as a float32 tensor broadcast like `ref`."""
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32,
                                              device=ref.device), ref.shape)
