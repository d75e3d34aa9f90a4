"""Double-single (hi + lo float32) phase arithmetic of the octaver's grain
phasor (port of the helpers in aefs_tpu/models/octaver.py); the LFO
effects carry their phase with ``_two_sum``.

Every step is an error-free transform, so each product and sum is its own
eager op and is rounded separately (no FMA contraction).  The octaver's
step kernel (csrc/resample.cu) repeats these operations in this order,
with the same float32 constants.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = torch.float32
_I32 = torch.int32


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth TwoSum), with the
    virtual operands a' = s - b', b' = s - a."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split12(v):
    """Veltkamp split of an f32 into 12-bit-significand halves: products
    of two halves are exact in f32."""
    c = v * 4097.0
    hi = c - (c - v)
    return hi, v - hi


def _two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, via _split12)."""
    p = a * b
    ah, al = _split12(a)
    bh, bl = _split12(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _ds_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    return _two_sum(s, e + (al + bl))


def _ds_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    return _two_sum(p, e + (ah * bl + al * bh))


def _exp2_coeffs():
    """Degree-12 Taylor coefficients of 2^r = exp(r ln 2) as (hi, lo) f32
    pairs of the float64 values (truncation ~2^-52 on |r| <= 0.5)."""
    out = []
    for j in range(13):
        c = math.log(2.0) ** j / math.factorial(j)
        hi = np.float32(c)
        out.append((float(hi), float(np.float32(c - float(hi)))))
    return out


_EXP2_C = _exp2_coeffs()
_INV12_HI = float(np.float32(1.0 / 12.0))
_INV12_LO = float(np.float32(1.0 / 12.0 - _INV12_HI))


def ds_exp2_div12(s):
    """Double-single 2^(s/12) for f32 semitones in [-24, 24]: hi + lo
    matches the float64 ratio to ~2^-43 relative.  Range-reduce
    y = s/12 = k + r (k = round, |r| <= 0.5), Horner the Taylor series in
    double-single, scale by the exact 2^k."""
    p, e = _two_prod(s, torch.full_like(s, _INV12_HI))
    y_hi, y_lo = _two_sum(p, e + s * _INV12_LO)
    k = torch.round(y_hi)
    r_hi, r_lo = _two_sum(y_hi - k, y_lo)  # y_hi - k exact: |diff| <= 0.5
    th = torch.full_like(s, _EXP2_C[12][0])
    tl = torch.full_like(s, _EXP2_C[12][1])
    for j in range(11, -1, -1):
        th, tl = _ds_mul(th, tl, r_hi, r_lo)
        th, tl = _ds_add(th, tl, _EXP2_C[j][0], _EXP2_C[j][1])
    scale = torch.ldexp(torch.ones_like(s), k.to(_I32))  # exact 2^k
    return th * scale, tl * scale


def _stride_levels(step_hi, step_lo):
    """((4096^l * step) mod 1) for l = 0, 1, 2 as renormalized DS pairs
    (the *4096 scalings and the mod-1 of an f32 < 2^24 are exact)."""
    def lift(h, l):
        rh = h * 4096.0
        rh = rh - torch.floor(rh)
        return _two_sum(rh, l * 4096.0)

    r1 = lift(step_hi, step_lo)
    r2 = lift(*r1)
    return ((step_hi, step_lo), r1, r2)


def _phase_accum(idx, strides, base_hi, base_lo):
    """Compensated (acc, err) of base + idx*step over base-4096 digits of
    the int32 index: every hi product has a <= 24-bit significand, exact
    in f32, and its mod-1 residue is exact."""
    acc = base_hi + torch.zeros(idx.shape, dtype=_F32, device=idx.device)
    err = base_lo + torch.zeros(idx.shape, dtype=_F32, device=idx.device)
    digits = (idx & 4095, (idx >> 12) & 4095, (idx >> 24) & 4095)
    for j, (rh, rl) in zip(digits, strides):
        a, b = _split12(rh)
        jf = j.to(_F32)
        t_exact = torch.remainder(jf * a, 1.0)  # exact (24-bit product)
        t_small = jf * b + jf * rl
        acc, e1 = _two_sum(acc, t_exact)
        acc, e2 = _two_sum(acc, t_small)
        err = err + (e1 + e2)
    return acc, err


def _phase_ramp(idx, strides, base_hi, base_lo):
    """f32 phases mod 1 for an int32 index tensor — one ulp(1) rounding."""
    acc, err = _phase_accum(idx, strides, base_hi, base_lo)
    return torch.remainder(torch.remainder(acc, 1.0) + err, 1.0)


def _phase_fold(n_abs, strides, base_hi, base_lo):
    """DS base' = mod(base + n_abs*step, 1): re-anchors the phase origin
    when the step changes (live semitone glide)."""
    acc, err = _phase_accum(n_abs, strides, base_hi, base_lo)
    return _two_sum(torch.remainder(acc, 1.0), err)
