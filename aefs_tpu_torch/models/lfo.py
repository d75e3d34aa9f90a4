"""The modulation family's LFO phase (chorus, tremolo, phaser, wah,
flanger; the JAX package writes it out inline in each model).

The phase is carried across blocks as a compensated split-float32 pair
(hi, lo) advanced by the octaver's TwoSum, so 256-sample streaming and
long blocks accumulate nearly the same phase: naive float32 accumulation
drifts by ~eps per block.  Inside a block the phase is one product per
sample, ``hi + (lo + idx * dph)``.  ``dph = rate_hz / fs`` divides by a
device tensor: CUDA turns a division by a Python scalar into a reciprocal
multiply, one ulp off the CPU.

The LFO's transcendentals go through ``f64``: torch's float32 sin, pow,
exp and tan differ by an ulp or two between its CPU and CUDA builds, and
these effects amplify an ulp of their sweep (a chorus tap moves by
ulp(delay) times the signal's slope; the wah's resonator integrates it).
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import lead
from aefs_tpu_torch.ops.dsphase import _two_sum

TWO_PI = 2.0 * math.pi


def f64(fn, *args):
    """``fn`` of float32 tensors evaluated in float64 and rounded once to
    float32: the CPU and the card then agree except where the float64
    result lies within a few of its ulps of a float32 rounding boundary
    (a chance of ~2^-28 per value)."""
    return fn(*(a.double() for a in args)).float()


def fs_tensor(fs, device):
    """The sample rate as a 0-dim float32 tensor, for divisions."""
    return torch.full((), float(fs), device=device)


def lfo_ramp(hi, lo, dph, n: int):
    """Per-sample phase in cycles for the next ``n`` samples: (..., n) for
    (...) slot-wise hi, lo, dph."""
    idx = torch.arange(n, dtype=torch.float32, device=dph.device)
    return lead(hi) + (lead(lo) + idx * lead(dph))


def spread_channels(ph, spread, c: int):
    """(..., n) phase -> (..., c, n): channel k is offset by k * spread
    cycles."""
    chan = torch.arange(c, dtype=torch.float32, device=ph.device)[:, None]
    return ph[..., None, :] + lead(spread, 2) * chan


def lfo_advance(hi, lo, dph, n: int):
    """The (hi, lo) pair ``n`` samples later, hi wrapped into [0, 1)."""
    nhi, nlo = _two_sum(hi, lo + float(n) * dph)
    return nhi - torch.floor(nhi), nlo
