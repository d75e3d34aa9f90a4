"""Wah and auto-wah: Chamberlin's state-variable filter, its corner swept
per sample by a sine LFO and by an envelope follower on the input.  Per
channel c and sample n, with Q = res and lo, hi the smaller and the
larger of min_hz and max_hz:

    ph[n]     = n dph,  dph = rate_hz / fs                       (cycles)
    lfo[n]    = (1 + sin(2 pi ph[n])) / 2
    env[n]    = a env[n-1] + (1 - a) mean_c |x_c[n]|,  a = exp(-1000 / (env_ms fs))
    sweep[n]  = (1 - mode) lfo[n] + mode clip(sens env[n], 0, 1)
    fc[n]     = lo (hi / lo)^sweep[n]
    f[n]      = min(2 sin(pi fc[n] / fs), 0.95 (sqrt(1/Q^2 + 4) - 1/Q))
    low_c[n]  = low_c[n-1] + f[n] band_c[n-1]
    band_c[n] = band_c[n-1] + f[n] (x_c[n] - low_c[n] - band_c[n-1] / Q)
    y_c[n]    = (1 - mix) x_c[n] + mix band_c[n] / Q

The filter is Chamberlin's digital state-variable filter as Dattorro
gives it ("Effect Design, Part 1: Reverberator and Other Filters", JAES
45(9), 1997); the LFO-swept wah and the envelope-driven auto-wah follow
Zolzer, DAFX: Digital Audio Effects, 2nd ed., Wiley, 2011.

Departures from those sources, as the program defines the effect: dph
and the pole a are taken as the program holds them, dph = rate_hz / fs
computed in float32, a = exp(-1000 / (env_ms fs)) with its exponent
computed in float32 and a itself rounded to float32 (``tests/oracles.py:
OracleWah`` mirrors the same rounding, save that NumPy's float32 exp can
miss the rounded pole by an ulp, as at env_ms 30); f is clamped to 95% of the
positive root of f^2 + 2 f / Q = 4, the filter's stability bound, which
acts only at low sample rates; the output is the band-pass scaled by
1/Q, so the resonance does not raise the level; one envelope, on the
channels' mean magnitude, sweeps every channel; the LFO starts at phase
0, and the envelope and the filter from silence.

Plain torch on the CPU, in the input's dtype (float64; a control may
hand it float32).  Both recurrences are stepped sample by sample in time
order, every 256-sample chunk at once: a first pass steps each chunk
from the zero state with its input and from each unit state without it,
which gives the chunk's end as an affine map of its start; a sequential
carry over the chunks' ends gives each chunk's start; a second pass
steps every chunk from its start.  The demo's 2 x 892,928 samples take
about 0.5 s on one CPU core.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

DEFAULTS = {"rate_hz": 1.5, "min_hz": 350.0, "max_hz": 2200.0, "res": 3.0, "mix": 1.0,
            "mode": 0.0, "sens": 4.0, "env_ms": 30.0}

CHUNK = 256


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _chunks(t, k):
    """(..., N) -> (..., k, CHUNK), zero past the end."""
    return F.pad(t, (0, k * CHUNK - t.shape[-1])).unflatten(-1, (k, CHUNK))


def stepped(step, drive, init, coef=None):
    """The states s[0..N-1] of s[n] = step(s[n-1], coef[n], drive[n]) from
    s[-1] = init, stepped in time order.  ``step`` is linear in (s,
    drive) for a fixed coef; s is a tuple of D tensors.  drive (..., N),
    coef None or broadcastable to drive, init D tensors of drive's shape
    without its last axis.  Returns D tensors (..., N)."""
    n = drive.shape[-1]
    k = -(-n // CHUNK)
    d = _chunks(drive, k)
    c = None if coef is None else _chunks(coef, k)
    dim = len(init)
    # Pass 1, stacked on a new first axis: slot 0 from the zero state with
    # the drive, slot 1 + j from unit state j without it.
    zero = torch.zeros(d.shape[:-1], dtype=d.dtype)
    s = tuple(torch.stack([zero] + [zero + float(i == j) for j in range(dim)])
              for i in range(dim))
    w = torch.tensor([1.0] + [0.0] * dim, dtype=d.dtype).reshape((-1,) + (1,) * (d.dim() - 1))
    for j in range(CHUNK):
        s = step(s, None if c is None else c[..., j], w * d[..., j])
    # The carry: chunk m ends at s[i][0] + sum_j s[i][1 + j] start[j].
    ends = [[s[i][r].unbind(-1) for r in range(dim + 1)] for i in range(dim)]
    start, starts = list(init), []
    for m in range(k):
        starts.append(start)
        start = [ends[i][0][m] + sum(ends[i][1 + j][m] * start[j] for j in range(dim))
                 for i in range(dim)]
    # Pass 2: every chunk from its start, with its drive.
    s = tuple(torch.stack([st[i] for st in starts], -1) for i in range(dim))
    out = []
    for j in range(CHUNK):
        s = step(s, None if c is None else c[..., j], d[..., j])
        out.append(s)
    return tuple(torch.stack([o[i] for o in out], -1).flatten(-2)[..., :n] for i in range(dim))


def envelope(mono, p, fs):
    """env (..., N) of the channels' mean magnitude ``mono`` (..., N)."""
    a = float(_f32(math.exp(float(_f32(-1000.0) / (_f32(p["env_ms"]) * _f32(fs))))))

    def step(s, _c, m):
        return (a * s[0] + (1.0 - a) * m,)

    return stepped(step, mono, (torch.zeros(mono.shape[:-1], dtype=mono.dtype),))[0]


def corner(x, p, fs):
    """f (..., N), the filter's per-sample coefficient, for x (..., C, N)."""
    n = x.shape[-1]
    dph = float(_f32(p["rate_hz"]) / _f32(fs))
    ph = torch.arange(n, dtype=x.dtype) * dph
    lfo = 0.5 * (1.0 + torch.sin(2.0 * math.pi * ph))
    env = envelope(torch.abs(x).mean(-2), p, fs)
    sweep = (1.0 - p["mode"]) * lfo + p["mode"] * torch.clamp(p["sens"] * env, 0.0, 1.0)
    lo, hi = min(p["min_hz"], p["max_hz"]), max(p["min_hz"], p["max_hz"])
    fc = lo * (hi / lo) ** sweep
    q1 = 1.0 / p["res"]
    bound = 0.95 * (math.sqrt(q1 * q1 + 4.0) - q1)
    return torch.clamp(2.0 * torch.sin(math.pi * fc / fs), max=bound)


def apply(x, p, fs):
    x = torch.from_numpy(np.ascontiguousarray(x))
    q1 = 1.0 / p["res"]

    def step(s, f, xn):
        low = s[0] + f * s[1]
        return low, s[1] + f * (xn - low - q1 * s[1])

    zero = torch.zeros(x.shape[:-1], dtype=x.dtype)
    _low, band = stepped(step, x, (zero, zero), corner(x, p, fs)[..., None, :])
    return ((1.0 - p["mix"]) * x + p["mix"] * (q1 * band)).numpy()
