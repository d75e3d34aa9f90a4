"""Regenerative flanger (Dattorro, "Effect Design, Part 2: Delay-Line
Modulation and Chorus", JAES 45(10), 1997): a delay line whose read tap
sweeps with a sine LFO and whose output is fed back into its input.  Per
channel c and sample n:

    ph[n]  = n * dph + spread * c                      (cycles)
    d[n]   = clip((base_ms + depth_ms sin(2 pi ph[n])) fs / 1000, 24, H - 2)
    s[n]   = cubic tap of v at d[n] samples back
    v[n]   = x[n] + feedback * s[n]                    (the line's input)
    y[n]   = (1 - mix) x[n] + mix s[n]

Plain torch in float64 on the CPU.  The recurrence is stepped sample by
sample, vectorised over stretches of L = ceil(min d) - 2 samples: the
nearest tap of sample n reads v[n - ceil(d[n]) + 2], so within a stretch
no sample reads another of the same stretch, and each stretch is one
gather of what earlier stretches wrote.  L is 22 at worst and 46 for
"Jet Flanger" (d sweeps 48-240 samples).

Departures from the published structure, as the program defines the
effect: the tap is a 4-point Catmull-Rom cubic at ceil(d) + {1, 0, -1, -2}
samples back, interpolated at frac = ceil(d) - d (Dattorro reads with
linear or all-pass interpolation); the delay is clipped to [24, H - 2]
samples with H = int(15 ms fs) + 8 (the program's largest base and depth,
and its lower bound on the reach); the phase increment is rate_hz / fs
rounded to float32, as the program holds it; the line starts silent and
the LFO at phase 0; there is no blend of the line's input into the
output, no damping in the loop, and no clip (the chain clips its
output).
"""

import math

import numpy as np
import torch

DEFAULTS = {"rate_hz": 0.3, "depth_ms": 2.0, "base_ms": 2.5, "feedback": 0.6, "mix": 0.5,
            "spread": 0.0}

MAX_MS = 15.0   # the largest base_ms plus the largest depth_ms
D_MIN = 24.0    # samples


def history(fs):
    """H, the delay line's length in samples."""
    return int(MAX_MS * fs / 1000.0) + 8


def taps(p, fs, channels, n):
    """(first, weights, d): for each channel and sample, the line position
    of the first of its four taps (counted in a line of ``history(fs)``
    zeros followed by the signal), the taps' cubic weights (c, n, 4), and
    the delay d (c, n) in samples."""
    h = history(fs)
    dph = float(torch.tensor(p["rate_hz"], dtype=torch.float32)
                / torch.tensor(float(fs), dtype=torch.float32))
    idx = torch.arange(n, dtype=torch.float64)
    ph = idx * dph + p["spread"] * torch.arange(channels, dtype=torch.float64)[:, None]
    ms = p["base_ms"] + p["depth_ms"] * torch.sin(2.0 * math.pi * ph)
    d = torch.clamp(ms * fs / 1000.0, D_MIN, h - 2.0)
    ca = torch.ceil(d)
    f = ca - d
    weights = torch.stack([f * (-0.5 + f * (1.0 - 0.5 * f)),
                           1.0 + f * f * (-2.5 + 1.5 * f),
                           f * (0.5 + f * (2.0 - 1.5 * f)),
                           f * f * (0.5 * f - 0.5)], -1)
    first = (h + idx - ca - 1.0).to(torch.int64)
    return first, weights, d


def _read(line, first, weights):
    """The cubic taps at ``first`` + 0..3 of line (..., c, m): (..., c, k)
    for first (c, k)."""
    c, k = first.shape
    pos = (first[..., None] + torch.arange(4)).reshape(c, 4 * k)
    got = line.gather(-1, pos.expand(line.shape[:-2] + pos.shape))
    return (got.reshape(line.shape[:-1] + (k, 4)) * weights).sum(-1)


def tap(v, p, fs):
    """The delay line's read of a whole signal v (..., c, n) written into
    a silent line, with no recirculation: s[n] = cubic tap of v at d[n]."""
    v = torch.tensor(np.asarray(v, np.float64))
    first, weights, _d = taps(p, fs, *v.shape[-2:])
    line = torch.cat([v.new_zeros(v.shape[:-1] + (history(fs),)), v], -1)
    return _read(line, first, weights).numpy()


def apply(x, p, fs):
    x = torch.tensor(np.asarray(x, np.float64))
    c, n = x.shape[-2:]
    h = history(fs)
    first, weights, d = taps(p, fs, c, n)
    step = int(torch.ceil(d.min())) - 2
    line = x.new_zeros(x.shape[:-1] + (h + n,))
    s = torch.empty_like(x)
    for a in range(0, n, step):
        b = min(n, a + step)
        s[..., a:b] = _read(line, first[:, a:b], weights[:, a:b])
        line[..., h + a:h + b] = x[..., a:b] + p["feedback"] * s[..., a:b]
    return ((1.0 - p["mix"]) * x + p["mix"] * s).numpy()
