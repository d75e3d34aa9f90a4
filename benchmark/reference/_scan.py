"""Vectorised recurrences in float64 NumPy, shared by the effect references.

Every function works along the last axis of its arrays and over any
leading axes at once (streams, channels).  They replace the per-sample
loops of a plain definition with associative scans (Hillis-Steele,
log2(N) passes), decimated first-order filters, or loops over chunks as
long as a delay, so that minutes of audio take seconds.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def affine(a, b, y0=0.0):
    """y[n] = a[n] * y[n-1] + b[n], y[-1] = y0."""
    a = np.array(np.broadcast_to(a, np.shape(b)), np.float64)
    b = np.array(b, np.float64)
    s = 1
    while s < b.shape[-1]:
        # each element composed with the one s places earlier
        b[..., s:] = b[..., s:] + a[..., s:] * b[..., :-s]
        a[..., s:] = a[..., s:] * a[..., :-s]
        s *= 2
    return a * y0 + b


def capped_affine(u, a, y0):
    """y[n] = min(u[n], a * y[n-1] + (1 - a) * u[n]), y[-1] = y0, 0 < a < 1.

    Each step is the map g -> min(C, A g + B); such maps compose into one
    of the same form, so the recurrence is an associative scan."""
    c = np.array(u, np.float64)
    bb = (1.0 - a) * c
    aa = np.full_like(c, a)
    s = 1
    while s < c.shape[-1]:
        c[..., s:] = np.minimum(c[..., s:], aa[..., s:] * c[..., :-s] + bb[..., s:])
        bb[..., s:] = bb[..., s:] + aa[..., s:] * bb[..., :-s]
        aa[..., s:] = aa[..., s:] * aa[..., :-s]
        s *= 2
    return np.minimum(c, aa * y0 + bb)


def decaying_peak(level, rho, p0=0.0):
    """p[n] = max(level[n], rho * p[n-1]), p[-1] = p0, 0 < rho < 1."""
    c = np.array(level, np.float64)
    r = np.full_like(c, rho)
    s = 1
    while s < c.shape[-1]:
        c[..., s:] = np.maximum(c[..., s:], r[..., s:] * c[..., :-s])
        r[..., s:] = r[..., s:] * r[..., :-s]
        s *= 2
    return np.maximum(c, r * p0)


def one_pole(x, a, b=None):
    """y[n] = b * x[n] + a * y[n-1], y[-1] = 0 (b defaults to 1 - a)."""
    b = 1.0 - a if b is None else b
    return lfilter([b], [1.0, -a], x, axis=-1)


def feedback_comb(u, lag, g):
    """s[n] = u[n] + g * s[n - lag], s before the start 0.

    Sample n depends only on samples of its own residue mod ``lag``, so the
    signal reshaped to (chunks, lag) is ``lag`` first-order filters down
    the chunk axis."""
    n = u.shape[-1]
    m = -(-n // lag)
    pad = np.zeros(u.shape[:-1] + (m * lag,), np.float64)
    pad[..., :n] = u
    rows = pad.reshape(u.shape[:-1] + (m, lag))
    s = lfilter([1.0], [1.0, -g], rows, axis=-2)
    return s.reshape(u.shape[:-1] + (m * lag,))[..., :n]


def delayed(x, d):
    """x moved d samples later, zeros in front (d >= 0)."""
    out = np.zeros(np.shape(x), np.float64)
    if d < out.shape[-1]:
        out[..., d:] = x[..., : out.shape[-1] - d]
    return out


def window_min(x, w):
    """out[i] = min(x[i : i + w]) along the last axis; len = len(x) - w + 1."""
    m, k = np.asarray(x, np.float64), 1
    while 2 * k <= w:
        m = np.minimum(m[..., :-k], m[..., k:])
        k *= 2
    n = x.shape[-1] - w + 1
    return np.minimum(m[..., :n], m[..., w - k: w - k + n])


def window_mean(x, w):
    """out[i] = mean(x[i : i + w]) along the last axis, by a running sum
    restarted every 4096 samples against rounding drift."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1] - w + 1
    out = np.empty(x.shape[:-1] + (n,), np.float64)
    step = 4096
    for i in range(0, n, step):
        j = min(n, i + step)
        seg = x[..., i: j + w - 1]
        cs = np.concatenate([np.zeros(seg.shape[:-1] + (1,)), np.cumsum(seg, axis=-1)], axis=-1)
        out[..., i:j] = (cs[..., w: w + j - i] - cs[..., : j - i]) / w
    return out


def f32_release(ms, fs):
    """1 - exp(-2.2 / (t fs)) with every operand float32, as the effects
    compute their smoother coefficients (t = ms / 1000, at least 1 ms)."""
    t = np.float32(max(1e-3, ms * 1e-3))
    return float(np.float32(1.0) - np.exp(np.float32(-2.2) / (t * np.float32(fs))))


def f32_samples(fs, ms):
    """fs * ms / 1000 in float32 (a delay's length in samples, untruncated)."""
    return np.float32(np.float32(fs) * np.float32(ms)) / np.float32(1000.0)
