"""Schroeder reverb per side: a pre-delay, four damped feedback combs
summed, two all-passes in series, blended with the dry signal and
clipped to [-1, 1].  The two sides' delay lengths are jittered apart."""

import numpy as np
from scipy.signal import lfilter

from ._scan import delayed, f32_samples, feedback_comb

DEFAULTS = {"rt60_s": 1.5, "damp": 0.3, "pre_delay_ms": 0.0, "mix_dry": 0.7,
            "mix_wet": 0.5, "comb_times_ms": (29.7, 37.1, 41.1, 43.7),
            "allpass_times_ms": (5.0, 1.7), "allpass_gain": 0.6, "jitter_ms": 0.3,
            "max_delay_ms": 200.0, "max_pre_delay_ms": 100.0}


def _lags(fs, times, jitter, max_ms):
    return [max(1, int(fs * min(t + jitter, max_ms - 1.0) / 1000.0)) for t in times]


def damped_comb(u, lag, g, h):
    """y[n] = s[n - lag] with s[n] = u[n] + g lp[n] and the damping
    lp[n] = (1 - h) s[n - lag] + h lp[n - 1]; one loop step per ``lag``
    samples (each chunk's low-pass runs on the previous chunk's s)."""
    n = u.shape[-1]
    s = np.zeros_like(u)
    s[..., :lag] = u[..., :lag]
    zi = np.zeros(u.shape[:-1] + (1,))
    for c in range(lag, n, lag):
        prev = s[..., c - lag: min(c, n - lag)]
        lp, zf = lfilter([1.0 - h], [1.0, -h], prev, axis=-1, zi=zi)
        zi = zf
        s[..., c: c + prev.shape[-1]] = u[..., c: c + prev.shape[-1]] + g * lp
    return delayed(s, lag)


def apply(x, p, fs):
    pre_size = max(1, int(fs * p["max_pre_delay_ms"] / 1000.0) + 1)
    d = min(int(f32_samples(fs, p["pre_delay_ms"])), pre_size - 1)
    a = p["allpass_gain"]
    out = np.empty_like(x)
    for side, sign in enumerate((1.0, -1.0)):
        pre = delayed(x[..., side, :], d)
        acc = 0.0
        for lag in _lags(fs, p["comb_times_ms"], sign * p["jitter_ms"], p["max_delay_ms"]):
            g = 10.0 ** (-3.0 * (lag / fs) / max(1e-3, p["rt60_s"]))
            acc = acc + damped_comb(pre, lag, g, p["damp"])
        for lag in _lags(fs, p["allpass_times_ms"], sign * p["jitter_ms"] * 0.2,
                         p["max_delay_ms"]):
            # s[n] = u[n] + a y[n], y[n] = s[n - lag] - a u[n]
            s = feedback_comb((1.0 - a * a) * acc, lag, a)
            acc = delayed(s, lag) - a * acc
        out[..., side, :] = p["mix_dry"] * x[..., side, :] + p["mix_wet"] * acc
    return np.clip(out, -1.0, 1.0)
