"""Stereo feedback delay: each side an echo line of its own length (the
right one offset), fed back into itself, blended with the dry signal and
clipped to [-1, 1]."""

import numpy as np

from ._scan import delayed, f32_samples, feedback_comb

DEFAULTS = {"delay_ms": 375.0, "feedback": 0.2, "mix_dry": 0.8, "mix_wet": 0.8,
            "offset_ms": 30.0, "max_delay_ms": 1500.0, "min_delay_ms": 1.0}


def apply(x, p, fs):
    size = int(fs * p["max_delay_ms"] / 1000.0) + 1
    d_l = p["delay_ms"]
    d_r = min(max(d_l + p["offset_ms"], p["min_delay_ms"]), p["max_delay_ms"] - 1.0)
    out = np.empty_like(x)
    for side, ms in enumerate((d_l, d_r)):
        d = min(int(f32_samples(fs, ms)), size - 1)
        wet = delayed(feedback_comb(x[..., side, :], d, p["feedback"]), d)
        out[..., side, :] = p["mix_dry"] * x[..., side, :] + p["mix_wet"] * wet
    return np.clip(out, -1.0, 1.0)
