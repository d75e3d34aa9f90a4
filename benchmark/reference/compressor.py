"""Feed-forward soft-knee compressor: a decaying peak of the louder
channel, smoothed by a one-pole attack, a gain computer with a quadratic
knee, and make-up gain."""

import numpy as np

from ._scan import decaying_peak, f32_release, one_pole

DEFAULTS = {"threshold_db": -24.0, "ratio": 4.0, "attack_ms": 10.0, "release_ms": 100.0,
            "knee_db": 6.0, "makeup_db": 0.0}


def apply(x, p, fs):
    att = f32_release(p["attack_ms"], fs)
    rho = 1.0 - f32_release(p["release_ms"], fs)
    w = max(p["knee_db"], 1e-6)
    slope = 1.0 / max(p["ratio"], 1.0) - 1.0
    peak = decaying_peak(np.max(np.abs(x), axis=-2), rho)
    env = one_pole(peak, 1.0 - att, att)
    o = 20.0 * np.log10(np.maximum(env, 1e-10)) - p["threshold_db"]
    t = np.clip(o + 0.5 * w, 0.0, w)
    g_db = slope * (t * t / (2.0 * w) + np.maximum(o - 0.5 * w, 0.0))
    return x * (10.0 ** ((g_db + p["makeup_db"]) / 20.0))[..., None, :]
