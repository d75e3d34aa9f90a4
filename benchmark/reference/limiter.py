"""Look-ahead brickwall limiter: the gain that holds each driven sample
under the ceiling, its minimum over the look-ahead window, a release that
rises at most one-pole fast, a moving-average attack ramp over the same
window, and the signal delayed by the window less one."""

import numpy as np

from ._scan import capped_affine, delayed, window_mean, window_min

DEFAULTS = {"ceiling_db": -1.0, "release_ms": 80.0, "drive_db": 0.0, "lookahead_ms": 5.0}


def _f32_db(db):
    return float(np.exp2(np.float32(db) * np.float32(1.0 / 6.0206)))


def apply(x, p, fs):
    w = max(int(round(p["lookahead_ms"] * fs / 1000.0)), 1) + 1
    d = w - 1
    a_r = float(np.exp(np.float32(-1000.0) / (np.float32(p["release_ms"]) * np.float32(fs))))
    xg = _f32_db(p["drive_db"]) * x
    peak = np.max(np.abs(xg), axis=-2)
    floor = np.minimum(1.0, _f32_db(p["ceiling_db"]) / np.maximum(peak, 1e-30))
    ones = np.ones(floor.shape[:-1] + (d,))
    u = window_min(np.concatenate([ones, floor], axis=-1), w)
    g = capped_affine(u, a_r, 1.0)
    ramp = window_mean(np.concatenate([ones, g], axis=-1), w)
    return ramp[..., None, :] * delayed(xg, d)
