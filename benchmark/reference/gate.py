"""Noise gate: a per-sample gain that glides towards 1 while the louder
channel's level is above the threshold (attack coefficient) and towards
0 otherwise (release coefficient), starting closed."""

import numpy as np

from ._scan import affine, f32_release

DEFAULTS = {"threshold_db": -40.0, "attack_ms": 10.0, "release_ms": 100.0}


def apply(x, p, fs):
    thresh = 10.0 ** (p["threshold_db"] / 20.0)
    att, rel = f32_release(p["attack_ms"], fs), f32_release(p["release_ms"], fs)
    opening = np.max(np.abs(x), axis=-2) > thresh
    # The gain is below 1 whenever it opens and at least 0 when it closes,
    # so the coefficient follows the target alone.
    c = np.where(opening, att, rel)
    g = affine(1.0 - c, c * opening)
    return x * g[..., None, :]
