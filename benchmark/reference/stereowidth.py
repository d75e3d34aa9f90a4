"""Mid-side width and balance."""

import numpy as np

DEFAULTS = {"width": 1.0, "pan": 0.0}


def apply(x, p, fs):
    m = 0.5 * (x[..., 0, :] + x[..., 1, :])
    s = 0.5 * (x[..., 0, :] - x[..., 1, :]) * p["width"]
    bl, br = min(1.0, 1.0 - p["pan"]), min(1.0, 1.0 + p["pan"])
    return np.stack([(m + s) * bl, (m - s) * br], axis=-2)
