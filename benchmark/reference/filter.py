"""RBJ cookbook biquad (types 0 low-pass, 1 high-pass, 2 band-pass,
3 peaking, 4 low shelf, 5 high shelf, 6 all-pass), float64 coefficients,
the cutoff held under 0.45 fs.  A float32 input is filtered in float32,
its coefficients rounded to it (the control, ``refchain``)."""

import numpy as np
from scipy.signal import lfilter

DEFAULTS = {"filter_type": 0.0, "cutoff_hz": 1000.0, "q": 0.707, "gain_db": 0.0}


def coefficients(p, fs):
    fc = min(p["cutoff_hz"], float(np.float32(0.45) * np.float32(fs)))
    w0 = 2.0 * np.pi * fc / fs
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * p["q"])
    t = int(round(p["filter_type"]))
    a_ = 10.0 ** (p["gain_db"] / 40.0)
    tsa = 2.0 * np.sqrt(a_) * alpha
    if t == 0:
        b, a = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2], [1 + alpha, -2 * cw, 1 - alpha]
    elif t == 1:
        b, a = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2], [1 + alpha, -2 * cw, 1 - alpha]
    elif t == 2:
        b, a = [alpha, 0.0, -alpha], [1 + alpha, -2 * cw, 1 - alpha]
    elif t == 3:
        b = [1 + alpha * a_, -2 * cw, 1 - alpha * a_]
        a = [1 + alpha / a_, -2 * cw, 1 - alpha / a_]
    elif t == 4:
        b = [a_ * ((a_ + 1) - (a_ - 1) * cw + tsa), 2 * a_ * ((a_ - 1) - (a_ + 1) * cw),
             a_ * ((a_ + 1) - (a_ - 1) * cw - tsa)]
        a = [(a_ + 1) + (a_ - 1) * cw + tsa, -2 * ((a_ - 1) + (a_ + 1) * cw),
             (a_ + 1) + (a_ - 1) * cw - tsa]
    elif t == 5:
        b = [a_ * ((a_ + 1) + (a_ - 1) * cw + tsa), -2 * a_ * ((a_ - 1) + (a_ + 1) * cw),
             a_ * ((a_ + 1) + (a_ - 1) * cw - tsa)]
        a = [(a_ + 1) - (a_ - 1) * cw + tsa, 2 * ((a_ - 1) - (a_ + 1) * cw),
             (a_ + 1) - (a_ - 1) * cw - tsa]
    else:
        b, a = [1 - alpha, -2 * cw, 1 + alpha], [1 + alpha, -2 * cw, 1 - alpha]
    return np.array(b) / a[0], np.array(a) / a[0]


def apply(x, p, fs):
    b, a = coefficients(p, fs)
    dt = np.float32 if np.asarray(x).dtype == np.float32 else np.float64
    return lfilter(b.astype(dt), a.astype(dt), x, axis=-1)
