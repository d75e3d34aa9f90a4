"""Octaver: a two-grain pitch shifter over a ring of the mono mix.  Two
read heads half a period apart sweep the ring at the phasor's rate, each
read by a 4-point cubic, crossfaded by Hann gains; the wet signal is
blended with the dry input."""

import numpy as np

DEFAULTS = {"semitones": -12.0, "mix": 0.5, "window_ms": 40.0}


def _cubic(frac, y0, y1, y2, y3):
    c1 = 0.5 * (y2 - y0)
    c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    return ((c3 * frac + c2) * frac + c1) * frac + y1


def apply(x, p, fs):
    size = max(int(fs * p["window_ms"] / 1000.0), 16)
    n = x.shape[-1]
    mono = x.mean(axis=-2)
    # ring index j at sample i holds the newest sample m <= i with m = j mod size
    hist = np.concatenate([np.zeros(mono.shape[:-1] + (size,)), mono], axis=-1)
    i = np.arange(n)
    step = (1.0 - 2.0 ** (p["semitones"] / 12.0)) / size
    p1 = np.mod(i * step, 1.0)
    p2 = p1 + 0.5
    p2 = np.where(p2 >= 1.0, p2 - 1.0, p2)
    wet = 0.0
    for ph in (p1, p2):
        raw = (i % size) - ph * size + size
        fl = np.floor(raw).astype(np.int64)
        taps = [hist[..., i - np.mod(i - (fl + k), size) + size] for k in (-1, 0, 1, 2)]
        wet = wet + _cubic(raw - fl, *taps) * (0.5 * (1.0 - np.cos(2.0 * np.pi * ph)))
    return x * (1.0 - p["mix"]) + wet[..., None, :] * p["mix"]
