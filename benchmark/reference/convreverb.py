"""Convolution reverb: each channel convolved with its own impulse
response, blended with the dry signal and clipped.  Per channel c and
sample n, with h_c the IR of L taps:

    wet_c[n] = sum_{k=0}^{L-1} h_c[k] x_c[n - k]        (x_c[m] = 0 for m < 0)
    y_c[n]   = clip(mix_dry x_c[n] + mix_wet wet_c[n], -1, 1)

The program computes the sum by uniformly partitioned FFT convolution
(Gardner, "Efficient Convolution without Input-Output Delay", JAES 43(3),
1995): the IR in partitions of one hop, a frequency-domain delay line of
the input's spectra, and on a whole file one long transform.  This file
convolves directly instead: one FFT of each channel and of its IR, of a
length of at least N + L - 1, their product and the inverse, the first
N samples kept.  Plain torch on the CPU, in the input's dtype (float64;
a control may hand it float32).

The IR is this configuration's weights, regenerated here: seeded
(numpy's ``default_rng(1234)``) standard normal noise, one row a channel,
under an exponential envelope that falls 60 dB from the first tap to the
last, each row scaled to unit energy, then rounded to float32, as the
program holds it.  Departures from a real hall: the IR is synthetic, not
measured; the channels' tails are uncorrelated noise with one decay
time for every frequency.
"""

import numpy as np
import torch

DEFAULTS = {"ir_seconds": 2.0, "mix_dry": 0.7, "mix_wet": 0.4}

IR_SEED = 1234


def impulse_response(fs, seconds, channels=2):
    """(channels, L) float32: L = int(fs * seconds), at least 1."""
    length = max(int(fs * seconds), 1)
    noise = torch.from_numpy(np.random.default_rng(IR_SEED).standard_normal((channels, length)))
    t = torch.arange(length, dtype=torch.float64)
    env = torch.pow(torch.tensor(10.0, dtype=torch.float64), -3.0 * t / max(length - 1, 1))
    ir = noise * env
    ir = ir / torch.sqrt(torch.sum(ir * ir, dim=1, keepdim=True))
    return ir.to(torch.float32)


def convolve(x, ir):
    """x (..., C, N) convolved with ir (C, L) along the last axis, the
    first N samples, in x's dtype."""
    n, length = x.shape[-1], ir.shape[-1]
    size = 1 << (n + length - 2).bit_length()  # a power of two >= N + L - 1
    spec = torch.fft.rfft(x, size) * torch.fft.rfft(ir.to(x.dtype), size)
    return torch.fft.irfft(spec, size)[..., :n]


def apply(x, p, fs):
    x = torch.from_numpy(np.ascontiguousarray(x))
    ir = impulse_response(fs, float(p["ir_seconds"]), x.shape[-2])
    y = torch.clamp(p["mix_dry"] * x + p["mix_wet"] * convolve(x, ir), -1.0, 1.0)
    return y.numpy()
