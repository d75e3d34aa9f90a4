"""Flanger with feedback: LFO-swept fractional-delay comb whose output
recirculates into the delay line (port of aefs_tpu/models/flanger.py).

Per channel:
    d[n] = clip((base_ms + depth_ms*sin(2*pi*ph[n])) * fs/1000, D_MIN, Hmax)
    v[n] = x[n] + feedback * s[n]        (delay-line signal)
    s[n] = cubic tap of v at distance d[n]
    y[n] = (1-mix) * x[n] + mix * s[n]

One solver serves every block: ``_solve`` hands every sample's delay
ceiling and cubic weights to ``ops/kernels/flanger.py:flanger_file``
(kernel K6 on the card, its plain version on the CPU), which runs the
recurrence directly for every file, slot and channel in one call.  Its
contract is the delay floor D_MIN = 24 samples: a tap reaches at least 22
samples back, so the solve takes 22 or more samples at a time.  The JAX
package solves the same recurrence with dense one-hot tap operators and
matmuls; the port's sums differ from those at the rounding level only.

The two entry points differ only in where the phases come from.
``process`` (streaming, any block length) ramps them chunk by chunk from
the carried phase, advancing it 256 samples at a time, so 256-sample
streaming and 4096-sample blocks agree bit for bit.  ``process_file``
takes every chunk's start from the parallel double-single ramp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import (
    TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp, spread_channels)
from aefs_tpu_torch.ops.dsphase import _two_sum
from aefs_tpu_torch.ops.kernels.flanger import D_MIN, flanger_file
from aefs_tpu_torch.ops.ringbuf import cubic_tap_weights

MAX_BASE_MS = 10.0
MAX_DEPTH_MS = 5.0
_CHUNK = 256


def _ds_phase(i, dph, hi0, lo0):
    """Double-single phase hi + lo ~= hi0 + lo0 + i*dph (hi in [0, 1)) for
    float32 sample indices i < 2^24: i and dph are Veltkamp-split so every
    partial product is exact, then TwoSum-accumulated."""
    s = dph * 4097.0
    d_hi = s - (s - dph)
    d_lo = dph - d_hi
    i_hi = torch.floor(i * (1.0 / 4096.0)) * 4096.0
    i_lo = i - i_hi
    hi, e1 = _two_sum(i_hi * d_hi, i_hi * d_lo)
    hi, e2 = _two_sum(hi, i_lo * d_hi)
    lo = e1 + e2 + i_lo * d_lo
    hi, e3 = _two_sum(hi, hi0)
    lo = lo + (e3 + lo0)
    return hi - torch.floor(hi), lo


class Flanger(EffectModel):
    kind = "flanger"

    PARAMS = {
        "rate_hz": ParamSpec(0.3, 0.05, 5.0, smooth="mult", step=0.05),
        "depth_ms": ParamSpec(2.0, 0.0, MAX_DEPTH_MS, smooth="step", step=0.1),
        "base_ms": ParamSpec(2.5, 0.5, MAX_BASE_MS, smooth="step", step=0.25),
        "feedback": ParamSpec(0.6, -0.9, 0.9, smooth="step", step=0.02),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        self.hist_len = int((MAX_BASE_MS + MAX_DEPTH_MS) * fs / 1000.0) + 8

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {
            "hist": torch.zeros((self.channels, self.hist_len), device=self.device),
            "ph_hi": zero,
            "ph_lo": zero.clone(),
        }

    def _delay(self, p, ph_c, fs):
        """Delay in samples for (..., C, N) phases, clipped to [D_MIN, H-2];
        slot-wise (S,) params meet (S, C, N) phases."""
        delay_ms = lead(p["base_ms"], 2) + lead(p["depth_ms"], 2) * f64(torch.sin, TWO_PI * ph_c)
        ms_per_s = torch.full((), 1000.0, device=fs.device)
        return torch.clamp(delay_ms * (fs / ms_per_s), float(D_MIN), float(self.hist_len - 2))

    def operands(self, p, x, ramp):
        """``flanger_file``'s signal operands for x (..., C, n) at LFO
        phases ``ramp`` (..., m*256), before the channel spread: x padded
        to whole 256-sample chunks (a fresh tensor), every sample's delay
        ceiling ca (int32) and its four cubic weights w (4, ..., C,
        m*256)."""
        d = self._delay(p, spread_channels(ramp, p["spread"], x.shape[-2]),
                        fs_tensor(self.fs, x.device))
        ca = torch.ceil(d)
        w = torch.stack(cubic_tap_weights(ca - d))
        xp = F.pad(x, (0, ramp.shape[-1] - x.shape[-1])).contiguous()
        return xp, ca.to(torch.int32), w

    def file_phases(self, state, p, n: int):
        """A whole file's phases: every sample's (..., m*256), each chunk's
        start from the parallel double-single ramp and in-chunk the same
        hi + (lo + idx*dph) as ``lfo_ramp``; and the phase (hi, lo) carried
        ``n`` samples on."""
        hi, lo = state["ph_hi"], state["ph_lo"]
        dev = hi.device
        dph = p["rate_hz"] / fs_tensor(self.fs, dev)
        m = -(-n // _CHUNK)
        gi = torch.arange(m, dtype=torch.float32, device=dev) * float(_CHUNK)
        chi, clo = _ds_phase(gi, dph, lead(hi), lead(lo))
        idx = torch.arange(_CHUNK, dtype=torch.float32, device=dev)
        ramp = (chi[..., None] + (clo[..., None] + idx * dph)).flatten(-2)
        return (ramp,) + lfo_advance(hi, lo, dph, n)

    def _solve(self, state, p, x, ramp, hi, lo):
        """The line solve of x (..., C, n) at phases ``ramp`` in one call of
        ``flanger_file``; the carry is the line's last H samples and the
        phase (hi, lo)."""
        n = x.shape[-1]
        xp, ca, w = self.operands(p, x, ramp)
        ys, vs = flanger_file(xp, ca, w, lead(p["feedback"]), lead(p["mix"]),
                              state["hist"].contiguous())
        hist = torch.cat([state["hist"], vs[..., :n]], -1)[..., -self.hist_len:]
        return {"hist": hist, "ph_hi": hi, "ph_lo": lo}, ys[..., :n]

    def process(self, state, p, x):
        """A block of any length: the phases ramp 256 samples at a time
        from the carried phase.  x (..., C, n); slot-wise params and state
        with a leading slot axis."""
        n = x.shape[-1]
        dph = p["rate_hz"] / fs_tensor(self.fs, x.device)
        hi, lo = state["ph_hi"], state["ph_lo"]
        ramps = []
        for _ in range(-(-n // _CHUNK)):
            ramps.append(lfo_ramp(hi, lo, dph, _CHUNK))
            hi, lo = lfo_advance(hi, lo, dph, _CHUNK)
        if n % _CHUNK:  # a padded block carries the phase n samples on
            hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return self._solve(state, p, x, torch.cat(ramps, -1), hi, lo)

    def process_file(self, state, p, x):
        """Whole-file path: the parallel ramp's phases, then the same solve,
        one call for every file and channel.  x: (C, N), or (F, C, N) for
        F files with (F, ...) state."""
        return self._solve(state, p, x, *self.file_phases(state, p, x.shape[-1]))
