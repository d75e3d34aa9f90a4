"""Phaser: LFO-swept cascade of first-order allpass sections (port of
aefs_tpu/models/phaser.py).

Each allpass H(z) = (a + z^-1)/(1 + a z^-1) is the recurrence
y[n] = a[n] x[n] + x[n-1] - a[n] y[n-1], first-order affine with a
per-sample multiplier: four ``affine_hillis`` scans per block.  The LFO
sweeps the corner exponentially between min_hz and max_hz (phase pair as
in models/lfo.py); ``spread`` offsets the right channel in cycles.  The
allpasses preserve the norm, so float32 rounding is not amplified.
mix = 0 is an exact passthrough.
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import (
    TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp, spread_channels)
from aefs_tpu_torch.ops.scan import affine_hillis

N_STAGES = 4


class Phaser(EffectModel):
    kind = "phaser"

    PARAMS = {
        "rate_hz": ParamSpec(0.5, 0.05, 10.0, smooth="mult", step=0.05),
        "min_hz": ParamSpec(200.0, 50.0, 2000.0, smooth="mult", step=0.1),
        "max_hz": ParamSpec(1600.0, 100.0, 8000.0, smooth="mult", step=0.1),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.25, 0.0, 0.5, smooth="instant"),
    }

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {
            "ph_hi": zero,
            "ph_lo": zero.clone(),
            # per-stage carried x[n-1] / y[n-1], per channel
            "xprev": torch.zeros((self.channels, N_STAGES), device=self.device),
            "yprev": torch.zeros((self.channels, N_STAGES), device=self.device),
        }

    def process(self, state, p, x):
        c, n = x.shape[-2:]
        fs = fs_tensor(self.fs, x.device)
        dph = p["rate_hz"] / fs
        ph_c = spread_channels(lfo_ramp(state["ph_hi"], state["ph_lo"], dph, n),
                               p["spread"], c)

        # Exponential corner sweep (min <= max even mid-glide), allpass
        # coefficient from tan.
        lo = lead(torch.minimum(p["min_hz"], p["max_hz"]), 2)
        hi = lead(torch.maximum(p["min_hz"], p["max_hz"]), 2)
        sweep = 0.5 * (1.0 + f64(torch.sin, TWO_PI * ph_c))
        f = lo * f64(torch.pow, hi / lo, sweep)
        t = f64(torch.tan, math.pi * f / fs)
        a = (t - 1.0) / (t + 1.0)

        y = x
        xprev, yprev = [], []
        for s in range(N_STAGES):
            xm1 = torch.cat([state["xprev"][..., s:s + 1], y[..., :-1]], -1)
            out = affine_hillis(-a, a * y + xm1, state["yprev"][..., s:s + 1])
            xprev.append(y[..., -1])
            yprev.append(out[..., -1])
            y = out

        mix = lead(p["mix"], 2)
        mixed = (1.0 - mix) * x + mix * y
        ph_hi, ph_lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return {
            "ph_hi": ph_hi,
            "ph_lo": ph_lo,
            "xprev": torch.stack(xprev, -1),
            "yprev": torch.stack(yprev, -1),
        }, mixed
