"""Tremolo / auto-pan: amplitude LFO (port of aefs_tpu/models/tremolo.py).

gain[n] = 1 - depth/2 * (1 + sin(2*pi*ph[n])), elementwise, so a block is
exact to float32 rounding at any block size; the phase carries across
blocks as the TwoSum pair (models/lfo.py).  ``spread`` offsets the right
channel's phase in cycles: 0.5 makes it an auto-panner.  depth = 0 is an
exact passthrough.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import (
    TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp, spread_channels)


class Tremolo(EffectModel):
    kind = "tremolo"

    PARAMS = {
        "rate_hz": ParamSpec(5.0, 0.05, 20.0, smooth="mult", step=0.05),
        "depth": ParamSpec(0.5, 0.0, 1.0, smooth="step", step=0.02),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {"ph_hi": zero, "ph_lo": zero.clone()}

    def process(self, state, p, x):
        c, n = x.shape[-2:]
        dph = p["rate_hz"] / fs_tensor(self.fs, x.device)
        ph_c = spread_channels(lfo_ramp(state["ph_hi"], state["ph_lo"], dph, n),
                               p["spread"], c)
        gain = 1.0 - 0.5 * lead(p["depth"], 2) * (1.0 + f64(torch.sin, TWO_PI * ph_c))
        hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return {"ph_hi": hi, "ph_lo": lo}, x * gain
