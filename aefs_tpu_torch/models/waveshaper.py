"""Waveshaper distortion (port of aefs_tpu/models/waveshaper.py).

Selectable transfer curves: hard clip (shape 0), tanh (1) and a
normalized cubic soft clip (2), blended with the dry signal and clipped.
Pure elementwise work.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead


class Waveshaper(EffectModel):
    kind = "waveshaper"

    PARAMS = {
        "drive": ParamSpec(4.0, 1.0, 100.0, smooth="mult", step=0.2),
        "shape": ParamSpec(1.0, 0.0, 2.0, smooth="step", step=1.0),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="step", step=0.05),
        "out_gain": ParamSpec(1.0, 0.0, 2.0, smooth="step", step=0.05),
    }

    def process(self, state, p, x):
        u = lead(p["drive"], 2) * x
        hard = torch.clamp(u, -1.0, 1.0)
        soft = 1.5 * hard - 0.5 * hard * hard * hard  # maps +-1 -> +-1
        tanh = torch.tanh(u)

        # torch.round, like jnp.round, rounds half to even.
        t = lead(torch.round(p["shape"]).to(torch.int32), 2)
        wet = torch.where(t == 0, hard, torch.where(t == 1, tanh, soft))

        mix = lead(p["mix"], 2)
        y = lead(p["out_gain"], 2) * (mix * wet + (1.0 - mix) * x)
        return state, torch.clamp(y, -1.0, 1.0)
