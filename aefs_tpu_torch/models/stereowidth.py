"""Stereo width / balance by mid-side processing (port of
aefs_tpu/models/stereowidth.py).

    M = (L + R)/2,  S = (L - R)/2 * width
    L' = (M + S) * bal_l,  R' = (M - S) * bal_r

with the balance law bal_l = min(1, 1 - pan), bal_r = min(1, 1 + pan).
Stateless elementwise math; a mono branch passes through unchanged.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead


class StereoWidth(EffectModel):
    kind = "stereowidth"

    PARAMS = {
        "width": ParamSpec(1.0, 0.0, 2.0, smooth="step", step=0.02),
        "pan": ParamSpec(0.0, -1.0, 1.0, smooth="step", step=0.02),
    }

    def process(self, state, p, x):
        if x.shape[-2] != 2:  # mono branch context: nothing to widen
            return state, x
        left, right = x[..., 0, :], x[..., 1, :]
        m = 0.5 * (left + right)
        s = 0.5 * (left - right) * lead(p["width"])
        bal_l = lead(torch.clamp(1.0 - p["pan"], max=1.0))
        bal_r = lead(torch.clamp(1.0 + p["pan"], max=1.0))
        return state, torch.stack([(m + s) * bal_l, (m - s) * bal_r], -2)
