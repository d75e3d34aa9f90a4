"""Look-ahead brickwall limiter (port of aefs_tpu/models/limiter.py).

Three parallel stages:

1. window floor: g_t[n] = min(1, ceiling/peak[n]) (stereo-linked peak),
   then its minimum over the trailing W-sample window
   (``ops/scan.py:window_min_trailing``);
2. release: v[n] = min(u[n], a*v[n-1] + (1-a)*u[n])
   (``ops/scan.py:minaffine_hillis``);
3. attack ramp: the W-point moving average of v
   (``ops/scan.py:window_sum_trailing``).

The output is x delayed by D = W-1 samples times that gain.
``lookahead_ms`` sets W and the delay line, so it is static (a host
integer); ``drive_db`` pushes gain into the ceiling.  The release
coefficient is evaluated in float64 and rounded once
(``models/lfo.py:f64``): its ulp would grow by 1/(1-a) in the release
recursion, and torch's float32 exp differs by an ulp between its CPU and
CUDA builds.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import f64, fs_tensor
from aefs_tpu_torch.ops.scan import (
    minaffine_hillis,
    window_min_trailing,
    window_sum_trailing,
)

_DB_TO_LOG2 = 1.0 / 6.0206  # dB -> exponent of 2, as a float32 product


class Limiter(EffectModel):
    kind = "limiter"

    PARAMS = {
        "ceiling_db": ParamSpec(-1.0, -24.0, 0.0, smooth="step", step=0.25),
        "release_ms": ParamSpec(80.0, 10.0, 1000.0, smooth="mult", step=0.05),
        "drive_db": ParamSpec(0.0, -12.0, 24.0, smooth="step", step=0.25),
    }

    def __init__(self, fs, blocksize, channels=2, device="cpu", **config):
        super().__init__(fs, blocksize, channels, device, **config)
        la_ms = float(config.get("lookahead_ms", 5.0))
        self.window = max(int(round(la_ms * fs / 1000.0)), 1) + 1  # >= 2
        self.delay = self.window - 1

    def init_state(self):
        return {
            "xh": torch.zeros((self.channels, self.delay), device=self.device),
            "vh": torch.ones((self.window - 1,), device=self.device),
            "g": torch.ones((), device=self.device),
        }

    def process(self, state, p, x):
        n = x.shape[-1]
        w, d = self.window, self.delay
        k = torch.full((), _DB_TO_LOG2, device=x.device)
        gain_in = f64(torch.exp2, p["drive_db"] * k)
        ceiling = f64(torch.exp2, p["ceiling_db"] * k)

        xd = lead(gain_in, 2) * x
        ext = torch.cat([state["xh"], xd], -1)  # (..., C, D + N)
        peak = torch.amax(torch.abs(ext), -2)  # stereo-linked, (..., D + N)
        # The history window's targets are recomputed with the CURRENT
        # ceiling and drive each block, as in the JAX package.
        gt = torch.clamp(lead(ceiling) / torch.clamp(peak, min=1e-30), max=1.0)
        u = window_min_trailing(gt[..., None, :], w, n)[..., 0, :]

        a_r = lead(f64(torch.exp, torch.full_like(k, -1000.0)
                       / (p["release_ms"] * fs_tensor(self.fs, x.device))))
        v = minaffine_hillis(a_r, (1.0 - a_r) * u, u, lead(state["g"]))

        vext = torch.cat([state["vh"], v], -1)  # (..., D + N)
        g = window_sum_trailing(vext[..., None, :], w, n)[..., 0, :] * (1.0 / w)
        y = g[..., None, :] * ext[..., :n]  # x delayed by D
        return {"xh": ext[..., -d:], "vh": vext[..., -(w - 1):], "g": v[..., -1]}, y
