"""Wah / auto-wah: resonant state-variable filter swept per sample by an
LFO and/or the input envelope (port of aefs_tpu/models/wah.py).

The Chamberlin SVF state s = (low, band) advances as

    s[n] = M[n] @ s[n-1] + (0, f[n]*x[n]),
    M[n] = [[1, f], [-f, 1 - f^2 - f/Q]][n],   f = 2 sin(pi*fc/fs),

a vector recurrence with a different matrix at every sample, solved by the
per-sample 2x2 Hillis scan (``ops/scan.py:mat2_affine_hillis``).  The
sweep blends the LFO (``mode`` 0, phase pair as in models/lfo.py) and an
envelope follower on |x| (``mode`` 1, one-pole ``affine_hillis``); fc
moves log-linearly between min_hz and max_hz.  f is clamped to 95% of the
Jury bound's positive root sqrt(1/Q^2 + 4) - 1/Q, which only acts at low
sample rates.  Output: the resonance-normalised band band/Q against dry.
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp
from aefs_tpu_torch.ops.scan import affine_hillis, mat2_affine_hillis


class Wah(EffectModel):
    kind = "wah"

    PARAMS = {
        "rate_hz": ParamSpec(1.5, 0.05, 8.0, smooth="mult", step=0.05),
        "min_hz": ParamSpec(350.0, 100.0, 1000.0, smooth="mult", step=0.05),
        "max_hz": ParamSpec(2200.0, 300.0, 4000.0, smooth="mult", step=0.05),
        "res": ParamSpec(3.0, 0.5, 8.0, smooth="step", step=0.1),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
        "mode": ParamSpec(0.0, 0.0, 1.0, smooth="instant"),
        "sens": ParamSpec(4.0, 0.5, 20.0, smooth="step", step=0.25),
        "env_ms": ParamSpec(30.0, 5.0, 200.0, smooth="mult", step=0.05),
    }

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {
            "low": torch.zeros((self.channels,), device=self.device),
            "band": torch.zeros((self.channels,), device=self.device),
            "env": zero,
            "ph_hi": zero.clone(),
            "ph_lo": zero.clone(),
        }

    def process(self, state, p, x):
        n = x.shape[-1]
        fs = fs_tensor(self.fs, x.device)
        dph = p["rate_hz"] / fs
        ph = lfo_ramp(state["ph_hi"], state["ph_lo"], dph, n)
        lfo_sweep = 0.5 * (1.0 + f64(torch.sin, TWO_PI * ph))

        mono = torch.mean(torch.abs(x), -2)
        # True divisions (a Python scalar over a tensor is a reciprocal
        # multiply in torch).
        a_e = lead(f64(torch.exp, torch.full((), -1000.0, device=x.device)
                       / (p["env_ms"] * fs)))
        env = affine_hillis(a_e, (1.0 - a_e) * mono, lead(state["env"]))
        env_sweep = torch.clamp(lead(p["sens"]) * env, 0.0, 1.0)

        sweep = lead(1.0 - p["mode"]) * lfo_sweep + lead(p["mode"]) * env_sweep
        lo_hz = lead(torch.minimum(p["min_hz"], p["max_hz"]))
        hi_hz = lead(torch.maximum(p["min_hz"], p["max_hz"]))
        fc = lo_hz * f64(torch.pow, hi_hz / lo_hz, sweep)
        q1 = torch.ones((), device=x.device) / p["res"]
        f = 2.0 * f64(torch.sin, math.pi * fc / fs)
        # Stability clamp (f^2 + 2f/Q < 4), inactive at fs >= 24 kHz.
        f = torch.minimum(f, lead(0.95 * (torch.sqrt(q1 * q1 + 4.0) - q1)))
        fr = f[..., None, :]  # (..., 1, N) against the channels

        low, band = mat2_affine_hillis(
            torch.ones((1, n), device=x.device), fr, -fr,
            (1.0 - f * f - f * lead(q1))[..., None, :], torch.zeros_like(x), fr * x,
            state["low"][..., None], state["band"][..., None])

        mix = lead(p["mix"], 2)
        y = (1.0 - mix) * x + mix * (lead(q1, 2) * band)
        hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return {"low": low[..., -1], "band": band[..., -1], "env": env[..., -1],
                "ph_hi": hi, "ph_lo": lo}, y
