"""Feed-forward soft-knee compressor (port of aefs_tpu/models/compressor.py;
Giannoulis/Massberg/Reiss, JAES 2012).

The detector is decoupled into two associative block scans:

    peak[n] = max(|x[n]|, rho * peak[n-1])        (max, x) semiring scan
    env[n]  = (1-att) * env[n-1] + att * peak[n]  affine scan

then the soft-knee gain computer (dB curve, 10^(g/20)) is elementwise.
Blocks of 4096 samples or more take the two-level ``*_scan_long`` forms,
shorter ones ``*_hillis``, exactly as the JAX package chooses: the two
differ by reassociation.

The attack and release coefficients are evaluated in float64 and rounded
once (``models/lfo.py:f64``): the peak decays as rho^k, so an ulp of rho
grows linearly over a release, and torch's float32 exp differs by an ulp
between its CPU and CUDA builds (and from XLA's, which rounds correctly).
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import f64
from aefs_tpu_torch.ops.scan import (
    affine_hillis,
    affine_scan_long,
    maxtimes_hillis,
    maxtimes_scan_long,
)

_ENV_FLOOR = 1e-10  # -200 dBFS: keeps log10 finite on silence


class Compressor(EffectModel):
    kind = "compressor"

    PARAMS = {
        "threshold_db": ParamSpec(-24.0, -60.0, 0.0, smooth="step", step=1.0),
        "ratio": ParamSpec(4.0, 1.0, 20.0, smooth="step", step=0.5),
        "attack_ms": ParamSpec(10.0, 0.1, 500.0, smooth="step", step=1.0),
        "release_ms": ParamSpec(100.0, 10.0, 1000.0, smooth="step", step=10.0),
        "knee_db": ParamSpec(6.0, 0.0, 24.0, smooth="step", step=1.0),
        "makeup_db": ParamSpec(0.0, -12.0, 24.0, smooth="step", step=0.5),
    }

    def init_state(self):
        z = torch.zeros((), device=self.device)
        return {"peak": z, "env": z.clone()}

    def _coeff(self, time_ms):
        """1-pole coefficient 1 - exp(-2.2 / (t * fs)), the gate's 10-90%
        rise-time convention; a true division by a device tensor."""
        t = torch.clamp(time_ms * 1e-3, min=1e-3)
        return 1.0 - f64(torch.exp, torch.full_like(t, -2.2) / (t * float(self.fs)))

    def process(self, state, p, x):
        att = lead(self._coeff(p["attack_ms"]))
        rho = lead(1.0 - self._coeff(p["release_ms"]))  # release multiplier

        level = torch.amax(torch.abs(x), -2)  # stereo-linked peak
        # Whole files (one, or a batch on a leading axis) take the
        # two-level long scans; blocks the full-length Hillis.
        long = x.shape[-1] >= 4096
        peak = (maxtimes_scan_long if long else maxtimes_hillis)(rho, level,
                                                                 lead(state["peak"]))
        env = (affine_scan_long if long else affine_hillis)(1.0 - att, att * peak,
                                                            lead(state["env"]))

        # Soft-knee gain computer (Giannoulis eq. 4), branch-free.
        o = 20.0 * torch.log10(torch.clamp(env, min=_ENV_FLOOR)) - lead(p["threshold_db"])
        w = lead(torch.clamp(p["knee_db"], min=1e-6))
        slope = lead(1.0 / torch.clamp(p["ratio"], min=1.0) - 1.0)
        t = torch.minimum(torch.clamp(o + 0.5 * w, min=0.0), w)
        g_db = slope * (t * t / (2.0 * w) + torch.clamp(o - 0.5 * w, min=0.0))
        gain = torch.pow(10.0, (g_db + lead(p["makeup_db"])) / torch.full_like(w, 20.0))
        return {"peak": peak[..., -1], "env": env[..., -1]}, x * gain[..., None, :]
