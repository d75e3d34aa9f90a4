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

Two helpers make every call: ``operands`` (the LFO ramp, the envelope
scan, the sweep, f and M[n]'s four coefficient arrays) and ``solve`` (the
2x2 scan, the band/Q mix and the new state).  ``process`` is the captured
streaming step and has no span.  ``process_file`` runs the same two over
a whole file under the spans ``wah.operands`` and ``wah.solve``
(``utils/metrics.py:TRACER``, rid None; the host's enqueue time, with no
device wait) and counts ``wah.file_renders``
(the files in the call) and ``wah.scan_levels`` (the 2x2 scan's
composition levels, ceil(log2 N)).
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp
from aefs_tpu_torch.ops.scan import affine_hillis, mat2_affine_hillis
from aefs_tpu_torch.utils.metrics import TRACER


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

    def operands(self, state, p, x):
        """The sweep's operands for x (..., C, n): M[n]'s four coefficient
        arrays (mp, mq, mr, ms), broadcastable to x; the envelope (..., n);
        the LFO's phase increment; 1/Q."""
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
        m = (torch.ones((1, n), device=x.device), fr, -fr,
             (1.0 - f * f - f * lead(q1))[..., None, :])
        return m, env, dph, q1

    def solve(self, state, p, x, m, env, dph, q1):
        """The filter over x (..., C, n) from ``operands``' results: the
        per-sample 2x2 scan with the drive (0, f x), the band/Q blend
        against dry, and the new state."""
        n = x.shape[-1]
        low, band = mat2_affine_hillis(
            *m, torch.zeros_like(x), m[1] * x,
            state["low"][..., None], state["band"][..., None])

        mix = lead(p["mix"], 2)
        y = (1.0 - mix) * x + mix * (lead(q1, 2) * band)
        hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return {"low": low[..., -1], "band": band[..., -1], "env": env[..., -1],
                "ph_hi": hi, "ph_lo": lo}, y

    def process(self, state, p, x):
        return self.solve(state, p, x, *self.operands(state, p, x))

    def process_file(self, state, p, x):
        """Whole-file path: ``process``'s two helpers over the whole signal,
        each under its span.  The spans time the host's enqueue of the
        ops, not the device's work: nothing here waits for the device.
        x: (C, N), or (F, C, N) for F files with (F, ...) state."""
        TRACER.count("wah.file_renders", x.shape[0] if x.dim() == 3 else 1)
        TRACER.count("wah.scan_levels", (x.shape[-1] - 1).bit_length())
        with TRACER.span("wah.operands"):
            ops = self.operands(state, p, x)
        with TRACER.span("wah.solve"):
            return self.solve(state, p, x, *ops)
