"""Noise gate with stereo-linked detection (port of aefs_tpu/models/gate.py).

Because the gate's target is always 0 or 1 and its gain stays in [0, 1],
the reference's attack/release branch (gate.py:6-42) selects on the target
alone, so the gain is a first-order affine recurrence whose coefficients
depend only on the input — a scan, not a sequential loop.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.ops.scan import affine_hillis, affine_scan_long


class NoiseGate(EffectModel):
    kind = "gate"

    PARAMS = {
        "threshold_db": ParamSpec(-40.0, -80.0, 0.0, smooth="step", step=1.0),
        "attack_ms": ParamSpec(10.0, 1.0, 500.0, smooth="step", step=5.0),
        "release_ms": ParamSpec(100.0, 10.0, 1000.0, smooth="step", step=10.0),
    }

    def init_state(self):
        # Gate starts closed (gate.py:53).
        return {"gain": torch.zeros((), device=self.device)}

    def _coeff(self, time_ms):
        """1-pole coefficient 1 - exp(-2.2 / (t * fs)) (gate.py:63-69)."""
        t = torch.clamp(time_ms * 1e-3, min=1e-3)
        # A true division (``-2.2 / t`` would be reciprocal-then-multiply).
        return 1.0 - torch.exp(torch.full_like(t, -2.2) / (t * float(self.fs)))

    def process(self, state, p, x):
        thresh = lead(torch.pow(10.0, p["threshold_db"] / 20.0))
        att = lead(self._coeff(p["attack_ms"]))
        rel = lead(self._coeff(p["release_ms"]))

        level = torch.amax(torch.abs(x), -2)  # stereo-linked (gate.py:21-25)
        open_ = level > thresh
        mult = torch.where(open_, 1.0 - att, 1.0 - rel)
        add = torch.where(open_, att, torch.zeros((), device=x.device))
        # Whole files (one, or a batch on a leading axis) take the
        # two-level long scan; blocks the full-length Hillis.
        scan = affine_scan_long if x.shape[-1] >= 4096 else affine_hillis
        gain = scan(mult, add, lead(state["gain"]))
        return {"gain": gain[..., -1]}, x * gain[..., None, :]
