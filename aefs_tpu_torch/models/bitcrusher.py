"""Bitcrusher: sample-and-hold decimation + bit-depth quantization (port
of aefs_tpu/models/bitcrusher.py).

- The decimation clock is the ring modulator's exact 32-bit modular ramp
  (models/ringmod.py): sample n is fresh iff ``(acc + n*num) mod 2^32 <
  num``, so the trigger pattern is independent of the block split.
- Sample-and-hold is the latch h[n] = a[n]*h[n-1] + b[n] with a = 1 -
  fresh in {0, 1} and b = fresh * q(x), an ``affine_hillis`` scan that is
  exact: every product zeroes or passes an operand unchanged.
- q(x) = round(x * L) / L with L = 2^(bits-1).  L is built as an exact
  power of two times exp2 of the fractional part (exp2(0) = 1 exactly), so
  at integer ``bits`` it is exact on every device; the reference's XLA
  exp2 is exact up to 2^12 on the CPU, so the two agree bit for bit at
  integer bits up to 13.

mix = 0 is an exact passthrough.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import f64
from aefs_tpu_torch.models.ringmod import advance_u32, phase_ramp_u32, phase_step_u32, u32_zero
from aefs_tpu_torch.ops.scan import affine_hillis


def exact_exp2(e):
    """2^e for float32 ``e`` in [0, 127) (elementwise): an exact power of two
    (built from its exponent bits) times exp2 of the fractional part."""
    k = torch.floor(e)
    pow2 = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return f64(torch.exp2, e - k) * pow2


class Bitcrusher(EffectModel):
    kind = "bitcrusher"

    PARAMS = {
        "bits": ParamSpec(8.0, 1.0, 16.0, smooth="step", step=0.25),
        "rate_hz": ParamSpec(8000.0, 300.0, 48000.0, smooth="mult", step=0.05),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
    }

    def init_state(self):
        return {
            "acc": u32_zero(self.device),
            "held": torch.zeros((self.channels,), device=self.device),
        }

    def process(self, state, p, x):
        n = x.shape[-1]
        num = phase_step_u32(p["rate_hz"], self.fs)
        ramp = phase_ramp_u32(state["acc"], num, n)
        fresh = (ramp < lead(num)).to(torch.float32)[..., None, :]

        levels = lead(exact_exp2(p["bits"] - 1.0), 2)
        q = torch.round(x * levels) / levels

        held = affine_hillis(1.0 - fresh, fresh * q, state["held"][..., None])
        mix = lead(p["mix"], 2)
        y = (1.0 - mix) * x + mix * held
        return {"acc": advance_u32(state["acc"], num, n), "held": held[..., -1]}, y
