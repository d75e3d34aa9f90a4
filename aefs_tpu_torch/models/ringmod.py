"""Ring modulator: carrier multiplication (port of aefs_tpu/models/ringmod.py).

The carrier phase rides an exact 32-bit modular accumulator:
``num = round(f/fs * 2^32)`` phase units per sample, per-sample phase
``(acc + n*num) mod 2^32``, converted to cycles only at the sin, so the
carry across blocks is exact and blocking invariance is bitwise.

The state keeps ``acc`` as a ``torch.uint32`` 0-dim tensor, the JAX
package's dtype, so state trees cross between the packages unchanged
(core/convert.py).  Torch has almost no uint32 arithmetic: the ramp runs
in int64 (``idx * num`` stays below 2^63 for any signal shorter than 2^31
samples) masked to the low 32 bits, which is the same mod-2^32 result.
The int64 -> float32 conversion rounds to nearest, as XLA's uint32 ->
float32 does.  ``spread`` offsets the right channel's carrier phase in
cycles; mix = 0 is an exact passthrough.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import TWO_PI, f64, spread_channels

_MASK32 = 0xFFFFFFFF
_INV_PHASE = float(np.float32(2.0**-32))
# The largest float32 below 2^32: at f == fs the product rounds to 2^32,
# whose integer conversion is backend-defined (reference ringmod.py:55-58).
_MAX_STEP = 2.0**32 - 256.0


def u32_zero(device):
    """A 0-dim uint32 zero on ``device`` (made on the host and copied)."""
    return torch.zeros((), dtype=torch.uint32).to(device)


def phase_step_u32(freq_hz, fs):
    """Quantize a frequency to phase units per sample,
    round(f32(f) * f32(2^32 / fs)), as an int64 0-dim tensor.  The scale is
    one host float64 division rounded to float32; on the device only a
    float32 multiply and a round-half-to-even."""
    scale = torch.full((), float(np.float32(2.0**32 / float(fs))), device=freq_hz.device)
    step = torch.minimum(torch.round(freq_hz * scale),
                         torch.full((), _MAX_STEP, device=freq_hz.device))
    return step.to(torch.int64)


def phase_ramp_u32(acc, num, n: int):
    """(acc + arange(n) * num) mod 2^32 as int64 (..., n) for slot-wise
    (...) acc and num."""
    idx = torch.arange(n, dtype=torch.int64, device=num.device)
    return (lead(acc.to(torch.int64)) + idx * lead(num)) & _MASK32


def phase_ramp_cycles(acc, num, n: int):
    """The exact modular ramp in cycles: float32 (..., n)."""
    return phase_ramp_u32(acc, num, n).to(torch.float32) * _INV_PHASE


def advance_u32(acc, num, n: int):
    """acc + n * num mod 2^32, as uint32."""
    return ((acc.to(torch.int64) + n * num) & _MASK32).to(torch.uint32)


class RingMod(EffectModel):
    kind = "ringmod"

    PARAMS = {
        "carrier_hz": ParamSpec(440.0, 0.5, 5000.0, smooth="mult", step=0.05),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def init_state(self):
        return {"acc": u32_zero(self.device)}

    def process(self, state, p, x):
        c, n = x.shape[-2:]
        num = phase_step_u32(p["carrier_hz"], self.fs)
        ph_c = spread_channels(phase_ramp_cycles(state["acc"], num, n), p["spread"], c)
        carrier = f64(torch.sin, TWO_PI * ph_c)
        mix = lead(p["mix"], 2)
        y = (1.0 - mix) * x + mix * (x * carrier)
        return {"acc": advance_u32(state["acc"], num, n)}, y
