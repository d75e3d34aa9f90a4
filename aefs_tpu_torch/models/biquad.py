"""RBJ-cookbook biquad EQ filter (port of aefs_tpu/models/biquad.py).

Coefficients are recomputed per block from the smoothed type/cutoff/Q;
the type select is branchless over one-hot masks.  The FIR half is a
parallel shift-and-scale, the IIR half a 2x2 companion scan (streaming)
or a chunked Toeplitz solve (long signals, ops/scan.py).  A streaming
block (under 1,024 samples) is one step of ``ops/kernels/biquad.py``:
kernel K5 on the card, these same coefficients and scan on the CPU.
"""

from __future__ import annotations

import math

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel
from aefs_tpu_torch.models.lfo import f64, fs_tensor
from aefs_tpu_torch.ops.kernels.biquad import biquad_step
from aefs_tpu_torch.ops.scan import BIQUAD_FILE_SOLVE, biquad_block


def coefficients(p, fs):
    """RBJ formulas for LP/HP/BP/peak/low shelf/high shelf/allpass,
    branchless over the type, with the 0.45*fs Nyquist clamp: (b0, b1, b2,
    a1, a2) over a0, float32, shaped like the params (0-dim or (S,))."""
    fs = float(fs)
    fc = torch.clamp(p["cutoff_hz"], max=0.45 * fs)
    q = p["q"]
    # A true division by a device tensor, and cos/sin in float64
    # rounded once (models/lfo.py:f64): a low cutoff puts the poles
    # near the unit circle, where the block scan turns an ulp of a
    # coefficient into a large output difference between the card and
    # the CPU.
    w0 = 2.0 * math.pi * fc / fs_tensor(fs, fc.device)
    cw = f64(torch.cos, w0)
    sw = f64(torch.sin, w0)
    alpha = sw / (2.0 * q)

    t = torch.round(p["filter_type"]).to(torch.int32)
    one = [(t == k).to(torch.float32) for k in range(7)]

    gain_db = p.get("gain_db", torch.zeros((), device=fc.device))
    big_a = f64(lambda e: torch.pow(10.0, e), gain_db / torch.full_like(gain_db, 40.0))
    sq = torch.sqrt(big_a)
    tsa = 2.0 * sq * alpha
    ap1, am1 = big_a + 1.0, big_a - 1.0
    zero = torch.zeros((), device=fc.device)

    rows = (
        # (b0, b1, b2, a0, a1, a2) per type
        ((1 - cw) / 2, 1 - cw, (1 - cw) / 2,
         1 + alpha, -2 * cw, 1 - alpha),                     # 0 LP
        ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2,
         1 + alpha, -2 * cw, 1 - alpha),                     # 1 HP
        (alpha, zero, -alpha,
         1 + alpha, -2 * cw, 1 - alpha),                     # 2 BP
        (1 + alpha * big_a, -2 * cw, 1 - alpha * big_a,
         1 + alpha / big_a, -2 * cw, 1 - alpha / big_a),     # 3 peak
        (big_a * (ap1 - am1 * cw + tsa), 2 * big_a * (am1 - ap1 * cw),
         big_a * (ap1 - am1 * cw - tsa),
         ap1 + am1 * cw + tsa, -2 * (am1 + ap1 * cw),
         ap1 + am1 * cw - tsa),                              # 4 low shelf
        (big_a * (ap1 + am1 * cw + tsa), -2 * big_a * (am1 + ap1 * cw),
         big_a * (ap1 + am1 * cw - tsa),
         ap1 - am1 * cw + tsa, 2 * (am1 - ap1 * cw),
         ap1 - am1 * cw - tsa),                              # 5 high shelf
        (1 - alpha, -2 * cw, 1 + alpha,
         1 + alpha, -2 * cw, 1 - alpha),                     # 6 allpass
    )
    b0, b1, b2, a0, a1, a2 = (
        sum(one[k] * rows[k][j] for k in range(7)) for j in range(6)
    )
    return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0


class BiquadFilter(EffectModel):
    kind = "filter"

    PARAMS = {
        "filter_type": ParamSpec(0.0, 0.0, 6.0, smooth="step", step=1.0),
        "cutoff_hz": ParamSpec(1000.0, 20.0, 20000.0, smooth="mult", step=0.1),
        "q": ParamSpec(0.707, 0.1, 10.0, smooth="step", step=0.1),
        "gain_db": ParamSpec(0.0, -24.0, 24.0, smooth="step", step=0.5),
    }

    def init_state(self):
        return {"df1": torch.zeros((self.channels, 4), device=self.device)}

    def process(self, state, p, x):
        if x.shape[-1] < BIQUAD_FILE_SOLVE:
            return biquad_step(state, p, x, self.fs)
        y, df1 = biquad_block(x, *coefficients(p, self.fs), state["df1"])
        return {"df1": df1}, y
