"""Stereo feedback delay / echo (port of aefs_tpu/models/delay.py).

Independent L/R delay lines with the right channel offset for width
(delay.py:84); dry/wet mix and hard clip after the wet sum
(delay.py:94-96).  Streaming runs the blocked fixed-point feedback solve
on a block-row ring (ops/ringbuf.py:feedback_delay_block_rows); file mode
with baked lags is one lag-affine scan per side.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead, ms_to_samples
from aefs_tpu_torch.ops.ringbuf import feedback_delay_block_rows, rowring_rows
from aefs_tpu_torch.ops.scan import lag_affine_scan


class StereoDelay(EffectModel):
    kind = "delay"

    # The block-row ring's row pointer advances once per block regardless
    # of params/audio — lockstep across pool slots (see EffectModel).
    LOCKSTEP_STATE = ("row",)

    PARAMS = {
        "delay_ms": ParamSpec(375.0, 1.0, 1499.0, smooth="step_ms", step=2.0),
        "feedback": ParamSpec(0.2, 0.0, 0.95, smooth="step", step=0.02),
        "mix_dry": ParamSpec(0.8, 0.0, 2.0),
        "mix_wet": ParamSpec(0.8, 0.0, 2.0),
        "offset_ms": ParamSpec(30.0, -1499.0, 1500.0),
    }

    def __init__(self, fs, blocksize, channels=2, max_delay_ms=1500.0,
                 min_delay_ms=1.0, file_delay_ms=None, file_offset_ms=None,
                 **config):
        super().__init__(fs, blocksize, channels, **config)
        self.max_delay_ms = float(max_delay_ms)
        self.min_delay_ms = float(min_delay_ms)
        self.size = int(fs * self.max_delay_ms / 1000.0) + 1
        self.min_delay = max(1, int(fs * float(min_delay_ms) / 1000.0))
        # Static lags for the whole-file path, derived through float32
        # EXACTLY like the blockwise path's runtime arithmetic: a float64
        # derivation disagrees by one sample when the product sits on a
        # truncation boundary (the reference's fuzz finding #4), and a
        # one-sample split between file and blockwise paths is a broadband
        # +6 dB gap.
        self.file_lags = None
        if file_delay_ms is not None:
            f32 = np.float32
            d_l = f32(file_delay_ms)
            d_r = min(max(f32(d_l + f32(file_offset_ms or 0.0)),
                          f32(self.min_delay_ms)),
                      f32(self.max_delay_ms - 1.0))

            def lag(ms):
                d = int(f32(f32(f32(fs) * ms) / f32(1000.0)))
                return min(max(d, 1), self.size - 1)

            self.file_lags = (lag(d_l), lag(d_r))

    def init_state(self):
        r = rowring_rows(self.size, self.blocksize)
        return {
            "lines": torch.zeros((2, r, self.blocksize), device=self.device),
            "row": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def process(self, state, p, x):
        d_l_ms = p["delay_ms"]
        d_r_ms = torch.clamp(d_l_ms + p["offset_ms"],
                             self.min_delay_ms, self.max_delay_ms - 1.0)
        fb = p["feedback"]

        def to_samples(ms):
            return torch.clamp(ms_to_samples(self.fs, ms), 0, self.size - 1)

        d_samples = torch.stack([to_samples(d_l_ms), to_samples(d_r_ms)], -1)
        row = state["row"]  # one shared row for every slot (LOCKSTEP_STATE)
        wet, lines = feedback_delay_block_rows(
            state["lines"], row, x, d_samples, lead(fb, 2), self.min_delay)
        y = torch.clamp(lead(p["mix_dry"], 2) * x + lead(p["mix_wet"], 2) * wet, -1.0, 1.0)
        new_row = torch.remainder(row + 1, lines.shape[-2]).to(torch.int32)
        return {"lines": lines, "row": new_row}, y

    def process_file(self, state, p, x):
        """Whole-file path: with static lags the echo is the lag-affine
        recurrence y[n] = x[n-d] + fb*y[n-d], one residue-class scan per
        side.  Requires fresh line state and the engine-baked delays.
        x: (2, N), or (F, 2, N) for F files."""
        if self.file_lags is None:
            k = -(-x.shape[-1] // self.min_delay)
            if k > 64:
                raise ValueError(
                    "StereoDelay.process_file without baked file delays would "
                    f"unroll {k} fixed-point iterations; build the chain with "
                    "core.fileopts.file_static_overrides (file_delay_ms) for "
                    "the whole-file fast path"
                )
            return self.process(state, p, x)
        fb = p["feedback"]
        n = x.shape[-1]
        files = x.shape[:-2]  # a batched render's file axis, if any
        wets, writes = [], []
        for side, lag in enumerate(self.file_lags):
            xs = x[..., side, :]
            if lag < n:
                base = torch.cat([torch.zeros(files + (lag,), device=x.device),
                                  xs[..., : n - lag]], -1)
            else:
                base = torch.zeros(files + (n,), device=x.device)
            y = lag_affine_scan(base, fb, lag)
            wets.append(y)
            writes.append(xs + fb * y)
        wet = torch.stack(wets, -2)
        w = torch.stack(writes, -2)
        # Rebuild the block-row ring for the final state: the slot of
        # absolute block b is b mod R; the last R blocks land rolled.
        if n % self.blocksize:
            raise ValueError("file fast path requires blocksize-padded input")
        nb = n // self.blocksize
        r = rowring_rows(self.size, self.blocksize)
        wpad = torch.cat([torch.zeros(files + (2, r * self.blocksize), device=x.device), w], -1)
        wpad = wpad[..., -r * self.blocksize :].reshape(*files, 2, r, self.blocksize)
        lines = torch.roll(wpad, (nb - r) % r, dims=-2)
        y = torch.clamp(p["mix_dry"] * x + p["mix_wet"] * wet, -1.0, 1.0)
        # The row is shared by every file (LOCKSTEP_STATE): nb is the same.
        row = torch.tensor(nb % r, dtype=torch.int32, device=x.device)
        return {"lines": lines, "row": row}, y
