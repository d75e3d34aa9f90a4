"""Chorus / vibrato: LFO-modulated fractional delay (port of
aefs_tpu/models/chorus.py).

The read position n - delay[n] is strictly increasing (the LFO slews the
delay far slower than one sample per sample), so the tap is a
feedforward 4-tap Hermite read into hist ++ x.  The LFO phase carries
across blocks as the TwoSum pair (models/lfo.py); ``spread`` offsets the
right channel's phase in cycles, added after the ramp as in the reference.
A block is one call of the block step K3
(``ops/kernels/resample.py:chorus_step``): LFO, delay law, tap, blend,
history and phase advance in one launch over both channels on the card,
its plain eager version on the CPU.

File mode has no separate path: ``process`` over the whole signal is the
reference's ``process_file`` (same phase ramp on the global sample index,
same delay law and clips), one K3 launch.  The reference's dense one-hot
tap operator there exists only to avoid TPU gathers, and differs from the
gather read only in the order of the four-term sum.  mix = 0 is an exact
passthrough.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel
from aefs_tpu_torch.ops.kernels.resample import chorus_step

MAX_BASE_MS = 40.0
MAX_DEPTH_MS = 10.0


class Chorus(EffectModel):
    kind = "chorus"

    PARAMS = {
        "rate_hz": ParamSpec(0.8, 0.05, 10.0, smooth="mult", step=0.05),
        "depth_ms": ParamSpec(3.0, 0.0, MAX_DEPTH_MS, smooth="step", step=0.1),
        "base_ms": ParamSpec(12.0, 1.0, MAX_BASE_MS, smooth="step", step=0.5),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.25, 0.0, 0.5, smooth="instant"),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        # The deepest legal tap plus the cubic read's reach.
        self.hist_len = int((MAX_BASE_MS + MAX_DEPTH_MS) * fs / 1000.0) + 8

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {
            "hist": torch.zeros((self.channels, self.hist_len), device=self.device),
            "ph_hi": zero,
            "ph_lo": zero.clone(),
        }

    def process(self, state, p, x):
        return chorus_step(state, p, x, self.fs)
