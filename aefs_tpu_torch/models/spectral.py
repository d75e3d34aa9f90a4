"""STFT spectral noise gate (port of aefs_tpu/models/spectral.py).

50%-overlap Hann-windowed frames of the mono mix, a per-bin binary mask
against a linear threshold, temporal mask smoothing (alpha = 0.8), and the
cleaned mono signal on every output channel.  All hops of a block are
framed and transformed as a batch; the temporal smoothing is a
first-order scan over the frame axis.  The hop is pinned at 256 whatever
the block size, so file mode and streaming produce the same spectra.

An optional learned **noise profile** (static config: the per-bin mean
magnitude of a noise-only capture, ``measure_noise_profile``) makes the
threshold per-bin:

    thresh_bin = max(threshold, profile_bin * 10^(profile_over_db/20))

The thresholds are evaluated in float64 and rounded once
(``models/lfo.py:f64``): the mask is a hard decision, and torch's float32
pow differs by an ulp between its CPU and CUDA builds (XLA's rounds
correctly).
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import f64
from aefs_tpu_torch.ops.fftops import (frame_signal, hann_window, irfft_last,
                                       overlap_add, rfft_last)
from aefs_tpu_torch.ops.scan import affine_scan


def measure_noise_profile(mono, hop: int = 256) -> np.ndarray:
    """Per-bin mean magnitude of a noise-only capture — host-side numpy,
    measured with the SAME analysis ``process`` gates against (symmetric
    Hann, n_fft = 2*hop, 50% overlap), so ``profile * 10^(over/20)`` is
    directly comparable to the frame magnitudes at runtime."""
    n_fft = 2 * hop
    mono = np.asarray(mono, np.float32).reshape(-1)
    if len(mono) < n_fft:
        mono = np.pad(mono, (0, n_fft - len(mono)))
    k = (len(mono) - n_fft) // hop + 1
    idx = np.arange(n_fft)[None, :] + hop * np.arange(k)[:, None]
    frames = mono[idx] * np.hanning(n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=-1)).mean(axis=0).astype(np.float32)


def db_to_lin(db):
    """10^(db/20): the quotient in float32 (a true division by a device
    tensor, as XLA divides), the power in float64 rounded once."""
    return f64(lambda e: torch.pow(10.0, e), db / torch.full_like(db, 20.0))


class SpectralFilter(EffectModel):
    kind = "spectral"

    PARAMS = {
        "threshold_db": ParamSpec(-40.0, -80.0, 0.0, smooth="step", step=1.0),
        "reduction": ParamSpec(0.5, 0.0, 1.0, smooth="step", step=0.05),
        # Margin over the learned per-bin noise floor (active only once a
        # profile is installed).
        "profile_over_db": ParamSpec(6.0, 0.0, 24.0, smooth="step", step=0.5),
    }

    def __init__(self, fs, blocksize, channels=2, device="cpu", hop=256, smoothing=0.8,
                 noise_profile=None, **config):
        super().__init__(fs, blocksize, channels, device, **config)
        if blocksize % hop != 0:
            raise ValueError(f"blocksize {blocksize} must be a multiple of hop {hop}")
        self.hop = int(hop)
        self.n_fft = 2 * self.hop
        self.alpha = float(smoothing)
        self.window = hann_window(self.n_fft, device)
        if noise_profile is not None:
            noise_profile = torch.from_numpy(np.asarray(noise_profile, np.float32)).to(device)
            bins = self.n_fft // 2 + 1
            if tuple(noise_profile.shape) != (bins,):
                raise ValueError(
                    f"noise_profile must have {bins} bins "
                    f"(hop {self.hop}), got {tuple(noise_profile.shape)}"
                )
        self.noise_profile = noise_profile

    def init_state(self):
        dev = self.device
        return {
            "in_tail": torch.zeros((self.n_fft - self.hop,), device=dev),
            "ola_tail": torch.zeros((self.hop,), device=dev),
            "mask": torch.ones((self.n_fft // 2 + 1,), device=dev),
        }

    def process(self, state, p, x):
        thresh = lead(db_to_lin(p["threshold_db"]), 2)

        mono = torch.mean(x, -2)  # mono analysis
        frames, in_tail = frame_signal(state["in_tail"], mono, self.n_fft, self.hop)
        spec = rfft_last(frames * self.window[None, :])  # (..., k, bins)

        mag = torch.abs(spec)
        if self.noise_profile is not None:
            over = lead(db_to_lin(p["profile_over_db"]), 2)
            thresh = torch.maximum(thresh, self.noise_profile * over)  # (..., bins)
        cur_mask = torch.where(mag > thresh, 1.0, lead(p["reduction"], 2))
        # Temporal smoothing across frames: a first-order scan.
        mask = affine_scan(self.alpha, (1.0 - self.alpha) * cur_mask, state["mask"], axis=-2)

        frames_out = irfft_last(spec * mask)
        y_mono, ola_tail = overlap_add(frames_out, state["ola_tail"], self.hop)
        new_state = {"in_tail": in_tail, "ola_tail": ola_tail, "mask": mask[..., -1, :]}
        # The same cleaned mono signal on every output channel.
        reps = (1,) * (x.dim() - 2) + (x.shape[-2], 1)
        return new_state, y_mono.unsqueeze(-2).repeat(*reps)
