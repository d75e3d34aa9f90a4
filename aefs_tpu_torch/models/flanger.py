"""Flanger with feedback: LFO-swept fractional-delay comb whose output
recirculates into the delay line (port of aefs_tpu/models/flanger.py).

Per channel:
    d[n] = clip((base_ms + depth_ms*sin(2*pi*ph[n])) * fs/1000, 24, Hmax)
    v[n] = x[n] + feedback * s[n]        (delay-line signal)
    s[n] = cubic tap of v at distance d[n]
    y[n] = (1-mix) * x[n] + mix * s[n]

The tap reaches at least D_MIN - 2 = 22 samples back, so over a 256-sample
chunk the in-chunk part of the read operator is nilpotent and v = x +
fb*T(v) is solved exactly by 12 fixed-point sweeps.  ``process`` runs any
block as the same sequence of 256-sample chunks, so 256-sample streaming
and 4096-sample blocks agree bit for bit.  Its tap operator is the
reference's dense form (cubic one-hot weights,
``ops/ringbuf.py:cubic_onehot_matrix``) and its products are plain fp32
matmuls, as the reference leaves them to XLA outside any kernel; keeping
the same weights and sums keeps the port within float rounding of it.

``process_file`` takes every chunk's phases from the parallel
double-single ramp and solves the recurrence itself, 22 or more samples
at a time, in one call of ``ops/kernels/flanger.py:flanger_file`` (kernel
K6 on the card): the same mathematics as the reference's squared dense
solve, with fewer roundings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead
from aefs_tpu_torch.models.lfo import (
    TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp, spread_channels)
from aefs_tpu_torch.ops.dsphase import _two_sum
from aefs_tpu_torch.ops.kernels.flanger import flanger_file
from aefs_tpu_torch.ops.ringbuf import cubic_onehot_matrix, cubic_tap_weights
from aefs_tpu_torch.ops.scan import _matmul

MAX_BASE_MS = 10.0
MAX_DEPTH_MS = 5.0
D_MIN = 24.0     # samples; bounds the nilpotency degree
_CHUNK = 256
_SWEEPS = 12     # ceil(_CHUNK / (D_MIN - 2))


def _mv(mat, z):
    """Batched matrix-vector product: (..., N, M) @ (..., M) -> (..., N)."""
    return _matmul(mat, z[..., None])[..., 0]


def _ds_phase(i, dph, hi0, lo0):
    """Double-single phase hi + lo ~= hi0 + lo0 + i*dph (hi in [0, 1)) for
    float32 sample indices i < 2^24: i and dph are Veltkamp-split so every
    partial product is exact, then TwoSum-accumulated."""
    s = dph * 4097.0
    d_hi = s - (s - dph)
    d_lo = dph - d_hi
    i_hi = torch.floor(i * (1.0 / 4096.0)) * 4096.0
    i_lo = i - i_hi
    hi, e1 = _two_sum(i_hi * d_hi, i_hi * d_lo)
    hi, e2 = _two_sum(hi, i_lo * d_hi)
    lo = e1 + e2 + i_lo * d_lo
    hi, e3 = _two_sum(hi, hi0)
    lo = lo + (e3 + lo0)
    return hi - torch.floor(hi), lo


class Flanger(EffectModel):
    kind = "flanger"

    PARAMS = {
        "rate_hz": ParamSpec(0.3, 0.05, 5.0, smooth="mult", step=0.05),
        "depth_ms": ParamSpec(2.0, 0.0, MAX_DEPTH_MS, smooth="step", step=0.1),
        "base_ms": ParamSpec(2.5, 0.5, MAX_BASE_MS, smooth="step", step=0.25),
        "feedback": ParamSpec(0.6, -0.9, 0.9, smooth="step", step=0.02),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        self.hist_len = int((MAX_BASE_MS + MAX_DEPTH_MS) * fs / 1000.0) + 8

    def init_state(self):
        zero = torch.zeros((), device=self.device)
        return {
            "hist": torch.zeros((self.channels, self.hist_len), device=self.device),
            "ph_hi": zero,
            "ph_lo": zero.clone(),
        }

    def _delay(self, p, ph_c, fs, k=0):
        """Delay in samples for (..., C, K) phases, clipped to [D_MIN, H-2];
        ``k`` trailing unit axes for slot-wise params."""
        delay_ms = lead(p["base_ms"], k) + lead(p["depth_ms"], k) * f64(torch.sin, TWO_PI * ph_c)
        ms_per_s = torch.full((), 1000.0, device=fs.device)
        return torch.clamp(delay_ms * (fs / ms_per_s), D_MIN, float(self.hist_len - 2))

    def _chunk(self, p, fs, dph, hist, hi, lo, xc):
        """One 256-sample chunk: 12 exact sweeps on the dense tap operator.
        xc (..., C, K); slot-wise params and state with leading axes."""
        H, K = self.hist_len, _CHUNK
        fb = lead(p["feedback"], 2)
        ph_c = spread_channels(lfo_ramp(hi, lo, dph, K), p["spread"], xc.shape[-2])
        d = self._delay(p, ph_c, fs, 2)
        ca = torch.ceil(d).to(torch.int32)
        fr = torch.ceil(d) - d
        base = H + torch.arange(K, dtype=torch.int32, device=xc.device)
        weights = cubic_onehot_matrix(base - ca - 1, fr, H + K)  # (..., C, K, H+K)
        # The history half contracts once; the sweeps iterate only the
        # strictly lower in-chunk quarter (taps reach >= 22 back).
        w_h, w_c = weights[..., :H], weights[..., H:]
        th = _mv(w_h, hist)
        b = xc + fb * th
        v = torch.zeros_like(xc)
        for _ in range(_SWEEPS):
            v = b + fb * _mv(w_c, v)
        tap = th + _mv(w_c, v)
        mix = lead(p["mix"], 2)
        y = (1.0 - mix) * xc + mix * tap
        new_hist = torch.cat([hist, v], -1)[..., -H:]
        nhi, nlo = lfo_advance(hi, lo, dph, K)
        return new_hist, nhi, nlo, y, v

    def process(self, state, p, x):
        n = x.shape[-1]
        fs = fs_tensor(self.fs, x.device)
        dph = p["rate_hz"] / fs
        pad = (-n) % _CHUNK
        xp = F.pad(x, (0, pad)) if pad else x
        hist, hi, lo = state["hist"], state["ph_hi"], state["ph_lo"]
        ys, vs = [], []
        for k in range(xp.shape[-1] // _CHUNK):
            hist, hi, lo, y, v = self._chunk(p, fs, dph, hist, hi, lo,
                                             xp[..., k * _CHUNK:(k + 1) * _CHUNK])
            ys.append(y)
            vs.append(v)
        return self._finish(state, dph, pad, n, torch.cat(ys, -1), torch.cat(vs, -1),
                            hist, hi, lo)

    def _finish(self, state, dph, pad, n, ys, vs, hist_f=None, hi_f=None, lo_f=None):
        """Unpad (..., C, total) outputs and, when padded or not given,
        build the carry from the unpadded delay-line signal and sample
        count."""
        if pad or hist_f is None:
            hist_f = torch.cat([state["hist"], vs[..., :n]], -1)[..., -self.hist_len:]
            hi_f, lo_f = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
        return {"hist": hist_f, "ph_hi": hi_f, "ph_lo": lo_f}, ys[..., :n]

    def file_operands(self, state, p, x):
        """``flanger_file``'s signal operands for a whole file: x padded to
        whole 256-sample chunks, every sample's delay ceiling ca (int32)
        and its four cubic weights w (4, ..., C, total), from the chunked
        double-single ramp (the blockwise step's phases).  Returns (xp, ca,
        w, pad).  x: (C, N), or (F, C, N) with (F, ...) state."""
        c, n = x.shape[-2:]
        dev = x.device
        fs = fs_tensor(self.fs, dev)
        dph = p["rate_hz"] / fs
        K = _CHUNK
        m = -(-n // K)
        pad = m * K - n
        xp = F.pad(x, (0, pad)) if pad else x

        # Every chunk's start phase from the parallel ramp; in-chunk phase
        # is the same hi + (lo + idx*dph) as the blockwise step.
        gi = torch.arange(m, dtype=torch.float32, device=dev) * float(K)
        chi, clo = _ds_phase(gi, dph, lead(state["ph_hi"]), lead(state["ph_lo"]))
        idx = torch.arange(K, dtype=torch.float32, device=dev)
        ph = chi[..., None] + (clo[..., None] + idx * dph)  # (..., m, K)
        chan = torch.arange(c, dtype=torch.float32, device=dev)
        ph_c = ph[..., None, :, :] + p["spread"] * chan[:, None, None]  # (..., C, m, K)
        d = self._delay(p, ph_c, fs).flatten(-2)  # (..., C, m*K)
        ca = torch.ceil(d)
        w = torch.stack(cubic_tap_weights(ca - d))
        return xp.contiguous(), ca.to(torch.int32), w, pad

    def process_file(self, state, p, x):
        """Whole-file path: ``file_operands``, then the line recurrence in
        one call of ``flanger_file`` (kernel K6 on the card) for every file
        and channel.  x: (C, N), or (F, C, N) for F files with (F, ...)
        state."""
        dph = p["rate_hz"] / fs_tensor(self.fs, x.device)
        xp, ca, w, pad = self.file_operands(state, p, x)
        ys, vs = flanger_file(xp, ca, w, p["feedback"], p["mix"], state["hist"].contiguous())
        return self._finish(state, dph, pad, x.shape[-1], ys, vs)
