"""Convolution reverb by uniformly-partitioned FFT overlap-save (port of
aefs_tpu/models/convreverb.py).

The impulse response is split into hop-length partitions; the input
spectra form a frequency-domain delay line, and each hop costs one rfft, a
(P x bins) complex multiply-accumulate and one irfft
(``ops/fftops.py:partitioned_fft_conv``).  The IR is static: a user array
(``ir``: (C, L) or (L,)) or a synthetic exponentially-decaying stereo noise
IR of ``ir_seconds`` (fixed seed, decorrelated channels).  File mode
(``process_file``) is one full-length FFT convolution that rebuilds the
blockwise end-of-file state exactly.  On a mesh with a model axis
(parallel/mesh.py) ``spec_hist`` arrives split over its partition axis
(``ModelShards``), and each model device does its partitions' MAC
(``ops/fftops.py:partitioned_fft_conv_split``).

Spans and counters (``utils/metrics.py:TRACER``, rid None): ``convreverb.build``
(the IR, its partition spectra and their copy to the device, in
``__init__``); per ``process_file`` call, ``convreverb.ir_spectrum`` (the
IR's float64 transform on the chain's device), ``convreverb.conv`` (the
forward transform, the product and the inverse) and ``convreverb.state``
(the end-of-file delay line's rebuild), each as the host enqueues it: no
device wait, so on the card these are enqueue times; counters
``convreverb.file_renders`` (files in the call) and
``convreverb.device_fft_points`` (nfft times the IR's channels, transformed
by ``torch.fft`` on the chain's device).  ``process``, the captured
streaming step, has none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, ModelShards, lead
from aefs_tpu_torch.ops.fftops import (
    partition_ir, partitioned_fft_conv, partitioned_fft_conv_split, rfft_last)
from aefs_tpu_torch.utils.metrics import TRACER


def synthetic_ir(fs: int, seconds: float, channels: int = 2, seed: int = 1234):
    """Exponentially-decaying noise IR, -60 dB at the tail, unit energy."""
    length = max(int(fs * seconds), 1)
    rng = np.random.default_rng(seed)
    t = np.arange(length, dtype=np.float64)
    env = np.power(10.0, -3.0 * t / max(length - 1, 1))  # -60 dB decay
    ir = rng.standard_normal((channels, length)) * env[None, :]
    ir /= np.sqrt(np.sum(ir**2, axis=1, keepdims=True))
    return ir.astype(np.float32)


class ConvReverb(EffectModel):
    kind = "convreverb"

    PARAMS = {
        "mix_dry": ParamSpec(0.7, 0.0, 2.0),
        "mix_wet": ParamSpec(0.4, 0.0, 2.0),
    }

    def __init__(self, fs, blocksize, channels=2, device="cpu", ir=None, ir_seconds=2.0,
                 hop=None, partition_multiple=1, **config):
        super().__init__(fs, blocksize, channels, device, **config)
        self.hop = int(hop) if hop else int(blocksize)
        if blocksize % self.hop != 0:
            raise ValueError("blocksize must be a multiple of the conv hop")
        with TRACER.span("convreverb.build"):
            if ir is None:
                ir = synthetic_ir(fs, float(ir_seconds), channels)
            ir = np.atleast_2d(np.asarray(ir, np.float32))
            if ir.shape[0] == 1 and channels > 1:
                ir = np.repeat(ir, channels, axis=0)
            # partition_multiple m: zero-pad the IR so (P-1) % m == 0, as the
            # JAX package does for its sharded partition axis; zero partitions
            # add nothing, but they set the state's P.
            m = max(int(partition_multiple), 1)
            p_raw = max(1, -(-ir.shape[1] // self.hop))
            pad_parts = (-(p_raw - 1)) % m
            if pad_parts:
                ir = np.pad(ir, ((0, 0), (0, pad_parts * self.hop +
                                          (p_raw * self.hop - ir.shape[1]))))
            spectra = np.stack([partition_ir(ch, self.hop) for ch in ir])  # (C, 2, P, hop+1)
            # (C, P, hop+1) complex64 partition spectra: static weights.
            self.ir_spectra = torch.complex(*torch.from_numpy(spectra).to(device).unbind(1))
            self.partitions = spectra.shape[2]
        # Time-domain IR (padded as above: it sets the file path's nfft).
        self._ir_time = ir
        self._ir_dev = {}  # device -> the time-domain IR there
        self._ir_parts = {}  # (device, lo, hi) -> partition spectra there

    def init_state(self):
        c = self.channels
        return {
            "spec_hist": torch.zeros((c, 2, self.partitions - 1, self.hop + 1),
                                     device=self.device),
            "in_tail": torch.zeros((c, self.hop), device=self.device),
        }

    def _mix(self, p, x, wet):
        return torch.clamp(lead(p["mix_dry"], 2) * x + lead(p["mix_wet"], 2) * wet, -1.0, 1.0)

    def process(self, state, p, x):
        hist = state["spec_hist"]
        if isinstance(hist, ModelShards):
            wet, parts, in_tail = partitioned_fft_conv_split(
                hist.pieces, state["in_tail"], x, self.ir_spectra, self.hop, self._ir_on)
            return ({"spec_hist": ModelShards(parts, hist.axis), "in_tail": in_tail},
                    self._mix(p, x, wet))
        wet, spec_hist, in_tail = partitioned_fft_conv(
            hist, state["in_tail"], x, self.ir_spectra, self.hop)
        return {"spec_hist": spec_hist, "in_tail": in_tail}, self._mix(p, x, wet)

    def _ir_on(self, device, lo, hi):
        """Partition spectra [lo, hi) on ``device``, kept after first use."""
        key = (str(device), lo, hi)
        if key not in self._ir_parts:
            self._ir_parts[key] = self.ir_spectra[..., lo:hi, :].contiguous().to(device)
        return self._ir_parts[key]

    def _ir_spectrum(self, nfft, device):
        """The IR's length-nfft spectrum on ``device``: the float32 IR (copied
        there at first use and kept) promoted exactly to float64, one full
        float64 transform, rounded once to complex64.  (C, nfft)."""
        key = str(device)
        if key not in self._ir_dev:
            self._ir_dev[key] = torch.from_numpy(np.ascontiguousarray(self._ir_time)).to(device)
        return torch.fft.fft(self._ir_dev[key].to(torch.float64), nfft).to(torch.complex64)

    def process_file(self, state, p, x):
        """One length-nfft FFT convolution, nfft = next_pow2(N + L), with the
        IR spectrum transformed on x's device in float64 and rounded to
        complex64 (``_ir_spectrum``), once per call (a batched render's files
        share it): no host transform, no copy of a spectrum to the device.
        The carried state is rebuilt exactly (in_tail = the last hop; the
        spectra of the last P-1 overlap-save frames of the zero-extended
        input), so blockwise processing resumes seamlessly.  x: (C, N), or
        (F, C, N) for F files.  The ``convreverb.ir_spectrum`` and
        ``convreverb.conv`` spans time the host's enqueue of the transforms
        and the product, not the device's work."""
        n = x.shape[-1]
        hop = self.hop
        if n % hop != 0 or n < hop:
            return self.process(state, p, x)
        TRACER.count("convreverb.file_renders", x.shape[0] if x.dim() == 3 else 1)
        nfft = 1 << int(np.ceil(np.log2(n + self._ir_time.shape[1])))
        with TRACER.span("convreverb.ir_spectrum"):
            h_spec = self._ir_spectrum(nfft, x.device)
        TRACER.count("convreverb.device_fft_points", nfft * self._ir_time.shape[0])
        with TRACER.span("convreverb.conv"):
            xs = torch.fft.fft(x, nfft)
            wet = torch.fft.ifft(xs * h_spec).real[..., :n]

        pparts = self.partitions
        with TRACER.span("convreverb.state"):
            if pparts > 1:
                # The last P*hop samples, zero history before the signal start;
                # frame i covers [i*hop, (i+2)*hop) of them, chronological.
                seg = F.pad(x[..., -pparts * hop:], (max(pparts * hop - n, 0), 0))
                fs_c = rfft_last(seg.unfold(-1, 2 * hop, hop))  # (..., C, P-1, hop+1)
                spec_hist = torch.stack([fs_c.real, fs_c.imag], -3)
            else:
                # The IR fits in one hop: the delay line is empty.
                spec_hist = torch.zeros(x.shape[:-1] + (2, 0, hop + 1), device=x.device)
        return {"spec_hist": spec_hist, "in_tail": x[..., -hop:]}, self._mix(p, x, wet)
