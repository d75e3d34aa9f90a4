"""Plot analysis on the engine's device: STFT log-spectrum + pitch-class
chroma (port of aefs_tpu/utils/analysis.py).

The reference UI computes these in the browser over a 131072-sample
rolling window with a Blackman-Harris window, a log-magnitude spectrum
and a MIDI pitch-class chroma fold with frequency weighting and cube-law
contrast (assets/02_custom.js).  Here one ``torch.fft.rfft`` per window
runs on the device and the serving layer ships the reduced spectra
(log-spaced bins).
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW_SAMPLES = 131072  # rolling plot window (02_custom.js:6)
FFT_SIZE = 16384         # analysis transform size (02_custom.js:7)
SPECTRUM_POINTS = 480    # log-spaced bins shipped to the UI
CHROMA_BINS = 12


def blackman_harris(n):
    k = np.arange(n)
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    w = (
        a[0]
        - a[1] * np.cos(2 * np.pi * k / (n - 1))
        + a[2] * np.cos(4 * np.pi * k / (n - 1))
        - a[3] * np.cos(6 * np.pi * k / (n - 1))
    )
    return w.astype(np.float32)


class PlotAnalyzer:
    """Rolling before/after analysis state for the plot pump."""

    def __init__(self, fs: int, device="cuda"):
        from aefs_tpu_torch.utils.platform import require_device

        self.fs = int(fs)
        self.device = require_device(device)
        self.window = torch.from_numpy(blackman_harris(FFT_SIZE)).to(self.device)
        self.rings = {
            "input": np.zeros(WINDOW_SAMPLES, np.float32),
            "output": np.zeros(WINDOW_SAMPLES, np.float32),
        }

        freqs = np.fft.rfftfreq(FFT_SIZE, 1.0 / self.fs)
        lo, hi = 20.0, min(20000.0, self.fs / 2)
        targets = np.geomspace(lo, hi, SPECTRUM_POINTS)
        self.log_idx = torch.from_numpy(
            np.searchsorted(freqs, targets).clip(0, len(freqs) - 1)).to(self.device)
        self.plot_freqs = targets.tolist()

        with np.errstate(divide="ignore"):
            midi = 12.0 * np.log2(np.maximum(freqs, 1e-9) / 440.0) + 69.0
        pc = (np.round(midi).astype(np.int64)) % 12
        audible = (freqs >= 55.0) & (freqs <= 5000.0)
        # Bins outside the audible band fold into a 13th class, dropped.
        self.pc_map = torch.from_numpy(np.where(audible, pc, CHROMA_BINS)).to(self.device)
        # Mild high-frequency de-emphasis like the reference's freq weighting.
        self.pc_weight = torch.from_numpy(
            np.where(audible, 1.0 / np.sqrt(np.maximum(freqs, 55.0) / 55.0), 0.0)
            .astype(np.float32)).to(self.device)

    def _analyze(self, frames):
        """frames: (W, FFT_SIZE) float32 numpy -> (spec_db (W,
        SPECTRUM_POINTS), chroma (W, 12)) as numpy, computed on the device
        with it current."""
        from aefs_tpu_torch.utils.platform import device_scope

        with device_scope(self.device):
            return self._analyze_on_device(torch.from_numpy(frames).to(self.device))

    def _analyze_on_device(self, frames):
        mag = torch.abs(torch.fft.rfft(frames * self.window)) / (FFT_SIZE / 4)
        # Log-spaced spectrum in dB (02_custom.js:178-250 renders log-x dB).
        spec_db = 20.0 * torch.log10(torch.clamp(mag[:, self.log_idx], min=1e-7))
        # Chroma: fold bins to pitch classes with frequency weighting, then
        # cube-law contrast (02_custom.js:65-106).
        energy = (mag * self.pc_weight) ** 2
        chroma = torch.zeros((frames.shape[0], CHROMA_BINS + 1), dtype=energy.dtype,
                             device=energy.device)
        chroma = chroma.index_add_(1, self.pc_map, energy)[:, :CHROMA_BINS]
        chroma = chroma / torch.clamp(chroma.max(dim=1, keepdim=True).values, min=1e-12)
        return spec_db.cpu().numpy(), (chroma ** 3).cpu().numpy()

    def _push(self, name, chunk):
        ring = self.rings[name]
        chunk = np.asarray(chunk, np.float32)[-WINDOW_SAMPLES:]
        n = len(chunk)
        if n:
            ring[:-n] = ring[n:]
            ring[-n:] = chunk
        return ring

    def analyze_file_arrays(self, original, processed, max_windows: int = 120,
                            min_hop_s: float = 0.25):
        """Windowed analysis of a whole file for playback scrubbing: one
        window per ``hop_s`` ships with the ``file_processed`` payload and
        the UI indexes windows by playback time.  Window w analyzes the
        FFT_SIZE samples ENDING at (w+1)*hop — the trailing-window
        semantics of the live plots.

        original, processed: (N,) mono float32.  Returns {hop_s, freqs,
        original: {spectrum_db (W, P), chroma (W, 12)}, processed: {...}},
        each array float32 rounded (2 and 4 decimals) as the payload
        carries it; ``engine/jsonfmt.py:reply`` writes it as JSON.
        """
        n = int(len(processed))
        fs = self.fs
        hop = max(1, int(max(min_hop_s, (n / fs) / max_windows) * fs))
        n_win = max(1, -(-n // hop))
        ends = np.minimum((np.arange(n_win) + 1) * hop, n)

        out = {"hop_s": hop / fs, "freqs": self.plot_freqs}
        for name, sig in (("original", original), ("processed", processed)):
            sig = np.asarray(sig, np.float32).reshape(-1)
            padded = np.concatenate([np.zeros(FFT_SIZE, np.float32), sig])
            frames = padded[ends[:, None] + np.arange(FFT_SIZE)[None, :]]
            specs, chromas = self._analyze(np.ascontiguousarray(frames))
            out[name] = {"spectrum_db": specs.round(2), "chroma": chromas.round(4)}
        return out

    def analyze_file(self, original, processed, max_windows: int = 120,
                     min_hop_s: float = 0.25):
        """``analyze_file_arrays`` as a JSON-ready dict: its arrays as
        lists of Python floats."""
        out = self.analyze_file_arrays(original, processed, max_windows, min_hop_s)
        for name in ("original", "processed"):
            out[name] = {k: v.tolist() for k, v in out[name].items()}
        return out

    def update(self, in_chunk, out_chunk):
        """Push new samples, return JSON-ready analysis for both signals."""
        result = {"freqs": self.plot_freqs}
        for name, chunk in (("input", in_chunk), ("output", out_chunk)):
            tail = self._push(name, chunk)[-FFT_SIZE:]
            spec_db, chroma = self._analyze(tail[None].copy())
            result[name] = {
                "spectrum_db": spec_db[0].round(2).tolist(),
                "chroma": chroma[0].round(4).tolist(),
            }
        return result
