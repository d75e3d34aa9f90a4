"""Seeded program audio for the traffic: a rain scene (a copy of
``scripts/make_demo.py:rain_scene``, rewritten so that one 18.6 s scene
takes tens of milliseconds: the rumble's cascaded moving averages are
running sums instead of convolutions), and the WAV data URL an upload
carries."""

from __future__ import annotations

import base64
import io
import wave

import numpy as np
from scipy.signal import lfilter


def seed_of(*parts) -> int:
    """A 63-bit seed for numpy from the run's seed and sub-indices."""
    return int(np.random.SeedSequence([int(p) % (1 << 63) for p in parts]).generate_state(1,
               np.uint64)[0] >> 1)


def _moving_average_same(x, k):
    """np.convolve(x, ones(k) / k, mode="same") by a running sum."""
    n = x.shape[0]
    cs = np.concatenate([[0.0], np.cumsum(x)])
    lo = np.clip(np.arange(n) - k // 2, 0, n)
    hi = np.clip(np.arange(n) - k // 2 + k, 0, n)
    return (cs[hi] - cs[lo]) / k


def rain_scene(seconds: float, fs: int, seed: int) -> np.ndarray:
    """Stereo rain: a pink-ish bed with a slow ripple, stereo-panned
    resonant droplets and two distant rumbles; (frames, 2) float32 with
    its peak at 0.7."""
    n = int(seconds * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    out = np.zeros((n, 2), np.float64)
    a = 0.12
    for ch in range(2):
        w = rng.standard_normal(n)
        y = lfilter([a], [1.0, -(1.0 - a)], w)
        ripple = 0.55 + 0.35 * np.sin(2 * np.pi * 0.23 * t + ch * 1.7)
        out[:, ch] = (0.5 * y + 0.05 * w) * ripple * 0.35
    ping_len = int(0.02 * fs)
    env = np.exp(-np.arange(ping_len) / (0.004 * fs))
    for _ in range(int(70 * seconds)):
        i = int(rng.uniform(0, n - ping_len))
        f = rng.uniform(1800, 9000)
        ping = np.sin(2 * np.pi * f * np.arange(ping_len) / fs) * env
        lvl = rng.uniform(0.02, 0.16)
        pan = rng.uniform(0.0, 1.0)
        out[i:i + ping_len, 0] += ping * lvl * (1.0 - pan)
        out[i:i + ping_len, 1] += ping * lvl * pan
    for center, width, lvl in ((0.3 * seconds, 1.8, 0.25), (0.72 * seconds, 2.4, 0.3)):
        g = np.exp(-0.5 * ((t - center) / width) ** 2)
        rum = rng.standard_normal(n)
        k = max(1, int(fs / 300))
        for _ in range(3):
            rum = _moving_average_same(rum, k)
        out[:, 0] += rum * g * lvl
        out[:, 1] += np.roll(rum, 97) * g * lvl
    return (out / np.max(np.abs(out)) * 0.7).astype(np.float32)


def to_int16(audio: np.ndarray) -> np.ndarray:
    """float in [-1, 1] -> 16-bit PCM, rounded."""
    return np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def wav_data_url(pcm: np.ndarray, fs: int) -> str:
    """(frames, ch) int16 -> a base64 WAV data URL, as a browser uploads."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes(np.ascontiguousarray(pcm).tobytes())
    return "data:audio/wav;base64," + base64.b64encode(buf.getvalue()).decode("ascii")


def read_wav_data_url(url: str):
    """A data URL's WAV -> ((frames, ch) int16, fs); raises when malformed."""
    raw = base64.b64decode(url.split(",", 1)[1], validate=True)
    with wave.open(io.BytesIO(raw), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{8 * w.getsampwidth()}-bit WAV, expected 16")
        ch, fs = w.getnchannels(), w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return pcm.reshape(-1, ch), fs
