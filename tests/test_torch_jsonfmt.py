"""The port's JSON text of float arrays (``aefs_tpu_torch/engine/jsonfmt.py``,
``csrc/json_f32.cpp``) against ``native.json_f32_array`` (one ``snprintf``
"%.5g" a value), byte for byte: NaN, infinities and zeros, subnormals and
the limits of the fast path, the switches of "%g"'s notation, a decimal
tie, every decoded 16-bit sample, random bit patterns, lengths around the
threaded split and an array split over several slices; a failed build
falls back to the same bytes; the upload reply of the demo is the same
bytes through the native writer and without the library, with its
``front.samples`` span and no value handed to ``snprintf``."""

import asyncio
import base64
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from aefs_tpu_torch import native
from aefs_tpu_torch.engine import jsonfmt
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.server import backend
from aefs_tpu_torch.utils.metrics import TRACER

DEMO = Path(__file__).resolve().parents[1] / "music" / "rain-demo.wav"
F32 = np.finfo(np.float32)
ONE_E9 = np.float32(1e9)


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


CASES = {
    "nan_inf_zeros": np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32),
    "subnormals": np.concatenate([_bits(0x1, 0x7FFFFF), -_bits(0x1, 0x7FFFFF)]),
    "flt_min_max": np.array([F32.tiny, -F32.tiny, F32.max, -F32.max], np.float32),
    "around_1e9": np.array([np.nextafter(ONE_E9, np.float32(0)), ONE_E9,
                            np.nextafter(ONE_E9, np.float32(np.inf)), -ONE_E9], np.float32),
    "g_switches": np.array([9.99995e-5, 1e-4, 99999.4, 99999.5, 1e5, -9.99995e-5,
                            0.00099999, 9999.95, 99999.0, 999999.0], np.float32),
    "tie_2_pow_minus_8": np.array([2.0 ** -8, -(2.0 ** -8), 2.0 ** -8 * 3], np.float32),
    "int16_samples": (np.arange(-32768, 32768) / 32768.0).astype(np.float32),
    "random_bits": np.random.default_rng(20261018).integers(
        0, 2 ** 32, 2 ** 20, dtype=np.uint64).astype(np.uint32).view(np.float32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_bytes_as_snprintf(name):
    arr = CASES[name]
    assert jsonfmt.json_f32_array(arr) == native.json_f32_array(arr)


@pytest.mark.parametrize("n", [0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 16 + 1])
def test_same_bytes_at_each_length(n):
    arr = (0.3 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    assert jsonfmt.json_f32_array(arr) == native.json_f32_array(arr)


def test_an_odd_length_splits_over_several_slices(monkeypatch):
    monkeypatch.setattr(jsonfmt, "THREADS", 5)
    n = 3 * 2 ** 16 + 7
    rng = np.random.default_rng(7)
    # means of two 16-bit codes, the reply's plotted mix
    arr = (rng.integers(-32768, 32768, (2, n)).sum(0) / 65536.0).astype(np.float32)
    arr[::97] = np.nan
    TRACER.reset()
    TRACER.enable()
    try:
        text = jsonfmt.json_f32_array(arr)
        counters = TRACER.export()["counters"]
    finally:
        TRACER.disable()
        TRACER.reset()
    assert text == native.json_f32_array(arr)
    # 8 slices a thread (csrc/json_f32.cpp: PIECES), taken in turn by the 5
    assert counters == {"jsonfmt.values": n, "jsonfmt.fallbacks": 0, "jsonfmt.slices": 40}


def _slices(threads):
    """The slices of an array of 2^16 values or more: 8 a thread
    (csrc/json_f32.cpp: PIECES), one on a single thread."""
    return 8 * threads if threads > 1 else 1


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 64, 65])
def test_every_thread_count_gives_the_same_bytes_and_its_slices(monkeypatch, threads):
    monkeypatch.setattr(jsonfmt, "THREADS", threads)
    n = 2 ** 16 + 4099
    arr = (0.4 * np.random.default_rng(threads).standard_normal(n)).astype(np.float32)
    arr[::61] = np.float32(2e-45)  # subnormals: snprintf, in every slice
    TRACER.reset()
    TRACER.enable()
    try:
        text = jsonfmt.json_f32_array(arr)
        counters = TRACER.export()["counters"]
    finally:
        TRACER.disable()
        TRACER.reset()
    assert text == native.json_f32_array(arr)
    assert counters["jsonfmt.fallbacks"] == len(arr[::61])
    assert counters["jsonfmt.slices"] == _slices(min(threads, 64))


def test_values_off_the_fast_path_are_counted():
    arr = np.concatenate([CASES["subnormals"], CASES["around_1e9"], [0.5, np.nan]])
    TRACER.reset()
    TRACER.enable()
    try:
        jsonfmt.json_f32_array(arr.astype(np.float32))
        counters = TRACER.export()["counters"]
    finally:
        TRACER.disable()
        TRACER.reset()
    assert counters["jsonfmt.fallbacks"] == 4 + 3  # subnormals, and 1e9, -1e9, above it
    assert counters["jsonfmt.slices"] == 1


def test_a_failed_build_falls_back_to_the_same_bytes(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(jsonfmt, "_lib", None)
    monkeypatch.setattr(jsonfmt, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jsonfmt, "CXX", str(tmp_path / "no-such-compiler"))
    arr = CASES["int16_samples"]
    assert jsonfmt.json_f32_array(arr) == native.json_f32_array(arr)
    assert jsonfmt.library() is None
    assert "unavailable" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())  # no half-built library left behind


@pytest.mark.parametrize("stereo", [False, True])
def test_plot_payload_same_bytes_through_either_formatter(monkeypatch, stereo):
    rng = np.random.default_rng(1)
    frames = [(0.2 * rng.standard_normal((256, 2))).astype(np.float32) for _ in range(3)]
    got = backend.serialize_audio_data(frames, frames[::-1], 48000, stereo_in=stereo)
    monkeypatch.setattr(jsonfmt, "json_f32_array", native.json_f32_array)
    assert got == backend.serialize_audio_data(frames, frames[::-1], 48000, stereo_in=stereo)


class _Socket:
    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)


def _demo_reply(url):
    eng = AudioEngine(device="cpu")
    eng.build_chain([{"effect_id": "f", "type": "filter",
                      "params": {"filter_type": 0, "cutoff_hz": 1200, "q": 0.707}}])
    sock = _Socket()
    asyncio.run(eng.process_wav_file(url, sock))
    eng.close()
    (reply,) = sock.sent
    return reply


def test_the_demo_upload_reply_is_the_same_bytes(monkeypatch):
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    url = "data:audio/wav;base64," + base64.b64encode(DEMO.read_bytes()).decode()
    TRACER.reset()
    TRACER.enable()
    try:
        reply = _demo_reply(url)
        ex = TRACER.export()
    finally:
        TRACER.disable()
        TRACER.reset()
        torch.set_num_threads(prev)
    assert reply.startswith('{"type": "file_processed"')
    (rid, s0, s1), = ex["spans"]["front.serialize"]
    (r, t0, t1), = ex["spans"]["front.samples"]
    assert r == rid and s0 <= t0 <= t1 <= s1
    msg = json.loads(reply)
    n = len(msg["original_samples"]) + len(msg["processed_samples"])
    assert ex["counters"] == {**ex["counters"], "jsonfmt.values": n, "jsonfmt.fallbacks": 0,
                              "jsonfmt.slices": 2 * _slices(jsonfmt.THREADS)}

    monkeypatch.setattr(jsonfmt, "_lib", False)  # json.dumps and native.json_f32_array
    assert _demo_reply(url) == reply
