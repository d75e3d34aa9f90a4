"""The upload's ``file_processed`` reply as ``engine/jsonfmt.py:reply``
writes it in one native pass (``csrc/json_f32.cpp:aefs_json_reply``),
against the text the reply was built from before: ``json.dumps`` of the
head (the analysis as lists of Python floats) with the two sample arrays
concatenated after it.  Seeded uploads with and without the analysis, an
``original_b64`` that needs escaping, and the library missing give the
same bytes; the float32 values come out as ``repr(float(np.float32(v)))``
over Python's layout switches, subnormals, the extremes, NaN and the
infinities and a sweep of bit patterns; the counters and the
``front.samples`` span engage as documented."""

import asyncio
import json

import numpy as np
import pytest
import torch

from aefs_tpu_torch import native
from aefs_tpu_torch.engine import jsonfmt
from aefs_tpu_torch.engine.engine import AudioEngine, _decode_data_url
from aefs_tpu_torch.engine.wavio import encode_wav_int16
from aefs_tpu_torch.utils.analysis import PlotAnalyzer
from aefs_tpu_torch.utils.metrics import TRACER

FS = 48000
CFG = [{"effect_id": "f", "type": "filter",
        "params": {"filter_type": 0, "cutoff_hz": 1200, "q": 0.707}}]
# Quotes, a backslash, a control character and text outside ASCII (one
# character outside the BMP) in the data URL's header; no comma, so the
# upload still decodes.
ODD_HEADER = 'data:audio/wav;name="take \\1\t\x7f\u00e9\u6f22\U0001F3B5";base64,'
# The same without the text outside ASCII: found by the native scan.
ASCII_HEADER = 'data:audio/wav;name="take \\1\t\x7f";base64,'


class _Socket:
    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)


def _url(seed, seconds=2.0, header="data:audio/wav;base64,"):
    x = 0.3 * np.random.default_rng(seed).standard_normal((int(seconds * FS), 2))
    return header + native.b64encode(encode_wav_int16(x.astype(np.float32), FS)).decode()


def _old_reply(eng, contents, analysis_on):
    """The reply as ``process_wav_file`` built it before the native writer:
    ``json.dumps`` of the head, then the sample arrays concatenated."""
    audio, fs = _decode_data_url(contents)
    mono, processed = eng.process_file_array(audio, fs)
    wav_bytes = encode_wav_int16(processed, fs)
    b64 = native.b64encode(wav_bytes).decode("ascii")
    head_dict = {
        "type": "file_processed",
        "original_b64": contents,
        "processed_b64": f"data:audio/wav;base64,{b64}",
        "sample_rate": int(fs),
    }
    if analysis_on:
        head_dict["analysis"] = PlotAnalyzer(fs, device="cpu").analyze_file(
            mono[:, 0], processed.mean(axis=1))
    head = json.dumps(head_dict)
    return (head[:-1]
            + ',"original_samples":' + native.json_f32_array(mono.flatten())
            + ',"processed_samples":' + native.json_f32_array(processed.mean(axis=1))
            + "}")


def _assert_same_text(got, want):
    """got == want, failing with the first difference in view (pytest's
    own diff of two multi-megabyte strings takes minutes)."""
    if got == want:
        return
    lo, hi = 0, min(len(got), len(want))
    while lo < hi:  # got[:lo] == want[:lo]
        mid = (lo + hi + 1) // 2
        if got[:mid] == want[:mid]:
            lo = mid
        else:
            hi = mid - 1
    pytest.fail(f"the texts differ at {lo} (lengths {len(got)}, {len(want)}): "
                f"{got[max(lo - 60, 0):lo + 60]!r} != {want[max(lo - 60, 0):lo + 60]!r}")


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def traced():
    TRACER.reset()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


# case: (seed, analysis on, data URL header, library present, counters)
REPLIES = {
    "analysis": (11, True, "data:audio/wav;base64,", True,
                 {"jsonfmt.reply_writes": 1, "jsonfmt.escaped_strings": 0}),
    "no_analysis": (12, False, "data:audio/wav;base64,", True,
                    {"jsonfmt.reply_writes": 1, "jsonfmt.escaped_strings": 0}),
    "escaped_original": (13, True, ODD_HEADER, True,
                         {"jsonfmt.reply_writes": 1, "jsonfmt.escaped_strings": 1}),
    "escaped_ascii_original": (15, True, ASCII_HEADER, True,
                               {"jsonfmt.reply_writes": 1, "jsonfmt.escaped_strings": 1}),
    "no_library": (14, True, ODD_HEADER, False, {"jsonfmt.reply_fallbacks": 1}),
}


@pytest.mark.parametrize("case", sorted(REPLIES))
def test_the_reply_is_the_old_text_byte_for_byte(case, monkeypatch, one_thread, traced):
    seed, analysis_on, header, lib, counters = REPLIES[case]
    monkeypatch.setenv("AEFS_SERVER_ANALYSIS", "1" if analysis_on else "0")
    if not lib:
        monkeypatch.setattr(jsonfmt, "_lib", False)
    contents = _url(seed, header=header)
    eng = AudioEngine(device="cpu")
    eng.build_chain(CFG)
    sock = _Socket()
    asyncio.run(eng.process_wav_file(contents, sock))
    (reply,) = sock.sent
    got = TRACER.export()["counters"]
    want = _old_reply(eng, contents, analysis_on)
    eng.close()
    _assert_same_text(reply, want)
    assert ('"analysis": {"hop_s": ' in reply) == analysis_on
    assert got["front.uploads"] == 1
    for name in ("jsonfmt.reply_writes", "jsonfmt.reply_fallbacks", "jsonfmt.escaped_strings"):
        assert got.get(name, 0) == counters.get(name, 0), name


def test_front_samples_lies_inside_front_serialize_of_the_same_upload(one_thread, traced):
    eng = AudioEngine(device="cpu")
    eng.build_chain(CFG)
    asyncio.run(eng.process_wav_file(_url(21), _Socket()))
    eng.close()
    ex = TRACER.export()
    (rid, s0, s1), = ex["spans"]["front.serialize"]
    (r, t0, t1), = ex["spans"]["front.samples"]
    assert r == rid and s0 <= t0 < t1 <= s1
    c = ex["counters"]
    assert c["jsonfmt.reply_writes"] == c["front.uploads"] == 1
    assert c["jsonfmt.values"] == 2 * 2 * FS and c["jsonfmt.fallbacks"] == 0
    assert "jsonfmt.reply_fallbacks" not in c and "jsonfmt.escaped_strings" not in c


def test_a_reply_without_the_library_times_its_arrays_as_front_samples(monkeypatch, traced):
    monkeypatch.setattr(jsonfmt, "_lib", False)
    arr = np.linspace(-1, 1, 1000, dtype=np.float32)
    text = jsonfmt.reply({"type": "t"}, {"a": arr}, "front.samples", 7)
    assert text == '{"type": "t","a":' + native.json_f32_array(arr) + "}"
    (rid, t0, t1), = TRACER.export()["spans"]["front.samples"]
    assert rid == 7 and t0 <= t1
    assert TRACER.export()["counters"]["jsonfmt.reply_fallbacks"] == 1


# -- the float32 values as json.dumps writes their Python floats -----------------

F32 = np.finfo(np.float32)


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


def _around(*vals):
    v = np.array(vals, np.float32)
    return np.concatenate([np.nextafter(v, np.float32(-np.inf)), v,
                           np.nextafter(v, np.float32(np.inf))])


_rng = np.random.default_rng(20261018)
VALUES = {
    "rounded_2_decimals": (_rng.standard_normal(20000) * 40 - 60).astype(np.float32).round(2),
    "rounded_4_decimals": (_rng.random(20000) ** 3).astype(np.float32).round(4),
    "layout_switches": np.concatenate([
        _around(1e-4, 1e-5, 1e15, 1e16, 9.9999e-5, 0.001, 0.1, 1.0),
        np.array([2.0, 100.0, 12345.0, 2.0 ** 24, 2.0 ** 24 + 2, 1e10, 123456789012.0,
                  0.5, 0.25, 0.0, -0.0, -1.0, -1e-4, -1e-5, -1e15, -1e16], np.float32)]),
    "subnormals": np.concatenate([_bits(0x1, 0x2, 0x3FF, 0x400000, 0x7FFFFF),
                                  -_bits(0x1, 0x7FFFFF)]),
    "extremes": np.array([F32.tiny, -F32.tiny, F32.max, -F32.max, F32.eps,
                          np.float32(2.0 ** -126) * 3], np.float32),
    "non_finite": np.concatenate([np.array([np.nan, np.inf, -np.inf], np.float32),
                                  -np.array([np.nan], np.float32), _bits(0x7FC00001)]),
    # every 4,093rd bit pattern: ~1.05 M values of every exponent
    "bit_sweep": (np.arange(0, 2 ** 32, 4093, dtype=np.uint64) + 1234).astype(np.uint32)
    .view(np.float32),
}


def _python_text(v):
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return repr(float(np.float32(v)))


@pytest.mark.parametrize("name", sorted(VALUES))
def test_each_value_is_the_repr_of_its_python_float(name):
    arr = VALUES[name]
    text = jsonfmt.reply({"v": arr[None]}, {})
    assert text.startswith('{"v": [[') and text.endswith("]]}")
    got = text[len('{"v": [['):-3].split(", ")
    if name == "bit_sweep":  # the same Python floats, without a numpy scalar each
        with np.errstate(invalid="ignore"):  # signalling NaNs
            want = json.dumps(arr.astype(np.float64).tolist())[1:-1].split(", ")
    else:
        want = [_python_text(v) for v in arr]
    assert len(got) == len(want)
    bad = [(w, g) for w, g in zip(want, got) if w != g]
    assert not bad, bad[:10]


@pytest.mark.parametrize("shape", [(3, 4), (1, 480), (0, 5), (2, 0), (0,), (7,)])
def test_arrays_nest_as_json_dumps_nests_their_lists(shape):
    arr = (np.arange(int(np.prod(shape))) * 0.37 - 1).astype(np.float32).reshape(shape)
    head = {"a": {"b": arr, "c": [1, 2.5], "d": None}, "e": "x"}
    assert jsonfmt.reply(head, {}) == json.dumps(jsonfmt.plain(head))


@pytest.mark.parametrize("char", ['"', "\\", "\x00", "\n", "\x1f", "\x7f", "\x80", "\u00e9", " ", "~"])
@pytest.mark.parametrize("at", [0, 17, 999])
def test_strings_are_written_as_json_dumps_escapes_them(char, at):
    text = "".join(chr(0x20 + i % 95) for i in range(1000)).replace('"', "a").replace("\\", "b")
    head = {"s": text[:at] + char + text[at + 1:], "t": text}
    TRACER.reset()
    TRACER.enable()
    try:
        got = jsonfmt.reply(head, {})
        escaped = TRACER.export()["counters"].get("jsonfmt.escaped_strings", 0)
    finally:
        TRACER.disable()
        TRACER.reset()
    assert got == json.dumps(head)
    assert escaped == (char not in " ~")


def test_other_dtypes_and_keys_go_through_json_dumps():
    head = {"f64": np.array([0.1, 1e-7]), "i": np.arange(3), 1: "int key", "s": b"raw"}
    assert jsonfmt.reply(head, {"z": np.zeros(2, np.float32)}) == (
        json.dumps(jsonfmt.plain(head))[:-1] + ',"z":[0,0]}')


def test_a_reply_reuses_the_last_buffer_and_none_of_its_old_text(monkeypatch):
    """Replies in a row write into one buffer while it is large enough; a
    shorter reply after a longer one carries nothing of the longer's text,
    and a longer one gets a larger buffer."""
    monkeypatch.setattr(jsonfmt, "_spare", [])
    rng = np.random.default_rng(11)

    def one(n, tag):
        head = {"type": tag, "analysis": {"a": rng.standard_normal((3, 4)).astype(np.float32)}}
        arr = (0.3 * rng.standard_normal(n)).astype(np.float32)
        got = jsonfmt.reply(head, {"s": arr})
        assert got == json.dumps(jsonfmt.plain(head))[:-1] + ',"s":' + \
            native.json_f32_array(arr) + "}"
        return jsonfmt._spare[-1]

    first = one(2 ** 16 + 5, "a")
    assert one(300, "b") is first
    assert one(2 ** 16 + 5, "c") is first
    assert one(2 ** 17, "d") is not first
    assert len(jsonfmt._spare) == 1
