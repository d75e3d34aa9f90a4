"""The benchmark's plain float64 convolution reverb
(``benchmark/reference/convreverb.py``) against the port: its IR is the
program's, the 256-sample streaming step, the whole-file pass through the
engine (one file and a batch of two) and the preset's 2.5 s IR agree with
it, and an output rounded to bfloat16 does not.  The whole-file path's IR
spectrum: a float64 transform on the chain's device, rounded once to
complex64, with no NumPy FFT and one kept copy of the IR.  The effect's
spans and counters: once per whole-file render, none while the tracer is
off, and the render the same bytes either way."""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS, FILE_SUPERBLOCK
from aefs_tpu_torch.core.fileopts import file_static_overrides
from aefs_tpu_torch.engine.engine import process_offline, render_batch
from aefs_tpu_torch.models.convreverb import ConvReverb, synthetic_ir
from aefs_tpu_torch.utils.metrics import TRACER
from benchmark.reference import convreverb as ref
from benchmark.refchain import render_mono, run_chain

from helpers import noise, tones
from oracles import err_dbfs

FS = 48000
HALL = DEFAULT_PRESETS["Concert Hall (Convolution)"]
# A 0.25 s IR: 47 partitions of 256 when streaming, 3 of 4,096 per file.
SHORT = [{"effect_id": "cv1", "type": "convreverb",
          "params": {"ir_seconds": 0.25, "mix_dry": 0.7, "mix_wet": 0.5}}]
# The port convolves in float32 (complex64 spectra, the IR's spectrum
# rounded to complex64), the reference in float64: the transforms'
# rounding, a few float32 ulps of the signal's level, reads -136 to -150
# dBFS here.  -120 leaves 16 dB of room; an output held in bfloat16 (an
# ulp of 2^-8) reads -46 to -61.
PORT_DBFS = -120.0
SPANS = ("convreverb.ir_spectrum", "convreverb.conv", "convreverb.state")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tracer():
    """The process's tracer enabled and empty for the test, then off and
    empty again."""
    TRACER.reset()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


def _mono_reference(x, cfg):
    """(frames, 2) as the engine takes it -> the reference's (frames, 2)
    of its mono mix, clipped as the engine clips."""
    return np.clip(render_mono(x.astype(np.float64).mean(axis=1), cfg, FS), -1.0, 1.0).T


@pytest.mark.parametrize("seconds", [2.5, 0.25])
def test_the_references_ir_is_the_programs(seconds):
    want = synthetic_ir(FS, seconds, channels=2)
    got = ref.impulse_response(FS, seconds, 2).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("signal", [noise, tones], ids=["noise", "tones"])
def test_streaming_matches_the_reference(signal):
    x = signal(16 * 4096)
    chain, state, tmap = build_chain(SHORT, FS, 256, channels_in=2, device="cpu")
    assert chain.effects[0][1].partitions > 1
    got = chain.process_array(state, chain.targets(tmap), x)[1]
    assert err_dbfs(got, run_chain(x.T, SHORT, FS).T) <= PORT_DBFS


@pytest.mark.parametrize("signal", [noise, tones], ids=["noise", "tones"])
def test_file_mode_matches_the_reference(signal):
    x = signal(16 * 4096 + 100)
    _mono, got = process_offline(SHORT, x, FS, device="cpu")
    assert err_dbfs(got, _mono_reference(x, SHORT)) <= PORT_DBFS


def test_a_batch_of_two_files_matches_the_reference():
    files = [noise(12 * 4096 + 77, seed=3), tones(9 * 4096)]
    outs = render_batch(SHORT, files, FS, device="cpu")
    for x, got in zip(files, outs):
        assert got.shape == x.shape
        assert err_dbfs(got, _mono_reference(x, SHORT)) <= PORT_DBFS


def test_the_presets_ir_matches_the_reference():
    """The shipped 2.5 s IR (30 partitions of 4,096, the file's transform
    of 2^18) on a file shorter than the IR."""
    x = noise(3 * 4096 + 500, seed=5)
    _mono, got = process_offline(HALL, x, FS, device="cpu")
    assert err_dbfs(got, _mono_reference(x, HALL)) <= PORT_DBFS


def test_a_bfloat16_output_fails_the_tolerance():
    x = noise(8 * 4096)
    want = run_chain(x.T, SHORT, FS)
    rounded = run_chain(x.T, SHORT, FS, "bfloat16")
    assert err_dbfs(rounded, want) > PORT_DBFS + 40


# -- the whole-file path's IR spectrum --------------------------------------

def _within_two_ulps(got, want):
    """Each real and imaginary part of ``got`` within two float32 ulps of
    ``want``'s (``np.spacing``), or within 2^-40 of max|want| where the part
    is near zero."""
    floor = 2.0 ** -40 * np.abs(want).max()
    return all(np.all(np.abs(g.astype(np.float64) - w) <= np.maximum(2 * np.spacing(np.abs(w)), floor))
               for g, w in ((got.real, want.real), (got.imag, want.imag)))


@pytest.mark.parametrize("model", [
    lambda: ConvReverb(FS, FILE_SUPERBLOCK, ir_seconds=2.5),
    # 47 partitions of 256 padded to 49: the padding is part of the IR.
    lambda: ConvReverb(FS, 256, ir_seconds=0.25, partition_multiple=4),
], ids=["hall", "padded"])
def test_the_ir_spectrum_is_numpys_float64_transform_rounded_once(model):
    model = model()
    ir = model._ir_time
    got = model._ir_spectrum(2 ** 18, "cpu")
    assert got.dtype == torch.complex64 and tuple(got.shape) == (2, 2 ** 18)
    want = np.fft.fft(ir.astype(np.float64), 2 ** 18).astype(np.complex64)
    assert _within_two_ulps(got.numpy(), want)


def _hall_chain():
    """The preset as ``process_offline`` builds it for a file."""
    return build_chain(HALL, FS, FILE_SUPERBLOCK, channels_in=1, channels_out=2,
                       static_overrides=file_static_overrides(HALL), device="cpu")


def test_a_file_render_calls_no_numpy_fft(monkeypatch):
    x = noise(5 * 4096, seed=4)
    want = process_offline(HALL, x, FS, device="cpu")[1]
    chain, state, tmap = _hall_chain()  # the build's partition spectra use np.fft

    def refuse(*_a, **_k):
        raise AssertionError("np.fft called on the whole-file path")
    for name in ("fft", "ifft", "rfft", "irfft", "fftn", "ifftn", "rfftn", "irfftn",
                 "fft2", "rfft2", "hfft", "ihfft"):
        monkeypatch.setattr(np.fft, name, refuse)
    mono = x.mean(axis=1, keepdims=True).astype(np.float32)
    got = np.clip(chain.process_array(state, chain.targets(tmap), mono, fast=True)[1], -1, 1)
    assert got.tobytes() == want.tobytes()


def test_two_renders_make_one_device_copy_of_the_ir():
    chain, state, tmap = _hall_chain()
    model = chain.effects[0][1]
    assert model._ir_dev == {}
    mono = noise(5 * 4096, channels=1, seed=6)
    chain.process_array(state, chain.targets(tmap), mono, fast=True)
    (key, copy), = model._ir_dev.items()
    assert key == "cpu" and np.array_equal(copy.numpy(), model._ir_time)
    chain.process_array(state, chain.targets(tmap), mono[: 4 * 4096], fast=True)
    assert list(model._ir_dev) == ["cpu"] and model._ir_dev["cpu"] is copy


# -- the spans and counters ------------------------------------------------------

def _spans(ex):
    return {name: len(ex["spans"].get(name, ())) for name in ("convreverb.build",) + SPANS}


def test_a_file_render_spans_and_counts_once(tracer):
    x = noise(5 * 4096)
    process_offline(HALL, x, FS, device="cpu")
    ex = tracer.export()
    assert _spans(ex) == dict.fromkeys(("convreverb.build",) + SPANS, 1)
    assert {r for n in ("convreverb.build",) + SPANS for r, _s, _e in ex["spans"][n]} == {None}
    (_r, f0, f1), = ex["spans"]["chain.file_effect"]
    starts = [ex["spans"][n][0][1:] for n in SPANS]
    assert all(f0 <= s <= e <= f1 for s, e in starts)
    assert all(a[1] <= b[0] for a, b in zip(starts, starts[1:]))  # in order, apart
    # nfft = 2^18 >= 20,480 + 120,000 samples, for each of the IR's 2 channels
    assert ex["counters"]["convreverb.file_renders"] == 1
    assert ex["counters"]["convreverb.device_fft_points"] == 2 * 2 ** 18
    assert "convreverb.host_fft_points" not in ex["counters"]


def test_a_batch_counts_its_files_and_spans_once(tracer):
    render_batch(SHORT, [noise(4 * 4096), noise(3 * 4096, seed=2)], FS, device="cpu")
    ex = tracer.export()
    assert _spans(ex) == dict.fromkeys(("convreverb.build",) + SPANS, 1)
    assert ex["counters"]["convreverb.file_renders"] == 2
    assert ex["counters"]["convreverb.device_fft_points"] == 2 * 2 ** 15
    assert "convreverb.host_fft_points" not in ex["counters"]


def test_a_streaming_block_keeps_no_convreverb_span(tracer):
    chain, state, tmap = build_chain(SHORT, FS, 256, device="cpu")
    tracer.reset()  # the build's span
    chain.process_block(state, chain.targets(tmap), torch.zeros(1, 256))
    assert tracer.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": tracer.offset_ns}}


def test_off_records_nothing_and_renders_the_same_bytes(tracer):
    x = noise(5 * 4096, seed=9)
    on = process_offline(HALL, x, FS, device="cpu")[1]
    tracer.disable()
    tracer.reset()
    off = process_offline(HALL, x, FS, device="cpu")[1]
    assert tracer.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": tracer.offset_ns}}
    assert on.tobytes() == off.tobytes()
