"""The port's utilities on the CPU against the JAX package's: device
selection, ``BlockTimer``, ``PlotAnalyzer`` (mirrors
tests/test_analysis.py), the tempo helpers (mirrors tests/test_tempo.py)
and the audio-device helpers without ``sounddevice``.

``PlotAnalyzer``'s bars are one rounding step of the values it ships (the
spectrum is rounded to 0.01 dB, the chroma to 1e-4), plus float32's
spacing at the rounded values; the spectrum is compared where JAX's value
is above -100 dB, well over the 1e-7 magnitude floor (-140 dB) where one
package's FFT rounding noise is all there is."""


import numpy as np
import pytest
import torch

from aefs_tpu.utils.analysis import PlotAnalyzer as JaxPlotAnalyzer
from aefs_tpu.utils.metrics import BlockTimer as JaxBlockTimer
from aefs_tpu_torch.engine import devices
from aefs_tpu_torch.utils import tempo
from aefs_tpu_torch.utils.analysis import FFT_SIZE, PlotAnalyzer
from aefs_tpu_torch.utils.metrics import BlockTimer
from aefs_tpu_torch.utils.platform import require_device, select_device

from helpers import noise, tones

FS = 48000
SPEC_TOL, CHROMA_TOL = 0.01 + 1e-5, 1e-4 + 1e-7


# -- device selection ---------------------------------------------------------

def test_select_device_reads_aefs_platform(monkeypatch):
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    assert select_device() == torch.device("cpu")
    assert select_device("cuda") == torch.device("cpu")  # the environment wins, as in JAX
    monkeypatch.delenv("AEFS_PLATFORM")
    assert select_device("cpu") == torch.device("cpu")


def test_select_device_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("AEFS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert select_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        select_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        require_device("cuda:0")
    assert require_device("cpu") == torch.device("cpu")


# -- BlockTimer ----------------------------------------------------------------

@pytest.mark.parametrize("times", [
    [],
    [0.001, 0.002, 0.0065, 0.004],
    list(np.random.default_rng(0).uniform(0.0, 0.012, 3000)),  # wraps the window
])
def test_block_timer_snapshot_equals_jax(times):
    ours, theirs = BlockTimer(FS, 256), JaxBlockTimer(FS, 256)
    for t in times:
        ours.record(float(t))
        theirs.record(float(t))
    assert ours.snapshot() == theirs.snapshot()


def test_block_timer_counts_a_block_that_raises():
    timer = BlockTimer(22050, 256)
    with pytest.raises(ValueError):
        with timer.block():
            raise ValueError("device error")
    snap = timer.snapshot()
    assert snap["blocks"] == 1 and snap["deadline_ms"] == round(1000 * 256 / 22050, 3)


# -- PlotAnalyzer ----------------------------------------------------------------

def _close_to_jax(got, want):
    s_got, s_want = np.asarray(got["spectrum_db"]), np.asarray(want["spectrum_db"])
    assert s_got.shape == s_want.shape
    above = s_want > -100
    assert above.any() and np.max(np.abs(s_got - s_want)[above]) <= SPEC_TOL
    assert np.max(np.abs(np.subtract(got["chroma"], want["chroma"]))) <= CHROMA_TOL


@pytest.mark.parametrize("fs", [48000, 22050])
def test_analyze_file_matches_jax(fs):
    x = noise(fs * 2, channels=1, amp=0.3)[:, 0]
    y = tones(fs * 2, channels=1, fs=fs)[:, 0]
    got = PlotAnalyzer(fs, device="cpu").analyze_file(x, y)
    want = JaxPlotAnalyzer(fs).analyze_file(x, y)
    assert got["hop_s"] == want["hop_s"] and got["freqs"] == want["freqs"]
    for k in ("original", "processed"):
        _close_to_jax(got[k], want[k])


def test_update_matches_jax():
    ours, theirs = PlotAnalyzer(FS, device="cpu"), JaxPlotAnalyzer(FS)
    for i in range(3):
        a = tones(5000 * (i + 1), channels=1)[:, 0]
        b = noise(3000, channels=1, seed=i)[:, 0]
        got, want = ours.update(a, b), theirs.update(a, b)
        for k in ("input", "output"):
            _close_to_jax(got[k], want[k])
        np.testing.assert_array_equal(ours.rings["input"], theirs.rings["input"])


def test_spectrum_peak_at_tone():
    an = PlotAnalyzer(FS, device="cpu")
    t = np.arange(FFT_SIZE * 2) / FS
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    out = an.update(tone, tone * 0.1)
    freqs = np.asarray(out["freqs"])
    spec_in = np.asarray(out["input"]["spectrum_db"])
    spec_out = np.asarray(out["output"]["spectrum_db"])
    assert 950 < freqs[int(np.argmax(spec_in))] < 1060
    assert abs((spec_in.max() - spec_out.max()) - 20.0) < 2.0  # output 20 dB quieter


def test_chroma_picks_pitch_class():
    an = PlotAnalyzer(FS, device="cpu")
    t = np.arange(FFT_SIZE * 2) / FS
    tone = sum(np.sin(2 * np.pi * f * t) for f in (220.0, 440.0, 880.0))
    out = an.update((0.1 * tone).astype(np.float32), tone.astype(np.float32))
    assert int(np.argmax(out["input"]["chroma"])) == 9  # pitch class A


def test_rolling_ring_keeps_window():
    an = PlotAnalyzer(FS, device="cpu")
    chunk = np.ones(1000, np.float32)
    an.update(chunk, chunk)
    an.update(chunk * 2, chunk * 2)
    assert an.rings["input"][-1] == 2.0 and an.rings["input"][-1001] == 1.0


def test_analyze_file_windows_track_content():
    t = np.arange(FS) / FS
    sig = np.concatenate([0.4 * np.sin(2 * np.pi * 440 * t),
                          0.4 * np.sin(2 * np.pi * 880 * t)]).astype(np.float32)
    res = PlotAnalyzer(FS, device="cpu").analyze_file(sig, sig, min_hop_s=0.25)
    freqs = np.asarray(res["freqs"])
    spec = np.asarray(res["original"]["spectrum_db"])
    n_win = spec.shape[0]
    assert n_win >= 6 and res["hop_s"] * n_win >= 1.9
    assert abs(freqs[np.argmax(spec[2])] - 440) < 40
    assert abs(freqs[np.argmax(spec[n_win - 1])] - 880) < 80
    assert np.asarray(res["processed"]["chroma"]).shape == (n_win, 12)


# -- tempo and audio devices ---------------------------------------------------

def test_tempo_delay_times():
    assert tempo.delay_ms_for(120) == 500.0
    assert tempo.delay_ms_for(120, "1/8") == 250.0
    assert tempo.delay_ms_for(120, "1/4.") == 750.0
    assert abs(tempo.delay_ms_for(120, "1/4T") - 1000.0 / 3.0) < 1e-9
    with pytest.raises(ValueError):
        tempo.delay_ms_for(0)
    with pytest.raises(ValueError, match="unknown division"):
        tempo.delay_ms_for(120, "1/3")


def test_tempo_lfo_rate():
    assert tempo.lfo_rate_hz_for(120) == 2.0
    assert tempo.lfo_rate_hz_for(120, "1/2") == 1.0
    assert abs(tempo.lfo_rate_hz_for(90, "1/8") - 3.0) < 1e-12


def test_audio_devices_without_sounddevice(monkeypatch):
    monkeypatch.setattr(devices, "sd", None)
    assert devices.pick_devices() == (None, None)
    assert devices.list_devices() == []
