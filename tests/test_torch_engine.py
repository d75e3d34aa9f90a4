"""The port's engine session layer on the CPU, against the JAX engine and
against itself (mirrors tests/test_engine.py, test_mic_stream.py,
test_file_stream.py, test_engine_races.py and test_noise_profile.py).

Bars: audio against the JAX engine within -90 dBFS; the file stream, the
pipelined step and the warmed rebuild bit-equal to the port's own
blockwise hot path; learned noise profiles equal to JAX's (the same numpy
analysis); the ``file_processed`` payload within one 16-bit step of
JAX's, its analysis within one rounding step of the shipped values.
"""

import asyncio
import base64
import copy
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from aefs_tpu.engine.engine import AudioEngine as JaxEngine
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import BLOCKSIZE, DEFAULT_PRESETS
from aefs_tpu_torch.engine import engine as engine_mod
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline, render_batch
from aefs_tpu_torch.engine.wavio import decode_wav, encode_wav_int16, resample_bandlimited
from aefs_tpu_torch.models.spectral import measure_noise_profile
from aefs_tpu_torch.utils.analysis import PlotAnalyzer
from __graft_entry__ import FLAGSHIP

from helpers import bursts, noise, tones
from oracles import err_dbfs

FS = 48000
N = BLOCKSIZE
DELAY = [{"effect_id": "d1", "type": "delay",
          "params": {"feedback": 0.2, "delay_ms": 20, "mix_dry": 1,
                     "mix_wet": 1, "offset_ms": 0}}]
FILTER = [{"effect_id": "f", "type": "filter",
           "params": {"filter_type": 0, "cutoff_hz": 2000, "q": 0.7}}]
SPECTRAL = {"effect_id": "s", "type": "spectral",
            "params": {"threshold_db": -80.0, "reduction": 0.0,
                       "profile_over_db": 6.0}}
CONV = [{"effect_id": "cv", "type": "convreverb",
         "params": {"ir_seconds": 0.5, "mix_dry": 0.7, "mix_wet": 0.5}}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(cfg=()):
    eng = AudioEngine(device="cpu")
    eng.build_chain(copy.deepcopy(list(cfg)))
    return eng


def _blocks(seed, n, amp=0.3):
    rng = np.random.default_rng(seed)
    return [(amp * rng.standard_normal((N, 1))).astype(np.float32) for _ in range(n)]


def _data_url(x, fs=FS):
    wav = encode_wav_int16(np.asarray(x, np.float32).reshape(len(x), -1), fs)
    return "data:audio/wav;base64," + base64.b64encode(wav).decode()


def _drain(q, timeout=60.0):
    """(seq, block) pairs from a playback queue until its None sentinel."""
    items, deadline = [], time.monotonic() + timeout
    while True:
        item = q.get(timeout=max(0.1, deadline - time.monotonic()))
        if item is None:
            return items
        items.append(item)


# -- no fallback to the CPU ------------------------------------------------

@pytest.mark.parametrize("entry", ["build_chain", "AudioEngine", "render_batch",
                                   "process_offline", "PlotAnalyzer"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, every entry point asks for the card, and
    raises where there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default runs there")
    x = np.zeros((FS // 10, 1), np.float32)
    calls = {
        "build_chain": lambda: build_chain(FILTER, FS, N),
        "AudioEngine": lambda: AudioEngine(),
        "render_batch": lambda: render_batch(FILTER, [x], FS),
        "process_offline": lambda: process_offline(FILTER, x, FS),
        "PlotAnalyzer": lambda: PlotAnalyzer(FS),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()


# -- the mic stream with a fake sounddevice ---------------------------------

class FakeStream:
    created = []
    negotiate = staticmethod(lambda sr: sr)

    def __init__(self, samplerate, blocksize, dtype, latency, channels,
                 callback, prime_output_buffers_using_stream_callback, device=None):
        self.samplerate = FakeStream.negotiate(samplerate)
        self.blocksize = blocksize
        self.channels = channels
        self.callback = callback
        self.device = device
        self.running = False
        FakeStream.created.append(self)

    def start(self):
        self.running = True

    def stop(self):
        self.running = False

    def close(self):
        pass

    def pump(self, blocks):
        outs = []
        for indata in blocks:
            outdata = np.zeros((self.blocksize, self.channels[1]), np.float32)
            self.callback(indata, outdata, self.blocksize, None, 0)
            outs.append(outdata.copy())
        return outs


@pytest.fixture
def fake_sd(monkeypatch):
    monkeypatch.setattr(engine_mod, "sd", types.SimpleNamespace(Stream=FakeStream))
    monkeypatch.setattr(FakeStream, "created", [])
    monkeypatch.setattr(FakeStream, "negotiate", staticmethod(lambda sr: sr))
    return FakeStream


def test_mic_stream_without_hardware(monkeypatch):
    monkeypatch.setattr(engine_mod, "sd", None)
    eng = _engine()
    eng.start_mic_stream()  # no sounddevice: the server-mode no-op
    assert not eng.is_running
    eng.stop_stream()


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_mic_stream_callback_round_trip(fake_sd, monkeypatch, pipeline):
    """The callback runs the pipelined step by default (the first block
    primes silent, then each callback returns the previous block's audio)
    and the synchronous one with AEFS_STREAM_PIPELINE=0; either way the
    audio equals the hot path's, bit for bit."""
    monkeypatch.setenv("AEFS_STREAM_PIPELINE", pipeline)
    blocks = _blocks(4, 5)
    ref_eng = _engine(FILTER)
    ref = [ref_eng.process_stream_block(b) for b in blocks]
    eng = _engine(FILTER)
    eng.start_mic_stream()
    assert eng.is_running
    st = fake_sd.created[-1]
    assert st.blocksize == 256 and st.channels == (1, 2) and st.device is None
    outs = st.pump(blocks)
    if pipeline == "1":
        assert np.all(outs[0] == 0)
        ref = ref[:-1]
        outs = outs[1:]
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert eng.metrics.snapshot()["blocks"] == len(blocks)
    assert eng.data_queues["input"].qsize() == len(blocks)
    eng.start_mic_stream()  # a double start warns, does not stack streams
    assert len(fake_sd.created) == 1
    eng.stop_stream()
    assert not eng.is_running and not st.running


def test_mic_samplerate_renegotiation(fake_sd):
    fake_sd.negotiate = staticmethod(lambda sr: 44100)
    eng = _engine(FILTER)
    eng.start_mic_stream()
    assert eng.current_sample_rate == 44100
    assert eng.metrics.fs == 44100 and eng.metrics.snapshot()["blocks"] == 0
    assert eng.chain.fs == 44100
    assert fake_sd.created[-1].pump(_blocks(1, 2))[-1].shape == (256, 2)


def test_set_devices_restarts_running_stream(fake_sd):
    eng = _engine(FILTER)
    eng.start_mic_stream()
    eng.set_devices(3, 5)
    assert eng.is_running
    assert fake_sd.created[-1].device == (3, 5) and len(fake_sd.created) == 2
    eng.stop_stream()
    eng.set_devices(None, None)
    assert eng.devices == (None, None)
    assert not eng.is_running


# -- the block step ---------------------------------------------------------

def test_pipelined_step_is_sync_shifted_one_block():
    """Block k's return value is block k-1's audio bit for bit; priming and
    a chain swap return one silent block."""
    blocks = _blocks(5, 6, amp=0.2)
    ref_eng = _engine(FLAGSHIP)
    ref = [ref_eng.process_stream_block(b) for b in blocks]
    eng = _engine(FLAGSHIP)
    got = [eng.process_stream_block_pipelined(b) for b in blocks]
    assert np.all(got[0] == 0.0)
    for k in range(1, len(blocks)):
        np.testing.assert_array_equal(got[k], ref[k - 1])
    eng.build_chain(FLAGSHIP)
    assert np.all(eng.process_stream_block_pipelined(blocks[0]) == 0.0)
    np.testing.assert_array_equal(eng.process_stream_block_pipelined(blocks[1]), ref[0])


def test_rebuild_warmup_leaves_the_live_state_fresh():
    """build_chain and resume_session warm the new chain on a throw-away
    state: the first live block equals a fresh chain's first block."""
    x = _blocks(6, 1)[0]
    chain, state, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    _, y = chain.process_block(state, chain.targets(tmap), torch.from_numpy(x.T.copy()))
    eng = _engine(FLAGSHIP)
    np.testing.assert_array_equal(eng.process_stream_block(x), y.numpy().T)


def test_stream_blocks_are_timed():
    eng = _engine(FILTER)
    for b in _blocks(7, 5):
        eng.process_stream_block(b)
    snap = eng.metrics.snapshot()
    assert snap["blocks"] == 5 and snap["deadline_ms"] == round(1000 * N / FS, 3)


def test_streaming_matches_jax_engine():
    blocks = _blocks(8, 6)
    jeng = JaxEngine()
    jeng.build_chain(copy.deepcopy(FLAGSHIP))
    want = np.concatenate([jeng.process_stream_block(b) for b in blocks])
    eng = _engine(FLAGSHIP)
    got = np.concatenate([eng.process_stream_block(b) for b in blocks])
    assert err_dbfs(got, want) <= -90, err_dbfs(got, want)


# -- the live file stream ---------------------------------------------------

def test_file_stream_empty_chain_exact_passthrough():
    rng = np.random.default_rng(0)
    n = FS // 4 + 100  # not a blocksize multiple
    x = (0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    eng = _engine()
    assert eng.start_file_stream(_data_url(x), realtime=False)
    items = _drain(eng.playback_queue)
    assert not eng.is_running
    assert [s for s, _ in items] == list(range(len(items)))
    y = np.concatenate([b for _, b in items])
    decoded, _ = decode_wav(encode_wav_int16(x, FS))
    assert y.shape == (n, 2)
    np.testing.assert_array_equal(y[:, 0], decoded[:, 0])
    np.testing.assert_array_equal(y[:, 1], decoded[:, 0])
    eng.close()


def test_file_stream_matches_blockwise_hot_path():
    """The flagship's streamed file is bit for bit the blockwise hot path of
    a twin engine on the decoded blocks."""
    x = (0.3 * np.random.default_rng(1).standard_normal((8 * N, 1))).astype(np.float32)
    eng = _engine(FLAGSHIP)
    eng.start_file_stream(_data_url(x), realtime=False)
    y = np.concatenate([b for _, b in _drain(eng.playback_queue)])
    eng.close()
    decoded, _ = decode_wav(encode_wav_int16(x, FS))
    twin = _engine(FLAGSHIP)
    ref = np.concatenate([twin.process_stream_block(decoded[i * N:(i + 1) * N])
                          for i in range(8)])
    np.testing.assert_array_equal(y, ref)


def test_file_stream_stop_midway_and_renegotiation():
    fs = 22050
    x = (0.2 * np.random.default_rng(2).standard_normal((fs * 4, 1))).astype(np.float32)
    eng = _engine([{"effect_id": "g", "type": "gate",
                    "params": {"threshold_db": -60, "attack_ms": 5, "release_ms": 50}}])
    assert eng.start_file_stream(_data_url(x, fs), realtime=True) is True
    assert eng.is_running and eng.current_sample_rate == fs
    assert eng.metrics.fs == fs and eng.chain.fs == fs
    assert eng.start_file_stream(_data_url(x, fs)) is False  # already running
    got = [eng.playback_queue.get(timeout=60)]
    eng.stop_stream()
    t0 = time.monotonic()
    got += _drain(eng.playback_queue, timeout=30)
    assert time.monotonic() - t0 < 10
    assert not eng.is_running
    assert 1 <= len(got) < fs * 4 // 512
    assert eng.process_stream_block(np.zeros((N, 1), np.float32)).shape == (N, 2)
    eng.close()


def test_set_devices_leaves_file_stream_alone():
    x = (0.3 * np.random.default_rng(5).standard_normal((FS // 2, 1))).astype(np.float32)
    eng = _engine()
    assert eng.start_file_stream(_data_url(x), realtime=False)
    eng.set_devices(1, 2)
    assert eng.devices == (1, 2)
    y = np.concatenate([b for _, b in _drain(eng.playback_queue)])
    assert y.shape == (FS // 2, 2)
    assert not eng.is_running


@pytest.mark.parametrize("previous", ["none", "finished"])
def test_stop_during_file_stream_start(monkeypatch, previous):
    """``stop_stream`` landing while ``start_file_stream`` is inside
    ``Thread.start``.  With no previous stream, the stop has nothing to
    join.  With a finished previous stream still recorded, the JAX engine
    had already swapped in the new stop event, so the stop ended the new
    stream before its first block and could leave ``is_running`` stuck;
    the port publishes the stop event with the started thread, so the new
    stream plays out and the flag drops at its end."""
    x = (0.2 * np.random.default_rng(0).standard_normal((1024, 1))).astype(np.float32)
    url = _data_url(x)
    eng = _engine(DELAY)
    if previous == "finished":
        assert eng.start_file_stream(url, realtime=False)
        assert len(_drain(eng.playback_queue)) == 4
        eng._file_thread.join(timeout=30)
        assert not eng._file_thread.is_alive() and not eng.is_running

    real_thread = threading.Thread
    in_start, gate = threading.Event(), threading.Event()

    class GatedThread(real_thread):
        def start(self):
            in_start.set()
            gate.wait(timeout=30)
            real_thread.start(self)

    errs = []

    def starter():
        try:
            assert eng.start_file_stream(url, realtime=False)
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    monkeypatch.setattr(engine_mod.threading, "Thread", GatedThread)
    try:
        w = real_thread(target=starter, daemon=True)
        w.start()
        assert in_start.wait(timeout=30), "engine never reached start()"
        eng.stop_stream()  # the new thread exists but is not started
    finally:
        gate.set()
        monkeypatch.undo()
    w.join(timeout=30)
    assert not w.is_alive() and not errs, errs
    assert len(_drain(eng.playback_queue)) == 1024 // 256  # the start won
    eng._file_thread.join(timeout=30)
    assert not eng.is_running
    assert eng.start_file_stream(url, realtime=False)  # not stuck
    assert len(_drain(eng.playback_queue)) == 4
    eng.stop_stream()
    eng.close()


@pytest.mark.parametrize("path", ["sync", "pipelined"])
def test_save_session_while_streaming(path, tmp_path):
    """Saves race a streaming thread; every checkpoint resumes, and the
    last resumes bit-exact against its own engine's next block."""
    eng = _engine(DELAY)
    step = eng.process_stream_block if path == "sync" else eng.process_stream_block_pipelined
    stop, errs, blk = threading.Event(), [], _blocks(3, 1)[0]

    def audio():
        try:
            while not stop.is_set():
                step(blk)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=audio)
    t.start()
    try:
        for i in range(6):
            eng.save_session(str(tmp_path / f"ck{i}"))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errs, errs
    eng2 = AudioEngine(device="cpu")
    assert [c["effect_id"] for c in eng2.resume_session(str(tmp_path / "ck5"))] == ["d1"]
    eng.save_session(str(tmp_path / "last"))
    eng2.resume_session(str(tmp_path / "last"))
    np.testing.assert_array_equal(eng.process_stream_block(blk), eng2.process_stream_block(blk))


def test_randomized_concurrency_hammer(tmp_path):
    """Two control threads race param storms, rebuilds, save/resume, file
    streams and file jobs against a streaming audio thread: no exception,
    no non-finite audio, no wedged thread."""
    rng = np.random.default_rng(1234)
    errors, stop = [], threading.Event()
    eng = _engine(DELAY)
    url = _data_url((0.2 * rng.standard_normal((2048, 1))).astype(np.float32))
    cfg_b = DELAY + [{"effect_id": "g1", "type": "gate", "params": {"threshold_db": -45}}]

    class NullWS:
        async def send(self, m):
            pass

    def audio_thread():
        x = (0.1 * rng.standard_normal((N, 1))).astype(np.float32)
        try:
            while not stop.is_set():
                if not np.all(np.isfinite(eng.process_stream_block(x))):
                    errors.append("non-finite audio")
                    return
        except Exception as e:  # pragma: no cover
            errors.append(f"audio: {type(e).__name__}: {e}")

    def control_thread(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(20):
                op = r.integers(0, 12)
                if op == 10:
                    eng.start_file_stream(url, realtime=False)
                elif op == 11:
                    eng.stop_stream()
                elif op <= 4:
                    eng.update_param(str(r.choice(["d1", "g1", "zz"])),
                                     str(r.choice(["feedback", "threshold_db", "bogus"])),
                                     float(r.uniform(-100, 2000)))
                elif op <= 6:
                    eng.build_chain(copy.deepcopy(DELAY if r.random() < 0.5 else cfg_b))
                elif op == 7:
                    eng.save_session(str(tmp_path / f"s{seed}"))
                elif op == 8:
                    try:
                        eng.resume_session(str(tmp_path / f"s{seed}"))
                    except FileNotFoundError:
                        pass
                else:
                    asyncio.run(eng.process_wav_file(url, NullWS()))
        except Exception as e:  # pragma: no cover
            errors.append(f"ctl{seed}: {type(e).__name__}: {e}")

    at = threading.Thread(target=audio_thread, daemon=True)
    cts = [threading.Thread(target=control_thread, args=(s,), daemon=True) for s in (1, 2)]
    at.start()
    for t in cts:
        t.start()
    for t in cts:
        t.join(timeout=120)
        assert not t.is_alive(), "control thread wedged"
    stop.set()
    at.join(timeout=60)
    assert not at.is_alive(), "audio thread wedged"
    assert not errors, errors
    eng.stop_stream()
    out = eng.process_stream_block((0.1 * rng.standard_normal((N, 1))).astype(np.float32))
    assert out.shape == (N, 2) and np.all(np.isfinite(out))
    eng.close()


# -- uploaded IRs and learned noise profiles ---------------------------------

def _room_tone(frames, seed=11, amp=0.02):
    x = noise(frames, channels=1, amp=amp, seed=seed)[:, 0]
    return np.convolve(x, np.ones(4, np.float32) / 4.0, "same").astype(np.float32)


def _jax_engine(cfg):
    eng = JaxEngine()
    eng.build_chain(copy.deepcopy(cfg))
    return eng


def test_set_ir_matches_jax_streaming_and_file():
    rng = np.random.default_rng(17)
    ir = (rng.standard_normal((2, 7001)) * np.exp(-np.arange(7001) / 2000.0)).astype(np.float32)
    url = _data_url(0.2 * ir.T, fs=44100)  # resampled to the engine rate
    blocks = _blocks(19, 4)
    x = tones(FS // 4)
    got, want = [], []
    for eng, outs in ((_engine(CONV), got), (_jax_engine(CONV), want)):
        with pytest.raises(ValueError, match="not a convreverb"):
            eng.set_ir("nope", url)
        assert eng.set_ir("cv", url) == pytest.approx(7001 / 44100)
        outs.append(np.concatenate([eng.process_stream_block(b) for b in blocks]))
        outs.append(eng.process_file_array(x, FS)[1])
    assert err_dbfs(got[0], want[0]) <= -90, err_dbfs(got[0], want[0])
    assert err_dbfs(got[1], want[1]) <= -90, err_dbfs(got[1], want[1])


def test_learn_noise_from_wav_matches_jax():
    """The learned profile (the same numpy analysis) and the floor equal
    JAX's; the gate then mutes same-statistics noise on the live path."""
    url = _data_url(_room_tone(FS))
    eng, jeng = _engine([SPECTRAL]), _jax_engine([SPECTRAL])
    with pytest.raises(ValueError):
        eng.learn_noise("nope", contents=url)
    floor_db = eng.learn_noise("s", contents=url)
    assert floor_db == jeng.learn_noise("s", contents=url) and floor_db < -20.0
    np.testing.assert_array_equal(eng.noise_profiles["s"], jeng.noise_profiles["s"])
    x = _room_tone(24 * N, seed=12).reshape(-1, 1)
    y = np.concatenate([eng.process_stream_block(x[i:i + N]) for i in range(0, len(x), N)])
    yj = np.concatenate([jeng.process_stream_block(x[i:i + N]) for i in range(0, len(x), N)])
    assert err_dbfs(y, yj) <= -90, err_dbfs(y, yj)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    assert rms(y[12 * N:]) < 0.2 * rms(x[12 * N:])


def test_learn_noise_offrate_wav_resamples():
    room = _room_tone(FS)
    eng = _engine([SPECTRAL])
    eng.learn_noise("s", contents=_data_url(room, fs=FS // 2))
    got = eng.noise_profiles["s"]
    jeng = _jax_engine([SPECTRAL])
    jeng.learn_noise("s", contents=_data_url(room, fs=FS // 2))
    np.testing.assert_array_equal(got, jeng.noise_profiles["s"])
    want = measure_noise_profile(resample_bandlimited(room, 2 * len(room)), hop=N)
    corr = np.corrcoef(got, want)[0, 1]
    assert corr > 0.99, corr
    assert np.corrcoef(got, measure_noise_profile(room, hop=N))[0, 1] < corr


def test_learn_noise_downrate_wav_does_not_alias():
    t = np.arange(2 * FS) / (2 * FS)
    sig = _room_tone(2 * FS, amp=0.005) + 0.4 * np.sin(2 * np.pi * 30000 * t).astype(np.float32)
    eng = _engine([SPECTRAL])
    eng.learn_noise("s", contents=_data_url(sig, fs=2 * FS))
    got = eng.noise_profiles["s"]
    freqs = np.fft.rfftfreq(2 * N, 1 / FS)
    alias = np.argmin(np.abs(freqs - 18000))
    assert got[alias] < 4 * np.median(got[(freqs > 4000) & (freqs < 16000)])


def _learn_live(eng, seconds=0.05):
    result = {}
    th = threading.Thread(target=lambda: result.setdefault(
        "floor_db", eng.learn_noise("s", seconds=seconds)))
    th.start()
    return th, result


def _feed_until_done(eng, th):
    room = _room_tone(FS // 2)
    i = 0
    while th.is_alive() and i + N <= len(room):
        eng.process_stream_block(room[i:i + N].reshape(-1, 1))
        i += N
    th.join(timeout=30)
    assert not th.is_alive()


def test_learn_noise_live_capture():
    eng = _engine([SPECTRAL])
    th, result = _learn_live(eng)
    _feed_until_done(eng, th)
    assert result["floor_db"] < -20.0 and "s" in eng.noise_profiles
    eng.close()


def test_concurrent_learn_noise_rejected():
    eng = _engine([SPECTRAL])
    th, result = _learn_live(eng)
    deadline = time.monotonic() + 5
    while eng._noise_capture is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(ValueError, match="already in progress"):
        eng.learn_noise("s", seconds=0.05)
    _feed_until_done(eng, th)
    assert "floor_db" in result
    eng.close()


def test_resume_prunes_profiles_absent_from_checkpoint(tmp_path):
    eng = _engine([SPECTRAL])
    path = eng.save_session(str(tmp_path / "sess"))  # no profile
    eng.learn_noise("s", contents=_data_url(_room_tone(FS)))
    assert "s" in eng.noise_profiles
    eng.resume_session(path)
    assert "s" not in eng.noise_profiles
    eng.close()


# -- the file upload path ----------------------------------------------------

class _FakeWS:
    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)


def test_process_wav_file_payload_matches_jax():
    """The ``file_processed`` payload: its WAV is ``process_file_array``'s
    int16 encoding and within one 16-bit step of JAX's; the sample arrays
    match; the analysis is within one rounding step of JAX's shipped values
    (0.01 dB where JAX's spectrum is above -100 dB, 1e-4 in chroma)."""
    x = (tones(FS // 2, fs=FS) + bursts(FS // 2, amp=0.2)).astype(np.float32)
    url = _data_url(x)
    msgs = []
    for eng in (_engine(DEFAULT_PRESETS["Rain Delay"]), _jax_engine(DEFAULT_PRESETS["Rain Delay"])):
        ws = _FakeWS()
        asyncio.run(eng.process_wav_file(url, ws))
        assert len(ws.sent) == 1 and not eng.is_processing_file
        msgs.append(json.loads(ws.sent[0]))
    got, want = msgs
    assert got["type"] == "file_processed" and got["sample_rate"] == FS
    assert got["original_b64"] == url
    eng = _engine(DEFAULT_PRESETS["Rain Delay"])
    audio, _ = decode_wav(base64.b64decode(url.split(",")[1]))
    _, processed = eng.process_file_array(audio, FS)
    wav = base64.b64decode(got["processed_b64"].split(",")[1])
    assert wav == encode_wav_int16(processed, FS)
    a, _ = decode_wav(wav)
    b, _ = decode_wav(base64.b64decode(want["processed_b64"].split(",")[1]))
    assert np.max(np.abs(a.astype(np.float64) - b)) * 32768.0 <= 1.0 + 1e-9
    np.testing.assert_array_equal(got["original_samples"], want["original_samples"])
    assert err_dbfs(got["processed_samples"], want["processed_samples"]) <= -90
    ga, wa = got["analysis"], want["analysis"]
    assert ga["hop_s"] == wa["hop_s"] and ga["freqs"] == wa["freqs"]
    for k in ("original", "processed"):
        s_got, s_want = np.asarray(ga[k]["spectrum_db"]), np.asarray(wa[k]["spectrum_db"])
        assert s_got.shape == s_want.shape
        above = s_want > -100
        # One rounding step, plus float32's spacing at the rounded values.
        assert np.max(np.abs(s_got - s_want)[above]) <= 0.01 + 1e-5
        assert np.max(np.abs(np.subtract(ga[k]["chroma"], wa[k]["chroma"]))) <= 1e-4 + 1e-7


def test_process_wav_file_without_analysis(monkeypatch):
    monkeypatch.setenv("AEFS_SERVER_ANALYSIS", "0")
    ws = _FakeWS()
    eng = _engine(FILTER)
    asyncio.run(eng.process_wav_file(_data_url(tones(FS // 10)), ws))
    msg = json.loads(ws.sent[0])
    assert "analysis" not in msg and len(msg["processed_samples"]) == FS // 10
    assert eng.last_file_contents is not None


def test_process_file_array_carries_uploads():
    """File mode renders with the session's learned profile, like JAX."""
    url = _data_url(_room_tone(FS))
    x = (_room_tone(FS // 2, seed=12) + tones(FS // 2, channels=1, amp=0.1)[:, 0])[:, None]
    outs = []
    for eng in (_engine([SPECTRAL]), _jax_engine([SPECTRAL])):
        plain = eng.process_file_array(x, FS)[1]
        eng.learn_noise("s", contents=url)
        outs.append(eng.process_file_array(x, FS)[1])
        assert not np.array_equal(outs[-1], plain)
    assert err_dbfs(outs[0], outs[1]) <= -90, err_dbfs(outs[0], outs[1])


def test_close_stops_and_drops_the_chain():
    eng = _engine(FILTER)
    eng.close()
    assert eng.chain is None and not eng.is_running
