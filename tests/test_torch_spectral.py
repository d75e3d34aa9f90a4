"""The FFT slice of the PyTorch port (``ops/fftops.py``, the spectral gate,
the convolution reverb) against the JAX package and the float64 oracles.

256-sample streaming and file mode against JAX (<= -90 dBFS on the output,
final state trees compared by path) and against the oracle (<= -80 dBFS);
blocking invariance; a JAX stream continued in the port; the convolution
reverb's whole-file state handoff; a learned noise profile and a user IR
through ``process_offline(extra_static=...)`` in both packages.  IRs stay
at or under 0.3 s, except in the handoff test's long-IR case."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.engine.engine import process_offline as jax_offline
from aefs_tpu.models.spectral import measure_noise_profile as jax_measure
from aefs_tpu.ops import fftops as jfft
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from aefs_tpu_torch.engine.engine import process_offline
from aefs_tpu_torch.models import synthetic_ir
from aefs_tpu_torch.models.convreverb import ConvReverb
from aefs_tpu_torch.models.spectral import measure_noise_profile
from aefs_tpu_torch.ops import fftops as tfft

from helpers import noise, tones
from oracles import OracleConvReverb, OracleSpectral, err_dbfs, run_oracle_blocks
from test_torch_models import assert_states_close, run_both

FS = 48000
N = 256
STREAM_FRAMES = 40 * N
FILE_FRAMES = 6 * 4096
IR_S = 0.25


def _gate_signal(frames):
    """The JAX spectral parity test's program: noise plus tones."""
    return (noise(frames, amp=0.1) + tones(frames, amp=0.2)).astype(np.float32)


SPECTRAL = [  # tests/test_effects_parity.py:597-602; the middle one is the preset's
    {"threshold_db": -45, "reduction": 0.2},
    {"threshold_db": -50, "reduction": 0.1},
    {"threshold_db": -20, "reduction": 0.7},
]
CONV = {"ir_seconds": IR_S, "mix_dry": 0.7, "mix_wet": 0.4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(etype, params):
    return [{"effect_id": "e", "type": etype, "params": params}]


# --- fftops ----------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [512, 768])
def test_frame_signal_matches_jax(n_fft):
    hop = 256
    rng = np.random.default_rng(0)
    tail = rng.standard_normal(n_fft - hop).astype(np.float32)
    x = rng.standard_normal(4 * hop).astype(np.float32)
    frames, new_tail = tfft.frame_signal(torch.from_numpy(tail), torch.from_numpy(x), n_fft, hop)
    jframes, jtail = jfft.frame_signal(jnp.asarray(tail), jnp.asarray(x), n_fft, hop)
    assert np.array_equal(frames.numpy(), np.asarray(jframes))
    assert np.array_equal(new_tail.numpy(), np.asarray(jtail))


def test_overlap_add_and_window_match_jax():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((5, 512)).astype(np.float32)
    tail = rng.standard_normal(256).astype(np.float32)
    y, t = tfft.overlap_add(torch.from_numpy(frames), torch.from_numpy(tail), 256)
    jy, jt = jfft.overlap_add(jnp.asarray(frames), jnp.asarray(tail), 256)
    assert np.array_equal(y.numpy(), np.asarray(jy)) and np.array_equal(t.numpy(), np.asarray(jt))
    assert np.array_equal(tfft.hann_window(512).numpy(), np.asarray(jfft.hann_window(512)))
    ir = synthetic_ir(FS, 0.01, channels=1)[0]
    assert np.array_equal(tfft.partition_ir(ir, 64), jfft.partition_ir(ir, 64))


@pytest.mark.parametrize("k", [1, 4])
def test_partitioned_fft_conv_matches_jax(k):
    """One hop per call (the flipped window) and four (the gather)."""
    hop, p = 64, 7
    rng = np.random.default_rng(2)
    ir = jfft.partition_ir(rng.standard_normal(p * hop - 10).astype(np.float32), hop)
    hist = rng.standard_normal((2, p - 1, hop + 1)).astype(np.float32)
    tail = rng.standard_normal(hop).astype(np.float32)
    x = rng.standard_normal(k * hop).astype(np.float32)
    ir_c = torch.complex(*torch.from_numpy(ir).unbind(0))
    y, h, t = tfft.partitioned_fft_conv(torch.from_numpy(hist), torch.from_numpy(tail),
                                        torch.from_numpy(x), ir_c, hop)
    jy, jh, jt = jfft.partitioned_fft_conv(jnp.asarray(hist), jnp.asarray(tail),
                                           jnp.asarray(x), jnp.asarray(ir), hop)
    scale = float(np.max(np.abs(np.asarray(jy))))
    assert err_dbfs(y.numpy() / scale, np.asarray(jy) / scale) <= -120
    assert h.shape == jh.shape and err_dbfs(h.numpy() / 100, np.asarray(jh) / 100) <= -120
    assert np.array_equal(t.numpy(), np.asarray(jt))


# --- the spectral gate -------------------------------------------------------

def _spectral_check(params, x, blocksize, fast):
    out, st, jout, jst = run_both(_cfg("spectral", params), x, blocksize, fast=fast)
    assert out.shape == x.shape and np.all(np.isfinite(out))
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)
    ref = run_oracle_blocks(OracleSpectral(FS, hop=N, **params), x.astype(np.float64), N)
    assert err_dbfs(out, ref) <= -80, err_dbfs(out, ref)


@pytest.mark.parametrize("params", SPECTRAL, ids=["-45dB", "-50dB", "-20dB"])
def test_spectral_streaming_vs_jax_and_oracle(params):
    _spectral_check(params, _gate_signal(STREAM_FRAMES), N, fast=False)


@pytest.mark.parametrize("params", SPECTRAL, ids=["-45dB", "-50dB", "-20dB"])
def test_spectral_file_mode_vs_jax_and_oracle(params):
    """File mode: all hops of the whole signal framed and transformed in
    one batch, the hop pinned at 256."""
    _spectral_check(params, _gate_signal(FILE_FRAMES), 4096, fast=True)


def test_spectral_blocking_invariance():
    x = _gate_signal(6 * 4096)
    outs = []
    for bs in (256, 4096):
        chain, state, tmap = build_chain(_cfg("spectral", SPECTRAL[0]), FS, bs, channels_in=2,
                                         device="cpu")
        outs.append(chain.process_array(state, chain.targets(tmap), x)[1])
    assert err_dbfs(outs[0], outs[1]) <= -110, err_dbfs(outs[0], outs[1])


def test_measure_noise_profile_matches_jax():
    room = noise(FS // 2, channels=1, amp=0.02, seed=11)[:, 0]
    assert np.array_equal(measure_noise_profile(room), jax_measure(room))


def test_noise_profile_and_user_ir_through_process_offline():
    """A learned noise profile and an uploaded IR ride ``extra_static`` in
    both packages: the engine's file path with its static merge."""
    room = noise(FS // 2, channels=1, amp=0.02, seed=11)[:, 0]
    profile = measure_noise_profile(room)
    ir = synthetic_ir(FS, 0.1, channels=2, seed=7)
    cfg = [{"effect_id": "s", "type": "spectral",
            "params": {"threshold_db": -80.0, "reduction": 0.0, "profile_over_db": 12.0}},
           {"effect_id": "c", "type": "convreverb", "params": {"mix_dry": 0.8, "mix_wet": 0.5}}]
    extra = {"s": {"noise_profile": profile}, "c": {"ir": ir}}
    x = (noise(FS // 2, amp=0.02, seed=12) + tones(FS // 2, amp=0.25)).astype(np.float32)
    _, got = process_offline(cfg, x, FS, extra_static=extra, device="cpu")
    _, ref = jax_offline(cfg, x, FS, extra_static=extra)
    assert got.shape == (FS // 2, 2) and np.all(np.isfinite(got))
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    _, plain = process_offline(cfg, x, FS, device="cpu")
    assert err_dbfs(got, plain) > -40  # the profile and the IR took effect


def test_noise_profile_shape_is_checked():
    with pytest.raises(ValueError, match="257 bins"):
        build_chain(_cfg("spectral", {}), FS, N, static_overrides={"e": {"noise_profile": [0.0]}},
                    device="cpu")


# --- the convolution reverb -----------------------------------------------------

def _conv_oracle(x):
    ir = synthetic_ir(FS, IR_S, channels=2)
    oracle = OracleConvReverb(ir, mix_dry=CONV["mix_dry"], mix_wet=CONV["mix_wet"])
    return run_oracle_blocks(oracle, x.astype(np.float64), N)


@pytest.mark.parametrize("blocksize,fast,extra", [
    (256, False, {}),                  # streaming: one hop per block, the flipped window
    (4096, True, {}),                  # file mode: one whole-signal FFT, state rebuilt
    (4096, False, {}),                 # 4096 superblocks, hop 4096: one hop per block
    (4096, False, {"hop": 256}),       # 16 hops per block: the gather
    (256, False, {"partition_multiple": 4}),  # zero partitions set the state's P
], ids=["stream-256", "file", "superblock-4096", "superblock-hop256", "partition-multiple"])
def test_convreverb_vs_jax_and_oracle(blocksize, fast, extra):
    frames = STREAM_FRAMES if blocksize == 256 else FILE_FRAMES
    x = noise(frames, amp=0.2)
    out, st, jout, jst = run_both(_cfg("convreverb", {**CONV, **extra}), x, blocksize, fast=fast)
    assert out.shape == x.shape and np.all(np.isfinite(out))
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)
    assert err_dbfs(out, _conv_oracle(x)) <= -80, err_dbfs(out, _conv_oracle(x))


def test_convreverb_blocking_invariance():
    x = noise(4 * 4096, amp=0.2)
    outs = []
    for bs in (256, 4096):
        chain, state, tmap = build_chain(_cfg("convreverb", CONV), FS, bs, channels_in=2,
                                         device="cpu")
        outs.append(chain.process_array(state, chain.targets(tmap), x)[1])
    assert err_dbfs(outs[0], outs[1]) <= -110, err_dbfs(outs[0], outs[1])


@pytest.mark.parametrize("ir_seconds", [0.3, 2.5, 0.02])
def test_convreverb_file_state_handoff(ir_seconds):
    """The whole-file path rebuilds the end-of-file state exactly:
    continuing blockwise from it matches a blockwise run throughout
    (tests/test_fastpath.py's three IR lengths: IR shorter than the file,
    longer than it, and shorter than one hop, P == 1)."""
    hop = 4096
    eff = ConvReverb(FS, hop, channels=2, ir_seconds=ir_seconds)
    rng = np.random.default_rng(7)
    xa = torch.from_numpy((0.3 * rng.standard_normal((2, 12 * hop))).astype(np.float32))
    xb = torch.from_numpy((0.3 * rng.standard_normal((2, 2 * hop))).astype(np.float32))
    p = {"mix_dry": torch.tensor(0.7), "mix_wet": torch.tensor(0.4)}

    st_fast, _ = eff.process_file(eff.init_state(), p, xa)
    _, y_cont = eff.process(st_fast, p, xb)
    st = eff.init_state()
    for j in range(12):
        st, _ = eff.process(st, p, xa[:, j * hop:(j + 1) * hop])
    _, y_ref = eff.process(st, p, xb)
    assert st_fast["spec_hist"].shape == st["spec_hist"].shape
    assert err_dbfs(y_cont.numpy(), y_ref.numpy()) <= -90


@pytest.mark.parametrize("etype", ["spectral", "convreverb"])
def test_jax_stream_continues_in_the_port(etype):
    """k blocks in JAX, the state handed over as numpy, the rest in the
    port: against JAX continuing, output and every state leaf."""
    params = SPECTRAL[1] if etype == "spectral" else CONV
    x = _gate_signal(24 * N) if etype == "spectral" else noise(24 * N, amp=0.2)
    k = 10
    cfg = _cfg(etype, params)
    jchain, jstate, jtmap = jax_build(cfg, FS, N, channels_in=2)
    jtargets = jchain.targets(jtmap)
    jst, _ = jchain.process_array(jstate, jtargets, x[: k * N])
    handoff = jax.tree.map(np.asarray, jst)
    jst2, ref = jchain.process_array(jax.tree.map(jnp.asarray, handoff), jtargets, x[k * N:])

    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")
    st, got = chain.process_array(state_from_numpy(handoff, "cpu"), chain.targets(tmap),
                                  x[k * N:])
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst2))


@pytest.mark.parametrize("etype,params", [
    ("convreverb", CONV), ("convreverb", {**CONV, "ir_seconds": 0.02}),
    ("spectral", SPECTRAL[1]),
], ids=["convreverb", "convreverb-one-hop-ir", "spectral"])
def test_file_mode_file_axis(etype, params):
    """``process_file`` over three files on a leading file axis: each file
    bit-equal to its own single-file call (the convolution's IR spectrum
    computed once for all files, its rebuilt overlap-save state per file)."""
    from test_torch_batch import file_axis_vs_per_file

    file_axis_vs_per_file(_cfg(etype, params))
