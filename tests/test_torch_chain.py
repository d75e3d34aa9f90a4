"""The flagship chain in the PyTorch port against the JAX package and the
composed float64 oracles, streaming and file mode; state carried across
packages; the octaver's bitwise blocksize invariance; the engine's
streaming path; the registry's refusal of effect types not ported yet."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.engine.engine import process_offline as jax_offline
from aefs_tpu.models import EFFECT_REGISTRY as JAX_REGISTRY
from aefs_tpu_torch import check_precision
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline
from aefs_tpu_torch.models import EFFECT_REGISTRY
from __graft_entry__ import FLAGSHIP

from helpers import bursts, mono, noise, tones
from oracles import (
    OracleBiquad,
    OracleGate,
    OracleOctaver,
    OracleReverb,
    OracleStereoDelay,
    err_dbfs,
    run_oracle_blocks,
)

FS = 48000
N = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def composed_oracles(x_mono, blocksize):
    """The flagship chain as float64 oracles, mono fanned to stereo."""
    sig = np.repeat(x_mono.astype(np.float64), 2, axis=1)
    for cfg, oracle in zip(FLAGSHIP, (OracleGate, OracleOctaver, OracleBiquad,
                                      OracleStereoDelay, OracleReverb)):
        sig = run_oracle_blocks(oracle(FS, **cfg["params"]), sig, blocksize)
    return sig


def test_flagship_streaming_vs_jax_and_oracles():
    x = mono(bursts(16 * N, amp=0.4))
    chain, state, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    _, got = chain.process_array(state, chain.targets(tmap), x)
    jchain, jstate, jtmap = jax_build(FLAGSHIP, FS, N, channels_in=1)
    _, ref = jchain.process_array(jstate, jchain.targets(jtmap), x)
    assert got.shape == (16 * N, 2)
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    assert err_dbfs(got, composed_oracles(x, N)) <= -80


def test_flagship_process_offline_vs_jax_and_oracles():
    x = bursts(FS, amp=0.4)  # 1 s stereo: the file's mono mix is rendered
    m, got = process_offline(FLAGSHIP, x, FS, device="cpu")
    _, ref = jax_offline(FLAGSHIP, x, FS)
    assert got.shape == (FS, 2) and np.all(np.isfinite(got))
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    oracle = np.clip(composed_oracles(m, 4096), -1.0, 1.0)
    assert err_dbfs(got, oracle) <= -80, err_dbfs(got, oracle)


def test_state_carried_across_packages():
    """A stream started in JAX continues in the port: k blocks in JAX,
    state_from_numpy, the rest in the port, against JAX continuing."""
    x = mono(bursts(24 * N, amp=0.4, seed=5))
    k = 10
    jchain, jstate, jtmap = jax_build(FLAGSHIP, FS, N, channels_in=1)
    jtargets = jchain.targets(jtmap)
    jst, _ = jchain.process_array(jstate, jtargets, x[: k * N])
    handoff = jax.tree.map(np.asarray, jst)
    jst2, ref = jchain.process_array(jax.tree.map(jnp.asarray, handoff), jtargets, x[k * N:])

    chain, _, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    st, got = chain.process_array(state_from_numpy(handoff, "cpu"),
                                  chain.targets(tmap), x[k * N:])
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    for a, b in zip(jax.tree.leaves(state_to_numpy(st)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jst2))):
        if np.issubdtype(b.dtype, np.integer):
            assert np.array_equal(a, b)
        else:
            assert err_dbfs(a, b) <= -90


def test_state_numpy_roundtrip_keeps_dtypes():
    chain, state, _ = build_chain(FLAGSHIP, FS, N, device="cpu")
    back = state_from_numpy(state_to_numpy(state), "cpu")
    for a, b in zip(jax.tree.leaves(state_to_numpy(state)), jax.tree.leaves(state_to_numpy(back))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    octaver = state["fx"][1]
    assert octaver["n_abs"].dtype == torch.int32 and state["fx"][3]["row"].dtype == torch.int32


@pytest.mark.parametrize("semitones", [-12, 7, 4.98])
def test_octaver_blocksize_invariance_bitwise(semitones):
    """The octaver's phase is a pure function of the absolute sample index:
    256-sample and 4096-sample blocks give bitwise the same output."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": semitones, "mix": 1.0}}]
    x = noise(4 * 4096, amp=0.3, seed=9)
    outs = []
    for bs in (256, 4096):
        chain, state, tmap = build_chain(cfg, FS, bs, channels_in=2, device="cpu")
        outs.append(chain.process_array(state, chain.targets(tmap), x)[1])
    assert np.array_equal(outs[0], outs[1])


def test_engine_streaming_matches_chain():
    """AudioEngine.process_stream_block block by block == the chain over the
    same stream; the plot queues receive every block pair."""
    x = mono(bursts(16 * N, amp=0.4, seed=2))
    eng = AudioEngine(device="cpu")
    eng.build_chain(FLAGSHIP)
    got = np.concatenate([eng.process_stream_block(x[i * N:(i + 1) * N])
                          for i in range(16)])
    chain, state, tmap = build_chain(FLAGSHIP, FS, N, channels_in=1, device="cpu")
    _, ref = chain.process_array(state, chain.targets(tmap), x)
    assert got.shape == (16 * N, 2)
    assert err_dbfs(got, ref) <= -100, err_dbfs(got, ref)
    assert eng.data_queues["input"].qsize() == eng.data_queues["output"].qsize() == 16
    assert eng.data_queues["input"].get().shape == (N, 2)


def test_engine_update_param_glides_and_syncs_config():
    cfg = [{"effect_id": "d", "type": "delay",
            "params": {"delay_ms": 300, "feedback": 0.1, "mix_dry": 1.0,
                       "mix_wet": 1.0, "offset_ms": 0}}]
    eng = AudioEngine(device="cpu")
    eng.build_chain(cfg)
    eng.update_param("d", "feedback", 0.9)
    eng.update_param("nope", "feedback", 0.5)  # reference warning, no raise
    eng.update_param("d", "nope", 0.5)
    for _ in range(10):
        eng.process_stream_block(np.zeros((N, 1), np.float32))
    fb = float(eng.chain_state["params"][0]["feedback"])
    assert abs(fb - (0.1 + 10 * 0.02)) < 1e-5
    assert eng.last_chain_config[0]["params"]["feedback"] == 0.9


def test_engine_file_array_uses_last_config():
    x = bursts(FS // 4, amp=0.4, seed=4)
    eng = AudioEngine(device="cpu")
    eng.build_chain(FLAGSHIP)
    _, got = eng.process_file_array(x, FS)
    _, ref = process_offline(FLAGSHIP, x, FS, device="cpu")
    assert np.array_equal(got, ref)


def test_registry_covers_jax_registry():
    """The port's registry equals JAX's: every effect type is ported."""
    assert set(EFFECT_REGISTRY) == set(JAX_REGISTRY)


@pytest.mark.parametrize("etype", ["compressor", "convreverb", "limiter", "multiband",
                                   "parallel", "spectral", "stereowidth", "waveshaper"])
def test_last_slice_effect_type_builds(etype):
    """The types this slice ports build behind the flagship's head and
    report their kind (``multiband`` expands onto the parallel container)."""
    extra = {"ir_seconds": 0.05} if etype == "convreverb" else {}
    cfg = FLAGSHIP[:2] + [{"effect_id": "z", "type": etype, "params": extra}]
    chain, state, tmap = build_chain(cfg, FS, N, device="cpu")
    model = dict(chain.effects)["z"]
    assert model.kind == ("parallel" if etype == "multiband" else etype)
    assert isinstance(model, EFFECT_REGISTRY[model.kind])
    _, y = chain.process_block(state, chain.targets(tmap), torch.zeros((1, N)))
    assert y.shape == (2, N) and bool(torch.isfinite(y).all())


def test_unknown_effect_type_skipped():
    chain, state, tmap = build_chain(
        [{"effect_id": "z", "type": "nope", "params": {}}], FS, N, device="cpu")
    assert len(chain.effects) == 0
    x = noise(2 * N, channels=1)
    _, y = chain.process_array(state, chain.targets(tmap), x)
    assert np.array_equal(y[:, 0], x[:, 0]) and np.array_equal(y[:, 1], x[:, 0])


def test_full_fp32_matmuls_enforced():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    check_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="fp32"):
            check_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_flagship_superblocks_vs_jax():
    """Blocks longer than the comb and allpass lags: the reverb's
    fixed-point comb bank, the allpass residue-class scan and the delay's
    doubling feedback solve, against JAX at the same blocksize."""
    x = mono(bursts(8 * 2048, amp=0.4, seed=6))
    statics = {"delay": {"min_delay_ms": 375.0}}
    chain, state, tmap = build_chain(FLAGSHIP, FS, 2048, channels_in=1,
                                     static_overrides=statics, device="cpu")
    _, got = chain.process_array(state, chain.targets(tmap), x)
    jchain, jstate, jtmap = jax_build(FLAGSHIP, FS, 2048, channels_in=1,
                                      static_overrides=statics)
    _, ref = jchain.process_array(jstate, jchain.targets(jtmap), x)
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)


# --- The modulation slice: its five presets end to end ---------------------

MODULATION_PRESETS = ["Lush Chorus", "Jet Flanger", "Psychedelic Sweep", "Funky Talk",
                      "8-Bit Arcade"]
# Program per preset, as the JAX package's parity tests drive each effect:
# tonal for the swept delays and allpasses, noise bursts for the envelope
# wah and the bit crusher.
PROGRAM = {"Lush Chorus": "tones", "Jet Flanger": "tones", "Psychedelic Sweep": "tones",
           "Funky Talk": "bursts", "8-Bit Arcade": "bursts"}


def _program(kind, frames, seed):
    return tones(frames, amp=0.4) if kind == "tones" else bursts(frames, amp=0.4, seed=seed)


def _offline_both(name, x):
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    _, got = process_offline(DEFAULT_PRESETS[name], x, FS, device="cpu")
    _, ref = jax_offline(DEFAULT_PRESETS[name], x, FS)
    assert got.shape == x.shape and np.all(np.isfinite(got))
    return got, ref


def _streaming_both(name, x):
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    blocks = x.shape[0] // N
    eng = AudioEngine(device="cpu")
    eng.build_chain(DEFAULT_PRESETS[name])
    got = np.concatenate([eng.process_stream_block(x[i * N:(i + 1) * N]) for i in range(blocks)])
    jchain, jstate, jtmap = jax_build(DEFAULT_PRESETS[name], FS, N, channels_in=1)
    _, ref = jchain.process_array(jstate, jchain.targets(jtmap), x)
    assert got.shape == (blocks * N, 2) and np.all(np.isfinite(got))
    return got, ref


@pytest.mark.parametrize("name", MODULATION_PRESETS)
def test_modulation_preset_process_offline_vs_jax(name):
    """File mode through the engine's entry (``process_offline``: fresh
    chain, whole-signal fast path) on 1 s of seeded stereo, against the
    JAX engine's render."""
    got, ref = _offline_both(name, _program(PROGRAM[name], FS, seed=12))
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)


@pytest.mark.parametrize("name", MODULATION_PRESETS)
def test_modulation_preset_streaming_vs_jax(name):
    """256-sample streaming through ``AudioEngine.process_stream_block`` on
    1 s of seeded mono, against the JAX chain's block step."""
    got, ref = _streaming_both(name, mono(_program(PROGRAM[name], (FS // N) * N, seed=13)))
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_lush_chorus_on_noise_bursts_vs_jax(mode):
    """On white-noise bursts the chorus's tap turns the ulp by which the two
    packages' float32 sin differ into delay error times the signal's slope
    (~5e-5 samples x ~1 per sample): measured -87..-89 dBFS against JAX, so
    -80 here (the JAX package pins its own chorus on noise at -55,
    tests/test_effects_parity.py:548)."""
    x = bursts(FS, amp=0.4, seed=12)
    got, ref = _offline_both("Lush Chorus", x) if mode == "offline" else \
        _streaming_both("Lush Chorus", mono(x[:(FS // N) * N]))
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


# --- The last slice: dynamics, FFT effects and the containers ---------------

LAST_SLICE_PRESETS = ["Clean Noise Removal", "Crunch", "Concert Hall (Convolution)", "Glue Bus",
                      "Master Bus", "Broadcast Voice", "Multiband Master"]
PROGRAM.update({"Clean Noise Removal": "gate", "Crunch": "tones"})


def _last_program(name, frames, seed):
    kind = PROGRAM.get(name, "bursts")
    if kind == "gate":  # the JAX spectral parity test's program
        return (noise(frames, amp=0.1, seed=seed) + tones(frames, amp=0.2)).astype(np.float32)
    return _program(kind, frames, seed)


def _oracle_chain(cfg, x_mono):
    """A chain of filters, compressors, width and limiter (with parallel
    branches) as float64 oracles, mono fanned to stereo."""
    from oracles import OracleCompressor, OracleLimiter, OracleStereoWidth

    kinds = {"filter": OracleBiquad, "compressor": OracleCompressor,
             "stereowidth": OracleStereoWidth, "limiter": OracleLimiter}

    def run(effects, sig):
        for c in effects:
            sig = run_oracle_blocks(kinds[c["type"]](FS, **c["params"]), sig, N)
        return sig

    sig = np.repeat(x_mono.astype(np.float64), 2, axis=1)
    for c in cfg:
        if c["type"] == "parallel":
            gains = c.get("params", {})
            sig = np.clip(sum(gains.get(f"gain_{bi}", 1.0) * run(br, sig)
                              for bi, br in enumerate(c["branches"])), -1.0, 1.0)
        else:
            sig = run([c], sig)
    return sig


@pytest.mark.parametrize("name", LAST_SLICE_PRESETS)
@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_last_slice_preset_vs_jax(name, mode):
    """File mode through ``process_offline`` and 256-sample streaming
    through ``AudioEngine`` on 1 s of seeded program, against JAX.

    "Multiband Master" is the stated exception: the JAX package solves its
    biquads in float32, which at the 150 Hz crossover stays only -30 dBFS
    (streaming) and -60 dBFS (file) from the float64 oracle; the port
    solves them in float64 (ops/scan.py:biquad_block).  There the port is
    held to the oracle chain at -80 dBFS, and its whole gap to JAX must be
    JAX's own distance from the oracle."""
    x = _last_program(name, FS, seed=12)
    if mode == "offline":
        got, ref = _offline_both(name, x)
    else:
        got, ref = _streaming_both(name, mono(x[:(FS // N) * N]))
    if name != "Multiband Master":
        assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
        return
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    m = mono(x) if mode == "offline" else mono(x[:(FS // N) * N])
    oracle = np.clip(_oracle_chain(DEFAULT_PRESETS[name], m), -1.0, 1.0)
    assert err_dbfs(got, oracle) <= -80, err_dbfs(got, oracle)
    assert err_dbfs(got, ref) <= err_dbfs(ref, oracle) + 1.0, (err_dbfs(got, ref),
                                                              err_dbfs(ref, oracle))


def test_every_preset_builds():
    """All 17 factory presets, and a compact multiband config, build on the
    port's registry and step one block."""
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    compact = [{"effect_id": "mb", "type": "multiband", "crossover_hz": [250.0, 2500.0],
                "branches": [[{"effect_id": "c", "type": "compressor", "params": {}}]]}]
    configs = list(DEFAULT_PRESETS.values()) + [compact]
    assert len(configs) == 18
    for cfg in configs:
        chain, state, tmap = build_chain(cfg, FS, N, device="cpu")
        assert len(chain.effects) == len(cfg)
        _, y = chain.process_block(state, chain.targets(tmap), torch.zeros((1, N)))
        assert bool(torch.isfinite(y).all())
