"""The modulation family (tremolo, chorus, phaser, wah, ring mod,
bitcrusher, flanger) in the PyTorch port against the JAX package and the
float64 oracles.

Per effect, at its preset's params and at one case of the JAX package's own
parity tests: 256-sample streaming through ``process`` and file mode
through ``process_file`` against JAX (<= -90 dBFS on the output, final
state trees compared leaf by leaf by path, the uint32 phase accumulators
exactly) and against the oracle (<= -80 dBFS); the JAX package's
blocking-invariance properties; exact passthrough at mix 0 / depth 0; a
JAX stream continued in the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy

from helpers import bursts, noise, tones
from oracles import (
    OracleBitcrusher,
    OracleChorus,
    OracleFlanger,
    OraclePhaser,
    OracleRingMod,
    OracleTremolo,
    OracleWah,
    err_dbfs,
    run_oracle_blocks,
)
from test_torch_models import assert_states_close, run_both

FS = 48000
N = 256
STREAM_FRAMES = 40 * N
FILE_FRAMES = 6 * 4096

_PRESET = {c["type"]: c["params"] for name in ("Lush Chorus", "Jet Flanger", "Psychedelic Sweep",
                                                "Funky Talk", "8-Bit Arcade")
           for c in DEFAULT_PRESETS[name]}

ORACLES = {
    "tremolo": OracleTremolo, "chorus": OracleChorus, "phaser": OraclePhaser,
    "wah": OracleWah, "ringmod": OracleRingMod, "bitcrusher": OracleBitcrusher,
    "flanger": OracleFlanger,
}

# (type, case, params, signal): each effect at its preset and at one case of
# tests/test_effects_parity.py, on the signal that test uses.
CASES = [
    ("tremolo", "default", {"rate_hz": 5.0, "depth": 0.5, "spread": 0.0}, bursts),
    ("tremolo", "autopan", {"rate_hz": 0.3, "depth": 1.0, "spread": 0.5}, bursts),
    ("chorus", "lush", _PRESET["chorus"], tones),
    ("chorus", "wide", {"rate_hz": 0.2, "depth_ms": 8.0, "base_ms": 30.0,
                        "mix": 0.7, "spread": 0.5}, tones),
    ("phaser", "psychedelic", _PRESET["phaser"], tones),
    ("phaser", "fast", {"rate_hz": 4.0, "min_hz": 80, "max_hz": 6000,
                        "mix": 1.0, "spread": 0.0}, tones),
    ("wah", "funky", _PRESET["wah"], noise),
    ("wah", "high-q", {"rate_hz": 0.5, "min_hz": 100, "max_hz": 4000, "res": 8.0,
                       "mix": 0.7, "mode": 0.0, "sens": 4.0, "env_ms": 30.0}, tones),
    ("ringmod", "arcade", _PRESET["ringmod"], bursts),
    ("ringmod", "top", {"carrier_hz": 5000.0, "mix": 0.7, "spread": 0.25}, bursts),
    ("bitcrusher", "arcade", _PRESET["bitcrusher"], bursts),
    ("bitcrusher", "one-bit", {"bits": 1.0, "rate_hz": 11025.0, "mix": 1.0}, bursts),
    ("flanger", "jet", _PRESET["flanger"], tones),
    ("flanger", "negative", {"rate_hz": 2.0, "depth_ms": 4.0, "base_ms": 1.0,
                             "feedback": -0.7, "mix": 1.0, "spread": 0.25}, tones),
]
IDS = [f"{t}-{c}" for t, c, _, _ in CASES]
TYPES = ["tremolo", "chorus", "phaser", "wah", "ringmod", "bitcrusher", "flanger"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(etype, params):
    return [{"effect_id": "e", "type": etype, "params": params}]


def _check(etype, params, x, blocksize, fast):
    out, st, jout, jst = run_both(_cfg(etype, params), x, blocksize, fast=fast)
    assert out.shape == x.shape and np.all(np.isfinite(out))
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)
    ref = run_oracle_blocks(ORACLES[etype](FS, **params), x.astype(np.float64), blocksize)
    assert err_dbfs(out, ref) <= -80, err_dbfs(out, ref)


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_streaming_vs_jax_and_oracle(etype, _case, params, signal):
    _check(etype, params, signal(STREAM_FRAMES), N, fast=False)


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_file_mode_vs_jax_and_oracle(etype, _case, params, signal):
    """File mode: ``process_file`` over the whole signal (the flanger's
    line solve, once; the chorus reads the whole file through K3)."""
    _check(etype, params, signal(FILE_FRAMES), 4096, fast=True)


def _render(etype, params, x, blocksize, fast=False):
    chain, state, tmap = build_chain(_cfg(etype, params), FS, blocksize, channels_in=2,
                                     device="cpu")
    return chain.process_array(state, chain.targets(tmap), x, fast=fast)[1]


# The JAX package's blocking-invariance properties (test_effects_parity.py,
# test_fastpath.py): the flanger, ring mod and bitcrusher bit for bit; the
# rest within -80 dBFS, except the chorus on noise, which the JAX package
# pins at -55 dBFS (an ulp of the float32 delay near the 50 ms reach moves a
# tap on white noise by ~1e-4 of full scale; on tones it holds -80).
INVARIANCE = {
    "tremolo": ({"rate_hz": 17.0, "depth": 0.8, "spread": 0.25}, bursts, -80),
    "chorus": ({"rate_hz": 4.0, "depth_ms": 9.0, "base_ms": 20.0, "mix": 1.0,
                "spread": 0.3}, lambda f: bursts(f, amp=0.3, seed=3), -55),
    "phaser": ({"rate_hz": 4.0, "min_hz": 80, "max_hz": 6000, "mix": 1.0,
                "spread": 0.25}, tones, -80),
    "wah": ({"rate_hz": 3.0, "min_hz": 200, "max_hz": 2000, "res": 5.0, "mix": 1.0,
             "mode": 0.5, "sens": 8.0, "env_ms": 20.0}, noise, -80),
    "ringmod": ({"carrier_hz": 4321.0, "mix": 0.8, "spread": 0.25}, bursts, None),
    "bitcrusher": ({"bits": 5.0, "rate_hz": 7351.0, "mix": 1.0}, bursts, None),
    "flanger": ({"rate_hz": 1.3, "depth_ms": 3.0, "base_ms": 2.0, "feedback": 0.8,
                 "mix": 0.7, "spread": 0.25}, noise, None),
}


@pytest.mark.parametrize("etype", TYPES)
def test_blocking_invariance(etype):
    """256-sample streaming against 4096-sample blocks (None: bitwise)."""
    params, signal, tol = INVARIANCE[etype]
    x = signal(8 * 4096)
    a = _render(etype, params, x, 256)
    b = _render(etype, params, x, 4096)
    if tol is None:
        assert np.array_equal(a, b)
    else:
        assert err_dbfs(a, b) <= tol, err_dbfs(a, b)


def test_chorus_blocking_invariance_on_tones():
    """On tonal program the chorus's 256-vs-4096 split holds -80 dBFS."""
    params = INVARIANCE["chorus"][0]
    x = tones(8 * 4096)
    a, b = _render("chorus", params, x, 256), _render("chorus", params, x, 4096)
    assert err_dbfs(a, b) <= -80, err_dbfs(a, b)


PASSTHROUGH = {
    "tremolo": {"rate_hz": 8.0, "depth": 0.0, "spread": 0.3},
    "chorus": {**_PRESET["chorus"], "mix": 0.0},
    "phaser": {**_PRESET["phaser"], "mix": 0.0},
    "wah": {**_PRESET["wah"], "mix": 0.0},
    "ringmod": {**_PRESET["ringmod"], "mix": 0.0},
    "bitcrusher": {**_PRESET["bitcrusher"], "mix": 0.0},
    "flanger": {**_PRESET["flanger"], "mix": 0.0},
}


@pytest.mark.parametrize("etype", TYPES)
def test_mix_zero_is_exact_passthrough(etype):
    x = bursts(8 * N)
    for blocksize, fast in ((N, False), (4096, True)):
        assert np.array_equal(_render(etype, PASSTHROUGH[etype], x, blocksize, fast), x)


@pytest.mark.parametrize("etype", TYPES)
def test_jax_stream_continues_in_the_port(etype):
    """k blocks in JAX, the state handed over as numpy (uint32 ``acc``
    included), the rest in the port: against JAX continuing, output and
    every state leaf (<= -90 dBFS; integer leaves exactly)."""
    params, signal = next((p, sig) for t, _, p, sig in CASES if t == etype)
    x = signal(24 * N)
    k = 10
    cfg = _cfg(etype, params)
    jchain, jstate, jtmap = jax_build(cfg, FS, N, channels_in=2)
    jtargets = jchain.targets(jtmap)
    jst, _ = jchain.process_array(jstate, jtargets, x[: k * N])
    handoff = jax.tree.map(np.asarray, jst)
    jst2, ref = jchain.process_array(jax.tree.map(jnp.asarray, handoff), jtargets, x[k * N:])

    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")
    carried = state_from_numpy(handoff, "cpu")
    assert state_to_numpy(carried).keys() == handoff.keys()
    st, got = chain.process_array(carried, chain.targets(tmap), x[k * N:])
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst2))


@pytest.mark.parametrize("etype", ["ringmod", "bitcrusher"])
def test_u32_accumulator_crosses_packages_bitwise(etype):
    """The phase accumulator is uint32 in both packages: a JAX value near
    the wrap goes into the port and back unchanged, and both advance it to
    the same bits over blocks that wrap it."""
    params = next(p for t, _, p, _ in CASES if t == etype)
    cfg = _cfg(etype, params)
    jchain, jstate, jtmap = jax_build(cfg, FS, N, channels_in=2)
    handoff = jax.tree.map(np.asarray, jstate)
    handoff["fx"][0]["acc"] = np.uint32(2**32 - 12345)
    back = state_to_numpy(state_from_numpy(handoff, "cpu"))
    assert back["fx"][0]["acc"].dtype == np.uint32
    assert back["fx"][0]["acc"] == handoff["fx"][0]["acc"]

    x = bursts(6 * N)
    jst, _ = jchain.process_array(jax.tree.map(jnp.asarray, handoff), jchain.targets(jtmap), x)
    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")
    st, _ = chain.process_array(state_from_numpy(handoff, "cpu"), chain.targets(tmap), x)
    got, ref = state_to_numpy(st)["fx"][0]["acc"], np.asarray(jst["fx"][0]["acc"])
    assert got.dtype == ref.dtype == np.uint32 and got == ref
    assert int(got) < int(handoff["fx"][0]["acc"])  # it wrapped


def test_u32_phase_ramp_matches_jax_bitwise():
    """The int64-masked ramp equals JAX's uint32 arithmetic bit for bit, and
    the float32 phase rounds as XLA's uint32 -> float32 does."""
    from aefs_tpu.models.ringmod import phase_ramp_cycles as jax_ramp
    from aefs_tpu.models.ringmod import phase_step_u32 as jax_step
    from aefs_tpu_torch.models.ringmod import phase_ramp_cycles, phase_step_u32

    for freq in (0.5, 55.0, 440.0, 4321.0, 11025.0, 48000.0):
        for fs in (22050, 44100, 48000):
            num = phase_step_u32(torch.tensor(freq), fs)
            jnum = jax_step(jnp.float32(freq), fs)
            assert int(num) == int(jnum), (freq, fs)
            for acc in (0, 2**31 + 7, 2**32 - 1):
                got = phase_ramp_cycles(torch.tensor(acc, dtype=torch.uint32), num, 4096)
                ref = np.asarray(jax_ramp(jnp.uint32(acc), jnum, 4096))
                assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_mat2_affine_hillis_matches_jax():
    from aefs_tpu.ops.scan import mat2_affine_hillis as jax_mat2
    from aefs_tpu_torch.ops.scan import mat2_affine_hillis

    rng = np.random.default_rng(4)
    f = rng.uniform(0.05, 0.6, 1000).astype(np.float32)
    x = (0.3 * rng.standard_normal((2, 1000))).astype(np.float32)
    ms = (1.0 - f * f - f * 0.3).astype(np.float32)
    args = (np.ones((1, 1000), np.float32), f[None], -f[None], ms[None],
            np.zeros_like(x), (f[None] * x).astype(np.float32))
    inits = (np.array([[0.1], [-0.2]], np.float32), np.array([[0.05], [0.0]], np.float32))
    got = mat2_affine_hillis(*(torch.from_numpy(a) for a in args + inits))
    ref = jax_mat2(*(jnp.asarray(a) for a in args + inits))
    for g, r in zip(got, ref):
        assert err_dbfs(g.numpy(), r) <= -110, err_dbfs(g.numpy(), r)


@pytest.mark.parametrize("etype", TYPES)
def test_modulation_type_is_ported(etype):
    from aefs_tpu_torch.models import EFFECT_REGISTRY

    assert etype in EFFECT_REGISTRY
    chain, _, _ = build_chain(_cfg(etype, {}), FS, N, device="cpu")
    assert chain.effects[0][1].kind == etype


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_file_mode_file_axis(etype, _case, params, signal):
    """``process_file`` over three files on a leading file axis: each file
    bit-equal to its own single-file call (the flanger's line solve once
    for all files, the chorus's K3 slot grid with S = F)."""
    from test_torch_batch import file_axis_vs_per_file

    file_axis_vs_per_file(_cfg(etype, params), frames=2 * 4096)
