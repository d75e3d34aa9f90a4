"""The five ported effect models against the JAX package and the float64
oracles, one effect per chain, at the flagship chain's and the "Rain
Delay" / "Robot Voice" presets' params.

Streaming: 256-sample blocks through ``process``.  File mode: a ~1 s
signal through ``process_file`` with the file-mode statics baked, as the
engine renders files.  The port is compared with JAX on the output and on
every leaf of the final state (<= -90 dBFS; integer leaves exactly), and
with the float64 oracle on the output (<= -80 dBFS)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.core.fileopts import file_static_overrides as jax_file_statics
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import state_to_numpy
from aefs_tpu_torch.core.fileopts import file_static_overrides
from __graft_entry__ import FLAGSHIP

from helpers import bursts, noise, tones
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
STREAM_FRAMES = 80 * N  # 0.43 s: reaches the 375 ms echo
FILE_FRAMES = 12 * 4096  # ~1 s

_FLAG = {c["type"]: c["params"] for c in FLAGSHIP}
_RAIN = {c["type"]: c["params"] for c in DEFAULT_PRESETS["Rain Delay"]}
_ROBOT = {c["type"]: c["params"] for c in DEFAULT_PRESETS["Robot Voice"]}

ORACLES = {
    "gate": (OracleGate, bursts),
    "octaver": (OracleOctaver, tones),
    "filter": (OracleBiquad, tones),
    "delay": (OracleStereoDelay, noise),
    "reverb": (OracleReverb, noise),
}

CASES = [
    ("gate", "flagship", _FLAG["gate"]),
    ("gate", "robot", _ROBOT["gate"]),
    ("octaver", "flagship", _FLAG["octaver"]),
    ("octaver", "robot", _ROBOT["octaver"]),
    ("filter", "flagship", _FLAG["filter"]),
    ("delay", "flagship", _FLAG["delay"]),
    ("delay", "rain", _RAIN["delay"]),
    ("delay", "robot", _ROBOT["delay"]),
    ("reverb", "flagship", _FLAG["reverb"]),
    ("reverb", "rain", _RAIN["reverb"]),
]
IDS = [f"{t}-{p}" for t, p, _ in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _signal(etype, frames):
    gen = ORACLES[etype][1]
    return gen(frames, amp=0.2) if etype == "reverb" else gen(frames)


def _leaves(tree, path=()):
    """{path: leaf} of a dict/tuple tree (dict keys by name: jax.tree.map
    returns dicts in sorted-key order)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], path + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, t in enumerate(tree) for p, v in _leaves(t, path + (i,)).items()}
    return {path: np.asarray(tree)}


def assert_states_close(got, ref):
    """Same tree, shapes and dtypes; float leaves <= -90 dBFS, int exact."""
    g, r = _leaves(got), _leaves(ref)
    assert g.keys() == r.keys()
    for path, a in g.items():
        b = r[path]
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), path
        else:
            assert err_dbfs(a, b) <= -90, (path, err_dbfs(a, b))


def run_both(cfg, x, blocksize, fast, fs=FS):
    """One config through both packages: (port out, port state, jax out,
    jax state), states as numpy trees."""
    statics = file_static_overrides(cfg) if fast else None
    chain, state, tmap = build_chain(cfg, fs, blocksize, channels_in=x.shape[1],
                                     static_overrides=statics, device="cpu")
    st, out = chain.process_array(state, chain.targets(tmap), x, fast=fast)
    jstatics = jax_file_statics(cfg) if fast else None
    jchain, jstate, jtmap = jax_build(cfg, fs, blocksize, channels_in=x.shape[1],
                                      static_overrides=jstatics)
    jst, jout = jchain.process_array(jstate, jchain.targets(jtmap), x, fast=fast)
    return out, state_to_numpy(st), jout, jax.tree.map(np.asarray, jst)


@pytest.mark.parametrize("etype,_preset,params", CASES, ids=IDS)
def test_streaming_blocks(etype, _preset, params):
    cfg = [{"effect_id": "e", "type": etype, "params": params}]
    x = _signal(etype, STREAM_FRAMES)
    out, st, jout, jst = run_both(cfg, x, N, fast=False)
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)
    ref = run_oracle_blocks(ORACLES[etype][0](FS, **params), x.astype(np.float64), N)
    assert err_dbfs(out, ref) <= -80, err_dbfs(out, ref)


FILE_CASES = CASES + [("octaver", "plus7", {"semitones": 7, "mix": 0.5})]


@pytest.mark.parametrize("etype,_preset,params", FILE_CASES,
                         ids=IDS + ["octaver-plus7"])
def test_file_mode(etype, _preset, params):
    cfg = [{"effect_id": "e", "type": etype, "params": params}]
    x = _signal(etype, FILE_FRAMES)
    out, st, jout, jst = run_both(cfg, x, 4096, fast=True)
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)
    ref = run_oracle_blocks(ORACLES[etype][0](FS, **params), x.astype(np.float64), 4096)
    assert err_dbfs(out, ref) <= -80, err_dbfs(out, ref)


def _spy_two_tap_reads(monkeypatch):
    """Record the block length of every call the octaver makes to its block
    step (K1), which reads both taps."""
    import aefs_tpu_torch.models.octaver as octaver_mod

    calls, real = [], octaver_mod.octaver_step

    def spy(state, p, x):
        calls.append(x.shape[-1])
        return real(state, p, x)

    monkeypatch.setattr(octaver_mod, "octaver_step", spy)
    return calls


def test_octaver_plus7_file_mode_takes_the_two_tap_read(monkeypatch):
    """A non-octave ratio in file mode runs the block step K1 (both taps),
    once over the whole signal."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": 7, "mix": 0.5}}]
    chain, state, tmap = build_chain(cfg, FS, 4096, channels_in=2,
                                     static_overrides=file_static_overrides(cfg), device="cpu")
    assert chain.effects[0][1]._pow2_e is None
    calls = _spy_two_tap_reads(monkeypatch)
    chain.process_array(state, chain.targets(tmap), tones(FILE_FRAMES), fast=True)
    assert calls == [FILE_FRAMES]


@pytest.mark.parametrize("fs,blocksize,fast", [(16000, 4096, True), (48000, 200, False)],
                         ids=["16k-file-plus7", "48k-block200"])
def test_octaver_two_tap_read_off_the_tpu_tile_rule(monkeypatch, fs, blocksize, fast):
    """Geometries where the reference's TPU tile rule reads each tap with the
    plain gather (a 640-sample ring at 16 kHz; blocks that are no multiple
    of 128) still run the block step K1 in the port, and agree with JAX."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": 7, "mix": 0.5}}]
    x = tones(8 * blocksize if not fast else 3 * blocksize, fs=fs)
    calls = _spy_two_tap_reads(monkeypatch)
    out, st, jout, jst = run_both(cfg, x, blocksize, fast, fs=fs)
    assert calls == ([x.shape[0]] if fast else [blocksize] * 8)
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)


def test_remainder_matches_jnp_mod_bitwise():
    """The phase code's floored modulo: torch.remainder gives jnp.mod's
    results bit for bit on phase-like values, negatives and -0.0 included.
    (Subnormal inputs are left out: XLA's CPU backend reads them as zero,
    and no phase value comes within 2^-126 of zero without being zero.)"""
    rng = np.random.default_rng(11)
    vals = np.concatenate([
        rng.uniform(-3.0, 3.0, 4096), rng.uniform(-1e-7, 1e-7, 256),
        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1 - 2**-24, -(1 - 2**-24), 2**-126, -2**-126],
    ]).astype(np.float32)
    for m in (1.0, 0.5):
        ours = torch.remainder(torch.from_numpy(vals), m).numpy()
        ref = np.asarray(jnp.mod(jnp.asarray(vals), jnp.float32(m)))
        assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
    ints = np.arange(-5000, 5000, 7, dtype=np.int32)
    assert np.array_equal(torch.remainder(torch.from_numpy(ints), 1920).numpy(),
                          np.asarray(jnp.mod(jnp.asarray(ints), 1920)))


def test_grid_semitones_not_ported():
    """``grid_semitones`` in a chain config (once refused) now builds the
    exact-grid streaming octaver, as JAX's does: the integer-phase state
    and outputs within -90 dBFS of JAX's over 8 blocks
    (tests/test_torch_grid.py holds the path in full)."""
    cfg = [{"effect_id": "o", "type": "octaver", "params": {"semitones": -12},
            "grid_semitones": -12}]
    x = tones(8 * N, channels=1)
    out, st, jout, jst = run_both(cfg, x, N, fast=False)
    assert set(st["fx"][0]) == {"hist", "num"}
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)


def test_gridtaps_geometry_matches_jax():
    from aefs_tpu.ops import gridtaps as jg
    from aefs_tpu_torch.ops import gridtaps as tg

    for semi in (None, -24, -12, -7, 0, 4.5, 12, 24, 36):
        assert tg.pow2_exponent(semi) == jg.pow2_exponent(semi), semi
    for size in (1918, 1920, 1764, 441, 2048):
        for e in (-2, -1, 0, 1, 2):
            assert tg.pow2_geometry_ok(size, e) == jg.pow2_geometry_ok(size, e)
            for n in (128, 256, 4096):
                assert (tg.pow2_stream_geometry_ok(size, e, n)
                        == jg.pow2_stream_geometry_ok(size, e, n))


@pytest.mark.parametrize("etype,_preset,params", FILE_CASES, ids=IDS + ["octaver-plus7"])
def test_file_mode_file_axis(etype, _preset, params):
    """``process_file`` over three files on a leading file axis (a batched
    render): each file bit-equal to its own single-file call, output and
    state (the delay's ring and shared row, the reverb's K2 tail, the
    octaver's exact grid and, at +7, K1's slot grid)."""
    from test_torch_batch import file_axis_vs_per_file

    file_axis_vs_per_file([{"effect_id": "e", "type": etype, "params": params}])
