"""The dynamics slice of the PyTorch port (the semiring scans of
``ops/scan.py``, compressor, limiter, stereo width, waveshaper) against
the JAX package and the float64 oracles.

Per effect, at its preset's params and at cases of the JAX package's own
parity tests: 256-sample streaming through ``process`` and file mode
through ``process_file`` against JAX (<= -90 dBFS on the output, final
state trees compared leaf by leaf by path) and against the oracle
(<= -80 dBFS); blocking invariance; a JAX stream continued in the port.
The scans against JAX on short and long inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.ops import scan as jscan
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from aefs_tpu_torch.ops import scan as tscan

from helpers import bursts, tones
from oracles import (
    OracleCompressor,
    OracleLimiter,
    OracleStereoWidth,
    OracleWaveshaper,
    err_dbfs,
    run_oracle_blocks,
)
from test_torch_models import assert_states_close, run_both

FS = 48000
N = 256
STREAM_FRAMES = 40 * N
FILE_FRAMES = 6 * 4096

_PRESET = {c["effect_id"]: c["params"] for name in ("Glue Bus", "Master Bus", "Crunch")
           for c in DEFAULT_PRESETS[name]}

# (type, case, params, signal): each effect at a preset and at the cases of
# tests/test_effects_parity.py, on the signal that test uses.
CASES = [
    ("compressor", "glue-bus", _PRESET["cp1"], bursts),
    ("compressor", "hard-knee", {"threshold_db": -40, "ratio": 20, "attack_ms": 0.1,
                                 "release_ms": 10, "knee_db": 0, "makeup_db": 6}, bursts),
    ("compressor", "slow", {"threshold_db": -12, "ratio": 1.5, "attack_ms": 200,
                            "release_ms": 800, "knee_db": 24, "makeup_db": -6}, bursts),
    ("limiter", "master-bus", _PRESET["mb3"], bursts),
    ("limiter", "slammed", {"ceiling_db": -1.0, "release_ms": 10.0, "drive_db": 24.0,
                            "lookahead_ms": 1.0}, bursts),
    ("limiter", "slow", {"ceiling_db": -12.0, "release_ms": 1000.0, "drive_db": 0.0,
                         "lookahead_ms": 10.0}, bursts),
    ("stereowidth", "master-bus", _PRESET["mb2"], bursts),
    ("stereowidth", "mono-left", {"width": 0.0, "pan": -0.6}, bursts),
    ("stereowidth", "wide-right", {"width": 2.0, "pan": 1.0}, bursts),
    ("waveshaper", "crunch", _PRESET["w1"], lambda f: tones(f, amp=0.4)),
    ("waveshaper", "hard", {"drive": 20.0, "shape": 0, "mix": 0.8, "out_gain": 1.0},
     lambda f: tones(f, amp=0.4)),
    ("waveshaper", "soft", {"drive": 4.0, "shape": 2, "mix": 1.0, "out_gain": 1.0},
     lambda f: tones(f, amp=0.4)),
]
IDS = [f"{t}-{c}" for t, c, _, _ in CASES]
TYPES = ["compressor", "limiter", "stereowidth", "waveshaper"]


def _oracle(etype, params):
    if etype == "compressor":
        return OracleCompressor(FS, **params)
    if etype == "limiter":
        return OracleLimiter(FS, **params)
    if etype == "stereowidth":
        return OracleStereoWidth(FS, **params)
    return OracleWaveshaper(**params)


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
    ref = run_oracle_blocks(_oracle(etype, params), x.astype(np.float64), N)
    assert err_dbfs(out, ref) <= -80, err_dbfs(out, ref)
    return out


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_streaming_vs_jax_and_oracle(etype, _case, params, signal):
    _check(etype, params, signal(STREAM_FRAMES), N, fast=False)


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_file_mode_vs_jax_and_oracle(etype, _case, params, signal):
    """File mode: one ``process_file`` over the whole signal (the
    compressor's two-level ``*_scan_long`` scans)."""
    out = _check(etype, params, signal(FILE_FRAMES), 4096, fast=True)
    if etype == "limiter":  # the brickwall holds to float32 rounding
        assert np.max(np.abs(out)) <= 10.0 ** (params["ceiling_db"] / 20.0) + 1e-6


def _render(etype, params, x, blocksize):
    chain, state, tmap = build_chain(_cfg(etype, params), FS, blocksize, channels_in=2,
                                     device="cpu")
    return chain.process_array(state, chain.targets(tmap), x)[1]


@pytest.mark.parametrize("etype", TYPES)
def test_blocking_invariance(etype):
    """256-sample streaming against 4096-sample blocks: the compressor
    switches from ``*_hillis`` to ``*_scan_long`` (a reassociation), the
    others run the same arithmetic at any block size."""
    params, signal = next((p, sig) for t, _, p, sig in CASES if t == etype)
    x = signal(6 * 4096)
    a, b = _render(etype, params, x, 256), _render(etype, params, x, 4096)
    assert err_dbfs(a, b) <= -110, err_dbfs(a, b)


def test_stereowidth_unity_is_near_passthrough():
    x = bursts(2 * N)
    got = _render("stereowidth", {"width": 1.0, "pan": 0.0}, x, N)
    np.testing.assert_allclose(got, x, atol=1e-7)


def test_limiter_under_ceiling_is_transparent():
    """A signal under the ceiling passes at unity gain, delayed by the
    look-ahead (W - 1 samples)."""
    x = bursts(STREAM_FRAMES) * 0.1
    got = _render("limiter", {"ceiling_db": 0.0, "release_ms": 80.0, "drive_db": 0.0,
                              "lookahead_ms": 5.0}, x, N)
    d = int(round(5.0 * FS / 1000.0))
    np.testing.assert_allclose(got[d:], x[: len(x) - d], atol=2e-7)


@pytest.mark.parametrize("etype", ["compressor", "limiter"])
def test_jax_stream_continues_in_the_port(etype):
    """k blocks in JAX, the state handed over as numpy, the rest in the
    port: against JAX continuing, output and every state leaf."""
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
    st, got = chain.process_array(state_from_numpy(handoff, "cpu"), chain.targets(tmap),
                                  x[k * N:])
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst2))


# --- the scans ---------------------------------------------------------------

def _pair(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def test_maxtimes_hillis_matches_jax():
    """The peak-decay scan over a (2, 256) batch."""
    rng = np.random.default_rng(1)
    mult = rng.uniform(0.99, 1.0, (2, N)).astype(np.float32)
    add = np.abs(rng.standard_normal((2, N))).astype(np.float32)
    init = np.array([[0.3], [0.0]], np.float32)
    (tm, ta, ti), (jm, ja, ji) = _pair(mult, add, init)
    got = tscan.maxtimes_hillis(tm, ta, ti).numpy()
    assert err_dbfs(got, jax.jit(jscan.maxtimes_hillis)(jm, ja, ji)) <= -120


def test_maxtimes_scan_long_matches_jax():
    """The two-level form at a file length, sparse peaks decaying."""
    rng = np.random.default_rng(1)
    n = 20_000
    mult = np.full(n, 0.9995, np.float32)
    add = (np.abs(rng.standard_normal(n)) * (rng.uniform(size=n) < 0.01)).astype(np.float32)
    (tm, ta), (jm, ja) = _pair(mult, add)
    got = tscan.maxtimes_scan_long(tm, ta, torch.tensor(0.5)).numpy()
    ref = jax.jit(jscan.maxtimes_scan_long)(jm, ja, jnp.float32(0.5))
    assert err_dbfs(got, ref) <= -120, err_dbfs(got, ref)


def _minaffine_f64(a, b, cap, init):
    y, out = float(init), np.empty(len(a))
    for i in range(len(a)):
        y = min(float(cap[i]), float(a[i]) * y + float(b[i]))
        out[i] = y
    return out


@pytest.mark.parametrize("n", [256, 20_000])
def test_minaffine_hillis_matches_jax(n):
    """The capped release against JAX and a float64 loop.  At file lengths
    the span products underflow: JAX's +inf identity cap then gives
    0 * inf = NaN from that position on, the port's finite cap stays
    exact, so JAX is compared where it is finite."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.9, 1.0, n).astype(np.float32)
    cap = rng.uniform(0.2, 1.0, n).astype(np.float32)
    b = ((1.0 - a) * cap).astype(np.float32)
    (ta, tb, tc), (ja, jb, jc) = _pair(a, b, cap)
    got = tscan.minaffine_hillis(ta, tb, tc, torch.tensor(0.7)).numpy()
    ref = np.asarray(jax.jit(jscan.minaffine_hillis)(ja, jb, jc, jnp.float32(0.7)))
    finite = np.isfinite(ref)
    assert finite[:1024].all() and (n < 8192 or not finite.all())
    assert err_dbfs(got[finite], ref[finite]) <= -120, err_dbfs(got[finite], ref[finite])
    assert err_dbfs(got, _minaffine_f64(a, b, cap, 0.7)) <= -120


def test_limiter_file_render_finite_at_file_length():
    """The whole-signal limiter on 2^17 samples (its release products
    underflow past ~49k samples at 10 ms) equals the 4096-superblock render
    and is finite."""
    params = {"ceiling_db": -1.0, "release_ms": 10.0, "drive_db": 6.0, "lookahead_ms": 5.0}
    x = bursts(2 ** 17, amp=0.5)
    cfg = _cfg("limiter", params)
    chain, state, tmap = build_chain(cfg, FS, 4096, channels_in=2, device="cpu")
    _, fast = chain.process_array(state, chain.targets(tmap), x, fast=True)
    _, blocks = chain.process_array(chain.init_state(), chain.targets(tmap), x)
    assert np.all(np.isfinite(fast))
    assert err_dbfs(fast, blocks) <= -110, err_dbfs(fast, blocks)


@pytest.mark.parametrize("w", [1, 2, 5, 241, 481])
@pytest.mark.parametrize("n", [256, 50_000])
def test_window_scans_match_jax_bitwise(w, n):
    """Trailing-window min and disjoint-chunk sum: the same operations in
    the same order as JAX, so bit for bit."""
    rng = np.random.default_rng(3)
    ext = rng.uniform(0.0, 1.0, (1, w - 1 + n)).astype(np.float32)
    (t,), (j,) = _pair(ext)
    jmin = jax.jit(jscan.window_min_trailing, static_argnums=(1, 2))
    jsum = jax.jit(jscan.window_sum_trailing, static_argnums=(1, 2))
    assert np.array_equal(tscan.window_min_trailing(t, w, n).numpy(), np.asarray(jmin(j, w, n)))
    got = tscan.window_sum_trailing(t, w, n).numpy()
    assert np.array_equal(got, np.asarray(jsum(j, w, n)))
    ref = np.stack([ext[0, i: i + w].astype(np.float64).sum() for i in range(n)])
    assert np.max(np.abs(got[0] - ref)) <= 1e-6 * w


@pytest.mark.parametrize("etype,_case,params,signal", CASES, ids=IDS)
def test_file_mode_file_axis(etype, _case, params, signal):
    """``process_file`` over three files on a leading file axis: each file
    bit-equal to its own single-file call (the compressor's long scans
    take the file axis)."""
    from test_torch_batch import file_axis_vs_per_file

    file_axis_vs_per_file(_cfg(etype, params))


@pytest.mark.parametrize("scan", ["affine_scan_long", "maxtimes_scan_long"])
@pytest.mark.parametrize("n", [300, 20_000])
def test_long_scans_file_axis_bitwise(scan, n):
    """Three streams on a leading axis, each with its own init: bit-equal
    to one call per stream (the same operations per element)."""
    rng = np.random.default_rng(7)
    mult = torch.from_numpy(rng.uniform(0.5, 1.0, (3, n)).astype(np.float32))
    add = torch.from_numpy(np.abs(rng.standard_normal((3, n))).astype(np.float32))
    init = torch.tensor([0.1, 0.4, 0.0])
    fn = getattr(tscan, scan)
    got = fn(mult, add, init[:, None])
    assert got.shape == (3, n)
    for f in range(3):
        assert torch.equal(got[f], fn(mult[f], add[f], init[f])), f


@pytest.mark.parametrize("lag,n", [(1411, 9000), (1411, 400_000), (37, 50_000)],
                         ids=["horner-rows", "toeplitz-chunks", "short-lag"])
def test_lag_affine_scan_file_axis_bitwise(lag, n):
    """The residue-class scan over three files on a leading axis: bit-equal
    to one call per file, and to JAX's within -120 dBFS."""
    rng = np.random.default_rng(8)
    base = (0.3 * rng.standard_normal((3, n))).astype(np.float32)
    got = tscan.lag_affine_scan(torch.from_numpy(base), 0.6, lag)
    for f in range(3):
        one = tscan.lag_affine_scan(torch.from_numpy(base[f]), 0.6, lag)
        assert torch.equal(got[f], one), f
    ref = jax.jit(jscan.lag_affine_scan, static_argnums=2)(jnp.asarray(base[0]), 0.6, lag)
    assert err_dbfs(got[0].numpy(), ref) <= -120, err_dbfs(got[0].numpy(), ref)


@pytest.mark.parametrize("etype", ["gate", "compressor"])
def test_whole_files_take_the_long_scans(monkeypatch, etype):
    """A whole file reaches the two-level scans with or without a file
    axis (the branch depends on length alone); a 256-sample pool step
    keeps the full-length Hillis."""
    import importlib

    mod = importlib.import_module(f"aefs_tpu_torch.models.{etype}")
    shapes, real = [], mod.affine_scan_long

    def spy(mult, add, init, *a):
        shapes.append(tuple(add.shape))
        return real(mult, add, init, *a)

    monkeypatch.setattr(mod, "affine_scan_long", spy)
    chain, one, tmap = build_chain([{"effect_id": "e", "type": etype, "params": {}}], FS, 4096,
                                   channels_in=2, device="cpu")
    targets = chain.targets(tmap)
    x = torch.from_numpy(bursts(8192).T.copy())
    chain.process_whole(chain.init_state(), targets, x)
    batched = {"fx": chain.batch_state(one, 3)["fx"], "params": one["params"]}
    chain.process_whole(batched, targets, x.expand(3, 2, 8192))
    chain.process_block(chain.batch_state(one, 3), targets,
                        x[:, :N].expand(3, 2, N).contiguous())
    assert shapes == [(8192,), (3, 8192)]
