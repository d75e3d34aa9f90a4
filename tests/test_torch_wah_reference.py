"""The benchmark's plain float64 wah (``benchmark/reference/wah.py``)
against the port: the whole-file pass (``Wah.process_file``, one file and
a batch of three) and the 256-sample streaming step agree with it in the
LFO, envelope and blended sweeps, at low and high resonance and at 16 kHz,
where the stability clamp acts; ``mix`` 0 passes the input through
exactly; a reference rounded to bfloat16 does not agree.  ``process`` is
the one-function step op for op; the whole-file spans and counters, once
per render, none while the tracer is off."""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.engine.engine import process_offline, render_batch
from aefs_tpu_torch.models.base import lead
from aefs_tpu_torch.models.lfo import TWO_PI, f64, fs_tensor, lfo_advance, lfo_ramp
from aefs_tpu_torch.models.wah import Wah
from aefs_tpu_torch.ops.scan import affine_hillis, mat2_affine_hillis
from aefs_tpu_torch.utils.metrics import TRACER
from benchmark.audio import rain_scene
from benchmark.refchain import render_mono, run_chain

from helpers import noise
from oracles import err_dbfs

FS = 48000
FUNKY = DEFAULT_PRESETS["Funky Talk"][0]["params"]
CASES = {
    "funky": FUNKY,
    "lfo": {"mode": 0.0, "res": 3.0, "rate_hz": 4.0},
    "blend-high-q": {"mode": 0.5, "res": 8.0, "sens": 6.0, "rate_hz": 2.0},
    "low-q": {"mode": 1.0, "res": 0.5, "sens": 12.0, "env_ms": 10.0, "mix": 0.7},
}
# The port runs the sweep and the filter in float32 (f and the pole from
# float64 rounded once), the reference in float64 throughout.  The 2x2
# scan alone, given the reference's f, reads ~-148 dBFS; the envelope's
# float32 one-pole scan holds env to ~2e-5 of its peak, which the sweep
# (sens 8, exponential in env) and Q 4 carry into the band: "Funky Talk"'s
# sweep reads -92.5 to -96.6 dBFS here, the LFO, blended and low-Q sweeps
# -107 to -140.  -85 leaves 7.5 dB of room; the reference with every
# output rounded to bfloat16 (an ulp of 2^-8) reads -47 to -71.
PORT_DBFS = -85.0


def _wah(params):
    return [{"effect_id": "w", "type": "wah", "params": params}]


def _rain(seconds=1.0, seed=11):
    return rain_scene(seconds, FS, seed)


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


def _stereo(cfg, x, fs=FS, fast=True):
    """(frames, 2) through a two-channel chain: one whole-file pass
    (``fast``) or 256-sample streaming blocks."""
    chain, state, tmap = build_chain(cfg, fs, 256, channels_in=2, device="cpu")
    return chain.process_array(state, chain.targets(tmap), x, fast=fast)[1]


def _mono_reference(x, cfg, fs=FS):
    """(frames, 2) as the engine takes it -> the reference's (frames, 2)
    of its mono mix, clipped as the engine clips."""
    return np.clip(render_mono(x.astype(np.float64).mean(axis=1), cfg, fs), -1.0, 1.0).T


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fast", [True, False], ids=["file", "stream"])
def test_the_port_matches_the_reference_on_noise(case, fast):
    cfg = _wah(CASES[case])
    x = noise(FS // 2 + 77, seed=3)
    assert err_dbfs(_stereo(cfg, x, fast=fast), run_chain(x.T, cfg, FS).T) <= PORT_DBFS


@pytest.mark.parametrize("case", sorted(CASES))
def test_an_upload_of_rain_matches_the_reference(case):
    """The engine's file path (mono downmix, the superblock's padding,
    ``Wah.process_file``) on a second of the benchmark's rain."""
    cfg = _wah(CASES[case])
    x = _rain()
    _mono, got = process_offline(cfg, x, FS, device="cpu")
    assert err_dbfs(got, _mono_reference(x, cfg)) <= PORT_DBFS


@pytest.mark.parametrize("fast", [True, False], ids=["file", "stream"])
def test_the_stability_clamp_at_16k_matches_the_reference(fast):
    """At 16 kHz and Q = 0.5 the clamp's bound, 0.95 (sqrt(8) - 2) =
    0.787, lies inside the sweep: 2 sin(pi fc / fs) runs from 0.39 at 1
    kHz to 1.41 at 4 kHz, so the clamp holds f over the top of every
    cycle."""
    p = {"mode": 0.0, "res": 0.5, "min_hz": 1000.0, "max_hz": 4000.0, "rate_hz": 3.0}
    q1 = 1.0 / p["res"]
    assert 2.0 * math.sin(math.pi * 4000.0 / 16000) > 0.95 * (math.sqrt(q1 * q1 + 4) - q1)
    cfg = _wah(p)
    x = noise(16000, seed=4)
    assert err_dbfs(_stereo(cfg, x, fs=16000, fast=fast),
                    run_chain(x.T, cfg, 16000).T) <= PORT_DBFS


def test_a_batch_of_three_files_matches_the_reference():
    files = [_rain(0.6, seed=5), noise(20000, seed=6), _rain(0.3, seed=7)]
    cfg = DEFAULT_PRESETS["Funky Talk"]
    outs = render_batch(cfg, files, FS, device="cpu")
    for x, got in zip(files, outs):
        assert got.shape == x.shape
        assert err_dbfs(got, _mono_reference(x, cfg)) <= PORT_DBFS


@pytest.mark.parametrize("fast", [True, False], ids=["file", "stream"])
def test_mix_zero_passes_the_input_through(fast):
    x = noise(9000, seed=8)
    got = _stereo(_wah({**FUNKY, "mix": 0.0}), x, fast=fast)
    assert np.array_equal(got, x)
    assert np.array_equal(run_chain(x.T, _wah({**FUNKY, "mix": 0.0}), FS), x.T)


@pytest.mark.parametrize("case", ["funky", "blend-high-q"])
def test_a_bfloat16_reference_fails_the_tolerance(case):
    cfg = _wah(CASES[case])
    x = noise(FS // 2, seed=9)
    want = run_chain(x.T, cfg, FS)
    assert err_dbfs(run_chain(x.T, cfg, FS, "bfloat16"), want) > PORT_DBFS + 15


# -- the one-function step, op for op ---------------------------------------------

def _one_function_process(self, state, p, x):
    """The wah's block step written as one function: what ``operands``
    followed by ``solve`` must match op for op and bit for bit."""
    n = x.shape[-1]
    fs = fs_tensor(self.fs, x.device)
    dph = p["rate_hz"] / fs
    ph = lfo_ramp(state["ph_hi"], state["ph_lo"], dph, n)
    lfo_sweep = 0.5 * (1.0 + f64(torch.sin, TWO_PI * ph))

    mono = torch.mean(torch.abs(x), -2)
    a_e = lead(f64(torch.exp, torch.full((), -1000.0, device=x.device)
                   / (p["env_ms"] * fs)))
    env = affine_hillis(a_e, (1.0 - a_e) * mono, lead(state["env"]))
    env_sweep = torch.clamp(lead(p["sens"]) * env, 0.0, 1.0)

    sweep = lead(1.0 - p["mode"]) * lfo_sweep + lead(p["mode"]) * env_sweep
    lo_hz = lead(torch.minimum(p["min_hz"], p["max_hz"]))
    hi_hz = lead(torch.maximum(p["min_hz"], p["max_hz"]))
    fc = lo_hz * f64(torch.pow, hi_hz / lo_hz, sweep)
    q1 = torch.ones((), device=x.device) / p["res"]
    f = 2.0 * f64(torch.sin, math.pi * fc / fs)
    f = torch.minimum(f, lead(0.95 * (torch.sqrt(q1 * q1 + 4.0) - q1)))
    fr = f[..., None, :]

    low, band = mat2_affine_hillis(
        torch.ones((1, n), device=x.device), fr, -fr,
        (1.0 - f * f - f * lead(q1))[..., None, :], torch.zeros_like(x), fr * x,
        state["low"][..., None], state["band"][..., None])

    mix = lead(p["mix"], 2)
    y = (1.0 - mix) * x + mix * (lead(q1, 2) * band)
    hi, lo = lfo_advance(state["ph_hi"], state["ph_lo"], dph, n)
    return {"low": low[..., -1], "band": band[..., -1], "env": env[..., -1],
            "ph_hi": hi, "ph_lo": lo}, y


class _Ops(TorchDispatchMode):
    """The aten ops a call dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _model(slots=None):
    model = Wah(FS, 256, channels=2, device="cpu")
    state = model.init_state()
    p = {k: torch.tensor(v, dtype=torch.float32) for k, v in
         {**{k: s.default for k, s in Wah.PARAMS.items()}, **FUNKY, "mode": 0.6}.items()}
    if slots:
        state = {k: torch.stack([v] * slots) for k, v in state.items()}
        p = {k: torch.stack([v + 0.01 * i for i in range(slots)]) for k, v in p.items()}
    return model, state, p


@pytest.mark.parametrize("slots", [None, 3], ids=["one", "slots"])
def test_process_is_the_one_function_step_op_for_op(slots):
    """Eight 256-sample blocks carried from block to block: the same aten
    ops in the same order (so a captured step holds the same kernels) and
    the same bits, state and output."""
    model, state, p = _model(slots)
    rng = np.random.default_rng(20251018)
    ref_state = dict(state)
    for _ in range(8):
        shape = ((slots,) if slots else ()) + (2, 256)
        x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32))
        with _Ops() as new:
            state, y = model.process(state, p, x)
        with _Ops() as old:
            ref_state, y_old = _one_function_process(model, ref_state, p, x)
        assert new.ops == old.ops
        assert torch.equal(y, y_old)
        assert all(torch.equal(state[k], ref_state[k]) for k in state)


def test_process_file_is_the_one_function_step_bit_for_bit():
    model, state, p = _model()
    x = torch.from_numpy(_rain(0.5, seed=13).T.copy())
    st, y = model.process_file(state, p, x)
    st_old, y_old = _one_function_process(model, state, p, x)
    assert torch.equal(y, y_old) and all(torch.equal(st[k], st_old[k]) for k in st)


# -- the spans and counters ------------------------------------------------------

SPANS = ("wah.operands", "wah.solve")


def test_a_file_render_spans_and_counts_once(tracer):
    x = _rain(0.5)
    process_offline(DEFAULT_PRESETS["Funky Talk"], x, FS, device="cpu")
    ex = tracer.export()
    assert {n: len(ex["spans"].get(n, ())) for n in SPANS} == dict.fromkeys(SPANS, 1)
    assert {r for n in SPANS for r, _s, _e in ex["spans"][n]} == {None}
    (_r, f0, f1), _delay = sorted(ex["spans"]["chain.file_effect"], key=lambda s: s[0])
    (o0, o1), (s0, s1) = (ex["spans"][n][0][1:] for n in SPANS)
    assert f0 <= o0 <= o1 <= s0 <= s1 <= f1  # inside the wah's pass, in order
    # 24,000 frames padded to 6 superblocks of 4,096: ceil(log2 24,576) = 15
    assert ex["counters"]["wah.file_renders"] == 1
    assert ex["counters"]["wah.scan_levels"] == 15


def test_the_demo_length_runs_twenty_levels(tracer):
    model, state, p = _model()
    model.process_file(state, p, torch.zeros(2, 892928))
    assert tracer.export()["counters"] == {"wah.file_renders": 1, "wah.scan_levels": 20}


@pytest.mark.parametrize("n", [1, 2, 1000, 1024, 1025, 4096])
def test_the_levels_are_ceil_log2_n(tracer, n):
    model, state, p = _model()
    model.process_file(state, p, torch.zeros(2, n))
    assert tracer.export()["counters"]["wah.scan_levels"] == math.ceil(math.log2(n))


def test_a_batch_counts_its_files_and_spans_once(tracer):
    render_batch(_wah(FUNKY), [noise(5000), noise(3000, seed=2), noise(4000, seed=3)], FS,
                 device="cpu")
    ex = tracer.export()
    assert {n: len(ex["spans"][n]) for n in SPANS} == dict.fromkeys(SPANS, 1)
    assert ex["counters"]["wah.file_renders"] == 3
    assert ex["counters"]["wah.scan_levels"] == 13  # 3 files padded to 8,192


def test_a_streaming_block_keeps_no_wah_span(tracer):
    chain, state, tmap = build_chain(_wah(FUNKY), FS, 256, device="cpu")
    chain.process_block(state, chain.targets(tmap), torch.zeros(1, 256))
    assert tracer.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": tracer.offset_ns}}


def test_off_records_nothing_and_renders_the_same_bytes(tracer):
    x = _rain(0.5, seed=17)
    cfg = DEFAULT_PRESETS["Funky Talk"]
    on = process_offline(cfg, x, FS, device="cpu")[1]
    tracer.disable()
    tracer.reset()
    off = process_offline(cfg, x, FS, device="cpu")[1]
    assert tracer.export() == {"spans": {}, "counters": {}, "dropped": {},
                               "clock": {"trace_offset_ns": tracer.offset_ns}}
    assert on.tobytes() == off.tobytes()
