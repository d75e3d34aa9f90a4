"""The benchmark's plain float64 flanger (``benchmark/reference/flanger.py``)
against the per-sample oracle, the port's whole-file solve and its
256-sample streaming against that reference, and the tolerance against a
solve cut short."""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from benchmark.reference import flanger as ref

from helpers import noise, tones
from oracles import OracleFlanger, err_dbfs

FS = 48000
JET = DEFAULT_PRESETS["Jet Flanger"][0]["params"]
NEGATIVE = {"rate_hz": 2.0, "depth_ms": 4.0, "base_ms": 1.0, "feedback": -0.7, "mix": 1.0,
            "spread": 0.25}
# The port computes in float32: the delay's rounding (an ulp of 240
# samples is 1.5e-5) times a broadband signal's slope, recirculated with a
# loop gain of up to 1 / (1 - 0.7), about 10 dB; on noise it reads -93.
PORT_DBFS = -90.0
# Both in float64 with the same taps: only the order of the sums differs.
ORACLE_ABS = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference(params, x):
    """x (frames, 2) -> the reference's (frames, 2)."""
    return ref.apply(x.T.astype(np.float64), {**ref.DEFAULTS, **params}, FS).T


@pytest.mark.parametrize("params", [JET, NEGATIVE], ids=["jet", "negative"])
def test_reference_matches_the_oracle(params):
    x = tones(4096).astype(np.float64)
    want = OracleFlanger(FS, **params).process(x)
    assert np.max(np.abs(_reference(params, x) - want)) <= ORACLE_ABS


@pytest.mark.parametrize("signal", [tones, noise], ids=["tones", "noise"])
@pytest.mark.parametrize("blocksize, fast", [(4096, True), (256, False)],
                         ids=["process_file", "stream256"])
def test_port_matches_the_reference(signal, blocksize, fast):
    x = signal(6 * 4096)
    chain, state, tmap = build_chain([{"effect_id": "f", "type": "flanger", "params": JET}],
                                     FS, blocksize, channels_in=2, device="cpu")
    got = chain.process_array(state, chain.targets(tmap), x, fast=fast)[1]
    assert err_dbfs(got, _reference(JET, x)) <= PORT_DBFS


# On 262,144 samples of white noise the worst sample reads far above
# PORT_DBFS: over ten times the frames, the float32 delay's rounding meets
# steeper stretches of noise, recirculated.  The solve does not set that
# level: the dense one-hot solve that the file path used before the line
# recurrence read -83.880 (jet) and -68.764 (negative) here, the
# recurrence -83.880 and -68.764 (float32 on the CPU, 4 threads).  These
# bars hold the whole-file solve to that level.
LONG_NOISE_DBFS = {"jet": -83.5, "negative": -68.5}


@pytest.mark.parametrize("name", sorted(LONG_NOISE_DBFS))
def test_port_on_long_noise_holds_its_level(name):
    params = {"jet": JET, "negative": NEGATIVE}[name]
    x = noise(262_144)
    chain, state, tmap = build_chain([{"effect_id": "f", "type": "flanger", "params": params}],
                                     FS, 4096, channels_in=2, device="cpu")
    got = chain.process_array(state, chain.targets(tmap), x, fast=True)[1]
    assert err_dbfs(got, _reference(params, x)) <= LONG_NOISE_DBFS[name]


def test_a_solve_cut_after_one_pass_fails_the_tolerance():
    """The line's input cut after one recirculation, v = x + fb tap(x),
    differs from the full recurrence by far more than the port may."""
    x = noise(6 * 4096).T.astype(np.float64)
    p = {**ref.DEFAULTS, **JET}
    cut = (1.0 - p["mix"]) * x + p["mix"] * ref.tap(x + p["feedback"] * ref.tap(x, p, FS), p, FS)
    assert err_dbfs(cut, ref.apply(x, p, FS)) > PORT_DBFS + 40
