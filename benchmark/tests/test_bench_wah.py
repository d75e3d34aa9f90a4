"""The ``funky_talk.upload`` cell on the CPU at a tiny size: the float64
wah reference agrees with the per-sample oracle, the harness's chain runs
the preset with its delay, a run reads correct against the reference
and, traced, reports the upload cells' front, render and idle metrics and
its own kernel count; the reference in bfloat16 in the program's place
does not read correct."""

import sys
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import delay as ref_delay
from benchmark.reference import wah as ref
from benchmark.refchain import run_chain

sys.path.insert(0, str(harness.ROOT / "tests"))
from oracles import OracleWah  # noqa: E402

CELL = "funky_talk.upload"
SHORT = {"warmup_uploads": 1, "compare_uploads": 1, "upload_seconds": 1.0}
METRICS = {"front_s.upload", "render_s.upload", "device_idle_pct.upload",
           "kernels_per_render.wah"}
FS = 48000


def _run(trace, control=None):
    return harness.run(CELL, 2 ** 33 + 29, 4.0, trace, time.perf_counter(), device="cpu",
                       traffic=SHORT, control=control)


def _chain():
    return harness.find_cell(CELL).config["chain"]


@pytest.mark.parametrize("params", [
    {},
    {"mode": 1.0, "sens": 8.0, "env_ms": 25.0, "res": 4.0, "min_hz": 300.0, "max_hz": 2500.0},
    {"mode": 0.0, "res": 8.0, "rate_hz": 6.0, "mix": 0.6},
], ids=["defaults", "funky", "lfo-high-q"])
def test_the_reference_matches_the_per_sample_oracle(params):
    """Both step the same float64 recurrence: the sums' order alone
    differs (the reference composes each 256-sample chunk's start from
    two unit-state runs), ~1e-15 here.  These env_ms values are ones at
    which NumPy's float32 exp in the oracle gives the rounded pole."""
    p = {**ref.DEFAULTS, **params}
    x = 0.3 * np.random.default_rng(4).standard_normal((2, 3000))
    want = OracleWah(FS, **p).process(x.T.copy()).T
    assert np.max(np.abs(ref.apply(x, p, FS) - want)) < 1e-12


def test_the_chain_runs_the_wah_then_the_delay():
    chain = _chain()
    assert [e["type"] for e in chain] == ["wah", "delay"]
    x = 0.3 * np.random.default_rng(5).standard_normal((2, 12000))
    wah = ref.apply(x, {**ref.DEFAULTS, **chain[0]["params"]}, FS)
    want = ref_delay.apply(wah, {**ref_delay.DEFAULTS, **chain[1]["params"]}, FS)
    assert np.array_equal(run_chain(x, chain, FS), want)
    assert not np.allclose(want, wah)  # the 110 ms slap is there


def test_the_cell_its_config_and_its_limit_load():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "upload"
    assert cell.config["reduced"] == [] and cell.config["assumed"]
    assert {m["name"] for m in cell.end_to_end} == {"upload_x_realtime", "setup_s"}
    lim = cell.limits["err_dbfs"]
    assert lim["lower"] < lim["limit"] < lim["upper"]


def test_the_cell_reads_correct():
    line = _run(False)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"upload_x_realtime", "setup_s"}
    assert line["checks"]["err_dbfs"]["value"] <= -85


def test_a_traced_run_reports_its_metrics():
    """On the CPU the profiler records no device operation, so the two
    device-trace metrics are left out; they are read from a trace summary
    of the card's form."""
    assert {m["name"] for m in harness.find_cell(CELL).per_layer} == METRICS
    line = _run(True)
    assert line["correct"]
    assert set(line["metrics"]) == {"front_s.upload", "render_s.upload"}
    assert line["metrics"]["render_s.upload"]["value"] > 0
    summary = {"busy_s": 0.05, "window_s": 1.0,
               "kernel_n": {"elementwise": 700, "mul": 300, "pad": 160}}
    read = {m: harness.load_reader(m).read for m in METRICS}
    assert read["kernels_per_render.wah"]({"trace": summary}) == 1160
    assert read["device_idle_pct.upload"]({"trace": summary}) == 95.0
    for m in ("kernels_per_render.wah", "device_idle_pct.upload"):
        assert read[m]({"trace": None}) is None


def test_the_bfloat16_control_is_not_correct():
    line = _run(False, control="bfloat16")
    assert line["correct"] and not line["control"]["correct"]
