"""The ``jet_flanger.upload`` cell on the CPU at a tiny size: a run reads
correct against the float64 flanger reference and, traced, reports the
upload cells' front, render and idle metrics and its own kernel count;
the reference in bfloat16 in the program's place does not read correct."""

import time

from benchmark import harness

CELL = "jet_flanger.upload"
SHORT = {"warmup_uploads": 1, "compare_uploads": 1, "upload_seconds": 1.0}
METRICS = {"front_s.upload", "render_s.upload", "device_idle_pct.upload",
           "kernels_per_render.flanger"}


def _run(trace, control=None):
    return harness.run(CELL, 2 ** 33 + 19, 4.0, trace, time.perf_counter(), device="cpu",
                       traffic=SHORT, control=control)


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
    assert line["metrics"]["front_s.upload"]["value"] > 0
    summary = {"busy_s": 0.25, "window_s": 2.0,
               "kernel_n": {"gemv": 3000, "elementwise": 120000, "gemm": 800}}
    read = {m: harness.load_reader(m).read for m in METRICS}
    assert read["kernels_per_render.flanger"]({"trace": summary}) == 123800
    assert read["device_idle_pct.upload"]({"trace": summary}) == 87.5
    for m in ("kernels_per_render.flanger", "device_idle_pct.upload"):
        assert read[m]({"trace": None}) is None


def test_the_bfloat16_control_is_not_correct():
    line = _run(False, control="bfloat16")
    assert line["correct"] and not line["control"]["correct"]
