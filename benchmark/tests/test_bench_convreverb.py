"""The ``concert_hall.upload`` cell on the CPU at a tiny size: a run reads
correct against the float64 convolution reverb reference and, traced,
reports the upload cells' front, render and idle metrics and its own
cuFFT time; the reference in bfloat16 in the program's place does not
read correct."""

import time

from benchmark import harness

CELL = "concert_hall.upload"
SHORT = {"warmup_uploads": 1, "compare_uploads": 1, "upload_seconds": 1.0}
METRICS = {"front_s.upload", "render_s.upload", "device_idle_pct.upload",
           "fft_device_ms.convreverb"}


def _run(trace, control=None):
    return harness.run(CELL, 2 ** 33 + 23, 4.0, trace, time.perf_counter(), device="cpu",
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
    fft = {"void regular_fft_factor<1024u, EPT<16u>, 8u>(kernel_arguments_t<unsigned int>)":
           (3.4e-5, 3),
           "void vector_fft_symm_r2c<16384u, EPT<32u>, 1u>(kernel_arguments_t<unsigned int>)":
           (1.6e-5, 2),
           "void postprocess_kernel<float, unsigned int>(real_complex_args_t<unsigned int>)":
           (5e-6, 1),
           "void at::native::_fft_conjugate_copy_kernel<c10::complex<float> >(long)":
           (1.5e-5, 1)}
    other = {"void at::native::elementwise_kernel<128, 2, MulFunctor<float> >(int)": (3e-5, 6)}
    both = {**fft, **other}
    summary = {"busy_s": 0.01, "window_s": 0.4,
               "kernel_s": {k: s for k, (s, _n) in both.items()},
               "kernel_n": {k: n for k, (_s, n) in both.items()}}
    read = {m: harness.load_reader(m).read for m in METRICS}
    assert abs(read["fft_device_ms.convreverb"]({"trace": summary}) - 0.07) < 1e-12
    assert read["device_idle_pct.upload"]({"trace": summary}) == 97.5
    for m in ("fft_device_ms.convreverb", "device_idle_pct.upload"):
        assert read[m]({"trace": None}) is None


def test_the_bfloat16_control_is_not_correct():
    line = _run(False, control="bfloat16")
    assert line["correct"] and not line["control"]["correct"]
