"""The ``multiband_master.upload_traced`` cell on the CPU at a tiny size: a
traced run reads correct and gives all nine of its program's readers and
the upload cells' own a number; with device records of the card's form
added to the trace, the idle gaps are named by the program's spans, from
the executor's threads too, and few are left unnamed; the readers' rules
(drops, a program without the spans or the clock); and the summarize
wrapper and the tracer end with the cell's run, so ``flagship.upload``'s
traced result keeps its keys and metric names."""

import time

import pytest
import torch

from benchmark import harness, program, tracing

CELL = "multiband_master.upload_traced"
SHORT = {"warmup_uploads": 1, "compare_uploads": 1, "upload_seconds": 1.0}
PROGRAM = {"decode_s.traced", "analysis_s.traced", "serialize_s.traced", "samples_s.traced",
           "wav_b64_s.traced", "front_self_s.traced", "hop_ms.traced",
           "render_self_s.traced", "unnamed_idle_pct.traced"}
OUTSIDE = {"front_s.upload", "render_s.upload", "device_idle_pct.upload"}
SPANS = {"front.upload", "front.decode", "front.hop", "engine.render", "chain.file_effect",
         "front.analysis", "front.serialize", "front.wav", "front.b64", "front.reply",
         "front.samples", "front.send"}


class _DeviceRecord:
    """A kernel of 1 us on the card, as the profiler's event gives it."""

    def __init__(self, start):
        self._start = start

    def name(self):
        return "kernel"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return 1000

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def correlation_id(self):
        return 1


def _with_device_records(real):
    """``summarize`` of a trace with 40 device records spread over the
    traced upload's ``front.upload`` (the last one in the view: the driver's
    span events), as a card's trace would have them."""
    def summarize(prof):
        events = list(prof.profiler.kineto_results.events())
        ups = [ev for ev in events if ev.name() == "front.upload"]
        up = max(ups, key=lambda ev: ev.start_ns())
        step = up.duration_ns() // 40
        dev = [_DeviceRecord(up.start_ns() + i * step) for i in range(40)]
        return real(type(prof)(events + dev))
    return summarize


def _run(cell, trace=True, seed=2 ** 33 + 41):
    return harness.run(cell, seed, 4.0, trace, time.perf_counter(), device="cpu",
                       traffic=SHORT)


def test_the_cell_its_config_and_its_limit_load():
    cell = harness.find_cell(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "upload_traced"
    upload = harness.find_cell("multiband_master.live").config
    assert cell.config == upload
    mix = dict(harness.load_json(harness.HERE / "traffic" / "upload.json"))
    assert {**mix, "kind": "upload_traced"} == cell.traffic
    assert {m["name"] for m in cell.end_to_end} == {"upload_x_realtime", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == PROGRAM | OUTSIDE
    lim = cell.limits["err_dbfs"]
    assert lim["lower"] < lim["limit"] < lim["upper"]


def test_a_traced_run_gives_every_reader_a_number(monkeypatch):
    monkeypatch.setattr(tracing, "summarize", _with_device_records(tracing.summarize))
    line = _run(CELL)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == PROGRAM | OUTSIDE
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    assert line["metrics"]["unnamed_idle_pct.traced"]["value"] < 100
    names = {name for name, _s in line["breakdown"]["idle_gaps"]}
    assert names & SPANS, names
    # The render's gaps lie on an executor's thread, where only the
    # program's spans name them.
    assert names & {"engine.render", "chain.file_effect"}, names


def test_an_untraced_run_reads_correct_and_leaves_the_tracer_off():
    from aefs_tpu_torch.utils.metrics import TRACER

    line = _run(CELL, trace=False)
    assert line["correct"] and set(line["metrics"]) == {"upload_x_realtime", "setup_s"}
    assert not TRACER.enabled and TRACER.export()["spans"] == {}


def test_a_tracer_that_records_nothing_leaves_the_readers_none(monkeypatch):
    from aefs_tpu_torch.utils.metrics import TRACER

    monkeypatch.setattr(TRACER, "enable", lambda: None)
    line = _run(CELL)
    assert line["correct"] and set(line["metrics"]) == {"front_s.upload", "render_s.upload"}


def test_the_wrapper_ends_with_the_run_and_flagship_keeps_its_result():
    from aefs_tpu_torch.utils.metrics import TRACER

    real = tracing.summarize
    _run(CELL)
    assert tracing.summarize is real and not TRACER.enabled
    line = _run("flagship.upload")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"front_s.upload", "render_s.upload"}
    assert {m["name"] for m in harness.find_cell("flagship.upload").per_layer} == {
        "front_s.upload", "render_s.upload", "k2_roofline_pct.upload", "device_idle_pct.upload"}
    assert TRACER.export()["spans"] == {}


# -- the readers' rules --------------------------------------------------------------

MS = 1_000_000


def _obs(spans, dropped=None, clock=True, uploads=(2, 3)):
    prog = {"spans": spans, "counters": {}, "dropped": dropped or {}, "uploads": list(uploads)}
    if clock:
        prog["clock"] = {"trace_offset_ns": 0}
    return {"program": prog, "trace": {"busy_s": 0.01, "window_s": 0.21, "breakdown": {
        "device_ops": [], "idle_gaps": [["front.serialize", 0.15], ["no host event", 0.01]]}}}


def _upload(rid, t):
    """An upload of rid ``rid`` from ``t`` ms: 100 ms in all."""
    at = lambda a, b: [rid, (t + a) * MS, (t + b) * MS]  # noqa: E731
    return {"front.upload": [at(0, 100)], "front.decode": [at(1, 11)],
            "front.hop": [at(11, 12), at(50, 51), at(52, 53), at(97, 98)],
            "engine.render": [at(12, 50)], "chain.file_effect": [[0, *at(15, 30)[1:]],
                                                                 [1, *at(30, 45)[1:]]],
            "front.analysis": [at(53, 63)], "front.serialize": [at(63, 97)],
            "front.wav": [at(63, 66)], "front.b64": [at(66, 70)],
            "front.samples": [at(75, 90)], "front.send": [at(98, 99)]}


def _merge(*ups):
    out = {}
    for u in ups:
        for k, v in u.items():
            out.setdefault(k, []).extend(v)
    return out


def _read(name, obs):
    return harness.load_reader(name).read(obs)


def test_the_readers_take_the_windows_uploads_by_rid_and_by_containment():
    # rid 1 is a warm-up upload: left out, its effects' spans too.
    obs = _obs(_merge(_upload(1, 0), _upload(2, 200), _upload(3, 400)))
    obs["program"]["spans"]["chain.file_effect"].append([0, 210 * MS, 240 * MS])
    got = {m: _read(m, obs) for m in PROGRAM}
    assert got["decode_s.traced"] == pytest.approx(0.010)
    assert got["analysis_s.traced"] == pytest.approx(0.010)
    assert got["serialize_s.traced"] == pytest.approx(0.034)
    assert got["samples_s.traced"] == pytest.approx(0.015)
    assert got["wav_b64_s.traced"] == pytest.approx(0.007)
    assert got["hop_ms.traced"] == pytest.approx(4.0)
    # 100 ms less decode 10, hops 4, render 38, analysis 10, serialize 34, send 1
    assert got["front_self_s.traced"] == pytest.approx(0.003)
    # render 38 ms less the effects' union: upload 3's 30 ms; upload 2's
    # extra span, clipped to its render, joins its first: 33 ms.
    assert got["render_self_s.traced"] == pytest.approx((0.005 + 0.008) / 2)
    assert got["unnamed_idle_pct.traced"] == pytest.approx(5.0)


def test_a_ring_that_dropped_or_a_program_without_the_spans_reads_none():
    spans = _merge(_upload(2, 0), _upload(3, 200))
    assert _read("decode_s.traced", _obs(spans, {"front.decode": 3})) is None
    assert _read("decode_s.traced", _obs(spans, {"front.upload": 1})) is None
    assert _read("analysis_s.traced", _obs(spans, {"front.decode": 3})) is not None
    no_hop = {k: v for k, v in spans.items() if k not in ("front.hop", "front.wav", "front.b64")}
    assert _read("hop_ms.traced", _obs(no_hop)) is None
    assert _read("wav_b64_s.traced", _obs(no_hop)) is None
    assert _read("unnamed_idle_pct.traced", _obs(spans, clock=False)) is None
    for m in PROGRAM:
        assert _read(m, {"trace": None}) is None, m


def test_union_of_intervals():
    assert program.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert program.union_ns([(0, 10), (5, 15), (20, 30)], 8, 25) == 12
    assert program.union_ns([]) == 0
