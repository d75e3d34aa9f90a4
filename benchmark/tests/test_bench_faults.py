"""A run with its timed path broken underneath comes out not correct: a
step that leaves its state unchanged, an answer altered where it is
produced, (the pool) half of a batch's blocks left out, and the controls
(the reference at a lower precision in the program's place; the
program's biquads in float32).  Each drives the rest of a run on the CPU
at a tiny size; the look for a card is skipped."""

import json
import os
import shutil
import time

from benchmark import control, harness

SHORT = {"warmup_blocks": 20, "slack_blocks": 100}


UPLOAD = {"warmup_uploads": 1, "compare_uploads": 1, "upload_seconds": 3.0}
POOL = {"sessions": 2, "compare_sessions": 2, "warmup_blocks": 60, "connect_margin_s": 5.0}


def _pool_root(tmp_path):
    """A copy of the benchmark with ``flagship.pool`` added as data only:
    its manifest entries and its limits file."""
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    man["workloads"].append({"name": "flagship.pool", "config": "flagship", "traffic": "pool",
                             "chips": 1, "why": "a test"})
    next(m for m in man["end_to_end"] if m["name"] == "block_p99_ms")["workloads"].append(
        "flagship.pool")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "benchmark/limits/flagship.pool.json").write_text(
        json.dumps({"err_dbfs": {"limit": -70.0}}))
    return tmp_path


def _run(cell, traffic=None, seconds=0.5, root=harness.ROOT, ctl=None):
    mix = {**SHORT, **(POOL if cell == "flagship.pool" else {}), **(traffic or {})}
    return harness.run(cell, 2 ** 33 + 5, seconds, False, time.perf_counter(), device="cpu",
                       root=root, traffic=mix, control=ctl)


def test_sound_run_is_correct():
    assert _run("flagship.live")["correct"]


def test_state_left_unchanged(monkeypatch):
    from aefs_tpu_torch.core.packing import PackedRunner

    original = PackedRunner.run

    def run(self):
        keep = [g.clone() for g in self.sgroups]
        groups, y = original(self)
        y = y.clone()
        for g, k in zip(self.sgroups, keep):
            g.copy_(k)
        return groups, y

    monkeypatch.setattr(PackedRunner, "run", run)
    assert not _run("flagship.live")["correct"]


def test_answer_altered(monkeypatch):
    from aefs_tpu_torch.core.packing import PackedRunner

    original, calls = PackedRunner.run, []

    def run(self):
        groups, y = original(self)
        calls.append(1)
        if len(calls) % 4 == 0:  # every fourth answer, however few a slow host makes
            y = y.clone()
            y[..., 7] += 1e-2
        return groups, y

    monkeypatch.setattr(PackedRunner, "run", run)
    assert not _run("flagship.live")["correct"]


def test_upload_answer_altered(monkeypatch):
    from aefs_tpu_torch.engine.engine import AudioEngine

    original = AudioEngine.process_file_array

    def process_file_array(self, audio, fs):
        mono, out = original(self, audio, fs)
        out = out.copy()
        out[1000] += 1e-2
        return mono, out

    monkeypatch.setattr(AudioEngine, "process_file_array", process_file_array)
    line = _run("flagship.upload", UPLOAD, seconds=2.0)
    assert not line["correct"]


FAULTY_POOL = '''
from aefs_tpu_torch.server import pool as _pool

_step = _pool.SessionPool.step_blocks_pipelined


def _half(self, blocks):
    # every other slot's block left out (stepped on silence)
    return _step(self, {s: (b if s % 2 == 0 else 0 * b) for s, b in blocks.items()})


_pool.SessionPool.step_blocks_pipelined = _half
'''


def test_pool_half_the_batch_left_out(tmp_path, monkeypatch):
    (tmp_path / "sitecustomize.py").write_text(FAULTY_POOL)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(harness.ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    line = _run("flagship.pool", seconds=1.0, root=_pool_root(tmp_path / "root"))
    assert not line["correct"]


def test_pool_sound_run_is_correct(tmp_path):
    line = _run("flagship.pool", seconds=1.0, root=_pool_root(tmp_path))
    assert line["correct"], line
    assert set(line["metrics"]) == {"block_p99_ms", "setup_s"}


def test_control_comes_out_not_correct():
    """The control (the reference in bfloat16) in the program's place,
    judged by the cell's own limits: not correct, while the program is."""
    line = _run("flagship.live", ctl="bfloat16")
    assert line["correct"] and line["control"]["correct"] is False
    assert line["control"]["checks"]["err_dbfs"]["value"] > line["checks"]["err_dbfs"]["limit"]
    assert list(line)[-1] == "checks"


def test_upload_control_comes_out_not_correct():
    line = _run("flagship.upload", UPLOAD, seconds=2.0,
                ctl="bfloat16")
    assert line["correct"] and line["control"]["correct"] is False


def test_planted_float32_biquads_not_correct(monkeypatch):
    """The program with its biquads solved in float32 (``control.py
    --biquads-float32``) fails the "Multiband Master" cell's limit."""
    from aefs_tpu_torch.models import biquad
    from aefs_tpu_torch.ops import scan

    monkeypatch.setattr(biquad, "biquad_block", biquad.biquad_block)
    control.plant_biquad_float32()
    assert biquad.biquad_block is not scan.biquad_block
    line = _run("multiband_master.live")
    assert not line["correct"], line["checks"]
