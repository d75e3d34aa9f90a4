"""BENCHMARK.json against the contract, the result line, the discovery of
configurations, mixes and metrics by name, and the import check."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_names(man):
    assert set(man) == KEYS["top"]
    assert man["command"] == ["python3", "benchmark/run.py"] and man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    for section, kind in (("configs", "config"), ("workloads", "workload"),
                          ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        names = [e["name"] for e in man[section]]
        assert len(names) == len(set(names))
        for e in man[section]:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in man["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len(json.dumps(man)) <= 64 * 1024


def test_metrics_and_cells(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"]), m["name"]
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    for w in cells:
        cell = harness.find_cell(w)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer and "err_dbfs" in cell.limits
        assert harness.load_driver(cell.traffic["kind"]).run


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship.live",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert not any(l.startswith("{") for l in res.stdout.splitlines())
    assert "no CUDA device" in res.stderr


def test_result_line_on_cpu():
    line = harness.run("flagship.live", 2 ** 31 + 12345, 0.5, False, time.perf_counter(),
                       device="cpu")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"block_p99_ms", "setup_s"}
    assert line["checks"]["err_dbfs"]["value"] < line["checks"]["err_dbfs"]["limit"]
    json.loads(json.dumps(line))


def test_found_by_name(tmp_path):
    """A configuration, a mix, a limit and a metric dropped into a copy are
    picked up without editing any file that is there."""
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    cfg = json.loads((harness.ROOT / "benchmark/configs/flagship.json").read_text())
    cfg["name"] = "short_echo"
    cfg["chain"][3]["params"]["delay_ms"] = 120
    (tmp_path / "benchmark/configs/short_echo.json").write_text(json.dumps(cfg))
    mix = json.loads((harness.ROOT / "benchmark/traffic/live.json").read_text())
    mix["warmup_blocks"] = 20
    (tmp_path / "benchmark/traffic/live_short.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/limits/short_echo.live_short.json").write_text(
        json.dumps({"err_dbfs": {"limit": -70.0}}))
    (tmp_path / "benchmark/metrics/handed_blocks.stream.py").write_text(
        'LAYER = "client (the benchmark\'s load generator)"\nUNIT = "blocks"\n'
        'SOURCE = "program_counter"\nMOVES = "block_p99_ms"\n\n\n'
        'def read(obs):\n    return obs["counters"]["due_blocks"] - obs["counters"]["skipped_blocks"]\n')
    man["configs"].append({"name": "short_echo", "source": "https://example.org/short",
                           "file": "benchmark/configs/short_echo.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "short_echo.live_short", "config": "short_echo",
                             "traffic": "live_short", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "handed_blocks.stream", "unit": "blocks",
                             "better": "higher", "source": "program_counter",
                             "layer": "client (the benchmark's load generator)",
                             "moves": "block_p99_ms", "workloads": ["short_echo.live_short"]})
    next(m for m in man["end_to_end"] if m["name"] == "block_p99_ms")["workloads"].append(
        "short_echo.live_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.find_cell("short_echo.live_short", tmp_path)
    assert cell.config["chain"][3]["params"]["delay_ms"] == 120
    assert cell.traffic["warmup_blocks"] == 20
    assert "handed_blocks.stream" in [m["name"] for m in cell.per_layer]
    line = harness.run("short_echo.live_short", 77, 0.3, True, time.perf_counter(),
                       device="cpu", root=tmp_path)
    assert line["correct"] and line["metrics"]["handed_blocks.stream"]["value"] > 0


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "aefs_tpu_torch_extra", sys)
    assert "aefs_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aefs_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"aefs_tpu.core", "jaxlib"} <= set(harness.forbidden_modules())


@pytest.mark.parametrize("cell, seconds", [("flagship.live", 0.3), ("flagship.upload", 2.0)])
def test_a_run_loads_no_jax(cell, seconds):
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import harness; "
            f"harness.run({cell!r}, 5, {seconds}, False, time.perf_counter(), device='cpu', "
            "traffic={'warmup_uploads': 1, 'upload_seconds': 3.0, 'warmup_blocks': 20}); "
            "print('LOADED', harness.forbidden_modules())")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert "LOADED []" in res.stdout, res.stdout[-2000:] + res.stderr[-2000:]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship.live",
                          "--seed", "3000000019", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.splitlines()[-1])["correct"] is True


BENCH_FILES = sorted(str(p.relative_to(harness.ROOT))
                     for p in (harness.ROOT / "benchmark").rglob("*.py"))


@pytest.mark.parametrize("rel", BENCH_FILES)
def test_no_file_imports_jax(rel):
    """Every module of the benchmark, by its import statements' top-level
    names compared whole (``aefs_tpu_torch`` is not ``aefs_tpu``)."""
    import ast

    tree = ast.parse((harness.ROOT / rel).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & set(harness.FORBIDDEN), (rel, roots & set(harness.FORBIDDEN))
