"""The benchmark's harness: finds a cell and everything that belongs to it
by name (``BENCHMARK.json``, ``configs/<config>.json``,
``traffic/<mix>.json``, ``limits/<cell>.json``, ``metrics/<metric>.py``,
``drivers/<kind>.py`` for the traffic's kind), runs the cell's driver,
judges what it compared against the cell's limits, and prints the result
line.

Nothing here imports the JAX package or JAX; a run that finds either in
``sys.modules`` once its window has closed prints no result.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "aefs_tpu", "__graft_entry__")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file, a
    forbidden import): it exits non-zero and prints no result line."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and where to log."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # perf_counter at the process's start of work
    # The control (benchmark/control.py): the reference at this precision
    # (``refchain``'s spec) put in the program's place and compared as the
    # program's outputs are; ``drivers/<kind>.py`` returns them apart.
    control: str | None = None

    def log(self, **fields):
        print("info " + json.dumps(fields), flush=True)


@dataclass
class Outcome:
    """What a driver returns.  ``e2e`` holds the cell's end-to-end values,
    ``obs`` what the per-layer readers read (spans, counters, the trace
    summary or None, shapes), ``checks`` the numbers the comparison
    produced, and ``control_checks`` the same numbers of the control's
    outputs in the program's place (a run with a control only)."""
    setup_s: float
    attempted: int
    failed: int
    e2e: dict
    obs: dict
    checks: dict
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    notes: dict = field(default_factory=dict)
    control_checks: dict = field(default_factory=dict)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reported_in(entry: dict, cell: str, e2e_names) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or
    without a list and moving (or being) an end-to-end metric it reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", (name,))]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if reported_in(m, name, e2e_names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer, root)


def load_reader(metric: str, root: Path = ROOT):
    """The per-layer metric's reader, ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def forbidden_modules():
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def pct(values, q):
    """The q-th percentile (linear), or None without values."""
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


def cache_env(root: Path = ROOT):
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernel library is already at build/aefs_tpu_torch)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_facts():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device is visible: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


def judge(checks: dict, limits: dict):
    """{name: (value, limit, ok)} for every limit; a number with no limit
    or a limit with no number is a failure."""
    out = {}
    for name, lim in limits.items():
        v = checks.get(name)
        out[name] = (v, lim["limit"],
                     v is not None and bool(np.isfinite(v)) and v <= lim["limit"])
    return out


def result_line(cell: Cell, oc: Outcome, trace: bool, verdicts: dict) -> dict:
    correct = oc.failed == 0 and all(ok for _v, _l, ok in verdicts.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            val = load_reader(m["name"], cell.root).read(oc.obs)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            val = oc.setup_s if m["name"] == "setup_s" else oc.e2e.get(m["name"])
            if val is None:
                raise BenchError(f"the run produced no {m['name']}")
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": oc.device_kind, "count": oc.device_count,
              "memory_peak_bytes": int(oc.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(oc.attempted), "failed": int(oc.failed),
            "metrics": metrics, "device": device}
    summary = oc.obs.get("trace")
    if trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = summary["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _ok) in verdicts.items()}
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", root: Path = ROOT, traffic: dict | None = None,
        control: str | None = None) -> dict:
    """One run of a cell of ``BENCHMARK.json``; returns the result line.
    ``device="cpu"`` skips the look for a card (the harness's own tests),
    ``traffic`` overrides parameters of the cell's mix (the tests' short
    warm-ups), and ``control`` names the precision of the control
    (benchmark/control.py), judged by the cell's limits as the program is
    and reported under ``control``."""
    cell = find_cell(workload, root)
    cell.traffic.update(traffic or {})
    cache_env(cell.root)
    if device == "cuda":
        require_cards(cell.chips)
    ctx = Context(cell, seed, seconds, trace, device, started, control)
    if device == "cuda":
        import torch

        ctx.log(card=card_facts(), devices=torch.cuda.device_count())
    ctx.log(cell=cell.name, seed=seed, seconds=seconds, trace=int(trace),
            cpu_count=os.cpu_count())
    oc = load_driver(cell.traffic["kind"]).run(ctx)
    verdicts = judge(oc.checks, cell.limits)
    ctx.log(counts={"attempted": oc.attempted, "failed": oc.failed, **oc.notes})
    line = result_line(cell, oc, trace, verdicts)
    if control:
        cv = judge(oc.control_checks, cell.limits)
        checks = line.pop("checks")
        line["control"] = {"correct": all(ok for _v, _l, ok in cv.values()),
                           "checks": {k: {"value": v, "limit": lim}
                                      for k, (v, lim, _ok) in cv.items()}}
        line["checks"] = checks
    return line


def main(argv=None, started=None) -> int:
    import argparse

    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line = run(args.workload, args.seed, args.seconds, bool(args.trace), started)
        bad = forbidden_modules()
        if bad:
            raise BenchError(f"the run loaded {bad}: the benchmark measures the PyTorch "
                             "port alone")
    except BenchError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
