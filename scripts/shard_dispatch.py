"""The host's dispatch of ``ShardedStreams``' compiled step over several cards.

    python3 scripts/shard_dispatch.py [--preset NAME] [--streams 16] [--steps 200]
                                      [--out OUT.json]

For 1, 2 and every visible card (one data shard per card), steps the
flagship chain (or the factory preset ``--preset`` names) over
``--streams`` streams with shared targets, each stream on its own part of
the demo's mono mix, in three dispatches of the same shards' graphs, taken
in turns (one, threads, interleaved, interleaved, threads, one):

- ``one``: ``ShardedStreams.run_block`` as the package runs it, one host
  thread writing every shard's targets and block, then replaying the
  shards' graphs in turn;
- ``interleaved``: one host thread doing each shard in turn, its shared
  targets packed and copied from the first card, its block, its replay:
  each later card's copy then waits in the first card's stream behind that
  card's replay;
- ``threads``: the calling thread packs the shared targets and copies
  them to each card, then one worker thread per card runs its shard's part
  (``ShardedStreams._shard_inputs``: its targets and block in; then its
  graph's replay), and the calling thread gathers the outputs as the
  package does.

Reported per (cards, dispatch), over ``--steps`` steps after 20 warm ones:
the synchronized step's p50/p99 (host clock until y and the peak are read
back) and the host's enqueue p50 (until the step returns, before the
readback).  Where ``one``'s enqueue grows with the cards while its step
follows, the host serialises the cards; ``threads`` shows what a thread
per card recovers of that.  The outputs of the two dispatches are held
equal bit for bit.  Prints one JSON object and writes it to ``--out``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aefs_tpu_torch.core.chain import build_chain  # noqa: E402
from aefs_tpu_torch.core.config import DEFAULT_PRESETS  # noqa: E402
from aefs_tpu_torch.engine.flagship import FLAGSHIP  # noqa: E402
from aefs_tpu_torch.engine.wavio import read_wav_file  # noqa: E402
from aefs_tpu_torch.parallel.mesh import ShardedStreams, make_mesh  # noqa: E402

FS, BLOCK, WARM = 48000, 256, 20


def pctl(lat):
    lat = sorted(lat)
    return {"p50_ms": statistics.median(lat),
            "p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]}


def threaded_step(runner, pool):
    """The step of ``runner`` (a prepared ``ShardedStreams``) with each
    shard's part on its own worker thread."""
    def part(i, tree, targets, shared, x):
        runner._shard_inputs(i, tree, targets, shared, x)
        return runner._replay(i)

    def step(state, targets, x):
        shared = runner._spread(targets)
        parts = [pool.submit(part, i, tree, targets, shared[i], x)
                 for i, tree in enumerate(state.shards)]
        ys, peaks = zip(*(f.result() for f in parts))
        y, peak = runner._gather(ys, peaks)
        return type(state)(runner._live, runner), y, peak
    return step


def interleaved_step(runner):
    """The step of ``runner`` one shard after the other, inputs and replay."""
    def step(state, targets, x):
        outs = []
        for i, tree in enumerate(state.shards):
            card = runner.mesh.devices[i][0]
            shared = tuple(v.to(card) for v in runner._shared_packer.pack(targets))
            runner._shard_inputs(i, tree, targets, shared, x)
            outs.append(runner._replay(i))
        y, peak = runner._gather(*zip(*outs))
        return type(state)(runner._live, runner), y, peak
    return step


def timed(step, state, targets, xs):
    """(step p50/p99, enqueue p50, outputs) over xs after WARM steps."""
    lat, host, outs = [], [], []
    for k, x in enumerate(xs):
        t0 = time.perf_counter()
        state, y, peak = step(state, targets, x)
        t1 = time.perf_counter()
        y, peak = y.cpu(), float(peak)
        t2 = time.perf_counter()
        if k >= WARM:
            lat.append(1000.0 * (t2 - t0))
            host.append(1000.0 * (t1 - t0))
            outs.append(y.numpy())
    return {**pctl(lat), "enqueue_p50_ms": statistics.median(host)}, outs, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(DEFAULT_PRESETS))
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default=str(ROOT / "build" / "shard_dispatch.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shard_dispatch.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    cfg = DEFAULT_PRESETS[args.preset] if args.preset else FLAGSHIP
    demo, _ = read_wav_file(str(ROOT / "music" / "rain-demo.wav"))
    mono = demo.mean(axis=1).astype(np.float32)
    n_blocks = WARM + args.steps
    xs = [np.stack([mono[s * FS + b * BLOCK:s * FS + (b + 1) * BLOCK]
                    for s in range(args.streams)])[:, None, :] for b in range(n_blocks)]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    chain, _, tmap = build_chain(cfg, FS, BLOCK, device=cards[0])
    targets = chain.targets(tmap)
    rows = {}
    for n in sorted({1, 2, len(cards)} & set(range(1, len(cards) + 1))):
        runner = ShardedStreams(chain, make_mesh(devices=cards[:n]), args.streams)
        runner.prepare()
        got = {"one": [], "threads": [], "interleaved": []}
        with ThreadPoolExecutor(max_workers=n) as pool:
            steps = {"one": runner.step_fn(), "threads": threaded_step(runner, pool),
                     "interleaved": interleaved_step(runner)}
            for mode in ("one", "threads", "interleaved", "interleaved", "threads", "one"):
                state, _ = runner.init_state()
                res, outs, _ = timed(steps[mode], state, targets, xs)
                got[mode].append((res, outs))
        for mode in ("threads", "interleaved"):
            if not all(np.array_equal(a, b) for (_, o1), (_, o2) in zip(got["one"], got[mode])
                       for a, b in zip(o1, o2)):
                raise AssertionError(f"{n} cards: the {mode} dispatch differs")
        for mode, runs in got.items():
            rows[f"cards={n} {mode}"] = [r for r, _ in runs]
        runner.release()
    out = {"card": card, "cards": len(cards), "torch": torch.__version__,
           "chain": args.preset or "flagship", "streams": args.streams,
           "steps": args.steps, "step": rows}
    print(json.dumps(out), flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
