"""Where the PyTorch port's time goes on one CUDA card.

    python3 scripts/profile_port.py [--preset NAME] [--blocks 40] [--pool S [--grid]]
                                    [--batch F] [--out OUT.json]

Profiles the flagship chain (``aefs_tpu_torch.engine.flagship``), or the factory
preset ``--preset`` names, of ``aefs_tpu_torch`` two ways, on the card,
under ``torch.profiler``:

- streaming: ``AudioEngine.process_stream_block`` on 256-sample blocks of
  the demo's mono mix (``--blocks`` profiled blocks after a warm-up): one
  replay of the chain's captured CUDA graph per block
  (``core/packing.py``), so its kernels are the graph's and no effect
  span fires; ``streaming_eager`` beside it steps the same chain eagerly
  (upload, ``Chain.process_block``, readback: the step before the graph),
  with the per-effect spans;
- file mode: ``process_offline`` of the whole demo file (one warm render
  first, then one profiled render);
- with ``--pool S``: ``SessionPool.step_blocks`` of a pool of S slots
  (aefs_tpu_torch/server/pool.py), every slot streaming its own part of
  the demo, one synchronous pool step (one graph replay) per profiled
  step, and ``pool_eager``, the same batched step eagerly; ``--grid``
  makes it the grid pool (``SessionPool(grid=True)``: a whole-octave
  octaver on its exact integer grid instead of the K1 step);
- with ``--batch F``: ``render_batch`` of F demo-length files (the demo
  rotated by i/16 of its length), one batched ``Chain.process_whole``;
  besides the profile, the unprofiled call's host clock split into
  ``pre_ms`` (mono downmix, padding, the chain's build, the upload),
  ``pass_ms`` (``process_whole`` until the card has drained, summed over
  ``passes`` calls) and ``post_ms`` (readback, clip, per-file trimming).

For the profiled runs only, each effect's ``process`` / ``process_file``
is wrapped in a ``record_function`` span named after its kind; the package
itself carries no instrumentation.  Reported per step (block or render):

- ``kernels``: device kernel events; ``copies``: memcpy/memset events;
- ``launch_calls``: host ``cudaLaunchKernel*`` calls; ``graph_launches``:
  host ``cudaGraphLaunch`` calls (one per replayed step);
- ``wall_ms_unprofiled``: the host wall time of the same step with the
  profiler off (streaming: median of the warm blocks; file: one render);
- ``device_busy_ms``: the union of all device intervals (kernels, copies,
  sets; overlaps counted once) per step;
- ``device_busy_share``: ``device_busy_ms`` over ``wall_ms_unprofiled``.
  The profiler slows the host, not the device, so the busy time is taken
  from the profiled run and the wall time from the unprofiled one;
- ``effects``: per effect, its span's host milliseconds per step, its share
  of the summed spans, the kernel launches issued inside the span, and the
  busy device time of the work that starts inside the span's mirror on the
  device timeline;
- ``top_kernels``: the device kernels with the most device time;
- ``port_kernels``: the hand-written kernels (K1-K6, ``csrc/``), their
  calls and device time per step, inside a graph replay or not.

Prints one JSON object and writes it to ``--out``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aefs_tpu_torch.core.chain import Chain  # noqa: E402
from aefs_tpu_torch.core.config import DEFAULT_PRESETS  # noqa: E402
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline, render_batch  # noqa: E402
from aefs_tpu_torch.engine.flagship import FLAGSHIP  # noqa: E402
from aefs_tpu_torch.engine.wavio import read_wav_file  # noqa: E402
from aefs_tpu_torch.models import EFFECT_REGISTRY, ParallelChains  # noqa: E402

BLOCK = 256
# The hand-written kernels of csrc/ (K1, K3, K5, K6; K2 and K4 share
# comb_bank_kernel).
PORT_KERNELS = ("octaver_step_kernel", "chorus_step_kernel", "comb_bank_kernel",
                "comb_side_sums_kernel", "biquad_step_kernel", "flanger_file_kernel")


@contextmanager
def effect_spans():
    """Wrap every registered effect's process/process_file in a
    record_function span named ``fx:<kind>``; restore on exit.  The parallel
    container gets no span of its own: its branch effects get theirs, and
    nested spans would count their time twice."""
    saved = []
    for cls in set(EFFECT_REGISTRY.values()) - {ParallelChains}:
        for meth in ("process", "process_file"):
            if meth not in vars(cls):
                continue
            orig = vars(cls)[meth]

            def wrapped(self, state, p, x, _orig=orig):
                with record_function(f"fx:{self.kind}"):
                    return _orig(self, state, p, x)

            saved.append((cls, meth, orig))
            setattr(cls, meth, wrapped)
    try:
        yield
    finally:
        for cls, meth, orig in saved:
            setattr(cls, meth, orig)


def _union_ms(intervals):
    """Total length of the union of (start_ns, end_ns) intervals, in ms."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def summarize(prof, steps, wall_ms_unprofiled):
    """Per-step counts and times from the profiler's raw (kineto) events."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev_iv, kernel_ns, kernel_n = [], defaultdict(int), defaultdict(int)
    copies = graph_launches = 0
    launches, spans, dev_spans = [], defaultdict(list), defaultdict(list)
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if name.startswith("fx:"):
            # A record_function span is mirrored onto the device timeline,
            # where it brackets the effect's kernels: it is no device work.
            (dev_spans if ev.device_type() == cuda else spans)[name[3:]].append((s, e))
        elif ev.device_type() == cuda:
            dev_iv.append((s, e))
            if name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernel_ns[name] += e - s
                kernel_n[name] += 1
        elif name.startswith("cudaLaunchKernel"):
            launches.append(s)
        elif name.startswith("cudaGraphLaunch"):
            graph_launches += 1
    launches.sort()
    dev_iv.sort()
    dev_starts = np.array([s for s, _ in dev_iv], dtype=np.int64)
    span_ms = {k: sum(e - s for s, e in v) / 1e6 / steps for k, v in spans.items()}
    span_total = sum(span_ms.values()) or 1.0
    effects = {}
    for k, ivs in spans.items():
        inside = sum(int(np.searchsorted(launches, e) - np.searchsorted(launches, s))
                     for s, e in ivs)
        mine = [dev_iv[i] for s, e in dev_spans.get(k, ())
                for i in range(np.searchsorted(dev_starts, s), np.searchsorted(dev_starts, e))]
        effects[k] = {"host_ms": span_ms[k], "share": span_ms[k] / span_total,
                      "launch_calls": inside / steps,
                      "device_busy_ms": _union_ms(mine) / steps}
    busy_ms = _union_ms(dev_iv) / steps
    top = sorted(kernel_ns, key=kernel_ns.get, reverse=True)[:12]
    ours = {k: {"calls": kernel_n[k] / steps, "device_ms": kernel_ns[k] / 1e6 / steps}
            for k in kernel_ns if any(n in k for n in PORT_KERNELS)}
    return {
        "steps": steps,
        "kernels": sum(kernel_n.values()) / steps,
        "copies": copies / steps,
        "launch_calls": len(launches) / steps,
        "graph_launches": graph_launches / steps,
        "wall_ms_unprofiled": wall_ms_unprofiled,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms_unprofiled,
        "effects": dict(sorted(effects.items(), key=lambda kv: -kv[1]["host_ms"])),
        "top_kernels": [{"name": k[:120], "calls": kernel_n[k] / steps,
                         "device_ms": kernel_ns[k] / 1e6 / steps} for k in top],
        "port_kernels": ours,
    }


def _profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def streaming(cfg, mono, n_blocks):
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(3 * n_blocks)]
    eng = AudioEngine(device="cuda")
    eng.build_chain(cfg)
    lat = []
    for blk in blocks[:2 * n_blocks]:  # warm-up, then unprofiled timing
        t0 = time.perf_counter()
        eng.process_stream_block(blk)  # returns host audio: synchronized
        lat.append(1000.0 * (time.perf_counter() - t0))
    wall = statistics.median(lat[n_blocks:])
    torch.cuda.synchronize()
    with effect_spans(), _profiler() as prof:
        for blk in blocks[2 * n_blocks:]:
            eng.process_stream_block(blk)
        torch.cuda.synchronize()
    return summarize(prof, n_blocks, wall)


def streaming_eager(cfg, mono, n_blocks):
    """The streaming step without the graph: each block uploaded, stepped
    through ``Chain.process_block`` and read back, as the engine did before
    its step was captured."""
    from aefs_tpu_torch.core.chain import build_chain

    chain, state, tmap = build_chain(cfg, 48000, BLOCK, device="cuda")
    targets = chain.targets(tmap)
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(3 * n_blocks)]

    def step(st, blk):
        st, y = chain.process_block(st, targets, torch.from_numpy(blk.T.copy()).cuda())
        y.cpu()
        return st

    lat = []
    for blk in blocks[:2 * n_blocks]:
        t0 = time.perf_counter()
        state = step(state, blk)
        lat.append(1000.0 * (time.perf_counter() - t0))
    wall = statistics.median(lat[n_blocks:])
    torch.cuda.synchronize()
    with effect_spans(), _profiler() as prof:
        for blk in blocks[2 * n_blocks:]:
            state = step(state, blk)
        torch.cuda.synchronize()
    return summarize(prof, n_blocks, wall)


def pool_eager(cfg, mono, n_blocks, slots, grid):
    """The pool's batched step without the graph: ``Chain.process_block``
    over the pool's fresh batched state and its target buffer, every slot
    streaming, uploaded and read back per step."""
    from aefs_tpu_torch.server.pool import SessionPool

    pool = SessionPool(cfg, n_slots=slots, device="cuda", grid=grid)
    chain = pool.chain
    state = chain.batch_state(pool._fresh_single, slots)
    tflat = torch.from_numpy(pool._tbuf.copy()).cuda()
    targets = tuple({name: tflat[pool._trows[(i, name)]] for name in model.PARAMS}
                    for i, (eid, model) in enumerate(chain.effects))
    pool.close()
    x = mono[:, 0]
    steps = [np.stack([x[(b * slots + s) * BLOCK % (x.shape[0] - BLOCK):][:BLOCK][None]
                       for s in range(slots)]) for b in range(3 * n_blocks)]

    def step(st, xb):
        st, y = chain.process_block(st, targets, torch.from_numpy(xb).cuda())
        y.cpu()
        return st

    lat = []
    for xb in steps[:2 * n_blocks]:
        t0 = time.perf_counter()
        state = step(state, xb)
        lat.append(1000.0 * (time.perf_counter() - t0))
    wall = statistics.median(lat[n_blocks:])
    torch.cuda.synchronize()
    with effect_spans(), _profiler() as prof:
        for xb in steps[2 * n_blocks:]:
            state = step(state, xb)
        torch.cuda.synchronize()
    return summarize(prof, n_blocks, wall)


def pool_steps(cfg, mono, n_blocks, slots, grid):
    from aefs_tpu_torch.server.pool import SessionPool

    pool = SessionPool(cfg, n_slots=slots, device="cuda", grid=grid)
    x = mono[:, 0]
    steps = [{s: x[(b * slots + s) * BLOCK % (x.shape[0] - BLOCK):][:BLOCK]
              for s in range(slots)} for b in range(3 * n_blocks)]
    lat = []
    for blocks in steps[:2 * n_blocks]:  # warm-up, then unprofiled timing
        t0 = time.perf_counter()
        pool.step_blocks(blocks)  # waits for its readback: synchronized
        lat.append(1000.0 * (time.perf_counter() - t0))
    wall = statistics.median(lat[n_blocks:])
    torch.cuda.synchronize()
    with effect_spans(), _profiler() as prof:
        for blocks in steps[2 * n_blocks:]:
            pool.step_blocks(blocks)
        torch.cuda.synchronize()
    return summarize(prof, n_blocks, wall)


def file_mode(cfg, demo, fs):
    process_offline(cfg, demo, fs, device="cuda")  # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    process_offline(cfg, demo, fs, device="cuda")
    wall = 1000.0 * (time.perf_counter() - t0)
    with effect_spans(), _profiler() as prof:
        process_offline(cfg, demo, fs, device="cuda")
        torch.cuda.synchronize()
    return summarize(prof, 1, wall)


def batch_render(cfg, demo, fs, files):
    step = demo.shape[0] // 16
    batch = [np.roll(demo, -i * step, axis=0) for i in range(files)]
    render_batch(cfg, batch, fs, device="cuda")  # warm: cuBLAS, allocator
    marks = []
    orig = Chain.process_whole

    def timed(self, *args):
        marks.append(time.perf_counter())
        out = orig(self, *args)
        torch.cuda.synchronize()  # render_batch's readback waits here anyway
        marks.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    Chain.process_whole = timed
    try:
        t0 = time.perf_counter()
        render_batch(cfg, batch, fs, device="cuda")
        t1 = time.perf_counter()
    finally:
        Chain.process_whole = orig
    with effect_spans(), _profiler() as prof:
        render_batch(cfg, batch, fs, device="cuda")
        torch.cuda.synchronize()
    passes = sum(b - a for a, b in zip(marks[::2], marks[1::2]))
    return {"files": files, "passes": len(marks) // 2, "pre_ms": 1000.0 * (marks[0] - t0),
            "pass_ms": 1000.0 * passes, "post_ms": 1000.0 * (t1 - marks[-1]),
            **summarize(prof, 1, 1000.0 * (t1 - t0))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(DEFAULT_PRESETS),
                    help="factory preset to profile (default: the flagship chain)")
    ap.add_argument("--blocks", type=int, default=40, help="profiled streaming blocks")
    ap.add_argument("--pool", type=int, default=0, metavar="S",
                    help="also profile the steps of a pool of S slots")
    ap.add_argument("--grid", action="store_true", help="make that pool a grid pool")
    ap.add_argument("--batch", type=int, default=0, metavar="F",
                    help="also profile a render_batch of F demo-length files")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_port.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_port needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    demo, fs = read_wav_file(str(ROOT / "music" / "rain-demo.wav"))
    mono = demo.mean(axis=1, keepdims=True).astype(np.float32)
    cfg = DEFAULT_PRESETS[args.preset] if args.preset else FLAGSHIP
    result = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "chain": args.preset or "flagship",
        "streaming": streaming(cfg, mono, args.blocks),
        "streaming_eager": streaming_eager(cfg, mono, args.blocks),
        "file_mode": file_mode(cfg, demo, fs),
    }
    if args.pool:
        result["pool"] = {"slots": args.pool, "grid": args.grid,
                          **pool_steps(cfg, mono, args.blocks, args.pool, args.grid)}
        result["pool_eager"] = {"slots": args.pool, "grid": args.grid,
                                **pool_eager(cfg, mono, args.blocks, args.pool, args.grid)}
    if args.batch:
        result["batch"] = batch_render(cfg, demo, fs, args.batch)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
