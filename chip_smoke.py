"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (aefs_tpu_torch) end to end on the card:

1. probe: a CUDA card is required; prints its name and power limit;
2. build: compiles the hand-written kernels (csrc/*.cu) from the sources;
3. K1 (the octaver's block step) against its plain PyTorch step on the
   card, bit for bit on every output and state leaf, over runs of blocks of
   256, 200 and 4096 samples with a semitone change mid-run, and from a
   state at n_abs = 2^28 - 100 (the re-anchor fires);
4. K2 (whole-file reverb comb sums) against its plain version on the card,
   at the flagship reverb's lags over the demo file's length, with the
   baked-damping FIR and the traced-damping scan; then its file grid:
   x (F, 2, N) at the demo's length for F = 1, 4, 16 in one launch, each
   file bit-equal to an F = 1 launch, timed beside its bound;
5. K3 (the chorus's block step) against its plain step, bit for bit, over
   2 x 256 blocks with a rate change mid-run, a clamped delay law, and
   2 x 892,800 (the demo file in one call);
6. K4 (the comb bank with every chunk's y and damped) through its entry
   ``ringbuf.comb_bank_file_chunks`` at the flagship reverb's lags over the
   demo's length, against its plain version; K5 (the biquad's block step)
   against its plain step, bit for bit: seven types over a 40-block
   cutoff glide and 64 pool slots, timed at 2 x 256 and at 16 slots; K6
   (the flanger's whole-file solve) against its plain version, bit for
   bit, on "Jet Flanger"'s and a negative-feedback flanger's operands at
   the demo's length, timed there beside its bound and its chain of
   stretches;
7. file mode: ``process_offline`` of the flagship chain, the "Rain Delay"
   preset, the five modulation presets ("Lush Chorus", "Jet Flanger",
   "Psychedelic Sweep", "Funky Talk", "8-Bit Arcade") and the seven
   presets of the dynamics/FFT/container slice ("Clean Noise Removal",
   "Crunch", "Concert Hall (Convolution)", "Glue Bus", "Master Bus",
   "Broadcast Voice", "Multiband Master") on music/rain-demo.wav, each
   against the same render on the CPU;
8. streaming: ``AudioEngine(device="cuda")`` with the flagship chain,
   "Lush Chorus", "Concert Hall (Convolution)" and "Multiband Master",
   375 blocks of 256 samples of the demo's mono mix each (120 for
   "Multiband Master"), against the CPU engine;
9. the session layer and the CLI's batch and resumable modes:
   ``render_batch`` of the flagship and "Lush Chorus" over three ragged
   files (the demo, its first 10 s, its last 7 s; one batched pass, so K2
   and K3 launch once per batch) against ``process_offline`` and the CPU
   port; ``render_batch_sweep``: demo-length files (the demo rotated), the
   flagship at F = 1, 4, 16 and "Jet Flanger", "Lush Chorus", "Rain Delay"
   and "Concert Hall (Convolution)" at F = 4, each file within -120 dBFS of
   its own render on the card and file 0 within -90 dBFS of the CPU port,
   with wall time, aggregate realtime factor, launches, device kernels and
   K2's device time per batch;
   ``--batch`` as a subprocess, byte-equal to ``render_batch``'s encoding;
   the flagship's file stream (bit-equal to the block loop, K1 once per
   block) with its ``BlockTimer`` snapshot; the pipelined step (bit-equal
   to the synchronous one shifted by a block); a session saved at block 150
   and resumed on the card (bit-equal) and on the CPU; an uploaded IR and a
   learned noise profile streamed card vs CPU; ``--checkpoint`` SIGKILLed
   and ``--resume``d, byte-equal to an uninterrupted run (K1 once per 4096
   superblock); ``process_wav_file`` of the demo with a fake websocket.

10. the multi-session pool (``aefs_tpu_torch.server.pool``): K1's and K3's
   slot grids against their plain steps and against S = 1 launches, bit for
   bit per slot, at S = 1, 16 and 64 over 40 blocks, timed beside their
   bound; a flagship ``SessionPool`` of 16 slots over 150 blocks (every
   slot its own stream and params, an ``update_param``, a release and a new
   claim at block 75) against each session's solo chain on the card, a
   dedicated pool (bit for bit) and the CPU pool, with K1 once per pool
   step and the kernels per pool step against the solo step's; pool step
   p50/p99, synchronous and pipelined, at S = 1, 16 and 64 for the
   flagship, "Lush Chorus" and "Rain Delay", the largest S within the
   5.33 ms deadline (streams per card) and the device busy share of a
   step; a ``MultiPool`` of two buckets (migration, a join, an
   ``update_param`` through the id map), bit for bit against dedicated
   pools; ``PoolServer.handler`` driven by a fake websocket.
11. the serving front, as users start it: ``server.backend.handler`` over a
   fake websocket (the flagship's ``process_file`` of the whole demo within
   one 16-bit step of ``process_offline``, ``update_param`` and
   ``reprocess_file``, ``stream_file`` equal to the engine's own file
   stream, ``plot_data`` with its analysis, ``get_stats``, sessions,
   ``set_ir``, ``learn_noise``, "Lush Chorus" streamed, a second client
   refused; K1, K2 and K3 launched); ``ui.app.serve`` over HTTP (the config
   and the assets); ``python -m aefs_tpu_torch.run`` as a subprocess (a real
   client's round trip where ``websockets`` imports, both children gone
   within 5 s of SIGTERM); the flagship's grid pool (``grid=True``) of 16
   slots over 375 blocks, each slot against its grid solo chain fed the
   pool's ``grid_phase`` and 3 slots against the CPU grid pool, K1 never
   launched, step times beside the generic pool's; ``make_mesh`` (one data
   shard per card) and ``ShardedStreams`` of 16 flagship streams (one
   graph replay per data shard a step), bit-equal to its eager step and to
   the pool.
12. sharding (``shard``) over every visible card or, with one card, four
   shards on it (``parallel/mesh.py:visible_devices`` replaced; the phase
   prints the cards and the shards' devices): ``ShardedStreams`` of the
   flagship over 16 streams on a (4, 1) mesh, 40 blocks (a semitone change
   at block 20), its graph step (one replay per shard) bit for bit against
   its eager step, the one-device runner and the pool, K1 once per shard
   per step; the same for "Lush Chorus", K3 once per shard per step; a
   (2, 2) mesh over the reverb chain and the convolution reverb (the model
   axis; over four cards each row one capture across two), graph against
   eager bit for bit and within -120 / -100 dBFS of one device; every
   shard's replay traced (``check_replay``); the synchronized step's
   p50/p99, graph and eager, over 1, 2 and 4 shards for the flagship and
   "Lush Chorus"; ``SessionPool(shard=True)`` at 16
   slots over 40 blocks (an ``update_param``, a release, a claim) against
   the unsharded pool, then step p50/p99, synchronous and pipelined, at
   S = 16 and 64 over 1, 2 and 4 shards; ``render_batch(shard=True)`` at
   F = 3, 4 and 16 demo-length files against the unsharded batch, K2 once
   per shard, with both wall times; ``--batch --shard`` as a subprocess;
   a sharded session saved, loaded and stepped.  Every data-sharded output
   is held bit for bit (a difference is printed, and fails beyond -120
   dBFS).

13. the compiled step (``step_graph``): since the streaming step and the
   pool's step are one captured CUDA graph per chain (phases 8-12 run
   through them), each of the flagship, "Lush Chorus", "Rain Delay",
   "Multiband Master", "Concert Hall (Convolution)" and "Clean Noise
   Removal" streams 40 blocks through the engine (an ``update_param`` at
   block 20) against the eager step on the card, bit for bit, with K1 and
   K3 counted once per replay; its capture seconds, kernels per replay
   against the eager step's, the graph pool's memory, and the host-clock
   p50/p99 of a synchronized step, graph and eager, in this process; then
   the flagship pool's step p50/p99 at S = 1, 16, 64 and 256, synchronous
   and pipelined.

``python3 chip_smoke.py --only shard`` runs the probe, the build and phase
12 alone, over every visible card (the default run needs one card).

Every path of phases 6-13 runs from zeroed kernel launch counters, read
just after it; each fails if a kernel it runs was not launched.  A graph
replay counts the launches its capture recorded; warm-up and capture are
set-up and count none (core/packing.py).  The last
slice's paths run none of the four kernels (their FFTs are cuFFT, as the
JAX package's are ``jnp.fft`` outside Pallas); their counts are recorded.
Phases 9 and 11 write their scratch files under ``build/chip_smoke/`` and
remove them.

Each kernel's record holds its time per wrapper call (CUDA events over
back-to-back calls, host cost included), its device-only time (the kernel
durations ``torch.profiler`` records, per call) and its bound: the larger
of the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, from this run's
shapes.  No single PyTorch call computes any of the four functions, so
``library_ms`` is null.  K1's and K3's records carry ``slot_grid``: the same
figures for one launch over S = 1, 16 and 64 slots; K2's carries
``file_grid``: one launch over F = 1, 4 and 16 demo-length files.

Any failure raises (non-zero exit).  The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.  Imports no
JAX.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline, render_batch
from aefs_tpu_torch.engine.flagship import FLAGSHIP
from aefs_tpu_torch.engine.wavio import decode_wav, encode_wav_int16, read_wav_file, write_wav_file
from aefs_tpu_torch.models.flanger import Flanger
from aefs_tpu_torch.models.octaver import Octaver
from aefs_tpu_torch.models.reverb import Reverb
from aefs_tpu_torch.models.spectral import SpectralFilter, db_to_lin
from aefs_tpu_torch.ops import kernels
from aefs_tpu_torch.ops.fftops import frame_signal
from aefs_tpu_torch.ops.kernels.biquad import biquad_step, biquad_step_plain
from aefs_tpu_torch.ops.kernels.comb import (
    comb_chunks, comb_chunks_plain, comb_sums, comb_sums_plain)
from aefs_tpu_torch.ops.kernels.flanger import flanger_file, flanger_file_plain
from aefs_tpu_torch.ops.kernels.resample import (
    chorus_step, chorus_step_plain, octaver_step, octaver_step_plain)
from aefs_tpu_torch.ops.ringbuf import comb_bank_file_chunks, comb_chunk_size
from aefs_tpu_torch.engine.checkpoint import load_session, save_session
from aefs_tpu_torch.parallel import mesh as mesh_mod
from aefs_tpu_torch.parallel.mesh import ShardedStreams, make_mesh
from aefs_tpu_torch.server import backend
from aefs_tpu_torch.server.pool import MultiPool, PoolServer, SessionPool, grid_static_overrides
from aefs_tpu_torch.ui.app import ASSETS_DIR, config_payload, serve
from aefs_tpu_torch.utils.analysis import PlotAnalyzer

ROOT = pathlib.Path(__file__).resolve().parent
DEMO = ROOT / "music" / "rain-demo.wav"
FS = 48000
BLOCK = 256
STREAM_BLOCKS = 375  # 2 s at 48 kHz
# "Multiband Master" streams 120 blocks (~100 ms each on the card, ~40 ms on
# the CPU reference): cut from 375 to keep the whole run near half its limit.
MULTIBAND_BLOCKS = 120
BUDGET_MS = 1000.0 * BLOCK / FS  # 5.33 ms per block
K2_SUM_TOL, K2_TAIL_TOL = 1e-5, 1e-4
K4_Y_TOL, K4_DAMPED_TOL = K2_SUM_TOL, K2_TAIL_TOL
DBFS_TOL = -90.0
# The file payload's analysis against the CPU's: one rounding step of the
# shipped values (0.01 dB, 1e-4 chroma) plus float32's spacing at them.
SPEC_TOL, CHROMA_TOL = 0.01 + 1e-5, 1e-4 + 1e-7
WORK = ROOT / "build" / "chip_smoke"  # scratch files of the CLI phases (gitignored)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
# float32 operations per output sample (transcendentals count one each).
# K1 at two channels: the base-4096 phase ramp 75, two distances 2, two
# Hermite reads 40, two Hann gains 8, wet 3, mono 2, blend 6; plus ~700
# once per call for the prologue (2^(s/12) in double-single, the step, its
# levels, the fold).  K3: ramp and spread 4, the delay law and its clamp 7,
# one Hermite read 20, blend 3, 1 for the sine's argument.
OCTAVER_STEP_OPS, OCTAVER_PROLOGUE_OPS = 136, 700
CHORUS_STEP_OPS = 35
CHORUS_HIST = 2408  # int((40 + 10) * 48000 / 1000) + 8
# Per comb and sample of the comb recursion: y = x + g r (2), then
# damped = h d + (1 - h) y (3, with 1 - h formed once) (K2, K4).
COMB_OPS = 5
MODULATION_PRESETS = ("Lush Chorus", "Jet Flanger", "Psychedelic Sweep", "Funky Talk",
                      "8-Bit Arcade")
LAST_SLICE_PRESETS = ("Clean Noise Removal", "Crunch", "Concert Hall (Convolution)",
                      "Glue Bus", "Master Bus", "Broadcast Voice", "Multiband Master")
# Every wrapper's launch counter, by the name the kernels' record uses.
COUNTERS = {"octaver_step": octaver_step, "comb_sums": comb_sums,
            "chorus_step": chorus_step, "comb_chunks": comb_chunks, "biquad_step": biquad_step,
            "flanger_file": flanger_file}
LAUNCHES = {k: 0 for k in COUNTERS}  # summed over the paths of phases 6-13
# The step kernels' device symbols: a graph replay's trace is held to the
# launches its capture recorded, which every replay credits (check_replay).
STEP_KERNELS = {"octaver_step": "octaver_step_kernel", "chorus_step": "chorus_step_kernel",
                "biquad_step": "biquad_step_kernel"}
GRAPH_CHECKS = {}  # graph path -> {"recorded": {...}, "traced": {...}, "kernels": [n, ...], ...}
TRACE_REPLAYS = 3  # traced replays of a graph path in one profiler session (check_replay)
TRACE_SESSIONS = 5  # profiler sessions tried while a trace holds no device record
TRACE_MARGIN_S = 0.01  # host time between a session's start and its first replay
POOL_SLOTS = 16  # the pool server's default width
SLOT_GRID_S = (1, 16, 64)
SLOT_GRID_BLOCKS = 40
POOL_PRESETS = ("flagship", "Lush Chorus", "Rain Delay")
TIMED_STEPS = 100
SWEEP_S = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# The batched render (phase 9): K2's file grid and the sweep's batch sizes.
# A batch's file i is the demo rotated by i/16 of its length (file 0 the
# demo itself), so every file is uncut and each differs.
FILE_GRID_F = (1, 4, 16)
SWEEP_ROTATIONS = 16
RENDER_SWEEP = (("flagship", FILE_GRID_F), ("Jet Flanger", (4,)), ("Lush Chorus", (4,)),
                ("Rain Delay", (4,)), ("Concert Hall (Convolution)", (4,)))
BATCH_DBFS_TOL = -120.0  # a batched file against its own render on the card
CPU_FILE_REF = {}  # the CPU port's demo render per chain, kept by file_mode


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def err_dbfs(a, b):
    e = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    return -float("inf") if e == 0 else 20.0 * float(np.log10(e))


def cuda_ms(fn, reps):
    """Mean device time per call of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes, flops, flops_per_s=F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate (float32 unless given),
    in ms."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {"bound_ms": 1000.0 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def record(max_abs_err, ms, dev_ms, plain_ms, bnd, **extra):
    """One kernel's entry of the kernels' JSON line (no library call)."""
    return {"max_abs_err": max_abs_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            **extra, "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": None}


def device_ms(fn, kernel_names, reps):
    """Device time per call of ``fn``: the summed durations of the device
    kernels whose names contain one of ``kernel_names``, under
    ``torch.profiler`` over ``reps`` calls after one warm-up call; None
    if the profiler recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ns = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == cuda and any(k in ev.name() for k in kernel_names))
    return ns / 1e6 / reps if ns else None


def count_launches(run, need=(), per_block=None, exact=None):
    """Run one path from zeroed launch counters and read them just after.
    ``need``: kernels the path must launch (at least once, or exactly
    ``per_block`` times); ``exact``: {kernel: launches} the path must make.
    Adds the counts to LAUNCHES."""
    for fn in COUNTERS.values():
        fn.launches = 0
    result = run()
    counts = {k: fn.launches for k, fn in COUNTERS.items()}
    want = {k: per_block for k in need} | dict(exact or {})
    for k, n in want.items():
        if not (counts[k] >= 1 if n is None else counts[k] == n):
            raise AssertionError(f"{k} launched {counts[k]} times on this path "
                                 f"(want {'>= 1' if n is None else n})")
    for k, v in counts.items():
        LAUNCHES[k] += v
    return result, counts


def probe(several=False):
    """The card's name and ``nvidia-smi`` line; one card unless ``several``
    (phase 12 alone runs over every visible card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; torch.cuda.is_available() is false")
    if torch.cuda.device_count() != 1 and not several:
        raise RuntimeError(f"chip_smoke drives one card; {torch.cuda.device_count()} are visible "
                           "(set CUDA_VISIBLE_DEVICES to one)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("probe", nvidia_smi=smi, device=name, torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def build():
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    phase("build", seconds=round(time.perf_counter() - t0, 3), library=str(so.relative_to(ROOT)))


def compare_runs(got, ref):
    """(bitwise, max abs difference) of two step runs: every block's output
    and every leaf of the final state."""
    (ys, st), (ys_ref, st_ref) = got, ref
    pairs = list(zip(ys, ys_ref)) + [(st[k], st_ref[k]) for k in st_ref]
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    return bitwise, err


def noise(rng, shape, dev):
    return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(dev)


# (name, N, semitones per block, n_abs set before the second block): a live
# semitone change (re-anchor by fold), blocks off the 128 grid, a 4096-sample
# superblock, and the 2^28 re-anchor from a phase just under 1 (wrap lanes).
K1_RUNS = (
    ("stream-256-glide", BLOCK, (-12.0,) * 5 + (-5.0,) * 4, None),
    ("block-200", 200, (7.0,) * 5 + (7.5,) * 3, None),
    ("superblock-4096", 4096, (-12.0,) * 2 + (12.0,) * 2, None),
    ("reanchor-2^28", BLOCK, (-12.0,) * 4, (1 << 28) - 100),
)


def octaver_run(step, dev, n, semis, n_abs_at, seed):
    """Blocks of noise through an octaver step from a noise ring (mix 0.4)."""
    rng = np.random.default_rng(seed)
    st = Octaver(FS, n, device=dev).init_state()
    st["hist"] = noise(rng, st["hist"].shape, dev)
    mix, ys = torch.tensor(0.4, device=dev), []
    for b, semi in enumerate(semis):
        if b == 1 and n_abs_at is not None:
            st = {**st, "n_abs": torch.tensor(n_abs_at, dtype=torch.int32, device=dev),
                  "base_hi": torch.tensor(0.9999, device=dev)}
        p = {"semitones": torch.tensor(semi, device=dev), "mix": mix}
        st, y = step(st, p, noise(rng, (2, n), dev))
        ys.append(y)
    return ys, st


def check_k1(dev, n_file):
    """K1 against its plain step over the runs of K1_RUNS and one +7 st
    call over the demo file's length (the file path's grid of tiles), bit
    for bit; times at the streaming shape (ring 1920, 2 x 256)."""
    worst = 0.0
    runs = K1_RUNS + (("file-plus7", n_file, (7.0,), None),)
    for i, (name, n, semis, n_abs_at) in enumerate(runs):
        got = octaver_run(octaver_step, dev, n, semis, n_abs_at, seed=10 + i)
        ref = octaver_run(octaver_step_plain, dev, n, semis, n_abs_at, seed=10 + i)
        torch.cuda.synchronize()
        same, err = compare_runs(got, ref)
        phase("k1_octaver_step_run", run=name, n=n, blocks=len(semis), bitwise=same,
              max_abs_err=err)
        if not same:
            raise AssertionError(f"K1 {name}: not bitwise equal to the plain step (max abs {err})")
        worst = max(worst, err)
    rng = np.random.default_rng(1)
    st = Octaver(FS, BLOCK, device=dev).init_state()
    size = st["hist"].shape[0]
    st["hist"] = noise(rng, size, dev)
    p = {"semitones": torch.tensor(-12.0, device=dev), "mix": torch.tensor(0.4, device=dev)}
    x = noise(rng, (2, BLOCK), dev)
    ms = cuda_ms(lambda: octaver_step(st, p, x), 2000)
    plain_ms = cuda_ms(lambda: octaver_step_plain(st, p, x), 200)
    dev_ms = device_ms(lambda: octaver_step(st, p, x), ("octaver_step_kernel",), 200)
    # Reads x, the ring and 8 scalars; writes y, the ring and 6 scalars.
    bnd = bound(4 * (2 * BLOCK + size + 8) + 4 * (2 * BLOCK + size + 6),
                OCTAVER_STEP_OPS * BLOCK + OCTAVER_PROLOGUE_OPS)
    phase("k1_octaver_step", max_abs_err=worst, bitwise=True, shape=[2, BLOCK], ring=size,
          ms=ms, device_ms=dev_ms, plain_ms=plain_ms, **bnd)
    return record(worst, ms, dev_ms, plain_ms, bnd, bitwise=True)


def flagship_combs(dev):
    """The flagship reverb's comb lags, side map, chunk and the gains of
    rt60 = 2.1 s, on ``dev``."""
    rev = Reverb(FS, 4096, file_mode=True, file_damp=0.05)
    lags = tuple(rev.comb_lags[0] + rev.comb_lags[1])
    side_of = (0,) * rev.n_combs + (1,) * rev.n_combs
    g = torch.pow(10.0, -3.0 * (torch.tensor(lags, dtype=torch.float32) / FS) / 2.1).to(dev)
    return lags, side_of, comb_chunk_size(lags), g


def check_k2(dev, demo):
    """K2 at the flagship reverb's lags over the demo's length: FIR damping
    (baked h = 0.05, the flagship's) and the log-step scan (h = 0.6)."""
    lags, side_of, c, g = flagship_combs(dev)
    x = torch.from_numpy(np.ascontiguousarray(demo.T)).to(dev)  # (2, N) real audio
    n, b = x.shape[1], len(lags)
    m = -(-n // c)
    worst, res = 0.0, {}
    for h, h_static in ((0.05, 0.05), (0.6, None)):
        ht = torch.tensor(h, dtype=torch.float32, device=dev)
        ysum, d_tail = comb_sums(x, g, ht, lags, c, side_of, 2, h_static)
        y_ref, d_ref = comb_sums_plain(x, g, ht, lags, c, side_of, 2)
        torch.cuda.synchronize()
        e_sum = float((ysum - y_ref).abs().max())
        e_tail = float((d_tail - d_ref).abs().max())
        if e_sum >= K2_SUM_TOL or e_tail >= K2_TAIL_TOL:
            raise AssertionError(f"K2 h={h}: sums {e_sum}, tail {e_tail}")
        if not (torch.isfinite(ysum).all() and torch.isfinite(d_tail).all()):
            raise AssertionError("K2 output not finite")
        run = lambda: comb_sums(x, g, ht, lags, c, side_of, 2, h_static)  # noqa: E731
        ms = cuda_ms(run, 20)
        dev_ms = device_ms(run, ("comb_bank_kernel", "comb_side_sums_kernel"), 10)
        plain_ms = cuda_ms(lambda: comb_sums_plain(x, g, ht, lags, c, side_of, 2), 3)
        # What the function needs, whichever damping the kernel runs: per
        # comb and lane the recursion's COMB_OPS, and one add into its side.
        bnd = bound(4 * (x.numel() + b + 1) + 4 * (2 * m * c + 3 * b * c),
                    b * m * c * (COMB_OPS + 1))
        worst = max(worst, e_sum, e_tail)
        res[h] = (ms, dev_ms, plain_ms, bnd)
        phase("k2_comb_sums", damping="fir" if h_static is not None else "scan", h=h,
              n=n, chunk=c, chunks=m, lags=list(lags), max_abs_err_sums=e_sum,
              max_abs_err_tail=e_tail, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
              us_per_step=1000.0 * ms / m, **bnd)
    ms, dev_ms, plain_ms, bnd = res[0.05]  # the flagship's path
    return record(worst, ms, dev_ms, plain_ms, bnd, us_per_step=1000.0 * ms / m)


def sweep_files(demo, files):
    """``files`` demo-length files: the demo rotated by i/16 of its length."""
    step = demo.shape[0] // SWEEP_ROTATIONS
    return [np.roll(demo, -i * step, axis=0) for i in range(files)]


def check_k2_file_grid(dev, demo):
    """K2 with a file axis, x (F, 2, N) at the demo's length, F = 1, 4, 16,
    the flagship's lags and FIR damping: one launch for every file, each
    file bit-equal to an F = 1 launch on its rows and within K2's bars of
    the plain version (first and last file); times beside the bound."""
    lags, side_of, c, g = flagship_combs(dev)
    ht = torch.tensor(0.05, dtype=torch.float32, device=dev)
    b = len(lags)
    res = {}
    for files in FILE_GRID_F:
        x = torch.from_numpy(np.ascontiguousarray(
            np.stack([f.T for f in sweep_files(demo, files)]))).to(dev)
        n = x.shape[-1]
        m = -(-n // c)
        run = lambda: comb_sums(x, g, ht, lags, c, side_of, 2, 0.05)  # noqa: E731
        ysum, d_tail = run()
        same = True
        for f in range(files):
            y1, d1 = comb_sums(x[f], g, ht, lags, c, side_of, 2, 0.05)
            same = same and torch.equal(ysum[f], y1) and torch.equal(d_tail[f], d1)
        worst = 0.0
        for f in sorted({0, files - 1}):
            yp, dp = comb_sums_plain(x[f], g, ht, lags, c, side_of, 2)
            e_sum = float((ysum[f] - yp).abs().max())
            e_tail = float((d_tail[f] - dp).abs().max())
            if e_sum >= K2_SUM_TOL or e_tail >= K2_TAIL_TOL:
                raise AssertionError(f"K2 F={files} file {f}: sums {e_sum}, tail {e_tail}")
            worst = max(worst, e_sum, e_tail)
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"K2 F={files}: a file differs from its F = 1 launch")
        ms = cuda_ms(run, 10)
        dev_ms = device_ms(run, ("comb_bank_kernel", "comb_side_sums_kernel"), 5)
        plain_ms = cuda_ms(lambda: comb_sums_plain(x, g, ht, lags, c, side_of, 2), 1)
        # x read once, g and h once for all files; per file the sums and tail.
        bnd = bound(4 * (x.numel() + b + 1) + 4 * files * (2 * m * c + 3 * b * c),
                    files * b * m * c * (COMB_OPS + 1))
        res[files] = {"max_abs_err": worst, "bitwise_vs_f1_launches": True, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
                      "bound_by": bnd["bound_by"]}
        phase("k2_file_grid", files=files, n=n, chunk=c, chunks=m, **res[files],
              device_ms_per_file=None if dev_ms is None else dev_ms / files,
              bytes=bnd["bytes"], flops=bnd["flops"])
    return res


def chorus_run(step, dev, n, rates, seed, base_ms=14.0, depth_ms=4.0):
    """Blocks of noise through a chorus step at the chorus's geometry
    (history 2408, two channels, spread 0.25, mix 0.5), one rate per block."""
    rng = np.random.default_rng(seed)
    st = {"hist": noise(rng, (2, CHORUS_HIST), dev), "ph_hi": torch.tensor(0.13, device=dev),
          "ph_lo": torch.tensor(0.0, device=dev)}
    fixed = {k: torch.tensor(v, device=dev) for k, v in
             (("depth_ms", depth_ms), ("base_ms", base_ms), ("mix", 0.5), ("spread", 0.25))}
    ys = []
    for rate in rates:
        st, y = step(st, {**fixed, "rate_hz": torch.tensor(rate, device=dev)},
                     noise(rng, (2, n), dev), FS)
        ys.append(y)
    return ys, st


def check_k3(dev, n_file):
    """K3 against its plain step, bit for bit: 2 x 256 blocks with a rate
    change, a delay law the clamp cuts (base 1 ms, depth 10 ms), and the demo
    file's length in one call; times at 2 x 256 and 2 x n_file."""
    runs = (("stream-2x256-rate-change", BLOCK, (0.6,) * 4 + (4.0,) * 4, 14.0, 4.0),
            ("stream-2x256-clamped", BLOCK, (2.0,) * 6, 1.0, 10.0),
            ("file-2x%d" % n_file, n_file, (0.6,), 14.0, 4.0))
    worst = 0.0
    for i, (name, n, rates, base_ms, depth_ms) in enumerate(runs):
        got = chorus_run(chorus_step, dev, n, rates, 20 + i, base_ms, depth_ms)
        ref = chorus_run(chorus_step_plain, dev, n, rates, 20 + i, base_ms, depth_ms)
        torch.cuda.synchronize()
        same, err = compare_runs(got, ref)
        phase("k3_chorus_step_run", run=name, n=n, blocks=len(rates), bitwise=same,
              max_abs_err=err)
        if not same:
            raise AssertionError(f"K3 {name}: not bitwise equal to the plain step (max abs {err})")
        worst = max(worst, err)
    res = {}
    for n, reps, plain_reps in ((BLOCK, 2000, 200), (n_file, 20, 5)):
        rng = np.random.default_rng(3)
        st = {"hist": noise(rng, (2, CHORUS_HIST), dev), "ph_hi": torch.tensor(0.13, device=dev),
              "ph_lo": torch.tensor(0.0, device=dev)}
        p = {k: torch.tensor(v, device=dev) for k, v in (("rate_hz", 0.6), ("depth_ms", 4.0),
             ("base_ms", 14.0), ("mix", 0.5), ("spread", 0.25))}
        x = noise(rng, (2, n), dev)
        ms = cuda_ms(lambda: chorus_step(st, p, x, FS), reps)
        plain_ms = cuda_ms(lambda: chorus_step_plain(st, p, x, FS), plain_reps)
        dev_ms = device_ms(lambda: chorus_step(st, p, x, FS), ("chorus_step_kernel",),
                           min(reps, 200))
        # Reads x, the history and 7 scalars; writes y, the history and 2.
        bnd = bound(4 * (x.numel() + 2 * CHORUS_HIST + 7) + 4 * (x.numel() + 2 * CHORUS_HIST + 2),
                    CHORUS_STEP_OPS * x.numel())
        res[n] = record(worst, ms, dev_ms, plain_ms, bnd, bitwise=True)
        phase("k3_chorus_step", shape=[2, n], hist=CHORUS_HIST, **res[n],
              bytes=bnd["bytes"], flops=bnd["flops"])
    return res[BLOCK]


def biquad_run(step, dev, n, params, seed):
    """Blocks of noise (two channels) through a biquad step from a noise
    state, one params dict per block (slots when the params have them)."""
    rng = np.random.default_rng(seed)
    lead = tuple(params[0]["cutoff_hz"].shape)
    st, ys = {"df1": noise(rng, lead + (2, 4), dev)}, []
    for p in params:
        st, y = step(st, p, noise(rng, lead + (2, n), dev), FS)
        ys.append(y)
    return ys, st


def biquad_params(dev, ftypes, cutoffs, q=0.707, gain_db=6.0):
    """One params dict per block: ``ftypes`` per slot, ``cutoffs`` per block."""
    t = torch.tensor(ftypes, dtype=torch.float32, device=dev)
    full = lambda v: torch.full_like(t, v)  # noqa: E731
    return [{"filter_type": t, "cutoff_hz": full(f), "q": full(q), "gain_db": full(gain_db)}
            for f in cutoffs]


def check_k5(dev):
    """K5 against its plain step, bit for bit: the seven filter types as
    seven slots over 40 blocks of a 20 Hz -> 20 kHz cutoff glide at q 10,
    and 64 slots at the 150 Hz high-pass; times at 2 x 256 (one stream, a
    low-pass as the flagship's) and at 16 slots."""
    glide = [20.0 * 1000.0 ** (b / 39) for b in range(40)]
    runs = (("glide-7-types-q10", biquad_params(dev, list(range(7)), glide, q=10.0)),
            ("pool-64-hp150", biquad_params(dev, [1] * 64, [150.0] * 8)))
    worst = 0.0
    for i, (name, params) in enumerate(runs):
        got = biquad_run(biquad_step, dev, BLOCK, params, 30 + i)
        ref = biquad_run(biquad_step_plain, dev, BLOCK, params, 30 + i)
        torch.cuda.synchronize()
        same, err = compare_runs(got, ref)
        phase("k5_biquad_step_run", run=name, blocks=len(params), bitwise=same,
              max_abs_err=err)
        if not same:
            raise AssertionError(f"K5 {name}: not bitwise equal to the plain step (max abs {err})")
        worst = max(worst, err)
    res = {}
    for slots in (None, 16):
        rng = np.random.default_rng(5)
        lead = (slots,) if slots else ()
        p = {k: torch.full(lead, v, device=dev) for k, v in
             (("filter_type", 0.0), ("cutoff_hz", 4000.0), ("q", 0.707), ("gain_db", 0.0))}
        st = {"df1": noise(rng, lead + (2, 4), dev)}
        x = noise(rng, lead + (2, BLOCK), dev)
        ms = cuda_ms(lambda: biquad_step(st, p, x, FS), 2000)
        plain_ms = cuda_ms(lambda: biquad_step_plain(st, p, x, FS), 200)
        dev_ms = device_ms(lambda: biquad_step(st, p, x, FS), ("biquad_step_kernel",), 200)
        # Reads x, the state and 4 params per slot, writes y and the state;
        # float64: v (5), 20 per level of the 8, y (4) per sample.
        rows = x.numel() // BLOCK
        bnd = bound(4 * (2 * x.numel() + 2 * 4 * rows + 4 * (slots or 1)),
                    x.numel() * (5 + 20 * 8 + 4), F64_FLOPS)
        res[slots or 1] = record(worst, ms, dev_ms, plain_ms, bnd, bitwise=True)
        phase("k5_biquad_step", shape=list(x.shape), **res[slots or 1],
              bytes=bnd["bytes"], flops=bnd["flops"])
    return {**res[1], "pool_16": res[16]}


def flanger_operands(dev, params, demo):
    """``flanger_file``'s operands for the demo (2 channels) through a
    flanger with ``params``, from a fresh state, as ``process_file`` makes
    them."""
    mdl = Flanger(FS, BLOCK, device=dev)
    p = {k: torch.tensor(float(v), device=dev) for k, v in params.items()}
    st = mdl.init_state()
    x = torch.from_numpy(np.ascontiguousarray(demo.T)).to(dev)
    xp, ca, w = mdl.operands(p, x, mdl.file_phases(st, p, x.shape[-1])[0])
    return xp, ca, w, p["feedback"], p["mix"], st["hist"]


def flanger_stretches(ca):
    """The kernel's dependent stretches on its longest row: per tile of 512
    samples, whole stretches of min(32, least ca of the tile - 2)."""
    n = ca.shape[-1]
    tiles = torch.nn.functional.pad(ca.reshape(-1, n), (0, -n % 512), value=1 << 30)
    tiles = tiles.reshape(tiles.shape[0], -1, 512)
    span = (tiles.amin(-1) - 2).clamp(1, 32)
    length = torch.full_like(span, 512)
    length[:, -1] = n - 512 * (tiles.shape[1] - 1)
    return int(((length + span - 1) // span).sum(-1).max())


def check_k6(dev, demo):
    """K6 against its plain version, bit for bit (y and v), on the
    operands of "Jet Flanger" and of a negative-feedback flanger with a
    channel spread at the demo's length (2 x 892,928 after the chunk
    padding); timed on the first beside its bound and its chain of
    dependent stretches."""
    runs = {"jet": flanger_operands(dev, DEFAULT_PRESETS["Jet Flanger"][0]["params"], demo),
            "negative-spread": flanger_operands(dev, {"rate_hz": 2.0, "depth_ms": 4.0,
                                                      "base_ms": 1.0, "feedback": -0.7,
                                                      "mix": 1.0, "spread": 0.25}, demo)}
    worst, bitwise = 0.0, True
    for name, ops in runs.items():
        got = flanger_file(*ops)
        want = flanger_file_plain(*ops)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
        worst, bitwise = max(worst, err), bitwise and same
        phase("k6_flanger_file_run", run=name, shape=list(ops[0].shape), bitwise=same,
              max_abs_err=err)
        if not same:
            raise AssertionError(f"K6 {name}: not bitwise equal to the plain version "
                                 f"(max abs {err})")
    jet = runs["jet"]
    x = jet[0]
    ms = cuda_ms(lambda: flanger_file(*jet), 50)
    dev_ms = device_ms(lambda: flanger_file(*jet), ("flanger_file_kernel",), 20)
    plain_ms = cuda_ms(lambda: flanger_file_plain(*jet), 1)
    # Reads x, ca and four weights, writes y and v: 32 bytes a sample; the
    # tap's 4 products and 3 sums, v's 2, y's 3 (1 - mix once a row).
    bnd = bound(32 * x.numel(), 12 * x.numel())
    stretches = flanger_stretches(jet[1])
    res = record(worst, ms, dev_ms, plain_ms, bnd, bitwise=bitwise, stretches_per_row=stretches,
                 ns_per_stretch=None if dev_ms is None else 1e6 * dev_ms / stretches)
    phase("k6_flanger_file", shape=list(x.shape), **res, bytes=bnd["bytes"], flops=bnd["flops"])
    return res


def check_k4(dev, demo):
    """K4 at the flagship reverb's 8 lags and its two sides over the demo
    (traced damping h = 0.25, the scan), through the entry
    ``ringbuf.comb_bank_file_chunks`` from a zeroed counter, against plain."""
    lags, side_of, _, g = flagship_combs(dev)
    x = torch.from_numpy(np.ascontiguousarray(demo.T)).to(dev)
    h = torch.tensor(0.25, dtype=torch.float32, device=dev)
    (y, damped, c), counts = count_launches(
        lambda: comb_bank_file_chunks(x, lags, g, h, side_of=side_of), need=("comb_chunks",))
    y_ref, d_ref = comb_chunks_plain(x, g, h, lags, c, side_of)
    torch.cuda.synchronize()
    e_y = float((y - y_ref).abs().max())
    e_d = float((damped - d_ref).abs().max())
    if e_y >= K4_Y_TOL or e_d >= K4_DAMPED_TOL:
        raise AssertionError(f"K4: y {e_y}, damped {e_d}")
    if not (torch.isfinite(y).all() and torch.isfinite(damped).all()):
        raise AssertionError("K4 output not finite")
    run = lambda: comb_chunks(x, g, h, lags, c, side_of)  # noqa: E731
    ms = cuda_ms(run, 20)
    dev_ms = device_ms(run, ("comb_bank_kernel",), 10)
    plain_ms = cuda_ms(lambda: comb_chunks_plain(x, g, h, lags, c, side_of), 3)
    m, b = y.shape[0], len(lags)
    # Reads x, g, h; writes y and damped; the recursion's COMB_OPS per comb and lane.
    bnd = bound(4 * (x.numel() + b + 1) + 4 * 2 * m * b * c, b * m * c * COMB_OPS)
    phase("k4_comb_chunks", n=x.shape[1], chunk=c, chunks=m, lags=list(lags),
          entry_launches=counts["comb_chunks"], max_abs_err_y=e_y, max_abs_err_damped=e_d,
          ms=ms, device_ms=dev_ms, plain_ms=plain_ms, us_per_step=1000.0 * ms / m, **bnd)
    return record(max(e_y, e_d), ms, dev_ms, plain_ms, bnd, us_per_step=1000.0 * ms / m)


def file_mode(name, cfg, audio, fs, need=()):
    """One file render path (cold, then warm from zeroed counters) on the
    card, held against the CPU port's render."""
    t0 = time.perf_counter()
    _, cold = process_offline(cfg, audio, fs, device="cuda")
    t_cold = time.perf_counter() - t0

    def warm():
        t1 = time.perf_counter()
        out = process_offline(cfg, audio, fs, device="cuda")[1]
        return out, time.perf_counter() - t1

    (out, t_warm), counts = count_launches(warm, need)
    if out.shape != (audio.shape[0], 2) or not np.all(np.isfinite(out)):
        raise AssertionError(f"file mode {name}: bad output {out.shape}")
    if not np.array_equal(out, cold):
        raise AssertionError(f"file mode {name}: two renders on the card differ")
    t0 = time.perf_counter()
    _, ref = process_offline(cfg, audio, fs, device="cpu")
    t_cpu = time.perf_counter() - t0
    CPU_FILE_REF[name] = ref
    err = err_dbfs(out, ref)
    if not err <= DBFS_TOL:
        raise AssertionError(f"file mode {name}: card vs CPU {err:.1f} dBFS > {DBFS_TOL}")
    secs = audio.shape[0] / fs
    phase("file_mode", chain=name, frames=audio.shape[0], audio_s=secs,
          wall_s_cold=t_cold, wall_s=t_warm, realtime_x=secs / t_warm, cpu_port_wall_s=t_cpu,
          launches=counts, vs_cpu_dbfs=err, peak=float(np.max(np.abs(out))))


def spectral_mask_flips(mono, threshold_db):
    """The spectral gate's hard decisions (|X| > threshold per frame and
    bin) over the demo's mono mix, on the card (cuFFT) and on the CPU
    (pocketfft): how many differ.  A flipped bin is smoothed into later
    frames, so this is what can move the card's render off the CPU's."""
    decisions = {}
    for d in ("cuda", "cpu"):
        gate = SpectralFilter(FS, BLOCK, device=d)
        x = torch.from_numpy(np.ascontiguousarray(mono[:, 0])).to(d)
        frames, _ = frame_signal(torch.zeros(gate.hop, device=d), x, gate.n_fft, gate.hop)
        mag = torch.abs(torch.fft.rfft(frames * gate.window))
        decisions[d] = (mag > db_to_lin(torch.tensor(float(threshold_db), device=d))).cpu()
    flips = int((decisions["cuda"] != decisions["cpu"]).sum())
    phase("spectral_mask", threshold_db=threshold_db, decisions=decisions["cpu"].numel(),
          above=int(decisions["cpu"].sum()), flips=flips)


def streaming(name, cfg, mono, kernel=None, n_blocks=STREAM_BLOCKS):
    """``n_blocks`` blocks through the card's engine from zeroed counters
    (``kernel``, if the path has one, launched exactly once per block),
    against the CPU engine."""
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(n_blocks)]
    eng = AudioEngine(device="cuda")
    eng.build_chain(cfg)

    def run():
        lat, outs = [], []
        for blk in blocks:
            t0 = time.perf_counter()
            outs.append(eng.process_stream_block(blk))  # returns host audio: synchronized
            lat.append(1000.0 * (time.perf_counter() - t0))
        return lat, outs

    (lat, outs), counts = count_launches(run, need=(kernel,) if kernel else (),
                                         per_block=n_blocks)
    check_replay(f"engine {name}", eng._runner)
    got = np.concatenate(outs)
    if got.shape != (n_blocks * BLOCK, 2) or not np.all(np.isfinite(got)):
        raise AssertionError(f"streaming {name}: bad output {got.shape}")
    ref_eng = AudioEngine(device="cpu")
    ref_eng.build_chain(cfg)
    t0 = time.perf_counter()
    ref = np.concatenate([ref_eng.process_stream_block(b) for b in blocks])
    t_cpu = time.perf_counter() - t0
    err = err_dbfs(got, ref)
    if not err <= DBFS_TOL:
        raise AssertionError(f"streaming {name}: card vs CPU {err:.1f} dBFS > {DBFS_TOL}")
    lat_sorted = sorted(lat)
    p99 = lat_sorted[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    phase("streaming", chain=name, blocks=n_blocks, block=BLOCK, launches=counts,
          vs_cpu_dbfs=err, median_ms=statistics.median(lat), p99_ms=p99,
          max_ms=max(lat), first_ms=lat[0], budget_ms=BUDGET_MS,
          within_budget_share=sum(t <= BUDGET_MS for t in lat) / len(lat),
          cpu_engine_wall_s=t_cpu)


# -- the session layer and the CLI's batch and resumable modes ---------------

def timed_phase(fn):
    """Run one phase and return its wall time in seconds with its result."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def demo_files(demo):
    """The three ragged files of the batch phases: the demo uncut, its
    first 10 s and its last 7 s."""
    return [demo, demo[:10 * FS], demo[-7 * FS:]]


def batch_render(name, cfg, files, need):
    """``render_batch`` on the card from zeroed counters (after one cold
    call), each output against ``process_offline`` on the card and the CPU
    port's ``render_batch``."""
    render_batch(cfg, files, FS, device="cuda")  # cold: allocator, cuFFT plans

    def warm():
        t0 = time.perf_counter()
        out = render_batch(cfg, files, FS, device="cuda")
        return out, time.perf_counter() - t0

    (outs, wall), counts = count_launches(warm, exact=need)
    ref_cpu = render_batch(cfg, files, FS, device="cpu")
    errs_single, errs_cpu = [], []
    for f, out, cpu in zip(files, outs, ref_cpu):
        if out.shape != (f.shape[0], 2) or not np.all(np.isfinite(out)):
            raise AssertionError(f"render_batch {name}: bad output {out.shape}")
        single = process_offline(cfg, f, FS, device="cuda")[1]
        errs_single.append(err_dbfs(out, single))
        errs_cpu.append(err_dbfs(out, cpu))
    if max(errs_single + errs_cpu) > DBFS_TOL:
        raise AssertionError(f"render_batch {name}: vs process_offline {errs_single}, "
                             f"vs CPU {errs_cpu} dBFS > {DBFS_TOL}")
    audio_s = sum(f.shape[0] for f in files) / FS
    phase("render_batch", chain=name, files=[f.shape[0] for f in files], wall_s=wall,
          audio_s=audio_s, realtime_x=audio_s / wall, launches=counts,
          vs_process_offline_dbfs=errs_single, vs_cpu_dbfs=errs_cpu)
    return outs


def profile_render(fn):
    """One call of ``fn`` under ``torch.profiler``: (device kernels, copies,
    device busy ms (the union of device intervals), K2's device ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [ev for ev in prof.profiler.kineto_results.events() if ev.device_type() == cuda]
    copies = sum(ev.name().startswith(("Memcpy", "Memset")) for ev in evs)
    k2_ns = sum(ev.duration_ns() for ev in evs
                if any(k in ev.name() for k in ("comb_bank_kernel", "comb_side_sums_kernel")))
    busy = union_ms([(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in evs])
    return len(evs) - copies, copies, busy, k2_ns / 1e6


def render_batch_sweep(demo):
    """``render_batch`` of demo-length files (``sweep_files``) on the card:
    the flagship at F = 1, 4, 16 and four presets at F = 4, each from
    zeroed counters after one cold call; every file within -120 dBFS of its
    own ``process_offline`` on the card, file 0 (the demo) within -90 dBFS
    of the CPU port's render (kept by ``file_mode``); K2 and K3 launched
    once per batch, K6 ("Jet Flanger") too.  A profiled call counts the
    device kernels and K2's device time."""
    rows = []
    for name, sizes in RENDER_SWEEP:
        cfg = FLAGSHIP if name == "flagship" else DEFAULT_PRESETS[name]
        types = {c["type"] for c in cfg}
        need = ({"comb_sums": 1} if "reverb" in types else {}) | (
            {"chorus_step": 1} if "chorus" in types else {}) | (
            {"flanger_file": 1} if "flanger" in types else {})
        for files in sizes:
            batch = sweep_files(demo, files)
            render_batch(cfg, batch, FS, device="cuda")  # cold: allocator, plans

            def warm():
                t0 = time.perf_counter()
                out = render_batch(cfg, batch, FS, device="cuda")
                return out, time.perf_counter() - t0

            (outs, wall), counts = count_launches(warm, exact=need)
            errs = []
            for f, out in zip(batch, outs):
                if out.shape != (f.shape[0], 2) or not np.all(np.isfinite(out)):
                    raise AssertionError(f"render_batch_sweep {name}: bad output {out.shape}")
                errs.append(err_dbfs(out, process_offline(cfg, f, FS, device="cuda")[1]))
            vs_cpu = err_dbfs(outs[0], CPU_FILE_REF[name])
            if max(errs) > BATCH_DBFS_TOL or vs_cpu > DBFS_TOL:
                raise AssertionError(f"render_batch_sweep {name} F={files}: vs process_offline "
                                     f"{max(errs)} dBFS (bar {BATCH_DBFS_TOL}), vs CPU "
                                     f"{vs_cpu} (bar {DBFS_TOL})")
            kernels, copies, busy, k2_ms = profile_render(
                lambda: render_batch(cfg, batch, FS, device="cuda"))
            audio_s = files * demo.shape[0] / FS
            row = {"chain": name, "files": files, "frames": demo.shape[0], "wall_s": wall,
                   "audio_s": audio_s, "realtime_x": audio_s / wall, "launches": counts,
                   "device_kernels": kernels, "device_copies": copies,
                   "device_busy_ms": busy, "device_busy_share": None if busy is None
                   else busy / (1000.0 * wall),
                   "k2_device_ms_per_call": k2_ms if "reverb" in types else None,
                   "vs_process_offline_dbfs": max(errs), "vs_cpu_dbfs": vs_cpu}
            phase("render_batch_sweep", **row)
            rows.append(row)
    return rows


def run_cli(*args):
    """``python -m aefs_tpu_torch.cli`` in a subprocess from the checkout."""
    proc = subprocess.run([sys.executable, "-m", "aefs_tpu_torch.cli", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"cli {args[:2]} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc


def cli_batch(files, work):
    """--batch over the three files as a subprocess: its WAVs equal
    ``render_batch``'s 16-bit encoding of the same decoded inputs."""
    cfg_path = work / "flagship.json"
    cfg_path.write_text(json.dumps(FLAGSHIP))
    paths = []
    for i, f in enumerate(files):
        paths.append(work / f"batch_in_{i}.wav")
        write_wav_file(str(paths[-1]), f, FS)
    decoded = [read_wav_file(str(p))[0] for p in paths]
    want = render_batch(FLAGSHIP, decoded, FS, device="cuda")
    t0 = time.perf_counter()
    proc = run_cli("--batch", work / "batch_out", *paths, "--config", cfg_path)
    wall = time.perf_counter() - t0
    for p, w in zip(paths, want):
        if (work / "batch_out" / p.name).read_bytes() != encode_wav_int16(w, FS):
            raise AssertionError(f"cli --batch: {p.name} differs from render_batch's encoding")
    phase("cli_batch", files=len(paths), byte_equal=True, subprocess_wall_s=wall,
          report=proc.stdout.strip().splitlines()[-1])


def data_url(x):
    return "data:audio/wav;base64," + base64.b64encode(encode_wav_int16(x, FS)).decode()


def file_stream(mono):
    """The flagship through ``start_file_stream(realtime=False)`` over 2 s:
    the drained playback queue is bit-equal to a fresh card engine's block
    loop, with ``octaver_step`` launched once per block."""
    x = mono[:STREAM_BLOCKS * BLOCK]
    url = data_url(x)
    decoded = decode_wav(encode_wav_int16(x, FS))[0]
    eng = AudioEngine(device="cuda")
    eng.build_chain(FLAGSHIP)

    def run():
        if not eng.start_file_stream(url, realtime=False):
            raise AssertionError("file stream did not start")
        items = []
        while True:
            item = eng.playback_queue.get(timeout=300)
            if item is None:
                return items
            items.append(item)

    items, counts = count_launches(run, need=("octaver_step",), per_block=STREAM_BLOCKS)
    eng._file_thread.join(timeout=60)
    got = np.concatenate([b for _, b in items])
    snap = eng.metrics.snapshot()
    ref_eng = AudioEngine(device="cuda")
    ref_eng.build_chain(FLAGSHIP)
    lat = []
    ref = []
    for i in range(STREAM_BLOCKS):
        t0 = time.perf_counter()
        ref.append(ref_eng.process_stream_block(decoded[i * BLOCK:(i + 1) * BLOCK]))
        lat.append(1000.0 * (time.perf_counter() - t0))
    if not np.array_equal(got, np.concatenate(ref)):
        raise AssertionError("file stream differs from the block loop on the card")
    eng.close()
    ref_eng.close()
    phase("file_stream", chain="flagship", blocks=len(items), bitwise=True, launches=counts,
          block_timer=snap, first_block_after_build_ms=lat[0],
          second_block_ms=lat[1], loop_median_ms=statistics.median(lat))


def pipelined(mono):
    """375 flagship blocks through the pipelined step: bit-equal to the
    synchronous run shifted by one block."""
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(STREAM_BLOCKS)]
    sync_eng = AudioEngine(device="cuda")
    sync_eng.build_chain(FLAGSHIP)
    sync = [sync_eng.process_stream_block(b) for b in blocks]
    eng = AudioEngine(device="cuda")
    eng.build_chain(FLAGSHIP)
    outs, counts = count_launches(
        lambda: [eng.process_stream_block_pipelined(b) for b in blocks],
        need=("octaver_step",), per_block=STREAM_BLOCKS)
    if not np.all(outs[0] == 0):
        raise AssertionError("pipelined: the priming block is not silent")
    for k in range(1, STREAM_BLOCKS):
        if not np.array_equal(outs[k], sync[k - 1]):
            raise AssertionError(f"pipelined: block {k} is not the synchronous block {k - 1}")
    phase("pipelined", chain="flagship", blocks=STREAM_BLOCKS, bitwise_shifted=True,
          launches=counts, sync_timer=sync_eng.metrics.snapshot(),
          pipelined_timer=eng.metrics.snapshot())


def session_resume(mono, work):
    """The flagship streams 300 blocks on the card and saves at block 150; a
    fresh card engine resumes and continues bit-equal, the CPU engine
    resumes the same directory and continues within DBFS_TOL."""
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(300)]
    eng = AudioEngine(device="cuda")
    eng.build_chain(FLAGSHIP)
    for b in blocks[:150]:
        eng.process_stream_block(b)
    path = str(work / "session")
    t0 = time.perf_counter()
    eng.save_session(path)
    save_s = time.perf_counter() - t0
    want = np.concatenate([eng.process_stream_block(b) for b in blocks[150:]])
    card = AudioEngine(device="cuda")
    t0 = time.perf_counter()
    card.resume_session(path)
    resume_s = time.perf_counter() - t0
    got, counts = count_launches(
        lambda: np.concatenate([card.process_stream_block(b) for b in blocks[150:]]),
        need=("octaver_step",), per_block=150)
    if not np.array_equal(got, want):
        raise AssertionError("session resume on the card is not bit-equal")
    cpu = AudioEngine(device="cpu")
    cpu.resume_session(path)
    err = err_dbfs(np.concatenate([cpu.process_stream_block(b) for b in blocks[150:]]), got)
    if not err <= DBFS_TOL:
        raise AssertionError(f"session resume: card vs CPU {err:.1f} dBFS > {DBFS_TOL}")
    phase("session_resume", chain="flagship", saved_at_block=150, continued=150,
          bitwise=True, launches=counts, vs_cpu_dbfs=err, save_s=save_s, resume_s=resume_s)


def uploads(mono):
    """An uploaded IR on "Concert Hall (Convolution)" and a noise profile
    learned from a WAV on "Clean Noise Removal": 100 streaming blocks each,
    card against the CPU engine."""
    rng = np.random.default_rng(7)
    ir = (0.2 * rng.standard_normal((FS // 2, 2))
          * np.exp(-np.arange(FS // 2) / (0.1 * FS))[:, None]).astype(np.float32)
    room = (0.02 * rng.standard_normal((FS, 1))).astype(np.float32)
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(100)]
    for preset, eid, upload in (
            ("Concert Hall (Convolution)", "convreverb", lambda e, i: e.set_ir(i, data_url(ir))),
            ("Clean Noise Removal", "spectral",
             lambda e, i: e.learn_noise(i, contents=data_url(room)))):
        cfg = DEFAULT_PRESETS[preset]
        target = next(c["effect_id"] for c in cfg if c["type"] == eid)
        outs, result = [], None
        for dev in ("cuda", "cpu"):
            eng = AudioEngine(device=dev)
            eng.build_chain(cfg)
            result = upload(eng, target)
            run = lambda: np.concatenate([eng.process_stream_block(b) for b in blocks])  # noqa: E731
            outs.append(count_launches(run)[0] if dev == "cuda" else run())
        err = err_dbfs(outs[0], outs[1])
        if not (err <= DBFS_TOL and np.all(np.isfinite(outs[0]))):
            raise AssertionError(f"uploads {preset}: card vs CPU {err:.1f} dBFS > {DBFS_TOL}")
        phase("uploads", chain=preset, upload="ir" if eid == "convreverb" else "noise_profile",
              result=result, blocks=100, vs_cpu_dbfs=err)


def cli_checkpoint(demo, work):
    """--checkpoint-every 4 over the uncut demo: an uninterrupted run (in
    this process, from zeroed counters: ``octaver_step`` once per 4096
    superblock), and a subprocess SIGKILLed once progress.json names a
    generation, then rerun with --resume: the WAVs are byte-equal."""
    from aefs_tpu_torch import cli

    src = work / "demo.wav"
    write_wav_file(str(src), demo, FS)
    cfg_path = work / "flagship.json"
    cfg_path.write_text(json.dumps(FLAGSHIP))
    common = ["--config", str(cfg_path), "--checkpoint-every", "4", "--device", "cuda"]
    superblocks = -(-demo.shape[0] // 4096)

    def ref_run():
        t0 = time.perf_counter()
        cli.main([str(src), str(work / "ref.wav"), "--checkpoint", str(work / "ck_ref"), *common])
        return time.perf_counter() - t0

    ref_s, counts = count_launches(ref_run, need=("octaver_step",), per_block=superblocks)
    ck = work / "ck"
    cmd = [sys.executable, "-m", "aefs_tpu_torch.cli", str(src), str(work / "out.wav"),
           "--checkpoint", str(ck), *common]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 300
        while not (ck / "progress.json").exists():
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"cli --checkpoint: no generation before exit "
                                     f"({proc.returncode}): {proc.stderr.read()[-2000:]}")
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stderr.close()
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"cli --checkpoint ended with {proc.returncode} before the kill")
    killed_at = json.loads((ck / "progress.json").read_text())["done_samples"]
    t0 = time.perf_counter()
    resumed = run_cli(*cmd[3:], "--resume")
    resume_s = time.perf_counter() - t0
    if "Resuming at" not in resumed.stdout:
        raise AssertionError("cli --resume did not resume")
    if (work / "out.wav").read_bytes() != (work / "ref.wav").read_bytes():
        raise AssertionError("cli --checkpoint: the resumed WAV differs")
    phase("cli_checkpoint", chain="flagship", frames=demo.shape[0], killed_at=killed_at,
          byte_equal=True, launches=counts, superblocks=superblocks,
          uninterrupted_wall_s=ref_s, resume_subprocess_wall_s=resume_s)


def wav_upload(demo):
    """The demo's data URL through ``process_wav_file`` on the card with a
    fake websocket: the payload decodes, its WAV is ``process_file_array``'s
    int16 encoding, and its analysis is within the CPU test's bars of the
    CPU ``PlotAnalyzer``."""
    class FakeWS:
        sent = []

        async def send(self, msg):
            self.sent.append(msg)

    eng = AudioEngine(device="cuda")
    eng.build_chain(FLAGSHIP)
    url = data_url(demo)
    audio = decode_wav(encode_wav_int16(demo, FS))[0]

    def run():
        t0 = time.perf_counter()
        asyncio.run(eng.process_wav_file(url, FakeWS()))
        return time.perf_counter() - t0

    wall, counts = count_launches(run, exact={"comb_sums": 1})
    if len(FakeWS.sent) != 1:
        raise AssertionError("process_wav_file sent no payload")
    msg = json.loads(FakeWS.sent[0])
    mono, processed = eng.process_file_array(audio, FS)
    wav = base64.b64decode(msg["processed_b64"].split(",")[1])
    if wav != encode_wav_int16(processed, FS) or msg["sample_rate"] != FS:
        raise AssertionError("process_wav_file: processed_b64 differs from process_file_array's")
    ref = PlotAnalyzer(FS, device="cpu").analyze_file(mono[:, 0], processed.mean(axis=1))
    worst = {"spectrum_db": 0.0, "chroma": 0.0}
    for k in ("original", "processed"):
        s_got = np.asarray(msg["analysis"][k]["spectrum_db"])
        s_ref = np.asarray(ref[k]["spectrum_db"])
        worst["spectrum_db"] = max(worst["spectrum_db"],
                                   float(np.max(np.abs(s_got - s_ref)[s_ref > -100])))
        worst["chroma"] = max(worst["chroma"], float(np.max(np.abs(
            np.subtract(msg["analysis"][k]["chroma"], ref[k]["chroma"])))))
    if worst["spectrum_db"] > SPEC_TOL or worst["chroma"] > CHROMA_TOL:
        raise AssertionError(f"process_wav_file analysis vs CPU: {worst}")
    phase("process_wav_file", chain="flagship", frames=demo.shape[0], wall_s=wall,
          payload_bytes=len(FakeWS.sent[0]), launches=counts, windows=len(s_got),
          analysis_vs_cpu=worst)


# -- phase 10: the multi-session pool ----------------------------------------

def slot_run(step, dev, kind, slots, blocks, seed):
    """``blocks`` blocks of 2 x 256 noise through a step with a leading slot
    axis, every slot with its own params: the octaver's semitones spread
    over [-24, 24] with slot 0 gliding -12 -> -5 halfway (a re-anchor
    mid-run), the last slot from n_abs = 2^28 - 300, mixes 0.1-0.9; the
    chorus's rates spread over [0.1, 9.5] with slot 0 going 0.6 -> 4.0
    halfway, depths, bases, mixes and spreads spread, the last slot's delay
    law cut by the clamp (base 1 ms, depth 10 ms)."""
    rng = np.random.default_rng(seed)
    lin = torch.linspace(0.0, 1.0, slots, device=dev)
    if kind == "octaver":
        one = Octaver(FS, BLOCK, device=dev).init_state()
        st = {k: v.expand((slots,) + v.shape).clone() for k, v in one.items()}
        st["hist"] = noise(rng, st["hist"].shape, dev)
        st["n_abs"][-1] = (1 << 28) - 300
        fixed = {"mix": 0.1 + 0.8 * lin}
    else:
        st = {"hist": noise(rng, (slots, 2, CHORUS_HIST), dev), "ph_hi": 0.9 * lin,
              "ph_lo": torch.zeros(slots, device=dev)}
        fixed = {"depth_ms": 2.0 + 8.0 * lin, "base_ms": 14.0 + 20.0 * lin,
                 "mix": 0.2 + 0.8 * lin, "spread": 0.5 * lin}
        fixed["depth_ms"][-1], fixed["base_ms"][-1] = 10.0, 1.0
    ys = []
    for b in range(blocks):
        x = noise(rng, (slots, 2, BLOCK), dev)
        if kind == "octaver":
            live = -24.0 + 48.0 * lin
            live[0] = -12.0 if b < blocks // 2 else -5.0
            p = {**fixed, "semitones": live}
        else:
            live = 0.1 + 9.4 * lin
            live[0] = 0.6 if b < blocks // 2 else 4.0
            p = {**fixed, "rate_hz": live}
        st, y = step(st, p, x)
        ys.append(y)
    torch.cuda.synchronize()
    return ys, st, p, x


def per_slot(step):
    """``step`` slot by slot without slot dims (S = 1 launches), stacked."""
    def run(st, p, x):
        outs = [step({k: v[s] for k, v in st.items()}, {k: v[s] for k, v in p.items()}, x[s])
                for s in range(x.shape[0])]
        return ({k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]},
                torch.stack([o[1] for o in outs]))
    return run


def check_slot_grids(dev):
    """K1 and K3 with S slots in one launch at S = 1, 16, 64 over 40 blocks:
    every slot bit-equal to the plain step and to an S = 1 launch on that
    slot's inputs; wrapper, device and plain times beside the bound."""
    chorus = lambda st, p, x: chorus_step(st, p, x, FS)  # noqa: E731
    chorus_plain = lambda st, p, x: chorus_step_plain(st, p, x, FS)  # noqa: E731
    kinds = {"octaver": (octaver_step, octaver_step_plain, "octaver_step_kernel"),
             "chorus": (chorus, chorus_plain, "chorus_step_kernel")}
    res = {"octaver": {}, "chorus": {}}
    for kind, (kern, plain, kname) in kinds.items():
        for slots in SLOT_GRID_S:
            got = slot_run(kern, dev, kind, slots, SLOT_GRID_BLOCKS, 50 + slots)
            ref = slot_run(plain, dev, kind, slots, SLOT_GRID_BLOCKS, 50 + slots)
            one = slot_run(per_slot(kern), dev, kind, slots, SLOT_GRID_BLOCKS, 50 + slots)
            same_plain, err = compare_runs(got[:2], ref[:2])
            same_one, err_one = compare_runs(got[:2], one[:2])
            if not (same_plain and same_one):
                raise AssertionError(f"{kind} slot grid S={slots}: plain bitwise {same_plain} "
                                     f"({err}), S=1 launches bitwise {same_one} ({err_one})")
            st, p, x = got[1], got[2], got[3]
            ms = cuda_ms(lambda: kern(st, p, x), 500)
            dev_ms = device_ms(lambda: kern(st, p, x), (kname,), 100)
            plain_ms = cuda_ms(lambda: plain(st, p, x), 20)
            if kind == "octaver":
                size = st["hist"].shape[-1]
                bnd = bound(slots * (4 * (2 * BLOCK + size + 8) + 4 * (2 * BLOCK + size + 6)),
                            slots * (OCTAVER_STEP_OPS * BLOCK + OCTAVER_PROLOGUE_OPS))
            else:
                bnd = bound(slots * (4 * (2 * BLOCK + 2 * CHORUS_HIST + 7)
                                     + 4 * (2 * BLOCK + 2 * CHORUS_HIST + 2)),
                            slots * CHORUS_STEP_OPS * 2 * BLOCK)
            res[kind][slots] = {"max_abs_err": max(err, err_one), "bitwise": True, "ms": ms,
                                "device_ms": dev_ms, "plain_ms": plain_ms,
                                "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}
            phase("pool_slot_grid", kernel=f"{kind}_step", slots=slots, blocks=SLOT_GRID_BLOCKS,
                  bitwise_vs_plain=True, bitwise_vs_s1_launches=True, **res[kind][slots],
                  bytes=bnd["bytes"], flops=bnd["flops"])
    return res


FLAGSHIP_SLOT_PARAMS = ("g", "threshold_db", lambda s: -60.0 + 2.0 * s), \
    ("o", "semitones", lambda s: (-12.0, -7.0, 12.0)[s % 3]), \
    ("f", "cutoff_hz", lambda s: 1000.0 + 500.0 * s), \
    ("d", "feedback", lambda s: 0.1 + 0.04 * s)
# The flagship pool's depth (phase 10), cut from 375 blocks to keep the whole
# run near half its time limit once phase 11 came; its change at block 75.
POOL_BLOCKS, CHANGE_AT = 150, 75
# The grid pool (phase 11): 375 blocks, the change at block 152.  The shared
# phase cycles every 15 blocks (3840 / 256), so a join at block 150 would
# start at phase 0 and not show that a new session takes the pool's phase.
GRID_CHANGE_AT = 152
CPU_POOL_SLOTS, CPU_POOL_BLOCKS = 3, 40
UPDATED_SLOT, UPDATE = 3, ("o", "semitones", 7.0)
RELEASED_SLOT = 5


def pool_streams(mono, slots, blocks):
    """Each slot's stream: the demo's mono mix from its own offset (1 s
    apart); one more for the session that claims a slot mid-run."""
    x = mono[:, 0]
    return [np.ascontiguousarray(x[s * FS:s * FS + blocks * BLOCK]).reshape(blocks, BLOCK)
            for s in range(slots + 1)]


def drive_pool(pool, streams, blocks, change_at=CHANGE_AT, slot_params=FLAGSHIP_SLOT_PARAMS,
               update=UPDATE):
    """The flagship pool's run: per-slot params, then at ``change_at`` an
    update_param on one slot and a release plus a new claim of another (the
    new session streams the extra stream).  Returns per block {slot: (N, 2)}."""
    for s in range(pool.n_slots):
        if pool.claim() != s:
            raise AssertionError("a fresh pool hands out slots in order")
        for eid, name, value in slot_params:
            if pool.update_param(s, eid, name, value(s)) is not None:
                raise AssertionError(f"update_param {eid}.{name} refused")
    outs = []
    for b in range(blocks):
        if b == change_at:
            pool.update_param(UPDATED_SLOT, *update)
            pool.release(RELEASED_SLOT)
            if pool.claim() != RELEASED_SLOT:
                raise AssertionError("the released slot was not handed out again")
        blocks_b = {s: streams[s][b] for s in range(pool.n_slots)}
        if b >= change_at:
            blocks_b[RELEASED_SLOT] = streams[pool.n_slots][b - change_at]
        outs.append(pool.step_blocks(blocks_b))
    return outs


def solo_session(dev, stream, params, blocks, update=None, grid_phase=None):
    """One session's solo chain (``Chain.process_block``) on ``dev``; with
    ``grid_phase`` = (first phase, advance, modulus), the grid chain fed the
    grid pool's shared phase from its first block on."""
    overrides = grid_static_overrides(FLAGSHIP) if grid_phase else None
    chain, state, tmap = build_chain(FLAGSHIP, FS, BLOCK, device=dev,
                                     static_overrides=overrides)
    for eid, name, value in params:
        tmap.setdefault(eid, {})[name] = value
    targets = chain.targets(tmap)
    octaver = [eid for eid, _ in chain.effects].index("o")
    x = torch.from_numpy(np.ascontiguousarray(stream[:blocks])).to(chain.device)
    ys = []
    for b in range(blocks):
        if update is not None and b == update[0]:
            tmap[update[1]][update[2]] = update[3]
            targets = chain.targets(tmap)
        if grid_phase:  # the pool's shared phase for this block, set in place
            phase0, adv, mod = grid_phase
            targets[octaver]["grid_phase"].fill_(float((phase0 + b * adv) % mod))
        state, y = chain.process_block(state, targets, x[b][None])
        ys.append(y)
    return torch.cat(ys, -1).cpu().numpy().T


def kernels_per_step(fn, steps=10):
    """(device kernels, copies, busy ms) per call of ``fn`` under
    torch.profiler, counted the way scripts/profile_port.py counts a block:
    memcpy and memset events are copies, not kernels.  (A strided copy runs
    as an elementwise kernel where a contiguous one is a memcpy, so the two
    counts trade places when a shift's pad input goes from (N,) to (S, N).)"""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = [ev for ev in prof.profiler.kineto_results.events() if ev.device_type() == cuda]
    n = sum(1 for ev in evs if not ev.name().startswith(("Memcpy", "Memset")))
    busy = union_ms([(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in evs])
    return n / steps, (len(evs) - n) / steps, busy / steps


def check_replay(path, runner):
    """Hold the launches a runner's capture recorded (which each replay
    credits to the wrappers' counters) against the device: TRACE_REPLAYS
    replays of its graph under torch.profiler, counting, for each replay,
    the step kernels whose CUPTI correlation id is that of its
    ``cudaGraphLaunch``, so each one counted ran as a node of the graph and
    not from the kernel library's own stream.

    The profiler loses device records: after the pool's timed steps on the
    H100, the first replay of a session often came back short of the
    graph's first few kernels, and now and then a whole session held no
    device record at all (less often with the pause of host time that now
    opens each session).  A graph replays the same nodes every time, so a
    step kernel is a node of it when any traced replay holds it: the check
    takes the most any replay holds, and no replay may hold more than the
    capture recorded.  A session with no device record at all is traced
    again, up to TRACE_SESSIONS times.  The static state is restored after
    it, so the path's stream goes on unchanged, and the replays credit no
    counter.  Once per graph path;
    fails on any difference."""
    if path in GRAPH_CHECKS:
        return
    graph, _, record = runner.captured
    recorded = {k: record.get(COUNTERS[k], 0) for k in STEP_KERNELS}
    cuda = torch.autograd.DeviceType.CUDA

    def sync():  # the runner's card and the side cards its graph spans
        for d in [runner.device] + runner.sides:
            torch.cuda.synchronize(d)

    for session in range(1, TRACE_SESSIONS + 1):
        with torch.cuda.device(runner.device):
            keep = [g.clone() for g in runner.sgroups]
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(TRACE_MARGIN_S)
                for _ in range(TRACE_REPLAYS):
                    graph.replay()
                    sync()
            for g, k in zip(runner.sgroups, keep):
                g.copy_(k)
            sync()
        evs = prof.profiler.kineto_results.events()
        launch = [ev.correlation_id() for ev in evs
                  if ev.device_type() != cuda and ev.name().startswith("cudaGraphLaunch")]
        if len(launch) != TRACE_REPLAYS or not all(launch):
            raise AssertionError(f"graph replay {path}: {len(launch)} cudaGraphLaunch calls "
                                 f"traced (correlation ids {launch}), {TRACE_REPLAYS} made")
        runs = [[ev.name() for ev in evs if ev.device_type() == cuda and ev.correlation_id() == c]
                for c in launch]
        if any(runs):
            break
    else:
        raise AssertionError(f"graph replay {path}: {TRACE_SESSIONS} traces held no device record")
    held = [{k: sum(sym in n for n in r) for k, sym in STEP_KERNELS.items()} for r in runs]
    traced = {k: max(h[k] for h in held) for k in STEP_KERNELS}
    if traced != recorded:
        raise AssertionError(f"graph replay {path}: the traced replays hold {held} step kernels "
                             f"among {[len(r) for r in runs]}, the capture recorded {recorded}")
    GRAPH_CHECKS[path] = {"recorded": recorded, "traced": traced,
                          "kernels": [len(r) for r in runs], "sessions": session}
    phase("graph_replay_trace", path=path, **GRAPH_CHECKS[path])


def graph_traced(kernel):
    """The graph paths whose traced replay held ``kernel``; fails if none
    did, since the credited launches of the graph paths would then rest on
    the capture's record alone."""
    n = sum(c["traced"][kernel] > 0 for c in GRAPH_CHECKS.values())
    if not n:
        raise AssertionError(f"{kernel}: no graph replay was traced with it")
    return n


def union_ms(intervals):
    """Length of the union of (start_ns, end_ns) intervals, in ms."""
    total, cur_s, cur_e = 0, None, None
    for s0, e0 in sorted(intervals):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def pool_flagship(mono):
    """The flagship SessionPool at 16 slots over 375 blocks, held against
    each session's solo chain on the card (<= -120 dBFS), a dedicated pool
    on the card (bit for bit) and the CPU pool (3 slots, 40 blocks,
    <= -90 dBFS); K1 once per pool step; kernels per pool step."""
    streams = pool_streams(mono, POOL_SLOTS, POOL_BLOCKS)
    pool = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
    t0 = time.perf_counter()
    outs, counts = count_launches(lambda: drive_pool(pool, streams, POOL_BLOCKS),
                                  need=("octaver_step",), per_block=POOL_BLOCKS)
    wall = time.perf_counter() - t0
    dedicated = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
    outs_d, counts_d = count_launches(lambda: drive_pool(dedicated, streams, POOL_BLOCKS),
                                      need=("octaver_step",), per_block=POOL_BLOCKS)
    check_replay(f"pool flagship S={POOL_SLOTS}", pool._runners[0])
    for b in range(POOL_BLOCKS):
        for s in range(POOL_SLOTS):
            if not np.array_equal(outs[b][s], outs_d[b][s]):
                raise AssertionError(f"pool block {b} slot {s}: differs from a dedicated pool")
    worst_solo, worst_cpu = -np.inf, -np.inf
    for s in range(POOL_SLOTS):
        params = [(eid, name, value(s)) for eid, name, value in FLAGSHIP_SLOT_PARAMS]
        got = np.concatenate([o[s] for o in outs])
        upd = (CHANGE_AT, *UPDATE) if s == UPDATED_SLOT else None
        span = CHANGE_AT if s == RELEASED_SLOT else POOL_BLOCKS
        want = solo_session("cuda", streams[s], params, span, upd)
        worst_solo = max(worst_solo, err_dbfs(got[:span * BLOCK], want))
    new = solo_session("cuda", streams[POOL_SLOTS], [], POOL_BLOCKS - CHANGE_AT)
    worst_solo = max(worst_solo, err_dbfs(
        np.concatenate([o[RELEASED_SLOT] for o in outs[CHANGE_AT:]]), new))
    if not worst_solo <= -120.0:
        raise AssertionError(f"pool vs solo chains: {worst_solo:.1f} dBFS > -120")
    cpu = SessionPool(FLAGSHIP, n_slots=CPU_POOL_SLOTS, device="cpu")
    for s in range(CPU_POOL_SLOTS):
        cpu.claim()
        for eid, name, value in FLAGSHIP_SLOT_PARAMS:
            cpu.update_param(s, eid, name, value(s))
    for b in range(CPU_POOL_BLOCKS):
        o = cpu.step_blocks({s: streams[s][b] for s in range(CPU_POOL_SLOTS)})
        for s in range(CPU_POOL_SLOTS):
            worst_cpu = max(worst_cpu, err_dbfs(outs[b][s], o[s]))
    if not worst_cpu <= DBFS_TOL:
        raise AssertionError(f"card pool vs CPU pool: {worst_cpu:.1f} dBFS > {DBFS_TOL}")
    x = {s: streams[s][0] for s in range(POOL_SLOTS)}
    k_pool, c_pool, busy_pool = kernels_per_step(lambda: pool.step_blocks(x))
    chain, state, tmap = build_chain(FLAGSHIP, FS, BLOCK, device="cuda")
    tg = chain.targets(tmap)
    xb = torch.from_numpy(streams[0][0][None]).to(chain.device)
    k_solo, c_solo, busy_solo = kernels_per_step(lambda: chain.process_block(state, tg, xb))
    phase("pool_flagship", slots=POOL_SLOTS, blocks=POOL_BLOCKS, wall_s=wall,
          step_ms_mean=1000.0 * wall / POOL_BLOCKS, launches=counts,
          dedicated_launches=counts_d, bitwise_vs_dedicated_pool=True,
          vs_solo_chain_dbfs=worst_solo, vs_cpu_pool_dbfs=worst_cpu,
          kernels_per_pool_step=k_pool, kernels_per_solo_step=k_solo,
          copies_per_pool_step=c_pool, copies_per_solo_step=c_solo,
          device_busy_ms_per_pool_step=busy_pool, device_busy_ms_per_solo_step=busy_solo)
    return counts


def preset_cfg(name):
    return FLAGSHIP if name == "flagship" else DEFAULT_PRESETS[name]


def timed_steps(cfg, slots, mono, steps, pipelined, need=None, grid=False, shard=False,
                per_step=1):
    """Host-clock ms of ``steps`` pool steps (every slot streaming) after 10
    warm-up steps; the synchronous step waits for its readback, the
    pipelined one for the previous step's.  Counted from zeroed launch
    counters when ``need`` names the path's kernel (``per_step`` launches a
    step: one per shard)."""
    pool = SessionPool(cfg, n_slots=slots, device="cuda", grid=grid, shard=shard)
    x = mono[:, 0]
    blocks = [{s: x[(b * slots + s) * BLOCK % (x.shape[0] - BLOCK):][:BLOCK]
               for s in range(slots)} for b in range(steps + 10)]
    step = pool.step_blocks_pipelined if pipelined else pool.step_blocks
    for b in blocks[:10]:
        step(b)

    def run():
        lat = []
        for b in blocks[10:]:
            t0 = time.perf_counter()
            step(b)
            lat.append(1000.0 * (time.perf_counter() - t0))
        return lat

    lat, counts = count_launches(run, need=(need,) if need else (), per_block=steps * per_step)
    if pipelined:
        pool.flush_pipeline()
    for i, runner in enumerate(pool._runners):
        check_replay(f"pool {pool.chain.label()} S={slots}{' grid' if grid else ''}"
                     f"{f' shard {i}' if shard else ''}", runner)
    lat.sort()
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    return {"p50_ms": statistics.median(lat), "p99_ms": p99, "max_ms": lat[-1],
            "launches": counts}, pool


def pool_timing(mono):
    """Pool step p50/p99 (synchronous and pipelined) at S = 1, 16, 64 for
    the flagship, "Lush Chorus" and "Rain Delay"; the largest S of a
    doubling sweep (S = 1 .. 256) whose synchronous p99 stays within the
    deadline (streams per card); kernels per step and the device busy
    share of a step at each S."""
    need = {"flagship": "octaver_step", "Lush Chorus": "chorus_step", "Rain Delay": None}
    out = {}
    for name in POOL_PRESETS:
        cfg = preset_cfg(name)
        rows = {}
        for slots in SLOT_GRID_S:
            sync, pool = timed_steps(cfg, slots, mono, TIMED_STEPS, False, need[name])
            pipe, _ = timed_steps(cfg, slots, mono, TIMED_STEPS, True, need[name])
            xb = {s: mono[s * BLOCK:(s + 1) * BLOCK, 0] for s in range(slots)}
            kern, copies, busy = kernels_per_step(lambda: pool.step_blocks(xb))
            rows[slots] = {"sync": sync, "pipelined": pipe, "kernels_per_step": kern,
                           "copies_per_step": copies, "device_busy_ms": busy,
                           "device_busy_share": busy / sync["p50_ms"]}
            phase("pool_step", chain=name, slots=slots, deadline_ms=BUDGET_MS, **rows[slots])
        # Every S of the sweep is measured: on a host-bound step p99 is not
        # monotone in S, so the first miss does not end the search.
        sweep = {}
        for slots in SWEEP_S:
            t = rows[slots]["sync"] if slots in rows else timed_steps(
                cfg, slots, mono, TIMED_STEPS, False, need[name])[0]
            sweep[slots] = {"p50_ms": t["p50_ms"], "p99_ms": t["p99_ms"]}
        fits = max((k for k, v in sweep.items() if v["p99_ms"] <= BUDGET_MS), default=0)
        out[name] = {"streams_per_card": fits, "sweep": sweep}
        phase("pool_streams_per_card", chain=name, deadline_ms=BUDGET_MS,
              streams_per_card=fits, sweep_sync_p99=sweep)
    return out


def pool_multi(mono):
    """A MultiPool of two buckets at 16 slots: the flagship default bucket
    and "Lush Chorus".  Session A stays on the default bucket, B migrates by
    ``build_session`` and gets an ``update_param`` through its id map at
    block 8, C joins B's running bucket with its own ids and params at block
    12; each bit-equal to a dedicated pool on the card, 24 blocks."""
    lush = DEFAULT_PRESETS["Lush Chorus"]
    lush_c = [dict(c, effect_id=f"c-{c['effect_id']}", params={**c["params"], **extra})
              for c, extra in zip(lush, ({"rate_hz": 1.7, "depth_ms": 6.0}, {"rt60_s": 3.0}))]
    x = mono[:, 0]

    def run():
        mp = MultiPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
        sa, sb0 = mp.default_pool.claim(), mp.default_pool.claim()
        key_b, pool_b, sb, _, _, idmap_b = mp.build_session(lush, current=(mp.default_pool, sb0))
        if pool_b is mp.default_pool or sb is None:
            raise AssertionError("build_session did not migrate to a new bucket")
        mp.default_pool.release(sb0)
        dedicated = {k: SessionPool(c, n_slots=POOL_SLOTS, device="cuda")
                     for k, c in (("a", FLAGSHIP), ("b", lush), ("c", lush_c))}
        ra, rb = dedicated["a"].claim(), dedicated["b"].claim()
        sc = rc = None
        for b in range(24):
            xa, xb, xc = (x[(3 * b + k) * BLOCK:(3 * b + k + 1) * BLOCK] for k in range(3))
            if b == 8:
                pool_b.update_param(sb, idmap_b["lc1"], "rate_hz", 2.5)
                dedicated["b"].update_param(rb, "lc1", "rate_hz", 2.5)
            if b == 12:
                key_c, pool_c, sc, _, _, idmap_c = mp.build_session(lush_c)
                if pool_c is not pool_b or key_c != key_b or sc in (None, sb):
                    raise AssertionError("session C did not join B's bucket")
                rc = dedicated["c"].claim()
            oa = mp.default_pool.step_blocks({sa: xa})[sa]
            ob = pool_b.step_blocks({sb: xb} | ({sc: xc} if sc is not None else {}))
            pairs = [(oa, dedicated["a"].step_blocks({ra: xa})[ra]),
                     (ob[sb], dedicated["b"].step_blocks({rb: xb})[rb])]
            if sc is not None:
                pairs.append((ob[sc], dedicated["c"].step_blocks({rc: xc})[rc]))
            for got, want in pairs:
                if not np.array_equal(got, want):
                    raise AssertionError(f"MultiPool block {b}: a session differs from its "
                                         "dedicated pool")
        return len(mp.buckets())

    n_buckets, counts = count_launches(run, need=("octaver_step", "chorus_step"))
    phase("pool_multipool", buckets=n_buckets, slots=POOL_SLOTS, blocks=24, bitwise=True,
          launches=counts)


class FakeWebSocket:
    """An in-process websocket: an async iterator over the client's
    messages and a ``send`` that records the server's replies with their
    arrival times.  Each message is (msg, waits): ``waits`` False sends the
    next one at once, True waits for any reply, a type name for a reply of
    that type (others, such as plot_data, interleave).  ``msg`` may also be
    a function (a coroutine function is awaited), run in its place."""

    def __init__(self, messages):
        self.messages = messages
        self.sent = []
        self.times = []
        self._replied = asyncio.Event()

    async def send(self, msg):
        self.sent.append(json.loads(msg))
        self.times.append(time.perf_counter())
        self._replied.set()

    def __aiter__(self):
        return self._gen()

    async def _reply(self, kind, start):
        """The first reply from index ``start`` on of type ``kind`` (any
        type if ``kind`` is True), waiting for it."""
        while True:
            for i in range(start, len(self.sent)):
                if kind is True or self.sent[i]["type"] == kind:
                    return i
            self._replied.clear()
            await asyncio.wait_for(self._replied.wait(), 300)

    async def _gen(self):
        for msg, waits in self.messages:
            if callable(msg):
                res = msg()
                if asyncio.iscoroutine(res):
                    await res
                continue
            start = len(self.sent)
            yield json.dumps(msg)
            if waits:
                await self._reply(waits, start)


def pool_server(mono):
    """``PoolServer.handler`` over a fake websocket on a 16-slot flagship
    pool: session_ready, stream_block -> processed_block (against a
    dedicated pool), build_chain -> chain_built ("Lush Chorus"),
    update_param with ack, get_pool_stats, and "pool full"."""
    x = mono[:, 0]
    blocks = [x[i * BLOCK:(i + 1) * BLOCK] for i in range(12)]
    msgs = [({"command": "stream_block", "audio": b.tolist()}, True) for b in blocks[:6]]
    msgs += [({"command": "update_param", "effect_id": "o", "param": "semitones",
               "value": 5.0, "ack": True}, True),
             ({"command": "build_chain", "effects_config": DEFAULT_PRESETS["Lush Chorus"]}, True)]
    msgs += [({"command": "stream_block", "audio": b.tolist()}, True) for b in blocks[6:]]
    msgs += [({"command": "get_pool_stats"}, True)]

    async def scenario():
        pool = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
        srv = PoolServer(pool)
        batcher = asyncio.create_task(srv.batcher())
        try:
            client = FakeWebSocket(msgs)
            await srv.handler(client)
            held = [pool.claim() for _ in range(POOL_SLOTS)]
            refused = FakeWebSocket([])
            await srv.handler(refused)
            for s in held:
                pool.release(s)
        finally:
            batcher.cancel()
            for task in srv._tasks.values():
                task.cancel()
        return client.sent, refused.sent

    (sent, refused), counts = count_launches(lambda: asyncio.run(scenario()),
                                             need=("octaver_step", "chorus_step"))
    kinds = [m["type"] for m in sent]
    want = (["session_ready"] + ["processed_block"] * 6 + ["param_ack", "chain_built"]
            + ["processed_block"] * 6 + ["pool_stats"])
    if kinds != want or refused != [{"type": "error", "error": "pool full"}]:
        raise AssertionError(f"pool server replies {kinds}, refused {refused}")
    ref = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
    r = ref.claim()
    for i, m in enumerate(sent[1:7]):
        want_out = ref.step_blocks({r: blocks[i]})[r]
        got = np.stack([m["output"], m["output_r"]], 1)
        if err_dbfs(got, want_out) > DBFS_TOL:  # the JSON carries 5 significant digits
            raise AssertionError(f"processed_block {i} differs from a dedicated pool")
    stats = sent[-1]
    if not (sent[7]["ok"] and stats["n_buckets"] == 2 and isinstance(stats["realtime_ok"], bool)
            and stats["step_ms"] > 0):
        raise AssertionError(f"pool server: ack {sent[7]}, stats {stats}")
    phase("pool_server", replies=len(sent), launches=counts, step_ms=stats["step_ms"],
          realtime_ok=stats["realtime_ok"], total_step_ms=stats["total_step_ms"],
          buckets=stats["buckets"])


# -- phase 11: the serving front ------------------------------------------------

# The grid pool's per-slot params: the octaver's semitones are baked there
# (update_param refuses them), so its mix takes their place.
GRID_SLOT_PARAMS = (("g", "threshold_db", lambda s: -60.0 + 2.0 * s),
                    ("o", "mix", lambda s: 0.2 + 0.04 * s),
                    ("f", "cutoff_hz", lambda s: 1000.0 + 500.0 * s),
                    ("d", "feedback", lambda s: 0.1 + 0.04 * s))
GRID_UPDATE = ("o", "mix", 0.9)
LUSH_STREAM_BLOCKS = 60
LAUNCHER_CLIP_S = 2
MESH_BLOCKS = 40


def collapse_runs(kinds):
    """Reply types with runs of stream_audio (however the pump batched the
    blocks) written once."""
    return [k for i, k in enumerate(kinds)
            if k != "stream_audio" or i == 0 or kinds[i - 1] != "stream_audio"]


def wav_steps(msg, ref):
    """How far the WAV a file_processed message carries is from ``ref``
    (frames, 2) written as a 16-bit WAV, in 16-bit steps (max over samples)."""
    got = decode_wav(base64.b64decode(msg["processed_b64"].split(",")[1]))[0]
    want = decode_wav(encode_wav_int16(ref, FS))[0]
    if got.shape != want.shape:
        raise AssertionError(f"WAV of {got.shape}, want {want.shape}")
    return float(np.max(np.abs(got - want))) * 32768.0


def backend_handler(demo, mono, work):
    """``backend.handler`` (the WebSocket backend the UI talks to) on the card
    over a fake websocket: the flagship's process_file of the whole demo
    (its WAV within one 16-bit step of ``process_offline`` on the card), an
    update_param and reprocess_file, stream_file (equal, after the wire's 5
    digits, to ``AudioEngine.start_file_stream`` driven directly), plot_data
    with its analysis, get_stats, save_session / resume_session, set_ir and
    learn_noise, "Lush Chorus" streamed, and a second client refused."""
    from aefs_tpu_torch import native

    os.environ["AEFS_SESSIONS_DIR"] = str(work / "sessions")
    rng = np.random.default_rng(7)
    ir = (0.2 * rng.standard_normal((FS // 2, 2))
          * np.exp(-np.arange(FS // 2) / (0.1 * FS))[:, None]).astype(np.float32)
    room = (0.02 * rng.standard_normal((FS, 1))).astype(np.float32)
    stream_url = data_url(mono[:STREAM_BLOCKS * BLOCK])
    fx = DEFAULT_PRESETS["Clean Noise Removal"] + DEFAULT_PRESETS["Concert Hall (Convolution)"]
    update = ("d", "feedback", 0.5)
    stamps, refused = {}, []

    async def second_client():
        late = FakeWebSocket([({"command": "get_stats"}, False)])
        await backend.handler(late)
        refused.append(late.sent)

    msgs = [({"command": "build_chain", "config": FLAGSHIP}, False),
            (lambda: stamps.setdefault("file", time.perf_counter()), False),
            ({"command": "process_file", "contents": data_url(demo)}, "file_processed"),
            ({"command": "update_param", "effect_id": update[0], "param": update[1],
              "value": update[2]}, False),
            ({"command": "reprocess_file"}, "file_processed"),
            ({"command": "stream_file", "contents": stream_url, "realtime": False},
             "stream_audio_end"),
            ({"command": "get_stats"}, "stats"),
            ({"command": "save_session", "path": "flagship"}, "session_saved"),
            ({"command": "resume_session", "path": "flagship"}, "session_resumed"),
            ({"command": "build_chain", "config": fx}, False),
            ({"command": "set_ir", "effect_id": "cv1", "contents": data_url(ir)}, "ir_set"),
            ({"command": "learn_noise", "effect_id": "p6", "contents": data_url(room)},
             "noise_learned"),
            ({"command": "build_chain", "config": DEFAULT_PRESETS["Lush Chorus"]}, False),
            ({"command": "stream_file", "contents": data_url(mono[:LUSH_STREAM_BLOCKS * BLOCK]),
              "realtime": False}, "stream_audio_end"),
            (second_client, False)]
    client = FakeWebSocket(msgs)

    def run():
        t0 = time.perf_counter()
        asyncio.run(backend.handler(client))
        return time.perf_counter() - t0

    wall, counts = count_launches(run, need=("octaver_step", "comb_sums", "chorus_step"))
    if backend.connected_client is not None:
        raise AssertionError("backend: the client slot was not freed")
    kinds = [m["type"] for m in client.sent if m["type"] != "plot_data"]
    want = ["file_processed", "file_processed", "stream_started", "stream_audio",
            "stream_audio_end", "stats", "session_saved", "session_resumed", "ir_set",
            "noise_learned", "stream_started", "stream_audio", "stream_audio_end"]
    if collapse_runs(kinds) != want or refused != [[]]:
        raise AssertionError(f"backend replies {collapse_runs(kinds)}, second client {refused}")
    replies = [m for m in client.sent if m["type"] != "plot_data"]
    files = [i for i, m in enumerate(client.sent) if m["type"] == "file_processed"]
    file_s = client.times[files[0]] - stamps["file"]
    audio = decode_wav(encode_wav_int16(demo, FS))[0]
    cfg2 = json.loads(json.dumps(FLAGSHIP))
    next(c for c in cfg2 if c["effect_id"] == update[0])["params"][update[1]] = update[2]
    file_steps = [wav_steps(client.sent[i], process_offline(cfg, audio, FS, device="cuda")[1])
                  for i, cfg in zip(files, (FLAGSHIP, cfg2))]
    if max(file_steps) > 1:
        raise AssertionError(f"backend process_file: {file_steps} 16-bit steps from "
                             "process_offline")
    # The first stream against the engine's own file stream, same chain and update.
    eng = AudioEngine(device="cuda")
    eng.build_chain(FLAGSHIP)
    eng.update_param(*update)
    if not eng.start_file_stream(stream_url, realtime=False):
        raise AssertionError("direct file stream did not start")
    items = []
    while (item := eng.playback_queue.get(timeout=300)) is not None:
        items.append(item)
    eng.close()
    ref = np.concatenate([b for _, b in items])
    end = kinds.index("stream_audio_end")
    streamed = [m for m in replies[:end] if m["type"] == "stream_audio"]
    for ch, key in ((0, "left"), (1, "right")):
        got = [v for m in streamed for v in m[key]]
        if got != json.loads(native.json_f32_array(ref[:, ch])):
            raise AssertionError(f"backend stream_file {key}: differs from the engine's stream")
    plots = [m for m in client.sent if m["type"] == "plot_data"]
    if not plots or not any("analysis" in m for m in plots):
        raise AssertionError("backend: no plot_data with its analysis")
    stats = next(m for m in replies if m["type"] == "stats")["engine"]
    oks = {m["type"]: m["ok"] for m in replies
           if m["type"] in ("session_saved", "session_resumed", "ir_set", "noise_learned")}
    if not all(oks.values()):
        raise AssertionError(f"backend replies not ok: {oks}")
    audio_s = demo.shape[0] / FS
    phase("backend_handler", wall_s=wall, launches=counts, replies=len(client.sent),
          plot_data=len(plots), process_file_s=file_s, process_file_realtime_x=audio_s / file_s,
          file_vs_process_offline_16bit_steps=file_steps, stream_blocks=len(items),
          stream_messages=len(streamed), stream_equal_to_engine=True,
          stream_p50_ms=stats.get("p50_ms"), stream_p99_ms=stats.get("p99_ms"),
          stream_xruns=stats.get("xruns"), stats=stats, ok=oks, second_client_refused=True)


def http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def ui_server():
    """``ui.app.serve`` on a free port: /, /config.json and an asset over
    HTTP; the config is ``config_payload()``, the bytes are the repository's
    aefs_tpu/ui/assets/ files."""
    assets = ROOT / "aefs_tpu" / "ui" / "assets"
    if pathlib.Path(ASSETS_DIR).resolve() != assets.resolve():
        raise AssertionError(f"the UI serves {ASSETS_DIR}, not {assets}")
    httpd = serve(port=0, blocking=False)
    port = httpd.server_address[1]
    try:
        t0 = time.perf_counter()
        index, cfg, app_js = (http_get(port, p) for p in ("/", "/config.json", "/app.js"))
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    if (index != (assets / "index.html").read_bytes() or app_js != (assets / "app.js").read_bytes()
            or json.loads(cfg) != json.loads(json.dumps(config_payload()))):
        raise AssertionError("ui server: a payload differs from its source")
    phase("ui_server", port=port, fetch_s=wall, index_bytes=len(index), config_bytes=len(cfg),
          asset_bytes=len(app_js))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def alive(pid):
    """Whether ``pid`` runs (a zombie left to a parent that does not reap
    counts as gone)."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


async def ws_file_round_trip(port, clip):
    """A real websockets client: build_chain flagship, process_file of
    ``clip``; returns the file_processed message."""
    import websockets

    for _ in range(600):
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}", max_size=2**29) as client:
                await client.send(json.dumps({"command": "build_chain", "config": FLAGSHIP}))
                await client.send(json.dumps({"command": "process_file",
                                              "contents": data_url(clip)}))
                while True:
                    msg = json.loads(await asyncio.wait_for(client.recv(), 300))
                    if msg["type"] == "file_processed":
                        return msg
        except OSError:
            await asyncio.sleep(0.2)
    raise AssertionError("launcher: the backend never accepted a connection")


def launcher(demo, work):
    """``python -m aefs_tpu_torch.run`` on free ports, on the card.  With
    ``websockets`` importable, one real client's build_chain + process_file
    round trip (the WAV within one 16-bit step of ``process_offline``);
    without it the backend child exits at start, and the launcher must say so
    and tear the UI down (a stated skip of the round trip).  Either way the
    launcher is SIGTERMed if still running and both children are gone
    within 5 s."""
    try:
        import websockets
        have_ws = f"present {websockets.__version__}"
    except ImportError:
        have_ws = "absent"
    print(f"websockets: {have_ws}", flush=True)
    bport, uport = free_port(), free_port()
    log = work / "launcher.log"
    env = {k: v for k, v in os.environ.items() if k != "AEFS_PLATFORM"}
    clip = demo[:LAUNCHER_CLIP_S * FS]
    round_trip = None
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "aefs_tpu_torch.run", "--backend-port",
                                 str(bport), "--ui-port", str(uport)],
                                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        if have_ws != "absent":
            t1 = time.perf_counter()
            msg = asyncio.run(ws_file_round_trip(bport, clip))
            round_trip = time.perf_counter() - t1
            if json.loads(http_get(uport, "/config.json"))["ws_port"] != bport:
                raise AssertionError("launcher: the UI names another backend port")
            ref = process_offline(FLAGSHIP, decode_wav(encode_wav_int16(clip, FS))[0], FS,
                                  device="cuda")[1]
            if wav_steps(msg, ref) > 1:
                raise AssertionError("launcher: the backend's WAV differs from process_offline")
        else:
            proc.wait(timeout=120)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log.read_text()
    pids = [int(p) for p in re.findall(r"\(pid (\d+)\)", text)]
    deadline = time.monotonic() + 5
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    if len(pids) != 2 or any(alive(p) for p in pids):
        raise AssertionError(f"launcher: children {pids} not gone: {text[-2000:]}")
    if have_ws == "absent" and "Service 'backend' exited" not in text:
        raise AssertionError(f"launcher: a dead backend went unreported: {text[-2000:]}")
    phase("launcher", websockets=have_ws, returncode=proc.returncode, children=pids,
          children_gone=True, round_trip_s=round_trip,
          round_trip="done" if round_trip is not None else "skipped: websockets absent",
          wall_s=time.perf_counter() - t0, log_tail=text[-600:])


def pool_grid(mono, generic):
    """The flagship's grid pool (``grid=True``: the octaver's exact grid, K1
    not launched) at 16 slots over 375 blocks, per-slot params and a release
    plus a claim at GRID_CHANGE_AT that joins at the shared phase; every slot
    within -120 dBFS of its grid solo chain fed the same grid_phase, 3 slots
    x 40 blocks within -90 dBFS of the CPU grid pool; step times beside the
    generic pool's (phase 10) at 16 slots."""
    streams = pool_streams(mono, POOL_SLOTS, STREAM_BLOCKS)
    pool = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, grid=True, device="cuda")
    refusal = pool.update_param(0, "o", "semitones", 7.0)
    if not refusal or "grid-specialized" not in refusal:
        raise AssertionError(f"grid pool: semitones not refused ({refusal})")
    row = next(iter(pool._phase_rows))
    adv, mod = pool._phase_rows[row].grid_phase_advance()
    t0 = time.perf_counter()
    outs, counts = count_launches(
        lambda: drive_pool(pool, streams, STREAM_BLOCKS, GRID_CHANGE_AT, GRID_SLOT_PARAMS,
                           GRID_UPDATE),
        exact={"octaver_step": 0})
    wall = time.perf_counter() - t0
    check_replay(f"grid pool flagship S={POOL_SLOTS}", pool._runners[0])
    if not np.all(pool._tbuf[row] == (STREAM_BLOCKS * adv) % mod):
        raise AssertionError("grid pool: the shared phase row is not the pool clock")
    worst_solo, worst_cpu = -np.inf, -np.inf
    for s in range(POOL_SLOTS):
        params = [(eid, name, value(s)) for eid, name, value in GRID_SLOT_PARAMS]
        got = np.concatenate([o[s] for o in outs])
        upd = (GRID_CHANGE_AT, *GRID_UPDATE) if s == UPDATED_SLOT else None
        span = GRID_CHANGE_AT if s == RELEASED_SLOT else STREAM_BLOCKS
        want = solo_session("cuda", streams[s], params, span, upd, grid_phase=(0, adv, mod))
        worst_solo = max(worst_solo, err_dbfs(got[:span * BLOCK], want))
    joined_at = (GRID_CHANGE_AT * adv) % mod
    new = solo_session("cuda", streams[POOL_SLOTS], [], STREAM_BLOCKS - GRID_CHANGE_AT,
                       grid_phase=(joined_at, adv, mod))
    worst_solo = max(worst_solo, err_dbfs(
        np.concatenate([o[RELEASED_SLOT] for o in outs[GRID_CHANGE_AT:]]), new))
    if not worst_solo <= -120.0:
        raise AssertionError(f"grid pool vs solo chains: {worst_solo:.1f} dBFS > -120")
    cpu = SessionPool(FLAGSHIP, n_slots=CPU_POOL_SLOTS, grid=True, device="cpu")
    for s in range(CPU_POOL_SLOTS):
        cpu.claim()
        for eid, name, value in GRID_SLOT_PARAMS:
            cpu.update_param(s, eid, name, value(s))
    for b in range(CPU_POOL_BLOCKS):
        o = cpu.step_blocks({s: streams[s][b] for s in range(CPU_POOL_SLOTS)})
        for s in range(CPU_POOL_SLOTS):
            worst_cpu = max(worst_cpu, err_dbfs(outs[b][s], o[s]))
    if not worst_cpu <= DBFS_TOL:
        raise AssertionError(f"card grid pool vs CPU grid pool: {worst_cpu:.1f} dBFS > {DBFS_TOL}")
    timed, tpool = timed_steps(FLAGSHIP, POOL_SLOTS, mono, TIMED_STEPS, False, grid=True)
    if timed["launches"]["octaver_step"]:
        raise AssertionError("grid pool: K1 launched in the timed steps")
    x = {s: streams[s][0] for s in range(POOL_SLOTS)}
    kern, copies, busy = kernels_per_step(lambda: tpool.step_blocks(x))
    phase("pool_grid", slots=POOL_SLOTS, blocks=STREAM_BLOCKS, wall_s=wall, launches=counts,
          vs_solo_chain_dbfs=worst_solo, vs_cpu_pool_dbfs=worst_cpu,
          joined_at_phase=joined_at, final_phase=int(pool._tbuf[row, 0]), kernels_per_step=kern, copies_per_step=copies,
          device_busy_ms=busy, step_p50_ms=timed["p50_ms"], step_p99_ms=timed["p99_ms"],
          generic_pool_step_p50_ms=generic["flagship"]["sweep"][POOL_SLOTS]["p50_ms"],
          generic_pool_step_p99_ms=generic["flagship"]["sweep"][POOL_SLOTS]["p99_ms"],
          deadline_ms=BUDGET_MS)


def drive_streams(runner, maps, xs, per_stream=True, eager=False, change=None, exact=None):
    """``ShardedStreams`` ``runner`` over the (S, 1, N) blocks ``xs`` from a
    fresh state (after one discarded warm step: the step is functional, the
    held state stays fresh), the graph step or with ``eager`` the eager
    one, from zeroed launch counters (``exact``: {kernel: launches}).
    ``maps``: each stream's targets map (``per_stream``) or maps[0] for all;
    ``change`` = (block, fn) edits the maps before that block.  Checks the
    peak meter against max |y| every block.  Returns (outputs, wall
    seconds, counts, final state)."""
    def targets():
        return runner.batch_targets(maps) if per_stream else runner.chain.targets(maps[0])

    state, _ = runner.init_state()
    tg = targets()
    runner.run_block(state, tg, xs[0], per_stream_targets=per_stream, eager=eager)[1].cpu()

    def run():
        nonlocal state, tg
        outs, t0 = [], time.perf_counter()
        for k, x in enumerate(xs):
            if change and k == change[0]:
                change[1](maps)
                tg = targets()
            state, y, peak = runner.run_block(state, tg, x, per_stream_targets=per_stream,
                                              eager=eager)
            y = y.cpu().numpy()
            if float(peak) != float(np.max(np.abs(y))):
                raise AssertionError(f"ShardedStreams {runner.chain.label()}: peak is not max |y|")
            outs.append(y)
        return outs, time.perf_counter() - t0

    (outs, wall), counts = count_launches(run, exact=exact)
    return outs, wall, counts, state


def check_shard_replays(path, runner):
    """``check_replay`` for each data shard's graph of a ``ShardedStreams``."""
    for i, r in enumerate(runner._runners):
        check_replay(f"{path} shard {i}", r)


def graph_equals_eager(what, got, want):
    """A graph step's outputs against the eager step's, bit for bit."""
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        worst = max(err_dbfs(a, b) for a, b in zip(got, want))
        raise AssertionError(f"{what}: the graph step is {worst:.1f} dBFS from the eager step")
    return True


def mesh(mono):
    """``make_mesh`` on the card and ``ShardedStreams`` of the flagship over
    16 streams with per-stream targets, 40 blocks, one graph replay per
    data shard a step: bit-equal to the eager step and to a
    ``SessionPool`` given the same params, the peak meter max |y|, K1 once
    per shard per step."""
    m = make_mesh()
    if m.shape != {"data": torch.cuda.device_count(), "model": 1}:
        raise AssertionError(f"make_mesh() over {torch.cuda.device_count()} card(s): {m.shape}")
    try:
        make_mesh(2)
    except ValueError as e:
        too_few = str(e)
    else:
        raise AssertionError("make_mesh(2) did not raise on one card")
    chain, _, tmap = build_chain(FLAGSHIP, FS, BLOCK, device="cuda")
    pool = SessionPool(FLAGSHIP, n_slots=POOL_SLOTS, device="cuda")
    for s in range(POOL_SLOTS):
        pool.claim()
        for eid, name, value in FLAGSHIP_SLOT_PARAMS:
            pool.update_param(s, eid, name, value(s))
    streams = pool_streams(mono, POOL_SLOTS, MESH_BLOCKS)
    xs = [np.stack([streams[s][b] for s in range(POOL_SLOTS)])[:, None, :]
          for b in range(MESH_BLOCKS)]
    runs = {}
    for mode in ("graph", "eager"):
        runner = ShardedStreams(chain, m, POOL_SLOTS)
        runs[mode] = drive_streams(runner, flagship_maps(tmap, POOL_SLOTS), xs,
                                   eager=mode == "eager",
                                   exact={"octaver_step": MESH_BLOCKS * m.shape["data"]})
        if mode == "graph":
            check_shard_replays("mesh flagship", runner)
    outs, wall, counts, _ = runs["graph"]
    graph_equals_eager("mesh flagship", outs, runs["eager"][0])
    for b, y in enumerate(outs):
        want = pool.step_blocks({s: streams[s][b] for s in range(POOL_SLOTS)})
        if not all(np.array_equal(y[s].T, want[s]) for s in range(POOL_SLOTS)):
            raise AssertionError(f"ShardedStreams block {b}: differs from the pool")
    phase("mesh", shape=m.shape, make_mesh_2=too_few, streams=POOL_SLOTS, blocks=MESH_BLOCKS,
          bitwise_vs_eager=True, bitwise_vs_pool=True, launches=counts,
          step_ms_mean=1000.0 * wall / MESH_BLOCKS,
          eager_step_ms_mean=1000.0 * runs["eager"][1] / MESH_BLOCKS)

# -- phase 12: sharding over several cards ------------------------------------

SHARD_STREAMS, SHARD_BLOCKS, SHARD_CHANGE_AT = 16, 40, 20
# Synchronized ShardedStreams steps timed per (chain, shards), graph and
# eager (an eager flagship step over four shards of one card takes ~40 ms).
SHARD_TIMED, SHARD_TIMED_EAGER = 100, 30
SHARD_FILES = (3, 4, 16)
SHARD_TIMING_S = (16, 64)
MODEL_CHAINS = {
    "filter_delay_reverb": ([
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 2000, "q": 0.707}},
        {"effect_id": "d", "type": "delay",
         "params": {"delay_ms": 375, "feedback": 0.3, "mix_dry": 1.0, "mix_wet": 0.8,
                    "offset_ms": 5}},
        {"effect_id": "r", "type": "reverb",
         "params": {"rt60_s": 1.5, "damp": 0.3, "pre_delay_ms": 10, "mix_dry": 0.7,
                    "mix_wet": 0.5}}], -120.0),
    "convreverb": ([
        {"effect_id": "c", "type": "convreverb", "params": {"mix_dry": 0.7, "mix_wet": 0.4},
         "ir_seconds": 0.4, "partition_multiple": 2}], -100.0),
}
MODEL_STREAMS, MODEL_BLOCK, MODEL_BLOCKS = 8, 512, 12


def shard_devices():
    """Every visible card, or with one card four shards on it: the one-card
    form, which shows the sharded code paths but not cards working side by
    side."""
    cards = torch.cuda.device_count()
    if cards > 1:
        return [torch.device("cuda", i) for i in range(cards)]
    return [torch.device("cuda", 0)] * 4


def held_equal(what, got, want):
    """(bitwise, dBFS) of a sharded output against its unsharded run; a
    difference beyond -120 dBFS fails (a batched library product may pick
    another algorithm at another batch count: recorded, held to -120)."""
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    worst = max(err_dbfs(a, b) for a, b in zip(got, want))
    if not same and worst > -120.0:
        raise AssertionError(f"{what}: {worst:.1f} dBFS from the unsharded run")
    return same, worst


def flagship_maps(tmap, slots):
    maps = []
    for s in range(slots):
        mp = {k: dict(v) for k, v in tmap.items()}
        for eid, name, value in FLAGSHIP_SLOT_PARAMS:
            mp[eid][name] = value(s)
        maps.append(mp)
    return maps


def shard_streams_data(mono, devs):
    """``ShardedStreams`` of the flagship over 16 streams with per-stream
    targets on a (shards, 1) mesh, 40 blocks, stream 5's semitones changed
    at block 20: the graph step (one replay per shard) bit for bit against
    the eager step, the one-device runner and a 16-slot ``SessionPool``;
    K1 once per shard per step, each shard's replay traced.  Returns the
    final sharded state and its runner."""
    chain, _, tmap = build_chain(FLAGSHIP, FS, BLOCK, device=devs[0])
    streams = pool_streams(mono, SHARD_STREAMS, SHARD_BLOCKS)
    xs = [np.stack([streams[s][b] for s in range(SHARD_STREAMS)])[:, None, :]
          for b in range(SHARD_BLOCKS)]

    def change(maps):
        maps[5]["o"]["semitones"] = -7.0

    runs = {}
    for name, mesh_devs, eager in (("sharded", devs, False), ("eager", devs, True),
                                   ("one", devs[:1], False)):
        runner = ShardedStreams(chain, make_mesh(devices=mesh_devs), SHARD_STREAMS)
        maps = flagship_maps(tmap, SHARD_STREAMS)
        outs, wall, counts, state = drive_streams(
            runner, maps, xs, eager=eager, change=(SHARD_CHANGE_AT, change),
            exact={"octaver_step": SHARD_BLOCKS * len(mesh_devs)})
        if not eager:
            check_shard_replays(f"shard streams flagship {len(mesh_devs)} shards", runner)
        runs[name] = (outs, wall, counts, state, runner, maps)
    graph_equals_eager("shard streams flagship", runs["sharded"][0], runs["eager"][0])
    pool = SessionPool(FLAGSHIP, n_slots=SHARD_STREAMS, device=devs[0])
    for s in range(SHARD_STREAMS):
        pool.claim()
        for eid, name, value in FLAGSHIP_SLOT_PARAMS:
            pool.update_param(s, eid, name, value(s))
    pool_outs = []
    for b in range(SHARD_BLOCKS):
        if b == SHARD_CHANGE_AT:
            pool.update_param(5, "o", "semitones", -7.0)
        out = pool.step_blocks({s: streams[s][b] for s in range(SHARD_STREAMS)})
        pool_outs.append(np.stack([out[s].T for s in range(SHARD_STREAMS)]))
    same_one, db_one = held_equal("ShardedStreams vs one device", runs["sharded"][0],
                                  runs["one"][0])
    same_pool, db_pool = held_equal("ShardedStreams vs the pool", runs["sharded"][0], pool_outs)
    outs, wall, counts, state, runner, maps = runs["sharded"]
    phase("shard_streams_data", mesh=runner.mesh.shape, streams=SHARD_STREAMS,
          blocks=SHARD_BLOCKS, launches=counts, bitwise_vs_eager=True,
          bitwise_vs_one_device=same_one, vs_one_device_dbfs=db_one,
          bitwise_vs_pool=same_pool, vs_pool_dbfs=db_pool,
          capture_s=[r.capture_s for r in runner._runners],
          step_ms_mean=1000.0 * wall / SHARD_BLOCKS,
          eager_step_ms_mean=1000.0 * runs["eager"][1] / SHARD_BLOCKS,
          one_device_step_ms_mean=1000.0 * runs["one"][1] / SHARD_BLOCKS)
    return state, runner, maps, xs


def shard_streams_chorus(mono, devs):
    """``ShardedStreams`` of "Lush Chorus" over 16 streams (each its own
    rate, stream 3's depth changed at block 20) on a (shards, 1) mesh, 40
    blocks: the graph step bit for bit against the eager step and the
    one-device runner, K3 once per shard per step, each replay traced."""
    cfg = DEFAULT_PRESETS["Lush Chorus"]
    chain, _, tmap = build_chain(cfg, FS, BLOCK, device=devs[0])
    streams = pool_streams(mono, SHARD_STREAMS, SHARD_BLOCKS)
    xs = [np.stack([streams[s][b] for s in range(SHARD_STREAMS)])[:, None, :]
          for b in range(SHARD_BLOCKS)]

    def maps_of():
        maps = [{k: dict(v) for k, v in tmap.items()} for _ in range(SHARD_STREAMS)]
        for s, mp in enumerate(maps):
            mp["lc1"]["rate_hz"] = 0.3 + 0.1 * s
        return maps

    def change(maps):
        maps[3]["lc1"]["depth_ms"] = 6.0

    runs = {}
    for name, mesh_devs, eager in (("sharded", devs, False), ("eager", devs, True),
                                   ("one", devs[:1], False)):
        runner = ShardedStreams(chain, make_mesh(devices=mesh_devs), SHARD_STREAMS)
        runs[name] = drive_streams(runner, maps_of(), xs, eager=eager,
                                   change=(SHARD_CHANGE_AT, change),
                                   exact={"chorus_step": SHARD_BLOCKS * len(mesh_devs)})
        if not eager:
            check_shard_replays(f"shard streams chorus {len(mesh_devs)} shards", runner)
    graph_equals_eager("shard streams Lush Chorus", runs["sharded"][0], runs["eager"][0])
    same_one, db_one = held_equal("Lush Chorus ShardedStreams vs one device",
                                  runs["sharded"][0], runs["one"][0])
    phase("shard_streams_chorus", shards=len(devs), streams=SHARD_STREAMS,
          blocks=SHARD_BLOCKS, launches=runs["sharded"][2], bitwise_vs_eager=True,
          bitwise_vs_one_device=same_one, vs_one_device_dbfs=db_one,
          step_ms_mean=1000.0 * runs["sharded"][1] / SHARD_BLOCKS,
          eager_step_ms_mean=1000.0 * runs["eager"][1] / SHARD_BLOCKS)


def shard_streams_model(devs):
    """A (2, 2) mesh over the reverb chain of tests/test_parallel.py and the
    convolution reverb with ``partition_multiple=2``: 8 streams, 12 blocks
    of 512, the graph step bit for bit against the eager step (over four
    cards, each row one capture across its two), and within its JAX bar
    (-120 / -100 dBFS) of the one-device runner."""
    rows = {}
    rng = np.random.default_rng(5)
    xs = [(0.2 * rng.standard_normal((MODEL_STREAMS, 1, MODEL_BLOCK))).astype(np.float32)
          for _ in range(MODEL_BLOCKS)]
    for name, (cfg, bar) in MODEL_CHAINS.items():
        chain, _, tmap = build_chain(cfg, FS, MODEL_BLOCK, device=devs[0])
        tg = chain.targets(tmap)
        outs = {}
        for label, mesh_devs, m, eager in (("model", devs[:4], 2, False),
                                           ("eager", devs[:4], 2, True),
                                           ("one", devs[:1], 1, False)):
            runner = ShardedStreams(chain, make_mesh(devices=mesh_devs, model_parallel=m),
                                    MODEL_STREAMS)
            state, _ = runner.init_state()
            ys = []
            for x in xs:
                state, y, _ = runner.run_block(state, tg, x, eager=eager)
                ys.append(y.cpu().numpy())
            if label == "model":
                check_shard_replays(f"shard streams model {name}", runner)
                cards = [len({d for d in row}) for row in runner.mesh.devices]
            outs[label] = ys
        graph_equals_eager(f"model-sharded {name}", outs["model"], outs["eager"])
        worst = max(err_dbfs(a, b) for a, b in zip(outs["model"], outs["one"]))
        if not worst <= bar:
            raise AssertionError(f"model-sharded {name}: {worst:.1f} dBFS > {bar}")
        rows[name] = {"bitwise_vs_eager": True, "vs_one_device_dbfs": worst, "bar_dbfs": bar,
                      "cards_per_row": cards}
    phase("shard_streams_model", mesh={"data": 2, "model": 2}, streams=MODEL_STREAMS,
          blocks=MODEL_BLOCKS, block=MODEL_BLOCK, chains=rows)


def shard_streams_timing(mono, devs):
    """Host-clock p50/p99 of a synchronized ``ShardedStreams`` step (its
    output and peak read back) of 16 streams, graph and eager, over 1, 2
    and all shards, for the flagship and "Lush Chorus" (shared targets),
    each run from zeroed counters with its kernel once per shard a step."""
    rows = {}
    for name, kernel in (("flagship", "octaver_step"), ("Lush Chorus", "chorus_step")):
        chain, _, tmap = build_chain(preset_cfg(name), FS, BLOCK, device=devs[0])
        targets = chain.targets(tmap)
        streams = pool_streams(mono, SHARD_STREAMS, SHARD_TIMED + 5)
        xs = [np.stack([streams[s][b] for s in range(SHARD_STREAMS)])[:, None, :]
              for b in range(SHARD_TIMED + 5)]
        for n in sorted({1, 2, len(devs)}):
            runner = ShardedStreams(chain, make_mesh(devices=devs[:n]), SHARD_STREAMS)
            for mode in ("graph", "eager"):
                steps = SHARD_TIMED if mode == "graph" else SHARD_TIMED_EAGER
                state, _ = runner.init_state()
                for x in xs[:5]:
                    state, y, peak = runner.run_block(state, targets, x, eager=mode == "eager")
                    y.cpu(), float(peak)

                def run():
                    nonlocal state
                    lat = []
                    for x in xs[5:5 + steps]:
                        t0 = time.perf_counter()
                        state, y, peak = runner.run_block(state, targets, x,
                                                          eager=mode == "eager")
                        y.cpu(), float(peak)
                        lat.append(1000.0 * (time.perf_counter() - t0))
                    return lat

                lat, _ = count_launches(run, exact={kernel: steps * n})
                rows[f"{name} shards={n} {mode}"] = {**pctl(lat), "steps": steps}
            runner.release()
    phase("shard_streams_step", streams=SHARD_STREAMS, step_ms=rows, deadline_ms=BUDGET_MS)
    return rows


def shard_pool(mono, devs):
    """``SessionPool(shard=True)`` of the flagship, 16 slots over the shards
    for 40 blocks (per-slot params, an ``update_param``, a release and a
    claim at block 20) bit for bit against the unsharded pool, K1 once per
    shard per step; then step p50/p99, synchronous and pipelined, at S = 16
    and 64 over 1, 2 and all shards (the host's cost against n)."""
    streams = pool_streams(mono, SHARD_STREAMS, SHARD_BLOCKS)
    pool = SessionPool(FLAGSHIP, n_slots=SHARD_STREAMS, shard=True, device="cuda")
    if len(pool.state) != len(devs):
        raise AssertionError(f"a sharded pool holds {len(pool.state)} shards, not {len(devs)}")
    outs, counts = count_launches(
        lambda: drive_pool(pool, streams, SHARD_BLOCKS, change_at=SHARD_CHANGE_AT),
        exact={"octaver_step": SHARD_BLOCKS * len(devs)})
    for i, runner in enumerate(pool._runners):
        check_replay(f"shard pool flagship S={SHARD_STREAMS} shard {i}", runner)
    plain = SessionPool(FLAGSHIP, n_slots=SHARD_STREAMS, device="cuda")
    want = drive_pool(plain, streams, SHARD_BLOCKS, change_at=SHARD_CHANGE_AT)
    same, worst = held_equal("sharded pool vs unsharded pool",
                             [o[s] for o in outs for s in o], [o[s] for o in want for s in o])
    timing = {}
    for n in sorted({1, 2, len(devs)}):
        mesh_mod.visible_devices = lambda device=None, n=n: devs[:n]
        for slots in SHARD_TIMING_S:
            for mode in ("sync", "pipelined"):
                t, _ = timed_steps(FLAGSHIP, slots, mono, TIMED_STEPS, mode == "pipelined",
                                   "octaver_step", shard=n > 1, per_step=n)
                timing[f"shards={n} S={slots} {mode}"] = {
                    "p50_ms": t["p50_ms"], "p99_ms": t["p99_ms"], "max_ms": t["max_ms"]}
    mesh_mod.visible_devices = lambda device=None: devs
    phase("shard_pool", slots=SHARD_STREAMS, shards=len(devs), blocks=SHARD_BLOCKS,
          launches=counts, bitwise_vs_unsharded=same, vs_unsharded_dbfs=worst,
          step_ms=timing, deadline_ms=BUDGET_MS)


def shard_render(demo, devs):
    """``render_batch(shard=True)`` of the flagship at F = 3 (padded to a
    multiple of the shards), 4 and 16 demo-length files: each file bit for
    bit its unsharded render, K2 once per shard, wall time and aggregate
    realtime factor beside the unsharded batch's."""
    rows = []
    for files in SHARD_FILES:
        batch = sweep_files(demo, files)
        walls = {}
        outs = {}
        for label, shard in (("sharded", True), ("unsharded", False)):
            render_batch(FLAGSHIP, batch, FS, shard=shard, device="cuda")  # cold

            def warm():
                t0 = time.perf_counter()
                out = render_batch(FLAGSHIP, batch, FS, shard=shard, device="cuda")
                return out, time.perf_counter() - t0

            (outs[label], walls[label]), counts = count_launches(
                warm, exact={"comb_sums": len(devs) if shard else 1})
            if shard:
                sharded_counts = counts
        same, worst = held_equal(f"sharded render_batch F={files}", outs["sharded"],
                                 outs["unsharded"])
        audio_s = files * demo.shape[0] / FS
        row = {"files": files, "frames": demo.shape[0], "shards": len(devs),
               "launches": sharded_counts, "bitwise_vs_unsharded": same,
               "vs_unsharded_dbfs": worst, "wall_s": walls["sharded"],
               "realtime_x": audio_s / walls["sharded"], "unsharded_wall_s": walls["unsharded"],
               "unsharded_realtime_x": audio_s / walls["unsharded"]}
        phase("shard_render_batch", **row)
        rows.append(row)
    return rows


def shard_cli(demo, work):
    """``cli --batch --shard`` as a subprocess over three files: byte-equal to
    the encoding of ``render_batch(shard=True)`` over the cards the
    subprocess sees (one card: the same render)."""
    paths = []
    for i, f in enumerate(demo_files(demo)):
        paths.append(work / f"shard_in_{i}.wav")
        write_wav_file(str(paths[-1]), f, FS)
    decoded = [read_wav_file(str(p))[0] for p in paths]
    want = render_batch(FLAGSHIP, decoded, FS, shard=True, device="cuda")
    cfg_path = work / "flagship.json"
    cfg_path.write_text(json.dumps(FLAGSHIP))
    t0 = time.perf_counter()
    proc = run_cli("--batch", work / "shard_out", *paths, "--config", cfg_path, "--shard")
    wall = time.perf_counter() - t0
    for p, w in zip(paths, want):
        if (work / "shard_out" / p.name).read_bytes() != encode_wav_int16(w, FS):
            raise AssertionError(f"cli --batch --shard: {p.name} differs")
    phase("shard_cli_batch", files=len(paths), subprocess_cards=torch.cuda.device_count(),
          byte_equal=True, subprocess_wall_s=wall, report=proc.stdout.strip().splitlines()[-1])


def shard_checkpoint(state, runner, maps, xs, work):
    """The data-sharded flagship state saved (joined, in JAX's leaf order),
    loaded onto a sharded template and stepped: bit-equal to the state it
    was saved from."""
    targets = runner.batch_targets(maps)
    t0 = time.perf_counter()
    save_session(str(work / "shard_session"), FLAGSHIP, maps[0], state)
    _, _, rebuild, _, _, _ = load_session(str(work / "shard_session"))
    restored = rebuild(runner.init_state()[0])
    wall = time.perf_counter() - t0
    _, y_a, _ = runner.run_block(state, targets, xs[0], per_stream_targets=True)
    _, y_b, _ = runner.run_block(restored, targets, xs[0], per_stream_targets=True)
    if not torch.equal(y_a, y_b):
        raise AssertionError("sharded session resumed differently")
    phase("shard_checkpoint", shards=len(restored.shards), bitwise=True, save_load_s=wall)


def shard(demo, mono, work):
    """Phase 12: the mesh's data and model axes, the sharded pool, the
    sharded batch render, ``--shard`` and sharded checkpoints, over every
    card or, with one card, four shards on it."""
    devs = shard_devices()
    phase("shard_devices", cards=torch.cuda.device_count(),
          shards=[str(d) for d in devs], one_card_form=torch.cuda.device_count() == 1)
    visible = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda device=None: devs
    walls = {}
    try:
        (state, runner, maps, xs), walls["streams_data"] = timed_phase(
            lambda: shard_streams_data(mono, devs))
        for step, fn in (("streams_chorus", lambda: shard_streams_chorus(mono, devs)),
                         ("streams_model", lambda: shard_streams_model(devs)),
                         ("streams_timing", lambda: shard_streams_timing(mono, devs)),
                         ("pool", lambda: shard_pool(mono, devs)),
                         ("render_batch", lambda: shard_render(demo, devs)),
                         ("cli_batch", lambda: shard_cli(demo, work)),
                         ("checkpoint", lambda: shard_checkpoint(state, runner, maps, xs,
                                                                 work))):
            _, walls[step] = timed_phase(fn)
    finally:
        mesh_mod.visible_devices = visible
    phase("shard_walls", seconds=walls, total_s=sum(walls.values()))


# -- phase 13: the compiled step (one captured CUDA graph per chain) ---------

# Each chain of the captured step, with the update_param made at block 20
# (tests/test_torch_graph.py holds the same runs).
GRAPH_CHAINS = (("flagship", ("o", "semitones", -7.0)),
                ("Lush Chorus", ("lc1", "rate_hz", 2.5)),
                ("Rain Delay", ("rd1", "feedback", 0.6)),
                ("Multiband Master", ("mml", "drive_db", 6.0)),
                ("Concert Hall (Convolution)", ("cv1", "mix_wet", 0.9)),
                ("Clean Noise Removal", ("p6", "threshold_db", -30.0)))
GRAPH_BLOCKS, GRAPH_CHANGE_AT = 40, 20
GRAPH_TIMED = 100  # synchronized steps timed per chain, graph and eager alike
GRAPH_TIMED_MULTIBAND = 40  # ~70 ms an eager step
GRAPH_POOL_S = (1, 16, 64, 256)
# Where a library op picks another algorithm under capture, the op and the
# bar instead of bitwise equality (none measured so far).
GRAPH_LIBRARY_OPS = {}


def pctl(lat):
    lat = sorted(lat)
    return {"p50_ms": statistics.median(lat),
            "p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]}


def graph_pool_bytes(graph):
    """Bytes of the card's memory segments in ``graph``'s private pool (None
    if the allocator's snapshot does not name pools)."""
    pool = graph.pool()
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(pool))


def step_graph_chain(name, change, mono):
    """One chain: 40 blocks through the engine (graph replays, the
    update_param at block 20 written into the static targets) against the
    eager step on the card, K1/K3 once per replay; capture seconds, kernels
    per replay and per eager step, the graph pool's memory, and the
    host-clock p50/p99 of a synchronized step, graph (engine) and eager
    (upload, ``process_block``, readback), in this process."""
    cfg = preset_cfg(name)
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(GRAPH_BLOCKS)]
    chain, state, tmap = build_chain(cfg, FS, BLOCK, device="cuda")
    targets, want = chain.targets(tmap), []
    for k, b in enumerate(blocks):
        if k == GRAPH_CHANGE_AT:
            tmap[change[0]][change[1]] = change[2]
            targets = chain.targets(tmap)
        state, y = chain.process_block(state, targets, torch.from_numpy(b.T.copy()).cuda())
        want.append(y.cpu().numpy().T)
    eng = AudioEngine(device="cuda")
    before = torch.cuda.memory_allocated()
    eng.build_chain(cfg)
    runner = eng._runner
    pool_bytes = graph_pool_bytes(runner.graph)
    alloc = torch.cuda.memory_allocated() - before

    def run():
        outs = []
        for k, b in enumerate(blocks):
            if k == GRAPH_CHANGE_AT:
                eng.update_param(*change)
            outs.append(eng.process_stream_block(b))
        return outs

    types = [c["type"] for c in cfg]
    exact = {"octaver_step": GRAPH_BLOCKS if "octaver" in types else 0,
             "chorus_step": GRAPH_BLOCKS if "chorus" in types else 0}
    got, counts = count_launches(run, exact=exact)
    check_replay(f"engine {name}", runner)
    err = err_dbfs(np.concatenate(got), np.concatenate(want))
    bitwise = bool(np.array_equal(np.concatenate(got), np.concatenate(want)))
    op, bar = GRAPH_LIBRARY_OPS.get(name, (None, None))
    if not bitwise and not (op and err <= bar):
        raise AssertionError(f"step_graph {name}: graph vs eager {err:.1f} dBFS")
    n = GRAPH_TIMED_MULTIBAND if name == "Multiband Master" else GRAPH_TIMED
    timed = [mono[(GRAPH_BLOCKS + i) * BLOCK:(GRAPH_BLOCKS + i + 1) * BLOCK] for i in range(n)]
    lat_graph = []
    for b in timed:
        t0 = time.perf_counter()
        eng.process_stream_block(b)
        lat_graph.append(1000.0 * (time.perf_counter() - t0))
    lat_eager = []
    for b in timed:
        t0 = time.perf_counter()
        state, y = chain.process_block(state, targets, torch.from_numpy(b.T.copy()).cuda())
        y.cpu()
        lat_eager.append(1000.0 * (time.perf_counter() - t0))
    k_graph, c_graph, busy_graph = kernels_per_step(lambda: runner.run(), steps=20)
    xb = torch.from_numpy(timed[0].T.copy()).cuda()
    k_eager, c_eager, busy_eager = kernels_per_step(
        lambda: chain.process_block(state, targets, xb), steps=5)
    graph, eager = pctl(lat_graph), pctl(lat_eager)
    eng.close()
    row = {"chain": name, "blocks": GRAPH_BLOCKS, "bitwise_vs_eager": bitwise,
           "graph_vs_eager_dbfs": err, "library_op": op, "launches": counts,
           "capture_s": runner.capture_s, "kernels_per_replay": k_graph,
           "copies_per_replay": c_graph, "kernels_per_eager_step": k_eager,
           "graph_pool_bytes": pool_bytes, "allocated_bytes_after_build": alloc,
           "graph_step": graph, "eager_step": eager, "timed_steps": n,
           "device_busy_ms_per_replay": busy_graph, "device_busy_ms_per_eager_step": busy_eager,
           "device_busy_share_graph": busy_graph / graph["p50_ms"], "deadline_ms": BUDGET_MS}
    phase("step_graph", **row)
    return row


def step_graph(mono):
    """Phase 13: every chain of the compiled step, graph against eager, then
    the flagship pool's step p50/p99 at S = 1, 16, 64, 256, synchronous and
    pipelined (one graph replay per step)."""
    rows = {name: step_graph_chain(name, change, mono) for name, change in GRAPH_CHAINS}
    pool = {}
    for slots in GRAPH_POOL_S:
        for mode in ("sync", "pipelined"):
            t, p = timed_steps(FLAGSHIP, slots, mono, TIMED_STEPS, mode == "pipelined",
                               "octaver_step")
            pool[f"S={slots} {mode}"] = {"p50_ms": t["p50_ms"], "p99_ms": t["p99_ms"],
                                         "max_ms": t["max_ms"],
                                         "capture_s": p._runners[0].capture_s}
            p.close()
    phase("step_graph_pool", chain="flagship", step_ms=pool, deadline_ms=BUDGET_MS)
    return rows, pool


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "shard"]):
        raise SystemExit("usage: chip_smoke.py [--only shard]")
    t_start = time.perf_counter()
    card, _ = probe(several=bool(argv))
    dev = torch.device("cuda")
    build()
    demo, fs = read_wav_file(str(DEMO))
    if fs != FS or demo.ndim != 2 or demo.shape[1] != 2:
        raise AssertionError(f"unexpected demo file: {demo.shape} @ {fs}")
    mono = demo.mean(axis=1, keepdims=True).astype(np.float32)
    if argv:  # phase 12 alone, over every visible card
        WORK.mkdir(parents=True, exist_ok=True)
        _, wall = timed_phase(lambda: shard(demo, mono, WORK))
        shutil.rmtree(WORK, ignore_errors=True)
        phase("shard_only", seconds=wall)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                                  "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    k1 = check_k1(dev, demo.shape[0])
    k2 = check_k2(dev, demo)
    k2["file_grid"] = check_k2_file_grid(dev, demo)
    k3 = check_k3(dev, demo.shape[0])
    k4 = check_k4(dev, demo)  # K4's own path: its entry, from a zeroed counter
    k5 = check_k5(dev)
    k6 = check_k6(dev, demo)

    # The main paths, each from zeroed launch counters.
    file_mode("flagship", FLAGSHIP, demo, fs, need=("comb_sums",))
    file_mode("Rain Delay", DEFAULT_PRESETS["Rain Delay"], demo, fs, need=("comb_sums",))
    for preset in MODULATION_PRESETS:
        need = {"Lush Chorus": ("chorus_step", "comb_sums"),
                "Jet Flanger": ("flanger_file",)}.get(preset, ())
        file_mode(preset, DEFAULT_PRESETS[preset], demo, fs, need=need)
    for preset in LAST_SLICE_PRESETS:
        file_mode(preset, DEFAULT_PRESETS[preset], demo, fs)
    # The preset's threshold, and -20 dB (a JAX parity case), where the
    # demo's bins split about evenly and far more sit near the threshold.
    for threshold_db in (DEFAULT_PRESETS["Clean Noise Removal"][0]["params"]["threshold_db"], -20):
        spectral_mask_flips(mono, threshold_db)
    streaming("flagship", FLAGSHIP, mono, "octaver_step")
    streaming("Lush Chorus", DEFAULT_PRESETS["Lush Chorus"], mono, "chorus_step")
    for preset in ("Concert Hall (Convolution)", "Multiband Master"):
        streaming(preset, DEFAULT_PRESETS[preset], mono,
                  n_blocks=MULTIBAND_BLOCKS if preset == "Multiband Master" else STREAM_BLOCKS)

    # The session layer and the CLI's batch and resumable modes.
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    files = demo_files(demo)
    walls = {}
    for chain, cfg, need in (("flagship", FLAGSHIP, {"comb_sums": 1}),
                             ("Lush Chorus", DEFAULT_PRESETS["Lush Chorus"],
                              {"comb_sums": 1, "chorus_step": 1})):
        _, walls[f"render_batch {chain}"] = timed_phase(
            lambda: batch_render(chain, cfg, files, need))
    _, walls["render_batch_sweep"] = timed_phase(lambda: render_batch_sweep(demo))
    for step, fn in (("cli_batch", lambda: cli_batch(files, WORK)),
                     ("file_stream", lambda: file_stream(mono)),
                     ("pipelined", lambda: pipelined(mono)),
                     ("session_resume", lambda: session_resume(mono, WORK)),
                     ("uploads", lambda: uploads(mono)),
                     ("cli_checkpoint", lambda: cli_checkpoint(demo, WORK)),
                     ("process_wav_file", lambda: wav_upload(demo))):
        _, walls[step] = timed_phase(fn)
    phase("session_layer_walls", seconds=walls, total_s=sum(walls.values()))
    shutil.rmtree(WORK, ignore_errors=True)

    # Phase 10: the multi-session pool.
    walls = {}
    grids, walls["slot_grids"] = timed_phase(lambda: check_slot_grids(dev))
    for step, fn in (("pool_flagship", lambda: pool_flagship(mono)),
                     ("pool_timing", lambda: pool_timing(mono)),
                     ("pool_multipool", lambda: pool_multi(mono)),
                     ("pool_server", lambda: pool_server(mono))):
        out, walls[step] = timed_phase(fn)
        if step == "pool_timing":
            generic = out
    phase("pool_walls", seconds=walls, total_s=sum(walls.values()))

    # Phase 11: the serving front, as users start it.
    WORK.mkdir(parents=True)
    walls = {}
    for step, fn in (("backend_handler", lambda: backend_handler(demo, mono, WORK)),
                     ("ui_server", ui_server),
                     ("launcher", lambda: launcher(demo, WORK)),
                     ("pool_grid", lambda: pool_grid(mono, generic)),
                     ("mesh", lambda: mesh(mono))):
        _, walls[step] = timed_phase(fn)
    phase("serving_walls", seconds=walls, total_s=sum(walls.values()))

    # Phase 12: sharding over several cards (the one-card form here).
    _, wall = timed_phase(lambda: shard(demo, mono, WORK))
    phase("shard_wall", seconds=wall)
    shutil.rmtree(WORK, ignore_errors=True)

    # Phase 13: the compiled step.
    _, wall = timed_phase(lambda: step_graph(mono))
    phase("step_graph_wall", seconds=wall)
    phase("smoke_wall", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [
        {"name": "octaver_step", "route": "cuda", "source": "aefs_tpu_torch/csrc/resample.cu",
         "replaces": "aefs_tpu/ops/pallas/resample.py:133", "launches": LAUNCHES["octaver_step"],
         "graph_paths_traced": graph_traced("octaver_step"), **k1, "slot_grid": grids["octaver"]},
        {"name": "comb_sums", "route": "cuda", "source": "aefs_tpu_torch/csrc/comb.cu",
         "replaces": "aefs_tpu/ops/pallas/comb.py:145", "launches": LAUNCHES["comb_sums"], **k2},
        {"name": "chorus_step", "route": "cuda", "source": "aefs_tpu_torch/csrc/resample.cu",
         "replaces": "aefs_tpu/ops/pallas/resample.py:64",
         "launches": LAUNCHES["chorus_step"], "graph_paths_traced": graph_traced("chorus_step"),
         **k3, "slot_grid": grids["chorus"]},
        {"name": "comb_chunks", "route": "cuda", "source": "aefs_tpu_torch/csrc/comb.cu",
         "replaces": "aefs_tpu/ops/pallas/comb.py:62", "launches": LAUNCHES["comb_chunks"], **k4},
        {"name": "biquad_step", "route": "cuda", "source": "aefs_tpu_torch/csrc/biquad.cu",
         "replaces": None, "launches": LAUNCHES["biquad_step"],
         "graph_paths_traced": graph_traced("biquad_step"), **k5},
        {"name": "flanger_file", "route": "cuda", "source": "aefs_tpu_torch/csrc/flanger.cu",
         "replaces": None, "launches": LAUNCHES["flanger_file"], **k6},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
