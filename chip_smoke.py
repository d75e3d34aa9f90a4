"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (aefs_tpu_torch) end to end on the card:

1. probe: a CUDA card is required; prints its name and power limit;
2. build: compiles the hand-written kernels (csrc/*.cu) from the sources;
3. K1 (octaver two-tap read) against its plain PyTorch version on the card,
   at the 256-sample streaming shape and a 4096-sample superblock;
4. K2 (whole-file reverb comb sums) against its plain version on the card,
   at the flagship reverb's lags over the demo file's length, with the
   baked-damping FIR and the traced-damping scan;
5. K3 (one stream's tap read, the chorus's tap) against its plain version,
   bit for bit, at 2 x 256 (streaming) and 2 x 892,800 (the demo file);
6. K4 (the comb bank with every chunk's y and damped) through its entry
   ``ringbuf.comb_bank_file_chunks`` at the flagship reverb's lags over the
   demo's length, against its plain version;
7. file mode: ``process_offline`` of the flagship chain, the "Rain Delay"
   preset, the five modulation presets ("Lush Chorus", "Jet Flanger",
   "Psychedelic Sweep", "Funky Talk", "8-Bit Arcade") and the seven
   presets of the dynamics/FFT/container slice ("Clean Noise Removal",
   "Crunch", "Concert Hall (Convolution)", "Glue Bus", "Master Bus",
   "Broadcast Voice", "Multiband Master") on music/rain-demo.wav, each
   against the same render on the CPU;
8. streaming: ``AudioEngine(device="cuda")`` with the flagship chain,
   "Lush Chorus", "Concert Hall (Convolution)" and "Multiband Master",
   375 blocks of 256 samples of the demo's mono mix each, against the CPU
   engine.

Every path of phases 6-8 runs from zeroed kernel launch counters, read
just after it; each fails if a kernel it runs was not launched.  The last
slice's paths run none of the four kernels (their FFTs are cuFFT, as the
JAX package's are ``jnp.fft`` outside Pallas); their counts are recorded.

Each kernel's record holds its time per wrapper call (CUDA events over
back-to-back calls, host cost included), its device-only time (the kernel
durations ``torch.profiler`` records, per call) and its bound: the larger
of the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, from this run's
shapes.  No single PyTorch call computes any of the four functions, so
``library_ms`` is null.

Any failure raises (non-zero exit).  The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.  Imports no
JAX.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from __graft_entry__ import FLAGSHIP
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.engine.engine import AudioEngine, process_offline
from aefs_tpu_torch.engine.wavio import read_wav_file
from aefs_tpu_torch.models.reverb import Reverb
from aefs_tpu_torch.models.spectral import SpectralFilter, db_to_lin
from aefs_tpu_torch.ops import kernels
from aefs_tpu_torch.ops.fftops import frame_signal
from aefs_tpu_torch.ops.kernels.comb import (
    comb_chunks, comb_chunks_plain, comb_sums, comb_sums_plain)
from aefs_tpu_torch.ops.kernels.resample import (
    fractional_read, fractional_read_plain, octaver_taps, octaver_taps_plain)
from aefs_tpu_torch.ops.ringbuf import comb_bank_file_chunks, comb_chunk_size

ROOT = pathlib.Path(__file__).resolve().parent
DEMO = ROOT / "music" / "rain-demo.wav"
FS = 48000
BLOCK = 256
STREAM_BLOCKS = 375  # 2 s at 48 kHz
BUDGET_MS = 1000.0 * BLOCK / FS  # 5.33 ms per block
K1_TOL = 2e-6
K2_SUM_TOL, K2_TAIL_TOL = 1e-5, 1e-4
K4_Y_TOL, K4_DAMPED_TOL = K2_SUM_TOL, K2_TAIL_TOL
DBFS_TOL = -90.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
HERMITE_FLOPS = 20  # per tap read: frac, the four coefficients, Horner (K1, K3)
# Per comb and sample of the comb recursion: y = x + g r (2), then
# damped = h d + (1 - h) y (3, with 1 - h formed once) (K2, K4).
COMB_OPS = 5
MODULATION_PRESETS = ("Lush Chorus", "Jet Flanger", "Psychedelic Sweep", "Funky Talk",
                      "8-Bit Arcade")
LAST_SLICE_PRESETS = ("Clean Noise Removal", "Crunch", "Concert Hall (Convolution)",
                      "Glue Bus", "Master Bus", "Broadcast Voice", "Multiband Master")
# Every wrapper's launch counter, by the name the kernels' record uses.
COUNTERS = {"octaver_taps": octaver_taps, "comb_sums": comb_sums,
            "fractional_read": fractional_read, "comb_chunks": comb_chunks}
LAUNCHES = {k: 0 for k in COUNTERS}  # summed over the paths of phases 6-8


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


def bound(n_bytes, flops):
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the peak rate, in ms."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
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


def count_launches(run, need=(), per_block=None):
    """Run one path from zeroed launch counters and read them just after.
    ``need``: kernels the path must launch (at least once, or exactly
    ``per_block`` times).  Adds the counts to LAUNCHES."""
    for fn in COUNTERS.values():
        fn.launches = 0
    result = run()
    counts = {k: fn.launches for k, fn in COUNTERS.items()}
    for k in need:
        want_ok = counts[k] >= 1 if per_block is None else counts[k] == per_block
        if not want_ok:
            raise AssertionError(f"{k} launched {counts[k]} times on this path "
                                 f"(want {'>= 1' if per_block is None else per_block})")
    for k, v in counts.items():
        LAUNCHES[k] += v
    return result, counts


def probe():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; torch.cuda.is_available() is false")
    if torch.cuda.device_count() != 1:
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


def check_k1(dev):
    """K1 at the streaming shape and a 4096-sample superblock, on phase
    ramps that cross the ring boundary (wrap lanes)."""
    size = 1920
    rng = np.random.default_rng(1)
    worst = 0.0
    for n in (BLOCK, 4096):
        for step_scale in (-0.94, -0.5, 0.3, 0.9):
            hist = torch.from_numpy((0.3 * rng.standard_normal(size)).astype(np.float32)).to(dev)
            x = torch.from_numpy((0.3 * rng.standard_normal(n)).astype(np.float32)).to(dev)
            p0 = 0.995 if step_scale > 0 else 0.005
            p1 = np.mod(p0 + np.arange(n) * (step_scale / size), 1.0).astype(np.float32)
            p2 = np.mod(p1 + np.float32(0.5), 1.0).astype(np.float32)
            ago1 = torch.from_numpy(p1 * size).to(dev)
            ago2 = torch.from_numpy(p2 * size).to(dev)
            got = octaver_taps(hist, x, ago1, ago2)
            ref = octaver_taps_plain(hist, x, ago1, ago2)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            if err > K1_TOL:
                raise AssertionError(f"K1 n={n} step={step_scale}: max abs {err} > {K1_TOL}")
            worst = max(worst, err)
    # Times at the streaming shape (the last n=256 inputs rebuilt).
    hist = torch.from_numpy((0.3 * rng.standard_normal(size)).astype(np.float32)).to(dev)
    x = torch.from_numpy((0.3 * rng.standard_normal(BLOCK)).astype(np.float32)).to(dev)
    p1 = np.mod(0.005 - np.arange(BLOCK) * (0.5 / size), 1.0).astype(np.float32)
    ago1 = torch.from_numpy(p1 * size).to(dev)
    ago2 = torch.from_numpy(np.mod(p1 + np.float32(0.5), 1.0).astype(np.float32) * size).to(dev)
    ms = cuda_ms(lambda: octaver_taps(hist, x, ago1, ago2), 2000)
    plain_ms = cuda_ms(lambda: octaver_taps_plain(hist, x, ago1, ago2), 200)
    dev_ms = device_ms(lambda: octaver_taps(hist, x, ago1, ago2), ("octaver_taps_kernel",), 200)
    # Reads hist, x, ago1, ago2; writes both taps.
    bnd = bound(4 * (size + 3 * BLOCK) + 4 * 2 * BLOCK, HERMITE_FLOPS * 2 * BLOCK)
    phase("k1_octaver_taps", max_abs_err=worst, tol=K1_TOL, shape=[size, BLOCK],
          ms=ms, device_ms=dev_ms, plain_ms=plain_ms, **bnd)
    return record(worst, ms, dev_ms, plain_ms, bnd)


def check_k2(dev, demo):
    """K2 at the flagship reverb's lags over the demo's length: FIR damping
    (baked h = 0.05, the flagship's) and the log-step scan (h = 0.6)."""
    rev = Reverb(FS, 4096, file_mode=True, file_damp=0.05)
    lags = tuple(rev.comb_lags[0] + rev.comb_lags[1])
    side_of = (0,) * rev.n_combs + (1,) * rev.n_combs
    c = comb_chunk_size(lags)
    x = torch.from_numpy(np.ascontiguousarray(demo.T)).to(dev)  # (2, N) real audio
    g = torch.pow(10.0, -3.0 * (torch.tensor(lags, dtype=torch.float32) / FS) / 2.1).to(dev)
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


def check_k3(dev, n_file):
    """K3 at the chorus's geometry (history 2408, two channels) with
    chorus-law distances: 2 x 256 (a streaming block) and 2 x n_file (the
    demo file), bit for bit against the plain gather."""
    rng = np.random.default_rng(3)
    res = {}
    for n, reps, plain_reps in ((BLOCK, 2000, 200), (n_file, 20, 5)):
        hist = torch.from_numpy((0.3 * rng.standard_normal((2, 2408))).astype(np.float32)).to(dev)
        x = torch.from_numpy((0.3 * rng.standard_normal((2, n))).astype(np.float32)).to(dev)
        ph = 0.13 + np.arange(n) * (0.6 / FS) + 0.25 * np.arange(2)[:, None]
        ago = torch.from_numpy(np.clip((14.0 + 4.0 * np.sin(2 * np.pi * ph)) * 48.0, 2.0, 2406.0)
                               .astype(np.float32)).to(dev)
        got = fractional_read(hist, x, ago)
        ref = fractional_read_plain(hist, x, ago)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 2x{n}: not bitwise equal to plain (max abs {err})")
        ms = cuda_ms(lambda: fractional_read(hist, x, ago), reps)
        plain_ms = cuda_ms(lambda: fractional_read_plain(hist, x, ago), plain_reps)
        dev_ms = device_ms(lambda: fractional_read(hist, x, ago), ("fractional_read_kernel",),
                           min(reps, 200))
        # Reads hist, x, ago; writes one tap per (row, sample).
        bnd = bound(4 * (hist.numel() + 2 * x.numel()) + 4 * x.numel(),
                    HERMITE_FLOPS * x.numel())
        res[n] = record(err, ms, dev_ms, plain_ms, bnd)
        phase("k3_fractional_read", shape=[2, n], hist=2408, bitwise=True, **res[n],
              bytes=bnd["bytes"], flops=bnd["flops"])
    return res[BLOCK]


def check_k4(dev, demo):
    """K4 at the flagship reverb's 8 lags and its two sides over the demo
    (traced damping h = 0.25, the scan), through the entry
    ``ringbuf.comb_bank_file_chunks`` from a zeroed counter, against plain."""
    rev = Reverb(FS, 4096, file_mode=True, file_damp=0.05)
    lags = tuple(rev.comb_lags[0] + rev.comb_lags[1])
    side_of = (0,) * rev.n_combs + (1,) * rev.n_combs
    x = torch.from_numpy(np.ascontiguousarray(demo.T)).to(dev)
    g = torch.pow(10.0, -3.0 * (torch.tensor(lags, dtype=torch.float32) / FS) / 2.1).to(dev)
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


def streaming(name, cfg, mono, kernel=None):
    """375 blocks through the card's engine from zeroed counters (``kernel``,
    if the path has one, launched exactly once per block), against the CPU
    engine."""
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(STREAM_BLOCKS)]
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
                                         per_block=STREAM_BLOCKS)
    got = np.concatenate(outs)
    if got.shape != (STREAM_BLOCKS * BLOCK, 2) or not np.all(np.isfinite(got)):
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
    phase("streaming", chain=name, blocks=STREAM_BLOCKS, block=BLOCK, launches=counts,
          vs_cpu_dbfs=err, median_ms=statistics.median(lat), p99_ms=p99,
          max_ms=max(lat), first_ms=lat[0], budget_ms=BUDGET_MS,
          within_budget_share=sum(t <= BUDGET_MS for t in lat) / len(lat),
          cpu_engine_wall_s=t_cpu)


def main():
    name, _ = probe()
    dev = torch.device("cuda")
    build()
    demo, fs = read_wav_file(str(DEMO))
    if fs != FS or demo.ndim != 2 or demo.shape[1] != 2:
        raise AssertionError(f"unexpected demo file: {demo.shape} @ {fs}")
    k1 = check_k1(dev)
    k2 = check_k2(dev, demo)
    k3 = check_k3(dev, demo.shape[0])
    k4 = check_k4(dev, demo)  # K4's own path: its entry, from a zeroed counter

    # The main paths, each from zeroed launch counters.
    file_mode("flagship", FLAGSHIP, demo, fs, need=("comb_sums",))
    file_mode("Rain Delay", DEFAULT_PRESETS["Rain Delay"], demo, fs, need=("comb_sums",))
    for preset in MODULATION_PRESETS:
        need = ("fractional_read", "comb_sums") if preset == "Lush Chorus" else ()
        file_mode(preset, DEFAULT_PRESETS[preset], demo, fs, need=need)
    for preset in LAST_SLICE_PRESETS:
        file_mode(preset, DEFAULT_PRESETS[preset], demo, fs)
    mono = demo.mean(axis=1, keepdims=True).astype(np.float32)
    # The preset's threshold, and -20 dB (a JAX parity case), where the
    # demo's bins split about evenly and far more sit near the threshold.
    for threshold_db in (DEFAULT_PRESETS["Clean Noise Removal"][0]["params"]["threshold_db"], -20):
        spectral_mask_flips(mono, threshold_db)
    streaming("flagship", FLAGSHIP, mono, "octaver_taps")
    streaming("Lush Chorus", DEFAULT_PRESETS["Lush Chorus"], mono, "fractional_read")
    for preset in ("Concert Hall (Convolution)", "Multiband Master"):
        streaming(preset, DEFAULT_PRESETS[preset], mono)

    print(json.dumps({"kernels": [
        {"name": "octaver_taps", "route": "cuda", "source": "aefs_tpu_torch/csrc/resample.cu",
         "replaces": "aefs_tpu/ops/pallas/resample.py:133", "launches": LAUNCHES["octaver_taps"],
         **k1},
        {"name": "comb_sums", "route": "cuda", "source": "aefs_tpu_torch/csrc/comb.cu",
         "replaces": "aefs_tpu/ops/pallas/comb.py:145", "launches": LAUNCHES["comb_sums"], **k2},
        {"name": "fractional_read", "route": "cuda", "source": "aefs_tpu_torch/csrc/resample.cu",
         "replaces": "aefs_tpu/ops/pallas/resample.py:64",
         "launches": LAUNCHES["fractional_read"], **k3},
        {"name": "comb_chunks", "route": "cuda", "source": "aefs_tpu_torch/csrc/comb.cu",
         "replaces": "aefs_tpu/ops/pallas/comb.py:62", "launches": LAUNCHES["comb_chunks"], **k4},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
