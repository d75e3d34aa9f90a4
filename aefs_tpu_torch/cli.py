"""Offline CLI: process WAVs through an effect chain on a CUDA card (port of
aefs_tpu/cli.py).

    python -m aefs_tpu_torch.cli input.wav output.wav --preset "Rain Delay"
    python -m aefs_tpu_torch.cli input.wav output.wav --config chain.json
    python -m aefs_tpu_torch.cli input.wav output.wav --device cpu
    python -m aefs_tpu_torch.cli --batch out_dir/ a.wav b.wav c.wav --preset "Lush Chorus"
    python -m aefs_tpu_torch.cli in.wav out.wav --checkpoint ck/ [--resume]
    python -m aefs_tpu_torch.cli --list-presets
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="INPUT OUTPUT (single-file mode) or INPUT... "
                         "(with --batch OUT_DIR)")
    ap.add_argument("--batch", metavar="OUT_DIR",
                    help="bulk mode: render every input WAV through the chain "
                         "(one chain, a fresh state per file); outputs land in OUT_DIR")
    ap.add_argument("--shard", action="store_true",
                    help="with --batch: distribute the batch over all "
                         "visible devices (data-parallel rendering)")
    ap.add_argument("--preset", help="factory preset name")
    ap.add_argument("--config", help="JSON chain-config file")
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="device to render on (default: $AEFS_PLATFORM, else cuda)")
    ap.add_argument("--checkpoint", metavar="DIR",
                    help="process resumably in chunks, checkpointing chain "
                         "state + partial output to DIR (long file jobs)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed job from --checkpoint DIR "
                         "(bit-exact: ring buffers/filter taps/phasors resume)")
    ap.add_argument("--checkpoint-every", type=float, default=10.0,
                    metavar="SECONDS", help="checkpoint interval in audio "
                    "seconds (default 10)")
    args = ap.parse_args(argv)

    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    if args.list_presets:
        for name, chain in DEFAULT_PRESETS.items():
            kinds = " -> ".join(c["type"] for c in chain)
            print(f"{name}: {kinds}")
        return 0

    if args.batch:
        if not args.paths:
            ap.error("--batch requires at least one input WAV")
    elif len(args.paths) != 2:
        ap.error("single-file mode takes INPUT OUTPUT "
                 "(or use --batch / --list-presets)")

    if args.config:
        with open(args.config) as f:
            chain_config = json.load(f)
    elif args.preset:
        if args.preset not in DEFAULT_PRESETS:
            ap.error(f"unknown preset {args.preset!r}; see --list-presets")
        chain_config = DEFAULT_PRESETS[args.preset]
    else:
        chain_config = []

    import torch

    from aefs_tpu_torch.engine.engine import process_offline, render_batch
    from aefs_tpu_torch.engine.wavio import read_wav_file, write_wav_file
    from aefs_tpu_torch.utils.platform import require_device, select_device

    try:
        device = require_device(args.device) if args.device else select_device()
    except RuntimeError as e:
        raise SystemExit(f"--device: {e}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    if args.batch:
        audios, fss = [], []
        for p in args.paths:
            a, f = read_wav_file(p)
            audios.append(a)
            fss.append(f)
        if len(set(fss)) != 1:
            ap.error(f"--batch needs one sample rate, got {sorted(set(fss))}")
        fs = fss[0]
        total_s = sum(a.shape[0] for a in audios) / fs
        print(f"{len(audios)} files, {total_s:.2f} s total @ {fs} Hz (device: {name})")
        t0 = time.perf_counter()
        outs = render_batch(chain_config, audios, fs, shard=args.shard, device=device)
        dt = time.perf_counter() - t0
        os.makedirs(args.batch, exist_ok=True)
        # De-collide output names: inputs from different directories may
        # share a basename and must not overwrite each other.
        seen = {}
        for p, out in zip(args.paths, outs):
            base = os.path.basename(p)
            n = seen.get(base, 0)
            seen[base] = n + 1
            if n:
                stem, ext = os.path.splitext(base)
                base = f"{stem}.{n}{ext}"
            write_wav_file(os.path.join(args.batch, base), out, fs)
        print(f"{args.batch}: {len(outs)} files in {dt*1000:.1f} ms "
              f"({total_s/dt:.0f}x realtime aggregate, device: {name})")
        return 0

    in_path, out_path = args.paths
    audio, fs = read_wav_file(in_path)
    print(f"{in_path}: {audio.shape[0]/fs:.2f} s @ {fs} Hz, "
          f"{audio.shape[1] if audio.ndim > 1 else 1} ch (device: {name})")
    t0 = time.perf_counter()
    if args.checkpoint:
        out = process_resumable(
            chain_config, audio, fs, args.checkpoint,
            resume=args.resume, every_s=args.checkpoint_every, device=device,
        )
    else:
        _, out = process_offline(chain_config, audio, fs, device=device)
    dt = time.perf_counter() - t0
    write_wav_file(out_path, out, fs)
    print(f"{out_path}: processed in {dt*1000:.1f} ms "
          f"({(audio.shape[0] / fs) / dt:.0f}x realtime, device: {name})")
    return 0


def _fsync_write(path, write):
    """Write through ``write(f)`` to ``path + '.tmp'``, fsync, then swap it
    into place atomically."""
    with open(path + ".tmp", "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def process_resumable(chain_config, audio, fs, ckpt_dir, resume=False,
                      every_s=10.0, device="cuda"):
    """Chunked blockwise processing with periodic session checkpoints: a
    killed job restarted with ``resume=True`` continues bit-exact from the
    last checkpoint (the carried state tree holds every ring buffer, filter
    tap and phasor — engine/checkpoint.py).

    Layout of ``ckpt_dir``: ``progress.json`` (the commit point, naming the
    committed generation), ``gen-{done}/`` (a session checkpoint), and
    ``chunks/chunk-{start}-{end}.npy`` (each chunk's output, written once)."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import FILE_SUPERBLOCK
    from aefs_tpu_torch.core.fileopts import file_static_overrides
    from aefs_tpu_torch.engine.checkpoint import (
        ir_static_overrides, load_session, profile_static_overrides, remap_profiles,
        save_session)

    if audio.ndim > 1:
        mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
    else:
        mono = audio.reshape(-1, 1).astype(np.float32)
    n = mono.shape[0]
    # Chunks stay blocksize-aligned so the carried state is identical to an
    # uninterrupted blockwise run (bit-exact resume).
    chunk = max(FILE_SUPERBLOCK,
                int(every_s * fs) // FILE_SUPERBLOCK * FILE_SUPERBLOCK)

    done = 0
    outs = []
    irs, profiles = {}, {}
    progress_path = os.path.join(ckpt_dir, "progress.json")
    chunks_dir = os.path.join(ckpt_dir, "chunks")
    if resume and os.path.exists(progress_path):
        with open(progress_path) as f:
            progress = json.load(f)
        # Refuse a checkpoint written for a different input: done_samples
        # applied to another file would splice two inputs' audio.
        if (int(progress.get("n_samples", n)) != n
                or int(progress.get("fs", fs)) != fs):
            raise SystemExit(
                f"--resume: checkpoint was written for a different input "
                f"({progress.get('n_samples')} samples @ "
                f"{progress.get('fs')} Hz; this file is {n} @ {fs})")
        done = int(progress["done_samples"])
        gen_dir = os.path.join(ckpt_dir, progress["dir"])  # the committed generation
        (chain_config, tmap, rebuild_state, irs, profiles,
         ck_meta) = load_session(gen_dir)
        overrides = file_static_overrides(chain_config)
        # A server-written checkpoint may carry uploaded IRs and learned
        # noise profiles (re-binned if saved at another rate).
        profiles = remap_profiles(profiles, ck_meta.get("fs"), fs)
        for extra in (ir_static_overrides(irs, chain_config, fs),
                      profile_static_overrides(profiles, chain_config)):
            for eid, ov in extra.items():
                overrides.setdefault(eid, {}).update(ov)
        chain, state, _ = build_chain(
            chain_config, fs, FILE_SUPERBLOCK, channels_in=1, channels_out=2,
            static_overrides=overrides, device=device,
        )
        state = rebuild_state(chain.init_state())
        outs = _load_partial_chunks(chunks_dir, done)
        print(f"Resuming at {done / fs:.2f} s / {n / fs:.2f} s")
    else:
        # File-mode statics (the delay's lags etc.); the resume branch
        # rebuilds from the checkpoint's own config instead.
        chain, state, tmap = build_chain(
            chain_config, fs, FILE_SUPERBLOCK, channels_in=1, channels_out=2,
            static_overrides=file_static_overrides(chain_config), device=device,
        )
        # A fresh job must not inherit another job's persisted chunks.
        if os.path.isdir(chunks_dir):
            shutil.rmtree(chunks_dir, ignore_errors=True)
    targets = chain.targets(tmap)

    while done < n:
        start, end = done, min(done + chunk, n)
        state, y = chain.process_array(state, targets, mono[start:end], fast=False)
        outs.append(np.clip(y, -1.0, 1.0))
        done = end
        if done < n:
            # Crash-safe commit: persist this chunk's output, stage the
            # state in a fresh generation directory, then swap
            # progress.json (the single manifest) to point at it.  A kill at
            # any instant leaves the previous generation intact and named.
            os.makedirs(chunks_dir, exist_ok=True)
            _fsync_write(os.path.join(chunks_dir, f"chunk-{start}-{done}.npy"),
                         lambda f: np.save(f, outs[-1]))
            # The IRs and profiles a resumed session carried ride every
            # re-checkpoint, or a second resume could not rebuild it.
            save_session(os.path.join(ckpt_dir, f"gen-{done}"), chain_config,
                         {k: dict(v) for k, v in tmap.items()}, state,
                         custom_irs=irs, noise_profiles=profiles, fs=fs)
            _fsync_write(progress_path, lambda f: f.write(json.dumps(
                {"done_samples": int(done), "n_samples": int(n), "fs": int(fs),
                 "dir": f"gen-{done}"}).encode()))
            for name in os.listdir(ckpt_dir):  # prune superseded generations
                if name.startswith("gen-") and name != f"gen-{done}":
                    shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            print(f"Checkpointed at {done / fs:.2f} s / {n / fs:.2f} s")
    return np.concatenate(outs)


def _load_partial_chunks(chunks_dir, done):
    """Load the persisted output covering samples [0, done): per-chunk
    files (chunk-{start}-{end}.npy) walked greedily by coverage (after an
    interval change, the longest committed chunk at each start; within one
    job lineage any committed chunk's content over a range is identical)."""
    by_start = {}
    if os.path.isdir(chunks_dir):
        for name in os.listdir(chunks_dir):
            m = re.match(r"chunk-(\d+)-(\d+)\.npy$", name)
            if not m:
                continue
            s, e = int(m.group(1)), int(m.group(2))
            if e <= done and e > s and e > by_start.get(s, (0, None))[0]:
                by_start[s] = (e, name)
    outs, cov = [], 0
    while cov < done:
        if cov not in by_start:
            raise SystemExit(
                f"--resume: checkpoint chunks cover only [0, {cov}) of "
                f"the committed {done} samples (missing chunk at {cov})")
        e, name = by_start[cov]
        outs.append(np.load(os.path.join(chunks_dir, name)))
        cov = e
    return outs


if __name__ == "__main__":
    sys.exit(main())
