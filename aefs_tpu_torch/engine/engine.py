"""AudioEngine: session runtime (port of aefs_tpu/engine/engine.py).

Owns the current streaming chain (fs=48000, blocksize=256) on one device,
the host-side parameter-target map, the plot queues, the optional mic
stream and live file stream, session checkpoints, uploaded IRs and learned
noise profiles, and whole-file processing (one file, or a batch through
``render_batch``).

- The streaming step is the chain's step runner (``Chain.packed_step``,
  core/packing.py): on the card one captured CUDA graph per chain, its
  state and targets in static device buffers, the block carried in
  through pinned staging and the output read from the static ``y``.
- ``update_param`` rewrites the target map and writes the packed targets
  into the runner's static target buffer; the smoothed glide happens
  inside the block step.
- A rebuild builds the new chain, warms up and captures its runner off the
  audio path, then swaps (chain, runner) under a lock and releases the old
  chain.
- File mode renders through a fresh chain in one whole-signal pass.

Entry points run on the card unless the caller passes ``device="cpu"``,
with that card current (``utils/platform.py:device_scope``); there is no
fallback.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import queue
import threading

import numpy as np
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import (
    BLOCKSIZE,
    CHANNELS_IN,
    CHANNELS_OUT,
    FILE_SUPERBLOCK,
    SAMPLE_RATE,
)
from aefs_tpu_torch.core.fileopts import file_static_overrides
from aefs_tpu_torch.core.packing import Staging
from aefs_tpu_torch.engine.wavio import decode_wav, encode_wav_int16
from aefs_tpu_torch.utils.metrics import TRACER, BlockTimer
from aefs_tpu_torch.utils.platform import device_scope, require_device

try:  # optional, absent in server images (reference engine.py:12-15)
    import sounddevice as sd
except (ImportError, OSError):
    sd = None


def _decode_data_url(contents: str):
    """base64 WAV data URL -> (audio, fs)."""
    from aefs_tpu_torch import native

    _, content_string = contents.split(",")
    return decode_wav(native.b64decode(content_string))


def process_offline(chain_config, audio, fs, superblock=FILE_SUPERBLOCK,
                    extra_static=None, device="cuda"):
    """Whole-file processing through a fresh chain on ``device`` (the
    file-mode core, engine.py:86-102): (frames, ch) float in -> (mono
    (frames, 1), clipped stereo (frames, 2)) out.  ``extra_static`` merges
    on top of the derived file statics (a session's uploaded IR, a learned
    noise profile)."""
    if audio.ndim > 1:
        mono = audio.mean(axis=1, keepdims=True)
    else:
        mono = audio.reshape(-1, 1)
    mono = mono.astype(np.float32)

    static = file_static_overrides(chain_config)
    for eid, extra in (extra_static or {}).items():
        static[eid] = {**static.get(eid, {}), **extra}
    with device_scope(require_device(device)):
        chain, state, targets_map = build_chain(
            chain_config, fs, superblock, channels_in=1, channels_out=2,
            static_overrides=static, device=device,
        )
        _, out = chain.process_array(state, chain.targets(targets_map), mono, fast=True)
    return mono, np.clip(out, -1.0, 1.0)


def render_batch(chain_config, audios, fs, superblock=FILE_SUPERBLOCK,
                 shard: bool = False, device="cuda"):
    """Offline rendering of many files through one chain topology in ONE
    batched whole-file pass, with the JAX package's contract
    (engine.py:77-155): mono downmix, every file zero-padded to the longest
    rounded up to the superblock, file statics, a fresh state per file,
    each output clipped and trimmed to its file's length.

    The files go down a leading file axis: x (F, 1, Lp), every effect's
    state batched over F (``Chain.batch_state``; the lockstep counters stay
    shared), and one ``chain.process_whole`` call renders them all, so F
    files cost the kernel launches of one (K2 once, with a file grid).
    The params stay 0-dim and shared: every file has the same targets and
    fresh state, so their smoothed values are the same (JAX batches them
    too, with equal values).  ``shard=True`` splits the file axis over
    every visible device of ``device``'s kind
    (``parallel/mesh.py:visible_devices``): the batch is padded with silent
    one-superblock entries to a multiple of the device count (their outputs
    are dropped), and each device runs one ``process_whole`` over its F/n
    files at the common length, launched in turn, so K2 runs once per
    device.  With one device it renders exactly as ``shard=False``.

    audios: list of (frames_i,) or (frames_i, ch) arrays, one sample rate.
    Returns a list of (frames_i, 2) float32 clipped outputs.
    """
    from aefs_tpu_torch.parallel import mesh

    device = require_device(device)
    devices = mesh.visible_devices(device) if shard else [device]
    monos = []
    for a in audios:
        a = np.asarray(a, np.float32)
        monos.append(a.mean(axis=1) if a.ndim > 1 else a)
    n_real = len(monos)
    # Any file count shards: silent entries up to a multiple of the devices.
    monos += [np.zeros((superblock,), np.float32)] * ((-n_real) % len(devices))
    length = max(m.shape[0] for m in monos)
    lp = -(-length // superblock) * superblock
    x = np.zeros((len(monos), 1, lp), np.float32)
    for i, m in enumerate(monos):
        x[i, 0, : m.shape[0]] = m

    with device_scope(devices[0]):
        chain, one, targets_map = build_chain(
            chain_config, fs, superblock, channels_in=1, channels_out=2,
            static_overrides=file_static_overrides(chain_config), device=devices[0],
        )
    span = len(monos) // len(devices)
    ys = []
    for i, dev in enumerate(devices):
        with device_scope(dev):
            part = chain.on_device(dev)
            st = one if part is chain else part.init_state()
            state = {"fx": part.batch_state(st, span)["fx"], "params": st["params"]}
            _, y = part.process_whole(state, part.targets(targets_map),
                                      torch.from_numpy(x[i * span:(i + 1) * span]).to(dev))
        ys.append(y)
    # Read back file by file: a (2, Lp) buffer is reused by the host's
    # allocator, where one (F, 2, Lp) array is fresh pages every call.
    outs = []
    for i, m in enumerate(monos[:n_real]):
        y = ys[i // span][i % span]
        with device_scope(y.device):
            outs.append(np.clip(y.cpu().numpy()[:, : m.shape[0]], -1.0, 1.0).T.copy())
    return outs


class _Pipeline:
    """Readback of a block's output: it goes into one of two pinned host
    buffers with a non-blocking copy and a CUDA event, and ``collect``
    waits on that event only.  The pipelined step collects block k-1's
    while block k runs; the synchronous step (its own instance) collects
    at once.  On the CPU the output tensor itself is kept."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.bufs = [torch.empty((CHANNELS_OUT, BLOCKSIZE), dtype=torch.float32,
                                     pin_memory=True) for _ in range(2)]
            self.next = 0

    def launch(self, y):
        """Start block y's readback; returns a handle for ``collect``."""
        if not self.cuda:
            return y
        buf = self.bufs[self.next][:, : y.shape[1]]
        self.next ^= 1
        buf.copy_(y, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(y.device))
        return buf, ev

    def collect(self, handle):
        if not self.cuda:
            return handle.numpy().T.copy()
        buf, ev = handle
        ev.synchronize()
        return buf.numpy().T.copy()


class AudioEngine:
    def __init__(self, data_queues=None, device="cuda"):
        self.device = require_device(device)
        self.data_queues = data_queues or {
            "input": queue.Queue(maxsize=200),
            "output": queue.Queue(maxsize=200),
        }
        self.current_sample_rate = SAMPLE_RATE
        self.is_running = False
        self.is_processing_file = False
        self.status_count = 0
        self.stream = None
        self.chain = None
        self.last_chain_config = []
        self.last_file_contents = None
        # User-selected (input, output) PortAudio device indices; None means
        # OS default.  Applied at the next mic-stream start.
        self.devices = (None, None)
        # Live file stream: lossless processed-block queue for playback, its
        # thread and stop event (published together, after the start).
        self.playback_queue = None
        self._file_thread = None
        self._file_stream_stop = None
        self._lock = threading.Lock()  # guards (chain, state, targets) swaps
        # Serializes block steps and state snapshots: two concurrent
        # producers (mic callback, file-stream thread) must not both step
        # from one state, and save_session must not copy a state a step is
        # about to replace.
        self._step_lock = threading.Lock()
        self._param_lock = threading.Lock()  # serializes update_param writers
        self._tap_lock = threading.Lock()  # one producer at a time on the plot rings
        # Held by start_file_stream from the thread's start to its
        # publication; the thread's exit takes it before it may clear
        # is_running, so it never clears the flag ahead of the publication.
        self._publish_lock = threading.Lock()
        self._targets_map = {}
        self._runner = None  # the chain's step runner, swapped with the chain
        self._pending = None  # depth-1 pipeline: (chain, readback handle)
        self._pipeline = _Pipeline(self.device)
        self._readback = _Pipeline(self.device)  # the synchronous step's
        self._staging = Staging((CHANNELS_IN, BLOCKSIZE), self.device)
        # Uploaded convreverb IRs: {effect_id: ((ch, n) float32, ir_fs)};
        # learned spectral noise profiles: {effect_id: (bins,) float32}.
        # Both ride session checkpoints and are pruned when their effect
        # leaves the chain.
        self.custom_irs = {}
        self.noise_profiles = {}
        # Live noise capture in flight: {"need": blocks, "blocks": [...],
        # "done": Event}; _tap_plots appends input blocks while set.
        self._noise_capture = None
        self.metrics = BlockTimer(self.current_sample_rate, BLOCKSIZE)
        # Request ids of the tracer's spans: stream blocks and uploads.
        self._blocks = itertools.count()
        self._uploads = itertools.count()
        self.build_chain([])

    @property
    def chain_state(self):
        """The live state tree: copies of the step runner's static groups
        (None without a chain).  Assigning a tree writes it into them."""
        with self._lock:
            runner = self._runner
        return None if runner is None else runner.unpack_state()

    @chain_state.setter
    def chain_state(self, state):
        with self._step_lock, self._lock, device_scope(self.device):
            self._runner.write_state(self._runner.pack_state(state))

    # -- chain lifecycle (engine.py:38-65) ------------------------------
    def _warm_runner(self, chain, state, targets):
        """The chain's step runner with ``state`` and ``targets`` in its
        static buffers, warmed up (two dummy blocks) and captured off the
        audio path, so the first live block after a rebuild pays neither
        kernel loading, cuFFT plan setup nor the capture (core.py:131-136).
        On the card a failure raises, naming the chain's effects."""
        chain.warmup(state, targets)
        return chain.packed_step()

    def _build(self, effects_config):
        """(chain, fresh state, targets map) for ``effects_config`` at the
        current rate, with the session's IRs and noise profiles."""
        return build_chain(
            effects_config, self.current_sample_rate, BLOCKSIZE,
            channels_in=CHANNELS_IN, channels_out=CHANNELS_OUT,
            static_overrides=self._ir_overrides(effects_config, self.current_sample_rate),
            device=self.device,
        )

    def _swap(self, chain, runner, targets_map, config):
        with self._lock:
            old = self.chain
            self.chain = chain
            # Swapped together with the chain, so readers holding _lock
            # always see a (chain, config) pair that belongs together.
            self.last_chain_config = config
            self._runner = runner
            self._targets_map = targets_map
            self._pending = None  # an in-flight block belongs to the old chain
        if old is not None and old is not chain:
            # The serving processes run with gc disabled: break the old
            # chain's runner cycle or it, its graph and the graph's memory
            # pool leak on every rebuild (Chain.release).  A step that took
            # the old runner before the swap holds the step lock until its
            # output's readback is enqueued: the release waits for it.
            with self._step_lock:
                old.release()

    def _ir_overrides(self, effects_config, fs):
        """Static-override map carrying uploaded IRs and learned noise
        profiles into a chain build (IRs resampled to the build rate);
        prunes entries whose effect left the chain."""
        from aefs_tpu_torch.engine.checkpoint import (
            ir_static_overrides, profile_static_overrides,
        )

        ids = {c.get("effect_id") for c in effects_config}
        self.custom_irs = {k: v for k, v in self.custom_irs.items() if k in ids}
        self.noise_profiles = {
            k: v for k, v in self.noise_profiles.items() if k in ids
        }
        out = ir_static_overrides(self.custom_irs, effects_config, fs)
        for eid, extra in profile_static_overrides(
            self.noise_profiles, effects_config
        ).items():
            out.setdefault(eid, {}).update(extra)
        return out

    def _effect_kind(self, effect_id):
        return {c.get("effect_id"): c.get("type") for c in self.last_chain_config}.get(effect_id)

    def set_ir(self, effect_id: str, contents: str) -> float:
        """Install a user-uploaded IR WAV (base64 data URL) on a convreverb
        in the current chain and rebuild so it takes effect.  Returns the
        IR length in seconds."""
        if self._effect_kind(effect_id) != "convreverb":
            raise ValueError(
                f"effect ID '{effect_id}' is not a convreverb in the "
                "current chain"
            )
        audio, fs_ir = _decode_data_url(contents)
        ir = audio.T if audio.ndim > 1 else audio[None, :]
        self.custom_irs[effect_id] = (np.asarray(ir, np.float32), int(fs_ir))
        self.build_chain(self.last_chain_config)
        return ir.shape[-1] / float(fs_ir)

    def learn_noise(self, effect_id: str, contents: str = None,
                    seconds: float = 2.0) -> float:
        """Learn a per-bin noise profile for a spectral filter in the
        current chain and rebuild so the gate thresholds per bin.  Sources:

        - ``contents``: a noise-only WAV (base64 data URL), resampled to
          the engine rate when it differs;
        - live capture (``contents is None``): the next ``seconds`` of
          streaming input audio.  Needs an active stream; blocks the
          calling thread until the capture completes.  One at a time.

        Returns the measured mean noise floor in dBFS."""
        from aefs_tpu_torch.models.spectral import measure_noise_profile

        if self._effect_kind(effect_id) != "spectral":
            raise ValueError(
                f"effect ID '{effect_id}' is not a spectral filter in the "
                "current chain"
            )
        if contents is not None:
            audio, fs_wav = _decode_data_url(contents)
            mono = audio.mean(axis=1) if audio.ndim > 1 else audio
            if int(fs_wav) != int(self.current_sample_rate):
                # Profile bins are indexed against the ENGINE rate: an
                # off-rate WAV analyzed raw would map every per-bin
                # threshold to the wrong frequency.
                from aefs_tpu_torch.engine.wavio import resample_bandlimited

                n_out = max(
                    8,
                    int(round(len(mono) * self.current_sample_rate / fs_wav)),
                )
                mono = resample_bandlimited(mono, n_out)
        else:
            need = max(1, int(round(float(seconds) * self.current_sample_rate
                                    / BLOCKSIZE)))
            cap = {"need": need, "blocks": [], "done": threading.Event()}
            with self._lock:
                # A second concurrent capture would steal this one's blocks.
                if self._noise_capture is not None:
                    raise ValueError(
                        "a noise capture is already in progress"
                    )
                self._noise_capture = cap
            try:
                if not cap["done"].wait(timeout=float(seconds) + 10.0):
                    raise ValueError(
                        "no streaming audio to learn from — start the mic "
                        "or a file stream, or upload a noise WAV"
                    )
            finally:
                with self._lock:
                    if self._noise_capture is cap:
                        self._noise_capture = None
            mono = np.concatenate(cap["blocks"])
        profile = measure_noise_profile(mono, hop=BLOCKSIZE)
        self.noise_profiles[effect_id] = profile
        self.build_chain(self.last_chain_config)
        floor = max(float(profile.mean()), 1e-10)
        # Mean |rfft| of a Hann frame scales with n_fft/4; normalize to a
        # rough dBFS figure for the UI status line.
        return 20.0 * float(np.log10(floor / (2 * BLOCKSIZE / 4)))

    def build_chain(self, effects_config):
        with device_scope(self.device):
            chain, state, targets_map = self._build(effects_config)
            runner = self._warm_runner(chain, state, chain.targets(targets_map))
        self._swap(chain, runner, targets_map, effects_config)

    def update_param(self, effect_id: str, param_name: str, value: float):
        """Route a live parameter change (engine.py:131-145): rewrite the
        target; the audio path glides toward it one clamped step per
        block.  Unknown ids/names print the reference's warnings.

        The targets are built and packed outside the locks (an upload),
        then copied into the runner's static target buffer under the step
        lock: the captured graph reads that buffer, so a swapped-in new
        tensor would never reach it."""
        with self._param_lock:
            with self._lock:
                chain, runner = self.chain, self._runner
                targets_map = {k: dict(v) for k, v in self._targets_map.items()}
            models = dict(chain.effects)
            if effect_id not in models:
                print(f"Error: effect ID '{effect_id}' not found")
                return
            spec = models[effect_id].PARAMS.get(param_name)
            if spec is None:
                print(f"Warning: parameter '{param_name}' in effect "
                      f"'{effect_id}' could not be updated")
                return
            targets_map.setdefault(effect_id, {})[param_name] = float(value)
            with device_scope(self.device):
                tgroups = runner.pack_targets(chain.targets(targets_map))
                with self._step_lock, self._lock:
                    if self.chain is chain:
                        runner.write_targets(tgroups)
                        self._targets_map = targets_map
                        # File mode rebuilds from the config: keep it in sync
                        # with the live (clamped) value.
                        for cfg in self.last_chain_config:
                            if cfg.get("effect_id") == effect_id:
                                cfg.setdefault("params", {})[param_name] = spec.clamp(value)
                                break

    # -- session checkpoint/resume (engine/checkpoint.py) ----------------
    def save_session(self, path: str) -> str:
        """Checkpoint the live session (chain config, parameter targets,
        the full audio-state tree, uploaded IRs and noise profiles) to a
        directory; returns the path."""
        from aefs_tpu_torch.core.convert import state_to_numpy
        from aefs_tpu_torch.engine.checkpoint import save_session

        # Snapshot under the step lock (the runner's copies of its static
        # groups, enqueued before any later step rewrites them); the copy to
        # the host follows outside it.
        with device_scope(self.device):
            with self._step_lock:
                with self._lock:
                    chain, runner, tmap = self.chain, self._runner, self._targets_map
                    irs = dict(self.custom_irs)
                    profiles = dict(self.noise_profiles)
                    fs = self.current_sample_rate
                state = runner.unpack_state()
            state = state_to_numpy(state)
        # The snapshotted chain's own config, never last_chain_config: a
        # concurrent rebuild may already have replaced it, and a
        # checkpoint pairing a new config with this state is unloadable.
        save_session(path, chain.source_config, tmap, state, custom_irs=irs,
                     noise_profiles=profiles, fs=fs)
        return path

    def resume_session(self, path: str):
        """Rebuild the chain from a checkpoint and graft the saved audio
        state onto it: ring buffers, filter taps and phasors continue
        bit-exact.  Returns the restored chain config."""
        from aefs_tpu_torch.engine.checkpoint import load_session, remap_profiles

        (chain_config, targets_map, rebuild_state, irs,
         profiles, ck_meta) = load_session(path)
        # Profile bins are fs-dependent: re-bin a checkpoint saved at
        # another rate onto this engine's analysis grid.
        profiles = remap_profiles(profiles, ck_meta.get("fs"),
                                  self.current_sample_rate)
        # For every effect id the checkpoint's config names, the checkpoint
        # is the sole source of truth: an IR or profile learned in-process
        # for that id but absent from the checkpoint must not survive.
        ids = {c.get("effect_id") for c in chain_config}
        self.custom_irs = {
            k: v for k, v in self.custom_irs.items() if k not in ids
        }
        self.noise_profiles = {
            k: v for k, v in self.noise_profiles.items() if k not in ids
        }
        self.custom_irs.update(irs)
        self.noise_profiles.update(profiles)
        with device_scope(self.device):
            chain, _, _ = self._build(chain_config)
            state = rebuild_state(chain.init_state())
            runner = self._warm_runner(chain, state, chain.targets(targets_map))
        self._swap(chain, runner, targets_map, chain_config)
        return chain_config

    # -- block streaming ------------------------------------------------
    def _step_held(self, in_block, seq):
        """One block step of request ``seq``; the caller holds the step
        lock and has the card current -> (the chain it ran on, y).  The
        block goes through pinned staging into the runner's static x (no
        wait on the stream), then the runner steps: one graph replay on
        the card.  A chain swapped mid-block keeps its own state, as in the
        reference's benign rebuild race."""
        with self._lock:
            chain, runner = self.chain, self._runner
        with TRACER.span("engine.stage", seq):
            self._staging.put(np.asarray(in_block, np.float32).T, runner.x)
        with TRACER.span("chain.replay", seq):
            y = runner.run()[1]
        return chain, y

    def process_stream_block(self, in_block: np.ndarray) -> np.ndarray:
        """One hot-path block: (N, ci) float32 in -> (N, co) float32 out.
        Timed by ``self.metrics``; feeds the plot queues like the
        reference's PlotDataTap chain heads/tails (core.py:89-106)."""
        seq = next(self._blocks)
        with self.metrics.block(seq), device_scope(self.device):
            with self._step_lock:
                _, y = self._step_held(in_block, seq)
                with TRACER.span("engine.readback", seq):
                    handle = self._readback.launch(y)
            with TRACER.span("engine.collect", seq):
                out = self._readback.collect(handle)
        with TRACER.span("engine.tap", seq):
            self._tap_plots(in_block, out)
        TRACER.count("engine.blocks")
        return out

    def process_stream_block_pipelined(self, in_block: np.ndarray) -> np.ndarray:
        """Depth-1 pipelined hot path: step block k, return block k-1's
        processed audio (one block of added latency, 5.33 ms @ 48 kHz).
        The host enqueues block k while the device finishes block k-1, and
        waits only on block k-1's readback.  Priming and a chain swap
        return one silent block."""
        seq = next(self._blocks)
        with self.metrics.block(seq), device_scope(self.device):
            with self._step_lock:
                chain, y = self._step_held(in_block, seq)
                with TRACER.span("engine.readback", seq):
                    handle = self._pipeline.launch(y)
                with self._lock:
                    pending, self._pending = self._pending, (chain, handle)
                if pending is not None and pending[0] is chain:
                    with TRACER.span("engine.collect", seq):
                        out = self._pipeline.collect(pending[1])
                else:
                    TRACER.count("engine.silent_blocks")
                    out = np.zeros((in_block.shape[0], CHANNELS_OUT), np.float32)
        with TRACER.span("engine.tap", seq):
            self._tap_plots(in_block, out)
        TRACER.count("engine.blocks")
        return out

    def _tap_plots(self, in_block, out):
        """Feed the plot queues as a pair: drop both blocks or neither (an
        independent drop could desynchronize the two rings forever)."""
        cap = self._noise_capture
        if cap is not None and not cap["done"].is_set():
            # learn_noise live capture: collect mono input blocks host-side.
            cap["blocks"].append(
                np.asarray(in_block, np.float32).mean(axis=1))
            if len(cap["blocks"]) >= cap["need"]:
                cap["done"].set()
        fanned = np.repeat(in_block, 2, axis=1) if in_block.shape[1] == 1 else in_block
        qin, qout = self.data_queues["input"], self.data_queues["output"]
        with self._tap_lock:
            try:
                if not (qin.full() or qout.full()):
                    qin.put_nowait(fanned.copy())
                    qout.put_nowait(out.copy())
            except queue.Full:
                pass

    def _set_rate(self, fs):
        """Sample-rate renegotiation: the chain and the deadline the
        metrics judge xruns against both depend on the rate."""
        self.current_sample_rate = int(fs)
        self.metrics = BlockTimer(int(fs), BLOCKSIZE)
        print(f"Rebuilding effects chain for {fs} Hz...")
        self.build_chain(self.last_chain_config)

    # -- mic stream (engine.py:147-190) ---------------------------------
    def start_mic_stream(self):
        if self.is_running:
            print("Warning: stream is already running")
            return
        if sd is None:
            print("Server Mode: Microphone hardware not available. Stream ignored.")
            return

        step = (
            self.process_stream_block
            if os.environ.get("AEFS_STREAM_PIPELINE", "1") == "0"
            else self.process_stream_block_pipelined
        )

        def callback(indata, outdata, frames, t, status):
            if status:
                self.status_count += 1
            outdata[:] = step(np.asarray(indata, np.float32))

        try:
            kwargs = {}
            if self.devices != (None, None):
                kwargs["device"] = self.devices
            self.stream = sd.Stream(
                samplerate=self.current_sample_rate,
                blocksize=BLOCKSIZE,
                dtype="float32",
                latency="low",
                channels=(CHANNELS_IN, CHANNELS_OUT),
                callback=callback,
                prime_output_buffers_using_stream_callback=True,
                **kwargs,
            )
            self.stream.start()
            self.is_running = True
            actual = int(self.stream.samplerate)
            if actual != self.current_sample_rate:
                self._set_rate(actual)
        except Exception as e:  # the device layer reports, the server keeps running
            print(f"Error on stream start: {e}")

    # -- live file stream ------------------------------------------------
    def start_file_stream(self, contents: str = None, realtime: bool = True):
        """Stream a WAV through the live hot path: the file replaces the
        microphone as the block source, so parameter changes apply while it
        plays.  Processed blocks go to ``self.playback_queue`` (lossless) as
        ``(seq, (N, 2) float32)`` pairs, terminated by ``None``.
        ``realtime=True`` paces the blocks at the audio cadence; ``False``
        runs flat-out.  Returns True iff a stream started."""
        if self.is_running:
            print("Warning: stream is already running")
            return False
        contents = contents or self.last_file_contents
        if not contents:
            print("Warning: no file uploaded yet; nothing to stream")
            return False
        self.last_file_contents = contents

        audio, fs = _decode_data_url(contents)
        if audio.ndim > 1:  # same downmix as file mode (process_offline)
            mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
        else:
            mono = audio.reshape(-1, 1).astype(np.float32)
        if fs != self.current_sample_rate:
            self._set_rate(fs)

        n = mono.shape[0]
        pad = (-n) % BLOCKSIZE
        if pad:
            mono = np.concatenate([mono, np.zeros((pad, 1), np.float32)])
        # The thread writes to its own queue (captured), so two racing
        # starts cannot cross-post.
        pq = self.playback_queue = queue.Queue()
        stop = threading.Event()
        period = BLOCKSIZE / float(fs)
        n_blocks = mono.shape[0] // BLOCKSIZE

        def run():
            import time

            try:
                next_t = time.monotonic()
                for seq in range(n_blocks):
                    if stop.is_set():
                        break
                    out = self.process_stream_block(mono[seq * BLOCKSIZE:(seq + 1) * BLOCKSIZE])
                    if seq == n_blocks - 1 and pad:
                        out = out[: BLOCKSIZE - pad]  # trim tail padding
                    pq.put((seq, out))
                    if realtime:
                        next_t += period
                        delay = next_t - time.monotonic()
                        if delay > 0:
                            time.sleep(delay)
                        else:  # fell behind: don't burst
                            next_t = time.monotonic()
            except Exception as e:  # the stream thread reports and ends
                print(f"Error in file stream: {e}")
            finally:
                # Natural end only, and only once this thread is published:
                # when stop_stream stopped it, stop_stream owns the flag.
                with self._publish_lock:
                    if self._file_stream_stop is stop and not stop.is_set():
                        self.is_running = False
                pq.put(None)

        t = threading.Thread(target=run, daemon=True)
        self.is_running = True
        with self._publish_lock:
            t.start()
            # The stop event is published together with the started thread:
            # a stop_stream landing before this line sees the previous
            # (thread, event) pair and cannot stop or join the new stream.
            with self._lock:
                self._file_thread, self._file_stream_stop = t, stop
            self.is_running = True
        return True

    def set_devices(self, in_index, out_index):
        """Select the (input, output) device pair for the next stream start;
        a running mic stream is restarted so the change applies.  A live
        file stream is left alone."""
        self.devices = (
            int(in_index) if in_index is not None else None,
            int(out_index) if out_index is not None else None,
        )
        if self.is_running and self.stream is not None:
            self.stop_stream()
            self.start_mic_stream()

    def stop_stream(self):
        if self.stream:
            self.stream.stop()
            self.stream.close()
            self.stream = None
            self.is_running = False
        with self._lock:
            t, stop = self._file_thread, self._file_stream_stop
            self._file_thread = None
        if t is not None:
            stop.set()
            if t is not threading.current_thread():
                t.join(timeout=30)
            # The stopping side owns the flag (the thread skips it once its
            # stop event is set).
            self.is_running = False
        with self._lock:
            self._pending = None

    def close(self):
        """End-of-session teardown: stop the streams, drop the chain and
        release it (its runner's graph and memory pool), so the engine
        frees by refcounting alone (the server disables gc)."""
        self.stop_stream()
        with self._lock:
            chain, self.chain, self._runner = self.chain, None, None
        if chain is not None:
            with self._step_lock:
                chain.release()

    # -- file mode (engine.py:67-129) -----------------------------------
    def process_file_array(self, audio: np.ndarray, fs: int):
        """(frames, ch) float32 -> (mono, (frames, 2) float32) through a
        fresh chain built from the last config at the file's sample rate,
        with the session's IRs and noise profiles."""
        return process_offline(
            self.last_chain_config, audio, fs,
            extra_static=self._ir_overrides(self.last_chain_config, fs),
            device=self.device,
        )

    def _render(self, audio, fs, rid):
        """``process_file_array`` as an upload makes it (the executor's
        side of the hop), timed as ``engine.render`` of upload ``rid``."""
        with TRACER.span("engine.render", rid):
            return self.process_file_array(audio, fs)

    async def process_wav_file(self, contents: str, websocket, taken=None):
        """Render an uploaded WAV (base64 data URL) and send the
        ``file_processed`` payload through ``websocket.send``.  Timed as
        ``front.upload`` from ``taken`` (the ``TRACER.clock()`` read when
        the backend's handler took the message; else now) until ``send``
        returns; its rid names the upload's spans on both sides of the
        executor hop.  Each of the two hops is kept as two ``front.hop``
        spans: the submit to the worker's start, and the worker's return to
        this coroutine running again."""
        upload = TRACER.span("front.upload", next(self._uploads), taken)
        if self.is_processing_file:
            print("Warning. A file is already being process. Ignoring new request")
            upload.close()
            return
        self.is_processing_file = True
        rid = upload.rid
        # Kept for the reprocess_file command and the file stream.
        self.last_file_contents = contents
        try:
            print("Info: Processing WAV")
            from aefs_tpu_torch import native
            from aefs_tpu_torch.engine import jsonfmt

            with TRACER.span("front.decode", rid):
                audio, fs = _decode_data_url(contents)
            loop = asyncio.get_running_loop()
            render = TRACER.hop("front.hop", rid, self._render)
            mono, processed = await loop.run_in_executor(None, render, audio, fs, rid)
            TRACER.landed(render)

            def serialize():
                analysis = None
                if os.environ.get("AEFS_SERVER_ANALYSIS", "1") == "1":
                    # Windowed spectrum/chroma for playback scrubbing.
                    from aefs_tpu_torch.utils.analysis import PlotAnalyzer

                    with TRACER.span("front.analysis", rid):
                        try:
                            analysis = PlotAnalyzer(fs, device=self.device).analyze_file_arrays(
                                mono[:, 0], processed.mean(axis=1)
                            )
                        except RuntimeError as e:
                            print(f"Warning: file analysis unavailable: {e}")
                with TRACER.span("front.serialize", rid):
                    with TRACER.span("front.wav", rid):
                        wav_bytes = encode_wav_int16(processed, fs)
                    with TRACER.span("front.b64", rid):
                        processed_b64 = b"data:audio/wav;base64," + native.b64encode(wav_bytes)
                    head = {
                        "type": "file_processed",
                        "original_b64": contents,
                        "processed_b64": processed_b64,
                        "sample_rate": int(fs),
                    }
                    if analysis is not None:
                        head["analysis"] = analysis
                    with TRACER.span("front.reply", rid):
                        return jsonfmt.reply(
                            head,
                            {"original_samples": mono.flatten(),
                             "processed_samples": processed.mean(axis=1)},
                            "front.samples", rid,
                        )

            serialize = TRACER.hop("front.hop", rid, serialize)
            reply = await loop.run_in_executor(None, serialize)
            TRACER.landed(serialize)
            with TRACER.span("front.send", rid):
                await websocket.send(reply)
            TRACER.count("front.uploads")
            TRACER.count("front.reply_bytes", len(reply))
        except Exception as e:  # a bad upload is reported, the session goes on
            print(f"Error processing WAV file: {e}")
        finally:
            upload.close()
            print("Success: Finished processing WAV file")
            self.is_processing_file = False
