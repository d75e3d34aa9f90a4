"""Multi-session pool server: many clients, ONE batched step per bucket
(port of aefs_tpu/server/pool.py).

The reference serves exactly one client per backend process
(backend.py:73-75).  A pool multiplexes many WebSocket sessions onto one
chain step with a leading slot axis (``Chain.process_block`` on
x (S, 1, N), every state leaf (S, ...) but the lockstep counters, and
(S,) targets; the JAX package vmaps the same step):

- sessions are BUCKETED BY CHAIN TOPOLOGY (one step serves one chain):
  every bucket is one ``SessionPool``, and a per-session ``build_chain``
  migrates the session's slot to the bucket matching its requested chain,
  building a new bucket on first use (``MultiPool``; the server starts with
  one default bucket from --preset/--config);
- every session owns a SLOT in its bucket: its own audio state and its own
  smoothed parameter targets, so per-session ``update_param`` works exactly
  like the single-session engine;
- clients stream mono blocks; pending blocks are batched per dispatch
  (idle slots process silence, which keeps their reverb/delay tails alive
  between submissions — live-session semantics).

One step launches each kernel of the chain once for all S slots (the
octaver's K1 and the chorus's K3 have a slot grid), so the launch count
per step does not grow with S.  On the card that step is one captured CUDA
graph (``core/packing.py:PackedRunner`` over ``HybridPacker`` groups: the
big rings stand alone, the small leaves share one buffer per dtype); the
blocks and the (P, S) targets reach its static buffers through pinned
staging, and a slot reset is grafted into them in place.  ``shard=True``
splits the slot axis over every visible card
(``parallel/mesh.py:visible_devices``): each card holds a contiguous slot
range with its own chain, state and graph, and a step replays each card's
graph in turn, with that card current.

Protocol (additive; one connection per session):

    -> {"command": "stream_block", "audio": [N floats]}
    <- {"type": "processed_block", "seq": k, "output": [...],
        "output_r": [...]}
    -> {"command": "build_chain", "effects_config": [...]}
    <- {"type": "chain_built", "slot": s, "chain": [...]}
    -> {"command": "update_param", "effect_id": id, "param": p, "value": v}
    -> {"command": "get_pool_stats"}
    <- {"type": "pool_stats", "slots": S, "active": a, "blocksize": N,
        "step_ms": t, "chain": [...], "n_buckets": b, "buckets": [...]}

Run: ``python -m aefs_tpu_torch.server.pool --preset "Rain Delay" --slots 16``
(on the card; ``--device cpu`` or ``AEFS_PLATFORM=cpu`` for the host).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import threading

import numpy as np
import torch

from aefs_tpu_torch.core.chain import build_chain, slot_ranges
from aefs_tpu_torch.core.packing import HybridPacker, PackedRunner, Staging
from aefs_tpu_torch.core.config import (
    BLOCKSIZE,
    CHANNELS_IN,
    CHANNELS_OUT,
    DEFAULT_PRESETS,
    SAMPLE_RATE,
    WS_MAX_MESSAGE,
)
from aefs_tpu_torch.parallel import mesh
from aefs_tpu_torch.utils.metrics import TRACER
from aefs_tpu_torch.utils.platform import device_scope, require_device, select_device

try:
    import websockets as ws
except ImportError:  # the handler itself does not need the package
    ws = None


def grid_static_overrides(chain_config):
    """Exact-grid serving specialization (opt-in): bake every whole-octave
    octaver's ratio so its streaming taps run on the integer phase grid
    (ops/gridtaps.py:octaver_taps_pow2_stream), phase-locked to one shared
    ``grid_phase`` the pool advances per dispatch; joining sessions start at
    the shared phase.  The baked ``semitones`` stops being live
    (update_param warns)."""
    from aefs_tpu_torch.ops.gridtaps import pow2_exponent

    overrides = {}
    for i, cfg in enumerate(chain_config):
        if cfg.get("type") != "octaver":
            continue
        st = cfg.get("params", {}).get("semitones", -12.0)
        if pow2_exponent(st) is not None:
            eid = cfg.get("effect_id") or f"fx{i}"
            overrides[eid] = {"grid_semitones": float(st), "grid_phase_lock": True}
    return overrides


def dict_copy(m):
    return {k: dict(v) for k, v in m.items()}


def _pool_step(chain, trows):
    """A shard's step ``fn(state, tflat, x)`` for its runner: the rows of
    the (P, S/n) target buffer are the chain's (S/n,) targets.  Closes over
    the chain and the row map, never over the pool: the serving process
    runs with gc disabled, and a pool -> runner -> fn -> pool cycle would
    never be freed."""
    effects = chain.effects

    def step(state, tflat, x):
        targets = tuple({name: tflat[trows[(i, name)]] for name in model.PARAMS}
                        for i, (eid, model) in enumerate(effects))
        return chain.process_block(state, targets, x)

    return step


class _Readback:
    """Depth-1 readback of a step's per-shard (S/n, co, N) outputs as one
    (S, co, N) array.  On the card each shard's copy goes into its slot
    range of one of two pinned host buffers with a non-blocking copy and a
    CUDA event recorded on that shard's stream, so the buffer handed back
    for step k-1 is never the one step k's copies are writing; on the CPU
    the outputs are the result."""

    def __init__(self, shape, device, ranges):
        self.cuda = device.type == "cuda"
        self.ranges = ranges
        if self.cuda:
            self.bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                         for _ in range(2)]
            self.next = 0

    def launch(self, ys):
        """Start the outputs' copy to the host; returns a function that
        waits for it and returns it as a numpy array."""
        if not self.cuda:
            return ys[0].numpy if len(ys) == 1 else lambda: torch.cat(ys).numpy()
        buf = self.bufs[self.next]
        self.next ^= 1
        events = []
        for (lo, hi), y in zip(self.ranges, ys):
            with device_scope(y.device):
                buf[lo:hi].copy_(y, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(y.device))
            events.append(ev)

        def collect():
            for ev in events:
                ev.synchronize()  # a fault of the step surfaces here
            return buf.numpy().copy()

        return collect


class SessionPool:
    """Batched multi-session runtime: slot allocation, per-slot targets,
    one batched chain step shared by every session.

    Each of the n devices (one without ``shard``) has a step runner over
    its slot range of S/n (``self._runners``; on the card a captured
    graph), and ``self.state`` holds each runner's static state groups.

    Locking is two-tier so control ops never wait on a device step:
    ``_ctrl_lock`` guards the HOST-side mutable maps (slot free-list,
    per-slot target maps, the (P, S) float32 target buffer, queued slot
    resets) and every control op (claim/release/update_param) touches only
    those; ``_step_lock`` serializes steps, which snapshot the target buffer
    and apply queued resets at the dispatch boundary."""

    def __init__(self, chain_config, n_slots: int = 16, fs: int = SAMPLE_RATE,
                 blocksize: int = BLOCKSIZE, shard: bool = False,
                 grid: bool = False, device="cuda"):
        """shard=True distributes the slot axis over every visible device of
        ``device``'s kind (``parallel/mesh.py:visible_devices``): a pool of
        4 cards hosts 4x the sessions of one; n_slots must divide the
        device count; on one device it does nothing, as in JAX.
        grid=True bakes whole-octave octaver ratios for exact-grid serving
        (see ``grid_static_overrides``).  ``device``: the card unless the
        caller asks for the CPU (no fallback)."""
        self.device = require_device(device)
        self.devices = list(mesh.visible_devices(self.device)) if shard else [self.device]
        if len(self.devices) > 1 and int(n_slots) % len(self.devices):
            raise ValueError(f"n_slots={n_slots} must divide over "
                             f"{len(self.devices)} devices")
        self.n_slots = int(n_slots)
        self.fs = int(fs)
        self.blocksize = int(blocksize)
        self.grid = bool(grid)
        self.shard = bool(shard)
        self.chain_config = chain_config
        self.chain, single_state, self._tmap0 = build_chain(
            chain_config, fs, blocksize, channels_in=CHANNELS_IN,
            channels_out=CHANNELS_OUT, device=self.devices[0],
            static_overrides=grid_static_overrides(chain_config) if grid else None)
        self._chains = [self.chain.on_device(d) for d in self.devices]
        self._ranges = slot_ranges(self.n_slots, len(self.devices))
        self._fresh_single = single_state
        # Per-slot parameter targets: host-side maps + ONE host buffer
        # tbuf[row, slot] (row = (effect, param) in chain order), shipped
        # with each dispatch as one tensor whose rows are the (S,) targets.
        self._targets_maps = [dict_copy(self._tmap0) for _ in range(self.n_slots)]
        self._trows = {}
        specs = []
        for i, (eid, model) in enumerate(self.chain.effects):
            for name in model.PARAMS:
                self._trows[(i, name)] = len(specs)
                specs.append((i, name, model.PARAMS[name]))
        self._tbuf = np.zeros((len(specs), self.n_slots), np.float32)
        for i, name, spec in specs:
            self._tbuf[self._trows[(i, name)], :] = spec.clamp(
                self._tmap0.get(self.chain.effects[i][0], {}).get(name, spec.default))
        self._tbuf0 = self._tbuf.copy()  # fresh-slot column template
        # Phase-locked grid rows: one shared integer phase (every column
        # equal), advanced host-side once per dispatch, never reset per slot.
        # Below 2^24, so exact in the float32 buffer.
        self._phase_rows = {
            self._trows[(i, "grid_phase")]: model
            for i, (eid, model) in enumerate(self.chain.effects)
            if (i, "grid_phase") in self._trows
        }
        self._readback = _Readback((self.n_slots, CHANNELS_OUT, self.blocksize),
                                   self.devices[0], self._ranges)
        # (collect, slots) of the dispatch whose readback the NEXT step does.
        self._inflight = None
        self._ctrl_lock = threading.Lock()
        self._step_lock = threading.Lock()
        self._pending_resets = []
        self._free = list(range(self.n_slots))
        self.last_step_ms = 0.0  # the last step's pool.step span
        self.generation = 0  # steps made: the tracer's request id of a step
        # One runner per shard, warmed up and captured off the serving path.
        # The warm-up is discarded (the runner restores its buffers): a
        # kept warm step would advance every slot's phase and glide state
        # by one silent block before any session arrives.
        self._runners, self._stages = [], []
        label = f"{self.chain.label()} pool of {self.n_slots} slots"
        for chain, state, dev, (lo, hi) in zip(self._chains, self._fresh_batched_state(),
                                               self.devices, self._ranges):
            with device_scope(dev):
                runner = PackedRunner(
                    _pool_step(chain, self._trows), state,
                    torch.from_numpy(self._tbuf[:, lo:hi].copy()).to(dev),
                    x_shape=(hi - lo, CHANNELS_IN, self.blocksize), device=dev,
                    packer=HybridPacker, label=f"{label} on {dev}")
                runner.prepare()
            self._runners.append(runner)
            self._stages.append((Staging(self._tbuf[:, lo:hi].shape, dev),
                                 Staging((hi - lo, CHANNELS_IN, self.blocksize), dev)))
        self.state = [r.sgroups for r in self._runners]

    def _fresh_batched_state(self):
        """Fresh per-slot audio state for every slot, one tree per shard;
        also the recovery state after a step or its readback failed."""
        batched = self.chain.batch_state(self._fresh_single, self.n_slots)
        if len(self.devices) == 1:
            return [batched]
        return self.chain.split_slots(batched, self.devices)

    def _reset_state(self):
        """Every slot's state fresh, written into the runners' buffers."""
        for runner, dev, state in zip(self._runners, self.devices,
                                      self._fresh_batched_state()):
            with device_scope(dev):
                runner.write_state(runner.pack_state(state))

    def _step(self, tbuf, x):
        """Every shard's step, launched in turn with its card current: the
        shard's columns of the (P, S) host targets and its rows of the
        (S, ci, N) host blocks go through pinned staging into the runner's
        static buffers (non-blocking), then its graph replays.  Returns the
        outputs (the runners' static ``y`` on the card), one per shard."""
        ys = []
        for runner, (t_stage, x_stage), dev, (lo, hi) in zip(
                self._runners, self._stages, self.devices, self._ranges):
            with device_scope(dev):
                t_stage.put(tbuf[:, lo:hi], runner.tgroups[0].view(-1, hi - lo))
                x_stage.put(x[lo:hi], runner.x)
                ys.append(runner.run()[1])
        return ys

    # -- slots (control plane: host-only, never waits on a dispatch) ------
    def claim(self):
        with self._ctrl_lock:
            if not self._free:
                return None
            return self._free.pop(0)

    def active_count(self):
        with self._ctrl_lock:
            return self.n_slots - len(self._free)

    def _slot_targets_held(self, slot: int, tmap):
        """Set one slot's targets from a {bucket-effect-id: {param: value}}
        map (missing params fall to spec defaults, values clamp like
        SmoothParam.set_target).  Caller holds ``_ctrl_lock``.  Shared
        grid-phase rows keep the pool clock (release()'s rule)."""
        self._targets_maps[slot] = dict_copy(tmap)
        for (i, name), row in self._trows.items():
            if row in self._phase_rows:
                continue
            eid, model = self.chain.effects[i]
            spec = model.PARAMS[name]
            self._tbuf[row, slot] = spec.clamp(tmap.get(eid, {}).get(name, spec.default))

    def claim_configured(self, tmap, single):
        """Claim a slot carrying a SESSION's own initial parameters and
        fresh audio state (heterogeneous-pool joins / migrations): ``tmap``
        is the session's targets map keyed by this pool's effect ids and
        ``single`` its fresh single-slot state (the ``build_chain`` seeds a
        dedicated pool of that config would use, so a migrated session is
        bit-identical to one served solo).  The state graft is queued and
        applied at the next dispatch boundary, like release()'s reset.
        Returns the slot, or None when full."""
        with self._ctrl_lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self._slot_targets_held(slot, tmap)
            self._pending_resets.append((slot, single))
        return slot

    def rebuild_slot(self, slot: int, tmap, single):
        """In-place rebuild of a claimed slot (same-topology build_chain:
        the reference's rebuild semantics — fresh state, new params —
        without slot churn)."""
        with self._ctrl_lock:
            self._slot_targets_held(slot, tmap)
            self._pending_resets.append((slot, single))

    def release(self, slot: int):
        """Reset the slot to default targets, queue its audio-state reset
        (applied by the next dispatch), and return it to the pool.  Pure
        host work: a leaving session never blocks on the device."""
        with self._ctrl_lock:
            self._targets_maps[slot] = dict_copy(self._tmap0)
            keep = {r: self._tbuf[r, slot] for r in self._phase_rows}
            self._tbuf[:, slot] = self._tbuf0[:, slot]
            for r, v in keep.items():  # the shared phase survives slot churn
                self._tbuf[r, slot] = v
            self._pending_resets.append((slot, None))
            self._free.append(slot)

    def update_param(self, slot: int, effect_id: str, param: str, value):
        """Rewrite one slot's target — a host array write (microseconds);
        the next dispatch ships the updated buffer.  Never touches the
        device and never waits on the step lock."""
        models = dict(self.chain.effects)
        if effect_id not in models:
            return f"Error: effect ID '{effect_id}' not found"
        model = models[effect_id]
        if param not in model.PARAMS:
            return (f"Warning: parameter '{param}' in effect "
                    f"'{effect_id}' could not be updated")
        if param == "semitones" and getattr(model, "_grid_e", None) is not None:
            return ("Warning: 'semitones' is grid-specialized (static) in "
                    "this pool and cannot be updated live")
        if param == "grid_phase":
            return "Warning: 'grid_phase' is pool-managed and not settable"
        eff_index = [eid for eid, _ in self.chain.effects].index(effect_id)
        with self._ctrl_lock:
            self._targets_maps[slot].setdefault(effect_id, {})[param] = float(value)
            self._tbuf[self._trows[(eff_index, param)], slot] = (
                model.PARAMS[param].clamp(float(value)))
        return None

    def _apply_pending_resets(self, resets):
        """Graft single-slot state into the runners' static state buffers,
        in place, for every queued (slot, single) entry — ``single`` is None
        for a plain release (fresh default state) or a session-configured
        seed from claim_configured/rebuild_slot.  Rare; runs under the step
        lock, stream-ordered after the steps already enqueued."""
        span = self.n_slots // len(self.devices)
        for slot, single in resets:
            i, local = divmod(slot, span)
            runner = self._runners[i]
            with device_scope(self.devices[i]):
                self._chains[i].graft_slot_state_(
                    runner.state_packer.unpack(runner.sgroups),
                    single if single is not None else self._fresh_single, local)

    # -- batched step ------------------------------------------------------
    def step_blocks(self, blocks: dict[int, np.ndarray]):
        """Synchronous batched dispatch: ``blocks`` maps slot -> (N,) mono
        float32; idle slots process silence.  Returns {slot: (N, co)} for
        THIS batch — a pipelined step followed by an immediate flush.  Do
        not interleave with pipelined callers (guarded)."""
        if self._inflight is not None:
            raise RuntimeError("a pipelined batch is in flight; flush_pipeline() first")
        self.step_blocks_pipelined(blocks)
        return self.flush_pipeline()

    def step_blocks_pipelined(self, blocks: dict[int, np.ndarray]):
        """Depth-1 pipelined batched step: enqueue THIS batch's step, return
        the PREVIOUS batch's results (None when the pipeline was empty).
        Batch k-1's readback overlaps batch k's launches; sessions see one
        extra block of latency.  Bit-parity with the sync path is exact —
        the same step, only the readback is deferred."""
        x = np.zeros((self.n_slots, CHANNELS_IN, self.blocksize), np.float32)
        for slot, audio in blocks.items():
            x[slot, 0, : len(audio)] = audio[: self.blocksize]
        with self._step_lock:
            # Dispatch boundary: apply queued slot resets and snapshot the
            # target buffer (the only points where control state meets the
            # device path — both brief).
            with self._ctrl_lock:
                resets, self._pending_resets = self._pending_resets, []
                tbuf = self._tbuf.copy()
            if resets:
                self._apply_pending_resets(resets)
            self.generation += 1
            TRACER.count("pool.steps")
            step = TRACER.timed("pool.step", self.generation)
            ys = self._step(tbuf, x)
            prev, self._inflight = self._inflight, (self._readback.launch(ys), tuple(blocks))
            # Advance the shared grid phase(s) for the block just enqueued
            # (every slot stepped, idle ones on silence).
            if self._phase_rows:
                with self._ctrl_lock:
                    for r, model in self._phase_rows.items():
                        adv, mod = model.grid_phase_advance(self.blocksize)
                        self._tbuf[r, :] = (self._tbuf[r, 0] + adv) % mod
            if prev is None:
                step.close()
                self.last_step_ms = step.ns / 1e6
                return None
            out = self._collect_held(prev)  # waits on dispatch k-1 only
            step.close()
            self.last_step_ms = step.ns / 1e6
        return {slot: out[slot].T for slot in prev[1]}

    def _collect_held(self, inflight):
        """Read back one in-flight generation; the caller holds the step
        lock.  A fault of the step surfaces at the readback, after
        self.state was replaced by the failed step's output: reset it, or
        every later step runs on a poisoned state.  Sessions keep their
        slots; their audio tails restart from silence."""
        try:
            return inflight[0]()
        except Exception:
            self._inflight = None
            print("Error: pool readback failed; resetting slot state")
            self._reset_state()
            raise

    def flush_pipeline(self):
        """Read back the in-flight batch ({slot: (N, co)}, or None if the
        pipeline is empty).  Called by the batcher when no new submissions
        arrive within a block period — the last block of a pausing stream
        must not wait for the next one."""
        with self._step_lock:
            prev, self._inflight = self._inflight, None
            if prev is None:
                return None
            out = self._collect_held(prev)
        return {slot: out[slot].T for slot in prev[1]}

    def drop_pipeline(self):
        """Abandon the in-flight batch (error recovery: after a failed
        pipelined step the batcher fails both generations' futures and
        restarts the pipeline clean — a transient lost block, never a
        mismatched delivery)."""
        with self._step_lock:
            self._inflight = None

    def close(self):
        """Drop the pool's device state so a discarded pool frees at once
        (the serving process runs with gc.disable()).  The pool must not be
        stepped after close; idempotent."""
        with self._step_lock:
            self._inflight = None
            self.state = None
            for runner in self._runners:
                runner.release()
            self._runners = []


def canonical_topology(effects_config, grid: bool = False):
    """Canonicalize a chain config into its topology-bucket identity.

    Returns (key, canon_config, session_ids):
      key          — string naming everything that shapes the bucket's step:
                     effect types in order plus each effect's static
                     constructor config (window sizes, comb topology,
                     branch structure, grid-baked ratios) and nothing that
                     is a live runtime target.  Configs with equal keys
                     share one bucket.
      canon_config — the same config with effect ids rewritten to the
                     positional fx{i} convention (session-id-free), fit to
                     build a shared bucket chain.
      session_ids  — the session's effect ids positionally (only the
                     entries a chain build keeps), for the session-id ->
                     bucket-id routing map.
    """
    from aefs_tpu_torch.core.multiband import expand_multiband
    from aefs_tpu_torch.models import EFFECT_REGISTRY
    from aefs_tpu_torch.ops.gridtaps import pow2_exponent

    def entry_key(cfg):
        etype = cfg.get("type")
        if etype == "multiband":
            cfg = expand_multiband(cfg)
            etype = cfg["type"]
        cls = EFFECT_REGISTRY.get(etype)
        if cls is None:
            return None  # build_chain skips unknown types (engine.py:56)
        if etype == "parallel":
            # Branch STRUCTURE is static; nested live params are lifted
            # into runtime targets — key the structure only, mirroring
            # ParallelChains.__init__ exactly: nested parallel and unknown
            # entries are skipped by the chain build, branch statics come only
            # from split_config(params), and the kept entry's branch-config
            # index ei is baked into the lifted param names
            # (``b{bi}_{ei}_{name}``) that key the target rows.
            from aefs_tpu_torch.models.parallel_chain import ParallelChains

            bkey = []
            for branch in cfg.get("branches", ()):
                bk = []
                for ei, sub in enumerate(branch):
                    scls = EFFECT_REGISTRY.get(sub.get("type"))
                    if scls is None or scls is ParallelChains:
                        continue
                    _l, sstatic = scls.split_config(dict(sub.get("params", {})))
                    bk.append([ei, sub.get("type"), sstatic])
                bkey.append(bk)
            return [etype, bkey]
        params = dict(cfg.get("params", {}))
        _live, static = cls.split_config(params)
        static.update({k: v for k, v in cfg.items()
                       if k not in ("effect_id", "type", "params")})
        if grid and etype == "octaver":
            st = params.get("semitones", -12.0)
            if pow2_exponent(st) is not None:
                # a grid pool bakes this ratio into the program
                static["__grid_semitones"] = float(st)
        return [etype, static]

    key_parts, canon, session_ids = [], [], []
    for i, cfg in enumerate(effects_config):
        ek = entry_key(cfg)
        c = dict(cfg)
        c["effect_id"] = f"fx{i}"
        canon.append(c)
        if ek is not None:
            key_parts.append(ek)
            session_ids.append(cfg.get("effect_id") or f"fx{i}")
    return json.dumps(key_parts, sort_keys=True, default=str), canon, session_ids


class MultiPool:
    """Heterogeneous-topology serving: sessions bucketed by chain topology,
    one SessionPool (one batched step) per bucket, slots migrating between
    buckets on per-session ``build_chain``.

    Every client may build an arbitrary chain (backend.py:99-100) and still
    get pool economics: sessions sharing a topology batch into one step;
    distinct topologies each get their own bucket, whose batchers dispatch
    independently onto the one device, so the server stays realtime while
    the SUM of the occupied buckets' step times fits the block deadline.

    Bucket identity is ``canonical_topology``'s key.  Live params never
    split buckets.  Creating a bucket builds and warms a pool (off the
    event loop); ``max_buckets`` bounds resident buckets, and sessionless
    buckets are evicted oldest-first to make room."""

    def __init__(self, default_config, n_slots: int = 16, fs: int = SAMPLE_RATE,
                 blocksize: int = BLOCKSIZE, shard: bool = False, grid: bool = False,
                 max_buckets: int = 8, device="cuda"):
        self.n_slots = int(n_slots)
        self.fs = int(fs)
        self.blocksize = int(blocksize)
        self.shard = bool(shard)
        self.grid = bool(grid)
        self.max_buckets = int(max_buckets)
        self.device = require_device(device)
        self._lock = threading.Lock()
        self._building = {}  # key -> threading.Event (in-flight builds)
        key, _canon, _ids = canonical_topology(default_config, self.grid)
        self.default_key = key
        # Build the default bucket from the ORIGINAL config, not the
        # canonicalized one: its effect ids stay the operator-configured
        # ids, so sessions on the default chain (idmap None = identity)
        # keep addressing update_param by the ids they were shown in
        # session_ready — the same contract wrap() preserves.
        self.default_pool = SessionPool(
            default_config, n_slots=self.n_slots, fs=self.fs, blocksize=self.blocksize,
            shard=self.shard, grid=self.grid, device=self.device)
        self._buckets = {key: self.default_pool}

    @classmethod
    def wrap(cls, pool: "SessionPool", max_buckets: int = 8):
        """Adopt an existing single-topology pool as the default bucket
        (the ``PoolServer(SessionPool)`` construction)."""
        self = cls.__new__(cls)
        self.n_slots, self.fs, self.blocksize = pool.n_slots, pool.fs, pool.blocksize
        self.shard, self.grid, self.device = pool.shard, pool.grid, pool.device
        self.max_buckets = int(max_buckets)
        self._lock = threading.Lock()
        self._building = {}
        key, _canon, _ids = canonical_topology(pool.chain_config, pool.grid)
        self.default_key = key
        self.default_pool = pool
        self._buckets = {key: pool}
        return self

    def buckets(self):
        with self._lock:
            return dict(self._buckets)

    def build_session(self, effects_config, current=None):
        """Resolve one session's ``build_chain``: find-or-create the
        topology bucket and PLACE the session in it — the returned slot
        carries the bucket-keyed targets map and fresh single-slot state a
        DEDICATED pool of this config would start from (bit-parity with
        solo serving), plus the session-effect-id -> bucket-effect-id map
        for update_param routing.  ``current`` is the session's present
        ``(pool, slot)`` placement (or None): a same-bucket request rebuilds
        that slot in place instead of claiming a new one.

        Blocking (a new bucket builds and warms its pool) — call off the
        event loop; the build runs OUTSIDE the bucket-map lock so
        ``buckets()`` and sessions on other buckets never stall behind it.
        Claims happen UNDER the map lock, so a bucket this returns can never
        be seen sessionless by a concurrent eviction scan before the caller
        uses it.  Returns (key, pool, slot, tmap, single, idmap) with slot
        None when the target bucket is full.  Raises RuntimeError when the
        bucket limit is hit and no sessionless bucket can be evicted."""
        key, canon, session_ids = canonical_topology(effects_config, self.grid)
        # Throwaway host build of the session's own chain: its fresh state
        # and targets map ARE the seeds a dedicated pool of this config
        # would use (build_chain is the single source of initial currents;
        # parallel containers lift nested branch params here).  The state
        # reaches the card when the pool grafts it.
        chain_s, single, tmap_s = build_chain(
            canon, self.fs, self.blocksize, channels_in=CHANNELS_IN,
            channels_out=CHANNELS_OUT, device="cpu",
            static_overrides=grid_static_overrides(canon) if self.grid else None)
        canon_ids = [eid for eid, _ in chain_s.effects]

        def place(pool):
            # Caller holds self._lock (or the pool is not yet published).
            bucket_ids = [eid for eid, _ in pool.chain.effects]
            remap = dict(zip(canon_ids, bucket_ids))
            tmap = {remap[eid]: dict(v) for eid, v in tmap_s.items()}
            idmap = dict(zip(session_ids, bucket_ids))
            if current is not None and pool is current[0]:
                pool.rebuild_slot(current[1], tmap, single)
                return current[1], tmap, idmap
            return pool.claim_configured(tmap, single), tmap, idmap

        while True:
            evicted, build_evt, wait_evt = [], None, None
            with self._lock:
                pool = self._buckets.get(key)
                if pool is not None:
                    slot, tmap, idmap = place(pool)
                else:
                    wait_evt = self._building.get(key)
                    if wait_evt is None:
                        # Reserve the key; in-flight builds count toward the
                        # resident-bucket limit.
                        while len(self._buckets) + len(self._building) >= self.max_buckets:
                            idle = next((k for k, p in self._buckets.items()
                                         if k != self.default_key and p.active_count() == 0),
                                        None)
                            if idle is None:
                                for k, p in evicted:  # undo partial pops
                                    self._buckets[k] = p
                                raise RuntimeError(
                                    f"bucket limit reached ({self.max_buckets} chain "
                                    "topologies resident, none idle)")
                            evicted.append((idle, self._buckets.pop(idle)))
                        build_evt = self._building[key] = threading.Event()
            for _k, p in evicted:
                p.close()  # off the map lock: close takes the step lock
            if pool is not None:
                return key, pool, slot, tmap, single, idmap
            if wait_evt is not None:
                wait_evt.wait()  # another session is building this bucket
                continue
            # This thread holds the reservation: build and warm outside the
            # map lock, then publish and place atomically.
            try:
                pool = SessionPool(canon, n_slots=self.n_slots, fs=self.fs,
                                   blocksize=self.blocksize, shard=self.shard,
                                   grid=self.grid, device=self.device)
            except BaseException:
                with self._lock:
                    self._building.pop(key, None)
                build_evt.set()
                raise
            with self._lock:
                self._buckets[key] = pool
                self._building.pop(key, None)
                slot, tmap, idmap = place(pool)
            build_evt.set()
            return key, pool, slot, tmap, single, idmap


class _Batcher:
    """Per-bucket submission aggregator + dispatch loop: collects blocks
    arriving close together into one batched step of its bucket's pool.
    One _Batcher (and one asyncio task running ``run``) exists per resident
    topology bucket; concurrent buckets' steps serialize on the device,
    which is the round-robin service the MultiPool docstring describes."""

    def __init__(self, pool: SessionPool):
        self.pool = pool
        self._pending = {}  # slot -> (audio, future, submitted: a TRACER.clock())
        self._cv = asyncio.Condition()

    @staticmethod
    def _deliver(batch, outs, gen):
        """Resolve one generation's futures from its readback results, each
        with (output, the generation, when it was resolved), timed as
        ``pool.deliver``."""
        if batch is None:
            return
        with TRACER.span("pool.deliver", gen):
            resolved = TRACER.clock()
            for slot, (_a, fut, _t) in batch.items():
                if fut.done():
                    continue
                if outs is not None and slot in outs:
                    fut.set_result((outs[slot], gen, resolved))
                else:
                    fut.set_exception(RuntimeError("pool step lost the block"))

    @staticmethod
    def _fail(batch, e):
        if batch is None:
            return
        for _slot, (_a, fut, _t) in batch.items():
            if not fut.done():
                fut.set_exception(RuntimeError(f"pool step failed: {e}"))

    async def run(self):
        """Collect submissions arriving close together into one dispatch.

        Depth-1 pipelined by default (AEFS_POOL_PIPELINE=0 for strict
        sync): batch k's step is enqueued and batch k-1's results come back
        while it runs.  ``prev`` holds the generation whose results the NEXT
        step (or an idle flush) delivers; a failed step fails BOTH
        generations and restarts the pipeline clean — sessions keep their
        slots, realtime drop-late rules."""
        loop = asyncio.get_running_loop()
        pipelined = os.environ.get("AEFS_POOL_PIPELINE", "1") == "1"
        prev = None  # in-flight generation: {slot: (audio, future, submitted)}
        prev_gen = None  # its step generation (the tracer's request id)
        while True:
            flush = False
            async with self._cv:
                while not self._pending:
                    if prev is None:
                        await self._cv.wait()
                        continue
                    # Results in flight and nothing queued: give a saturated
                    # stream one block period to piggyback, then flush so a
                    # pausing stream's last block is never held hostage to
                    # the next one.
                    try:
                        await asyncio.wait_for(self._cv.wait(), timeout=0.005)
                    except asyncio.TimeoutError:
                        flush = True
                        break
            if not flush:
                await asyncio.sleep(0.002)  # aggregation window
                async with self._cv:
                    batch, self._pending = self._pending, {}
                if not batch and prev is None:
                    continue
            else:
                batch = {}

            if not batch:  # idle flush of the in-flight generation
                TRACER.count("pool.idle_flushes")
                try:
                    outs = await loop.run_in_executor(
                        None, TRACER.hop("pool.executor", prev_gen, self.pool.flush_pipeline))
                except Exception as e:
                    TRACER.count("pool.failed_steps")
                    self._fail(prev, e)
                    self.pool.drop_pipeline()
                    prev = None
                    continue
                self._deliver(prev, outs, prev_gen)
                prev = None
                continue

            # This batch's step is the pool's next generation: only this
            # batcher steps its pool.
            gen = self.pool.generation + 1
            taken = TRACER.clock()
            for _a, _f, submitted in batch.values():
                TRACER.record("pool.wait", gen, submitted, taken)
            TRACER.count("pool.blocks", len(batch))
            blocks = {slot: audio for slot, (audio, _f, _t) in batch.items()}
            if pipelined:
                try:
                    outs = await loop.run_in_executor(
                        None, TRACER.hop("pool.executor", gen, self.pool.step_blocks_pipelined),
                        blocks)
                except Exception as e:
                    # A failed step must kill neither the batcher task (every
                    # later submission would hang on a dead queue) nor the
                    # sessions: fail both generations' waiters and restart
                    # the pipeline clean.
                    TRACER.count("pool.failed_steps")
                    self._fail(prev, e)
                    self._fail(batch, e)
                    self.pool.drop_pipeline()
                    prev = None
                    continue
                self._deliver(prev, outs, prev_gen)
                prev, prev_gen = batch, gen
            else:
                try:
                    outs = await loop.run_in_executor(
                        None, TRACER.hop("pool.executor", gen, self.pool.step_blocks), blocks)
                except Exception as e:
                    TRACER.count("pool.failed_steps")
                    self._fail(batch, e)
                    continue
                self._deliver(batch, outs, gen)

    async def submit(self, slot: int, audio: np.ndarray):
        """Queue one block of ``slot``'s session -> (its output, the step
        generation that delivered it, when it was resolved: a
        ``TRACER.clock()``)."""
        fut = asyncio.get_running_loop().create_future()
        submitted = TRACER.clock()
        async with self._cv:
            # One in-flight block per session: a second submission before
            # the first resolves replaces it (drop-late, realtime rules); the
            # displaced future is resolved so its waiter does not hang.
            old = self._pending.get(slot)
            if old is not None:
                TRACER.count("pool.superseded")
            if old is not None and not old[1].done():
                old[1].set_exception(
                    RuntimeError("block superseded by a newer submission (drop-late)"))
            self._pending[slot] = (audio, fut, submitted)
            self._cv.notify()
        return await fut


class PoolServer:
    """WebSocket frontend over one or many topology buckets.

    Accepts a single-topology ``SessionPool`` (wrapped as a MultiPool's
    default bucket) or a ``MultiPool``.  Sessions join the default bucket
    and may issue per-session ``build_chain`` commands — the reference's
    central interaction (backend.py:99-100) — which migrate their slot to
    the matching topology bucket (building it on first use, off the event
    loop)."""

    def __init__(self, pool, max_buckets: int = 8):
        self.multi = pool if isinstance(pool, MultiPool) else MultiPool.wrap(pool, max_buckets)
        self.pool = self.multi.default_pool
        self._batchers = {self.multi.default_key: _Batcher(self.pool)}
        self._tasks = {}  # key -> task for dynamically created buckets

    async def batcher(self):
        """Run the DEFAULT bucket's dispatch loop (main() creates one task
        of it).  Dynamically created buckets get their own tasks from
        ``_batcher_for``."""
        await self._batchers[self.multi.default_key].run()

    def _batcher_for(self, key, pool):
        """Get (or start) the dispatch loop for a bucket; prune loops of
        evicted buckets.  Event-loop thread only."""
        b = self._batchers.get(key)
        if b is None or b.pool is not pool:
            # new bucket, or the key was evicted and re-created since
            old = self._tasks.pop(key, None)
            if old is not None:
                old.cancel()
            b = self._batchers[key] = _Batcher(pool)
            self._tasks[key] = asyncio.create_task(b.run())
        live = self.multi.buckets()
        for k in [k for k in self._tasks if k not in live]:
            self._tasks.pop(k).cancel()
            self._batchers.pop(k, None)
        return b

    async def handler(self, websocket):
        from aefs_tpu_torch.engine import jsonfmt

        loop = asyncio.get_running_loop()
        key, pool = self.multi.default_key, self.multi.default_pool
        slot = pool.claim()
        if slot is None:
            await websocket.send(json.dumps({"type": "error", "error": "pool full"}))
            return
        batcher = self._batcher_for(key, pool)
        idmap = None  # None = identity (session on the default config)
        seq = 0
        print(f"Session joined: slot {slot}")
        try:
            await websocket.send(json.dumps({
                "type": "session_ready", "slot": slot,
                "blocksize": pool.blocksize,
                "sample_rate": pool.fs,
                "chain": pool.chain_config,
            }))
            async for message in websocket:
                try:
                    cmd = json.loads(message)
                    command = cmd.get("command")
                    if command == "stream_block":
                        audio = np.asarray(cmd.get("audio", []), np.float32)
                        out, gen, resolved = await batcher.submit(slot, audio)
                        seq += 1
                        head = json.dumps({"type": "processed_block", "seq": seq})
                        await websocket.send(
                            head[:-1]
                            + ',"output":' + jsonfmt.json_f32_array(out[:, 0])
                            + ',"output_r":' + jsonfmt.json_f32_array(out[:, 1])
                            + "}")
                        TRACER.record("pool.reply", gen, resolved, TRACER.clock())
                    elif command == "build_chain":
                        # Per-session topology: migrate this session's slot
                        # to the bucket serving the requested chain,
                        # creating it on first use.
                        cfg = cmd.get("effects_config") or cmd.get("config") or []
                        try:
                            # Same-bucket requests rebuild the held slot in
                            # place; otherwise the new slot is claimed inside
                            # build_session, under the bucket-map lock.  ANY
                            # build failure (bucket limit, malformed config)
                            # must answer the client — the protocol promises
                            # chain_built or error.
                            nkey, npool, nslot, tmap, single, nidmap = (
                                await loop.run_in_executor(
                                    None, self.multi.build_session, cfg, (pool, slot)))
                        except Exception as e:
                            await websocket.send(json.dumps({"type": "error", "error": str(e)}))
                            continue
                        if nslot is None:
                            await websocket.send(json.dumps({
                                "type": "error", "error": "pool full (target bucket)"}))
                            continue
                        if npool is not pool:
                            pool.release(slot)
                            key, pool, slot = nkey, npool, nslot
                            batcher = self._batcher_for(key, pool)
                        idmap = nidmap
                        await websocket.send(json.dumps({
                            "type": "chain_built", "slot": slot, "chain": cfg}))
                    elif command == "update_param":
                        # Pure host work (a target-buffer write): runs inline
                        # on the event loop and never waits on a step.
                        eid = cmd.get("effect_id")
                        if idmap is not None:
                            eid = idmap.get(eid, f"\x00missing:{eid}")
                        err = pool.update_param(slot, eid, cmd.get("param"), cmd.get("value"))
                        if err:
                            print(err)
                        if cmd.get("ack"):
                            await websocket.send(json.dumps({
                                "type": "param_ack", "param": cmd.get("param"),
                                "ok": err is None}))
                    elif command == "get_pool_stats":
                        deadline_ms = pool.blocksize / pool.fs * 1000.0
                        buckets = self.multi.buckets()
                        # The server is realtime while the SUM of the
                        # occupied buckets' step times fits the block period
                        # (their steps share the device).
                        total_ms = sum(p.last_step_ms for p in buckets.values()
                                       if p.active_count())
                        stats = {
                            "type": "pool_stats",
                            # the SESSION's bucket
                            "slots": pool.n_slots,
                            "active": pool.active_count(),
                            "blocksize": pool.blocksize,
                            "step_ms": round(pool.last_step_ms, 3),
                            "deadline_ms": round(deadline_ms, 3),
                            "realtime_ok": total_ms < deadline_ms,
                            "chain": pool.chain_config,
                            "n_buckets": len(buckets),
                            "total_step_ms": round(total_ms, 3),
                            "buckets": [
                                {"types": [m.kind for _e, m in p.chain.effects],
                                 "slots": p.n_slots,
                                 "active": p.active_count(),
                                 "step_ms": round(p.last_step_ms, 3)}
                                for p in buckets.values()
                            ],
                        }
                        if TRACER.enabled:  # AEFS_TRACE=1: the program's spans
                            stats["trace"] = TRACER.snapshot()
                        await websocket.send(json.dumps(stats))
                except json.JSONDecodeError:
                    print(f"Error: message is not valid JSON: {message!r}")
                except Exception as e:
                    print(f"Error processing pool command: {e}")
        finally:
            # Release is pure host work (the audio-state reset is queued and
            # applied by the next dispatch), so it cannot block or be
            # skipped by task cancellation.
            pool.release(slot)
            print(f"Session left: slot {slot}")


async def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="Rain Delay")
    ap.add_argument("--config", help="JSON chain-config file (overrides --preset)")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--shard", action="store_true",
                    help="distribute slots over all devices (multi-chip pool)")
    ap.add_argument("--grid", action="store_true",
                    help="bake whole-octave octaver ratios for exact-grid "
                         "serving (higher density + -80 dBFS parity; "
                         "semitones stops being live)")
    ap.add_argument("--max-buckets", type=int, default=8,
                    help="max resident chain-topology buckets (one batched step per "
                         "distinct topology; sessions migrate between buckets via "
                         "build_chain)")
    ap.add_argument("--port", type=int, default=int(os.environ.get("POOL_PORT", 8766)))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; default $AEFS_PLATFORM, else cuda")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            chain_config = json.load(f)
    else:
        chain_config = DEFAULT_PRESETS[args.preset]

    # Health probes (TCP connect-and-close) otherwise print a full
    # handshake-EOF traceback per probe.  Filter just those records — real
    # websocket errors must stay visible.
    import logging

    class _ProbeNoise(logging.Filter):
        def filter(self, record):
            return "opening handshake failed" not in record.getMessage()

    logging.getLogger("websockets.server").addFilter(_ProbeNoise())

    gc.disable()
    device = select_device(args.device)
    pool = MultiPool(chain_config, n_slots=args.slots, shard=args.shard, grid=args.grid,
                     max_buckets=args.max_buckets, device=device)
    server = PoolServer(pool)
    print(f"Pool server: {args.slots} slots/bucket, {args.max_buckets} buckets max, "
          f"port {args.port} (device: {device})")
    if ws is None:
        raise RuntimeError("the pool server needs the websockets package")
    asyncio.create_task(server.batcher())
    async with ws.serve(server.handler, "0.0.0.0", args.port, max_size=WS_MAX_MESSAGE):
        await asyncio.Future()


if __name__ == "__main__":
    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        print("\nClosing pool server")
        gc.enable()
