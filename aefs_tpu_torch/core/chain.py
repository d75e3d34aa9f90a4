"""The effect-graph substrate (port of aefs_tpu/core/chain.py).

A ``Chain`` is a static description: sample rate, channel map, blocksize,
the device its state lives on, and an ordered list of (effect_id,
EffectModel).  All mutable data — every effect's audio state plus the
smoothed parameter currents — lives in one state tree:

    state, y = chain.process_block(state, targets, x)

PyTorch runs eagerly: ``process_block`` is a sequence of tensor ops (and
kernel launches) issued on the chain's device.  The compiled entry points
of the JAX package have one counterpart, ``packed_step`` (``step``): a
cached ``core/packing.py:PackedRunner`` over ``process_block`` that, on the
card, replays the block step as one captured CUDA graph.  ``warmup``
captures it, ``file_fn`` and ``process_array(fast=False)`` replay it block
by block, and ``release`` drops it (the chain -> runner -> bound method ->
chain cycle that ``gc.disable()`` would never collect).

The JAX package's whole-file entry points, ``fast_file_fn`` and
``packed_fast_file_fn`` (a jit of ``process_whole``), and the jitted pass of
its ``render_batch`` stay eager here: ``process_whole`` and
``process_array(fast=True)`` launch their kernels one by one.  Every
caller builds a fresh chain for one render and drops it after that pass
(``process_offline``, ``render_batch``, the backend's ``reprocess_file``
through ``process_file_array``), and a CUDA graph replayed once costs a
warm-up pass and a capture on top of the eager pass it records.  A
whole-file graph pays only with a chain kept across calls and a graph per
file length, which the JAX package does not have either: that is speed
work, not a part of the port.

The serving pool steps many streams at once through the same
``process_block`` with a leading slot axis written out (JAX vmaps it):
x (S, ci, N), every state leaf (S, ...) but the lockstep counters, and
targets (S,).  ``state_axes``, ``batch_state`` and ``graft_slot_state``
build and edit such a batched state; ``split_slots`` and ``join_slots``
lay it out over a mesh's data shards (contiguous slot ranges, as JAX's
``P("data")`` does) and back.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.core.params import smooth_all
from aefs_tpu_torch.models.base import tree_map
from aefs_tpu_torch.utils.metrics import TRACER
from aefs_tpu_torch.utils.platform import same_device


def slot_ranges(n_slots: int, n_shards: int):
    """The contiguous slot range [lo, hi) of each of ``n_shards`` data
    shards over ``n_slots`` slots (shard i holds i*S/n .. (i+1)*S/n - 1)."""
    span = n_slots // n_shards
    return [(i * span, (i + 1) * span) for i in range(n_shards)]


def _map_axes(f, axes, *trees):
    """``f(axis, *leaves)`` over parallel trees; ``axes`` is a tree of slot
    axes whose int or None leaves also stand for whole subtrees."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map_axes(f, axes[k] if isinstance(axes, dict) else axes,
                             *(u[k] for u in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(_map_axes(f, axes[i] if isinstance(axes, (tuple, list)) else axes,
                                 *(u[i] for u in trees)) for i in range(len(t)))
    return f(axes, *trees)


def _slot_count(axes, tree):
    """The slot count of a batched tree: the size of its first slot axis."""
    sizes = []
    _map_axes(lambda ax, t: sizes.append(t.shape[ax]) if ax is not None and t.dim() else None,
              axes, tree)
    if not sizes:
        raise ValueError("the tree has no leaf with a slot axis")
    return sizes[0]


class Chain:
    def __init__(self, fs: int, channels_in: int, channels_out: int,
                 blocksize: int, effects, device="cuda"):
        self.fs = int(fs)
        self.ci = int(channels_in)
        self.co = int(channels_out)
        self.blocksize = int(blocksize)
        self.effects = tuple(effects)  # ordered (effect_id, model)
        self.device = torch.device(device)
        self.config_seeds = {}  # {effect_id: params} captured by build_chain
        self._runners = {}  # cached step runners (packed_step); release() drops them

    # -- state ----------------------------------------------------------
    def init_state(self, configs=None):
        """configs: optional {effect_id: params-dict} initial live values;
        defaults to the chain-config seeds captured at build time."""
        configs = self.config_seeds if configs is None else configs
        fx, params = [], []
        for eid, model in self.effects:
            fx.append(model.init_state())
            params.append(model.initial_params(configs.get(eid, {})))
        return {"fx": tuple(fx), "params": tuple(params)}

    def state_axes(self, batch_axis: int = 0):
        """Slot axis of every leaf of a batched state: ``batch_axis``
        everywhere except each model's LOCKSTEP_STATE leaves (None), pure
        per-block counters identical in every stream when all streams step
        together (the delay's shared ring row)."""
        fx = tuple(model.state_axes_tree(batch_axis) for eid, model in self.effects)
        return {"fx": fx, "params": batch_axis}

    def batch_state(self, one, n_streams: int):
        """Broadcast a single-stream state to ``n_streams`` slots, keeping
        LOCKSTEP_STATE leaves unbatched.  Every leaf is a copy: ``one`` may
        be a shared fresh-state template."""
        def bcast(leaf):
            return leaf.unsqueeze(0).expand((n_streams,) + leaf.shape).clone()

        fx = tuple(model.map_state(bcast, torch.clone, st)
                   for (eid, model), st in zip(self.effects, one["fx"]))
        return {"fx": fx, "params": tree_map(bcast, one["params"])}

    def graft_slot_state(self, batched, single, slot: int):
        """A batched state with ``single``'s state written into ``slot``
        (pool slot reset).  LOCKSTEP_STATE leaves keep the shared running
        counter: a freshly zeroed ring is self-consistent from any row, and
        resetting the shared row would desync the other slots."""
        def put(b, s):
            b = b.clone()
            b[slot] = s
            return b

        fx = tuple(model.map_state(put, lambda b, s: b, bst, sst)
                   for (eid, model), bst, sst in zip(self.effects, batched["fx"], single["fx"]))
        return {"fx": fx, "params": tree_map(put, batched["params"], single["params"])}

    def graft_slot_state_(self, batched, single, slot: int):
        """``graft_slot_state`` in place: ``single``'s leaves are copied into
        row ``slot`` of ``batched``'s leaves (views of a runner's static
        groups, say); LOCKSTEP_STATE leaves are left as they are."""
        _map_axes(lambda ax, b, s: None if ax is None else b[slot].copy_(s),
                  self.state_axes(), batched, single)

    def split_slots(self, batched, devices, axes=None):
        """A batched state (or, with ``axes=0``, a targets tree) as one tree
        per data shard: shard i holds slot range i of ``len(devices)``
        (``slot_ranges``) on ``devices[i]``.  Leaves without a slot axis
        (LOCKSTEP_STATE, 0-dim shared targets) are copied to every shard:
        they advance alike there.  Every leaf is a copy."""
        axes = self.state_axes() if axes is None else axes
        n_slots = _slot_count(axes, batched)

        def take(lo, hi, dev):
            def leaf(ax, t):
                if ax is None or t.dim() == 0:
                    return t.to(dev, copy=True)
                return t.narrow(ax, lo, hi - lo).to(dev, copy=True)
            return leaf

        return [_map_axes(take(lo, hi, torch.device(dev)), axes, batched)
                for (lo, hi), dev in zip(slot_ranges(n_slots, len(devices)), devices)]

    def join_slots(self, shards, device, axes=None):
        """``split_slots``'s inverse: one tree on ``device`` with every
        shard's slots in order; a leaf without a slot axis is shard 0's."""
        axes = self.state_axes() if axes is None else axes

        def leaf(ax, *ts):
            if ax is None or ts[0].dim() == 0:
                return ts[0].to(device, copy=True)
            return torch.cat([t.to(device) for t in ts], ax)

        return _map_axes(leaf, axes, *shards)

    def on_device(self, device):
        """This chain with its constants on ``device``: ``self`` where it
        lives there already, else ``build_chain`` of the same arguments."""
        if same_device(device, self.device):
            return self
        return build_chain(*self.build_args, device=device)[0]

    def targets(self, per_effect: dict):
        """Targets tree (tuple of dicts of 0-dim tensors, chain order) from a
        host-side {effect_id: {param: float}} map; missing params fall back
        to spec defaults, values are clamped like SmoothParam.set_target
        (core.py:64-66)."""
        return tuple(
            {
                name: torch.tensor(spec.clamp(per_effect.get(eid, {}).get(name, spec.default)),
                                   dtype=torch.float32, device=self.device)
                for name, spec in model.PARAMS.items()
            }
            for eid, model in self.effects
        )

    # -- processing -----------------------------------------------------
    def _fan_in(self, x):
        """Channel fan (core.py:147-154): mono->stereo duplicates, otherwise
        copy the common channels and zero the rest.  x: (..., ci, N)."""
        if self.ci == 1 and self.co == 2:
            return torch.cat([x, x], -2)
        ch = min(self.ci, self.co)
        pad = self.co - ch
        if pad:
            z = torch.zeros(x.shape[:-2] + (pad, x.shape[-1]), dtype=x.dtype, device=x.device)
            return torch.cat([x[..., :ch, :], z], -2)
        return x[..., :ch, :]

    def _process(self, state, targets, x, method):
        buf = self._fan_in(x)
        new_fx, new_params = [], []
        for i, (eid, model) in enumerate(self.effects):
            pcur = smooth_all(model.PARAMS, state["params"][i], targets[i], self.fs)
            if method == "process_file":  # rid: the effect's position
                with TRACER.span("chain.file_effect", i):
                    st, buf = model.process_file(state["fx"][i], pcur, buf)
            else:
                st, buf = model.process(state["fx"][i], pcur, buf)
            new_fx.append(st)
            new_params.append(pcur)
        return {"fx": tuple(new_fx), "params": tuple(new_params)}, buf

    def process_block(self, state, targets, x):
        """x: (ci, N) float32 tensor -> (new_state, (co, N)); with a leading
        slot axis on x, state and targets, (S, ci, N) -> (S, co, N)."""
        return self._process(state, targets, x, "process")

    def process_whole(self, state, targets, x):
        """Whole-signal pass routed through each effect's ``process_file``
        fast path: one parameter-smoothing step, then every effect
        transforms the entire signal in closed form.  Needs fresh state.
        x (ci, N), or (F, ci, N) for F files with ``batch_state``'s fx and
        0-dim params (``render_batch``).  Each effect's pass is a
        ``chain.file_effect`` span of the tracer."""
        return self._process(state, targets, x, "process_file")

    # -- the compiled entry points ----------------------------------------
    def label(self) -> str:
        """The chain's effect types in order, as errors name the chain."""
        return " -> ".join(model.kind for _, model in self.effects) or "an empty chain"

    def packed_step(self):
        """The cached ``PackedRunner`` over ``process_block`` at this chain's
        blocksize: one static buffer per state dtype and one for the
        targets, x (ci, blocksize); on the card one captured CUDA graph per
        step.  This is the engine's hot path."""
        key = ("packed_step", self.blocksize)
        runner = self._runners.get(key)
        if runner is None:
            from aefs_tpu_torch.core.packing import PackedRunner

            runner = self._runners[key] = PackedRunner(
                self.process_block, self.init_state(), self.targets({}),
                x_shape=(self.ci, self.blocksize), device=self.device,
                label=self.label())
        return runner

    def step(self):
        """The single-block step: the same cached runner as ``packed_step``."""
        return self.packed_step()

    def file_fn(self, n_blocks: int):
        """(state, targets, blocks (n_blocks, ci, N)) -> (state, ys (n_blocks,
        co, N)): the step runner replayed block by block (JAX scans the
        jitted block step)."""
        runner = self.packed_step()

        def run(state, targets, blocks):
            if blocks.shape[0] != n_blocks:
                raise ValueError(f"{blocks.shape[0]} blocks where the file has {n_blocks}")
            runner.write_state(runner.pack_state(state))
            runner.write_targets(runner.pack_targets(targets))
            ys = torch.empty((n_blocks, self.co, self.blocksize), dtype=torch.float32,
                             device=self.device)
            for k in range(n_blocks):
                runner.write_x(blocks[k])
                ys[k].copy_(runner.run()[1])
            return runner.unpack_state(), ys

        return run

    def release(self):
        """Drop the cached runners, their graphs and the graphs' memory
        pools.  The cache holds runners over this chain's bound methods
        (chain -> runner -> method -> chain), a cycle the serving processes
        (``gc.disable()``) never collect: callers that replace or finish
        with a chain release it.  A holder of a released chain stays
        correct; its next step builds and captures a new runner."""
        for runner in self._runners.values():
            runner.release()
        self._runners.clear()

    def warmup(self, state, targets):
        """Warm up and capture the step runner (two dummy blocks, then the
        capture, on the card; ``PackedRunner.prepare``) with ``state`` and
        ``targets`` in its buffers; returns a fresh ``init_state()``, as the
        JAX package does (its warm-up donates the state)."""
        runner = self.packed_step()
        runner.write_state(runner.pack_state(state))
        runner.write_targets(runner.pack_targets(targets))
        runner.prepare()
        return self.init_state()

    def process_array(self, state, targets, audio, fast: bool = False):
        """Process a whole (frames, ci) array on the chain's device.

        fast=False: the step runner over consecutive blocks (``file_fn``;
        works from any carried state).  fast=True: one ``process_whole``
        pass — requires fresh state (file mode).

        Returns (new_state, (frames, co) float32 numpy).  Frames are padded
        up to a multiple of the blocksize; the pad is trimmed."""
        audio = np.asarray(audio, np.float32)
        frames = audio.shape[0]
        n = self.blocksize
        pad = (-frames) % n
        if pad:
            audio = np.concatenate([audio, np.zeros((pad, audio.shape[1]), np.float32)])
        if fast:
            x = torch.from_numpy(np.ascontiguousarray(audio.T)).to(self.device)  # (ci, N)
            state, y = self.process_whole(state, targets, x)
            return state, y.cpu().numpy().T[:frames]
        blocks = torch.from_numpy(np.ascontiguousarray(
            audio.T.reshape(self.ci, -1, n).transpose(1, 0, 2))).to(self.device)
        state, ys = self.file_fn(blocks.shape[0])(state, targets, blocks)
        out = ys.permute(1, 0, 2).reshape(self.co, -1).cpu().numpy().T
        return state, out[:frames]


def build_chain(effects_config, fs, blocksize, channels_in=1, channels_out=2,
                static_overrides=None, device="cuda"):
    """Chain factory from a JSON-style config list (engine.py:38-65).

    effects_config: [{"effect_id": str, "type": str, "params": {...}}, ...]
    static_overrides: optional extra static config, keyed by effect_id
      (takes precedence) or effect type.
    device: where the chain's state and targets live; the card unless the
      caller passes "cpu" (no fallback: without a card the default raises).

    Unknown types are skipped like the reference (engine.py:56); a
    ``multiband`` config is expanded onto the parallel container
    (core/multiband.py).

    Returns (chain, state, targets_map) where targets_map is the host-side
    {effect_id: params} dict mirroring the initial state."""
    from aefs_tpu_torch.core.multiband import expand_multiband
    from aefs_tpu_torch.models import EFFECT_REGISTRY
    from aefs_tpu_torch.utils.platform import require_device

    device = require_device(device)
    static_overrides = static_overrides or {}
    effects, configs = [], {}
    for i, cfg in enumerate(effects_config):
        etype = cfg.get("type")
        if etype == "multiband":
            # A Linkwitz-Riley band split over the parallel container; the
            # expansion keeps the effect_id (or its absence).
            cfg = expand_multiband(cfg)
            etype = cfg["type"]
        cls = EFFECT_REGISTRY.get(etype)
        if cls is None:
            continue  # unknown types are skipped (engine.py:56)
        # Fallback ids use the raw config index, like core/fileopts.py.
        eid = cfg.get("effect_id") or f"fx{i}"
        params = dict(cfg.get("params", {}))
        _, static = cls.split_config(params)
        static.update(
            {k: v for k, v in cfg.items() if k not in ("effect_id", "type", "params")}
        )
        static.update(static_overrides.get(etype, {}))
        static.update(static_overrides.get(eid, {}))
        model = cls(fs, blocksize, channels=channels_out, device=device, **static)
        effects.append((eid, model))
        # Live params are decided against the instance's table: a parallel
        # container's lifted branch params exist only per instance, and
        # their branch-config values (``_initial``) seed the targets too.
        live = {k: v for k, v in params.items() if k in model.PARAMS}
        configs[eid] = {**getattr(model, "_initial", {}), **live}

    chain = Chain(fs, channels_in, channels_out, blocksize, effects, device=device)
    chain.config_seeds = configs
    # The raw config, kept on the chain so a snapshot of the chain carries
    # its own config (save_session): the engine's last_chain_config may
    # already name a newer chain.
    chain.source_config = effects_config
    # What ``on_device`` rebuilds a shard's chain from.
    chain.build_args = (effects_config, fs, blocksize, channels_in, channels_out,
                        static_overrides)
    state = chain.init_state(configs)
    targets_map = {
        eid: {k: float(v) for k, v in configs.get(eid, {}).items()}
        for eid, _ in effects
    }
    return chain, state, targets_map
