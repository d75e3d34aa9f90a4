"""The effect-graph substrate (port of aefs_tpu/core/chain.py).

A ``Chain`` is a static description: sample rate, channel map, blocksize,
the device its state lives on, and an ordered list of (effect_id,
EffectModel).  All mutable data — every effect's audio state plus the
smoothed parameter currents — lives in one state tree:

    state, y = chain.process_block(state, targets, x)

PyTorch runs eagerly, so there is no compile cache: a block is a sequence
of tensor ops (and kernel launches) issued on the chain's device.

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
            st, buf = getattr(model, method)(state["fx"][i], pcur, buf)
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
        0-dim params (``render_batch``)."""
        return self._process(state, targets, x, "process_file")

    def process_array(self, state, targets, audio, fast: bool = False):
        """Process a whole (frames, ci) array on the chain's device.

        fast=False: the block step over consecutive blocks (works from any
        carried state).  fast=True: one ``process_whole`` pass — requires
        fresh state (file mode).

        Returns (new_state, (frames, co) float32 numpy).  Frames are padded
        up to a multiple of the blocksize; the pad is trimmed."""
        audio = np.asarray(audio, np.float32)
        frames = audio.shape[0]
        n = self.blocksize
        pad = (-frames) % n
        if pad:
            audio = np.concatenate([audio, np.zeros((pad, audio.shape[1]), np.float32)])
        x = torch.from_numpy(np.ascontiguousarray(audio.T)).to(self.device)  # (ci, N)
        if fast:
            state, y = self.process_whole(state, targets, x)
        else:
            ys = []
            for start in range(0, x.shape[-1], n):
                state, yb = self.process_block(state, targets, x[:, start : start + n])
                ys.append(yb)
            y = torch.cat(ys, -1) if ys else torch.zeros((self.co, 0), device=self.device)
        return state, y.cpu().numpy().T[:frames]


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
