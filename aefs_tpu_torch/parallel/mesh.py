"""Many streams in one step over a device mesh (port of
aefs_tpu/parallel/mesh.py).

The JAX package shards independent audio streams over the ``data`` axis of
a (data, model) mesh, the reverb's comb bank and the convolution reverb's
partition history over ``model``, and lets GSPMD insert the collectives.
The port runs the mesh from one process, as JAX runs it from one
controller:

- each data shard (a row of the mesh) has its own chain, built on the
  row's first device, and its own batched state: slot range i of S/data
  (``Chain.split_slots``), as ``P("data")`` lays the stream axis out;
- JAX jits the step; here each data shard's step is one captured CUDA
  graph (``ShardedStreams``), and one thread replays the shards' graphs
  in turn; replays are asynchronous, so the cards overlap;
- with a model axis, the reverb's ``combs``/``lps`` (comb axis) and the
  convolution reverb's ``spec_hist`` (partition axis) are split over the
  row's devices (``ModelShards``): each model device runs its part, and
  the partial sums are added on the row's first device, model shard 0
  first (JAX's rule, with its divisibility condition);
- the global clip meter, ``peak = max |y|`` over every stream, is each
  shard's max, reduced on the mesh's first device.

The devices come from ``visible_devices``, for ``make_mesh()``,
``SessionPool(shard=True)`` and ``render_batch(shard=True)`` alike, as
JAX's take theirs from ``jax.devices()``.  A test replaces it to get
several shards on one device, as JAX's tests force 8 host devices.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.core.chain import slot_ranges
from aefs_tpu_torch.core.packing import HybridPacker, PackedRunner, Packer, Staging
from aefs_tpu_torch.models.base import ModelShards
from aefs_tpu_torch.utils.platform import (
    device_scope, require_device, same_device, select_device)

# JAX's model-axis rule (aefs_tpu/parallel/mesh.py:_state_shardings), by
# state key: (least ndim of the batched leaf, the axis split over model).
MODEL_AXIS = {"combs": (4, 2), "lps": (3, 2), "spec_hist": (5, 3)}


class Mesh:
    """A (data, model) grid of devices: ``devices[i][j]`` serves data shard
    i, model shard j; ``shape`` names the axis sizes."""

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The mesh's first device (data shard 0, model shard 0)."""
        return self.devices[0][0]

    @property
    def data_devices(self):
        """Each data shard's first device, in order."""
        return [row[0] for row in self.devices]


def visible_devices(device=None):
    """The devices an entry point of the port sees: every card for a CUDA
    ``device`` (by default ``AEFS_PLATFORM``, else the card; no card
    raises, as ``select_device``), the host once for the CPU."""
    dev = select_device() if device is None else require_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """Build a (data, model) mesh over the visible devices (or ``devices``,
    which may name a device more than once); row i holds devices
    [i*m, (i+1)*m), as JAX reshapes them.  The errors are JAX's."""
    devices = visible_devices() if devices is None else [require_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            # A silent devices[:n] would run an "N-device" run on fewer.
            raise ValueError(f"requested a {n_devices}-device mesh but only "
                             f"{len(devices)} devices are visible")
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    m = int(model_parallel)
    return Mesh([devices[i * m:(i + 1) * m] for i in range(n // m)])


def _map_keyed(f, tree, key=None):
    """``f(key, leaf)`` over a state tree, ``key`` the nearest dict key
    above the leaf (JAX's rule reads the key path)."""
    if isinstance(tree, dict):
        return {k: _map_keyed(f, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_keyed(f, v, key) for v in tree)
    return f(key, tree)


def split_model(tree, row):
    """A data shard's state with its model-axis leaves split over ``row``
    (``MODEL_AXIS``); a leaf whose axis does not divide by the model size
    stays whole on the row's first device."""
    m = len(row)
    if m == 1:
        return tree

    def leaf(key, t):
        ndim, ax = MODEL_AXIS.get(key, (None, None))
        if ax is None or t.dim() < ndim or t.shape[ax] == 0 or t.shape[ax] % m:
            return t
        r = t.shape[ax] // m
        return ModelShards([t.narrow(ax, j * r, r).contiguous().to(dev)
                            for j, dev in enumerate(row)], ax)

    return _map_keyed(leaf, tree)


def join_model(tree, device):
    """``split_model``'s inverse: every ``ModelShards`` leaf whole on
    ``device``."""
    return _map_keyed(lambda _k, t: t.join(device) if isinstance(t, ModelShards) else t, tree)


def _open(tree):
    """A shard's state with every ``ModelShards`` leaf as the tuple of its
    pieces: the tree a ``PackedRunner`` packs, each piece into a group on
    its own device."""
    if isinstance(tree, ModelShards):
        return tuple(tree.pieces)
    if isinstance(tree, dict):
        return {k: _open(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_open(v) for v in tree)
    return tree


def _close(tree, like):
    """``_open``'s inverse: a ``ModelShards`` wherever ``like`` (``_marks``
    of a state) holds one, with its axis."""
    if isinstance(like, ModelShards):
        return ModelShards(tree, like.axis)
    if isinstance(like, dict):
        return {k: _close(tree[k], v) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_close(t, v) for t, v in zip(tree, like))
    return tree


def _marks(tree):
    """``tree``'s structure and its ``ModelShards`` axes, no tensor: what
    ``_close`` needs, kept by a runner without holding a state."""
    if isinstance(tree, ModelShards):
        return ModelShards((), tree.axis)
    if isinstance(tree, dict):
        return {k: _marks(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_marks(v) for v in tree)
    return None


def _shard_fn(chain, marks):
    """A data shard's step, as its ``PackedRunner`` captures it: the chain's
    batched ``process_block`` over the opened state, then the shard's peak
    ``max |y|``; y and the peak land in the graph's static outputs."""

    def step(state, targets, x):
        new, y = chain.process_block(_close(state, marks), targets, x)
        return _open(new), (y, y.abs().amax())

    return step


class ShardedState:
    """A ``ShardedStreams`` state: ``shards[i]`` is data shard i's batched
    tree, on the mesh's row i (its model-axis leaves as ``ModelShards``).
    The state a compiled step returns holds views of its runners' static
    buffers, which the next step advances in place (JAX's donation).
    ``join()`` copies it out as the one slot-axis tree a checkpoint saves;
    ``resplit`` lays such a tree out as this state is (``load_session``'s
    rebuild)."""

    def __init__(self, shards, runner):
        self.shards = list(shards)
        self.runner = runner

    def join(self):
        return self.runner.join(self)

    def resplit(self, tree):
        return self.runner.split(tree)


class ShardedStreams:
    """Run S independent effect chains (one per stream) across a mesh.

    State trees gain a leading stream axis (``Chain.batch_state``; lockstep
    leaves stay shared); streams shard over ``data``, the reverb's comb
    bank and the convolution reverb's partition history also over
    ``model``.  Each step returns the global peak meter.

    The step is compiled, the counterpart of JAX's jitted GSPMD step: each
    data shard has a ``core/packing.py:PackedRunner`` over its chain's
    batched ``process_block`` and its slot range (``HybridPacker`` groups,
    one per dtype and device), whose graph is captured on the row's first
    card at the first step or in ``prepare`` and replayed per step, with
    the shard's y and peak computed inside it.  One host thread replays
    the shards in turn: a replay is asynchronous, so the cards overlap, as
    the sharded pool's do.  The cross-shard gather (the peak's maximum and
    the cat of y, on the mesh's first device, in shard order) runs after
    the replays.

    A model axis across cards is captured as one graph per shard across
    the row's cards: each model card's work runs on its own capture stream
    forked from the row's, the copies between cards order the two, and its
    intermediates stay in a private pool of that card
    (``packing.py:_with_sides``).  Work issued on another card without its
    stream joining the capture would run once, eagerly, and the replays
    would skip it; one graph per card, split at the model hops, would need
    the reverb's and the convolution reverb's step cut into per-card
    stages.  On one card (every model part there) the row is one graph
    like any other.

    ``step_fn(eager=True)`` is the eager step (each shard's
    ``process_block`` in turn), kept as the reference the card tests hold
    the graph against; a capture that fails raises, naming the chain and
    the shard, and nothing falls back to it.
    """

    def __init__(self, chain, mesh: Mesh, n_streams: int):
        self.chain = chain
        self.mesh = mesh
        self.n_streams = int(n_streams)
        data_size = mesh.shape["data"]
        if self.n_streams % data_size:
            raise ValueError(f"n_streams={n_streams} must divide over data axis {data_size}")
        if not same_device(chain.device, mesh.device):
            raise ValueError(f"the chain lives on {chain.device}, the mesh on {mesh.device}")
        self.chains = [chain.on_device(dev) for dev in mesh.data_devices]
        self.ranges = slot_ranges(self.n_streams, data_size)
        # Built by prepare(): one runner and one input staging per data
        # shard, each runner's static state as a shard tree of views (the
        # state the last step returned), and the shared-targets packer.
        self._runners = self._stages = self._live = self._shared_packer = None

    # -- layout ---------------------------------------------------------
    def split(self, state) -> ShardedState:
        """A batched state of every stream as the runner's sharded state."""
        shards = self.chain.split_slots(state, self.mesh.data_devices)
        return ShardedState([split_model(t, row) for t, row in zip(shards, self.mesh.devices)],
                            self)

    def join(self, state: ShardedState):
        """The sharded state as one batched tree on the mesh's first device
        (a copy: the next step does not change it)."""
        trees = [join_model(t, row[0]) for t, row in zip(state.shards, self.mesh.devices)]
        return self.chain.join_slots(trees, self.mesh.device)

    def init_state(self, configs=None):
        """The sharded initial state of every stream, and each leaf's stream
        axis (None for the shared lockstep leaves): the port's form of JAX's
        (state, shardings)."""
        batched = self.chain.batch_state(self.chain.init_state(configs), self.n_streams)
        return self.split(batched), self.chain.state_axes()

    def batch_targets(self, per_stream_maps):
        """Per-stream parameter targets: each stream's targets from its
        {effect_id: {param: value}} map, stacked to (S,) per param and
        split by slot range over the data shards (one tree per shard)."""
        if len(per_stream_maps) != self.n_streams:
            raise ValueError(f"{len(per_stream_maps)} target maps for {self.n_streams} streams")
        per = [self.chain.targets(m) for m in per_stream_maps]
        stacked = tuple({name: torch.stack([p[i][name] for p in per]) for name in per[0][i]}
                        for i in range(len(per[0])))
        return self.chain.split_slots(stacked, self.mesh.data_devices, axes=0)

    # -- the compiled step ----------------------------------------------------
    def prepare(self):
        """Build each data shard's runner over a fresh state and, on the
        card, warm it up and capture its graph (a no-op once built)."""
        if self._runners is not None:
            return
        fresh = self.init_state()[0]
        shared = self.chain.targets({})
        self._shared_packer = Packer(shared)
        runners, stages, live = [], [], []
        for i, (chain, tree, row, (lo, hi)) in enumerate(zip(
                self.chains, fresh.shards, self.mesh.devices, self.ranges)):
            dev, marks = row[0], _marks(tree)
            with device_scope(dev):
                targets = tuple({k: v.to(dev).expand(hi - lo).clone() for k, v in t.items()}
                                for t in shared)
                runner = PackedRunner(
                    _shard_fn(chain, marks), _open(tree), targets,
                    x_shape=(hi - lo, chain.ci, chain.blocksize), device=dev,
                    packer=HybridPacker,
                    label=f"{chain.label()}: ShardedStreams shard {i} of {len(self.ranges)} "
                          f"({hi - lo} streams on {', '.join(map(str, row))})")
                runner.prepare()
            runners.append(runner)
            stages.append(Staging(tuple(runner.x.shape), dev))
            live.append(_close(runner.state_packer.unpack(runner.sgroups), marks))
        self._runners, self._stages, self._live = runners, stages, live

    def release(self):
        """Drop the runners, their graphs and the graphs' memory; a later
        step builds and captures them again (a state they returned is then
        written in like any other)."""
        for runner in self._runners or ():
            runner.release()
        self._runners = self._stages = self._live = self._shared_packer = None

    def _spread(self, targets):
        """Shared targets packed once (one (P,) group per dtype) and copied
        to each data shard's card."""
        shared = self._shared_packer.pack(targets)
        return [tuple(v.to(row[0]) for v in shared) for row in self.mesh.devices]

    def _shard_inputs(self, i, tree, targets, shared, x):
        """Data shard i's inputs into its runner's static buffers, with its
        card current: its state tree (unless it is the runner's own), its
        targets (its per-stream tree, or its copy of the ``shared`` groups
        spread over its slots) and its rows of x."""
        runner, (lo, hi) = self._runners[i], self.ranges[i]
        with device_scope(self.mesh.devices[i][0]):
            if tree is not self._live[i]:
                runner.write_state(runner.pack_state(_open(tree)))
            if shared is None:
                runner.write_targets(runner.pack_targets(targets[i]))
            else:  # each dtype's (P,) values into the (P, S_i) static group
                for g, v in zip(runner.tgroups, shared):
                    g.view(-1, hi - lo).copy_(v[:, None].expand(-1, hi - lo))
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                runner.write_x(x[lo:hi])
            else:  # from the host through the shard's pinned staging
                host = x.numpy() if isinstance(x, torch.Tensor) else x
                self._stages[i].put(host[lo:hi], runner.x)

    def _replay(self, i):
        """One replay of data shard i's graph -> its static (y, peak)."""
        with device_scope(self.mesh.devices[i][0]):
            return self._runners[i].run()[1]

    def _gather(self, ys, peaks):
        """The counterpart of the collectives XLA inserts: every shard's
        output and max gathered on the mesh's first device, in order, as
        new tensors."""
        first = self.mesh.device
        with device_scope(first):
            peak = peaks[0].to(first, copy=True)
            for p in peaks[1:]:
                peak = torch.maximum(peak, p.to(first))
            y = torch.cat([y.to(first) for y in ys]) if len(ys) > 1 else ys[0].clone()
        return y, peak

    def step_fn(self, per_stream_targets: bool = False, eager: bool = False):
        """(state, targets, x (S, ci, N)) -> (state, y (S, co, N), peak).
        Without ``per_stream_targets`` one targets tree serves every stream;
        with it, ``batch_targets``' per-shard trees.  N is the chain's
        blocksize; x is a host array or a tensor.

        A state this step returned (its shard trees are the runners' static
        buffers) is stepped in place and must not be reused; any other
        state is copied in and stays as it was.  ``eager=True``: each
        shard's ``process_block`` in turn, the reference."""
        if eager:
            return self._eager_step(per_stream_targets)

        def step(state, targets, x):
            shape = (self.n_streams, self.chain.ci, self.chain.blocksize)
            if tuple(x.shape) != shape:
                raise ValueError(f"x of shape {tuple(x.shape)}; the step takes {shape}")
            self.prepare()
            shared = ([None] * len(self._runners) if per_stream_targets
                      else self._spread(targets))
            # Every shard's inputs before any replay: a copy from the first
            # card queued behind its replay would hold the other cards back.
            for i, tree in enumerate(state.shards):
                self._shard_inputs(i, tree, targets, shared[i], x)
            ys, peaks = zip(*(self._replay(i) for i in range(len(self._runners))))
            y, peak = self._gather(ys, peaks)
            return ShardedState(self._live, self), y, peak

        return step

    def _eager_step(self, per_stream_targets):
        def step(state, targets, x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x, np.float32))
            new, ys, peaks = [], [], []
            for i, ((lo, hi), chain, row) in enumerate(zip(self.ranges, self.chains,
                                                           self.mesh.devices)):
                dev = row[0]
                with device_scope(dev):
                    if per_stream_targets:
                        tg = targets[i]
                    else:
                        tg = tuple({k: v.to(dev).expand(hi - lo).contiguous()
                                    for k, v in t.items()} for t in targets)
                    st, y = chain.process_block(state.shards[i], tg, x[lo:hi].to(dev))
                    new.append(st)
                    ys.append(y)
                    peaks.append(y.abs().amax())
            y, peak = self._gather(ys, peaks)
            return ShardedState(new, self), y, peak

        return step

    def run_block(self, state, targets, x, per_stream_targets: bool = False,
                  eager: bool = False):
        """x: (S, ci, N) host array or tensor; each slot range goes to its
        shard's device straight from where x lives (a host block through
        pinned staging)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        return self.step_fn(per_stream_targets, eager)(state, targets, x)
