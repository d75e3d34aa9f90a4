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
- a step launches each shard's work in turn; CUDA launches are
  asynchronous, so the cards overlap;
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


class ShardedState:
    """A ``ShardedStreams`` state: ``shards[i]`` is data shard i's batched
    tree, on the mesh's row i (its model-axis leaves as ``ModelShards``).
    ``join()`` is the one slot-axis tree a checkpoint saves; ``resplit``
    lays such a tree out as this state is (``load_session``'s rebuild)."""

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

    # -- layout ---------------------------------------------------------
    def split(self, state) -> ShardedState:
        """A batched state of every stream as the runner's sharded state."""
        shards = self.chain.split_slots(state, self.mesh.data_devices)
        return ShardedState([split_model(t, row) for t, row in zip(shards, self.mesh.devices)],
                            self)

    def join(self, state: ShardedState):
        """The sharded state as one batched tree on the mesh's first device."""
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

    # -- step -------------------------------------------------------------
    def step_fn(self, per_stream_targets: bool = False):
        """(state, targets, x (S, ci, N)) -> (state, y (S, co, N), peak).
        Without ``per_stream_targets`` one targets tree serves every stream;
        with it, ``batch_targets``' per-shard trees."""

        def step(state, targets, x):
            new, ys, peaks = [], [], []
            for i, ((lo, hi), chain, row) in enumerate(zip(self.ranges, self.chains,
                                                           self.mesh.devices)):
                dev = row[0]
                with device_scope(dev):  # each shard's work with its card current
                    if per_stream_targets:
                        tg = targets[i]
                    else:
                        tg = tuple({k: v.to(dev).expand(hi - lo).contiguous()
                                    for k, v in t.items()} for t in targets)
                    st, y = chain.process_block(state.shards[i], tg, x[lo:hi].to(dev))
                    new.append(st)
                    ys.append(y)
                    peaks.append(y.abs().amax())
            # The counterpart of the collectives XLA inserts: every shard's
            # output and max gathered on the mesh's first device, in order.
            first = self.mesh.device
            with device_scope(first):
                peak = peaks[0].to(first)
                for p in peaks[1:]:
                    peak = torch.maximum(peak, p.to(first))
                y = torch.cat([y.to(first) for y in ys]) if len(ys) > 1 else ys[0]
            return ShardedState(new, self), y, peak

        return step

    def run_block(self, state, targets, x, per_stream_targets: bool = False):
        """x: (S, ci, N) host array or tensor; each slot range goes to its
        shard's device straight from where x lives."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return self.step_fn(per_stream_targets)(state, targets, x)
