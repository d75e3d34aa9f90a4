"""Many streams in one step over a device mesh (port of
aefs_tpu/parallel/mesh.py).

The JAX package shards independent audio streams over the ``data`` axis of
a (data, model) mesh and the reverb's comb bank over ``model``, and lets
GSPMD insert the collectives.  The port covers one card: there the data
axis is the slot axis every effect takes (``Chain.process_block`` on
x (S, ci, N), ``Chain.batch_state``, (S,) targets), the axis the serving
pool steps, and the model axis has size 1.  A mesh over more than one card
raises ``NotImplementedError``.

Each step also returns the global clip meter, ``peak = max |y|`` over every
stream, a reduction on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.utils.platform import require_device, select_device


class Mesh:
    """A (data, model) grid of devices: ``devices[i][j]`` serves data shard
    i, model shard j; ``shape`` names the axis sizes."""

    def __init__(self, devices):
        self.devices = [list(row) for row in devices]
        self.shape = {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The one device of a one-device mesh."""
        return self.devices[0][0]


def _visible_devices():
    """The devices an entry point of the port sees: every card, or the host
    when ``AEFS_PLATFORM=cpu`` (no card raises, as ``select_device``)."""
    dev = select_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """Build a (data, model) mesh over the visible devices (or ``devices``).
    The errors are JAX's; a mesh over more than one device is not supported."""
    devices = _visible_devices() if devices is None else [require_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            # A silent devices[:n] would run an "N-device" run on fewer.
            raise ValueError(f"requested a {n_devices}-device mesh but only "
                             f"{len(devices)} devices are visible")
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if n > 1:
        raise NotImplementedError(
            f"a mesh over {n} devices is not supported: the mesh of aefs_tpu_torch "
            "covers one card, whose data axis is the slot axis")
    return Mesh([devices])


class ShardedStreams:
    """Run S independent effect chains (one per stream) as one batched step.

    State trees gain a leading stream axis (``Chain.batch_state``; lockstep
    leaves stay shared), which is the mesh's data axis.  Each step returns
    the global peak meter.
    """

    def __init__(self, chain, mesh: Mesh, n_streams: int):
        self.chain = chain
        self.mesh = mesh
        self.n_streams = int(n_streams)
        data_size = mesh.shape["data"]
        if self.n_streams % data_size:
            raise ValueError(f"n_streams={n_streams} must divide over data axis {data_size}")
        if (chain.device.type, chain.device.index or 0) != (mesh.device.type,
                                                             mesh.device.index or 0):
            raise ValueError(f"the chain lives on {chain.device}, the mesh on {mesh.device}")

    def init_state(self, configs=None):
        """Batched initial state for all streams, and each leaf's stream
        axis (None for the shared lockstep leaves): the one-card form of
        JAX's (state, shardings)."""
        batched = self.chain.batch_state(self.chain.init_state(configs), self.n_streams)
        return batched, self.chain.state_axes()

    def batch_targets(self, per_stream_maps):
        """Per-stream parameter targets: each stream's targets from its
        {effect_id: {param: value}} map, stacked to (S,) per param (the
        pool's per-slot targets)."""
        if len(per_stream_maps) != self.n_streams:
            raise ValueError(f"{len(per_stream_maps)} target maps for {self.n_streams} streams")
        per = [self.chain.targets(m) for m in per_stream_maps]
        return tuple({name: torch.stack([p[i][name] for p in per]) for name in per[0][i]}
                     for i in range(len(per[0])))

    def step_fn(self, per_stream_targets: bool = False):
        """(state, targets, x (S, ci, N)) -> (state, y (S, co, N), peak).
        Without ``per_stream_targets`` one targets tree serves every stream."""
        chain, n = self.chain, self.n_streams

        def step(state, targets, x):
            if not per_stream_targets:
                targets = tuple({k: v.expand(n).contiguous() for k, v in t.items()}
                                for t in targets)
            state, y = chain.process_block(state, targets, x)
            return state, y, y.abs().amax()

        return step

    def run_block(self, state, targets, x, per_stream_targets: bool = False):
        """x: (S, ci, N) host array or tensor."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return self.step_fn(per_stream_targets)(state, targets, x.to(self.mesh.device))
