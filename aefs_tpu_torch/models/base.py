"""Functional effect protocol (port of aefs_tpu/models/base.py).

An ``EffectModel`` instance holds only *static* topology (buffer lengths,
lags, window tables) and the device its state lives on; all mutable audio
state is an explicit tree of dicts/tuples of tensors threaded through
``process``:

    state = model.init_state()
    state, y = model.process(state, params, x)      # x, y: (2, N) float32

``params`` is a dict of 0-dim float32 tensors — the smoothed current
values, advanced once per block by the chain (core/params.py).

``process`` also takes a leading slot axis, the pool's batch of streams
written out (JAX vmaps the same step): x (S, C, N), params (S,), and every
state leaf (S, ...) except the LOCKSTEP_STATE leaves, which stay shared.
``lead`` gives a param the trailing unit axes it needs to meet a signal;
a 0-dim value passes unchanged, so the single-stream step runs exactly the
ops it ran before.  A batched file render (``process_file``) uses the same
leading axis for its files with 0-dim params.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec, init_params, lead  # noqa: F401


def tree_map(f, tree, *rest):
    """Apply ``f`` to the leaves of a dict/tuple/list tree (and of the
    parallel trees in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, *leaves) for leaves in zip(tree, *rest))
    return f(tree, *rest)


class ModelShards:
    """A state leaf split over the mesh's model axis (parallel/mesh.py):
    ``pieces[j]`` lives on model device j and holds the j-th equal part of
    the leaf's ``axis``.  Only a sharded runner's states hold one; the
    effects whose leaves the mesh splits (the reverb's comb bank, the
    convolution reverb's partition history) run each part on its device."""

    def __init__(self, pieces, axis: int):
        self.pieces = tuple(pieces)
        self.axis = int(axis)

    def join(self, device):
        """The whole leaf on ``device``, parts in order."""
        return torch.cat([p.to(device) for p in self.pieces], self.axis)


def ms_to_samples(fs, ms):
    """(fs * ms / 1000) truncated to int32, for a 0-dim float32 ``ms``.
    The division is by a tensor: CUDA turns division by a Python scalar
    into a reciprocal multiply, which can land one ulp below an integer
    and truncate to a different lag than the CPU does."""
    v = float(fs) * ms
    return (v / torch.full_like(v, 1000.0)).to(torch.int32)


class EffectModel:
    kind: str = ""
    PARAMS: dict[str, ParamSpec] = {}
    # Top-level state keys that are pure per-block counters: they advance
    # identically in every stream whenever all streams step together, so a
    # batched step keeps them unbatched (Chain.state_axes).
    LOCKSTEP_STATE: tuple = ()

    def __init__(self, fs: int, blocksize: int, channels: int = 2,
                 device="cpu", **config):
        self.fs = int(fs)
        self.blocksize = int(blocksize)
        self.channels = int(channels)
        self.device = device
        self.config = dict(config)

    # -- static helpers -------------------------------------------------
    @classmethod
    def split_config(cls, config: dict):
        """Split a chain-config params dict into (live targets, static)."""
        live = {k: v for k, v in config.items() if k in cls.PARAMS}
        static = {k: v for k, v in config.items() if k not in cls.PARAMS}
        return live, static

    def initial_params(self, config: dict) -> dict:
        return init_params(self.PARAMS, config, self.device)

    def map_state(self, f_batched, f_lockstep, st, *rest):
        """Map leaves of a state tree (plus parallel trees in ``rest``):
        ``f_lockstep`` on LOCKSTEP_STATE keys, ``f_batched`` elsewhere."""
        return {
            k: tree_map(
                f_lockstep if k in self.LOCKSTEP_STATE else f_batched,
                v, *(r[k] for r in rest),
            )
            for k, v in st.items()
        }

    def state_axes_tree(self, batch_axis: int = 0):
        """Per-leaf slot axis matching ``init_state``'s structure:
        ``batch_axis`` everywhere except LOCKSTEP_STATE leaves (None)."""
        return self.map_state(lambda _: batch_axis, lambda _: None, self.init_state())

    # -- to implement ---------------------------------------------------
    def init_state(self):
        """Return the effect's state tree (all-zero history)."""
        return {}

    def process(self, state, p, x):
        """Pure block transform: (state, params, (C, N)) -> (state, (C, N)),
        or the same with a leading slot axis on x, params and state."""
        raise NotImplementedError

    def process_file(self, state, p, x):
        """Whole-signal transform for the file-mode fast path: one call over
        the entire (padded) signal with constant params and fresh state.
        Also takes a batched render's leading file axis: x (F, C, N) and
        (F, ...) state with the 0-dim params every file shares.  Defaults
        to ``process``; effects whose blockwise cost scales with N/lag
        override it with a closed-form whole-file algorithm."""
        return self.process(state, p, x)
